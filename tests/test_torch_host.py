"""comd_tpu_torch host state against comd_tpu, bit for bit.

The port copies comd_tpu's numpy host code (lattice, per-gid RNG streams,
cell geometry and planning, table readers, Chebyshev fits); these tests hold
every such array equal to the reference's, and check that the port never
imports jax.

Both packages build the native scene library (native/comd_init.cpp) at first
use.  comd_tpu's loader compiles straight into its final path, so a test
process that loads it while another process is still writing it falls back
for good to numpy's gasdev, which is 1 ulp off glibc for ~0.1% of draws;
the bit-equality test therefore waits until the reference's library really
loads and checks that both packages draw natively.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from comd_tpu import cells as jcells, lattice as jlattice, rng as jrng
from comd_tpu.potentials import eam as jeam
from comd_tpu.sim import plan_geometry as j_plan_geometry
from comd_tpu.config import Config as JConfig
from comd_tpu.utils import native as jnative

from comd_tpu_torch import cells as tcells, lattice as tlattice, rng as trng
from comd_tpu_torch.potentials import eam as team
from comd_tpu_torch.sim import plan_geometry as t_plan_geometry
from comd_tpu_torch.config import Config as TConfig
from comd_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POTS = os.path.join(REPO, "pots")
LAT = 3.615


def _scene(pkg_lattice, n, temp, delta, mass):
    ext = np.array([n, n, n], np.float64) * LAT
    r, gid = pkg_lattice.create_fcc_lattice(n, n, n, LAT, np.zeros(3), ext)
    p = pkg_lattice.set_temperature(gid, mass, temp, 4 * n ** 3)
    r = pkg_lattice.random_displacements(r, gid, delta)
    return r, gid, p


def _wait_for_reference_native(timeout: float = 180.0) -> bool:
    """True once comd_tpu's native library is loaded.  Its loader gives up
    for good after one failed load (``_tried``), which is what a load of a
    library still being written by a concurrent build gives; reset it and
    retry until that build is done, for at most ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not jnative.available() and time.monotonic() < deadline:
        time.sleep(0.5)
        with jnative._lock:
            jnative._tried, jnative._lib = False, None
    return jnative.available()


@pytest.mark.parametrize("n,temp,delta", [(6, 600.0, 0.0), (5, 1500.0, 0.2)])
def test_lattice_and_momenta_bit_equal(n, temp, delta):
    assert _wait_for_reference_native(), "comd_tpu's native library"
    assert tnative.available(), "comd_tpu_torch's native library"
    mass = jeam.read_funcfl(os.path.join(POTS, "Cu_u6.eam")).mass
    rj, gj, pj = _scene(jlattice, n, temp, delta, mass)
    rt, gt, pt = _scene(tlattice, n, temp, delta, mass)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(pt, pj)


def test_rng_streams_bit_equal():
    gid = np.arange(5000, dtype=np.int64)
    np.testing.assert_array_equal(trng.gasdev_n(gid, 123, 3),
                                  jrng.gasdev_n(gid, 123, 3))
    np.testing.assert_array_equal(trng.uniform_n(gid, 457, 3),
                                  jrng.uniform_n(gid, 457, 3))


@pytest.mark.parametrize("hilbert", [False, True])
def test_cell_geometry_maps_bit_equal(hilbert):
    ext = np.full(3, 6 * LAT)
    gj = jcells.make_geometry(np.zeros(3), ext, 4.95, use_hilbert=hilbert,
                              cell_size=1.5 * LAT)
    gt = tcells.make_geometry(np.zeros(3), ext, 4.95, use_hilbert=hilbert,
                              cell_size=1.5 * LAT)
    assert gt.grid == gj.grid == (4, 4, 4)
    assert gt.use_hilbert == gj.use_hilbert == hilbert
    for name in ("box_size", "inv_box_size", "local_box_of_tuple",
                 "tuple_of_box", "nbr_map", "halo_src", "halo_shift"):
        np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name),
                                      err_msg=name)
    assert (gt.n_local, gt.n_halo, gt.n_total) == \
        (gj.n_local, gj.n_halo, gj.n_total)


@pytest.mark.parametrize("n", [6, 63])
def test_plan_cells_same_capacity(n):
    """plan_cells (with its copied _slot_cost) resolves the same A, mode,
    skin and cell size; 63^3 is the 1,000,188-atom headline (A = 16 on a
    42^3 grid, skin 0.4725)."""
    pot = jeam.read_funcfl(os.path.join(POTS, "Cu_u6.eam"))
    r, _gid, _p = _scene(jlattice, n, 0.0, 0.0, pot.mass)
    ext = np.full(3, n * LAT)
    kw = dict(nx=n, ny=n, nz=n, doeam=True, pot_dir=POTS)
    cj, geo_j, pj = j_plan_geometry(JConfig(**kw), pot, LAT, r, (n,) * 3,
                                    (1, 1, 1), np.zeros(3), ext)
    ct, geo_t, pt = t_plan_geometry(TConfig(device="cpu", **kw), pot, LAT, r,
                                    (n,) * 3, (1, 1, 1), np.zeros(3), ext)
    assert (pt.max_atoms, pt.mode, pt.skin, pt.t0_max_occ) == \
        (pj.max_atoms, pj.mode, pj.skin, pj.t0_max_occ)
    np.testing.assert_array_equal(pt.cell_size, pj.cell_size)
    assert (ct.max_atoms, ct.cell_mode) == (cj.max_atoms, cj.cell_mode)
    assert geo_t.grid == geo_j.grid
    if n == 63:
        assert len(r) == 1_000_188
        assert (pt.max_atoms, pt.mode, geo_t.grid) == \
            (16, "commensurate", (42, 42, 42))
        assert pt.skin == pytest.approx(0.4725, abs=1e-9)


@pytest.mark.parametrize("fname,reader", [("Cu_u6.eam", "read_funcfl"),
                                          ("Cu01.eam.alloy", "read_setfl")])
def test_tables_and_cheb_coefficients_bit_equal(fname, reader):
    pj = getattr(jeam, reader)(os.path.join(POTS, fname))
    pt = getattr(team, reader)(os.path.join(POTS, fname))
    for tab in ("phi", "rho", "f"):
        a, b = getattr(pt, tab), getattr(pj, tab)
        assert (a.n, a.x0, a.inv_dx) == (b.n, b.x0, b.inv_dx)
        np.testing.assert_array_equal(a.padded, b.padded)
    assert (pt.mass, pt.lat, pt.cutoff) == (pj.mass, pj.lat, pj.cutoff)
    fj, ft = pj.cheb_pair, pt.cheb_pair
    assert (ft.transform, ft.deg, ft.u_lo, ft.u_hi, ft.w_lo, ft.w_hi) == \
        (fj.transform, fj.deg, fj.u_lo, fj.u_hi, fj.w_lo, fj.w_hi)
    for name in ("phi", "rho"):
        np.testing.assert_array_equal(ft.coef[name], fj.coef[name])
        np.testing.assert_array_equal(ft.dcoef[name], fj.dcoef[name])
    if fname == "Cu_u6.eam":
        # the headline evaluator: inv_u, 9 phi and 11 rho coefficients
        assert (ft.transform, len(ft.coef["phi"]), len(ft.coef["rho"])) == \
            ("inv_u", 9, 11)


def test_port_never_imports_jax():
    code = ("import sys, comd_tpu_torch, comd_tpu_torch.cli, "
            "comd_tpu_torch.interop, comd_tpu_torch.ops.cuda.stencil, "
            "comd_tpu_torch.ops.force_lj, comd_tpu_torch.potentials.lj; "
            "from comd_tpu_torch.ops.cuda.stencil import eam_pass1_half, "
            "eam_pass3_half, lj_pass_half, lj_pass; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'comd_tpu' or "
            "m.startswith('comd_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
