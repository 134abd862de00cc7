"""The -P spline tables in the port against comd_tpu.

- ``make_spline``: the coefficients of phi and rho equal comd_tpu's bit for
  bit, for the funcfl (Adams Cu_u6) and setfl (Mishin Cu01) tables.
- ``interpolate_spline`` on r^2 samples across each table, the clip edges
  at x0 and past xn included: f64 within 1e-12 and f32 within 1e-6 of the
  largest value (f and (1/r) df/dr both; the cubic cancels in f32, so the
  bound is relative to the output's largest magnitude).
- The plain force passes with the spline evaluator (K1 full shell, K2 half
  shell with its fold, NL2 on the lists) against comd_tpu's eam_force,
  eam_force_half and eam_force_nl with spline=True, from one 8^3 state
  (T = 600 K, 0.1 A displacements) carried over by ``state_from_numpy``:
  f64 forces, U and ePot within 1e-12 relative (forces also 1e-12 of their
  largest value); f32 ePot rtol 1e-5, forces atol 2e-4 eV/A and U 3e-5 of
  its largest value.  The f32 bounds are wider than the Chebyshev path's
  (1e-4, 1e-5): the f32 cubic cancels strongly, so one evaluation is off
  the f64 spline by up to 1.6e-5 in (1/r) dphi/dr; the port rounds it op
  by op (as its kernels do) while comd_tpu's jitted sweep contracts it
  into FMAs, and the two differ by up to 1.3e-4 eV/A (3 of 6,144 force
  components at 8^3) and 1.6e-5 in U.  The spline values themselves are
  the same bits in both packages (``test_interpolate_spline_...``).
- chip_smoke.py's -P and -I goldens equal comd_tpu's T = 0 cohesive
  energies at 6^3 (f64, the goldens' 12 printed digits).

The kernels' spline variants are held against these plain versions on the
card by tests/test_torch_kernel_cuda.py.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.potentials import eam as jeam_pot
from comd_tpu.potentials import tables as jtables

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import FIELDS, state_from_numpy
from comd_tpu_torch.potentials import eam as team_pot
from comd_tpu_torch.potentials import tables as ttables

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POTS = os.path.join(ROOT, "pots")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

POT_FILES = {"funcfl": "Cu_u6.eam", "setfl": "Cu01.eam.alloy"}


def _pots(pot_type):
    name = POT_FILES[pot_type]
    return (jeam_pot.init_eam_pot(POTS, name, pot_type),
            team_pot.init_eam_pot(POTS, name, pot_type))


@pytest.mark.parametrize("table", ["phi", "rho"])
@pytest.mark.parametrize("pot_type", ["funcfl", "setfl"])
def test_make_spline_matches_comd_tpu_bitwise(pot_type, table):
    jp, tp = _pots(pot_type)
    jt, tt = getattr(jp, table), getattr(tp, table)
    want = jtables.make_spline(jt.padded[1:], jt.n, jt.x0, jt.inv_dx)
    got = ttables.make_spline(tt.padded[1:], tt.n, tt.x0, tt.inv_dx)
    assert (got.n, got.x0, got.xn, got.inv_dx) == (want.n, want.x0,
                                                    want.xn, want.inv_dx)
    assert got.coeffs.dtype == np.float64
    assert np.array_equal(got.coeffs, want.coeffs)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pot_type", ["funcfl", "setfl"])
def test_interpolate_spline_matches_comd_tpu(pot_type, dtype):
    jp, _tp = _pots(pot_type)
    tab = jp.rho
    sp = ttables.make_spline(tab.padded[1:], tab.n, tab.x0, tab.inv_dx)
    dx = 1.0 / sp.inv_dx
    knots = sp.x0 + dx * np.arange(sp.n + 1)
    r = np.concatenate([
        np.linspace(0.0, 1.05 * sp.xn, 4001),      # past xn: clipped
        knots, knots + 0.5 * dx, [sp.x0, sp.xn, 1e-6, 0.0]])
    r2 = (r * r).astype(dtype)
    tdt = getattr(torch, dtype)
    for table in (jp.phi, jp.rho):
        s = ttables.make_spline(table.padded[1:], table.n, table.x0,
                                table.inv_dx)
        want = jtables.interpolate_spline(
            jnp.asarray(s.coeffs, dtype=dtype), s.n, s.x0, s.xn, s.inv_dx,
            jnp.asarray(r2))
        c = lambda x: ttables.as_dtype(x, tdt)  # noqa: E731
        got = ttables.interpolate_spline(
            torch.as_tensor(s.coeffs, dtype=tdt), s.n, c(s.x0), c(s.xn),
            c(s.inv_dx), c(s.x0 * s.inv_dx), torch.from_numpy(r2))
        tol = 1e-12 if dtype == "float64" else 1e-6
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == tdt
            np.testing.assert_allclose(g.numpy(), w, rtol=tol,
                                       atol=tol * np.abs(w).max())


def _carry(jsim, **kw):
    """The port's simulation of ``kw`` on the CPU holding comd_tpu's state
    (and, on the list paths, its own list rebuilt on that state)."""
    tsim = init_simulation(Config(device="cpu", **kw))
    assert tsim.geom.grid == jsim.geom.grid
    assert tsim.cfg.max_atoms == jsim.cfg.max_atoms
    tsim.state = state_from_numpy(
        {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
    if tsim.uses_nl:
        tsim.build_neighbor_list()
    return tsim


@pytest.mark.parametrize("path", ["full", "half", "nl"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_spline_force_matches_comd_tpu(dtype, path):
    """K1's (full), K2's + fold (half) and NL2's (nl) plain spline passes,
    through the force of each path, against comd_tpu's with spline=True."""
    kw = dict(nx=8, ny=8, nz=8, doeam=True, spline=True, temperature=600.0,
              initial_delta=0.1, dtype=dtype, pot_dir=POTS,
              half_shell=path == "half",
              method="thread_atom_nl" if path == "nl" else "thread_atom")
    jsim = j_init(JConfig(**kw))
    tsim = _carry(jsim, **kw)
    assert tsim.pair_eval.kind == "spline"
    r, n = jsim.state.r, jsim.state.n_atoms
    s = tsim.state
    if path == "nl":
        jf, je = jsim._force_fn_nl()(jsim.nlist, r, n)
        jf, ju = np.asarray(jf)[:, :jsim.geom.n_local], None
        tf, tu, te = tsim.force(s.r, s.n_atoms, nlist=tsim.nlist)
    else:
        jf, ju, je = (np.asarray(x) for x in jsim._force_fn()(r, n))
        tf, tu, te = tsim.force(s.r, s.n_atoms)
    tf = tf.numpy()
    if dtype == "float64":
        np.testing.assert_allclose(tf, jf, rtol=1e-12,
                                   atol=1e-12 * np.abs(jf).max())
        u_tol = rtol = 1e-12
    else:
        np.testing.assert_allclose(tf, jf, rtol=0, atol=2e-4)
        rtol, u_tol = 1e-5, 3e-5
    if ju is not None:
        np.testing.assert_allclose(tu.numpy(), ju, rtol=u_tol,
                                   atol=u_tol * np.abs(ju).max())
    assert float(te) == pytest.approx(float(je), rel=rtol)


@pytest.mark.parametrize("name,kw", [
    ("GOLDEN_EAM_SPLINE", dict(doeam=True, spline=True)),
    ("GOLDEN_LJ_INTERP", dict(lj_interpolation=True))])
def test_chip_smoke_goldens_are_comd_tpu_energies(name, kw):
    """The -P and -I goldens chip_smoke.py holds the card to are comd_tpu's
    T = 0 cohesive energies at 6^3, f64."""
    jsim = j_init(JConfig(nx=6, ny=6, nz=6, temperature=0.0,
                          initial_delta=0.0, dtype="float64", max_atoms=40,
                          box_chunk=32, pot_dir=POTS, **kw))
    e = float(jsim.e_potential) / jsim.n_global
    assert abs(e - getattr(chip_smoke, name)) < 1e-12
