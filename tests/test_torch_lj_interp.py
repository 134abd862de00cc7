"""-I, the table-interpolated LJ, in the port against comd_tpu.

comd_tpu's lj_force_interp (gpu_utility.c:348-374) interpolates a
1000-point quadratic table of the shifted energy 4 eps (r6 (r6 - 1) -
e_shift), with forces from the table's derivative.  The port runs it on
K1's LJ-table variant; here its plain version:
- against lj_force_interp from one 8^3 state (T = 600 K, 0.1 A
  displacements) carried over by ``state_from_numpy``: f64 forces, U and
  ePot within 1e-12 relative, f32 forces atol 1e-4 eV/A, U and ePot rtol
  1e-5;
- with one pair put at the cutoff, where the table index reaches n and
  the 4-point stencil reads entry n + 3: comd_tpu's gather clamps it to
  the last entry, the port pads its table with that entry;
- comd_tpu's dispatch: -I ignores --halfShell (K1, the table), and the
  list paths (-m *_nl, -L) ignore -I (analytic LJ on NL2).
The kernel is held against this plain version on the card by
tests/test_torch_kernel_cuda.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import force_lj as jlj

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import FIELDS, state_from_numpy
from comd_tpu_torch.ops import force_lj as tlj

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")


def _pair(dtype, **extra):
    kw = dict(nx=8, ny=8, nz=8, lj_interpolation=True, temperature=600.0,
              initial_delta=0.1, dtype=dtype, pot_dir=POTS, **extra)
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    assert tsim.geom.grid == jsim.geom.grid
    tsim.state = state_from_numpy(
        {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
    return jsim, tsim


def _cutoff_distance(rcut2, np_dtype):
    """The largest distance whose rounded square is within the cutoff."""
    d = np.sqrt(np_dtype(rcut2))
    while d * d > np_dtype(rcut2):
        d = np.nextafter(d, np_dtype(0))
    while np.nextafter(d, np_dtype(np.inf)) ** 2 <= np_dtype(rcut2):
        d = np.nextafter(d, np_dtype(np.inf))
    return d


def _compare(jsim, tsim, r_np, dtype):
    jf, ju, je = jlj.lj_force_interp(jsim.geom, jsim.pot, jnp.asarray(r_np),
                                     chunk=64)
    tf, tu, te = (x[0] for x in tlj.lj_force_interp(
        tsim.maps.nbr_map, torch.from_numpy(r_np)[None], tsim.pair_eval))
    jf, ju = np.asarray(jf), np.asarray(ju)
    if dtype == "float64":
        np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-12,
                                   atol=1e-12 * np.abs(jf).max())
        rtol = 1e-12
    else:
        np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-4)
        rtol = 1e-5
    np.testing.assert_allclose(tu.numpy(), ju, rtol=rtol,
                               atol=rtol * np.abs(ju).max())
    assert float(te) == pytest.approx(float(je), rel=rtol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lj_interp_matches_comd_tpu(dtype):
    jsim, tsim = _pair(dtype)
    assert tsim.pair_eval.kind == "lj_table"
    assert tsim.pair_eval.phi.shape == (1004,)       # n + 3 and the pad
    _compare(jsim, tsim, np.array(jsim.state.r), dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lj_interp_pad_entry_at_cutoff(dtype):
    """A pair at the cutoff reads the table's entry n + 3."""
    jsim, tsim = _pair(dtype)
    ev = tsim.pair_eval
    np_dtype = np.dtype(dtype).type
    d = _cutoff_distance(ev.rcut2, np_dtype)
    assert np.floor((d - np_dtype(ev.x0)) * np_dtype(ev.inv_dx)) == ev.n
    r = np.array(jsim.state.r)
    # atom (0, 1) moves to distance d of atom (0, 0), in the direction
    # farthest from every other atom (no close pair of huge forces)
    others = r.reshape(3, -1)[:, 2:]
    others = others[:, np.abs(others[0]) < 1e9].astype(np.float64)
    u = np.random.default_rng(0).normal(size=(3, 256))
    u /= np.linalg.norm(u, axis=0)
    cand = r[:, 0, :1].astype(np.float64) + d * u
    gap = np.sqrt(((cand[:, :, None] - others[:, None, :]) ** 2).sum(0))
    u = u[:, np.argmax(gap.min(1))]
    for k in range(3):
        r[k, 0, 1] = r[k, 0, 0] + np_dtype(d * u[k])
    dr = (r[:, 0, 1] - r[:, 0, 0]).astype(np_dtype)
    r2 = (dr[0] * dr[0] + dr[1] * dr[1]) + dr[2] * dr[2]
    rr = np.sqrt(r2)
    assert r2 <= np_dtype(ev.rcut2)
    if np.floor((rr - np_dtype(ev.x0)) * np_dtype(ev.inv_dx)) != ev.n:
        pytest.fail("the pair does not reach the table's last interval")
    _compare(jsim, tsim, r, dtype)


@pytest.mark.parametrize("extra,kind,interp", [
    (dict(half_shell=True), "lj_table", True),
    (dict(method="thread_atom_nl"), "lj", False),
    (dict(use_pairlist=True), "lj", False)])
def test_lj_interp_dispatch_follows_comd_tpu(extra, kind, interp):
    """-I with --halfShell runs the table on the full shell; on the lists
    -I is ignored.  The initial ePot is comd_tpu's for the same flags
    (f64, 1e-12)."""
    kw = dict(nx=6, ny=6, nz=6, lj_interpolation=True, temperature=600.0,
              dtype="float64", pot_dir=POTS, **extra)
    tsim = init_simulation(Config(device="cpu", **kw))
    assert tsim.pair_eval.kind == kind
    jsim = j_init(JConfig(**kw))
    assert tsim.e_potential == pytest.approx(float(jsim.e_potential),
                                             rel=1e-12)
    e_table = init_simulation(Config(device="cpu", **dict(
        kw, half_shell=False, method="thread_atom",
        use_pairlist=False))).e_potential
    assert (tsim.e_potential == pytest.approx(e_table, rel=1e-12)) == interp
