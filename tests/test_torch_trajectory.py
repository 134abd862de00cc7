"""Trajectories of the port against comd_tpu from the identical state.

Both packages start from one comd_tpu state, carried over with
``comd_tpu_torch.interop.state_from_numpy``.
  - f64, exact tables vs comd_tpu ``interp_impl="rows"``, 20 steps, once
    with lazy-shell stepping (hot enough that the skin trigger rebuckets
    inside the run) and once eager (a rebucket every step): r, p atol 1e-8,
    gid and counts equal, ePot rtol 1e-10.
  - f32, Chebyshev evaluator vs comd_tpu ``thread_atom``, 10 steps: ePot
    rtol 1e-5, p atol 2e-4 (sweep order differs).
  - f32 energy conservation over 30 steps < 5e-5 (tests/test_pallas.py).
"""
import os

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import FIELDS, state_from_numpy

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")


def _pair(steps, **kw):
    """(comd_tpu sim, port sim) from the same comd_tpu state, stepped."""
    jsim = j_init(JConfig(pot_dir=POTS, **kw))
    tsim = init_simulation(Config(pot_dir=POTS, device="cpu", **kw))
    assert tsim.cfg.max_atoms == jsim.cfg.max_atoms
    assert tsim.geom.grid == jsim.geom.grid
    tsim.state = state_from_numpy(
        {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
    jsim.step_block(steps)
    tsim.step_block(steps)
    return jsim, tsim


@pytest.mark.parametrize("lazy", [True, False])
def test_f64_trajectory_matches_rows(lazy):
    jsim, tsim = _pair(20, nx=6, ny=6, nz=6, doeam=True, temperature=1200.0,
                       dtype="float64", interp_impl="rows", lazy_shell=lazy)
    assert tsim.uses_lazy == lazy and tsim.cfg.max_atoms == 16
    # lazy: the skin trigger fired inside the run; eager: every step
    assert tsim.n_rebucket >= (1 if lazy else 20)
    js, ts = jsim.state, tsim.state
    np.testing.assert_array_equal(ts.gid.numpy(), np.asarray(js.gid))
    np.testing.assert_array_equal(ts.n_atoms.numpy(), np.asarray(js.n_atoms))
    np.testing.assert_allclose(ts.r.numpy(), np.asarray(js.r), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0,
                               atol=1e-8)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, rel=1e-10)
    assert tsim.kinetic_energy() == pytest.approx(jsim.kinetic_energy(),
                                                  rel=1e-10)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 864
    assert not bool(ts.overflow)


def test_f32_cheb_matches_thread_atom():
    jsim, tsim = _pair(10, nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
                       dtype="float32", method="thread_atom")
    assert tsim.pair_eval.kind == "cheb"
    assert tsim.e_potential == pytest.approx(jsim.e_potential, rel=1e-5)
    np.testing.assert_allclose(tsim.state.p.numpy(), np.asarray(jsim.state.p),
                               rtol=0, atol=2e-4)
    assert tsim.sum_atoms() == jsim.n_global


def test_f32_energy_conservation():
    sim = init_simulation(Config(nx=6, ny=6, nz=6, doeam=True,
                                 temperature=600.0, dtype="float32",
                                 pot_dir=POTS, device="cpu"))
    e0 = sim.e_potential + sim.kinetic_energy()
    sim.step_block(30)
    e1 = sim.e_potential + sim.kinetic_energy()
    assert abs(e1 - e0) / abs(e0) < 5e-5
    assert not bool(sim.state.overflow)
    assert sim.sum_atoms() == sim.n_global
