"""The port's sharded simulation against comd_tpu and against its own
serial run.

  - Sharded init on 2x2x2 at comd_tpu's multidevice size (8^3 unit cells,
    f64, max_atoms=48; -r 0.1 so the forces are not zero), EAM and LJ,
    against comd_tpu's sharded init on the
    8-device virtual CPU mesh: every shard's gid, n_atoms and r bit for bit;
    f within 1e-9 eV/A and ePot within 1e-9 eV (the exact table evaluator
    against comd_tpu's two-level one, in another summation order).
  - comd_tpu's sharded state carried into the port's shards and back,
    exactly.
  - 20 f64 EAM steps on 2x2x2 against comd_tpu's serial run of the same
    flags: every atom's position and momentum within 1e-8, ePot within
    1e-8 eV, no atom lost, with rebuckets and atoms migrating between
    shards inside the run.  6^3 unit cells with 0.8 A initial displacements
    (-r 0.8): shard faces lie 0.9 A from the FCC site planes, so without
    the displacements no atom changes shard within 20 steps, and at 8^3 with
    A = 48 the plain sweeps would cost ~1 s a step on one CPU core.  Lazy
    stepping with the full shell, eager stepping with the half shell.

tests/test_torch_transports.py runs the meshes comd_tpu never ran and the
three transports.
"""
import os

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import shards_from_numpy, shards_to_numpy
from comd_tpu_torch.parallel.sharded import ShardedSimulation

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
EMPTY = 2**31 - 1
FIELDS = ("r", "p", "f", "gid", "n_atoms")
MESH = dict(xproc=2, yproc=2, zproc=2)
# the trajectory runs: 864 atoms, displaced so that some change shard
TRAJ = dict(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
            initial_delta=0.8, dtype="float64", pot_dir=POTS)


def _multidevice(**kw):
    return dict(nx=8, ny=8, nz=8, temperature=600.0, dtype="float64",
                max_atoms=48, box_chunk=64, pot_dir=POTS, **MESH, **kw)


@pytest.fixture(scope="module", params=["eam", "lj"])
def inits(request):
    kw = _multidevice(doeam=request.param == "eam", initial_delta=0.1)
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    js = {k: np.asarray(getattr(jsim.state, k))
          for k in FIELDS + ("e_potential", "n_local", "overflow")}
    return jsim, tsim, js


def test_sharded_init_matches_comd_tpu(inits):
    jsim, tsim, js = inits
    assert isinstance(tsim, ShardedSimulation)
    assert tsim.geom.grid == jsim.geom.grid
    assert tsim.cfg.max_atoms == jsim.cfg.max_atoms == 48
    ts = shards_to_numpy(tsim.states, (2, 2, 2))
    for k in ("gid", "n_atoms", "r", "p"):
        np.testing.assert_array_equal(ts[k], js[k])
    np.testing.assert_allclose(ts["f"], js["f"], rtol=0, atol=1e-9)
    assert np.abs(ts["f"]).max() > 0.1
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-9)
    assert tsim.kinetic_energy() == pytest.approx(jsim.kinetic_energy(),
                                                  abs=1e-9)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 2048
    assert int(ts["n_local"]) == 2048 and not tsim.overflow


def test_carry_sharded_state_across(inits):
    """comd_tpu's [Px, Py, Pz, ...] state into the port's shards and back,
    exactly; the port steps on from it like from its own init."""
    _jsim, tsim, js = inits
    shards = shards_from_numpy(js, "cpu")
    assert len(shards) == 8 and shards[0].r.shape == js["r"].shape[3:]
    back = shards_to_numpy(shards, (2, 2, 2))
    for k in js:
        assert back[k].dtype == js[k].dtype
        np.testing.assert_array_equal(back[k], js[k])


def _owners(sim: ShardedSimulation) -> dict:
    nl = sim.geom.n_local
    out = {}
    for s, st in enumerate(sim.states):
        g = st.gid[:nl].reshape(-1).numpy()
        out.update({int(x): s for x in g[g != EMPTY]})
    return out


def _by_gid(sim):
    """{gid: (r wrapped into the global box, p)} of every owned atom."""
    nl = sim.geom.n_local
    L = np.asarray(sim.global_extent)
    states = sim.states if isinstance(sim, ShardedSimulation) else [sim.state]
    out = {}
    for s, st in enumerate(states):
        off = (np.asarray(sim.mesh.coords[s]) * L / np.asarray(sim.mesh.grid)
               if isinstance(sim, ShardedSimulation) else np.zeros(3))
        g = np.asarray(st.gid)[:nl].reshape(-1)
        r = np.asarray(st.r)[:, :nl].reshape(3, -1).T
        p = np.asarray(st.p)[:, :nl].reshape(3, -1).T
        for gi, ri, pi in zip(g, r, p):
            if gi != EMPTY:
                out[int(gi)] = (np.mod(ri + off, L), pi)
    return out


def _assert_same_atoms(a, b, L, tol):
    da, db = _by_gid(a), _by_gid(b)
    assert sorted(da) == sorted(db)
    for g, (ra, pa) in da.items():
        rb, pb = db[g]
        dr = (ra - rb + 0.5 * L) % L - 0.5 * L      # across the boundary
        assert np.abs(dr).max() < tol, (g, ra, rb)
        np.testing.assert_allclose(pa, pb, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def serial_ref():
    jsim = j_init(JConfig(**TRAJ))
    jsim.step_block(20)
    return jsim


@pytest.mark.parametrize("lazy,half", [(True, False), (False, True)])
def test_trajectory_matches_comd_tpu_serial(serial_ref, lazy, half):
    sim = init_simulation(Config(device="cpu", lazy_shell=lazy,
                                 half_shell=half, **MESH, **TRAJ))
    owners0 = _owners(sim)
    sim.step_block(20)
    owners1 = _owners(sim)
    assert sim.n_rebucket >= (1 if lazy else 20)
    assert sum(owners0[g] != owners1[g] for g in owners0) > 0
    assert sim.sum_atoms() == serial_ref.sum_atoms() == 864
    assert not sim.overflow
    _assert_same_atoms(sim, serial_ref, np.asarray(sim.global_extent), 1e-8)
    assert sim.e_potential == pytest.approx(serial_ref.e_potential, abs=1e-8)
    assert sim.kinetic_energy() == pytest.approx(
        serial_ref.kinetic_energy(), abs=1e-8)
