"""The port's neighbor-list methods on a 2x2x2 mesh of shards.

8^3 unit cells (2,048 atoms; 4^3 would leave each shard one NL cell, which
both packages refuse), f64, T = 1200 K, 0.1 A initial displacements, -m
thread_atom_nl EAM, 20 steps in blocks of 10 through at least one rebuild of
the lists (and so an atom exchange):
  - under -a auto (1: the interior/boundary row split) and -a 0 against
    comd_tpu's sharded run on the 8-device virtual CPU mesh: the initial
    ePot within 1e-9, every shard's gid and n_atoms equal and r within
    1e-10 at the end, ePot within 1e-7;
  - against the port's own serial run of the same flags: ePot and the
    kinetic energy within 1e-9 (the same lists in another row order);
  - -L LJ (-S 0.05, so the lists are rebuilt inside the run) under -a auto
    and --commImpl ki (the atom exchange on ring_push's plain version)
    against the port's serial -L run;
  - f32 at 9^3, where atom planes lie on cell faces of the shards' classic
    cells: a ghost cell holds its source cell's atoms slot for slot at
    t = 0 (the first ghost refresh moves none), and 10 steps end within
    1e-7 eV/atom of the serial run.  comd_tpu bins the generated atoms
    from their f64 coordinates and its ghosts from f32 ones, so its
    sharded f32 NL run at 9^3 loses 0.14 eV/atom in the first 10 steps.
"""
import os

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import shards_to_numpy
from comd_tpu_torch.parallel import exchange
from comd_tpu_torch.parallel.sharded import ShardedSimulation

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
MESH = dict(xproc=2, yproc=2, zproc=2)
KW = dict(nx=8, ny=8, nz=8, temperature=1200.0, initial_delta=0.1,
          dtype="float64", pot_dir=POTS)
EAM = dict(KW, doeam=True, method="thread_atom_nl")


def _run(sim, blocks=2, block=10):
    e0 = sim.e_potential
    for _ in range(blocks):
        sim.step_block(block)
    return e0


@pytest.fixture(scope="module")
def serial():
    sim = init_simulation(Config(device="cpu", **EAM))
    e0 = _run(sim)
    return sim, e0


@pytest.mark.parametrize("gpu_async", [-1, 0], ids=["auto", "a0"])
def test_mesh_nl_matches_comd_tpu_and_serial(serial, gpu_async):
    kw = dict(EAM, gpu_async=gpu_async, **MESH)
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    assert isinstance(tsim, ShardedSimulation)
    assert (tsim.nl_row_split is not None) == (gpu_async == -1)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-9)
    _run(jsim)
    _run(tsim)
    assert tsim.n_nl_build >= 2                   # init and a rebuild
    js = {k: np.asarray(getattr(jsim.state, k))
          for k in ("r", "gid", "n_atoms")}
    ts = shards_to_numpy(tsim.states, (2, 2, 2))
    for k in ("gid", "n_atoms"):
        np.testing.assert_array_equal(ts[k], js[k])
    np.testing.assert_allclose(ts["r"], js["r"], rtol=0, atol=1e-10)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-7)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 2048
    assert not tsim.overflow
    ser, ser_e0 = serial
    assert ser.n_nl_build == tsim.n_nl_build
    assert tsim.e_potential == pytest.approx(ser.e_potential, abs=1e-9)
    assert tsim.kinetic_energy() == pytest.approx(ser.kinetic_energy(),
                                                  abs=1e-9)


def test_mesh_pairlist_lj_ki_matches_serial():
    kw = dict(KW, use_pairlist=True, relative_skin_distance=0.05)
    ser = init_simulation(Config(device="cpu", **kw))
    mesh = init_simulation(Config(device="cpu", comm_impl="ki", **kw,
                                  **MESH))
    assert mesh.uses_nl and mesh.nl_row_split is not None
    assert mesh.e_potential == pytest.approx(ser.e_potential, abs=1e-9)
    _run(ser)
    _run(mesh)
    assert mesh.n_nl_build == ser.n_nl_build >= 2
    assert mesh.e_potential == pytest.approx(ser.e_potential, abs=1e-9)
    assert mesh.kinetic_energy() == pytest.approx(ser.kinetic_energy(),
                                                  abs=1e-9)
    assert mesh.sum_atoms() == 2048 and not mesh.overflow


def test_mesh_nl_f32_face_atoms_match_serial():
    kw = dict(EAM, nx=9, ny=9, nz=9, initial_delta=0.0, temperature=600.0,
              dtype="float32")
    ser = init_simulation(Config(device="cpu", **kw))
    mesh = init_simulation(Config(device="cpu", **kw, **MESH))
    n_local = mesh.geom.n_local
    refreshed = [s.r.clone() for s in mesh.states]
    exchange.exchange_positions(mesh.halo, refreshed)
    for s, r in zip(mesh.states, refreshed):
        occ = (torch.arange(s.r.shape[2])[None, :]
               < s.n_atoms[n_local:, None])
        moved = (r[:, n_local:] - s.r[:, n_local:]).abs().amax(0)
        assert not bool(((moved > 1e-4) & occ).any())
    for sim in (ser, mesh):
        sim.step_block(10)
    e = [(sim.e_potential + sim.kinetic_energy()) / sim.n_global
         for sim in (ser, mesh)]
    assert e[1] == pytest.approx(e[0], abs=1e-7)
    assert mesh.sum_atoms() == 2916 and not mesh.overflow
