"""The port's mesh on other shapes and transports, against itself.

  - A 3x2x1 mesh (a 3-wide and a 1-wide axis: comd_tpu never ran a 3-wide
    one, so the port's own serial run is the reference) under --commImpl
    ki_fused, 20 f64 EAM steps with atoms changing shard: every atom
    within 1e-8 of the serial run, ePot within 1e-8 eV.
  - collective, ki and ki_fused give bitwise-equal trajectories (eager
    stepping, so the atom exchange runs every step), full and half shell:
    on the CPU the kernels' plain versions move the same bits as the
    collective copies.
"""
import numpy as np
import pytest
import torch

from comd_tpu_torch import Config, init_simulation

from test_torch_sharded import (FIELDS, MESH, TRAJ, _assert_same_atoms,
                                _owners)

torch.set_num_threads(1)


def test_3x2x1_ki_fused_matches_port_serial():
    kw = dict(TRAJ, nx=9, nz=3)
    sharded = init_simulation(Config(device="cpu", xproc=3, yproc=2,
                                     zproc=1, comm_impl="ki_fused", **kw))
    serial = init_simulation(Config(device="cpu", **kw))
    assert sharded.mesh.ring(0, 1) == [2, 3, 4, 5, 0, 1]
    assert sharded.mesh.ring(2, 1) == list(range(6))   # pushes to itself
    owners0 = _owners(sharded)
    sharded.step_block(20)
    serial.step_block(20)
    assert sum(owners0[g] != v for g, v in _owners(sharded).items()) > 0
    assert sharded.sum_atoms() == serial.n_global == 648
    _assert_same_atoms(sharded, serial, np.asarray(serial.global_extent),
                       1e-8)
    assert sharded.e_potential == pytest.approx(serial.e_potential, abs=1e-8)


@pytest.mark.parametrize("half", [False, True])
def test_transports_bit_equal(half):
    """Eager stepping exchanges atoms every step; K3 and K4's plain versions
    move the same bits as the collective copies."""
    sims = []
    for ci in ("collective", "ki", "ki_fused"):
        sim = init_simulation(Config(device="cpu", lazy_shell=False,
                                     half_shell=half, comm_impl=ci,
                                     **MESH, **TRAJ))
        sim.step_block(5)
        sims.append(sim)
    for other in sims[1:]:
        assert other.e_potential == sims[0].e_potential
        for a, b in zip(sims[0].states, other.states):
            for k in FIELDS:
                assert torch.equal(getattr(a, k), getattr(b, k)), k
