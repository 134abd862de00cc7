"""-a 1 of the cell methods on a 2x2x2 mesh against comd_tpu's.

12^3 unit cells (6,912 atoms; EAM 4^3 cells a shard, 8 of them interior,
LJ 3^3, one), f64, T = 1200 K, 0.1 A initial displacements, 20 steps in
blocks of 10 through at least one rebucket, comd_tpu on its 8 virtual CPU
devices, the port's kernels on their plain versions: EAM with lazy and
with eager stepping, LJ eager.  The initial ePot within 1e-9, every
shard's gid and n_atoms equal, r within 1e-10 and ePot within 1e-7 at the
end (the bounds of test_torch_nl_mesh.py).  The split's parts, and the
split against the port's own -a 0 run: tests/test_torch_split.py.
"""
import os

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import shards_to_numpy

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
KW = dict(nx=12, ny=12, nz=12, xproc=2, yproc=2, zproc=2,
          temperature=1200.0, initial_delta=0.1, dtype="float64",
          pot_dir=POTS, gpu_async=1)


def _run(sim):
    for _ in range(2):
        sim.step_block(10)


@pytest.mark.parametrize("case", ["eam_lazy", "eam_eager", "lj_eager"])
def test_split_mesh_matches_comd_tpu(case):
    kw = dict(KW, doeam=case.startswith("eam"),
              lazy_shell=not case.endswith("eager"))
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    assert tsim.uses_split and tsim.maps.interior.n == (
        8 if kw["doeam"] else 1)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-9)
    _run(jsim)
    _run(tsim)
    assert tsim.n_rebucket >= 1
    js = {k: np.asarray(getattr(jsim.state, k))
          for k in ("r", "gid", "n_atoms")}
    ts = shards_to_numpy(tsim.states, tsim.mesh.grid)
    for k in ("gid", "n_atoms"):
        np.testing.assert_array_equal(ts[k], js[k])
    np.testing.assert_allclose(ts["r"], js["r"], rtol=0, atol=1e-10)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-7)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 4 * 12 ** 3
    assert not tsim.overflow
