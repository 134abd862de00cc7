"""The step's conditional graphs and its -S 0 graphs
(comd_tpu_torch/stepgraph.py) on the CPU, against comd_tpu and against
the eager loop.

Stub graphs stand in for CUDA graphs, as a CUDA capture and replay
behave: a capture runs the step's Python once, on clones of the step's
buffers (``sim._scratch``), with both conditional bodies taken (a CUDA
capture records both and launches nothing); a replay runs the step
again with the kernels' launch counts held (a replay runs no Python),
the rebucket condition read by ``if_node``'s plain version.  Each
capture is first warmed on clones, as on the card.  f64, from one
comd_tpu state carried over with ``state_from_numpy``:
  - ``-S 0`` (a rebucket every step, comd_tpu's ``_make_step`` and
    ``_shard_step``): serially at 6^3, and on a one-process 2x2x2 mesh
    under --commImpl collective with -a 0 (6^3) and -a 1 (12^3, classic
    cells: 8 interior cells a shard), each with atoms changing shard
    inside the run (-r 0.8: from the 9th step) and without (the
    migrations counted), 10 steps in two blocks (-a 1 without: 5), through the graph runner and (but
    -a 1, whose eager loop tests/test_torch_split_mesh.py holds) the
    eager loop, against comd_tpu's run (the mesh on 8 virtual CPU
    devices) at tests/test_torch_stepgraph.py's tolerances: r and p
    within 1e-8, gid and counts equal, ePot within 1e-10 relative;
  - under -a 1 the -S 0 step picks its interior-sweep positions on the
    device: ``_any`` (the host's or over the shards) is never called;
  - the graph runner's rebucket and list-build counters and launch
    counts equal the eager loop's, lazy, list, on the mesh and -S 0 (the
    kernels, which count only on the card, stood in for by counting
    wrappers of the head, the two bodies and the rest).
The lazy and list steps through the conditional graphs against comd_tpu
are in tests/test_torch_stepgraph.py; on the card, against the eager
loop, in tests/test_torch_kernel_cuda.py (``-m cuda``).
"""
import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from comd_tpu_torch import Config, init_simulation, stepgraph
from comd_tpu_torch.interop import (FIELDS, shards_from_numpy,
                                    shards_to_numpy, state_from_numpy)
from comd_tpu_torch.ops import binning
from comd_tpu_torch.ops.cuda import LAUNCHES
from comd_tpu_torch.ops.cuda import step as step_ops

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
BASE = dict(nx=6, ny=6, nz=6, doeam=True, temperature=1200.0,
            dtype="float64", interp_impl="rows", pot_dir=POTS)
MESH = dict(xproc=2, yproc=2, zproc=2, comm_impl="collective")
BLOCKS = (5, 5)
A1 = dict(lazy_shell=False, temperature=600.0, gpu_async=1, nx=12, ny=12,
          nz=12, cell_mode="classic", **MESH)
FULL = {   # -S 0 cases: (the configuration beside BASE, blocks)
    "serial": (dict(lazy_shell=False), BLOCKS),
    "a0_migrating": (dict(lazy_shell=False, temperature=600.0,
                          initial_delta=0.8, gpu_async=0, **MESH), BLOCKS),
    "a0_still": (dict(lazy_shell=False, temperature=600.0, gpu_async=0,
                      **MESH), BLOCKS),
    "a1_migrating": (dict(A1, initial_delta=0.8), BLOCKS),
    "a1_still": (A1, (3, 2)),
}
# the eager loop's -S 0 against comd_tpu under -a 1:
# tests/test_torch_split_mesh.py; against the graphs: below
RUNS = [(case, runner) for case in FULL for runner in ("eager", "graphs")
        if runner == "graphs" or not case.startswith("a1")]


class GraphStub:
    """A replay: the captured step run again, its launch counts held."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        held = dict(LAUNCHES)
        self.fn()
        LAUNCHES.update(held)


def _both(_pred, body, negate=False, pool=None):
    body()


def stub_steps(sim):
    """GraphSteps whose capture runs the step on clones of the buffers
    with both bodies taken, and whose graphs are ``GraphStub``s."""
    def capture(fn, pool):
        with sim._scratch(), mock.patch.object(stepgraph, "if_node",
                                               _both):
            fn()
        return GraphStub(fn), 0.0, 0.0

    return stepgraph.GraphSteps("cpu", capture=capture,
                                scratch=sim._scratch)


def _run(sim, runner: str, blocks=BLOCKS):
    if runner == "graphs":
        sim.step_block(0)            # binds the buffers the graphs read
        sim._graphs = stub_steps(sim)
    for n in blocks:
        sim.step_block(n)
    if runner == "graphs":
        assert sim._graphs.captures == 2
        assert sim._graphs.replays == sum(blocks)
    return sim


@pytest.fixture(scope="module")
def refs():
    """comd_tpu's -S 0 runs, by case: initial state, state after
    ``BLOCKS``, ePot, atoms."""
    cache = {}

    def get(case):
        if case not in cache:
            kw = dict(BASE, **FULL[case][0])
            jsim = j_init(JConfig(**kw))
            keys = FIELDS + ("e_potential", "n_local", "overflow")
            start = {k: np.asarray(getattr(jsim.state, k)) for k in keys}
            for n in FULL[case][1]:
                jsim.step_block(n)
            end = {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}
            cache[case] = (kw, start, end, jsim.e_potential,
                           jsim.sum_atoms())
        return cache[case]

    return get


def _migrations(monkeypatch) -> list:
    """Patch the rebucket to record each shard's atoms leaving it."""
    seen = []
    orig = binning.rebucket

    def rebucket(*a, **kw):
        out = orig(*a, **kw)
        seen.append(int(out[4]))
        return out

    monkeypatch.setattr(binning, "rebucket", rebucket)
    return seen


@pytest.mark.parametrize("case,runner", RUNS,
                         ids=[f"{c}-{r}" for c, r in RUNS])
def test_full_step_matches_comd_tpu(refs, monkeypatch, case, runner):
    kw, start, end, e_j, n_j = refs(case)
    blocks = FULL[case][1]
    sim = init_simulation(Config(device="cpu", **kw))
    assert not (sim.uses_lazy or sim.uses_nl)
    mesh = hasattr(sim, "states")
    if mesh:
        assert sim.mesh.nprocs == 1
        assert sim.uses_split == bool(kw["gpu_async"])
        if sim.uses_split:
            assert sim.maps.interior.n == 8
        sim.states = shards_from_numpy(start, "cpu")
    else:
        sim.state = state_from_numpy({k: start[k] for k in FIELDS}, "cpu")
    host_any = []
    monkeypatch.setattr(sim, "_any", lambda flag: host_any.append(1))
    moved = _migrations(monkeypatch)
    _run(sim, runner, blocks)
    assert sim.n_rebucket == sum(blocks)
    # no host reduction in a -S 0 step (-a 1's select is on the device)
    assert host_any == []
    if mesh:
        ts = shards_to_numpy(sim.states, (2, 2, 2))
        # each shard rebucketed once a step, and once a capture's warm-up
        # and a capture
        assert len(moved) == 8 * (sum(blocks) + (4 if runner == "graphs"
                                                 else 0))
        assert (sum(moved) > 0) == case.endswith("migrating")
    else:
        ts = {k: getattr(sim.state, k).numpy() for k in FIELDS}
    np.testing.assert_array_equal(ts["gid"], end["gid"])
    np.testing.assert_array_equal(ts["n_atoms"], end["n_atoms"])
    np.testing.assert_allclose(ts["r"], end["r"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts["p"], end["p"], rtol=0, atol=1e-8)
    monkeypatch.undo()
    assert sim.e_potential == pytest.approx(e_j, rel=1e-10)
    assert sim.sum_atoms() == n_j and not sim.overflow


#: the launch counters the stand-in wrappers bump: the head, the rebucket
#: body, the refresh body, the rest
STAND_INS = {"head": "lj", "rebucket": "ring_push", "refresh": "halo_fill",
             "rest": "eam_pass1", "build": "nl_build"}


def _counting(monkeypatch, sim):
    """Count a launch in each stand-in as it runs."""
    def wrap(obj, name, key, module=True):
        orig = getattr(obj, name)

        def counted(*a, **kw):
            LAUNCHES[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(obj, name, counted)

    wrap(step_ops, "kick_drift_trigger", STAND_INS["head"])
    wrap(binning, "rebucket", STAND_INS["rebucket"])
    wrap(sim, "_refresh", STAND_INS["refresh"])
    wrap(sim, "_land", STAND_INS["rest"])
    wrap(sim, "build_lists", STAND_INS["build"])


@pytest.mark.parametrize("case", [
    dict(BASE), dict(BASE, method="thread_atom_nl"),
    dict(BASE, temperature=600.0, initial_delta=0.8, **MESH),
    dict(BASE, lazy_shell=False),
    dict(BASE, lazy_shell=False, gpu_async=1, temperature=600.0,
         initial_delta=0.8, **MESH)],
    ids=["lazy", "list", "mesh_lazy", "S0", "mesh_S0_a1"])
def test_counters_and_launches_equal_eager(monkeypatch, case):
    """Rebuckets, list builds and launch counts of the graph runner (each
    capture's counts credited a replay, a rebucket body's a rebucket)
    equal the eager loop's, and so does the state, bit for bit."""
    runs = {}
    for runner in ("eager", "graphs"):
        sim = init_simulation(Config(device="cpu", **case))
        with monkeypatch.context() as m:
            for k in LAUNCHES:
                m.setitem(LAUNCHES, k, 0)
            _counting(m, sim)
            _run(sim, runner, (10, 10))
            launches = {k: v for k, v in LAUNCHES.items() if v}
        runs[runner] = (sim, launches)
    (e, le), (g, lg) = runs["eager"], runs["graphs"]
    lazy = e.uses_lazy or e.uses_nl
    assert le == lg
    assert g.n_rebucket == e.n_rebucket and g.n_nl_build == e.n_nl_build
    assert 1 <= e.n_rebucket < 20 if lazy else e.n_rebucket == 20
    shards = len(e.states) if hasattr(e, "states") else 1
    assert le[STAND_INS["rest"]] == 20
    assert le[STAND_INS["rebucket"]] == shards * e.n_rebucket
    if lazy:
        assert le[STAND_INS["head"]] == 20 * shards
        assert le[STAND_INS["refresh"]] == 20 - e.n_rebucket
    if e.uses_nl:
        assert le[STAND_INS["build"]] == e.n_rebucket
        assert e.n_nl_build == e.n_rebucket + 1
    states = (lambda s: s.states if hasattr(s, "states") else [s.state])
    for a, b in zip(states(e), states(g)):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))


def test_scratch_leaves_the_state():
    """The warm-up before a capture runs both branches on clones of the
    step's buffers: the state, the baseline and the rebucket counter stay
    as they were, and the views point at the buffers again."""
    sim = init_simulation(Config(device="cpu", **BASE))
    sim.step_block(3)
    before = {k: v.clone() for k, v in sim._bufs.items()}
    r = sim.state.r
    with sim._scratch():
        assert sim.state.r is not r
        sim._lazy_step(True, stepgraph._both)
        assert int(sim._bufs["rebuckets"]) == int(before["rebuckets"]) + 1
    assert sim.state.r is r and sim.last_r is sim._bufs["last_r", 0]
    for k, v in sim._bufs.items():
        assert torch.equal(v, before[k]), k
