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
    wrappers of the head, the two bodies and the rest);
  - a captured lazy or list step makes its condition before the head,
    every shard's trigger launch after the first ors into the flag and
    the last gets the condition's handles, and the IF nodes follow the
    head with nothing launched between: no kernel sets a handle but the
    head's; serially one handle and one IF node (the rebucket: the head
    refreshes the ghosts), on the mesh two (the position exchange);
  - a lazy run on the 2x2x2 mesh whose trigger fires in one shard only
    (one baseline slot moved a skin) rebuckets at the steps comd_tpu's
    sharded lazy step does, eager and through the graphs, and ends on its
    state.
The lazy and list steps through the conditional graphs against comd_tpu
are in tests/test_torch_stepgraph.py; on the card, against the eager
loop, in tests/test_torch_kernel_cuda.py (``-m cuda``).
"""
import dataclasses
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from comd_tpu_torch import Config, init_simulation, stepgraph
from comd_tpu_torch.interop import (FIELDS, shards_from_numpy,
                                    shards_to_numpy, state_from_numpy)
from comd_tpu_torch.ops import binning
from comd_tpu_torch.ops.cuda import LAUNCHES
from comd_tpu_torch.ops.cuda.graph_if import if_node_plain
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


def _both(_cond, _k, body, pool=None):
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
    # the serial step's body rebuckets in place
    wrap(binning, "rebucket_into", STAND_INS["rebucket"])
    if sim._refresh is not None:     # serially the head refreshes
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
    equal the eager loop's, and so does the state, bit for bit; the
    refresh body runs on the mesh's steps that do not rebucket, and
    serially never (the head refreshes)."""
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
        # one head launch a step over the stack of every shard
        assert le[STAND_INS["head"]] == 20
        assert le.get(STAND_INS["refresh"], 0) == (
            20 - e.n_rebucket if shards > 1 else 0)
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
        assert sim.state.r.data_ptr() != r.data_ptr()
        sim._lazy_step(True, stepgraph._both)
        assert int(sim._bufs["rebuckets"]) == int(before["rebuckets"]) + 1
    # the views are the stacks' again
    assert sim.state.r.data_ptr() == r.data_ptr() == \
        sim._bufs["r"].data_ptr()
    assert sim.last_r.data_ptr() == sim._bufs["last_r"].data_ptr()
    for k, v in sim._bufs.items():
        assert torch.equal(v, before[k]), k


#: the lazy cases of the head's handles: (configuration, shards)
LAZY = {"lazy": (dict(BASE), 1),
        "list": (dict(BASE, method="thread_atom_nl"), 1),
        "mesh_lazy": (dict(BASE, temperature=600.0, initial_delta=0.8,
                           **MESH), 8)}


@pytest.mark.parametrize("case", list(LAZY))
def test_head_sets_the_handles(monkeypatch, case):
    """In a captured step the condition comes first (its handles made in
    the graph, here stand-in values: one serially, two on the mesh), then
    the head's one trigger launch over the stack of every shard, given
    those handles, then the IF nodes on handles 0 (and 1 on the mesh),
    with no launch between the head and them; the launch
    counts (stand-ins, as above) equal the eager loop's, and no counter
    of a condition kernel exists."""
    kw, shards = LAZY[case]
    assert "set_condition" not in LAUNCHES
    events = []
    orig_kdt = step_ops.kick_drift_trigger

    def kdt(p, r, *a, handles=(), **k):
        events.append(("head", handles, tuple(r.shape[:-3])))
        return orig_kdt(p, r, *a, **k)

    def cond(_device, n=2):
        events.append(("condition", n))
        return stepgraph.Condition((11, 12)[:n])

    capturing = []

    def node(c, k, body, pool=None):
        """A capture records both bodies; a replay takes one."""
        events.append(("if", c.handles[k], k))
        if capturing:
            body()
        else:
            if_node_plain(c.flag, body, bool(k))

    runs = {}
    for runner in ("eager", "graphs"):
        sim = init_simulation(Config(device="cpu", **kw))
        with monkeypatch.context() as m:
            for k in LAUNCHES:
                m.setitem(LAUNCHES, k, 0)
            m.setattr(step_ops, "kick_drift_trigger", kdt)
            _counting(m, sim)
            m.setattr(stepgraph, "condition", cond)
            m.setattr(stepgraph, "if_node", node)
            if runner == "graphs":
                sim.step_block(0)

                def capture(fn, pool):
                    del events[:]
                    capturing.append(1)
                    with sim._scratch():
                        fn()
                    capturing.pop()
                    return GraphStub(fn), 0.0, 0.0

                sim._graphs = stepgraph.GraphSteps(
                    "cpu", capture=capture, scratch=sim._scratch)
            del events[:]
            sim.step_block(1)
            runs[runner] = (dict(LAUNCHES), list(events))
    (le, ee), (lg, eg) = runs["eager"], runs["graphs"]
    assert le == lg and le[STAND_INS["head"]] == 1
    # eager: no condition made, no handles, no IF node; the head's one
    # launch takes the stack of every shard
    assert ee == [("head", (), (shards,))]
    # the capture, then the replay (a stub: the step run again)
    n = 1 if shards == 1 else 2
    step = ([("condition", n), ("head", (11, 12)[:n], (shards,))]
            + [("if", 11, 0), ("if", 12, 1)][:n])
    assert eg == step + step


@pytest.fixture(scope="module")
def one_shard_ref():
    """comd_tpu's 2x2x2 lazy run (6^3, 600 K) from its initial state with
    one baseline slot of one shard a skin away: (configuration, state,
    baseline [Px, Py, Pz, 3, B, A], the shard, the steps that
    rebucketed (the baseline moved), final state, ePot, atoms)."""
    kw = dict(BASE, temperature=600.0, **MESH)
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    keys = FIELDS + ("e_potential", "n_local", "overflow")
    start = {k: np.array(getattr(jsim.state, k)) for k in keys}
    shard = (1, 0, 1)
    n_local = tsim.geom.n_local
    box = int(np.nonzero(start["n_atoms"][shard][:n_local])[0][0])
    last = start["r"].copy()
    last[shard][0, box, 0] += tsim.skin
    jsim.last_r = jnp.asarray(last)
    taken = []
    for i in range(N_ONE):
        before = np.array(jsim.last_r)
        jsim.step_block(1)
        if not np.array_equal(before, np.array(jsim.last_r)):
            taken.append(i)
    end = {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}
    return (kw, start, last, shard, taken, end, jsim.e_potential,
            jsim.sum_atoms())


N_ONE = 6     # single-step blocks of the one-shard run


@pytest.mark.parametrize("runner", ["eager", "graphs"])
def test_one_shard_fires_the_mesh(one_shard_ref, monkeypatch, runner):
    """The trigger fires in one shard of eight (and in no other) on the
    first step: the mesh rebuckets at the same steps as comd_tpu's sharded
    lazy step and ends on its state (r and p within 1e-8, gid and counts
    equal, ePot within 1e-10 relative)."""
    kw, start, last, shard, taken, end, e_j, n_j = one_shard_ref
    assert taken and taken[0] == 0
    sim = init_simulation(Config(device="cpu", **kw))
    assert sim.uses_lazy and len(sim.geom.grid) == 3
    sim.states = shards_from_numpy(start, "cpu")
    sim.last_r = [torch.as_tensor(last[idx].copy())
                  for idx in np.ndindex(2, 2, 2)]
    fired = []                       # each shard's own trigger, in order
    orig = step_ops.nlmod.needs_rebuild

    def needs_rebuild(*a, **k):
        t = orig(*a, **k)
        fired.append(bool(t))
        return t

    monkeypatch.setattr(step_ops.nlmod, "needs_rebuild", needs_rebuild)
    if runner == "graphs":
        sim.step_block(0)
        sim._graphs = stub_steps(sim)
    got = []
    for i in range(N_ONE):
        n0 = sim.n_rebucket
        del fired[:]
        sim.step_block(1)
        if sim.n_rebucket > n0:
            got.append(i)
        if i == 0:
            # the step's own eight launches come last (a first replay
            # follows the warm-up and the capture)
            assert fired[-8:] == [idx == shard
                                  for idx in np.ndindex(2, 2, 2)]
    assert got == taken
    ts = shards_to_numpy(sim.states, (2, 2, 2))
    np.testing.assert_array_equal(ts["gid"], end["gid"])
    np.testing.assert_array_equal(ts["n_atoms"], end["n_atoms"])
    np.testing.assert_allclose(ts["r"], end["r"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts["p"], end["p"], rtol=0, atol=1e-8)
    assert sim.e_potential == pytest.approx(e_j, rel=1e-10)
    assert sim.sum_atoms() == n_j and not sim.overflow
