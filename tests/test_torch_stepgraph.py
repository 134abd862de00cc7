"""The step cut into head and tail (comd_tpu_torch/stepgraph.py) against
comd_tpu, and the graph runner's bookkeeping.

On the CPU the steps run eagerly, or through ``GraphSteps`` with a stub
graph that replays by calling the captured step again (the runner's
control flow: each step's graph captured at its first use after both
branches were warmed on clones of the buffers, keyed by energy; the
rebucket condition read at replay by ``if_node``'s plain version).  From
one comd_tpu state, carried over with ``state_from_numpy``:
  - f64 lazy cell steps, hot enough that the skin trigger rebuckets inside
    the run, and the list path (-m thread_atom_nl, a rebuild inside the
    run), 20 steps in two blocks: r and p within 1e-8, gid and counts
    equal, ePot within 1e-10 relative (tests/test_torch_trajectory.py's
    tolerances);
  - the same on a one-process 2x2x2 mesh under --commImpl collective
    against comd_tpu's sharded run on 8 virtual CPU devices, every shard;
  - a ``sim.state`` replaced between blocks is the state the next block
    steps from, and a replacement of another shape makes new buffers;
  - a capture's launch counts are taken back and credited once per
    replay, a rebucket body's once per rebucket (stub graphs).
The graphs on the card against the eager loop are in
tests/test_torch_kernel_cuda.py (``-m cuda``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from comd_tpu_torch import Config, init_simulation, stepgraph
from comd_tpu_torch.interop import (FIELDS, shards_from_numpy,
                                    shards_to_numpy, state_from_numpy)
from comd_tpu_torch.ops.cuda import LAUNCHES
from comd_tpu_torch.ops.neighborlist import NeighborList

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
BASE = dict(nx=6, ny=6, nz=6, doeam=True, temperature=1200.0,
            dtype="float64", interp_impl="rows", pot_dir=POTS)
MESH = dict(xproc=2, yproc=2, zproc=2)
LIST_FIELDS = ("a_list", "a_valid", "nl", "last_r", "row_start")


class ReplayStub:
    """A graph whose replay runs the captured function again."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def replaying_steps(sim=None):
    """A runner of stub graphs; with ``sim``, each capture first warms
    both branches on clones of its buffers, as on the card."""
    return stepgraph.GraphSteps(
        "cpu", capture=lambda fn, pool: (ReplayStub(fn), 0.0, 0.0),
        scratch=None if sim is None else sim._scratch)


def _run(sim, runner: str, blocks=(10, 10)):
    if runner == "graphs" and sim._graphs is None:
        sim.step_block(0)            # binds the buffers the graphs read
        sim._graphs = replaying_steps(sim)
    for n in blocks:
        sim.step_block(n)
    return sim


def _assert_same(ts, js, e_t, e_j):
    np.testing.assert_array_equal(ts["gid"], js["gid"])
    np.testing.assert_array_equal(ts["n_atoms"], js["n_atoms"])
    np.testing.assert_allclose(ts["r"], js["r"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts["p"], js["p"], rtol=0, atol=1e-8)
    assert e_t == pytest.approx(e_j, rel=1e-10)


@pytest.mark.parametrize("runner", ["eager", "graphs"])
@pytest.mark.parametrize("method", ["thread_atom", "thread_atom_nl"],
                         ids=["lazy", "list"])
def test_head_tail_matches_comd_tpu(runner, method):
    kw = dict(BASE, method=method)
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    assert tsim.geom.grid == jsim.geom.grid
    tsim.state = state_from_numpy(
        {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
    if tsim.uses_nl:
        tsim.build_neighbor_list()
    else:
        assert tsim.uses_lazy
    for _ in range(2):
        jsim.step_block(10)
    _run(tsim, runner)
    assert tsim.n_rebucket >= 1 and (not tsim.uses_nl
                                     or tsim.n_nl_build >= 2)
    if runner == "graphs":
        g = tsim._graphs
        # one graph a step, with and without the energy terms
        assert g.captures == 2 and g.replays == 20
    ts = {k: getattr(tsim.state, k).numpy() for k in FIELDS}
    js = {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}
    _assert_same(ts, js, tsim.e_potential, jsim.e_potential)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 864
    assert not tsim.overflow


@pytest.fixture(scope="module")
def mesh_ref():
    """comd_tpu's 2x2x2 run (6^3, -r 0.8: atoms change shard), its
    initial state and the state after 20 steps."""
    kw = dict(BASE, temperature=600.0, initial_delta=0.8, **MESH)
    jsim = j_init(JConfig(**kw))
    keys = FIELDS + ("e_potential", "n_local", "overflow")
    start = {k: np.asarray(getattr(jsim.state, k)) for k in keys}
    for _ in range(2):
        jsim.step_block(10)
    end = {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}
    return kw, start, end, jsim.e_potential, jsim.sum_atoms()


@pytest.mark.parametrize("runner", ["eager", "graphs"])
def test_mesh_head_tail_matches_comd_tpu(mesh_ref, runner):
    kw, start, end, e_j, n_j = mesh_ref
    tsim = init_simulation(Config(device="cpu", comm_impl="collective",
                                  **kw))
    assert tsim.mesh.nprocs == 1 and tsim.uses_lazy
    tsim.states = shards_from_numpy(start, "cpu")
    _run(tsim, runner)
    assert tsim.n_rebucket >= 1
    ts = shards_to_numpy(tsim.states, (2, 2, 2))
    _assert_same(ts, end, tsim.e_potential, e_j)
    assert tsim.sum_atoms() == n_j == 864 and not tsim.overflow


@pytest.mark.parametrize("runner", ["eager", "graphs"])
@pytest.mark.parametrize("method", ["thread_atom", "thread_atom_nl"],
                         ids=["lazy", "list"])
def test_replaced_state_is_stepped(runner, method):
    """A block after ``sim.state`` and the lazy baseline or the list were
    replaced steps from the replacement, in the buffers the graphs were
    captured on: the same bits as the simulation the replacement came
    from, stepping on."""
    kw = dict(BASE, method=method, device="cpu")
    src = _run(init_simulation(Config(**kw)), runner, (10,))
    snap = {k: getattr(src.state, k).numpy().copy() for k in FIELDS}
    last = None if src.last_r is None else src.last_r.clone()
    lst = None if src.nlist is None else NeighborList(**{
        f: getattr(src.nlist, f).clone() for f in LIST_FIELDS})
    e_src = src.e_potential
    src.step_block(10)
    dst = _run(init_simulation(Config(**kw)), runner, (3,))
    bufs = dict(dst._bufs)
    dst.state = state_from_numpy(snap, "cpu")
    if dst.uses_nl:
        dst.nlist = lst
    else:
        dst.last_r = last
    dst.compute_force()            # a replace() on top of the new state
    assert dst.e_potential == e_src
    dst.step_block(10)
    # the same buffers, the replacement copied into them (the state's
    # fields the views of their stacks)
    assert all(dst._bufs[k] is v for k, v in bufs.items())
    assert dst.state.r.data_ptr() == bufs["r"].data_ptr()
    for k in FIELDS:
        assert torch.equal(getattr(dst.state, k), getattr(src.state, k)), k
    assert dst.e_potential == src.e_potential


def test_new_buffers_drop_the_graphs():
    """A tensor that cannot be copied into its buffer (another dtype or
    shape) gets a buffer of its own, and the graphs go; a block of no
    steps only binds."""
    sim = init_simulation(Config(device="cpu", **BASE))
    sim.step_block(0)
    sim._graphs = g = replaying_steps()
    sim.step_block(2)
    sim.step_block(1)
    assert sim._graphs is g and g.captures >= 2
    sim.state = dataclasses.replace(sim.state, r=sim.state.r.float())
    sim.step_block(0)
    assert sim._graphs is None and sim.state.r.dtype == torch.float32


def test_keep_copies_into_buffers():
    a, b = torch.zeros(4), torch.ones(4)
    bufs = {}
    assert stepgraph.keep(bufs, {"x": a})
    assert bufs["x"] is not a and torch.equal(bufs["x"], a)
    x = bufs["x"]
    assert not stepgraph.keep(bufs, {"x": b})
    assert bufs["x"] is x and torch.equal(x, b)
    assert not stepgraph.keep(bufs, {"x": x})
    assert stepgraph.keep(bufs, {"x": torch.ones(5)})


def test_launch_credits_once_per_replay(monkeypatch):
    """A capture runs the step's Python (the wrappers count as they go)
    but launches nothing: its counts are taken back and credited on each
    replay, so every run of the key counts once."""
    for k in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, k, 0)
    calls = []

    def fn(_branch):
        LAUNCHES["eam_pass1"] += 1
        LAUNCHES["eam_pass3"] += 2
        calls.append(1)

    replays = []

    class Counted:
        def replay(self):
            replays.append(1)

    def capture(f, pool):
        f()                      # the Python body runs under a capture
        return Counted(), 0.0, 0.0

    steps = stepgraph.GraphSteps("cpu", capture=capture)
    for _ in range(4):
        steps.run("k", fn)
    # the capture's call of fn; four replays
    assert len(calls) == 1 and len(replays) == 4
    assert steps.captures == 1 and steps.replays == 4
    assert LAUNCHES["eam_pass1"] == 4 and LAUNCHES["eam_pass3"] == 8
    assert sum(LAUNCHES.values()) == 12
