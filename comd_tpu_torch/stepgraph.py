"""The step as CUDA graphs: the port's counterpart of comd_tpu's compiled
``step_block``.

comd_tpu runs a printRate block as one compiled program: ``jax.jit`` of a
``lax.scan`` over the step, the skin-triggered rebucket taken on the
device by ``lax.cond`` (comd_tpu/sim.py:319-320, :373-375, :403-422; on
the mesh one ``shard_map`` program, parallel/sharded.py:416, :478).  Here
each step is one CUDA graph, captured once a ``want_energy`` and replayed
``n`` times from ``step_block`` with no host read between the replays:

  - a lazy or list step: the head (half kick, drift and the skin trigger,
    one ``kick_drift_trigger`` launch over the stack of every shard,
    ops/cuda/step.py, the flag the or of the shards' triggers; serially
    the same launch writes the ghost images), then a conditional IF node a
    body on the trigger (``ops/cuda/graph_if.py``: the step's
    ``Condition`` holds their handles, made in the captured graph before
    the head, whose trigger launch sets them, the first to the
    trigger, the second to its negation; torch 2.11 has no conditional
    node that Python reaches): if set, the rebucket (sort, scatter, halo
    rebuild; on a mesh the atom exchange and in-cell sort; on the list
    paths the rebuild, NR's rows and NL1, into the list's buffers; the
    new baseline; one more on a device rebucket counter), and on a mesh,
    if clear, the position exchange
    (under -a 1 with the copy of the positions the interior sweeps read;
    serially the head has refreshed the ghosts: no second body); then
    the rest both branches share (the force with its halo fill, the
    second half kick, the bookkeeping; on the list paths pass 2 and the
    landing from the list's rows, ER and LR);
  - a ``-S 0`` step (comd_tpu's ``_make_step`` and ``_shard_step``):
    drift, rebucket and rest, no condition; under -a 1 the interior
    sweeps' positions are selected on the device.

The host reads the rebucket counter once a block, at its end: the
simulation's ``n_rebucket``/``n_nl_build`` and the launch credits of the
rebucket bodies come from it.  A graph replays fixed addresses, so the
state lives in buffers the step owns (``keep``; a per-shard field one
[S, ...] stack of every shard, each shard's state its views) and every
update is in place; whatever replaced a buffer's tensor between blocks (a restore, a
test, ``compute_force``) is copied into it before the next replay, and
whatever the rest reads after a conditional body (the positions, counts,
lists, baseline, -a 1's interior positions) lies in a buffer both bodies
write.

A conditional graph records both bodies at once, so before its capture
the step runs once on throwaway clones of the buffers (``scratch``) with
both branches taken: that warms every lazy cache of either body (the
brick and fill plans, the kernels' builds and shared-memory limits, the
comm kernel's occupancy query) without moving the real state, and the
capture records launches only.  A graph keeps the launches' parameters
as they were at its capture (the pair evaluator's constants and tables,
the plans, every address), so it belongs to one simulation and one
``want_energy``.  All graphs of a simulation share one memory pool, and
their conditional bodies another (``BodyPool``).  The
kernels' Python wrappers count their launches (``ops.cuda.LAUNCHES``)
when they run, which a replay does not: each capture records the counts
its step added (each conditional body's apart), takes them back (a
capture launches nothing; the warm-up's launches are throwaway work,
taken back too) and credits on every replay the common part and the
false body (a mesh's position exchange; none serially); ``settle``
adds, for each rebucket of the block, the rebucket body's counts less
the false body's.

A capture or replay that fails raises: nothing steps eagerly in its
place.  ``EagerSteps`` runs the same step functions as a Python loop of
launches, the trigger read on the host every step: on the CPU, in a
multi-process launch, and on the card when a simulation's
``cuda_graphs`` is False (for comparison).
"""
from __future__ import annotations

import gc
import time
import weakref
from typing import Callable

import torch

from .ops.cuda import LAUNCHES
from .ops.cuda.graph_if import BodyPool, Condition, condition, if_node


def _is_view(t: torch.Tensor, b: torch.Tensor) -> bool:
    """``t`` is the buffer view ``b`` itself: the same elements."""
    return t.data_ptr() == b.data_ptr() and t.shape == b.shape and \
        t.stride() == b.stride() and t.dtype == b.dtype and \
        t.device == b.device


def keep(bufs: dict, tensors: dict) -> bool:
    """Bring the step's buffers ``bufs`` (name -> tensor, filled in place)
    up to date with ``tensors`` (name -> the tensor that now holds that
    value, or for a per-shard field the list of the shards' tensors, whose
    buffer is one [S, ...] stack): a tensor that is its buffer (a shard's
    that is its view of the stack) is skipped, another one is copied into
    it, and a name without a buffer of the same shape, dtype and device
    gets one of its own (a clone, or the shards stacked).  Returns True
    when a buffer was made (the graphs captured on the old ones must
    go)."""
    made = False
    for name, t in tensors.items():
        b = bufs.get(name)
        if b is t:
            continue
        if isinstance(t, torch.Tensor):
            shape, dtype, device = t.shape, t.dtype, t.device
        else:
            shape = (len(t),) + tuple(t[0].shape)
            dtype, device = t[0].dtype, t[0].device
        if b is None or b.shape != shape or b.dtype != dtype or \
                b.device != device:
            bufs[name] = (t.clone(memory_format=torch.contiguous_format)
                          if isinstance(t, torch.Tensor) else torch.stack(t))
            made = True
        elif isinstance(t, torch.Tensor):
            b.copy_(t)
        else:
            for i, x in enumerate(t):
                if not _is_view(x, b[i]):
                    b[i].copy_(x)
    return made


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}


class Branch:
    """How a step takes its branch (comd_tpu's lax.cond): ``cond =
    branch.condition(n)`` before the head, for ``n`` bodies (1: no false
    body), which writes the trigger into ``cond.flag`` (and sets
    ``cond.handles``, if any, on the device), then ``branch(cond,
    if_true, if_false)`` (``if_false`` None with one body).  Here no
    handles, and the branch taken on the host from ``read(cond.flag)``."""

    def __init__(self, read: Callable = bool):
        self.read = read

    def condition(self, n: int = 2) -> Condition:
        return Condition()

    def __call__(self, cond: Condition, if_true: Callable,
                 if_false: Callable = None) -> None:
        body = if_true if self.read(cond.flag) else if_false
        if body is not None:
            body()


class _Both(Branch):
    """Both bodies taken (the warm-up before a capture)."""

    def __call__(self, cond, if_true, if_false=None) -> None:
        if_true()
        if if_false is not None:
            if_false()


_both = _Both()


class _Nodes(Branch):
    """The branch inside a capture: the condition's handles made in the
    captured graph, each body an IF node on one of them (``wrap``: what a
    body runs as, here its launches counted)."""

    def __init__(self, device, pool, wrap: Callable):
        self.device, self.pool, self.wrap = device, pool, wrap

    def condition(self, n: int = 2) -> Condition:
        return condition(self.device, n)

    def __call__(self, cond, if_true, if_false=None) -> None:
        for k, body in enumerate((if_true, if_false)):
            if body is not None:
                if_node(cond, k, self.wrap(body), self.pool)


class EagerSteps:
    """The steps run as they are: a Python loop of launches, each
    condition read on the host through ``read`` (on a mesh of processes
    an or over them)."""

    def __init__(self, read: Callable):
        self._branch = Branch(read)

    def run(self, key, fn: Callable) -> None:
        fn(self._branch)

    def settle(self, n_taken: int) -> None:
        """The wrappers counted their launches as they ran."""


def cuda_capture(fn: Callable, pool):
    """A CUDA graph of ``fn``'s launches, captured on a side stream, its
    memory from ``pool``, then instantiated: ``torch.cuda.graph`` without
    its ``gc.collect()`` and ``empty_cache()``, which would cost a capture
    in the middle of a run tens of ms and free the cached memory the eager
    steps reuse.  Returns (graph, capture seconds, instantiation
    seconds)."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    t0 = time.perf_counter()
    # no garbage collection inside the capture: it could destroy another
    # simulation's graphs and release their pools, which a capture refuses
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            g.capture_begin(pool=pool)
            try:
                fn()
            finally:
                g.capture_end()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.current_stream().wait_stream(side)
    t1 = time.perf_counter()
    g.instantiate()
    return g, t1 - t0, time.perf_counter() - t1


class GraphSteps:
    """The captured steps of one simulation on one card, replayed.

    ``capture(fn, pool)`` makes (graph, capture s, instantiation s) with
    ``graph.replay()`` (a CUDA graph by default; the CPU tests give a stub
    whose replay calls ``fn`` again, so each condition, ``if_node``'s
    plain version on the CPU, is read at replay); ``scratch()`` (a
    context manager) points the step at throwaway clones of its buffers
    while both branches are warmed before a capture, or None (nothing to
    warm).  ``replays``, ``captures``, ``capture_s`` and
    ``instantiate_s`` count what this object did."""

    def __init__(self, device, capture: Callable = cuda_capture,
                 scratch: Callable = None):
        self.device = torch.device(device)
        self._capture_fn = capture
        # held weakly: the simulation that owns the scratch holds this
        self._scratch = None if scratch is None else weakref.WeakMethod(
            scratch)
        # key -> (graph, launch counts a replay)
        self.graphs = {}
        # launch counts a taken condition adds to a replay's: the true
        # body's less the false body's
        self.taken = None
        cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        # the conditional bodies' memory
        self.body_pool = BodyPool(self.device) if cuda else None
        self.replays = 0
        self.captures = 0
        self.capture_s = 0.0
        self.instantiate_s = 0.0

    def _capture(self, key, fn: Callable) -> None:
        before = dict(LAUNCHES)
        if self._scratch is not None:
            with self._scratch()():
                fn(_both)
            LAUNCHES.update(before)  # throwaway work, none of the run's
        bodies = []                  # launch counts of each body, in order

        def measured(body):
            def run():
                b0 = dict(LAUNCHES)
                body()
                bodies.append(_delta(b0))
            return run

        branch = _Nodes(self.device, self.body_pool, measured)
        graph, t_cap, t_inst = self._capture_fn(lambda: fn(branch),
                                                self.pool)
        added = _delta(before)
        LAUNCHES.update(before)      # a capture launches nothing
        if bodies:                   # one condition: (if set[, if clear])
            if_true, if_false = bodies[0], dict(*bodies[1:2])
            for k, v in if_true.items():
                added[k] -= v        # the false body stays in a replay
            taken = {k: if_true.get(k, 0) - if_false.get(k, 0)
                     for k in set(if_true) | set(if_false)}
            self.taken = {k: v for k, v in taken.items() if v}
        self.graphs[key] = (graph, {k: v for k, v in added.items() if v})
        self.captures += 1
        self.capture_s += t_cap
        self.instantiate_s += t_inst

    def _replay(self, key) -> None:
        graph, added = self.graphs[key]
        graph.replay()
        for k, v in added.items():
            LAUNCHES[k] += v
        self.replays += 1

    def run(self, key, fn: Callable) -> None:
        """Replay ``key``'s graph, capturing it from ``fn`` at its first
        use."""
        if key not in self.graphs:
            self._capture(key, fn)
        self._replay(key)

    def settle(self, n_taken: int) -> None:
        """Credit the rebucket bodies of a block's ``n_taken`` rebuckets."""
        for k, v in (self.taken or {}).items():
            LAUNCHES[k] += n_taken * v

