"""The step as CUDA graphs: the port's counterpart of comd_tpu's compiled
``step_block``.

comd_tpu runs a printRate block as one compiled program: ``jax.jit`` of a
``lax.scan`` over the step, the rebucket decided on the device by
``lax.cond`` (comd_tpu/sim.py:373, :394-436; on the mesh one
``shard_map`` program, parallel/sharded.py:282-316).  Here the step is cut
at that decision into two parts, each captured once as a CUDA graph and
replayed from ``step_block``:

  - the **head**: the half kick, the drift and the skin trigger
    (``needs_rebuild``), whose flag the graph copies into a pinned host
    tensor (on a mesh the or of every shard's);
  - the **tail**, one graph a (``refresh``, ``want_energy``): the ghost
    refresh (when ``refresh``), the force with its halo fill, the second
    half kick and the bookkeeping;
  - the **rebucket**: the redistribution (sort, scatter, halo rebuild; on
    a mesh the atom exchange; on the list paths the rebuild NL1) into the
    same buffers.

The host reads the flag once a step: one stream synchronize, counted by
``torch.cuda.set_sync_debug_mode``.  A clear flag replays the tail and at
once the next step's head, so the card runs them back to back while the
host waits; a set flag replays the rebucket, then the tail without the
refresh (comd_tpu's ``lax.cond`` branch, taken on the host: conditional
graph nodes would take it onto the device).  A graph replays fixed
addresses, so the state lives in buffers the step owns (``keep``) and
every update is in place; whatever replaced a buffer's tensor between
blocks (a restore, a test, ``compute_force``) is copied into it before the
next replay.

A graph is captured at the first use of its key, right after that use has
run the same function eagerly: the eager run is that step's own work and
warms every lazy cache (the brick and fill plans, the kernels' builds and
shared-memory limits, the comm kernel's occupancy query), so the capture
records launches only.  A graph keeps the launches' parameters as they
were at its capture (the pair evaluator's constants and tables, the brick
and fill plans, every address), so it belongs to one simulation and one
``want_energy``.  All graphs of a simulation share one memory pool:
their temporaries are written and read within one replay, and the replays
never overlap.  The kernels' Python wrappers count their launches
(``ops.cuda.LAUNCHES``) when they run, which a replay does not: each
capture records the counts its function added, takes them back (a capture
launches nothing) and credits them on every replay.

A capture or replay that fails raises: nothing steps eagerly in its
place.  ``EagerSteps`` runs the same head and tail functions as a Python
loop of launches: on the CPU, in a multi-process launch, and on the card
when a simulation's ``cuda_graphs`` is False (for comparison).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .ops.cuda import LAUNCHES


def keep(bufs: dict, tensors: dict) -> bool:
    """Bring the step's buffers ``bufs`` (name -> tensor, filled in place)
    up to date with ``tensors`` (name -> the tensor that now holds that
    value): a tensor that is its buffer is skipped, another one is copied
    into it, and a name without a buffer of the same shape, dtype and
    device gets a clone of its own.  Returns True when a buffer was made
    (the graphs captured on the old ones must go)."""
    made = False
    for name, t in tensors.items():
        b = bufs.get(name)
        if b is t:
            continue
        if b is None or b.shape != t.shape or b.dtype != t.dtype or \
                b.device != t.device:
            bufs[name] = t.clone(memory_format=torch.contiguous_format)
            made = True
        else:
            b.copy_(t)
    return made


def run_block(steps, wants: Sequence[bool], head: Callable,
              tail: Callable, rebucket: Callable, read: Callable) -> int:
    """One block of lazy or list steps; returns how many of them
    rebucketed.  ``wants[k]``: step k computes the energy terms.
    ``head()`` kicks, drifts and returns the trigger (a 0-dim bool
    tensor), ``read`` reduces it to a Python bool (on a mesh of processes
    an allgather), ``rebucket()`` redistributes into the buffers, and
    ``tail(refresh, want_energy)`` finishes the step.  ``steps``
    (``GraphSteps`` or ``EagerSteps``) runs or replays them; the host
    counts the rebuckets, since a replay runs no Python."""
    n_rebucket = 0
    if not wants:
        return n_rebucket
    steps.head(head)
    for k, want in enumerate(wants):
        if steps.read(read):
            steps.run(("rebucket",), rebucket)
            n_rebucket += 1
            steps.run(("tail", False, want), lambda w=want: tail(False, w))
        else:
            steps.run(("tail", True, want), lambda w=want: tail(True, w))
        if k + 1 < len(wants):
            steps.head(head)
    return n_rebucket


class EagerSteps:
    """The head and tail run as they are: a Python loop of launches."""

    def head(self, fn: Callable) -> None:
        self._flag = fn()

    def read(self, reduce: Callable) -> bool:
        return reduce(self._flag)

    def run(self, key, fn: Callable) -> None:
        fn()


def cuda_capture(fn: Callable, pool):
    """A CUDA graph of ``fn``'s launches, captured on a side stream, its
    memory from ``pool``: ``torch.cuda.graph`` without its
    ``gc.collect()`` and ``empty_cache()``, which would cost a capture in
    the middle of a run tens of ms and free the cached memory the eager
    steps reuse."""
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        g.capture_begin(pool=pool)
        try:
            fn()
        finally:
            g.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return g


class GraphSteps:
    """The captured head, tails and rebucket of one simulation on one card,
    replayed.

    ``capture(fn, pool)`` makes a graph object with ``replay()`` (a CUDA
    graph by default; the CPU tests give a stub).  ``replays`` and
    ``captures`` count what this object did."""

    def __init__(self, device, capture: Callable = cuda_capture):
        self.device = torch.device(device)
        self._capture_fn = capture
        self.graphs = {}            # key -> (graph, launch counts a replay)
        cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        # the head's flag lands here; pinned so the graph copies it itself
        self.flag = torch.zeros((), dtype=torch.bool, pin_memory=cuda)
        self._eager_flag = None
        self.replays = 0
        self.captures = 0

    def _capture(self, key, fn: Callable) -> None:
        before = dict(LAUNCHES)
        graph = self._capture_fn(fn, self.pool)
        added = {k: v - before[k] for k, v in LAUNCHES.items()
                 if v != before[k]}
        LAUNCHES.update(before)     # a capture launches nothing
        self.graphs[key] = (graph, added)
        self.captures += 1

    def _replay(self, key) -> None:
        graph, added = self.graphs[key]
        graph.replay()
        for k, v in added.items():
            LAUNCHES[k] += v
        self.replays += 1

    def run(self, key, fn: Callable) -> None:
        """Replay ``key``'s graph; at its first use run ``fn`` eagerly (the
        step's own work), then capture it."""
        if key in self.graphs:
            self._replay(key)
            return
        fn()
        self._capture(key, fn)

    def head(self, fn: Callable) -> None:
        if "head" in self.graphs:
            self._eager_flag = None
            self._replay("head")
            return
        self._eager_flag = fn()
        self._capture("head",
                      lambda: self.flag.copy_(fn(), non_blocking=True))

    def read(self, reduce: Callable) -> bool:
        """The head's flag on the host: after a replay, one synchronize of
        the stream that holds the head and the pinned copy; after the eager
        first head, ``reduce`` of its tensor."""
        if self._eager_flag is not None:
            return reduce(self._eager_flag)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return bool(self.flag)
