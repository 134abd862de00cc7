"""Conditional IF nodes of the step's CUDA graph (csrc/graph_if.cu).

comd_tpu takes the skin-triggered rebucket on the device with
``lax.cond`` (comd_tpu/sim.py:319-320, :373-375; parallel/sharded.py:416,
:478).  Its counterpart inside a CUDA graph capture is a ``Condition``
made by ``condition`` before the step's head, whose trigger kernel
(ops/cuda/step.kick_drift_trigger) writes the trigger and sets the
conditional handles at every replay, then ``if_node(cond, k, body)``:
``body``'s launches become the body of a conditional IF node on handle
``k`` (0: run when the trigger is set, 1: when it is clear; a step
without a false body makes one handle).  The branch is taken on the
device with no read by the host and no kernel of its own.

The body is captured on a stream of its own (``cudaStreamBeginCaptureToGraph``
into the IF node's body graph) while PyTorch's capture of the step goes
on.  Its allocations go to a private memory pool of the bodies
(``BodyPool``; PyTorch records a pool no second time while its capture
records into it), kept as long as the graphs that replay them, so
whatever a body allocates is not handed to eager code between replays
(torch._C's ``_cuda_beginAllocateCurrentStreamToPool``, the call behind
PyTorch's own routing of a stream into a pool).

On a CPU trigger ``if_node`` runs its plain version: the trigger read on
the host and the body run or not, now.  A CUDA trigger needs the handles
of a capture, else it raises (a condition outside a graph is a host
read: use ``bool``).
"""
from __future__ import annotations

import ctypes
import os
import threading
import weakref
from typing import Callable

import torch

from .nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "graph_if.cu")

_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process
_BODY_STREAMS = {}     # device index -> the stream bodies are captured on


def build():
    """Compile csrc/graph_if.cu for sm_90a (first use) and bind it."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "graph_if")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.comd_if_handle.restype = i
        lib.comd_if_handle.argtypes = [p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.comd_if_begin.restype = i
        lib.comd_if_begin.argtypes = [p, ctypes.c_ulonglong, p]
        lib.comd_if_end.restype = i
        lib.comd_if_end.argtypes = [p]
        lib.comd_if_stream_create.restype = i
        lib.comd_if_stream_create.argtypes = [i, ctypes.POINTER(p)]
        lib.comd_if_error_string.restype = ctypes.c_char_p
        lib.comd_if_error_string.argtypes = [i]
        _lib = lib
        return lib


#: comd_if_begin's steps, as its error codes carry them
_STEPS = ("", "capture info", "add the IF node",
          "update the capture's dependencies", "begin the body's capture")


def _check(err: int, what: str) -> None:
    if err:
        msg = build().comd_if_error_string(err).decode()
        step = _STEPS[err // 100000] if err < 500000 else ""
        raise RuntimeError(f"{what} failed" + (f" at {step}" if step else "")
                           + f": {msg} (error {err % 100000})")


def _body_stream(dev: int):
    """The stream IF bodies are captured on, one a device, made by
    csrc/graph_if.cu: ``torch.cuda.Stream()`` hands out its pool's
    streams round robin, so it could give the stream of the capture a
    body joins (which cannot capture twice)."""
    s = _BODY_STREAMS.get(dev)
    if s is None:
        handle = ctypes.c_void_p()
        _check(build().comd_if_stream_create(dev, ctypes.byref(handle)),
               "the IF bodies' stream")
        s = _BODY_STREAMS[dev] = torch.cuda.ExternalStream(
            handle.value, device=torch.device("cuda", dev))
    return s


class BodyPool:
    """The private memory pool IF bodies allocate from, held from its
    creation until ``close()`` or the object's collection: a body's
    temporaries live at the same addresses at every replay."""

    def __init__(self, device):
        device = torch.device(device)
        self.device = device.index if device.index is not None \
            else torch.cuda.current_device()
        self.id = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(_body_stream(self.device)):
            # makes the pool, held once
            torch._C._cuda_beginAllocateCurrentStreamToPool(self.device,
                                                            self.id)
            torch._C._cuda_endAllocateToPool(self.device, self.id)
        self._close = weakref.finalize(self, torch._C._cuda_releasePool,
                                       self.device, self.id)

    def close(self) -> None:
        self._close()


class Condition:
    """A step's branch condition: ``flag``, the trigger its head writes (a
    0-dim bool), and ``handles``, the IF nodes' conditional handles the
    head's trigger kernel sets inside a capture (0: the trigger, 1, if
    made: its negation), () elsewhere."""

    def __init__(self, handles: tuple = ()):
        self.handles = tuple(handles)
        self.flag = None


def condition(device, n: int = 2) -> Condition:
    """The condition of a branch of the graph being captured on
    ``device``'s current stream: ``n`` new handles of that graph (1 or 2,
    one a body: for the head to set, before ``if_node`` adds their
    nodes).  On the CPU, or on the card outside a capture, none."""
    if n not in (1, 2):
        raise ValueError(f"a condition has one or two handles, not {n}")
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        return Condition()
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    handles = []
    for _ in range(n):
        h = ctypes.c_ulonglong()
        _check(lib.comd_if_handle(stream, ctypes.byref(h)),
               "the IF node's conditional handle")
        handles.append(h.value)
    return Condition(handles)


def if_node_plain(pred: torch.Tensor, body: Callable,
                  negate: bool = False) -> None:
    """The plain version: ``body()`` now when ``pred`` (xor ``negate``)."""
    if bool(pred) != negate:
        body()


def if_node(cond: Condition, k: int, body: Callable,
            pool: BodyPool = None) -> None:
    """Capture ``body()`` into an IF node, on ``cond.handles[k]``, of the
    graph being captured on the current stream after its launches so far
    (the head's, which sets the handle): run at replay when the trigger
    ``cond.flag`` is set (``k`` 0) or clear (``k`` 1); ``pool``: where the
    body allocates (held as long as the graph).  A CPU trigger runs the
    plain version."""
    pred = cond.flag
    if not isinstance(pred, torch.Tensor) or pred.dim() != 0 or \
            pred.dtype != torch.bool:
        raise ValueError(f"an IF node's trigger is a 0-dim bool, got "
                         f"{pred!r}")
    if pred.device.type != "cuda":
        if_node_plain(pred, body, bool(k))
        return
    if not 0 <= k < len(cond.handles):
        raise ValueError(f"a CUDA trigger's IF node needs handle {k} of a "
                         f"capture (graph_if.condition), set by the head")
    if pool is None:
        raise ValueError("if_node needs a BodyPool for the body's memory")
    lib = build()
    dev = pool.device
    stream = torch.cuda.current_stream(dev)
    body_stream = _body_stream(dev)
    _check(lib.comd_if_begin(stream.cuda_stream, cond.handles[k],
                             body_stream.cuda_stream),
           "the IF node's capture")
    try:
        with torch.cuda.stream(body_stream):
            # the body stream's allocations into the pool
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool.id)
            try:
                body()
            finally:
                torch._C._cuda_endAllocateToPool(dev, pool.id)
                torch._C._cuda_releasePool(dev, pool.id)
    finally:
        _check(lib.comd_if_end(body_stream.cuda_stream),
               "the IF node's body capture")
