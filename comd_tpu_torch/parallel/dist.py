"""The multi-process launch: process groups, gathers and the peer exchange.

The counterpart of the ``jax.distributed`` and ``multihost_utils`` calls
comd_tpu makes (comd_tpu/cli.py:417-427, parallel/sharded.py:721-727,
utils/timers.py:122-144), and of the reference's MPI layer (initParallel
and sendReceiveParallel, parallel.c:66-118).  Every process runs the same
program; ``init`` joins the group over an explicit ``tcp://`` address.

The backend is chosen once, before any launch, from the device count alone
(``backend_for``):

  * ``--device cpu``: gloo;
  * CUDA with a card for every process of the host
    (``torch.cuda.device_count() >= num_procs``): NCCL, process p on
    ``cuda:{p % count}``, sending device tensors (not yet run on a host
    with two or more cards);
  * CUDA with processes sharing a card: gloo, each message copied into a
    pinned host buffer, sent, received into a pinned buffer and copied
    onto the card -- the reference's own base transport (pinned host
    buffers with MPI send/recv, haloExchange.c:209-272).

A failure of ``init_process_group``, of a send or of a receive raises;
nothing retries on another backend.  Without ``init`` every function here
describes the single process (index 0 of 1).

The kernel-initiated transports across processes (parallel/ki_comm.py)
move their planes through CUDA IPC, not through the group: the group only
gathers the arenas' handles once (``allgather`` of uint8 numpy), and
``destroy`` frees the arenas (``at_destroy``) after a barrier, so that no
process still writes into memory that another frees.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as tdist


def backend_for(device_type: str, num_procs: int, cuda_count: int):
    """(backend, staged) for ``num_procs`` processes of one host on
    ``device_type`` with ``cuda_count`` cards."""
    if device_type == "cpu":
        return "gloo", False
    if device_type != "cuda":
        raise ValueError(f"no multi-process backend for device "
                         f"{device_type!r}")
    if cuda_count >= num_procs:
        return "nccl", False
    return "gloo", True


def init(num_procs: int, coordinator: str, proc_id: int,
         device: str) -> torch.device:
    """Join the group of ``num_procs`` processes at ``coordinator``
    (host:port, process 0's listening address) as ``proc_id``.  Returns the
    device this process runs on."""
    if not coordinator:
        raise ValueError("--numProcs > 1 needs --coordinator HOST:PORT")
    if not 0 <= proc_id < num_procs:
        raise ValueError(f"--procId {proc_id} is outside 0..{num_procs - 1}")
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and count == 0:
        raise RuntimeError("--device cuda but torch sees no CUDA device")
    backend, _staged = backend_for(dev.type, num_procs, count)
    if dev.type == "cuda":
        dev = torch.device("cuda", proc_id % count)
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                             world_size=num_procs, rank=proc_id)
    return dev


_AT_DESTROY = []     # closers of the ki arenas, run by destroy


def at_destroy(fn) -> None:
    """Run ``fn`` (an arena's close) in ``destroy``, after every process
    has finished its writes and before the group goes."""
    _AT_DESTROY.append(fn)


def destroy() -> None:
    """Leave the group.  The ki arenas go first: every process waits for
    its card, then for the others (a barrier), so that no peer's last
    write lands in freed memory; then each arena is closed and freed.
    While an exception propagates (this process failed) there is no
    barrier, which the peers may never reach: the memory goes with the
    process."""
    if _AT_DESTROY:
        failed = sys.exc_info()[0] is not None
        if not failed:
            torch.cuda.synchronize()
            barrier()
        while _AT_DESTROY:
            fn = _AT_DESTROY.pop()
            if not failed:
                fn()
    if tdist.is_initialized():
        tdist.destroy_process_group()


def all_ok(ok: bool) -> bool:
    """Whether ``ok`` holds on every process (an allgather): a step that
    one process failed fails on all, instead of leaving the others waiting
    for it."""
    return bool(allgather(np.array([ok], np.uint8)).all())


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def describe(device) -> str:
    """The backend and staging of the group, as the prolog prints them."""
    backend = tdist.get_backend()
    if _staged(torch.device(device)):
        return f"{backend}, staged through pinned host buffers"
    return backend


def _staged(device: torch.device) -> bool:
    return device.type == "cuda" and tdist.get_backend() == "gloo"


def barrier() -> None:
    if tdist.is_initialized():
        tdist.barrier()


def _wire() -> torch.device:
    """Where a collective's tensors live: this process's card under NCCL,
    else the host."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather(x):
    """Every process's ``x`` (a numpy array or a tensor, the same shape and
    dtype on every process), stacked [process_count, ...] in process
    order, as numpy or as a tensor on ``x``'s device.  The bytes travel
    unchanged."""
    if isinstance(x, np.ndarray):
        return allgather(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    if process_count() == 1:
        return x[None]
    b = x.detach().contiguous().reshape(-1).view(torch.uint8).to(_wire())
    out = [torch.empty_like(b) for _ in range(process_count())]
    tdist.all_gather(out, b)
    return (torch.stack(out).view(x.dtype)
            .reshape((len(out),) + tuple(x.shape)).to(x.device))


def gather_to_root(x: np.ndarray):
    """Every process's ``x`` (same shape and dtype everywhere) stacked
    [process_count, ...] on process 0; None on the others."""
    if process_count() == 1:
        return x[None]
    b = torch.from_numpy(np.ascontiguousarray(x).reshape(-1)
                         .view(np.uint8)).to(_wire())
    root = process_index() == 0
    out = [torch.empty_like(b) for _ in range(process_count())] \
        if root else None
    tdist.gather(b, out, dst=0)
    if not root:
        return None
    return (torch.stack(out).cpu().numpy().view(x.dtype)
            .reshape((len(out),) + x.shape))


def exchange(sends: dict, nbytes: dict, bufs: dict, stats: dict) -> dict:
    """One exchange with each peer process: ``sends[peer]`` (a flat uint8
    tensor) goes to ``peer`` and ``nbytes[peer]`` bytes come back from it,
    in one ``batch_isend_irecv``, peers in increasing order on both sides.
    Returns {peer: received uint8 tensor on the senders' device}.

    ``bufs`` holds the receive buffers (and, when staged, the pinned host
    buffers) of this stage, one set a peer, made on first use and reused by
    every later call with the same ``bufs``.  With ``stats["time"]`` true
    it sums the host seconds of the staging copies into ``stats["stage_s"]``
    (after waiting for the card, so that they are the copies' alone) and of
    the transfer into ``stats["transfer_s"]``."""
    peers = sorted(nbytes)
    dev = sends[peers[0]].device
    staged = _staged(dev)
    for q in peers:
        if q not in bufs:
            pin = dict(dtype=torch.uint8, pin_memory=True)
            bufs[q] = (torch.empty(nbytes[q], dtype=torch.uint8, device=dev),
                       torch.empty(sends[q].numel(), **pin) if staged
                       else None,
                       torch.empty(nbytes[q], **pin) if staged else None)
    timed = bool(stats.get("time"))
    if staged and timed:
        torch.cuda.current_stream(dev).synchronize()
    t0 = time.perf_counter()
    if staged:
        for q in peers:
            bufs[q][1].copy_(sends[q], non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    t1 = time.perf_counter()
    ops = []
    for q in peers:
        recv, hsend, hrecv = bufs[q]
        ops.append(tdist.P2POp(tdist.isend, hsend if staged else sends[q],
                               q))
        ops.append(tdist.P2POp(tdist.irecv, hrecv if staged else recv, q))
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    t2 = time.perf_counter()
    if staged:
        # the next call of this stage overwrites the pinned buffer only
        # after its own synchronize, which waits for this copy
        for q in peers:
            bufs[q][0].copy_(bufs[q][2], non_blocking=True)
    if timed:
        stats["stage_s"] = (stats.get("stage_s", 0.0) + (t1 - t0)
                            + time.perf_counter() - t2)
        stats["transfer_s"] = stats.get("transfer_s", 0.0) + (t2 - t1)
    return {q: bufs[q][0] for q in peers}
