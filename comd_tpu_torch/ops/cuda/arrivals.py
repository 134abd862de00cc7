"""The atom exchange's unload on hand-written CUDA kernels
(csrc/arrivals.cu, one source, one build, -fmad=false).

comd_tpu has no Pallas kernel for it: its ``binning.append_arrivals``
(comd_tpu/ops/binning.py:175-214) and ``sort_cells`` (:217-232) run
inside its per-shard XLA program.  As PyTorch ops (``append_arrivals_plain``:
the f64 binning, a stable ``torch.sort``, a run rank, seven scatters and
the count add, ~143 operations; ``sort_cells_plain``) a 2x2x2 mesh's
redistribution made 48 appends and 8 sorts, ~6,900 launches, so here
they are three kernels:

- ``arrivals_bin``: one thread an arrival slot of every (shard,
  direction) source of a stage loads the slot beside its mask, shifts it
  into the receiver's frame, bins it in f64 (csrc/bin.cuh, as
  rebucket_bin does) and stages it as one record in its cell (one atomic
  a warp and a cell); the first to stage into a cell lists it, each
  block's firsts behind one atomic on the list's length;
- ``arrivals_place``: a grid sized to the card (``place_blocks``) whose
  warps stride over the list, a warp a listed cell: it ranks the cell's
  records by (direction, gid, place) (k <= 32: by shuffles in
  registers), writes them to slots n_atoms + rank < A, adds the count,
  sets the overflow flag where a slot reached A and clears its counter;
  the last block to read the list's length clears it; cells without
  arrivals are left as they were;
- ``sort_cells``: every cell of every shard sorted by gid (stable: ties,
  the empty slots' EMPTY_GID, by slot) in one launch, in place or into
  other tensors; A <= 32 in the warp form (a cell a warp segment, a slot
  a lane, its seven words loaded together and ranked by shuffles), larger
  A in the block form (``sort_form``).

``append_stage`` takes one exchange stage's arrivals of both directions
for every shard of the process and appends them in place (two launches,
or two a 32 shards); ``sort_shards`` sorts every shard (one launch, or
one a 64 shards).  ``append_arrivals`` and ``sort_cells`` keep comd_tpu's
one-shard signatures and return new tensors.  Beside them sit the plain
versions, the port's torch code as it was; the wrappers take them only
for tensors on the CPU, and a CUDA tensor launches the kernels or raises.
Kernels and plain versions give the same bits while no cell receives more
than ``stage_capacity(A)`` (C) arrivals in a stage; past that the counts
and the overflow flag still agree but the stored slots of such a cell may
differ (a run with overflow aborts).  Launches are counted in
``LAUNCHES`` under the kernels' names.  The staging (the records, the
length the last place launch read, then the list of the cells) and the
per-cell counters (then the list's length and the place launch's
ticket) are made at the first launch on a device at a size (a workspace
kept for the process, as rebucket.py's: a captured graph replays its
addresses), which must not be inside a CUDA graph capture; every place
launch leaves the counters, the length and the ticket clear.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from .. import binning
from . import LAUNCHES
from . import rebucket as rebucket_ops
from .nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "arrivals.cu")
MAX_SHARDS = 32         # csrc/arrivals.cu's kMaxShards: shards a launch
SORT_SHARDS = 64        # kSortShards: shards a sort launch
SMEM_LIMIT = 48 * 1024  # a place or sort block's shared memory, at most
MAX_A = 3072            # the largest A both fit (16 bytes a slot)

_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None    # wall time of the nvcc build in this process
_WORK = {}              # device index -> [Workspace, ...], never freed
_LAST = {}              # device index -> (Workspace, the byte offset in its
                        # staging of the length the last launch read)
_GRID = {}              # (device index, elem, A) -> place launch blocks

stage_capacity = rebucket_ops.stage_capacity


def place_warps(A: int) -> int:
    """Warps a place block: 8, fewer where their keys (8 bytes a staged
    record, C a cell) would pass the shared memory limit."""
    return max(1, min(8, SMEM_LIMIT // (8 * stage_capacity(A))))


def sort_form(A: int) -> str:
    """The sort launch's form: "warp" (a cell a warp segment of A rounded
    up to a power of two lanes) for A <= 32, else "block"."""
    return "warp" if A <= 32 else "block"


def sort_smem(A: int) -> int:
    """Shared memory bytes of a sort block (csrc/arrivals.cu's sort_smem):
    16 a slot of as many cells as fit 256 threads with one a slot."""
    return (256 // A if A < 256 else 1) * A * 16


class _Source(ctypes.Structure):
    """csrc/arrivals.cu's ArrivalSource."""
    _fields_ = [(name, ctypes.c_void_p) for name in ("r", "p", "gid", "mask")]


class _Args(ctypes.Structure):
    """csrc/arrivals.cu's ArrivalsArgs, field for field."""
    _fields_ = [("src", (_Source * 2) * MAX_SHARDS)] + [
        (name, ctypes.c_void_p * MAX_SHARDS)
        for name in ("r", "p", "gid", "n_atoms")] + [
        (name, ctypes.c_void_p)
        for name in ("overflow", "stage", "counts", "list", "list_n",
                     "listed", "box_of_tuple")] + [
        ("local_min", ctypes.c_double * 3),
        ("local_max", ctypes.c_double * 3),
        ("inv_box", ctypes.c_double * 3),
        ("shift", ctypes.c_double * 2),
        ("grid", ctypes.c_int * 3)] + [(name, ctypes.c_int) for name in (
            "n_local", "B", "A", "C", "M", "n_shards", "n_dirs", "axis",
            "mask_counts", "place_warps", "place_blocks")]


class _SortArgs(ctypes.Structure):
    """csrc/arrivals.cu's SortArgs, field for field."""
    _fields_ = [(name, ctypes.c_void_p * SORT_SHARDS) for name in (
        "r", "p", "gid", "out_r", "out_p", "out_gid")] + [
        (name, ctypes.c_int) for name in ("n_shards", "B", "A", "form")]


def build():
    """Compile csrc/arrivals.cu for sm_90a (first use) and bind it.
    -fmad=false: the shift and the bin round each operation once, as
    PyTorch's eager kernels do."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "arrivals",
                                           ("-fmad=false",))
        for name, args in (("comd_arrivals", _Args),
                           ("comd_sort_cells", _SortArgs)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(args),
                           ctypes.c_void_p]
        lib.comd_arrivals_place_blocks.restype = ctypes.c_int
        lib.comd_arrivals_place_blocks.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.comd_arrivals_error_string.restype = ctypes.c_char_p
        lib.comd_arrivals_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------

def append_arrivals_plain(geom, maps, r, p, gid, n_atoms, arr_r, arr_p,
                          arr_gid, arr_valid):
    """Plain PyTorch: as ``append_arrivals`` (the port's torch code as it
    was: a stable sort on box << 31 | gid, a run rank and the scatters)."""
    A = r.shape[-1]
    B = r.shape[1]
    box = binning.box_from_coord(geom, maps, arr_r)
    box = torch.where(arr_valid, box, geom.n_total)
    # invalid entries sort last whatever their gid holds
    box_s, perm = binning._sort_by_box_gid(
        box, torch.where(arr_valid, arr_gid, int(binning.EMPTY_GID)))
    rank, run_len = binning._run_rank(box_s, geom.n_total + 1)

    in_cell = box_s < geom.n_total
    slot = n_atoms.to(torch.int64)[box_s.clamp(max=B - 1)] + rank
    overflow = (in_cell & (slot >= A)).any()
    dest = torch.where(in_cell & (slot < A), box_s * A + slot, B * A)

    def scatter(field, vals):
        out = torch.cat([field.reshape(B * A), field.new_empty(1)])
        out[dest] = vals[perm]               # slot B*A collects the drops
        return out[:B * A].reshape(B, A)

    r = torch.stack([scatter(r[a], arr_r[a]) for a in range(3)])
    p = torch.stack([scatter(p[a], arr_p[a]) for a in range(3)])
    gid = scatter(gid, arr_gid)
    n_atoms = n_atoms + run_len[:B].to(torch.int32)
    return r, p, gid, n_atoms, overflow


def sort_cells_plain(r, p, gid):
    """Plain PyTorch: as ``sort_cells`` (a stable row sort, two
    gathers)."""
    gid, order = torch.sort(gid, dim=-1, stable=True)
    idx = order.expand(3, *order.shape)
    return torch.gather(r, -1, idx), torch.gather(p, -1, idx), gid


def _flat(arrival, A: int):
    """One source's (r [3, M], p [3, M], gid [M], valid [M]) as views,
    its valid flags from the sender's counts where the mask is them."""
    ar, ap, ag, mask = arrival
    ar, ap, ag = ar.reshape(3, -1), ap.reshape(3, -1), ag.reshape(-1)
    if mask.dtype != torch.bool:
        mask = (torch.arange(A, device=mask.device)[None, :]
                < mask.reshape(-1, 1)).reshape(-1)
    return ar, ap, ag, mask


def append_stage_plain(geom, maps, r, p, gid, n_atoms, arrivals, overflow,
                       axis: int = -1, shifts=(0.0, 0.0)) -> None:
    """Plain PyTorch: as ``append_stage`` (``append_arrivals_plain`` a shard
    and direction, direction 0 first, the results copied in)."""
    A = r[0].shape[-1]
    for s, dirs in enumerate(arrivals):
        for d, arrival in enumerate(dirs):
            ar, ap, ag, valid = _flat(arrival, A)
            if axis >= 0:
                ar = ar.clone()
                ar[axis] += shifts[d]        # the sender's frame -> ours
            new = append_arrivals_plain(geom, maps, r[s], p[s], gid[s],
                                        n_atoms[s], ar, ap, ag, valid)
            for t, v in zip((r[s], p[s], gid[s], n_atoms[s]), new):
                t.copy_(v)
            overflow.logical_or_(new[4])


def sort_shards_plain(r, p, gid, out=None) -> None:
    """Plain PyTorch: as ``sort_shards``."""
    for s, fields in enumerate(zip(r, p, gid)):
        dst = fields if out is None else [o[s] for o in out]
        for t, v in zip(dst, sort_cells_plain(*fields)):
            t.copy_(v)


# --------------------------------------------------------------------------
# the operand checks
# --------------------------------------------------------------------------

def _check_cells(what: str, geom, r, p, gid, n_atoms=None) -> None:
    """One shard's fields: contiguous r, p [3, B, A] (f32 or f64), gid
    [B, A] and n_atoms [B] int32 on r's device, B >= n_total."""
    if r.dim() != 3 or r.shape[0] != 3 or not r.is_contiguous() or \
            r.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: r must be a contiguous float32 or "
                         f"float64 [3, B, A], got {r.dtype} "
                         f"{tuple(r.shape)}")
    B, A = r.shape[1], r.shape[2]
    dev = r.device
    if p.shape != r.shape or p.dtype != r.dtype or p.device != dev or \
            not p.is_contiguous():
        raise ValueError(f"{what}: p must be a contiguous {r.dtype} "
                         f"{tuple(r.shape)} on {dev}")
    if gid.shape != (B, A) or gid.dtype != torch.int32 or \
            gid.device != dev or not gid.is_contiguous():
        raise ValueError(f"{what}: gid must be a contiguous int32 "
                         f"[{B}, {A}] on {dev}")
    if n_atoms is not None and (
            n_atoms.shape != (B,) or n_atoms.dtype != torch.int32 or
            n_atoms.device != dev or not n_atoms.is_contiguous()):
        raise ValueError(f"{what}: n_atoms must be a contiguous int32 "
                         f"[{B}] on {dev}")
    if geom is not None and B < geom.n_total:
        raise ValueError(f"{what}: {B} cells hold fewer than the "
                         f"{geom.n_total} of the geometry")
    if not 1 <= A <= MAX_A:
        raise ValueError(f"{what}: {A} slots a cell: the kernels' shared "
                         f"memory takes at most A = {MAX_A}")
    if B * A >= 2 ** 31:
        raise ValueError(f"{what}: {B} cells of {A} slots do not fit the "
                         f"kernels' 32-bit indices")


def _check_arrival(arrival, like: torch.Tensor, M: int, counts: bool):
    """One source: r and p contiguous of 3M values of the fields' dtype,
    gid M contiguous int32, the mask M bools or M / A int32 counts (the
    kind ``counts`` says), all on the fields' device."""
    A = like.shape[-1]
    ar, ap, ag, mask = arrival
    dev, dt = like.device, like.dtype
    for name, t in (("r", ar), ("p", ap)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous() or \
                t.dim() < 1 or t.shape[0] != 3 or t.numel() != 3 * M:
            raise ValueError(f"append_stage: arrival {name} must be a "
                             f"contiguous {dt} [3, ...] of {3 * M} values on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)}")
    if ag.dtype != torch.int32 or ag.device != dev or \
            not ag.is_contiguous() or ag.numel() != M:
        raise ValueError(f"append_stage: arrival gid must be {M} contiguous "
                         f"int32 on {dev}")
    want = (torch.int32, M // A) if counts else (torch.bool, M)
    if mask.dtype != want[0] or mask.device != dev or \
            not mask.is_contiguous() or mask.numel() != want[1] or \
            (counts and M % A):
        raise ValueError(f"append_stage: an arrival mask must be {M} "
                         f"contiguous bools or {M} / {A} int32 counts on "
                         f"{dev}, the same kind for every source")


def _check_stage(geom, maps, r, p, gid, n_atoms, arrivals, overflow,
                 axis: int) -> tuple:
    """The operands ``append_stage`` takes; raises ValueError on the
    others.  Returns (M, whether the masks are counts)."""
    n = len(r)
    if not n or not len(p) == len(gid) == len(n_atoms) == len(arrivals) == n:
        raise ValueError("append_stage: one r, p, gid, n_atoms and arrivals "
                         "entry a shard")
    for s in range(n):
        _check_cells("append_stage", geom, r[s], p[s], gid[s], n_atoms[s])
        if r[s].shape != r[0].shape or r[s].dtype != r[0].dtype or \
                r[s].device != r[0].device:
            raise ValueError("append_stage: the shards' fields differ in "
                             "shape, dtype or device")
    dev = r[0].device
    if overflow.shape != () or overflow.dtype != torch.bool or \
            overflow.device != dev:
        raise ValueError(f"append_stage: overflow must be a 0-dim bool on "
                         f"{dev}")
    if not -1 <= axis <= 2:
        raise ValueError(f"append_stage: axis {axis} is not -1, 0, 1 or 2")
    n_dirs = len(arrivals[0])
    if n_dirs not in (1, 2) or any(len(a) != n_dirs for a in arrivals):
        raise ValueError("append_stage: one or two directions, the same for "
                         "every shard")
    first = arrivals[0][0]
    M = first[2].numel()
    counts = first[3].dtype != torch.bool
    for dirs in arrivals:
        for a in dirs:
            _check_arrival(a, r[0], M, counts)
    if 2 * MAX_SHARDS * M >= 2 ** 31 or MAX_SHARDS * r[0].shape[1] >= 2 ** 31:
        raise ValueError(f"append_stage: {M} arrivals a source do not fit "
                         f"the kernels' 32-bit indices")
    if dev.type == "cuda" and geom.use_hilbert:
        t = maps.box_of_tuple
        if t.shape != tuple(geom.grid) or t.dtype != torch.int64 or \
                t.device != dev or not t.is_contiguous():
            raise ValueError(f"append_stage: the maps' box_of_tuple must be "
                             f"a contiguous int64 {tuple(geom.grid)} on "
                             f"{dev}")
    return M, counts


def _check_sort(r, p, gid, out) -> None:
    n = len(r)
    if not n or not len(p) == len(gid) == n:
        raise ValueError("sort_shards: one r, p and gid a shard")
    for s in range(n):
        _check_cells("sort_shards", None, r[s], p[s], gid[s])
        if r[s].shape != r[0].shape or r[s].dtype != r[0].dtype or \
                r[s].device != r[0].device:
            raise ValueError("sort_shards: the shards' fields differ in "
                             "shape, dtype or device")
    if out is not None:
        if len(out) != 3 or any(len(o) != n for o in out):
            raise ValueError("sort_shards: out holds (r, p, gid) lists of "
                             "every shard")
        for s in range(n):
            for t, like in zip((o[s] for o in out), (r[s], p[s], gid[s])):
                if t.shape != like.shape or t.dtype != like.dtype or \
                        t.device != like.device or not t.is_contiguous():
                    raise ValueError("sort_shards: an out tensor differs "
                                     "from its field in shape, dtype, "
                                     "device or contiguity")


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = build().comd_arrivals_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} "
                           f"(cudaError {err})")


def place_blocks(device: torch.device, elem: int, A: int) -> int:
    """The place launch's grid on ``device``: its SMs times the blocks an
    SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once
    a device, dtype and A and kept, so a graph replays the grid it
    captured."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (dev, elem, A)
    if key not in _GRID:
        n = ctypes.c_int(0)
        _raise_on(build().comd_arrivals_place_blocks(
            elem, place_warps(A), stage_capacity(A), dev, ctypes.byref(n)),
            "arrivals_place grid")
        _GRID[key] = n.value
    return _GRID[key]


def list_length(device: torch.device) -> int:
    """The cells the last launch pair on ``device`` listed (the cells that
    got arrivals in its stage's last chunk of shards), read to the host:
    for checks, not on the step's path."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    w, at = _LAST[dev]
    return int(w.stage[at:at + 4].view(torch.int32)[0])


def _launch_stage(geom, maps, r, p, gid, n_atoms, arrivals, overflow,
                  axis: int, shifts, M: int, counts: bool) -> None:
    """Bin and place, one launch each, for every shard of the lists (at
    most MAX_SHARDS)."""
    S, n_dirs = len(r), len(arrivals[0])
    B, A = r[0].shape[1], r[0].shape[2]
    C = stage_capacity(A)
    elem = r[0].element_size()
    rec = 8 * elem                           # 32 (f32) or 64 (f64) bytes
    # the records, the length the place launch read, then the list; the
    # list's length and the ticket after the counters
    at_n = S * B * C * rec
    at_list = at_n + 16
    w = rebucket_ops.workspace(r[0].device, at_list + 4 * S * B, S * B + 2,
                               _WORK)
    a = _Args()
    for s in range(S):
        for d, (ar, ap, ag, mask) in enumerate(arrivals[s]):
            a.src[s][d] = _Source(ar.data_ptr(), ap.data_ptr(),
                                  ag.data_ptr(), mask.data_ptr())
        a.r[s], a.p[s] = r[s].data_ptr(), p[s].data_ptr()
        a.gid[s], a.n_atoms[s] = gid[s].data_ptr(), n_atoms[s].data_ptr()
    a.overflow = overflow.data_ptr()
    a.stage, a.counts = w.stage.data_ptr(), w.counts.data_ptr()
    a.list, a.listed = a.stage + at_list, a.stage + at_n
    a.list_n = a.counts + 4 * S * B
    a.box_of_tuple = maps.box_of_tuple.data_ptr() if geom.use_hilbert \
        else None
    a.local_min[:] = [float(v) for v in geom.local_min]
    a.local_max[:] = [float(v) for v in geom.local_max]
    a.inv_box[:] = [float(v) for v in geom.inv_box_size]
    a.shift[:] = [float(v) for v in shifts]
    a.grid[:] = [int(v) for v in geom.grid]
    a.n_local, a.B, a.A, a.C, a.M = geom.n_local, B, A, C, M
    a.n_shards, a.n_dirs, a.axis = S, n_dirs, axis
    a.mask_counts, a.place_warps = int(counts), place_warps(A)
    a.place_blocks = place_blocks(r[0].device, elem, A)
    stream = torch.cuda.current_stream(r[0].device).cuda_stream
    _raise_on(build().comd_arrivals(elem, ctypes.byref(a), stream),
              "arrivals")
    _LAST[w.counts.device.index] = (w, at_n)
    if S * n_dirs * M > 0:
        LAUNCHES["arrivals_bin"] += 1
    LAUNCHES["arrivals_place"] += 1


def append_stage(geom, maps, r, p, gid, n_atoms, arrivals, overflow,
                 axis: int = -1, shifts=(0.0, 0.0)) -> None:
    """Append one exchange stage's arrivals to every shard, in place.

    ``r``, ``p``, ``gid``, ``n_atoms``: a list of the shards' fields
    ([3, B, A], [B, A], [B]); ``arrivals[s]``: shard s's sources, one or
    two directions, each (r [3, ...], p [3, ...], gid, mask) with M
    entries (r and p [3, M] or [3, n, A]), the mask M bools or the
    sender's n = M / A cell counts (slot i valid while i % A < counts[i //
    A]); ``overflow`` (0-dim bool) is set where a slot reached A, never
    cleared.  With ``axis`` >= 0 direction d's positions are shifted by
    ``shifts[d]`` along it (rounded to r's dtype; the sender's frame ->
    the receiver's).  Equals ``append_arrivals`` of each shard, direction
    0 then 1.  CPU tensors run the plain version; CUDA tensors two
    launches (two a ``MAX_SHARDS`` shards)."""
    M, counts = _check_stage(geom, maps, r, p, gid, n_atoms, arrivals,
                             overflow, axis)
    if r[0].device.type == "cpu":
        append_stage_plain(geom, maps, r, p, gid, n_atoms, arrivals,
                           overflow, axis, shifts)
        return
    for lo in range(0, len(r), MAX_SHARDS):
        part = slice(lo, lo + MAX_SHARDS)
        _launch_stage(geom, maps, r[part], p[part], gid[part],
                      n_atoms[part], arrivals[part], overflow, axis, shifts,
                      M, counts)


def append_arrivals(geom, maps, r, p, gid, n_atoms, arr_r, arr_p, arr_gid,
                    arr_valid):
    """Merge one shard's flat arrivals (``arr_r``, ``arr_p`` [3, M],
    ``arr_gid`` [M] int32, ``arr_valid`` [M] bool) into its cells by
    coordinate binning (comd_tpu/ops/binning.py::append_arrivals).
    Returns new tensors (r, p, gid, n_atoms, overflow); ``n_atoms`` counts
    every arrival binned into a cell, stored or not.  CPU tensors run the
    plain version; CUDA tensors the two kernels on copies of the
    fields."""
    ovf = torch.zeros((), dtype=torch.bool, device=r.device)
    arrival = (arr_r, arr_p, arr_gid, arr_valid)
    _check_stage(geom, maps, [r], [p], [gid], [n_atoms], [[arrival]], ovf,
                 -1)
    if r.device.type == "cpu":
        return append_arrivals_plain(geom, maps, r, p, gid, n_atoms, arr_r,
                                     arr_p, arr_gid, arr_valid)
    out = [r.clone(), p.clone(), gid.clone(), n_atoms.clone()]
    append_stage(geom, maps, *[[t] for t in out], [[arrival]], ovf)
    return tuple(out) + (ovf,)


def sort_shards(r, p, gid, out=None) -> None:
    """Sort every cell of every shard by gid (stable), in place on the
    lists' tensors or, with ``out`` ((r, p, gid) lists of tensors like
    them), into those.  CPU tensors run the plain version; CUDA tensors
    one launch (one a ``SORT_SHARDS`` shards) in ``sort_form(A)``."""
    _check_sort(r, p, gid, out)
    if r[0].device.type == "cpu":
        sort_shards_plain(r, p, gid, out)
        return
    dst = (r, p, gid) if out is None else out
    B, A = r[0].shape[1], r[0].shape[2]
    stream = torch.cuda.current_stream(r[0].device).cuda_stream
    for lo in range(0, len(r), SORT_SHARDS):
        part = range(lo, min(lo + SORT_SHARDS, len(r)))
        a = _SortArgs()
        for i, s in enumerate(part):
            for name, t in zip(("r", "p", "gid", "out_r", "out_p", "out_gid"),
                               (r[s], p[s], gid[s]) + tuple(o[s]
                                                            for o in dst)):
                getattr(a, name)[i] = t.data_ptr()
        a.n_shards, a.B, a.A = len(part), B, A
        a.form = int(sort_form(A) == "warp")
        _raise_on(build().comd_sort_cells(r[0].element_size(),
                                          ctypes.byref(a), stream),
                  "sort_cells")
        LAUNCHES["sort_cells"] += 1


def sort_cells(r, p, gid):
    """Canonical in-cell gid sort of one shard's [B, A] cells
    (comd_tpu/ops/binning.py::sort_cells).  Returns new tensors (r, p,
    gid).  CPU tensors run the plain version; CUDA tensors the kernel."""
    _check_sort([r], [p], [gid], None)
    if r.device.type == "cpu":
        return sort_cells_plain(r, p, gid)
    out = (torch.empty_like(r), torch.empty_like(p), torch.empty_like(gid))
    sort_shards([r], [p], [gid], [[t] for t in out])
    return out
