"""The kernel-initiated halo transports on hand-written CUDA kernels.

Three kernels, one source (csrc/comm.cu), one build:

- ``halo_fill`` replaces comd_tpu/parallel/pallas_comm.py::_ring_push_kernel
  (K3) as exchange_scalar_ki drives it, and _pass2_push_kernel (K4) as
  exchange_scalar_ki_fused drives it: in one process the whole staged
  dfEmbed fill of every shard's [B, A] field in one cooperative launch,
  stages x, y and z in order inside the kernel; across processes one
  ordinary launch a stage.  The x stage evaluates F'(rhobar) when
  ``rhobar`` is given (K4).  ``pass2_push`` is K4 alone: one direction of
  the x stage, with each shard's local copy of its plane.
- ``ring_push`` (K3) replaces _ring_push_kernel as exchange_atoms_ki drives
  it: one stage of the atom exchange, both directions and every field of
  every shard in one launch, each field at its own vector width.
- ``position_fill`` replaces no Pallas kernel: the mesh's ghost-position
  refresh (comd_tpu's exchange_positions, three ppermutes in its XLA
  step) as one launch over a row map, in one process the three stages
  composed (parallel/exchange.py::position_map), across processes one
  stage (ki_comm.py).
- ``atom_pack`` replaces no Pallas kernel: the collective transport's atom
  messages of one stage (comd_tpu's XLA packing, parallel/exchange.py:
  186-210; the port's exchange._atom_message is the plain reference), every
  shard and both faces in one launch, count-packed or full planes, into
  buffers the plan keeps.
- ``fold_halo`` replaces no Pallas kernel: the half-shell fold (comd_tpu's
  ops/sweep.py:615 fold_halo_serial and parallel/exchange.py:270
  fold_halo, XLA scatter-adds), halo rows added into their owner rows in
  place over a fold plan, one launch serially and one a stage on a mesh.

Each launch follows a plan made once (``FillPlan``, ``PushPlan``,
``PositionPlan``, ``AtomPackPlan``, ``FoldPlan``; parallel/ki_comm.py and
parallel/exchange.py cache them on the ``Halo``, ops/sweep.py the serial
fold's on the geometry's image map): the
row lists and the destination maps on the device, the fields' shapes,
each field's vector width and the launch grid, checked against the
kernels' limits when the plan is made, and a ctypes argument struct that
every call reuses.  A
destination is a shard of the launch (a value below S in the map) or a
receive plane of the plan (S + its index): the plane of a receiver in
another process, in that process's arena.  A call checks that the tensors
it is given have the plan's shape, writes their base pointers into the
struct and makes one ctypes call on the current stream.

Across processes (parallel/ki_comm.py) the receive planes live in one
arena a process (``Arena``: cudaMalloc, shared by CUDA IPC handles), and
the stages are ordered by 32-bit counters that the stream itself writes
and waits on (``stream_write``, ``stream_wait``; see csrc/comm.cu).

What bounds the kernels on the card: bytes (copies, and a copy with a short
table read per value); at the mesh's sizes, latency and the launch.

Beside each kernel sits its plain PyTorch version (``*_plain``: an index
gather plus a scatter a shard and direction; the pack's a compaction by
cumulative sums over the stacked shards; the fold's adds image rank by
image rank, each rank's destinations distinct, so it gives the same bits
on any device).  The wrappers take it only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
``LAUNCHES`` (ops/cuda/__init__.py) counts the launches under "halo_fill"
(a whole fill in one launch, or K4 alone), "halo_fill_stage" (one stage of
a fill across processes), "ring_push", "position_fill" (a whole refresh),
"position_fill_stage" (one stage of a refresh across processes),
"atom_pack" (one stage's messages) and "fold_halo" (the serial fold, or
one stage of the mesh's).
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import binning
from ...potentials.tables import EmbedTable
from . import LAUNCHES
from .nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "comm.cu")
MAX_SHARDS = 64     # shards a launch (csrc/comm.cu kMaxShards)
MAX_STAGES = 3      # stages a fill (kMaxStages)
MAX_FIELDS = 4      # fields a ring_push launch (kMaxFields)
MAX_PLANES = 2 * MAX_SHARDS   # receive planes a launch (kMaxPlanes)
WARPS = 8           # warps a block (kThreads / 32)
PACK_CELLS = 64     # cells a block of atom_pack (kPackCells)
SHARD_BITS = 6      # bits of a shard in a fold record's word (kShardBits)
FOLD_RECORD_VECS = 3   # 16-byte words a fold record at most (kFoldRecordVecs)


# --------------------------------------------------------------------------
# the plans
# --------------------------------------------------------------------------

def _vec_bytes(row_bytes: int) -> int:
    """The widest move (16, 8 or 4 bytes) that tiles a row."""
    for v in (16, 8, 4):
        if row_bytes % v == 0:
            return v
    raise ValueError(f"rows of {row_bytes} bytes are not whole 32-bit words")


def _lanes_lg(per_row: int) -> int:
    """log2 of the lanes that share a row: the power of two at or above the
    row's moves, at most a warp."""
    return min(5, (per_row - 1).bit_length())


def _blocks(n_rows: int, lg: int) -> int:
    """Blocks of WARPS warps that cover n_rows rows, 32 >> lg a warp."""
    per_block = WARPS * (32 >> lg)
    return -(-n_rows // per_block)


def _rows_list(rows: torch.Tensor, device: torch.device, B: int) -> int:
    """Checks a row list once; returns its length."""
    if rows.dtype != torch.int32 or rows.dim() != 1 or \
            not rows.is_contiguous() or rows.device != device or \
            rows.numel() < 1:
        raise ValueError(f"a row list must be a non-empty contiguous int32 "
                         f"vector on {device}")
    if int(rows.min()) < 0 or int(rows.max()) >= B:
        raise ValueError(f"row list outside the field's {B} rows")
    return rows.numel()


def _targets(to, n_shards: int, n_planes: int, device: torch.device):
    """A direction's destination map as Python ints (the plain versions)
    and an int32 device vector (the kernels): shard s's rows go to shard
    ``to[s]`` of the launch (below ``n_shards``) or to receive plane
    ``to[s] - n_shards``.  The destinations must be distinct, so every
    destination row is written by one shard; in one process (no planes)
    the map is a ring, a permutation of the shards."""
    to = [int(v) for v in to]
    if len(set(to)) != len(to) or \
            any(not 0 <= v < n_shards + n_planes for v in to) or \
            (n_planes == 0 and sorted(to) != list(range(n_shards))):
        raise ValueError(f"a direction's destinations must be distinct "
                         f"shards of the {n_shards} or planes of the "
                         f"{n_planes} (with no planes a ring: a permutation "
                         f"of the shards), got {to}")
    return to, torch.as_tensor(to, dtype=torch.int32, device=device)


def _planes_used(maps, n_shards: int, n_planes: int) -> None:
    """Every receive plane is the destination of exactly one (direction,
    shard)."""
    used = sorted(t - n_shards for to in maps for t in to if t >= n_shards)
    if used != list(range(n_planes)):
        raise ValueError(f"the {n_planes} receive planes must each be the "
                         f"destination of one (direction, shard), got "
                         f"{used}")


def _plane_ptrs(planes, shape, dtype, vec: int, what: str) -> list:
    """The base pointers of receive planes (CUDA tensors of ``shape`` and
    ``dtype``, contiguous, ``vec``-byte aligned)."""
    ptrs = []
    for t in planes:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or \
                not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"{what}: a receive plane must be a contiguous "
                             f"CUDA {dtype} {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
    _aligned(ptrs, vec, what)
    return ptrs


def _shards(n: int) -> None:
    if not 1 <= n <= MAX_SHARDS:
        raise ValueError(f"the comm kernels take 1 to {MAX_SHARDS} shards a "
                         f"launch, got {n}")


def _device(device) -> torch.device:
    """``device`` with its index ("cuda" is the current card), as the
    tensors on it report it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class FillPlan:
    """The launch plan of one dfEmbed fill (or of K4 alone, or of one stage
    of a fill across processes).

    ``stages``: the fill's stages in order, each a list of one or two
    directions ``(send, recv, to)``: shard s sends rows ``send`` of its
    field into rows ``recv`` of shard ``to[s]``'s field, or, where ``to[s]
    >= S``, into row k (for its k-th sent row) of ``planes[to[s] - S]``.
    ``shape`` and ``dtype``: every shard's [B, A] field.  ``planes``: the
    receive planes, [n_rows, A] of the field's dtype (one stage only).
    ``count_as``: the LAUNCHES key of its launches."""

    def __init__(self, stages, shape, dtype, device, planes=(),
                 count_as: str = "halo_fill"):
        device = _device(device)
        if not 1 <= len(stages) <= MAX_STAGES:
            raise ValueError(f"a fill has 1 to {MAX_STAGES} stages")
        n_dirs = len(stages[0])
        if not 1 <= n_dirs <= 2 or any(len(st) != n_dirs for st in stages):
            raise ValueError("every stage needs the same 1 or 2 directions")
        shape = tuple(shape)
        if len(shape) != 2 or dtype.itemsize not in (4, 8):
            raise ValueError(f"the fill moves [B, A] fields of 4- or 8-byte "
                             f"elements, got {dtype} {shape}")
        B, A = shape
        self.n_shards = len(stages[0][0][2])
        _shards(self.n_shards)
        self.planes = list(planes)
        if self.planes and len(stages) != 1:
            raise ValueError("receive planes take a one-stage plan")
        if len(self.planes) > MAX_PLANES:
            raise ValueError(f"a launch takes at most {MAX_PLANES} planes")
        self.shape, self.dtype, self.device = shape, dtype, device
        self.count_as = count_as
        self.stages = []        # [stage][d] -> (send, recv, to as ints)
        self.n_rows = []        # [stage]
        keep = []               # device maps the struct points at
        for st in stages:
            dirs = []
            for send, recv, to in st:
                n = _rows_list(send, device, B)
                if _rows_list(recv, device, B) != n:
                    raise ValueError("send and recv lists differ in length")
                to, to_dev = _targets(to, self.n_shards, len(self.planes),
                                      device)
                dirs.append((send, recv, to))
                keep.append(to_dev)
            if len({d[0].numel() for d in dirs}) != 1:
                raise ValueError("a stage's directions move different rows")
            _planes_used([d[2] for d in dirs], self.n_shards,
                         len(self.planes))
            self.stages.append(dirs)
            self.n_rows.append(dirs[0][0].numel())
        # rows of rhobar the fused stage reads: it must hold them
        self.rho_rows = max(int(d[0].max()) for d in self.stages[0]) + 1
        self.vec = _vec_bytes(A * dtype.itemsize)
        self.row_vecs = A * dtype.itemsize // self.vec
        self.vec_lg, self.elem_lg = _lanes_lg(self.row_vecs), _lanes_lg(A)
        # blocks along rows (the widest stage) and along (direction, shard)
        self.grid = (max(_blocks(n, lg) for n in self.n_rows
                         for lg in (self.vec_lg, self.elem_lg)),
                     n_dirs * self.n_shards)
        for t in self.planes:
            if tuple(t.shape) != (self.n_rows[0], A) or t.dtype != dtype:
                raise ValueError(f"a receive plane must be {dtype} "
                                 f"{(self.n_rows[0], A)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        self.args = None
        if device.type == "cuda":
            self._keep = keep
            self.device_index = device.index
            a = self.args = _FillArgs()
            a.n_shards, a.n_dirs, a.n_stages = self.n_shards, n_dirs, len(
                stages)
            a.elem_bytes, a.vec_bytes = dtype.itemsize, self.vec
            a.row_elems, a.row_vecs = A, self.row_vecs
            a.vec_lg, a.elem_lg = self.vec_lg, self.elem_lg
            a.grid_x, a.grid_y = self.grid
            a.device = self.device_index
            a.n_planes = len(self.planes)
            a.plane[:len(self.planes)] = _plane_ptrs(
                self.planes, (self.n_rows[0], A), dtype, self.vec,
                "halo_fill plane")
            k = 0
            for i, dirs in enumerate(self.stages):
                g = a.stage[i]
                g.n_rows = self.n_rows[i]
                for d, (send, recv, _t) in enumerate(dirs):
                    g.send[d], g.recv[d] = send.data_ptr(), recv.data_ptr()
                    g.to[d] = keep[k].data_ptr()
                    k += 1
            self.ref = ctypes.byref(a)


class PushedField(NamedTuple):
    """One field of a stage push, as its plan moves it."""
    shape: tuple        # a shard's field: [B], [B, A] or [P, B, A]
    dtype: torch.dtype
    vec_bytes: int      # the widest move that tiles a row: 16, 8 or 4
    planes: int         # P (1 for [B] and [B, A])
    row_vecs: int       # moves a row
    lg: int             # log2 of the lanes a row
    out_shape: tuple    # the arrivals: [n_dirs, S, ...] with n rows


class PushPlan:
    """The launch plan of one atom-exchange stage.

    ``dirs``: one or two directions ``(send, to)``: shard s sends rows
    ``send`` of each field into row k of shard ``to[s]``'s arrival buffer
    of that direction, or, where ``to[s] >= S``, of receive plane set
    ``sets[to[s] - S]``.  ``fields``: ``(shape, dtype)`` of each field of a
    shard, [B], [B, A] or [P, B, A] with rows along B.  ``sets``: flat
    uint8 tensors of ``set_bytes``, each holding every field of one
    (sender, direction) at ``set_off[f]`` (``set_views`` reads them)."""

    def __init__(self, dirs, fields, device, sets=()):
        device = _device(device)
        if not 1 <= len(dirs) <= 2:
            raise ValueError("a stage push has 1 or 2 directions")
        if not 1 <= len(fields) <= MAX_FIELDS:
            raise ValueError(f"a stage push moves 1 to {MAX_FIELDS} fields")
        self.n_shards = len(dirs[0][1])
        _shards(self.n_shards)
        self.sets = list(sets)
        if len(self.sets) > MAX_PLANES:
            raise ValueError(f"a launch takes at most {MAX_PLANES} plane "
                             f"sets")
        self.device = device
        shapes = [tuple(shape) for shape, _dt in fields]
        for shape, dtype in fields:
            if not 1 <= len(shape) <= 3 or dtype.itemsize not in (4, 8):
                raise ValueError(f"a pushed field is [B], [B, A] or [P, B, "
                                 f"A] of 4- or 8-byte elements, got {dtype} "
                                 f"{tuple(shape)}")
        B = _rows_shape(shapes[0])[1]
        if any(_rows_shape(sh)[1] != B for sh in shapes):
            raise ValueError("the fields differ in rows")
        self.dirs, keep = [], []
        for send, to in dirs:
            _rows_list(send, device, B)
            to, to_dev = _targets(to, self.n_shards, len(self.sets), device)
            self.dirs.append((send, to))
            keep.append(to_dev)
        if len({s.numel() for s, _r in self.dirs}) != 1:
            raise ValueError("the directions move different rows")
        _planes_used([t for _s, t in self.dirs], self.n_shards,
                     len(self.sets))
        n = self.n_rows = self.dirs[0][0].numel()
        self.fields = []
        for shape, (_s, dtype) in zip(shapes, fields):
            P, _B, E = _rows_shape(shape)
            vec = _vec_bytes(E * dtype.itemsize)
            rv = E * dtype.itemsize // vec
            rest = (n,) + shape[1:] if len(shape) < 3 else (P, n, E)
            self.fields.append(PushedField(
                shape, dtype, vec, P, rv, _lanes_lg(rv),
                (len(dirs), self.n_shards) + rest))
        self.set_off, self.set_bytes = set_layout(
            [(f.out_shape[2:], f.dtype) for f in self.fields])
        for t in self.sets:
            if t.dtype != torch.uint8 or t.dim() != 1 or \
                    t.numel() != self.set_bytes:
                raise ValueError(f"a receive plane set must be uint8 "
                                 f"[{self.set_bytes}], got {t.dtype} "
                                 f"{tuple(t.shape)}")
        self.grid_x = max(_blocks(n, f.lg) for f in self.fields)
        self.args = None
        if device.type == "cuda":
            self._keep = keep
            self.device_index = device.index
            a = self.args = _PushArgs()
            a.n_fields, a.n_shards = len(fields), self.n_shards
            a.n_dirs, a.n_rows = len(dirs), n
            a.grid_x = self.grid_x
            a.device = self.device_index
            for d, ((send, _r), to_dev) in enumerate(zip(self.dirs, keep)):
                a.send[d], a.to[d] = send.data_ptr(), to_dev.data_ptr()
            for i, f in enumerate(self.fields):
                a.field[i] = _PushField(f.planes, f.row_vecs, f.vec_bytes,
                                        f.lg, B * f.row_vecs)
                a.set_off[i] = self.set_off[i]
            a.n_sets = len(self.sets)
            a.set[:len(self.sets)] = _plane_ptrs(
                self.sets, (self.set_bytes,), torch.uint8, 16,
                "ring_push plane set")
            self.ref = ctypes.byref(a)

    def set_views(self, buf: torch.Tensor) -> list:
        """The fields of one plane set ``buf`` (uint8 [set_bytes]), each
        shaped as one (direction, shard) slab of its arrivals."""
        out = []
        for off, f in zip(self.set_off, self.fields):
            size = int(np.prod(f.out_shape[2:])) * f.dtype.itemsize
            out.append(buf[off:off + size].view(f.dtype)
                       .reshape(f.out_shape[2:]))
        return out


def set_layout(slabs) -> tuple:
    """(byte offset of each field, bytes) of one receive plane set: the
    fields' (shape, dtype) slabs of one (sender, direction) in order, each
    at a multiple of 16 bytes, so that every field keeps its 16-byte
    moves."""
    offs, at = [], 0
    for shape, dtype in slabs:
        offs.append(at)
        at += -(-int(np.prod(shape)) * dtype.itemsize // 16) * 16
    return offs, at


class RowMap(NamedTuple):
    """A position refresh as a row map, numpy, one entry a destination
    row: coordinate rows c = 0, 1, 2 of row ``dst_row`` of shard ``dst``'s
    positions (or of receive plane ``dst - S``) get those of row
    ``src_row`` of shard ``src``'s, plus ``signs[:, c]`` (-1, 0, +1) times
    the shift ext[c]."""
    dst: np.ndarray        # [N] int
    dst_row: np.ndarray    # [N] int
    src: np.ndarray        # [N] int
    src_row: np.ndarray    # [N] int
    signs: np.ndarray      # [N, 3] int


class PositionPlan:
    """The launch plan of a ghost-position refresh: the row map ``rows``
    (``RowMap``; in one process the whole refresh composed, across
    processes one stage) over ``n_shards`` shards' [3, B, A] positions of
    ``shape`` and ``dtype``, the per-axis shifts ``ext`` (rounded to the
    dtype) and the receive planes ``planes`` ([3, n, A] each).  Checked
    when made: every destination row written once, no row both read and
    written (so a launch needs no barrier), every plane row written.  On
    the device: the map as [N, 4] int32 (dst, dst_row, src | sign bits <<
    8, src_row), sorted by destination; for the plain version the gather
    index, the shifts a row and coordinate (-0.0 where none: x + -0.0 is x,
    also for x = -0.0) and the destination rows a target.  ``count_as``:
    the LAUNCHES key of its launches."""

    def __init__(self, rows: RowMap, shape, dtype, device, ext, n_shards,
                 planes=(), count_as: str = "position_fill"):
        device = _device(device)
        shape = tuple(shape)
        if len(shape) != 3 or shape[0] != 3 or \
                dtype not in (torch.float32, torch.float64):
            raise ValueError(f"a position refresh moves [3, B, A] float32 or "
                             f"float64 positions, got {dtype} {shape}")
        _shards(n_shards)
        self.planes = list(planes)
        if len(self.planes) > MAX_PLANES:
            raise ValueError(f"a launch takes at most {MAX_PLANES} planes")
        _, B, A = shape
        S, P = n_shards, len(self.planes)
        self.n_shards, self.shape, self.dtype = S, shape, dtype
        self.device, self.count_as = device, count_as
        dst, dst_row, src, src_row = (np.asarray(v, np.int64) for v in
                                      rows[:4])
        signs = np.asarray(rows.signs, np.int64).reshape(-1, 3)
        n = dst.size
        if n < 1 or not all(v.shape == (n,) for v in (dst_row, src,
                                                       src_row)) or \
                signs.shape[0] != n:
            raise ValueError("a row map needs one entry or more, all its "
                             "arrays of one length")
        n_plane = self.planes[0].shape[1] if P else 0
        for t in self.planes:
            if tuple(t.shape) != (3, n_plane, A) or t.dtype != dtype:
                raise ValueError(f"a receive plane must be {dtype} "
                                 f"{(3, n_plane, A)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        on_plane = dst >= S
        if dst.min() < 0 or dst.max() >= S + P or src.min() < 0 or \
                src.max() >= S or src_row.min() < 0 or src_row.max() >= B \
                or dst_row.min() < 0 or \
                (dst_row >= np.where(on_plane, n_plane, B)).any() or \
                not np.isin(signs, (-1, 0, 1)).all():
            raise ValueError("a row map entry lies outside the shards, "
                             "planes, rows or signs of the plan")
        order = np.lexsort((dst_row, dst))
        dst, dst_row, src, src_row, signs = (v[order] for v in (
            dst, dst_row, src, src_row, signs))
        key = dst * B + dst_row
        if (np.diff(key) == 0).any():
            raise ValueError("a destination row appears twice in the map")
        if np.isin(src * B + src_row, key[dst < S]).any():
            raise ValueError("a row the map reads is a row it writes")
        for p in range(P):
            got = dst_row[dst == S + p]
            if not np.array_equal(got, np.arange(n_plane)):
                raise ValueError(f"receive plane {p} is not written row by "
                                 f"row once")
        self.n_rows = n
        self.vec = _vec_bytes(A * dtype.itemsize)
        self.row_vecs = A * dtype.itemsize // self.vec
        self.lg = _lanes_lg(self.row_vecs)
        self.grid_x = _blocks(n, self.lg)
        self.ext = tuple(float(e) for e in ext)
        # the plain version: one gather, one add, one put a target
        self.src_index = torch.as_tensor(src, device=device)
        self.src_row_index = torch.as_tensor(src_row, device=device)
        shift = np.where(signs != 0, signs * np.asarray(self.ext), -0.0)
        self.shift = torch.as_tensor(shift, dtype=torch.float64).to(
            dtype).to(device)
        cuts = np.flatnonzero(np.diff(dst)) + 1
        self.targets = [(int(dst[lo]), lo, hi,
                         torch.as_tensor(dst_row[lo:hi], device=device))
                        for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, n])]
        code = src | (((signs == 1) << 2 * np.arange(3)).sum(1) |
                      ((signs == -1) << 2 * np.arange(3) + 1).sum(1)) << 8
        self.map = torch.as_tensor(
            np.stack([dst, dst_row, code, src_row], 1).astype(np.int32),
            device=device)
        self.args = None
        if device.type == "cuda":
            self.device_index = device.index
            _aligned([self.map.data_ptr()], 16, "position_fill map")
            a = self.args = _PositionArgs()
            a.n_shards, a.n_planes, a.n_rows = S, P, n
            a.elem_bytes, a.vec_bytes = dtype.itemsize, self.vec
            a.row_vecs, a.lg, a.grid_x = self.row_vecs, self.lg, self.grid_x
            a.device = self.device_index
            a.field_plane = B * self.row_vecs
            a.recv_plane = n_plane * self.row_vecs
            a.ext[:] = self.ext
            a.map = self.map.data_ptr()
            a.plane[:P] = _plane_ptrs(self.planes, (3, n_plane, A), dtype,
                                      self.vec, "position_fill plane")
            self.ref = ctypes.byref(a)


class AtomPackPlan:
    """The launch plan of one stage's atom messages of the collective
    transport, and the buffers they are written into.

    ``ids``: the two faces' send cells (int32 device vectors of one
    length, d = 0 the minus face); ``cap``: entries a count-packed message
    (0: full planes, n_cells * A entries); every shard's positions and
    momenta [3, B, A] of ``dtype``.  Buffers, made once: ``rp`` [2, S, 6,
    n_out] (r's three rows, then p's), ``gid`` [2, S, n_out] int32,
    ``valid`` [2, S, n_out] bool, message (d, s) at [d, s].  On the
    device a block takes PACK_CELLS cells, and each lane a vector of
    ``slots`` slots (16 bytes where A allows)."""

    def __init__(self, ids, cap: int, n_shards: int, shape, dtype, device):
        device = _device(device)
        shape = tuple(shape)
        if len(shape) != 3 or shape[0] != 3 or \
                dtype not in (torch.float32, torch.float64):
            raise ValueError(f"atom_pack takes [3, B, A] float32 or float64 "
                             f"positions, got {dtype} {shape}")
        _shards(n_shards)
        _, B, A = shape
        n = _rows_list(ids[0], device, B)
        if _rows_list(ids[1], device, B) != n:
            raise ValueError("the two faces send different numbers of cells")
        if cap < 0 or n * A >= 2 ** 31:
            raise ValueError(f"an atom message of {n} cells of {A} slots "
                             f"and cap {cap} does not fit 32-bit entries")
        self.ids, self.cap, self.n_shards = tuple(ids), int(cap), n_shards
        self.shape, self.dtype, self.device = shape, dtype, device
        self.n_cells = n
        self.n_out = self.cap or n * A
        self.grid_x = -(-n // PACK_CELLS)
        self.slots = _vec_bytes(A * dtype.itemsize) // dtype.itemsize
        self.row_vecs = A // self.slots
        self.lg = _lanes_lg(self.row_vecs)
        S = n_shards
        self.rp = torch.zeros((2, S, 6, self.n_out), dtype=dtype,
                              device=device)
        self.gid = torch.zeros((2, S, self.n_out), dtype=torch.int32,
                               device=device)
        self.valid = torch.zeros((2, S, self.n_out), dtype=torch.bool,
                                 device=device)
        # the messages' views, made once: a stage's call hands them out
        # without slicing 16 x 4 tensors on the host
        self._messages = [[(self.rp[d, s, :3], self.rp[d, s, 3:],
                            self.gid[d, s], self.valid[d, s])
                           for d in (0, 1)] for s in range(S)]
        self.args = None
        if device.type == "cuda":
            self.device_index = device.index
            a = self.args = _AtomPackArgs()
            a.n_shards, a.n_cells, a.row_elems, a.n_rows = S, n, A, B
            a.cap, a.n_out, a.elem_bytes = self.cap, self.n_out, dtype.itemsize
            a.slots, a.row_vecs = self.slots, self.row_vecs
            a.lg, a.grid_x, a.device = self.lg, self.grid_x, self.device_index
            a.ids[:] = [t.data_ptr() for t in self.ids]
            a.rp, a.gid_out = self.rp.data_ptr(), self.gid.data_ptr()
            a.valid = self.valid.data_ptr()
            self.ref = ctypes.byref(a)

    def messages(self) -> list:
        """Each shard's two messages (to its minus neighbor, to its plus
        neighbor), each (r [3, n_out], p [3, n_out], gid, valid), as views
        of the buffers (the same list every call: read it, do not change
        it)."""
        return self._messages


class FoldMap(NamedTuple):
    """A fold as a list of adds, numpy, in add order: row ``dst_row`` of
    shard ``dst`` gets row ``src_row`` of shard ``src`` added, on every
    plane of the field."""
    dst: np.ndarray        # [M] int
    dst_row: np.ndarray    # [M] int
    src: np.ndarray        # [M] int
    src_row: np.ndarray    # [M] int


class FoldPlan:
    """The launch plan of one fold launch: the adds of ``adds``
    (``FoldMap``) over ``n_shards`` shards' fields of ``shape`` ([B, A] or
    [P, B, A]) and ``dtype``, grouped by destination (a destination's adds
    keep their order).  Checked when made: no row the plan reads is a row
    it writes, so a launch needs no barrier.  On the device one record a
    destination, ``record`` [N, 4R] int32 (R = ``record_vecs`` 16-byte
    words, the fewest that hold every destination's sources inline, at
    most FOLD_RECORD_VECS): the destination (shard | row << SHARD_BITS),
    its sources' count n with the start of its spill (n | spill << 8),
    then its first K = 4R - 2 sources (shard | row << SHARD_BITS) in add
    order; ``spill`` holds every record's sources past K, in order.  For
    the plain version the adds rank by rank (the k-th add of every
    destination that has one), each rank as (destination shard, source
    shard, destination rows, source rows)."""

    def __init__(self, adds: FoldMap, shape, dtype, device, n_shards: int):
        device = _device(device)
        shape = tuple(shape)
        if len(shape) not in (2, 3) or \
                dtype not in (torch.float32, torch.float64):
            raise ValueError(f"a fold adds [B, A] or [P, B, A] float32 or "
                             f"float64 fields, got {dtype} {shape}")
        _shards(n_shards)
        P, B, A = _rows_shape(shape)
        S = self.n_shards = n_shards
        self.shape, self.dtype, self.device = shape, dtype, device
        dst, dst_row, src, src_row = (np.asarray(v, np.int64).reshape(-1)
                                      for v in adds)
        m = dst.size
        if m < 1 or not all(v.size == m for v in (dst_row, src, src_row)):
            raise ValueError("a fold needs one add or more, all its arrays "
                             "of one length")
        if min(dst.min(), src.min(), dst_row.min(), src_row.min()) < 0 or \
                max(dst.max(), src.max()) >= S or \
                max(dst_row.max(), src_row.max()) >= B:
            raise ValueError("a fold's add lies outside the shards or rows "
                             "of the plan")
        key = dst * B + dst_row
        if np.isin(src * B + src_row, key).any():
            raise ValueError("a row the fold reads is a row it writes")
        order = np.argsort(key, kind="stable")
        key, dst, dst_row, src, src_row = (v[order] for v in (
            key, dst, dst_row, src, src_row))
        first = np.r_[0, np.flatnonzero(np.diff(key)) + 1]
        end = np.r_[first[1:], m]
        self.n_entries, self.n_adds = first.size, m
        rank = np.arange(m) - np.repeat(first, end - first)
        self.ranks = []
        for k in range(int(rank.max()) + 1):
            at = np.flatnonzero(rank == k)
            groups = []
            for t, s_ in sorted({(int(a), int(b)) for a, b in
                                 zip(dst[at], src[at])}):
                sel = at[(dst[at] == t) & (src[at] == s_)]
                groups.append((t, s_, torch.as_tensor(dst_row[sel],
                                                      device=device),
                               torch.as_tensor(src_row[sel], device=device)))
            self.ranks.append(groups)
        n_src = end - first
        if B > 2 ** (31 - SHARD_BITS) or n_src.max() > 255:
            raise ValueError(f"a fold record holds rows below "
                             f"{2 ** (31 - SHARD_BITS)} and 255 sources a "
                             f"row, got {B} rows, {n_src.max()} sources")
        R = self.record_vecs = min(FOLD_RECORD_VECS,
                                   -(-(int(n_src.max()) + 2) // 4))
        K = 4 * R - 2
        word = src | src_row << SHARD_BITS
        spilled = np.maximum(n_src - K, 0)
        spill_at = np.cumsum(spilled) - spilled
        if spill_at[-1] + spilled[-1] >= 2 ** 23:
            raise ValueError("a fold's spill outgrows its records' 23 bits")
        record = np.zeros((first.size, 4 * R), np.int64)
        record[:, 0] = dst[first] | dst_row[first] << SHARD_BITS
        record[:, 1] = n_src | spill_at << 8
        inline = np.arange(K) < n_src[:, None]
        record[:, 2:][inline] = word[(first[:, None] + np.arange(K))[inline]]
        self.record = torch.as_tensor(record.astype(np.int32), device=device)
        # never empty: the kernel takes a pointer
        self.spill = torch.as_tensor(np.r_[word[rank >= K], 0].astype(
            np.int32), device=device)
        self.vec = _vec_bytes(A * dtype.itemsize)
        self.row_vecs = A * dtype.itemsize // self.vec
        self.lg = _lanes_lg(self.row_vecs)
        self.grid_x = _blocks(self.n_entries, self.lg)
        self.args = None
        if device.type == "cuda":
            self.device_index = device.index
            _aligned([self.record.data_ptr()], 16, "fold_halo records")
            a = self.args = _FoldArgs()
            a.n_shards, a.n_entries, a.n_planes = S, self.n_entries, P
            a.elem_bytes, a.vec_bytes = dtype.itemsize, self.vec
            a.row_vecs, a.lg, a.grid_x = self.row_vecs, self.lg, self.grid_x
            a.record_vecs, a.device = R, self.device_index
            a.plane_vecs = B * self.row_vecs
            a.record = self.record.data_ptr()
            a.spill = self.spill.data_ptr()
            self.ref = ctypes.byref(a)


def _rows_shape(shape) -> tuple:
    """(planes, rows, elements a row) of a [B], [B, A] or [P, B, A] field."""
    if len(shape) == 1:
        return 1, shape[0], 1
    if len(shape) == 2:
        return 1, shape[0], shape[1]
    return tuple(shape)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _put(x, t: int, recv, v, planes) -> None:
    """Rows ``v`` into rows ``recv`` of shard ``t``'s field, or into
    receive plane ``t - S``."""
    if t < len(x):
        x[t][recv] = v
    else:
        planes[t - len(x)].copy_(v)


def fill_push_plain(x, to, send, recv, planes=()) -> None:
    """One direction of one fill stage, in place: rows ``send`` of every
    shard's field ``x[s]`` into rows ``recv`` of ``x[to[s]]`` (or into
    ``planes[to[s] - S]``).  All shards are read before any is written."""
    got = [v[send] for v in x]
    for s, v in enumerate(got):
        _put(x, to[s], recv, v, planes)


def pass2_push_plain(rhobar, dfe, to, send, recv, emb: EmbedTable,
                     planes=()) -> list:
    """For every shard s: F'(rhobar[s] at rows ``send``) written into rows
    ``recv`` of ``dfe[to[s]]`` (or into ``planes[to[s] - S]``), in place.
    Returns each shard's local copy [n_rows, A] of its plane."""
    local = [emb(rho[send])[1] for rho in rhobar]
    for s, v in enumerate(local):
        _put(dfe, to[s], recv, v, planes)
    return local


def halo_fill_plain(plan: FillPlan, x: list, rhobar=None,
                    emb: EmbedTable = None) -> list:
    """The fill of ``plan`` on every shard's field ``x[s]``, in place,
    stage by stage; with ``rhobar`` the first stage pushes F'(rhobar)
    (``emb``: pass 2's evaluator).  Rows for receive planes go into the
    plan's planes."""
    for i, dirs in enumerate(plan.stages):
        for send, recv, to in dirs:
            if i == 0 and rhobar is not None:
                pass2_push_plain(rhobar, x, to, send, recv, emb, plan.planes)
            else:
                fill_push_plain(x, to, send, recv, plan.planes)
    return x


def position_fill_plain(plan: PositionPlan, r: list) -> list:
    """The refresh of ``plan`` on every shard's [3, B, A] positions
    ``r[s]``, in place: one gather of the map's source rows from the
    stacked shards, one add of each row's shifts, then each destination
    shard's rows (or receive plane) written.  Returns ``r``."""
    v = torch.stack(r)[plan.src_index, :, plan.src_row_index]   # [N, 3, A]
    v += plan.shift[:, :, None]
    S = plan.n_shards
    for t, lo, hi, rows in plan.targets:
        if t < S:
            r[t][:, rows] = v[lo:hi].transpose(0, 1)
        else:
            plan.planes[t - S].copy_(v[lo:hi].transpose(0, 1))
    return r


def atom_pack_plain(plan: AtomPackPlan, r, p, gid, n_atoms,
                    overflow) -> list:
    """One stage's atom messages of every shard into the plan's buffers:
    for each face d, the stacked shards' send cells, the real slots (slot
    < n_atoms) counted by a cumulative sum and, count-packed, scattered to
    their rank's entry below cap (the rest zero, EMPTY_GID, invalid;
    ``count > cap`` or-ed into ``overflow`` in place); full planes
    gathered whole with their slots' validity.  Returns ``messages()``."""
    A, cap, S = plan.shape[2], plan.cap, plan.n_shards
    slots = torch.arange(A, device=plan.device)
    for d, ids in enumerate(plan.ids):
        ids = ids.long()
        n = torch.stack([c[ids] for c in n_atoms])             # [S, n]
        ok = (slots < n[..., None]).reshape(S, -1)             # [S, M]
        rpm = torch.cat([torch.stack([x[:, ids] for x in r]),
                         torch.stack([x[:, ids] for x in p])],
                        1).reshape(S, 6, -1)
        gm = torch.stack([g[ids] for g in gid]).reshape(S, -1)
        if not cap:
            plan.rp[d].copy_(rpm)
            plan.gid[d].copy_(gm)
            plan.valid[d].copy_(ok)
            continue
        pos = torch.cumsum(ok, 1) - 1
        count = ok.sum(1)
        s_i, e_i = (ok & (pos < cap)).nonzero(as_tuple=True)
        k_i = pos[s_i, e_i]
        plan.rp[d].zero_()
        plan.rp[d][s_i, :, k_i] = rpm[s_i, :, e_i]
        plan.gid[d].fill_(int(binning.EMPTY_GID))
        plan.gid[d][s_i, k_i] = gm[s_i, e_i]
        plan.valid[d].copy_(torch.arange(cap, device=plan.device)
                            < count[:, None])
        overflow.logical_or_((count > cap).any())
    return plan.messages()


def fold_halo_plain(plan: FoldPlan, x: list) -> list:
    """The fold of ``plan`` on every shard's field ``x[s]``, in place,
    add rank by add rank: each rank's destination rows get their source
    rows added, one gather, add and put a (destination, source) pair, its
    destinations distinct, so every sum is rounded once in the plan's
    order, on any device.  Returns ``x``."""
    for groups in plan.ranks:
        for t, s, drows, srows in groups:
            dim = x[t].dim() - 2
            v = x[t].index_select(dim, drows) + x[s].index_select(dim, srows)
            x[t].index_copy_(dim, drows, v)
    return x


def ring_push_plain(plan: PushPlan, srcs) -> list:
    """One stage push of ``plan``: for every field f (``srcs[f]``, one
    tensor a shard), direction d and shard s, rows ``send[d]`` of
    ``srcs[f][s]`` into ``out[f][d, to_d[s]]``, or into field f of the
    plan's plane set ``to_d[s] - S``.  Returns ``out``, one [n_dirs, S,
    ...] arrival tensor a field."""
    out = [torch.empty(f.out_shape, dtype=f.dtype, device=srcs[0][0].device)
           for f in plan.fields]
    sets = [plan.set_views(b) for b in plan.sets]
    S = plan.n_shards
    for i, (o, ts) in enumerate(zip(out, srcs)):
        axis = 1 if ts[0].dim() == 3 else 0
        for d, (send, to) in enumerate(plan.dirs):
            for s, t in enumerate(ts):
                v = t.index_select(axis, send)
                if to[s] < S:
                    o[d, to[s]] = v
                else:
                    sets[to[s] - S][i].copy_(v)
    return out


# --------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# --------------------------------------------------------------------------

class _FillStage(ctypes.Structure):
    _fields_ = [("send", ctypes.c_void_p * 2), ("recv", ctypes.c_void_p * 2),
                ("to", ctypes.c_void_p * 2), ("n_rows", ctypes.c_int)]


class _FillArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_int) for k in (
        "n_shards", "n_dirs", "n_stages", "fused", "elem_bytes", "vec_bytes",
        "row_elems", "row_vecs", "vec_lg", "elem_lg", "grid_x", "grid_y",
        "device", "n_planes")] + [
        ("stage", _FillStage * MAX_STAGES),
        ("embed_n", ctypes.c_int), ("embed_x0", ctypes.c_double),
        ("embed_inv_dx", ctypes.c_double), ("embed_table", ctypes.c_void_p),
        ("x", ctypes.c_void_p * MAX_SHARDS),
        ("rho", ctypes.c_void_p * MAX_SHARDS),
        ("local", ctypes.c_void_p * MAX_SHARDS),
        ("plane", ctypes.c_void_p * MAX_PLANES)]


class _PushField(ctypes.Structure):
    _fields_ = [("n_planes", ctypes.c_int), ("row_vecs", ctypes.c_int),
                ("vec_bytes", ctypes.c_int), ("lg", ctypes.c_int),
                ("src_plane", ctypes.c_longlong)]


class _PushArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_int) for k in (
        "n_fields", "n_shards", "n_dirs", "n_rows", "grid_x", "device",
        "n_sets")] + [
        ("send", ctypes.c_void_p * 2), ("to", ctypes.c_void_p * 2),
        ("field", _PushField * MAX_FIELDS),
        ("src", (ctypes.c_void_p * MAX_SHARDS) * MAX_FIELDS),
        ("dst", ctypes.c_void_p * MAX_FIELDS),
        ("set", ctypes.c_void_p * MAX_PLANES),
        ("set_off", ctypes.c_longlong * MAX_FIELDS)]


class _PositionArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_int) for k in (
        "n_shards", "n_planes", "n_rows", "elem_bytes", "vec_bytes",
        "row_vecs", "lg", "grid_x", "device")] + [
        ("field_plane", ctypes.c_longlong), ("recv_plane", ctypes.c_longlong),
        ("ext", ctypes.c_double * 3), ("map", ctypes.c_void_p),
        ("x", ctypes.c_void_p * MAX_SHARDS),
        ("plane", ctypes.c_void_p * MAX_PLANES)]


class _AtomPackArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_int) for k in (
        "n_shards", "n_cells", "row_elems", "n_rows", "cap", "n_out",
        "elem_bytes", "slots", "row_vecs", "lg", "grid_x", "device")] + [
        ("ids", ctypes.c_void_p * 2),
        ("r", ctypes.c_void_p * MAX_SHARDS),
        ("p", ctypes.c_void_p * MAX_SHARDS),
        ("gid", ctypes.c_void_p * MAX_SHARDS),
        ("n_atoms", ctypes.c_void_p * MAX_SHARDS),
        ("rp", ctypes.c_void_p), ("gid_out", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("overflow", ctypes.c_void_p)]


class _FoldArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_int) for k in (
        "n_shards", "n_entries", "n_planes", "elem_bytes", "vec_bytes",
        "row_vecs", "lg", "record_vecs", "grid_x", "device")] + [
        ("plane_vecs", ctypes.c_longlong), ("record", ctypes.c_void_p),
        ("spill", ctypes.c_void_p), ("x", ctypes.c_void_p * MAX_SHARDS)]


_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process
_NOT_SUPPORTED = 801   # cudaErrorNotSupported


def build():
    """Compile csrc/comm.cu for sm_90a (first use) and bind it.  -fmad=false
    keeps the fused stage's arithmetic rounded op by op, as PyTorch's eager
    pass 2; -lcuda links the stream memory operations of cuda.h."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "comm",
                                           ("-fmad=false", "-lcuda"))
        P, I, V = ctypes.POINTER, ctypes.c_int, ctypes.c_void_p
        for name, args in (
                ("comd_halo_fill", [P(_FillArgs), V]),
                ("comd_ring_push", [P(_PushArgs), V]),
                ("comd_position_fill", [P(_PositionArgs), V]),
                ("comd_atom_pack", [P(_AtomPackArgs), V]),
                ("comd_fold_halo", [P(_FoldArgs), V]),
                ("comd_arena_alloc", [P(V), ctypes.c_longlong, I]),
                ("comd_arena_free", [V, I]),
                ("comd_ipc_handle", [V, I, ctypes.c_char_p]),
                ("comd_ipc_open", [ctypes.c_char_p, I, P(V)]),
                ("comd_ipc_close", [V, I]),
                ("comd_peer_access", [I, I]),
                ("comd_stream_wait", [V, V, ctypes.c_uint]),
                ("comd_stream_write", [V, V, ctypes.c_uint])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = I, args
        for name in ("comd_comm_error_string", "comd_cu_error_string"):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_char_p, [I]
        _lib = lib
        return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err == _NOT_SUPPORTED:
        raise RuntimeError(f"{what}: the device has no cooperative launch, "
                           f"which the fill's stage barriers need")
    if err != 0:
        msg = lib.comd_comm_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def _pointers(ts, n: int, shape, dtype, device: int, what: str) -> list:
    """The base pointers of one tensor a shard, each of the plan's shape
    and dtype, contiguous, on its CUDA device."""
    if len(ts) != n:
        raise ValueError(f"{what}: {n} shards in the plan, {len(ts)} given")
    ptrs = []
    for t in ts:
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous() or \
                t.get_device() != device:
            raise ValueError(f"{what}: expected contiguous {dtype} {shape} "
                             f"on cuda:{device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def _aligned(ptrs, vec: int, what: str) -> None:
    acc = 0
    for p in ptrs:
        acc |= p
    if acc % vec:
        raise ValueError(f"{what}: a pointer is not {vec}-byte aligned")


def _launch_fill(plan: FillPlan, x, rhobar, emb, local) -> None:
    a, S, A = plan.args, plan.n_shards, plan.shape[1]
    ptrs = _pointers(x, S, plan.shape, plan.dtype, plan.device_index,
                     "halo_fill field")
    _aligned(ptrs, plan.vec, "halo_fill field")
    a.x[:S] = ptrs
    a.fused = int(rhobar is not None)
    if rhobar is not None:
        tab = emb.table
        if plan.dtype not in (torch.float32, torch.float64) or \
                tab.dtype != plan.dtype or not tab.is_contiguous() or \
                tab.get_device() != plan.device_index:
            raise ValueError("the fused fill needs a float32 or float64 "
                             "field and a table of its dtype on its device")
        if len(rhobar) != S:
            raise ValueError(f"halo_fill rhobar: {S} shards in the plan, "
                             f"{len(rhobar)} given")
        rho_ptrs = []
        for t in rhobar:
            if t.dim() != 2 or t.shape[1] != A or \
                    t.shape[0] < plan.rho_rows or t.dtype != plan.dtype or \
                    not t.is_contiguous() or \
                    t.get_device() != plan.device_index:
                raise ValueError(f"halo_fill rhobar: expected contiguous "
                                 f"{plan.dtype} [>= {plan.rho_rows}, {A}] "
                                 f"on the field's device, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
            rho_ptrs.append(t.data_ptr())
        a.rho[:S] = rho_ptrs
        a.embed_n, a.embed_x0, a.embed_inv_dx = emb.n, emb.x0, emb.inv_dx
        a.embed_table = tab.data_ptr()
    if local is not None:
        a.local[:S] = [t.data_ptr() for t in local]
    lib = build()
    stream = torch.cuda.current_stream(plan.device_index).cuda_stream
    _raise_on(lib, lib.comd_halo_fill(plan.ref, stream), "halo_fill")
    LAUNCHES[plan.count_as] += 1


def halo_fill(plan: FillPlan, x: list, rhobar=None,
              emb: EmbedTable = None) -> list:
    """The dfEmbed fill of ``plan`` on every shard's [B, A] field ``x[s]``,
    in place, in one launch: stage by stage, rows ``send`` of each shard
    into rows ``recv`` of its ring neighbor's field.  With ``rhobar`` (per
    shard [n_local, A]) and ``emb`` (pass 2's evaluator) the first stage
    pushes F'(rhobar) of the send rows instead, op by op as pass 2 (K4).
    CPU tensors run the plain version; CUDA tensors the kernel."""
    if x[0].device.type == "cpu":
        return halo_fill_plain(plan, x, rhobar, emb)
    _launch_fill(plan, x, rhobar, emb, None)
    return x


def pass2_push(rhobar, dfe, to, send, recv, emb: EmbedTable) -> list:
    """K4 alone: for every shard s, F'(rhobar[s] at rows ``send``) -- the
    derivative output of tables.interpolate, op by op -- written into rows
    ``recv`` of ``dfe[to[s]]``, in place; a one-stage, one-direction fill.
    Returns each shard's local copy [n_rows, A].  ``rhobar``: per-shard
    [n_local, A]; ``dfe``: per-shard [B, A]; ``send``/``recv``: int32 row
    lists.  CPU tensors run the plain version; CUDA tensors the kernel."""
    if send.device.type == "cpu":
        return pass2_push_plain(rhobar, dfe, to, send, recv, emb)
    plan = FillPlan([[(send, recv, to)]], dfe[0].shape, dfe[0].dtype,
                    send.device)
    local = list(rhobar[0].new_empty((len(dfe), send.numel(),
                                      plan.shape[1])).unbind(0))
    _launch_fill(plan, dfe, rhobar, emb, local)
    return local


def ring_push(plan: PushPlan, srcs) -> list:
    """One atom-exchange stage push of ``plan`` in one launch: for every
    field f (``srcs[f]``: one tensor a shard), direction d and shard s, rows
    ``send[d]`` of ``srcs[f][s]`` go into ``out[f][d, to_d[s]]`` (or into
    the plan's plane set ``to_d[s] - S``), each field at its own vector
    width.  Returns ``out``, one [n_dirs, S, ...] arrival tensor a field
    (rows along the field's B axis replaced by the sent rows).  CPU tensors
    run the plain version; CUDA tensors the kernel."""
    if srcs[0][0].device.type == "cpu":
        return ring_push_plain(plan, srcs)
    a, S = plan.args, plan.n_shards
    if len(srcs) != len(plan.fields):
        raise ValueError(f"ring_push: {len(plan.fields)} fields in the "
                         f"plan, {len(srcs)} given")
    dev = srcs[0][0].device
    out = [torch.empty(f.out_shape, dtype=f.dtype, device=dev)
           for f in plan.fields]
    for i, (ts, f) in enumerate(zip(srcs, plan.fields)):
        what = f"ring_push field {i}"
        ptrs = _pointers(ts, S, f.shape, f.dtype, plan.device_index, what)
        _aligned(ptrs + [out[i].data_ptr()], f.vec_bytes, what)
        a.src[i][:S] = ptrs
        a.dst[i] = out[i].data_ptr()
    lib = build()
    stream = torch.cuda.current_stream(plan.device_index).cuda_stream
    _raise_on(lib, lib.comd_ring_push(plan.ref, stream), "ring_push")
    LAUNCHES["ring_push"] += 1
    return out


def position_fill(plan: PositionPlan, r: list) -> list:
    """The ghost-position refresh of ``plan`` on every shard's [3, B, A]
    positions ``r[s]``, in place, in one launch: every map entry's three
    coordinate rows copied from its source row, the shift added to
    coordinate c where the entry's sign c says (one rounded add, as the
    staged exchange adds it), into the destination shard's row or receive
    plane.  CPU tensors run the plain version; CUDA tensors the kernel."""
    if r[0].device.type == "cpu":
        return position_fill_plain(plan, r)
    a, S = plan.args, plan.n_shards
    ptrs = _pointers(r, S, plan.shape, plan.dtype, plan.device_index,
                     "position_fill positions")
    _aligned(ptrs, plan.vec, "position_fill positions")
    a.x[:S] = ptrs
    lib = build()
    stream = torch.cuda.current_stream(plan.device_index).cuda_stream
    _raise_on(lib, lib.comd_position_fill(plan.ref, stream), "position_fill")
    LAUNCHES[plan.count_as] += 1
    return r


def atom_pack(plan: AtomPackPlan, r, p, gid, n_atoms, overflow) -> list:
    """One stage's atom messages of every shard (both faces, count-packed
    or full planes, ``plan``) in one launch, into the plan's buffers;
    ``count > cap`` of a packed message is or-ed into ``overflow`` (a 0-dim
    bool) in place.  ``r``, ``p`` [3, B, A], ``gid`` [B, A] int32 and
    ``n_atoms`` [B] int32: one tensor a shard.  Returns each shard's two
    messages (``AtomPackPlan.messages``).  CPU tensors run the plain
    version; CUDA tensors the kernel."""
    if r[0].device.type == "cpu":
        return atom_pack_plain(plan, r, p, gid, n_atoms, overflow)
    a, S = plan.args, plan.n_shards
    B, A = plan.shape[1:]
    dev = plan.device_index
    a.r[:S] = _pointers(r, S, plan.shape, plan.dtype, dev, "atom_pack r")
    a.p[:S] = _pointers(p, S, plan.shape, plan.dtype, dev, "atom_pack p")
    a.gid[:S] = _pointers(gid, S, (B, A), torch.int32, dev, "atom_pack gid")
    _aligned(list(a.r[:S]) + list(a.p[:S]), plan.slots * plan.dtype.itemsize,
             "atom_pack r, p")
    _aligned(a.gid[:S], plan.slots * 4, "atom_pack gid")
    a.n_atoms[:S] = _pointers(n_atoms, S, (B,), torch.int32, dev,
                              "atom_pack n_atoms")
    if overflow.shape != () or overflow.dtype != torch.bool or \
            overflow.get_device() != dev:
        raise ValueError(f"atom_pack overflow: expected a 0-dim bool on "
                         f"cuda:{dev}, got {overflow.dtype} "
                         f"{tuple(overflow.shape)} on {overflow.device}")
    a.overflow = overflow.data_ptr()
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib, lib.comd_atom_pack(plan.ref, stream), "atom_pack")
    LAUNCHES["atom_pack"] += 1
    return plan.messages()


def fold_halo(plan: FoldPlan, x: list) -> list:
    """The fold of ``plan`` on every shard's field ``x[s]`` ([B, A] or [P,
    B, A] as the plan's), in place, in one launch: each destination row of
    every plane gets its source rows added in the plan's order, each add
    rounded alone.  Returns ``x``.  CPU tensors run the plain version;
    CUDA tensors the kernel."""
    if x[0].device.type == "cpu":
        return fold_halo_plain(plan, x)
    a, S = plan.args, plan.n_shards
    ptrs = _pointers(x, S, plan.shape, plan.dtype, plan.device_index,
                     "fold_halo field")
    _aligned(ptrs, plan.vec, "fold_halo field")
    a.x[:S] = ptrs
    lib = build()
    stream = torch.cuda.current_stream(plan.device_index).cuda_stream
    _raise_on(lib, lib.comd_fold_halo(plan.ref, stream), "fold_halo")
    LAUNCHES["fold_halo"] += 1
    return x


# --------------------------------------------------------------------------
# across processes: the receive-plane arena and the ready counters
# --------------------------------------------------------------------------

def _check(err: int, what: str) -> None:
    if err != 0:
        msg = build().comd_comm_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError {err})")


def _check_cu(err: int, what: str) -> None:
    if err != 0:
        msg = build().comd_cu_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (CUresult {err}); the "
                           f"cross-process ki transports need the stream "
                           f"memory operations (cuStreamWaitValue32, "
                           f"cuStreamWriteValue32)")


class _CudaArray:
    """A device buffer as ``__cuda_array_interface__`` (bytes), so that
    ``torch.as_tensor`` views it without owning it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


def device_bytes(ptr: int, nbytes: int) -> torch.Tensor:
    """A uint8 tensor over ``nbytes`` of device memory at ``ptr`` (this
    process's arena or a peer's opened one), on the card that holds it;
    the memory stays owned by whoever allocated or opened it."""
    return torch.as_tensor(_CudaArray(ptr, nbytes))


class Arena:
    """One process's receive-plane arena: ``nbytes`` of device memory from
    cudaMalloc, zeroed, with its 64-byte IPC handle (``handle``), and the
    peers' arenas opened from theirs (``open``).  ``close`` closes the
    peers and frees the arena; the caller makes sure first that no process
    still writes into either (parallel/dist.destroy's barrier)."""

    def __init__(self, nbytes: int, device):
        self.device = _device(device)
        self.index = self.device.index
        lib = build()
        ptr = ctypes.c_void_p()
        _check(lib.comd_arena_alloc(ctypes.byref(ptr), int(nbytes),
                                    self.index), "cudaMalloc of the arena")
        self.ptr, self.nbytes = ptr.value, int(nbytes)
        self.peers = {}          # process -> opened base pointer
        buf = ctypes.create_string_buffer(64)
        _check(lib.comd_ipc_handle(self.ptr, self.index, buf),
               "cudaIpcGetMemHandle of the arena")
        self.handle = buf.raw
        self.view = device_bytes(self.ptr, self.nbytes)

    def open(self, proc: int, handle: bytes, peer_device: int) -> int:
        """Open process ``proc``'s arena (never this process's own) and
        return its base pointer here.  With a card a process, peer access
        to ``peer_device`` first (raises where it is refused)."""
        lib = build()
        if peer_device != self.index:
            _check(lib.comd_peer_access(self.index, peer_device),
                   f"peer access from cuda:{self.index} to "
                   f"cuda:{peer_device}")
        ptr = ctypes.c_void_p()
        _check(lib.comd_ipc_open(bytes(handle), self.index,
                                 ctypes.byref(ptr)),
               f"cudaIpcOpenMemHandle of process {proc}'s arena")
        self.peers[proc] = ptr.value
        return ptr.value

    def close(self) -> None:
        lib = build()
        for proc, ptr in sorted(self.peers.items()):
            _check(lib.comd_ipc_close(ptr, self.index),
                   f"cudaIpcCloseMemHandle of process {proc}'s arena")
        self.peers = {}
        if self.ptr is not None:
            self.view = None
            _check(lib.comd_arena_free(self.ptr, self.index),
                   "cudaFree of the arena")
            self.ptr = None


def stream_wait(addr: int, value: int, device) -> None:
    """The current stream waits until the 32-bit counter at ``addr`` has
    reached ``value`` (cuStreamWaitValue32, greater or equal)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _check_cu(build().comd_stream_wait(stream, addr, value),
                  "cuStreamWaitValue32")


def stream_write(addr: int, value: int, device) -> None:
    """The current stream writes ``value`` to the 32-bit counter at
    ``addr`` after every earlier write of the stream (cuStreamWriteValue32
    with its memory barrier)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _check_cu(build().comd_stream_write(stream, addr, value),
                  "cuStreamWriteValue32")
