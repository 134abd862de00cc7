"""The kernel-initiated halo transports on hand-written CUDA kernels.

Two kernels, one source (csrc/comm.cu), one build:

- K3 ``ring_push`` replaces comd_tpu/parallel/pallas_comm.py::
  _ring_push_kernel (driven by _ring_push): every shard of a mesh pushes
  rows of its fields to the ring neighbor of one axis, the gather, the
  push and the receiver's scatter of the Pallas path in one launch.  Users:
  parallel/ki_comm.py's dfEmbed and atom exchanges.
- K4 ``pass2_push`` replaces pallas_comm.py::_pass2_push_kernel (driven by
  _pass2_push): F'(rhobar) of every shard's x-face plane, evaluated in the
  kernel and written straight into the x neighbor's dfEmbed halo rows.
  User: the x stage of ki_comm.exchange_scalar_ki_fused.

What bounds them on the card: bytes (a copy, and a copy with a short table
read per value).  All shards live on one device, so stream order replaces
the Pallas kernels' barrier and DMA semaphores (see csrc/comm.cu).

Beside each kernel sits its plain PyTorch version (``*_plain``: an index
gather plus a scatter per shard).  The wrappers take it only for tensors
on the CPU; a CUDA tensor launches the kernel or raises.  ``LAUNCHES``
(ops/cuda/__init__.py) counts the launches under "ring_push" and
"pass2_push".
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from ...potentials.tables import EmbedTable
from . import LAUNCHES
from .nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "comm.cu")
MAX_FIELDS = 4      # fields per K3 launch (csrc/comm.cu kMaxFields)
MAX_ENTRIES = 192   # (field, shard) pairs per K3 launch (kMaxEntries)
MAX_SHARDS = 128    # shards per K4 launch (kMaxShards)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """A field as [planes, rows, row]: [B] -> [1, B, 1], [B, A] -> [1, B, A];
    [P, B, A] stays."""
    if t.dim() == 1:
        return t.reshape(1, -1, 1)
    if t.dim() == 2:
        return t.unsqueeze(0)
    return t


def ring_push_plain(fields, to, send, recv=None) -> None:
    """For every (srcs, dsts) field and every shard s: copy rows ``send``
    of ``srcs[s]`` into rows ``recv`` (row k when None) of
    ``dsts[to[s]]``, in place.  Fields are [B], [B, A] or [P, B, A]
    tensors, rows along the box axis.  All sources are read before any
    destination is written."""
    got = [[_as_rows(src).index_select(1, send) for src in srcs]
           for srcs, _dsts in fields]
    for (_srcs, dsts), rows in zip(fields, got):
        for s, v in enumerate(rows):
            dst = _as_rows(dsts[to[s]])
            if recv is None:
                dst.copy_(v)
            else:
                dst[:, recv] = v


def pass2_push_plain(rhobar, dfe, to, send, recv, emb: EmbedTable) -> list:
    """For every shard s: F'(rhobar[s] at rows ``send``) written into rows
    ``recv`` of ``dfe[to[s]]``, in place.  Returns each shard's local copy
    [n_rows, A] of its plane."""
    local = [emb(rho[send])[1] for rho in rhobar]
    for s, v in enumerate(local):
        dfe[to[s]][recv] = v
    return local


# --------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# --------------------------------------------------------------------------

class _PushField(ctypes.Structure):
    _fields_ = [("n_planes", ctypes.c_int), ("row_words", ctypes.c_int),
                ("src_plane_words", ctypes.c_longlong),
                ("dst_plane_words", ctypes.c_longlong)]


class _PushArgs(ctypes.Structure):
    _fields_ = [("n_fields", ctypes.c_int), ("n_shards", ctypes.c_int),
                ("field", _PushField * MAX_FIELDS),
                ("src", ctypes.c_void_p * MAX_ENTRIES),
                ("dst", ctypes.c_void_p * MAX_ENTRIES)]


class _EmbedParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("x0", ctypes.c_double),
                ("inv_dx", ctypes.c_double), ("table", ctypes.c_void_p)]


class _Pass2Args(ctypes.Structure):
    _fields_ = [("n_shards", ctypes.c_int),
                ("rho", ctypes.c_void_p * MAX_SHARDS),
                ("dst", ctypes.c_void_p * MAX_SHARDS),
                ("local", ctypes.c_void_p * MAX_SHARDS)]


_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process


def build():
    """Compile csrc/comm.cu for sm_90a (first use) and bind it.  -fmad=false
    keeps K4's arithmetic rounded op by op, as PyTorch's eager pass 2."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "comm", ("-fmad=false",))
        lib.comd_ring_push.restype = ctypes.c_int
        lib.comd_ring_push.argtypes = [
            ctypes.POINTER(_PushArgs), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.comd_pass2_push.restype = ctypes.c_int
        lib.comd_pass2_push.argtypes = [
            ctypes.POINTER(_Pass2Args), ctypes.POINTER(_EmbedParams),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.comd_comm_error_string.restype = ctypes.c_char_p
        lib.comd_comm_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.comd_comm_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def _check_rows(rows: torch.Tensor, device, what: str) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 1 or \
            not rows.is_contiguous() or rows.device != device:
        raise ValueError(f"{what} must be a contiguous int32 vector on "
                         f"{device}")


def _rows_shape(shape) -> tuple:
    """(planes, rows, elements per row) of a [B], [B, A] or [P, B, A]
    field, as ``_as_rows`` views it."""
    if len(shape) == 1:
        return 1, shape[0], 1
    if len(shape) == 2:
        return 1, shape[0], shape[1]
    return tuple(shape)


def _check_field(ts, dev) -> None:
    """One field's per-shard tensors: one shape and dtype, contiguous, on
    ``dev``, of 4- or 8-byte elements."""
    t0 = ts[0]
    if t0.element_size() not in (4, 8) or t0.dim() > 3:
        raise ValueError("K3 moves fields of 4- or 8-byte elements, [B], "
                         f"[B, A] or [P, B, A], got {t0.dtype} "
                         f"{tuple(t0.shape)}")
    for t in ts:
        if t.shape != t0.shape or t.dtype != t0.dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError("the shards' fields must share one shape and "
                             "dtype and be contiguous on one device")


def _ring_push_kernel(fields, to, send, recv) -> None:
    dev = send.device
    _check_rows(send, dev, "send rows")
    if recv is not None:
        _check_rows(recv, dev, "recv rows")
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"K3 takes 1 to {MAX_FIELDS} fields per launch")
    n_shards = len(fields[0][0])
    descr, ptrs = [], []
    for srcs, dsts in fields:
        if len(srcs) != n_shards or len(dsts) != n_shards:
            raise ValueError("every field needs one source and one "
                             "destination per shard")
        _check_field(srcs, dev)
        _check_field(dsts, dev)
        sp, sr, sw = _rows_shape(srcs[0].shape)
        dp, dr, dw = _rows_shape(dsts[0].shape)
        if srcs[0].dtype != dsts[0].dtype or sp != dp or sw != dw or (
                recv is None and dr != send.numel()):
            raise ValueError("source and destination fields do not match")
        words = srcs[0].element_size() // 4
        sw *= words
        descr.append((sp, sw, sr * sw, dr * sw))
        ptrs.append(([t.data_ptr() for t in srcs],
                     [dsts[to[s]].data_ptr() for s in range(n_shards)]))
    vec = 4
    for sp, sw, ss, ds in descr:
        while vec > 1 and (sw % vec or ss % vec or ds % vec):
            vec //= 2
    for srcp, dstp in ptrs:
        while vec > 1 and any(p % (4 * vec) for p in srcp + dstp):
            vec //= 2
    lib = build()
    # a mesh with more (field, shard) pairs than one launch takes is pushed
    # in groups of shards, one launch each
    per = MAX_ENTRIES // len(fields)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s0 in range(0, n_shards, per):
            s1 = min(s0 + per, n_shards)
            a = _PushArgs()
            a.n_fields, a.n_shards = len(fields), s1 - s0
            for f, ((sp, sw, ss, ds), (srcp, dstp)) in enumerate(
                    zip(descr, ptrs)):
                a.field[f] = _PushField(sp, sw, ss, ds)
                for j, s in enumerate(range(s0, s1)):
                    a.src[f * a.n_shards + j] = srcp[s]
                    a.dst[f * a.n_shards + j] = dstp[s]
            err = lib.comd_ring_push(
                ctypes.byref(a), send.data_ptr(),
                None if recv is None else recv.data_ptr(), send.numel(),
                vec, stream)
            _raise_on(lib, err, "K3 ring_push")
            LAUNCHES["ring_push"] += 1


def ring_push(fields, to, send, recv=None) -> None:
    """K3: for every field (srcs, dsts) -- per-shard lists of [B], [B, A]
    or [P, B, A] tensors -- and every shard s, rows ``send`` of
    ``srcs[s]`` go into rows ``recv`` of ``dsts[to[s]]`` (row k of it when
    ``recv`` is None), in place.  ``to`` is one ring direction of the mesh
    (a permutation).  ``send``/``recv`` are int32 row lists on the fields'
    device.  CPU tensors run the plain version; CUDA tensors the kernel."""
    if send.device.type == "cpu":
        return ring_push_plain(fields, to, send, recv)
    return _ring_push_kernel(fields, to, send, recv)


def pass2_push(rhobar, dfe, to, send, recv, emb: EmbedTable) -> list:
    """K4: for every shard s, F'(rhobar[s] at rows ``send``) -- the
    derivative output of tables.interpolate, op by op -- written into rows
    ``recv`` of ``dfe[to[s]]``, in place.  Returns each shard's local copy
    [n_rows, A].  ``rhobar``: per-shard [n_local, A]; ``dfe``: per-shard
    [B, A]; ``send``/``recv``: int32 row lists.  CPU tensors run the plain
    version; CUDA tensors the kernel."""
    if send.device.type == "cpu":
        return pass2_push_plain(rhobar, dfe, to, send, recv, emb)
    dev = send.device
    _check_rows(send, dev, "send rows")
    _check_rows(recv, dev, "recv rows")
    n = len(rhobar)
    if not 1 <= n <= MAX_SHARDS or len(dfe) != n:
        raise ValueError(f"K4 takes 1 to {MAX_SHARDS} shards, one rhobar and "
                         f"one dfEmbed each")
    dtype, A = emb.table.dtype, dfe[0].shape[-1]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    for t in list(rhobar) + list(dfe) + [emb.table]:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("K4's operands must be contiguous, of the "
                             "table's dtype, on one device")
    if any(t.dim() != 2 or t.shape[1] != A for t in list(rhobar) + list(dfe)):
        raise ValueError("rhobar and dfEmbed must be [rows, A]")
    local = list(rhobar[0].new_empty((n, send.numel(), A)).unbind(0))
    lib = build()
    a = _Pass2Args()
    a.n_shards = n
    for s in range(n):
        a.rho[s] = rhobar[s].data_ptr()
        a.dst[s] = dfe[to[s]].data_ptr()
        a.local[s] = local[s].data_ptr()
    e = _EmbedParams(emb.n, emb.x0, emb.inv_dx, emb.table.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.comd_pass2_push(
            ctypes.byref(a), ctypes.byref(e),
            0 if dtype == torch.float32 else 1, send.data_ptr(),
            recv.data_ptr(), send.numel(), A, stream)
    _raise_on(lib, err, "K4 pass2_push")
    LAUNCHES["pass2_push"] += 1
    return local
