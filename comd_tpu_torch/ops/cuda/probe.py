"""The archive probes' kernels (P1-P6) on hand-written CUDA.

Three kernels, one source (csrc/probe.cu), one build:

- ``window_pair`` (P1-P3) replaces tools/archive/pallas_probe.py::kernel,
  pallas_probe2.py::kernel and pallas_probe3.py::kernel_A / kernel_BC: a
  branch-free pair sum over static lane offsets of a [3, A, L] position
  array, with P1's 1/r2, P2's and P3's Clenshaw chains, or P3's LJ.
- ``row_lookup`` (P4) replaces gather_probe.py::pallas_kernel (driven by
  pallas_take): a [rows, 4] table row per value.
- ``lane_lookup`` (P5, P6) replaces gather_probe2.py::k_gather (driven by
  pgather) and k_onehot (ponehot): a per-lane row of a [rows, lanes] table.

What bounds them on the card: pair arithmetic (window_pair), bytes (the
lookups).  The plain PyTorch versions and the choice between them and the
kernels are in comd_tpu_torch/probes/ (window.py, lookup.py), which call
these wrappers for CUDA tensors only.  ``LAUNCHES`` (ops/cuda/__init__.py)
counts the launches under "window_pair", "row_lookup" and "lane_lookup".
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import LAUNCHES
from .nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "probe.cu")
MAX_OFFSETS = 32          # lane offsets per window launch (kMaxOffsets)
MAX_COEF = 17             # coefficients per Clenshaw chain (kMaxCoef)
#: Clenshaw chain lengths (phi, dphi, rho) the kernel is instantiated for
CHEB_COUNTS = ((17, 16, 17), (17, 16, 16))
ROW_LOOKUP_MAX_ROWS = 4096   # [rows, 4] f32 staged whole: 64 KB
LANE_LOOKUP_MAX_ROWS = 1024  # [rows, 32] f32 column slice staged: 128 KB
LANE_SLICE = 32              # table columns a lane_lookup block stages
_PHYSICS_ID = {"inv_r2": 0, "cheb": 1, "lj": 2}


class _WindowParams(ctypes.Structure):
    _fields_ = [("n_slots", ctypes.c_int), ("row_len", ctypes.c_int),
                ("n_cols", ctypes.c_int), ("pad", ctypes.c_int),
                ("n_offsets", ctypes.c_int),
                ("offsets", ctypes.c_int * MAX_OFFSETS),
                ("rcut2", ctypes.c_float), ("clip_lo", ctypes.c_float),
                ("clip_hi", ctypes.c_float), ("t_scale", ctypes.c_float),
                ("t_shift", ctypes.c_float),
                ("phi", ctypes.c_float * MAX_COEF),
                ("dphi", ctypes.c_float * MAX_COEF),
                ("rho", ctypes.c_float * MAX_COEF)]


_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process


def build():
    """Compile csrc/probe.cu for sm_90a (first use) and bind it."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "probe")
        lib.comd_window_pair.restype = ctypes.c_int
        lib.comd_window_pair.argtypes = [
            ctypes.POINTER(_WindowParams), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.comd_row_lookup.restype = ctypes.c_int
        lib.comd_row_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.comd_lane_lookup.restype = ctypes.c_int
        lib.comd_lane_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.comd_probe_error_string.restype = ctypes.c_char_p
        lib.comd_probe_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.comd_probe_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def _check_f32(what: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev or \
                t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous float32 CUDA tensors "
                             f"on one device, got {t.dtype} {t.device}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def window_pair(rp: torch.Tensor, spec, n_cols: int) -> tuple:
    """P1-P3 on the card: the pair sums of ``spec`` (a probes.window
    WindowSpec) over ``n_cols`` output columns of ``rp`` [3, A, L].
    Returns (fx, u) for P1's physics, else (fx, u, rho), each [A, n_cols]."""
    _check_f32("window_pair", rp)
    if rp.dim() != 3 or rp.shape[0] != 3:
        raise ValueError(f"rp must be [3, A, L], got {tuple(rp.shape)}")
    A, L = rp.shape[1], rp.shape[2]
    offs = tuple(spec.offsets)
    if not 1 <= len(offs) <= MAX_OFFSETS:
        raise ValueError(f"window_pair takes 1 to {MAX_OFFSETS} offsets")
    if n_cols < 1 or spec.pad + min(min(offs), 0) < 0 or \
            spec.pad + max(max(offs), 0) + n_cols > L:
        raise ValueError(f"{n_cols} columns at pad {spec.pad} with offsets "
                         f"{min(offs)}..{max(offs)} do not fit rp's {L} lanes")
    counts = (len(spec.phi), len(spec.dphi), len(spec.rho))
    if spec.physics == "cheb" and counts not in CHEB_COUNTS:
        raise ValueError(f"Clenshaw chains of {counts} coefficients: the "
                         f"kernel is built for {CHEB_COUNTS}")
    p = _WindowParams()
    p.n_slots, p.row_len, p.n_cols, p.pad = A, L, n_cols, spec.pad
    p.n_offsets = len(offs)
    for k, d in enumerate(offs):
        p.offsets[k] = d
    p.rcut2 = spec.rcut2
    p.clip_lo, p.clip_hi = spec.clip
    p.t_scale, p.t_shift = spec.t_scale, spec.t_shift
    for name in ("phi", "dphi", "rho"):
        dst = getattr(p, name)
        for k, c in enumerate(getattr(spec, name)):
            dst[k] = c
    n_out = spec.n_out
    outs = rp.new_empty((n_out, A, n_cols))
    lib = build()
    with torch.cuda.device(rp.device):
        err = lib.comd_window_pair(
            ctypes.byref(p), _PHYSICS_ID[spec.physics], *counts,
            rp.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if n_out == 3 else None, _stream(rp.device))
    _raise_on(lib, err, "window_pair")
    LAUNCHES["window_pair"] += 1
    return tuple(outs.unbind(0))


def row_lookup(x: torch.Tensor, tab: torch.Tensor, scale: float
               ) -> torch.Tensor:
    """P4 on the card: x + scale * (r0 + u (r1 + u (r2 + r3))), r the row
    floor(x) (clamped) of ``tab`` [rows, 4], u = x - floor(x); f32, op by
    op.  ``x`` any shape; x and the table 16-byte aligned."""
    _check_f32("row_lookup", x, tab)
    if tab.dim() != 2 or tab.shape[1] != 4 or \
            not 1 <= tab.shape[0] <= ROW_LOOKUP_MAX_ROWS:
        raise ValueError(f"row_lookup's table must be [1.."
                         f"{ROW_LOOKUP_MAX_ROWS}, 4], got {tuple(tab.shape)}")
    if x.data_ptr() % 16 or tab.data_ptr() % 16:
        raise ValueError("row_lookup takes x and a table 16-byte aligned")
    out = torch.empty_like(x)
    lib = build()
    with torch.cuda.device(x.device):
        err = lib.comd_row_lookup(x.data_ptr(), tab.data_ptr(),
                                  out.data_ptr(), x.numel(), tab.shape[0],
                                  scale, _stream(x.device))
    _raise_on(lib, err, "row_lookup")
    LAUNCHES["row_lookup"] += 1
    return out


def lane_lookup(x: torch.Tensor, tab: torch.Tensor, scale: float
                ) -> torch.Tensor:
    """P5/P6 on the card: out[r, l] = x + scale * (tab[floor(x[r, l]), l]
    * u), floor clamped to the table's rows, u = x - floor(x); f32, op by
    op.  ``x`` [R, lanes], ``tab`` [rows, lanes], lanes a multiple of 32
    (the kernel stages 32-lane slices of the table)."""
    _check_f32("lane_lookup", x, tab)
    if x.dim() != 2 or tab.dim() != 2 or tab.shape[1] != x.shape[1] or \
            x.shape[1] % LANE_SLICE or \
            not 1 <= tab.shape[0] <= LANE_LOOKUP_MAX_ROWS:
        raise ValueError(f"lane_lookup takes x [R, lanes] and a table "
                         f"[1..{LANE_LOOKUP_MAX_ROWS}, lanes], lanes a "
                         f"multiple of {LANE_SLICE}, got {tuple(x.shape)} "
                         f"and {tuple(tab.shape)}")
    out = torch.empty_like(x)
    lib = build()
    with torch.cuda.device(x.device):
        err = lib.comd_lane_lookup(x.data_ptr(), tab.data_ptr(),
                                   out.data_ptr(), x.shape[0], x.shape[1],
                                   tab.shape[0], scale, _stream(x.device))
    _raise_on(lib, err, "lane_lookup")
    LAUNCHES["lane_lookup"] += 1
    return out
