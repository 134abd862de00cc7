"""The archive probes' kernels (P1-P6) on hand-written CUDA.

Three kernels, one source (csrc/probe.cu), one build:

- ``window_pair`` (P1-P3) replaces tools/archive/pallas_probe.py::kernel,
  pallas_probe2.py::kernel and pallas_probe3.py::kernel_A / kernel_BC: a
  pair sum over static lane offsets of a [3, A, L] position array, with
  P1's 1/r2, P2's and P3's Clenshaw chains, or P3's LJ.  One warp walks a
  column's candidate pairs (lane a is i-slot a), tests r2 on every pair,
  lists the pairs inside the cutoff and drains the warp's lists entry by
  entry through the pair function; the offsets of a column are split over
  several warps of one block when the columns alone do not fill the card
  (``window_plan``).
- ``row_lookup`` (P4) replaces gather_probe.py::pallas_kernel (driven by
  pallas_take): a [rows, 4] table row per value.
- ``lane_lookup`` (P5, P6) replaces gather_probe2.py::k_gather (driven by
  pgather) and k_onehot (ponehot): a per-lane row of a [rows, lanes] table.

What bounds them on the card: pair arithmetic (window_pair), bytes (the
lookups).  Launch plans are made once per device and shape and kept here:
the window's offset split, block shape and ctypes parameter block, and the
lookups' resident-block counts (the occupancy query also sets a kernel's
dynamic shared-memory limit), so a call checks its tensors, allocates its
output and makes one ctypes call.  The plain PyTorch versions and the
choice between them and the kernels are in comd_tpu_torch/probes/
(window.py, lookup.py), which call these wrappers for CUDA tensors only.
``LAUNCHES`` (ops/cuda/__init__.py) counts the launches under
"window_pair", "row_lookup" and "lane_lookup".
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import threading

import torch

from . import LAUNCHES
from .nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "probe.cu")
MAX_OFFSETS = 32          # lane offsets per window launch (kMaxOffsets)
MAX_COEF = 17             # coefficients per Clenshaw chain (kMaxCoef)
MAX_SLOTS = 32            # i-slots a window column: one lane each
WINDOW_WARPS = 8          # warps a window block at most (kMaxWarps)
#: Clenshaw chain lengths (phi, dphi, rho) the kernel is instantiated for
CHEB_COUNTS = ((17, 16, 17), (17, 16, 16))
ROW_LOOKUP_MAX_ROWS = 4096   # [rows, 4] f32 staged whole: 64 KB
LANE_LOOKUP_MAX_ROWS = 1024  # [rows, 32] f32 column slice staged: 128 KB
LANE_SLICE = 32              # table columns a lane_lookup block stages
ROW_THREADS = 256            # row_lookup block (kRowThreads)
LANE_THREADS = LANE_SLICE * 16   # lane_lookup block (32 lanes x kLaneRows)
_PHYSICS_ID = {"inv_r2": 0, "cheb": 1, "lj": 2}
_KERNEL_ID = {"window_pair": 0, "row_lookup": 1, "lane_lookup": 2}


class _WindowParams(ctypes.Structure):
    _fields_ = [("n_slots", ctypes.c_int), ("row_len", ctypes.c_int),
                ("n_cols", ctypes.c_int), ("pad", ctypes.c_int),
                ("n_offsets", ctypes.c_int), ("group", ctypes.c_int),
                ("n_groups", ctypes.c_int), ("cols_per_block", ctypes.c_int),
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
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.comd_probe_occupancy.restype = i
        lib.comd_probe_occupancy.argtypes = [
            i, i, i, i, i, i, ctypes.c_longlong, ctypes.POINTER(i),
            ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)]
        lib.comd_window_pair.restype = i
        lib.comd_window_pair.argtypes = [
            ctypes.POINTER(_WindowParams), i, i, i, i, vp, vp, vp, vp, vp]
        lib.comd_row_lookup.restype = i
        lib.comd_row_lookup.argtypes = [vp, vp, vp, ctypes.c_longlong, i, f,
                                        i, vp]
        lib.comd_lane_lookup.restype = i
        lib.comd_lane_lookup.argtypes = [vp, vp, vp, ctypes.c_longlong, i, i,
                                         f, i, vp]
        lib.comd_probe_error_string.restype = ctypes.c_char_p
        lib.comd_probe_error_string.argtypes = [i]
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


@dataclasses.dataclass(frozen=True)
class Occupancy:
    """What the card holds of one kernel launch shape."""
    blocks_per_sm: int
    n_sms: int
    smem_bytes: int      # dynamic shared memory a block

    @property
    def resident_blocks(self) -> int:
        return self.blocks_per_sm * self.n_sms


@functools.lru_cache(maxsize=None)
def occupancy(device_index: int, kernel: str, threads: int, smem: int = 0,
              physics: str = "inv_r2", counts: tuple = (0, 0, 0)
              ) -> Occupancy:
    """Blocks of ``threads`` an SM holds for ``kernel`` on the card, once per
    device and shape; sets the kernel's dynamic shared-memory limit first.
    A window block's shared bytes follow from its warps (``smem`` unused)."""
    lib = build()
    per_sm, sms, used = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        err = lib.comd_probe_occupancy(
            _KERNEL_ID[kernel], _PHYSICS_ID[physics], *counts, threads, smem,
            ctypes.byref(per_sm), ctypes.byref(sms), ctypes.byref(used))
    _raise_on(lib, err, f"{kernel} occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"{kernel}: no block of {threads} threads and "
                           f"{used.value} shared bytes fits an SM")
    return Occupancy(per_sm.value, sms.value, used.value)


# --------------------------------------------------------------------------
# window_pair
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """The launch of one window probe at one shape: the kernel's warps each
    walk one column over one group of consecutive offsets (``group`` of
    them, the last group shorter), ``n_groups`` warps a column, and a block
    holds ``cols_per_block`` columns' warps.  ``params`` is the kernel's
    parameter block, filled once."""
    physics: str
    counts: tuple             # Clenshaw chain lengths, (0, 0, 0) otherwise
    n_slots: int
    row_len: int
    n_cols: int
    pad: int
    offsets: tuple
    group: int
    n_groups: int
    cols_per_block: int
    params: _WindowParams = dataclasses.field(compare=False, repr=False)

    @property
    def warps(self) -> int:
        return self.cols_per_block * self.n_groups

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def blocks(self) -> int:
        return -(-self.n_cols // self.cols_per_block)

    def warp_work(self, block: int, warp: int):
        """(column, first offset index, end offset index) that warp
        ``warp`` of block ``block`` walks, as the kernel computes them, or
        None for a warp past the last column or with no offsets."""
        cb, g = divmod(warp, self.n_groups)
        c = block * self.cols_per_block + cb
        k0 = g * self.group
        k1 = min(k0 + self.group, len(self.offsets))
        return (c, k0, k1) if c < self.n_cols and k0 < k1 else None


def split_offsets(n_offsets: int, n_cols: int, resident_warps: int) -> tuple:
    """(group, n_groups, cols_per_block): the fewest offset groups a column
    (at most one warp of a block each, no group empty) whose warps, a
    column each, come to about one wave of the ``resident_warps`` the card
    holds (90% of it), else as many groups as a block allows; blocks of up
    to 8 warps."""
    best = None
    for n in range(1, min(n_offsets, WINDOW_WARPS) + 1):
        group = -(-n_offsets // n)
        best = (group, -(-n_offsets // group))
        if n_cols * best[1] >= 0.9 * resident_warps:
            break
    group, n_groups = best
    return group, n_groups, max(1, WINDOW_WARPS // n_groups)


def _window_params(plan_fields: dict, spec) -> _WindowParams:
    p = _WindowParams()
    for name in ("n_slots", "row_len", "n_cols", "pad", "group", "n_groups",
                 "cols_per_block"):
        setattr(p, name, plan_fields[name])
    offs = plan_fields["offsets"]
    p.n_offsets = len(offs)
    p.offsets[:len(offs)] = offs
    p.rcut2 = spec.rcut2
    p.clip_lo, p.clip_hi = spec.clip
    p.t_scale, p.t_shift = spec.t_scale, spec.t_shift
    for name in ("phi", "dphi", "rho"):
        coef = getattr(spec, name)
        getattr(p, name)[:len(coef)] = coef
    return p


@functools.lru_cache(maxsize=None)
def window_plan(spec, n_slots: int, row_len: int, n_cols: int,
                resident_warps: int) -> WindowPlan:
    """The launch plan of ``spec`` (a probes.window WindowSpec) over
    ``n_cols`` output columns of an rp [3, n_slots, row_len], for a card that
    holds ``resident_warps`` window warps at once; checked and made once per
    spec and shape (cached)."""
    offs = tuple(spec.offsets)
    if not 1 <= len(offs) <= MAX_OFFSETS:
        raise ValueError(f"window_pair takes 1 to {MAX_OFFSETS} offsets")
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"window_pair takes 1 to {MAX_SLOTS} slots, got "
                         f"{n_slots}")
    if n_cols < 1 or spec.pad + min(min(offs), 0) < 0 or \
            spec.pad + max(max(offs), 0) + n_cols > row_len:
        raise ValueError(f"{n_cols} columns at pad {spec.pad} with offsets "
                         f"{min(offs)}..{max(offs)} do not fit rp's "
                         f"{row_len} lanes")
    counts = (len(spec.phi), len(spec.dphi), len(spec.rho))
    if spec.physics == "cheb" and counts not in CHEB_COUNTS:
        raise ValueError(f"Clenshaw chains of {counts} coefficients: the "
                         f"kernel is built for {CHEB_COUNTS}")
    group, n_groups, cpb = split_offsets(len(offs), n_cols, resident_warps)
    fields = dict(physics=spec.physics,
                  counts=counts if spec.physics == "cheb" else (0, 0, 0),
                  n_slots=n_slots, row_len=row_len, n_cols=n_cols,
                  pad=spec.pad, offsets=offs, group=group, n_groups=n_groups,
                  cols_per_block=cpb)
    return WindowPlan(**fields, params=_window_params(fields, spec))


@functools.lru_cache(maxsize=None)
def _resident_warps(device_index: int, physics: str, counts: tuple) -> int:
    occ = occupancy(device_index, "window_pair", 32 * WINDOW_WARPS,
                    physics=physics, counts=counts)
    return occ.resident_blocks * WINDOW_WARPS


def card_window_plan(device_index: int, spec, n_slots: int, row_len: int,
                     n_cols: int) -> WindowPlan:
    """``window_plan`` for the card ``device_index`` (its occupancy asked
    once per device and variant)."""
    cheb = spec.physics == "cheb"
    counts = (len(spec.phi), len(spec.dphi), len(spec.rho)) if cheb \
        else (0, 0, 0)
    return window_plan(spec, n_slots, row_len, n_cols,
                       _resident_warps(device_index, spec.physics, counts))


def window_pair(rp: torch.Tensor, spec, n_cols: int) -> tuple:
    """P1-P3 on the card: the pair sums of ``spec`` (a probes.window
    WindowSpec) over ``n_cols`` output columns of ``rp`` [3, A, L], A <= 32.
    Returns (fx, u) for P1's physics, else (fx, u, rho), each [A, n_cols]."""
    _check_f32("window_pair", rp)
    if rp.dim() != 3 or rp.shape[0] != 3:
        raise ValueError(f"rp must be [3, A, L], got {tuple(rp.shape)}")
    dev = rp.device
    A, L = rp.shape[1], rp.shape[2]
    plan = card_window_plan(dev.index, spec, A, L, n_cols)
    n_out = spec.n_out
    outs = rp.new_empty((n_out, A, n_cols))
    lib = build()
    with torch.cuda.device(dev):
        err = lib.comd_window_pair(
            plan.params, _PHYSICS_ID[plan.physics], *plan.counts,
            rp.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if n_out == 3 else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "window_pair")
    LAUNCHES["window_pair"] += 1
    return tuple(outs.unbind(0))


# --------------------------------------------------------------------------
# lookups
# --------------------------------------------------------------------------

def _lookup_blocks(device_index: int, kernel: str, n_rows: int) -> int:
    """Blocks of ``kernel`` the card holds at once with an ``n_rows`` table
    staged (cached per device and table)."""
    if kernel == "row_lookup":
        threads, smem = ROW_THREADS, 16 * n_rows
    else:
        threads, smem = LANE_THREADS, 4 * LANE_SLICE * n_rows
    return occupancy(device_index, kernel, threads, smem).resident_blocks


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
    dev = x.device
    blocks = _lookup_blocks(dev.index, "row_lookup", tab.shape[0])
    out = torch.empty_like(x)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.comd_row_lookup(x.data_ptr(), tab.data_ptr(),
                                  out.data_ptr(), x.numel(), tab.shape[0],
                                  scale, blocks,
                                  torch.cuda.current_stream(dev).cuda_stream)
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
    dev = x.device
    blocks = _lookup_blocks(dev.index, "lane_lookup", tab.shape[0])
    out = torch.empty_like(x)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.comd_lane_lookup(x.data_ptr(), tab.data_ptr(),
                                   out.data_ptr(), x.shape[0], x.shape[1],
                                   tab.shape[0], scale, blocks,
                                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "lane_lookup")
    LAUNCHES["lane_lookup"] += 1
    return out
