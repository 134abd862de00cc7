"""The redistribution on hand-written CUDA kernels (csrc/rebucket.cu, one
source, one build, -fmad=false).

comd_tpu has no Pallas kernel for it: its ``binning.rebucket``
(comd_tpu/ops/binning.py:91-172) is one XLA fusion around a two-key
``lax.sort``.  As PyTorch ops (``rebucket_plain``: the wrap, the f64
binning, the halo fold, a stable ``torch.sort``, a run rank, seven
scatters) a serial rebucket at 63^3 costs ~186 launches and ~1.28 ms of
device time on an H100, so it is two kernels here:

- ``rebucket_bin``: one thread a local slot wraps, bins and folds its
  atom, takes a place in its cell's staging area (one atomic a warp and a
  cell) and writes the atom there as one record; it counts the migrating
  atoms and whether a kept cell got more than A;
- ``rebucket_place``: each cell's staged records ranked by gid, written
  to their slots, the rest emptied, the count written and its counter
  cleared; its block 0 writes n_migrating and the overflow flag.  A <= 32
  in the warp form (``place_form``: a cell a segment of ``place_lanes(A)``
  lanes, two cells a warp at A = 16, a record a lane loaded beside the
  count and ranked by shuffles), larger A in the block form (a thread a
  slot, the rank through shared memory).

``rebucket`` returns new tensors, as ``binning.rebucket`` (the mesh's
shards, ``utils/profile.py``); ``rebucket_into`` writes in place into the
fields it reads, with the lazy baseline's local rows (the serial step's
body).  Beside them sits ``rebucket_plain``, the port's torch code as it
was; the wrappers take it only for tensors on the CPU, and a CUDA tensor
launches the kernels or raises.  Kernels and plain version give the same
bits while no kept cell receives more than ``stage_capacity(A)`` atoms;
past that the counts, n_migrating and the overflow flag still agree but
the kept A atoms of such a cell may differ (csrc/rebucket.cu: a run
with overflow aborts).  Launches are counted in ``LAUNCHES`` under the
kernels' names.  The staging, the per-cell counters and two scratch words
are made at the first launch on a device (a workspace kept for the
process: a captured graph replays its addresses), which must not be
inside a CUDA graph capture; every launch leaves the counters and words
clear.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from .. import binning
from . import LAUNCHES
from .nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "rebucket.cu")
THREADS = 256          # csrc/rebucket.cu's kThreads
SMEM_LIMIT = 48 * 1024  # kSmemLimit: a block-form place block's shared
                        # memory, at most

_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process
_WORK = {}             # device index -> [Workspace, ...], never freed


def stage_capacity(A: int) -> int:
    """The staged records a cell (C): twice the capacity, at least 32 (a
    warp's lanes); the layout is exact up to C atoms a cell."""
    return max(2 * A, 32)


def place_smem(A: int) -> int:
    """Shared memory bytes of a block-form place block (csrc/rebucket.cu's
    place_smem): a count and C gids for each of its cells, as many cells
    as fit 256 threads with one a slot.  The wrapper refuses an A whose
    block would pass SMEM_LIMIT, whatever the form."""
    cells = THREADS // A if A < THREADS else 1
    return 4 * cells * (1 + stage_capacity(A))


def place_form(A: int) -> str:
    """The place launch's form: "warp" (a cell a segment of
    ``place_lanes(A)`` lanes, no shared memory) for A <= 32, else
    "block"."""
    return "warp" if A <= 32 else "block"


def place_lanes(A: int) -> int:
    """The warp form's lanes a cell: A rounded up to a power of two."""
    return 1 << max(A - 1, 0).bit_length()


class _Args(ctypes.Structure):
    """csrc/rebucket.cu's Args, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "r", "p", "gid", "n_atoms", "out_r", "out_p", "out_gid", "out_n",
        "last_r", "n_migrating", "overflow", "extent", "box_of_tuple",
        "halo_src", "halo_shift", "stage", "counts", "scalars")] + [
        ("local_min", ctypes.c_double * 3),
        ("local_max", ctypes.c_double * 3),
        ("inv_box", ctypes.c_double * 3),
        ("grid", ctypes.c_int * 3)] + [(name, ctypes.c_int) for name in (
            "n_local", "n_halo", "B", "A", "C", "max_box", "or_overflow",
            "form")]


def build():
    """Compile csrc/rebucket.cu for sm_90a (first use) and bind it.
    -fmad=false: each operation rounds once, as PyTorch's eager kernels
    round it."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "rebucket",
                                           ("-fmad=false",))
        lib.comd_rebucket.restype = ctypes.c_int
        lib.comd_rebucket.argtypes = [ctypes.c_int, ctypes.POINTER(_Args),
                                      ctypes.c_void_p]
        lib.comd_rebucket_error_string.restype = ctypes.c_char_p
        lib.comd_rebucket_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


class Workspace:
    """The kernels' device buffers: the staging (``stage_bytes`` bytes),
    the per-cell counters and two scratch words (``counts``: int32 [2 +
    n_cells], zero and left zero by every launch)."""

    def __init__(self, device: torch.device, stage_bytes: int, n_cells: int):
        self.stage = torch.empty(max(stage_bytes, 16), dtype=torch.uint8,
                                 device=device)
        self.counts = torch.zeros(2 + n_cells, dtype=torch.int32,
                                  device=device)

    def fits(self, stage_bytes: int, n_cells: int) -> bool:
        return self.stage.numel() >= stage_bytes and \
            self.counts.numel() >= 2 + n_cells


def workspace(device: torch.device, stage_bytes: int, n_cells: int,
              pool: dict = _WORK) -> Workspace:
    """A workspace of the device that holds ``stage_bytes`` of staging and
    ``n_cells`` counters: the first of ``pool``'s that does, else a new
    one (made outside a capture; the old ones stay, since graphs may
    replay them)."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    held = pool.setdefault(dev, [])
    for w in held:
        if w.fits(stage_bytes, n_cells):
            return w
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a kernel workspace (csrc/rebucket.cu's, "
                           "csrc/arrivals.cu's) is made at its first launch "
                           "at a size, which may not be captured")
    w = Workspace(torch.device("cuda", dev), stage_bytes, n_cells)
    held.append(w)
    return w


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def rebucket_plain(geom, maps, r, p, gid, n_atoms, *, wrap_extent=None,
                   keep_halo: bool = False):
    """Plain PyTorch: as ``rebucket`` (a stable sort on box << 31 | gid,
    a run rank and the scatters; the port's rebucket as it was)."""
    EMPTY_POS, EMPTY_GID = binning.EMPTY_POS, binning.EMPTY_GID
    A = r.shape[-1]
    B = r.shape[1]
    n_local = geom.n_local
    flat_n = n_local * A
    dev = r.device

    rl = r[:, :n_local].reshape(3, flat_n)
    pl = p[:, :n_local].reshape(3, flat_n)
    gl = gid[:n_local].reshape(flat_n)
    slot = torch.arange(A, device=dev, dtype=torch.int32).repeat(n_local)
    valid = slot < n_atoms[:n_local].repeat_interleave(A)

    if wrap_extent is not None:
        rl = binning.wrap_pbc(rl, wrap_extent)

    box = binning.box_from_coord(geom, maps, rl)

    if wrap_extent is not None:
        # an atom binned into a halo cell (a coordinate rounded exactly
        # onto L) is owned by the periodic-image local cell: fold it back
        # through the halo map (the reference's serial self-exchange with
        # PBC shift, src-mpi/parallel.c:112-117)
        in_halo = box >= n_local
        h = (box - n_local).clamp(0, geom.n_halo - 1)
        src = maps.halo_src[h]
        shf = maps.halo_shift.to(rl.dtype)[h]            # [N, 3]
        box = torch.where(in_halo, src, box)
        rl = torch.where(in_halo[None, :], rl - shf.T, rl)

    box = torch.where(valid, box, geom.n_total)          # empties sort last
    migrating = valid & (box >= n_local)
    n_migrating = migrating.sum(dtype=torch.int32)

    box_s, perm = binning._sort_by_box_gid(box, gl)
    rank, run_len = binning._run_rank(box_s, geom.n_total + 1)

    max_box = geom.n_total if keep_halo else n_local
    in_cell = box_s < max_box
    overflow = (in_cell & (rank >= A)).any()
    dest = torch.where(in_cell & (rank < A), box_s * A + rank, B * A)

    def scatter(flat_vals, fill):
        out = torch.full((B * A + 1,), fill, dtype=flat_vals.dtype,
                         device=dev)
        out[dest] = flat_vals[perm]          # slot B*A collects the drops
        return out[:B * A].reshape(B, A)

    new_r = torch.stack([scatter(rl[a], EMPTY_POS) for a in range(3)])
    new_p = torch.stack([scatter(pl[a], 0.0) for a in range(3)])
    new_gid = scatter(gl, int(EMPTY_GID))
    # occupancy counts every atom binned into a kept box, stored or not
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[:max_box] = run_len[:max_box].to(torch.int32)
    return new_r, new_p, new_gid, counts, n_migrating, overflow


def rebucket_into_plain(geom, maps, r, p, gid, n_atoms, overflow, *,
                        wrap_extent=None, last_r=None) -> None:
    """Plain PyTorch: as ``rebucket_into``."""
    new = rebucket_plain(geom, maps, r, p, gid, n_atoms,
                         wrap_extent=wrap_extent)
    for t, v in zip((r, p, gid, n_atoms), new):
        t.copy_(v)
    if last_r is not None:
        last_r[:, :geom.n_local] = new[0][:, :geom.n_local]
    overflow.logical_or_(new[5])


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _check(geom, maps, r, p, gid, n_atoms, wrap_extent, keep_halo: bool):
    """The operands the kernels take; raises ValueError on the others.
    Returns the wrap extent as a tensor of r's dtype on its device (None
    without a wrap) for the kernel path."""
    if r.dim() != 3 or r.shape[0] != 3 or not r.is_contiguous() or \
            r.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rebucket: r must be a contiguous float32 or "
                         f"float64 [3, B, A], got {r.dtype} "
                         f"{tuple(r.shape)}")
    B, A = r.shape[1], r.shape[2]
    dev = r.device
    if p.shape != r.shape or p.dtype != r.dtype or p.device != dev or \
            not p.is_contiguous():
        raise ValueError(f"rebucket: p must be a contiguous {r.dtype} "
                         f"{tuple(r.shape)} on {dev}")
    if gid.shape != (B, A) or gid.dtype != torch.int32 or \
            gid.device != dev or not gid.is_contiguous() or \
            n_atoms.shape != (B,) or n_atoms.dtype != torch.int32 or \
            n_atoms.device != dev or not n_atoms.is_contiguous():
        raise ValueError(f"rebucket: gid [{B}, {A}] and n_atoms [{B}] must "
                         f"be contiguous int32 on {dev}")
    max_box = geom.n_total if keep_halo else geom.n_local
    if B < max_box:
        raise ValueError(f"rebucket: {B} cells hold fewer than the "
                         f"{max_box} kept ones")
    if A < 1 or place_smem(A) > SMEM_LIMIT:
        raise ValueError(f"rebucket: {A} slots a cell: the place launch's "
                         f"shared memory takes at most {SMEM_LIMIT} bytes")
    if B * A >= 2 ** 31 or max_box * stage_capacity(A) >= 2 ** 31:
        raise ValueError(f"rebucket: {B} cells of {A} slots do not fit the "
                         f"kernels' 32-bit indices")
    if dev.type == "cpu":
        return None
    n_halo = geom.n_halo
    want = [("box_of_tuple", maps.box_of_tuple, tuple(geom.grid),
             torch.int64)] if geom.use_hilbert else []
    if wrap_extent is not None:
        want += [("halo_src", maps.halo_src, (n_halo,), torch.int64),
                 ("halo_shift", maps.halo_shift, (n_halo, 3), r.dtype)]
    for name, t, shape, dtype in want:
        if t.shape != shape or t.dtype != dtype or t.device != dev or \
                not t.is_contiguous():
            raise ValueError(f"rebucket: the maps' {name} must be a "
                             f"contiguous {dtype} {shape} on {dev}")
    if wrap_extent is None:
        return None
    if isinstance(wrap_extent, torch.Tensor):
        if wrap_extent.numel() != 3 or wrap_extent.dtype != r.dtype or \
                wrap_extent.device != dev or \
                not wrap_extent.is_contiguous():
            raise ValueError(f"rebucket: a wrap extent tensor must be 3 "
                             f"contiguous {r.dtype} values on {dev}")
        return wrap_extent
    # wrap_pbc's rounding of the host values to r's dtype
    return torch.as_tensor(np.asarray(wrap_extent, np.float64).reshape(3),
                           dtype=r.dtype, device=dev)


def _check_like(what: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or \
            t.device != like.device or not t.is_contiguous():
        raise ValueError(f"rebucket: {what} must be a contiguous "
                         f"{like.dtype} {tuple(like.shape)} on "
                         f"{like.device}")


def _launch(geom, maps, r, p, gid, n_atoms, out, extent, keep_halo: bool,
            last_r, n_migrating, overflow, or_overflow: bool) -> None:
    """Both kernels on r's current stream: ``out`` (r, p, gid, n_atoms)
    may be the inputs."""
    B, A = r.shape[1], r.shape[2]
    C = stage_capacity(A)
    max_box = geom.n_total if keep_halo else geom.n_local
    rec = 8 * r.element_size()               # 32 (f32) or 64 (f64) bytes
    w = workspace(r.device, max_box * C * rec, B)
    a = _Args()
    for name, t in (("r", r), ("p", p), ("gid", gid), ("n_atoms", n_atoms),
                    ("out_r", out[0]), ("out_p", out[1]),
                    ("out_gid", out[2]), ("out_n", out[3]),
                    ("last_r", last_r), ("n_migrating", n_migrating),
                    ("overflow", overflow), ("extent", extent),
                    ("box_of_tuple", maps.box_of_tuple
                     if geom.use_hilbert else None),
                    ("halo_src", maps.halo_src),
                    ("halo_shift", maps.halo_shift), ("stage", w.stage),
                    ("scalars", w.counts)):
        setattr(a, name, None if t is None else t.data_ptr())
    a.counts = w.counts.data_ptr() + 8
    a.local_min[:] = [float(v) for v in geom.local_min]
    a.local_max[:] = [float(v) for v in geom.local_max]
    a.inv_box[:] = [float(v) for v in geom.inv_box_size]
    a.grid[:] = [int(v) for v in geom.grid]
    a.n_local, a.n_halo, a.B, a.A, a.C = geom.n_local, geom.n_halo, B, A, C
    a.max_box, a.or_overflow = max_box, int(or_overflow)
    a.form = int(place_form(A) == "warp")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = build().comd_rebucket(r.element_size(), ctypes.byref(a), stream)
    if err != 0:
        msg = build().comd_rebucket_error_string(err).decode()
        raise RuntimeError(f"rebucket kernel launch failed: {msg} "
                           f"(cudaError {err})")
    if geom.n_local * A > 0:
        LAUNCHES["rebucket_bin"] += 1
    LAUNCHES["rebucket_place"] += 1


def rebucket(geom, maps, r, p, gid, n_atoms, *, wrap_extent=None,
             keep_halo: bool = False):
    """Re-bin every valid local atom into the canonical (cell, gid) dense
    layout (comd_tpu/ops/binning.py::rebucket).  ``r``, ``p``: [3, B, A]
    (the local boxes read); ``gid`` [B, A] and ``n_atoms`` [B] int32;
    ``wrap_extent`` ([3] host values, or a tensor of r's dtype on its
    device): the serial wrap into [0, L) and the fold of halo landers
    through ``maps.halo_src``/``halo_shift``; ``keep_halo``: atoms that
    bin into halo cells stay there (a mesh's shard).  Returns new tensors
    (r, p, gid, n_atoms, n_migrating, overflow), the last two 0-dim on
    the device.  CPU tensors run the plain version; CUDA tensors the two
    kernels (exact up to ``stage_capacity(A)`` atoms a kept cell)."""
    extent = _check(geom, maps, r, p, gid, n_atoms, wrap_extent, keep_halo)
    if r.device.type == "cpu":
        return rebucket_plain(geom, maps, r, p, gid, n_atoms,
                              wrap_extent=wrap_extent, keep_halo=keep_halo)
    out = (torch.empty_like(r), torch.empty_like(p), torch.empty_like(gid),
           torch.empty_like(n_atoms))
    n_mig = torch.empty((), dtype=torch.int32, device=r.device)
    ovf = torch.empty((), dtype=torch.bool, device=r.device)
    _launch(geom, maps, r, p, gid, n_atoms, out, extent, keep_halo, None,
            n_mig, ovf, False)
    return out + (n_mig, ovf)


def rebucket_into(geom, maps, r, p, gid, n_atoms, overflow, *,
                  wrap_extent=None, last_r=None) -> None:
    """``rebucket`` of a single domain (local cells kept) in place: r, p,
    gid and n_atoms take the new layout (the halo cells empty, for the
    halo fill to follow), ``overflow`` (a 0-dim bool) is or-ed with the
    overflow flag and, given, ``last_r`` ([3, B, A], the lazy baseline)
    takes the new positions in its local rows.  No allocation on the
    card: the serial step's conditional body.  CPU tensors run the plain
    version; CUDA tensors the two kernels."""
    extent = _check(geom, maps, r, p, gid, n_atoms, wrap_extent, False)
    if overflow.shape != () or overflow.dtype != torch.bool or \
            overflow.device != r.device:
        raise ValueError(f"rebucket: overflow must be a 0-dim bool on "
                         f"{r.device}")
    if last_r is not None:
        _check_like("last_r", last_r, r)
    if r.device.type == "cpu":
        rebucket_into_plain(geom, maps, r, p, gid, n_atoms, overflow,
                            wrap_extent=wrap_extent, last_r=last_r)
        return
    _launch(geom, maps, r, p, gid, n_atoms, (r, p, gid, n_atoms), extent,
            False, last_r, None, overflow, True)
