"""The small ops of the step around the EAM force on hand-written CUDA
kernels (csrc/step.cu, one source, one build, -fmad=false).

comd_tpu has no Pallas kernel for these: its jitted step
(comd_tpu/sim.py:337-390) leaves them to XLA, which fuses them around the
force.  As PyTorch ops they cost the serial EAM step ~66 launches and
~0.3 ms of device time on an H100, so each is one kernel here:

- ``kick_drift_trigger``: the half kick and the drift of every slot, then
  the skin trigger (comd_tpu/sim.py:367-373 and
  ops/neighborlist.py::needs_rebuild) as a 0-dim bool (the or over a
  mesh's shards) and, inside the step's CUDA graph,
  as the value of its IF nodes' conditional handles, set by the kernel's
  last block (graph_if.py: no kernel of its own sets them); with the
  image map of a single domain (``images``) also the serial ghost refresh
  (sim.py:353-358), written by the threads that drift the sources;
  ``last_r`` None: the kick and drift only, ``-S 0``;
- ``refresh_halo``: the serial halo fill (comd_tpu/ops/binning.py::
  fill_halo_serial): the halo rows' positions from their sources plus the
  shift, and their gids and counts, one launch (the rebucket's and the
  initial one, ``binning.fill_halo_serial``); a 2-D block, 16-byte
  vectors where A and the pointers allow (``halo_width``);
- ``embed_fill``: EAM pass 2 (``tables.interpolate``'s F and F'), dfEmbed
  [B, A] with the serial halo fill or zero halo rows, and on energy steps
  U = 0.5 phi + F with empty slots 0 (comd_tpu/ops/force_eam.py:371-380,
  :603); a thread takes the slots whose values (and U's) fit a 16-byte
  access, where A and the pointers allow (``embed_width``);
- ``land``: the force landing, the second half kick and the local atom
  count (sim.py:380-383), summed over a mesh's shards;
- ``embed_rows`` (ER): pass 2 of the list paths on a Verlet list's rows
  (comd_tpu/ops/force_eam.py:420-439): dfEmbed [B, A] in the cell layout,
  each slot F' of its row (``row_start[c] + s``), its serial halo fill
  or zero halo rows, and on energy steps U a row, written by the slot
  that owns the row; ``embed_fill``'s 16-byte vectors of slots where A
  allows (``embed_rows_plan``);
- ``land_rows`` (LR): ``land``'s form for a list force per row: each
  slot its row's force (EAM's two passes added), the kick and the count;
  without the kick the force only (the initial force, ``-s``).
ER and LR take their row operands as one or two row segments (the -a 1
split's interior and boundary sweeps), so no concatenation runs.
``kick_drift_trigger``, ``embed_fill`` and ``land`` take one shard's
fields or a mesh's stack of them ([S, ...], the step's buffers: comd_tpu's
leading shard index) and run every shard in one launch; their plain
versions run the shards one by one.  ER and LR stay one launch a shard.

Beside each sits its plain PyTorch version (``*_plain``: the step's torch
code as it was; ER's and LR's in ops/neighborlist.py); the wrappers take it only for tensors on the CPU, and a
CUDA tensor launches the kernel or raises.  Kernel and plain version give
the same bits.  Launches are counted in ``LAUNCHES`` (ops/cuda/
__init__.py) under the kernels' names.  The trigger and the count reduce
into a scratch buffer a device that each launch leaves clear (csrc/
step.cu), made at the first launch, which must therefore not be inside a
CUDA graph capture.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from ...potentials.tables import EmbedTable, as_dtype
from .. import neighborlist as nlmod
from . import LAUNCHES, as_stack
from .nvcc import CSRC, build_library

SOURCE = os.path.join(CSRC, "step.cu")
THREADS = 256          # csrc/step.cu's kThreads
BLOCKS_PER_SM = 8      # the grid-stride loops' grid: at most this a SM
# embed_fill's blocks a SM in each of its two ranges, a grid-stride loop
# over the vectors (None: a block to every 256 vectors, one vector a
# thread), without and with energy: the faster of the forms
# step_timing.py times at 63^3 f32 on an H100 (PERF.md §6); read at each
# launch, so that it can time the others
EMBED_BLOCKS_PER_SM = {False: 4, True: None}
# refresh_halo's grid: None, a block to every (256 / (A / width)) halo rows,
# once round; else at most this many blocks a SM, a grid-stride loop over
# the rows (step_timing.py times the forms; read at each launch)
HALO_BLOCKS_PER_SM = None
ROWS_A_THREAD = 4      # csrc/step.cu's kRowsAThread: embed_rows' U rows
MAX_SHARDS = 1024      # csrc/step.cu's kMaxShards: the trigger's words

_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process
_SCRATCH = {}          # device index -> the reductions' scratch words
_SMS = {}              # device index -> multiprocessors


def build():
    """Compile csrc/step.cu for sm_90a (first use) and bind it.
    -fmad=false: each operation rounds once, as PyTorch's eager kernels
    round it."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "step", ("-fmad=false",))
        p, i, d, q = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                      ctypes.c_longlong)
        for name, args in (
                ("comd_kick_drift_trigger",
                 [i, p, p, p, p, q, q, d, d, d, p, p, p, i, p, p, p, i, i,
                  i, i, p]),
                ("comd_refresh_halo", [i, i, p, p, p, p, p, i, i, i, i, i,
                                       p]),
                ("comd_embed_fill",
                 [i, i, i, p, p, p, p, p, p, i, i, i, i, d, d, p, i, q, q, q,
                  q, q, i, i, p]),
                ("comd_land", [i, p, p, p, q, q, p, q, q, q, q, d, p, q, i,
                               p, p, i, i, p]),
                ("comd_embed_rows",
                 [i, i, i, p, p, i, p, p, i, p, p, p, p, p, p, i, i, i, i,
                  i, d, d, p, i, i, p]),
                ("comd_land_rows",
                 [i, p, p, p, p, q, q, i, p, p, q, q, i, p, p, i, i, i, i,
                  i, d, p, i, p, i, p])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = i, args
        lib.comd_step_error_string.restype = ctypes.c_char_p
        lib.comd_step_error_string.argtypes = [i]
        _lib = lib
        return lib


def _launched(err: int, name: str) -> None:
    if err != 0:
        msg = build().comd_step_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES[name] += 1


def _sms(device: torch.device) -> int:
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


def _grid(n: int, device: torch.device) -> int:
    """Blocks of a grid-stride loop over ``n`` items."""
    return max(1, min(-(-n // THREADS), BLOCKS_PER_SM * _sms(device)))


def _scratch(device: torch.device) -> torch.Tensor:
    """The device's scratch words (csrc/step.cu's Scratch: 16 bytes and a
    trigger word a shard), zero and left zero by every launch."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _SCRATCH.get(dev)
    if s is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the step kernels' scratch is made at their "
                               "first launch, which may not be captured")
        s = _SCRATCH[dev] = torch.zeros(2 + MAX_SHARDS, dtype=torch.int64,
                                        device=torch.device("cuda", dev))
    return s


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_field(what: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """``t`` is a contiguous tensor of ``like``'s shape, dtype, device."""
    if t.shape != like.shape or t.dtype != like.dtype or \
            t.device != like.device or not t.is_contiguous():
        raise ValueError(f"{what}: expected contiguous {like.dtype} "
                         f"{tuple(like.shape)} on {like.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}"
                         + ("" if t.is_contiguous() else " (strided)"))


def _check_state(r: torch.Tensor) -> None:
    if r.dim() != 3 or r.shape[0] != 3 or not r.is_contiguous() or \
            r.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"expected a contiguous float32 or float64 [3, B, "
                         f"A] field, got {r.dtype} {tuple(r.shape)}")


def _check_stack(r: torch.Tensor) -> None:
    """``r`` is a contiguous float32 or float64 stack [S, 3, B, A] of at
    most MAX_SHARDS shards."""
    if r.dim() != 4 or r.shape[1] != 3 or not r.is_contiguous() or \
            r.dtype not in (torch.float32, torch.float64) or \
            not 1 <= r.shape[0] <= MAX_SHARDS:
        raise ValueError(f"expected a contiguous float32 or float64 stack "
                         f"[1..{MAX_SHARDS}, 3, B, A], got {r.dtype} "
                         f"{tuple(r.shape)}")


# --------------------------------------------------------------------------
# the head: half kick, drift, skin trigger
# --------------------------------------------------------------------------

def kick_drift_trigger_plain(p, r, f, last_r, n_local: int, kick: float,
                             drift: float, skin: float, flag=None,
                             add: bool = False, images=None):
    """Plain PyTorch: ``p += kick f``, ``r += p drift``, with ``images``
    the ghost refresh (``refresh_halo_plain``'s positions), then
    ``needs_rebuild`` (a 0-dim bool, or-ed into ``flag`` with ``add``,
    else written there when given), or None without ``last_r``.  Of a
    stack [S, 3, B, A], shard by shard, each after the first or-ing its
    trigger into the flag."""
    if r.dim() == 4:
        for s in range(r.shape[0]):
            out = kick_drift_trigger_plain(
                p[s], r[s], f[s], None if last_r is None else last_r[s],
                n_local, kick, drift, skin, flag, add or s > 0, images)
            flag = out if flag is None else flag
        return flag
    p.add_(kick * f)
    r.add_(p * drift)
    if images is not None:
        _refresh_plain(r, images.n_local, images.halo_src, images.halo_shift)
    if last_r is None:
        return None
    t = nlmod.needs_rebuild(last_r, r, n_local, skin)
    if flag is None:
        return t
    return flag.logical_or_(t) if add else flag.copy_(t)


def _check_images(images, r: torch.Tensor, n_local: int) -> None:
    """``images`` (binning.ImageMap) fits r [3, B, A] with ``n_local``
    local cells: one image a halo row, every tensor contiguous on r's
    device, the shifts in r's dtype, n_local * A < 2^31."""
    B, A = r.shape[1], r.shape[2]
    n_halo = B - n_local
    ok = images.n_local == n_local and \
        images.start.shape == (n_local + 1,) and \
        images.row.shape == (n_halo,) and \
        images.shift.shape == (n_halo, 3) and \
        images.halo_src.shape == (n_halo,) and \
        images.start.dtype == images.row.dtype == torch.int32 and \
        images.shift.dtype == images.halo_shift.dtype == r.dtype and \
        all(t.device == r.device and t.is_contiguous()
            for t in (images.start, images.row, images.shift))
    if not ok:
        raise ValueError(f"kick_drift_trigger: the image map of "
                         f"{images.n_local} local cells does not fit r "
                         f"{r.dtype} {tuple(r.shape)} on {r.device} with "
                         f"{n_local} local cells")
    if n_local * A >= 2 ** 31:
        raise ValueError(f"kick_drift_trigger: {n_local} local cells of {A} "
                         f"slots do not fit the images' 32-bit indices")


def kick_drift_trigger(p, r, f, last_r: Optional[torch.Tensor],
                       n_local: int, kick: float, drift: float,
                       skin: float = 0.0, flag: torch.Tensor = None,
                       handles: tuple = (), images=None):
    """The head of a step, in place on every shard's fields, one launch:
    ``p``, ``r``, ``f`` (and ``last_r``) one shard's [3, B, A] or a mesh's
    stack [S, 3, B, A], each contiguous.  The half kick ``p += kick * f``
    and the drift ``r += p * drift`` over every slot (``kick``, ``drift``:
    the step's constants rounded to the dtype), then, with the lazy
    baseline ``last_r``, whether some local slot of some shard moved more
    than skin/2 since it: a 0-dim bool, the or over the shards of each
    shard's max of |r - last_r|^2 over its first ``n_local`` cells against
    (skin/2)^2 rounded to the dtype, written into ``flag`` (a 0-dim bool on
    r's device; a new one when None).  ``handles``: inside a capture on the
    card, the IF nodes' conditional handles of that graph
    (``graph_if.condition``, one or two), which the kernel sets from the
    flag it writes: the first to the flag, the second to its negation.
    ``images`` (``binning.ImageMap``, a single domain's; one shard only):
    the ghost refresh too, the halo rows' positions their periodic
    sources' drifted ones plus the shift (the same bits as
    ``refresh_halo`` after the drift); the kernel writes them from the
    threads that drift the sources, and a halo slot's own thread kicks
    its p only.  Returns the flag, or None without ``last_r``.  CPU
    tensors run the plain version, shard by shard (each after the first
    or-ing its trigger into the flag); CUDA tensors the kernel."""
    one, r = as_stack("kick_drift_trigger r", r, 3)
    fields = [("p", p), ("f", f)] + (
        [("last_r", last_r)] if last_r is not None else [])
    fields = [(w, as_stack(f"kick_drift_trigger {w}", t, 3)[1])
              for w, t in fields]
    _check_stack(r)
    for what, t in fields:
        _check_field(what, t, r)
    p, f = fields[0][1], fields[1][1]
    last_r = fields[2][1] if last_r is not None else None
    S = r.shape[0]
    if flag is not None and (flag.shape != () or flag.dtype != torch.bool
                             or flag.device != r.device):
        raise ValueError(f"kick_drift_trigger: flag must be a 0-dim bool on "
                         f"{r.device}")
    if (handles and last_r is None) or len(handles) > 2:
        raise ValueError("kick_drift_trigger: handles need a baseline, and "
                         "at most two")
    if images is not None:
        if S != 1:
            raise ValueError("kick_drift_trigger: the serial images take one "
                             "shard")
        _check_images(images, r[0], n_local)
    if r.device.type == "cpu":
        if handles:
            raise ValueError("kick_drift_trigger: conditional handles are "
                             "set by the kernel, on the card")
        return kick_drift_trigger_plain(p, r, f, last_r, n_local, kick,
                                        drift, skin, flag, False, images)
    n = r.shape[2] * r.shape[3]
    if flag is None and last_r is not None:
        flag = torch.empty((), dtype=torch.bool, device=r.device)
    thresh = as_dtype((0.5 * skin) ** 2, r.dtype)
    img = (None, None, None) if images is None else (
        images.start.data_ptr(), images.row.data_ptr(),
        images.shift.data_ptr())
    grid = max(1, min(-(-n // THREADS), BLOCKS_PER_SM * _sms(r.device) // S))
    err = build().comd_kick_drift_trigger(
        r.element_size(), p.data_ptr(), r.data_ptr(), f.data_ptr(),
        None if last_r is None else last_r.data_ptr(), n,
        0 if last_r is None else n_local * r.shape[3], kick, drift, thresh,
        _scratch(r.device).data_ptr(),
        None if flag is None else flag.data_ptr(),
        (ctypes.c_ulonglong * 2)(*handles), len(handles), *img,
        r.shape[3], n_local, S, grid, _stream(r))
    _launched(err, "kick_drift_trigger")
    return flag


# --------------------------------------------------------------------------
# the serial halo fill
# --------------------------------------------------------------------------

def _refresh_plain(r, n_local: int, src, shift) -> None:
    r[:, n_local:] = r[:, src] + shift.T[:, :, None]


def refresh_halo_plain(geom, maps, r, gid=None, n_atoms=None):
    """Plain PyTorch: as ``refresh_halo``."""
    _refresh_plain(r, geom.n_local, maps.halo_src, maps.halo_shift)
    if gid is not None:
        gid[geom.n_local:] = gid[maps.halo_src]
        n_atoms[geom.n_local:] = n_atoms[maps.halo_src]
    return r


def refresh_halo(geom, maps, r, gid=None, n_atoms=None):
    """The serial halo fill, in place, one launch: every halo cell's
    positions from its periodic source cell plus the shift
    (``maps.halo_src``, ``maps.halo_shift``; comd_tpu/ops/binning.py::
    fill_halo_serial), and with ``gid`` ([B, A] int32) and ``n_atoms``
    ([B] int32) their gids and atom counts copied from the source.  The
    sources are local cells, so a launch reads no row it writes.  Returns
    ``r``.  CPU tensors run the plain version; CUDA tensors the kernel,
    whose indices are 32 bits: B * A must be below 2^31."""
    _check_state(r)
    B, A = r.shape[1], r.shape[2]
    src, shift = maps.halo_src, maps.halo_shift
    n_halo = B - geom.n_local
    if src.shape != (n_halo,) or src.dtype != torch.int64 or \
            shift.shape != (n_halo, 3) or shift.dtype != r.dtype or \
            not (src.is_contiguous() and shift.is_contiguous()) or \
            src.device != r.device or shift.device != r.device:
        raise ValueError(f"refresh_halo: the maps' halo_src [{n_halo}] "
                         f"int64 and halo_shift [{n_halo}, 3] {r.dtype} do "
                         f"not fit r {tuple(r.shape)} on {r.device}")
    if (gid is None) != (n_atoms is None) or (gid is not None and (
            gid.shape != (B, A) or n_atoms.shape != (B,) or
            gid.dtype != torch.int32 or n_atoms.dtype != torch.int32 or
            not (gid.is_contiguous() and n_atoms.is_contiguous()) or
            gid.device != r.device or n_atoms.device != r.device)):
        raise ValueError(f"refresh_halo: gid [{B}, {A}] and n_atoms [{B}] "
                         f"int32, contiguous on {r.device}, go together")
    if B * A >= 2 ** 31:
        raise ValueError(f"refresh_halo: {B} cells of {A} slots do not fit "
                         f"the kernel's 32-bit indices")
    if r.device.type == "cpu":
        return refresh_halo_plain(geom, maps, r, gid, n_atoms)
    if n_halo == 0:
        return r
    width = halo_width(A, r.element_size(),
                       [t.data_ptr() for t in (r, gid) if t is not None])
    per_row = A // width
    rows = THREADS // min(per_row, THREADS)
    blocks = -(-n_halo // rows)
    if HALO_BLOCKS_PER_SM is not None:
        blocks = min(blocks, HALO_BLOCKS_PER_SM * _sms(r.device))
    err = build().comd_refresh_halo(
        r.element_size(), width, r.data_ptr(),
        None if gid is None else gid.data_ptr(),
        None if n_atoms is None else n_atoms.data_ptr(), src.data_ptr(),
        shift.data_ptr(), n_halo, A, geom.n_local, B, blocks, _stream(r))
    _launched(err, "refresh_halo")
    return r


def halo_width(A: int, elem: int, ptrs) -> int:
    """The slots a thread of refresh_halo takes: as many as fill a 16-byte
    access of the ``elem``-byte positions (4 f32, 2 f64), when A is a
    multiple of them and every pointer is 16-byte aligned; else 1."""
    w = 16 // elem
    if A % w == 0 and all(q % 16 == 0 for q in ptrs):
        return w
    return 1


# --------------------------------------------------------------------------
# EAM pass 2 and the dfEmbed field
# --------------------------------------------------------------------------

def embed_fill_plain(f_eval: EmbedTable, rhobar, phi, n_atoms, n_rows: int,
                     halo_src=None, e_dtype=torch.float64):
    """Plain PyTorch: (dfEmbed [n_rows, A], U [n_local, A] | None), as
    ``embed_fill``; of a stack [S, n_local, A], shard by shard, the
    results stacked."""
    if rhobar.dim() == 3:
        outs = [embed_fill_plain(f_eval, rhobar[s],
                                 None if phi is None else phi[s], n_atoms[s],
                                 n_rows, halo_src, e_dtype)
                for s in range(rhobar.shape[0])]
        return (torch.stack([d for d, _u in outs]),
                None if phi is None else torch.stack([u for _d, u in outs]))
    f_emb, df = f_eval(rhobar)
    n_local, A = rhobar.shape
    dfe = df.new_zeros((n_rows, A))
    dfe[:n_local] = df
    if halo_src is not None:
        dfe[n_local:] = torch.index_select(dfe, 0, halo_src)
    if phi is None:
        return dfe, None
    u = 0.5 * phi.to(e_dtype) + f_emb.to(e_dtype)
    valid = torch.arange(A, device=u.device) < n_atoms[:n_local, None]
    return dfe, torch.where(valid, u, torch.zeros((), dtype=e_dtype,
                                                  device=u.device))


def embed_fill(f_eval: EmbedTable, rhobar, phi, n_atoms, n_rows: int,
               halo_src=None, e_dtype=torch.float64):
    """EAM pass 2 of every shard, one launch, from its density ``rhobar``
    (one shard's [n_local, A] or a mesh's stack [S, n_local, A], each
    shard contiguous, the shards any distance apart; eam.c:351-371):
    dfEmbed [.., n_rows, A] (B rows) holding F'(rhobar) in the local rows
    and, in the halo rows, F' of the serial periodic source rows
    ``halo_src`` ([B - n_local] int64: the serial fill, the same bits as
    copying them) or 0 (``halo_src`` None: a mesh transport fills them).
    With the pair energy ``phi`` (rhobar's shape; energy steps) also U =
    0.5 phi + F(rhobar) [.., n_local, A] in ``e_dtype``, 0 in the slots at
    or past the shard's ``n_atoms`` ([.., B] int32).  Returns (dfEmbed,
    U | None).  CPU tensors run the plain version shard by shard; CUDA
    tensors the kernel, whose indices within a shard are 32 bits:
    ``n_rows * A`` must be below 2^31."""
    one, rhobar = as_stack("embed_fill rhobar", rhobar, 2)
    if not rhobar[0].is_contiguous() or \
            rhobar.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"embed_fill: rhobar must be float32 or float64 "
                         f"[n_local, A] a shard, each contiguous, got "
                         f"{rhobar.dtype} {tuple(rhobar.shape)}")
    S, n_local, A = rhobar.shape
    dev = rhobar.device
    tab = f_eval.table
    if tab.dtype != rhobar.dtype or tab.device != dev or \
            not tab.is_contiguous():
        raise ValueError("embed_fill: F's table must be contiguous, of "
                         "rhobar's dtype, on its device")
    if phi is not None:
        phi = as_stack("embed_fill phi", phi, 2)[1]
        if phi.shape != rhobar.shape or phi.dtype != rhobar.dtype or \
                phi.device != dev or not phi[0].is_contiguous():
            raise ValueError(f"embed_fill phi: expected {rhobar.dtype} "
                             f"{tuple(rhobar.shape)}, each shard contiguous, "
                             f"on {dev}")
    if isinstance(n_atoms, torch.Tensor):
        n_atoms = as_stack("embed_fill n_atoms", n_atoms, 1)[1]
    if not isinstance(n_atoms, torch.Tensor) or (
            n_atoms.shape[0] != S or n_atoms.shape[1] < n_local or
            n_atoms.dtype != torch.int32 or n_atoms.device != dev or
            n_atoms.stride(1) != 1):
        raise ValueError(f"embed_fill: n_atoms must be int32 [>= {n_local}] "
                         f"a shard, each contiguous, on rhobar's device")
    if halo_src is not None and (
            halo_src.shape != (n_rows - n_local,) or
            halo_src.dtype != torch.int64 or halo_src.device != dev or
            not halo_src.is_contiguous()):
        raise ValueError(f"embed_fill: halo_src must be a contiguous int64 "
                         f"[{n_rows - n_local}] on rhobar's device")
    if e_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"embed_fill: unsupported energy dtype {e_dtype}")
    if n_rows * A >= 2 ** 31:
        raise ValueError(f"embed_fill: {n_rows} rows of {A} slots do not fit "
                         f"the kernel's 32-bit indices")
    if S > 65535:
        raise ValueError(f"embed_fill: {S} shards exceed the grid's 65535")
    if dev.type == "cpu":
        dfe, u = embed_fill_plain(f_eval, rhobar, phi, n_atoms, n_rows,
                                  halo_src, e_dtype)
        return (dfe[0], None if u is None else u[0]) if one else (dfe, u)
    dfe = torch.empty((S, n_rows, A), dtype=rhobar.dtype, device=dev)
    u = None if phi is None else torch.empty((S, n_local, A), dtype=e_dtype,
                                             device=dev)
    if n_rows * A > 0:
        # every shard's pointers aligned: the bases and the shard strides
        ptrs = [q for t in (rhobar, phi, dfe, u) if t is not None
                for q in (t.data_ptr(),
                          t.data_ptr() + t.stride(0) * t.element_size())]
        width = embed_width(A, rhobar.element_size(), ptrs,
                            None if u is None else u.element_size())

        def ptr(t):
            return None if t is None else t.data_ptr()

        per_sm = EMBED_BLOCKS_PER_SM[phi is not None]

        def blocks(rows):
            n = -(-rows * A // width // THREADS)
            return n if per_sm is None else \
                min(n, max(1, per_sm * _sms(dev) // S))

        err = build().comd_embed_fill(
            rhobar.element_size(), 8 if e_dtype == torch.float64 else 4,
            width, rhobar.data_ptr(), ptr(phi), n_atoms.data_ptr(),
            ptr(halo_src), dfe.data_ptr(), ptr(u), A, n_local, n_rows,
            f_eval.n, f_eval.x0, f_eval.inv_dx, tab.data_ptr(), S,
            rhobar.stride(0), 0 if phi is None else phi.stride(0),
            n_atoms.stride(0), dfe.stride(0), 0 if u is None else u.stride(0),
            blocks(n_local), blocks(n_rows - n_local), _stream(rhobar))
        _launched(err, "embed_fill")
    if one:
        return dfe[0], None if u is None else u[0]
    return dfe, u


def embed_width(A: int, elem: int, ptrs, e_elem: int = None) -> int:
    """The slots a thread of embed_fill takes: as many as fill a 16-byte
    access of the ``elem``-byte values and, with energy, of U's
    ``e_elem``-byte ones (4 f32, 2 f64 or with U in f64), when A is a
    multiple of them and every pointer is 16-byte aligned; else 1."""
    w = 16 // max(elem, e_elem or 0)
    if A % w == 0 and all(q % 16 == 0 for q in ptrs):
        return w
    return 1


# --------------------------------------------------------------------------
# the landing: force, second half kick, atom count
# --------------------------------------------------------------------------

def land_plain(f, p, f1, f3, n_atoms, n_local_out, n_local: int,
               kick: float, add: bool = False) -> None:
    """Plain PyTorch: as ``land``; of a stack [S, 3, B, A], shard by
    shard, each after the first adding its count."""
    if f.dim() == 4:
        for s in range(f.shape[0]):
            land_plain(f[s], p[s], f1[s], None if f3 is None else f3[s],
                       n_atoms[s], n_local_out, n_local, kick, add or s > 0)
        return
    f[:, :n_local] = f1 if f3 is None else f1 + f3
    f[:, n_local:] = 0
    p.add_(kick * f)
    count = n_atoms[:n_local].sum(dtype=torch.int32)
    n_local_out.copy_(n_local_out + count if add else count)


def land(f, p, f1, f3, n_atoms, n_local_out, n_local: int,
         kick: float) -> None:
    """The end of a step of every shard, in place, one launch: the force
    ``f`` (one shard's [3, B, A] or a mesh's stack [S, 3, B, A],
    contiguous, as ``p``) gets ``f1`` (+ ``f3``: EAM's two passes, added
    here) in its first ``n_local`` cells and 0 in the halo cells, then the
    half kick ``p += kick * f``, and ``n_local_out`` (0-dim int32) the
    atoms in the local cells of every shard's ``n_atoms`` ([.., B] int32,
    each shard contiguous).  ``f1``/``f3``: [.., 3, n_local, A], each plane
    contiguous (planes and shards any distance apart).  CPU tensors run
    the plain version shard by shard, each after the first adding its
    count; CUDA tensors the kernel."""
    f = as_stack("land f", f, 3)[1]
    _check_stack(f)
    p = as_stack("land p", p, 3)[1]
    _check_field("land p", p, f)
    S, A = f.shape[0], f.shape[3]
    parts = []
    for what, t in (("f1", f1), ("f3", f3)):
        if t is not None:
            t = as_stack(f"land {what}", t, 3)[1]
            if t.shape != (S, 3, n_local, A) or t.dtype != f.dtype or \
                    t.device != f.device or t.stride()[2:] != (A, 1):
                raise ValueError(f"land {what}: expected {f.dtype} [{S}, 3, "
                                 f"{n_local}, {A}] with contiguous planes on "
                                 f"{f.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} strides {t.stride()} on "
                                 f"{t.device}")
        parts.append(t)
    f1, f3 = parts
    if isinstance(n_atoms, torch.Tensor):
        n_atoms = as_stack("land n_atoms", n_atoms, 1)[1]
    if not isinstance(n_atoms, torch.Tensor) or \
            n_atoms.shape != (S, f.shape[2]) or \
            n_atoms.dtype != torch.int32 or n_atoms.stride(1) != 1 or \
            n_atoms.device != f.device or \
            n_local_out.shape != () or n_local_out.dtype != torch.int32 or \
            n_local_out.device != f.device:
        raise ValueError("land: n_atoms must be int32 [B] a shard, each "
                         "contiguous, and n_local_out a 0-dim int32, on f's "
                         "device")
    if S > 65535:
        raise ValueError(f"land: {S} shards exceed the grid's 65535")
    if f.device.type == "cpu":
        land_plain(f, p, f1, f3, n_atoms, n_local_out, n_local, kick)
        return
    n = f.shape[2] * A
    grid = max(1, min(-(-n // THREADS), BLOCKS_PER_SM * _sms(f.device) // S))
    err = build().comd_land(
        f.element_size(), f.data_ptr(), p.data_ptr(), f1.data_ptr(),
        f1.stride(0), f1.stride(1), None if f3 is None else f3.data_ptr(),
        0 if f3 is None else f3.stride(0), 0 if f3 is None else f3.stride(1),
        n, n_local * A, kick, n_atoms.data_ptr(), n_atoms.stride(0), n_local,
        n_local_out.data_ptr(), _scratch(f.device).data_ptr(), S, grid,
        _stream(f))
    _launched(err, "land")


# --------------------------------------------------------------------------
# the list paths: pass 2 on the rows, the landing of a list force
# --------------------------------------------------------------------------

def _segments(what: str, segs, n_rows: int, planes: int, dtype, dev):
    """(ptr0, ptr1, plane stride 0, plane stride 1, split) of a row operand
    given as a tuple of one or two segments whose rows add up to
    ``n_rows``: [rows] (``planes`` 0) or [planes, rows] tensors, rows
    contiguous, of ``dtype`` on ``dev``."""
    segs = tuple(segs)
    ok = len(segs) in (1, 2)
    for t in segs if ok else ():
        shape_ok = (t.dim() == 1 if planes == 0 else
                    t.dim() == 2 and t.shape[0] == planes)
        ok = ok and shape_ok and t.dtype == dtype and t.device == dev and \
            t.stride(-1) == 1
    if not ok or sum(t.shape[-1] for t in segs) != n_rows:
        shape = "[rows]" if planes == 0 else f"[{planes}, rows]"
        raise ValueError(f"{what}: expected one or two {dtype} {shape} row "
                         f"segments, rows contiguous, on {dev}, {n_rows} "
                         f"rows in all")
    plane = [t.stride(0) if planes else 0 for t in segs]
    if len(segs) == 1:
        return segs[0].data_ptr(), None, plane[0], 0, n_rows
    return (segs[0].data_ptr(), segs[1].data_ptr(), plane[0], plane[1],
            segs[0].shape[-1])


def _check_rows_of(what: str, nlist, n_atoms, n_local: int, dev):
    """The list's rows and ``row_start`` and ``n_atoms`` fit together."""
    R = nlist.a_list.shape[0]
    rs = nlist.row_start
    if nlist.a_valid.shape != (R,) or nlist.a_valid.dtype != torch.bool or \
            rs.dim() != 1 or rs.shape[0] < n_local or \
            rs.dtype != torch.int32 or not rs.is_contiguous() or \
            not nlist.a_valid.is_contiguous() or \
            n_atoms.dim() != 1 or n_atoms.shape[0] < n_local or \
            n_atoms.dtype != torch.int32 or not n_atoms.is_contiguous() or \
            any(t.device != dev for t in (nlist.a_valid, rs, n_atoms)):
        raise ValueError(f"{what}: the list's a_valid [R] bool, row_start "
                         f"[>= {n_local}] int32 and n_atoms [>= {n_local}] "
                         f"int32 must be contiguous on {dev}")
    return R


def rows_width(A: int, elem: int) -> int:
    """The slots a thread of embed_rows takes: a 16-byte vector of the
    ``elem``-byte values (4 f32, 2 f64) when A is a multiple of it, else
    1.  U is a row's, stored a row at a time (rows are not aligned to
    slots), so its dtype does not enter."""
    w = 16 // elem
    return w if A % w == 0 else 1


def embed_rows_plan(A: int, elem: int, n_slots: int, n_rows: int,
                    energy: bool) -> tuple:
    """embed_rows' launch plan: (width, slot blocks, row blocks).  The
    slot blocks cover the ``n_slots / width`` vectors of dfEmbed, the row
    blocks (energy steps only, else 0) U's ``n_rows``, ``ROWS_A_THREAD``
    rows a thread; each range a block to every 256 threads, one at least
    (grids capped at 4 or 8 blocks an SM measured slower at the 63^3 list
    headline on an H100)."""
    width = rows_width(A, elem)

    def blocks(n):
        return max(1, -(-n // THREADS))

    return (width, blocks(n_slots // width),
            blocks(-(-n_rows // ROWS_A_THREAD)) if energy else 0)


def embed_rows(f_eval: EmbedTable, nlist, n_atoms, rho, phi, n_local: int,
               B: int, halo_src=None, e_dtype=torch.float64):
    """EAM pass 2 on the rows of a Verlet list (ER): (dfEmbed [B, A], U [R]
    | None), as ``neighborlist.embed_rows_plain`` defines them.  ``rho``
    (and ``phi`` on energy steps, else None) are the rows' sums as a tuple
    of one or two row segments ([R_s], rows in order: the -a 1 split's
    interior and boundary sweeps); ``n_atoms`` the counts by cell;
    ``halo_src`` ([B - n_local] int64) the serial fill's sources, None on a
    mesh (zero halo rows).  The list's valid rows are those that
    ``row_start`` and ``n_atoms`` give the local slots (NR built it from
    these counts): on the card the slot that owns a row writes its U.  CPU
    tensors run the plain version; CUDA tensors the kernel, one launch,
    32-bit indices (B * A < 2^31)."""
    A = nlist.last_r.shape[2]
    tab = f_eval.table
    dtype, dev = tab.dtype, tab.device
    if dtype not in (torch.float32, torch.float64) or \
            not tab.is_contiguous():
        raise ValueError(f"embed_rows: F's table must be a contiguous "
                         f"float32 or float64 tensor, got {dtype}")
    R = _check_rows_of("embed_rows", nlist, n_atoms, n_local, dev)
    rho_s = _segments("embed_rows rho", rho, R, 0, dtype, dev)
    phi_s = (None, None, 0, 0, R) if phi is None else \
        _segments("embed_rows phi", phi, R, 0, dtype, dev)
    if halo_src is not None and (
            halo_src.shape != (B - n_local,) or
            halo_src.dtype != torch.int64 or halo_src.device != dev or
            not halo_src.is_contiguous()):
        raise ValueError(f"embed_rows: halo_src must be a contiguous int64 "
                         f"[{B - n_local}] on {dev}")
    if e_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"embed_rows: unsupported energy dtype {e_dtype}")
    if B * A >= 2 ** 31:
        raise ValueError(f"embed_rows: {B} cells of {A} slots do not fit "
                         f"the kernel's 32-bit indices")
    if dev.type == "cpu":
        return nlmod.embed_rows_plain(f_eval, nlist, n_atoms, rho, phi,
                                      n_local, B, halo_src, e_dtype)
    dfe = torch.empty((B, A), dtype=dtype, device=dev)
    u = None if phi is None else torch.empty(R, dtype=e_dtype, device=dev)
    width, slot_blocks, row_blocks = embed_rows_plan(
        A, tab.element_size(), B * A, R, u is not None)
    err = build().comd_embed_rows(
        tab.element_size(), 8 if e_dtype == torch.float64 else 4, width,
        rho_s[0], rho_s[1], rho_s[4], phi_s[0], phi_s[1], phi_s[4],
        nlist.a_valid.data_ptr(), nlist.row_start.data_ptr(),
        n_atoms.data_ptr(), None if halo_src is None else halo_src.data_ptr(),
        dfe.data_ptr(), None if u is None else u.data_ptr(), A, n_local,
        B * A, R, f_eval.n, f_eval.x0, f_eval.inv_dx, tab.data_ptr(),
        slot_blocks, row_blocks, _stream(tab))
    _launched(err, "embed_rows")
    return dfe, u


def land_rows(f, p, nlist, n_atoms, parts, n_local_out, n_local: int,
              kick: Optional[float] = None, add: bool = False) -> None:
    """The landing of a list force (LR), in place: ``parts`` the force's
    passes (EAM's f1 and f3, added row by row; LJ's one), each a tuple of
    one or two [3, R_s] row segments (rows contiguous, planes any stride
    apart: NL2's outputs).  ``f`` [3, B, A] gets each local slot's row
    force (``row_start[c] + s``) and 0 in every other slot; then, with
    ``kick`` (the step's half-kick constant), ``p += kick * f`` and
    ``n_local_out`` (0-dim int32) the local atoms of ``n_atoms``, added to
    its value with ``add``.  Without ``kick`` only f is written (``p`` and
    ``n_local_out`` may be None).  CPU tensors run the plain version; CUDA
    tensors the kernel, one launch, 32-bit indices (B * A < 2^31)."""
    _check_state(f)
    dev = f.device
    if kick is not None:
        _check_field("land_rows p", p, f)
        if n_local_out is None or n_local_out.shape != () or \
                n_local_out.dtype != torch.int32 or \
                n_local_out.device != dev:
            raise ValueError("land_rows: n_local_out must be a 0-dim int32 "
                             "on f's device")
    R = _check_rows_of("land_rows", nlist, n_atoms, n_local, dev)
    if len(parts) not in (1, 2):
        raise ValueError("land_rows: one or two force passes")
    segs = [_segments(f"land_rows pass {k + 1}", part, R, 3, f.dtype, dev)
            for k, part in enumerate(parts)]
    B, A = f.shape[1], f.shape[2]
    if B * A >= 2 ** 31:
        raise ValueError(f"land_rows: {B} cells of {A} slots do not fit "
                         f"the kernel's 32-bit indices")
    if dev.type == "cpu":
        nlmod.land_rows_plain(f, p, nlist, n_atoms, parts, n_local_out,
                              n_local, kick, add)
        return
    f3 = segs[1] if len(segs) == 2 else (None, None, 0, 0, R)
    scratch = None if kick is None else _scratch(dev).data_ptr()
    err = build().comd_land_rows(
        f.element_size(), f.data_ptr(),
        None if kick is None else p.data_ptr(), *segs[0], *f3,
        nlist.row_start.data_ptr(), n_atoms.data_ptr(), A, n_local, B * A, R,
        int(kick is not None), 0.0 if kick is None else kick,
        None if kick is None else n_local_out.data_ptr(), int(add), scratch,
        _grid(B * A, dev), _stream(f))
    _launched(err, "land_rows")
