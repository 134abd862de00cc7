"""EAM passes 1 and 3 and LJ on the hand-written CUDA cell-stencil kernels.

Two kernels, one source (csrc/stencil.cu), one build:

- K1, the full-shell sweep, replaces comd_tpu/ops/pallas/stencil.py::_kernel
  (driven by stencil_sweep, with the eam_pass1_stencil / eam_pass3_stencil /
  _lj_pair pair functions): the 27-cell pair sweep that sums, per i-slot,
  fc * (dx, dy, dz) and the per-pair scalars.  Wrappers ``eam_pass1``,
  ``eam_pass3``, ``lj_pass``.
- K2, the half-shell sweep, replaces stencil.py::_kernel_half (driven by
  stencil_sweep_half): every pair within the cutoff evaluated once over
  the 14-cell half map and delivered to both atoms, into dense [.., B, A]
  outputs whose halo rows the caller folds (ops/sweep.fold_halo_serial).
  Wrappers ``eam_pass1_half``, ``eam_pass3_half``, ``lj_pass_half``.

What bounds them on the card: pair arithmetic.  At the 63^3 EAM headline
(74,088 local cells, A = 16) one K1 pass tests 74,088 * 27 * 16 * 16 =
512 M candidate pairs, ~12% of them inside the cutoff, and reads ~22 MB of
cell data, so it is compute-bound; K2 tests about half as many.  Design:
TI = min(A, 128) threads per cell, each owning one i-slot (looping over
i-slots in steps of TI when A > TI), several cells per block (>= 128
threads); the block stages one neighbor cell per cell at a time in shared
memory, in tiles of TI slots (positions, plus dfEmbed for pass 3), and every
i-thread walks the staged slots; the pair evaluation runs only for pairs
inside the cutoff.  K2 gathers each pair's j-side terms in shared memory and
adds them to the dense output with one global atomicAdd per (j-slot,
output) per tile, so its float sums change in the last bits from run to
run.  The kernels read the state's own [3, B, A] layout and the
``GeomMaps`` neighbor maps directly: comd_tpu's transposed cells-on-lanes
window, its locality plane and its overlap-added chunk spills were TPU lane
artefacts and are gone.

Beside each kernel sits its plain PyTorch version (ops/sweep.py sweeps with
the same pair functions, ``*_plain``).  The wrappers take it only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` (ops/cuda/__init__.py) counts kernel launches per wrapper.

The 27-neighbor and half-map orders differ from the Pallas kernels' dense
offset orders, so f32 results agree with comd_tpu up to reassociation; f64
agrees to rounding.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
from typing import Optional

import torch

from ...potentials import tables
from ...potentials.tables import ChebFused
from ..sweep import cell_pair_sweep, cell_pair_sweep_half
from . import LAUNCHES, reset_launch_counts  # noqa: F401 (re-exported)
from .nvcc import BUILD_DIR, CSRC, build_library  # noqa: F401

#: largest cell capacity the kernels take (they loop over i-slots and stage
#: j-slots in tiles of 128, so this bounds only the work per block)
MAX_A = 512
#: coefficient slots per Chebyshev output in the kernel's parameter struct
MAX_CHEB = 40

SOURCE = os.path.join(CSRC, "stencil.cu")
_TRANSFORM_ID = {"u": 0, "inv_u": 1, "log_u": 2}
_PAIR_ID = {"eam_pass1": 0, "eam_pass3": 1, "lj": 2}


@dataclasses.dataclass(frozen=True)
class PairEvaluator:
    """The pair representation the pair passes evaluate.

    ``kind`` "cheb": the EAM shared-basis Chebyshev fit (tables.ChebFused).
    ``kind`` "table": the EAM reference quadratic interpolation of the phi
    and rho tables, held as [n+4] device arrays (InterpTable.device_table).
    ``kind`` "lj": the analytic Lennard-Jones pair (``s6`` = sigma^6,
    ``eps4`` = 4 epsilon, ``e_shift``), each rounded to ``dtype``.
    """
    kind: str
    dtype: torch.dtype
    rcut2: float
    cheb: Optional[ChebFused] = None
    phi: Optional[torch.Tensor] = None
    rho: Optional[torch.Tensor] = None
    n: int = 0
    x0: float = 0.0
    inv_dx: float = 0.0
    s6: float = 0.0
    eps4: float = 0.0
    e_shift: float = 0.0


# --------------------------------------------------------------------------
# plain PyTorch pair functions (the kernels' per-pair arithmetic)
# --------------------------------------------------------------------------

def _pair1(ev: PairEvaluator, want_energy: bool):
    def pair(r2, mask, sj, si):
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        if ev.kind == "cheb":
            wants = ([("phi", "val")] if want_energy else []) + \
                [("phi", "der"), ("rho", "val")]
            outs = tables.eval_cheb_fused(ev.cheb, r2, wants)
            phi = outs[0] if want_energy else None
            dphi, rho = outs[-2], outs[-1]
            fc = torch.where(mask, -dphi, zero)
        else:
            rr = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
            phi, dphi = tables.interpolate(ev.phi, ev.n, ev.x0, ev.inv_dx, rr)
            rho, _ = tables.interpolate(ev.rho, ev.n, ev.x0, ev.inv_dx, rr)
            fc = torch.where(mask, -dphi / rr, zero)
        scal = [torch.where(mask, rho, zero)]
        if want_energy:
            scal.insert(0, torch.where(mask, phi, zero))
        return fc, scal
    return pair


def _pair3(ev: PairEvaluator):
    def pair(r2, mask, sj, si):
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        if ev.kind == "cheb":
            (scale,) = tables.eval_cheb_fused(ev.cheb, r2, [("rho", "der")])
        else:
            rr = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
            _, drho = tables.interpolate(ev.rho, ev.n, ev.x0, ev.inv_dx, rr)
            scale = drho / rr
        return torch.where(mask, -(si[0] + sj[0]) * scale, zero), []
    return pair


def _pair_lj(ev: PairEvaluator, want_energy: bool):
    """comd_tpu.ops.force_lj.make_lj_pair_fn (ljForce.c:146-265): the
    unscaled shifted energy r6 (r6 - 1) - e_shift and the force coefficient
    4 eps r6 / r2 (12 r6 - 6)."""
    def pair(r2, mask, sj, si):
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        inv_r2 = torch.where(
            mask, 1.0 / torch.where(mask, r2, torch.ones_like(r2)), zero)
        r6 = (ev.s6 * inv_r2) * (inv_r2 * inv_r2)
        fc = torch.where(mask, ev.eps4 * r6 * inv_r2 * (12.0 * r6 - 6.0),
                         zero)
        if not want_energy:
            return fc, []
        return fc, [torch.where(mask, r6 * (r6 - 1.0) - ev.e_shift, zero)]
    return pair


def eam_pass1_plain(r, nbr_map, ev: PairEvaluator, *,
                    want_energy: bool = True, box_chunk: int = 256):
    """Plain PyTorch pass 1 -> (f1 [3, n_local, A], phi_sum | None, rhobar)."""
    f1, scal = cell_pair_sweep(r, nbr_map, _pair1(ev, want_energy),
                               ev.rcut2, chunk=box_chunk)
    phi_sum, rhobar = scal if want_energy else (None, scal[0])
    return f1, phi_sum, rhobar


def eam_pass3_plain(r, nbr_map, ev: PairEvaluator, df_embed, *,
                    box_chunk: int = 256):
    """Plain PyTorch pass 3 -> f3 [3, n_local, A]."""
    f3, _ = cell_pair_sweep(r, nbr_map, _pair3(ev), ev.rcut2,
                            scalar_j=[df_embed], chunk=box_chunk)
    return f3


def lj_pass_plain(r, nbr_map, ev: PairEvaluator, *, want_energy: bool = True,
                  box_chunk: int = 256):
    """Plain PyTorch LJ sweep -> (f [3, n_local, A], e [n_local, A] | None),
    ``e`` the unscaled pair-energy sum."""
    f, scal = cell_pair_sweep(r, nbr_map, _pair_lj(ev, want_energy),
                              ev.rcut2, chunk=box_chunk)
    return f, (scal[0] if want_energy else None)


def eam_pass1_half_plain(r, half_nbr_map, ev: PairEvaluator, *,
                         want_energy: bool = True, box_chunk: int = 256):
    """Plain PyTorch half-shell pass 1 -> dense (f1 [3, B, A], phi_sum
    [B, A] | None, rhobar [B, A]), halo rows pending the fold."""
    f1, scal = cell_pair_sweep_half(r, half_nbr_map, _pair1(ev, want_energy),
                                    ev.rcut2, chunk=box_chunk)
    phi_sum, rhobar = scal if want_energy else (None, scal[0])
    return f1, phi_sum, rhobar


def eam_pass3_half_plain(r, half_nbr_map, ev: PairEvaluator, df_embed, *,
                         box_chunk: int = 256):
    """Plain PyTorch half-shell pass 3 -> dense f3 [3, B, A]."""
    f3, _ = cell_pair_sweep_half(r, half_nbr_map, _pair3(ev), ev.rcut2,
                                 scalar_j=[df_embed], chunk=box_chunk)
    return f3


def lj_pass_half_plain(r, half_nbr_map, ev: PairEvaluator, *,
                       want_energy: bool = True, box_chunk: int = 256):
    """Plain PyTorch half-shell LJ -> dense (f [3, B, A], e [B, A] | None)."""
    f, scal = cell_pair_sweep_half(r, half_nbr_map,
                                   _pair_lj(ev, want_energy), ev.rcut2,
                                   chunk=box_chunk)
    return f, (scal[0] if want_energy else None)


# --------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# --------------------------------------------------------------------------

class _ChebParams(ctypes.Structure):
    _fields_ = [("transform", ctypes.c_int), ("n_terms", ctypes.c_int),
                ("u_lo", ctypes.c_double), ("u_hi", ctypes.c_double),
                ("w_mid", ctypes.c_double), ("w_scale", ctypes.c_double),
                ("c", (ctypes.c_double * MAX_CHEB) * 4)]


class _TableParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("x0", ctypes.c_double),
                ("inv_dx", ctypes.c_double),
                ("phi", ctypes.c_void_p), ("rho", ctypes.c_void_p)]


class _LjParams(ctypes.Structure):
    _fields_ = [("s6", ctypes.c_double), ("eps4", ctypes.c_double),
                ("e_shift", ctypes.c_double)]


_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process


def build():
    """Compile csrc/stencil.cu for sm_90a (first use) and bind it."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "stencil")
        lib.comd_stencil.restype = ctypes.c_int
        lib.comd_stencil.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,                                   # pair..energy
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # r nbr n_nbr
            ctypes.c_void_p, ctypes.c_void_p,               # dfe out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,       # sizes
            ctypes.c_double,
            ctypes.POINTER(_ChebParams), ctypes.POINTER(_TableParams),
            ctypes.POINTER(_LjParams), ctypes.c_void_p]
        lib.comd_cuda_error_string.restype = ctypes.c_char_p
        lib.comd_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def _cheb_params(ev: PairEvaluator, wants) -> _ChebParams:
    fz = ev.cheb
    p = _ChebParams()
    p.transform = _TRANSFORM_ID[fz.transform]
    cs = tables.cheb_wants_coefs(fz, wants)
    p.n_terms = max(len(c) for c in cs)
    if p.n_terms > MAX_CHEB:
        raise ValueError(f"Chebyshev fit of {p.n_terms} terms exceeds the "
                         f"kernel's {MAX_CHEB} coefficient slots")
    p.u_lo, p.u_hi = fz.u_lo, fz.u_hi
    p.w_mid = 0.5 * (fz.w_lo + fz.w_hi)
    p.w_scale = 2.0 / (fz.w_hi - fz.w_lo)
    # slot order phi, dphi, rho, drho; zero padding is exact (|T_k| <= 1)
    slot = {("phi", "val"): 0, ("phi", "der"): 1, ("rho", "val"): 2,
            ("rho", "der"): 3}
    for want, c in zip(wants, cs):
        for k, v in enumerate(c):
            p.c[slot[want]][k] = float(v)
    return p


def _table_params(ev: PairEvaluator) -> _TableParams:
    p = _TableParams()
    p.n, p.x0, p.inv_dx = ev.n, ev.x0, ev.inv_dx
    p.phi, p.rho = ev.phi.data_ptr(), ev.rho.data_ptr()
    return p


def _check(r, nbr_map, ev: PairEvaluator, dfe=None, n_nbr: int = 27):
    if r.dim() != 3 or r.shape[0] != 3:
        raise ValueError(f"r must be [3, B, A], got {tuple(r.shape)}")
    if r.dtype != ev.dtype:
        raise ValueError(f"r dtype {r.dtype} != evaluator dtype {ev.dtype}")
    n_local = nbr_map.shape[0]
    if nbr_map.dim() != 2 or nbr_map.shape[1] != n_nbr or \
            n_local > r.shape[1] or nbr_map.dtype != torch.int32:
        raise ValueError(f"nbr_map must be [n_local <= B, {n_nbr}] int32, "
                         f"got {tuple(nbr_map.shape)} {nbr_map.dtype}")
    tensors = [r, nbr_map] + ([dfe] if dfe is not None else [])
    if ev.kind == "table":
        tensors += [ev.phi, ev.rho]
    if any(t.device != r.device for t in tensors):
        raise ValueError("the stencil operands lie on different devices")
    if dfe is not None and (dfe.shape != r.shape[1:] or dfe.dtype != r.dtype):
        raise ValueError(f"df_embed must be {tuple(r.shape[1:])} {r.dtype}")


def _launch(name: str, pair: str, half: bool, r, nbr_map, ev: PairEvaluator,
            want_energy: bool, dfe=None):
    """Launch K1 (``half`` False) or K2 for one pair function.  Returns
    (force [3, rows, A], [scalars [rows, A] ...]) with rows = n_local for
    K1 and B (dense, halo rows pending the fold) for K2."""
    if r.device.type != "cuda":
        raise ValueError(f"the cell-stencil kernels run CUDA tensors, got "
                         f"{r.device}")
    if r.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {r.dtype}")
    if (pair == "lj") != (ev.kind == "lj"):
        raise ValueError(f"evaluator kind {ev.kind!r} does not fit {pair}")
    B, A = r.shape[1], r.shape[2]
    if not 1 <= A <= MAX_A:
        raise ValueError(f"cell capacity A={A} exceeds the kernels' limit "
                         f"{MAX_A}")
    for t in (r, nbr_map) + ((dfe,) if dfe is not None else ()):
        if not t.is_contiguous():
            raise ValueError("the stencil operands must be contiguous")
    lib = build()
    n_local = nbr_map.shape[0]
    if pair == "eam_pass1":
        n_s = 2 if want_energy else 1
    else:
        n_s = 1 if pair == "lj" and want_energy else 0
    # K1 writes every slot of its rows; K2 adds into a zeroed buffer
    alloc = torch.zeros if half else torch.empty
    out = alloc((3 + n_s, B if half else n_local, A), dtype=r.dtype,
                device=r.device)
    cheb = tab = lj = None
    kind = 0
    if ev.kind == "cheb":
        if pair == "eam_pass1":
            wants = ([("phi", "val")] if want_energy else []) + \
                [("phi", "der"), ("rho", "val")]
        else:
            wants = [("rho", "der")]
        cheb = _cheb_params(ev, wants)
    elif ev.kind == "table":
        tab, kind = _table_params(ev), 1
    else:
        lj = _LjParams(ev.s6, ev.eps4, ev.e_shift)
    dtype_id = 0 if r.dtype == torch.float32 else 1

    def ref(p):
        return ctypes.byref(p) if p is not None else None

    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.comd_stencil(
            _PAIR_ID[pair], int(half), dtype_id, kind, int(want_energy),
            r.data_ptr(), nbr_map.data_ptr(), nbr_map.shape[1],
            None if dfe is None else dfe.data_ptr(), out.data_ptr(),
            n_local, B, A, ev.rcut2, ref(cheb), ref(tab), ref(lj), stream)
    if err != 0:
        msg = lib.comd_cuda_error_string(err).decode()
        raise RuntimeError(f"cell-stencil kernel launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES[name] += 1
    return out[:3], list(out[3:])


# --------------------------------------------------------------------------
# K1: full shell
# --------------------------------------------------------------------------

def eam_pass1(r, nbr_map, ev: PairEvaluator, *, want_energy: bool = True,
              box_chunk: int = 256):
    """EAM pass 1 (gpu_eam_cta_cell.h:34-75): pair energy, density and pair
    force.  Returns (f1 [3, n_local, A], phi_sum [n_local, A] or None when
    ``want_energy`` is False, rhobar [n_local, A]).  CPU tensors run the
    plain version (chunked by ``box_chunk``); CUDA tensors the kernel."""
    _check(r, nbr_map, ev)
    if r.device.type == "cpu":
        return eam_pass1_plain(r, nbr_map, ev, want_energy=want_energy,
                               box_chunk=box_chunk)
    f, scal = _launch("eam_pass1", "eam_pass1", False, r, nbr_map, ev,
                      want_energy)
    return (f,) + (tuple(scal) if want_energy else (None, scal[0]))


def eam_pass3(r, nbr_map, ev: PairEvaluator, df_embed, *,
              box_chunk: int = 256):
    """EAM pass 3: f_i -= (dfe_i + dfe_j) * rho'(r) * rhat, with
    ``df_embed`` the halo-filled [B, A] field (eam.c:374-413).
    Returns f3 [3, n_local, A].  CPU tensors run the plain version; CUDA
    tensors the kernel."""
    _check(r, nbr_map, ev, df_embed)
    if r.device.type == "cpu":
        return eam_pass3_plain(r, nbr_map, ev, df_embed, box_chunk=box_chunk)
    f3, _ = _launch("eam_pass3", "eam_pass3", False, r, nbr_map, ev, False,
                    df_embed)
    return f3


def lj_pass(r, nbr_map, ev: PairEvaluator, *, want_energy: bool = True,
            box_chunk: int = 256):
    """LJ over the 27-cell shell (comd_tpu's lj_force_stencil):
    (f [3, n_local, A], e [n_local, A] | None), ``e`` the unscaled sum of
    r6 (r6 - 1) - e_shift over j.  CPU tensors run the plain version; CUDA
    tensors the kernel."""
    _check(r, nbr_map, ev)
    if r.device.type == "cpu":
        return lj_pass_plain(r, nbr_map, ev, want_energy=want_energy,
                             box_chunk=box_chunk)
    f, scal = _launch("lj", "lj", False, r, nbr_map, ev, want_energy)
    return f, (scal[0] if want_energy else None)


# --------------------------------------------------------------------------
# K2: half shell (dense outputs, halo rows pending ops.sweep.fold_halo_serial)
# --------------------------------------------------------------------------

def eam_pass1_half(r, half_nbr_map, ev: PairEvaluator, *,
                   want_energy: bool = True, box_chunk: int = 256):
    """Half-shell EAM pass 1: dense (f1 [3, B, A], phi_sum [B, A] | None,
    rhobar [B, A]).  CPU tensors run the plain version; CUDA tensors K2."""
    _check(r, half_nbr_map, ev, n_nbr=14)
    if r.device.type == "cpu":
        return eam_pass1_half_plain(r, half_nbr_map, ev,
                                    want_energy=want_energy,
                                    box_chunk=box_chunk)
    f, scal = _launch("half_eam_pass1", "eam_pass1", True, r, half_nbr_map,
                      ev, want_energy)
    return (f,) + (tuple(scal) if want_energy else (None, scal[0]))


def eam_pass3_half(r, half_nbr_map, ev: PairEvaluator, df_embed, *,
                   box_chunk: int = 256):
    """Half-shell EAM pass 3: dense f3 [3, B, A].  CPU tensors run the
    plain version; CUDA tensors K2."""
    _check(r, half_nbr_map, ev, df_embed, n_nbr=14)
    if r.device.type == "cpu":
        return eam_pass3_half_plain(r, half_nbr_map, ev, df_embed,
                                    box_chunk=box_chunk)
    f3, _ = _launch("half_eam_pass3", "eam_pass3", True, r, half_nbr_map, ev,
                    False, df_embed)
    return f3


def lj_pass_half(r, half_nbr_map, ev: PairEvaluator, *,
                 want_energy: bool = True, box_chunk: int = 256):
    """Half-shell LJ (comd_tpu's lj_force_stencil_half before its fold):
    dense (f [3, B, A], e [B, A] | None).  CPU tensors run the plain
    version; CUDA tensors K2."""
    _check(r, half_nbr_map, ev, n_nbr=14)
    if r.device.type == "cpu":
        return lj_pass_half_plain(r, half_nbr_map, ev,
                                  want_energy=want_energy,
                                  box_chunk=box_chunk)
    f, scal = _launch("half_lj", "lj", True, r, half_nbr_map, ev,
                      want_energy)
    return f, (scal[0] if want_energy else None)
