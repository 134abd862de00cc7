"""EAM pass 1 and pass 3 on the hand-written CUDA cell-stencil kernel.

Replaces comd_tpu/ops/pallas/stencil.py::_kernel (driven by stencil_sweep,
with the eam_pass1_stencil / eam_pass3_stencil pair functions): the
full-shell 27-cell pair sweep that sums, per i-slot, fc * (dx, dy, dz) and
the per-pair scalars.  The kernel source is csrc/stencil.cu.

What bounds it on the card: pair arithmetic.  At the 63^3 headline
(74,088 local cells, A = 16) one pass evaluates 74,088 * 27 * 16 * 16 =
512 M candidate pairs, ~12% of them inside the cutoff; the cell data it
reads is ~22 MB per pass, so it is compute-bound.  Its design: one thread
per i-slot, several cells per block (>= 128 threads), the block stages one
neighbor cell per cell at a time in shared memory (positions, plus dfEmbed
for pass 3) and every i-thread of a cell walks the staged j-slots; the
table or Chebyshev evaluation runs only for pairs inside the cutoff.  The
kernel reads the state's own [3, B, A] layout and ``geom.nbr_map``
directly: comd_tpu's transposed cells-on-lanes window and its
back-gather were TPU lane artefacts and are gone.

Beside the kernel sits its plain PyTorch version (ops/sweep.cell_pair_sweep
with the same pair functions).  ``eam_pass1`` / ``eam_pass3`` take it only
for tensors on the CPU; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper.

The 27-neighbor order differs from the Pallas kernel's dense-offset order,
so f32 results agree with comd_tpu up to reassociation; f64 agrees to
rounding.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from ...potentials import tables
from ...potentials.tables import ChebFused
from ..sweep import cell_pair_sweep

#: largest cell capacity the kernel stages (threads per block = cpb * A)
MAX_A = 64
#: coefficient slots per Chebyshev output in the kernel's parameter struct
MAX_CHEB = 40

#: kernel launches per wrapper, bumped right after each successful launch
LAUNCHES = {"eam_pass1": 0, "eam_pass3": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "stencil.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
_TRANSFORM_ID = {"u": 0, "inv_u": 1, "log_u": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class PairEvaluator:
    """The pair-table representation both pair passes evaluate.

    ``kind`` "cheb": the shared-basis Chebyshev fit (tables.ChebFused).
    ``kind`` "table": the reference quadratic interpolation of the phi and
    rho tables, held as [n+4] device arrays (InterpTable.device_table).
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


# --------------------------------------------------------------------------
# plain PyTorch pair functions (the kernel's per-pair arithmetic)
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


# --------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
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


_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the cell-stencil kernel is built "
                           "from csrc/stencil.cu at first use on the card")
    return found


def build():
    """Compile csrc/stencil.cu for sm_90a (first use) and bind it."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as fh:
            digest = hashlib.sha1(fh.read()).hexdigest()[:12]
        path = os.path.join(BUILD_DIR, f"libcomd_stencil_{digest}.so")
        t0 = time.perf_counter()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, SOURCE]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed to build the cell-stencil "
                                   f"kernel:\n{res.stderr[-4000:]}")
            with open(os.path.join(BUILD_DIR, "stencil_ptxas.log"), "w") as fh:
                fh.write(res.stderr)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.comd_stencil_eam.restype = ctypes.c_int
        lib.comd_stencil_eam.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # pass..
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # r nbr dfe
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # f phi rho
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # sizes
            ctypes.c_double,
            ctypes.POINTER(_ChebParams), ctypes.POINTER(_TableParams),
            ctypes.c_void_p]
        lib.comd_cuda_error_string.restype = ctypes.c_char_p
        lib.comd_cuda_error_string.argtypes = [ctypes.c_int]
        BUILD_SECONDS = time.perf_counter() - t0
        _lib = lib
        return lib


def cells_per_block(A: int) -> int:
    """Cells a block covers: enough for >= 128 threads (8 cells at A=16)."""
    return max(1, -(-128 // A))


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


def _check(r, nbr_map, ev: PairEvaluator, dfe=None):
    if r.dim() != 3 or r.shape[0] != 3:
        raise ValueError(f"r must be [3, B, A], got {tuple(r.shape)}")
    if r.dtype != ev.dtype:
        raise ValueError(f"r dtype {r.dtype} != evaluator dtype {ev.dtype}")
    n_local = nbr_map.shape[0]
    if nbr_map.dim() != 2 or nbr_map.shape[1] != 27 or \
            n_local > r.shape[1] or nbr_map.dtype != torch.int32:
        raise ValueError("nbr_map must be [n_local <= B, 27] int32, got "
                         f"{tuple(nbr_map.shape)} {nbr_map.dtype}")
    tensors = [r, nbr_map] + ([dfe] if dfe is not None else [])
    if ev.kind == "table":
        tensors += [ev.phi, ev.rho]
    if any(t.device != r.device for t in tensors):
        raise ValueError("the stencil operands lie on different devices")
    if dfe is not None and (dfe.shape != r.shape[1:] or dfe.dtype != r.dtype):
        raise ValueError(f"df_embed must be {tuple(r.shape[1:])} {r.dtype}")


def _launch(name: str, pass_id: int, r, nbr_map, ev: PairEvaluator,
            want_energy: bool, dfe=None):
    if r.device.type != "cuda":
        raise ValueError(f"the cell-stencil kernel runs CUDA tensors, got "
                         f"{r.device}")
    if r.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {r.dtype}")
    B, A = r.shape[1], r.shape[2]
    if not 1 <= A <= MAX_A:
        raise ValueError(f"cell capacity A={A} exceeds the kernel's staging "
                         f"limit {MAX_A}")
    for t in (r, nbr_map) + ((dfe,) if dfe is not None else ()):
        if not t.is_contiguous():
            raise ValueError("the stencil operands must be contiguous")
    lib = build()
    n_local = nbr_map.shape[0]
    dev = r.device
    f = torch.empty((3, n_local, A), dtype=r.dtype, device=dev)
    phi = (torch.empty((n_local, A), dtype=r.dtype, device=dev)
           if pass_id == 1 and want_energy else None)
    rho = (torch.empty((n_local, A), dtype=r.dtype, device=dev)
           if pass_id == 1 else None)
    if ev.kind == "cheb":
        if pass_id == 1:
            wants = ([("phi", "val")] if want_energy else []) + \
                [("phi", "der"), ("rho", "val")]
        else:
            wants = [("rho", "der")]
        cheb, tab, kind = _cheb_params(ev, wants), None, 0
    else:
        cheb, tab, kind = None, _table_params(ev), 1
    dtype_id = 0 if r.dtype == torch.float32 else 1

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.comd_stencil_eam(
            pass_id, dtype_id, kind, int(want_energy),
            ptr(r), ptr(nbr_map), ptr(dfe), ptr(f), ptr(phi), ptr(rho),
            n_local, B, A, cells_per_block(A), ev.rcut2,
            ctypes.byref(cheb) if cheb is not None else None,
            ctypes.byref(tab) if tab is not None else None, stream)
    if err != 0:
        msg = lib.comd_cuda_error_string(err).decode()
        raise RuntimeError(f"cell-stencil kernel launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES[name] += 1
    return f, phi, rho


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
    return _launch("eam_pass1", 1, r, nbr_map, ev, want_energy)


def eam_pass3(r, nbr_map, ev: PairEvaluator, df_embed, *,
              box_chunk: int = 256):
    """EAM pass 3: f_i -= (dfe_i + dfe_j) * rho'(r) * rhat, with
    ``df_embed`` the halo-filled [B, A] field (eam.c:374-413).
    Returns f3 [3, n_local, A].  CPU tensors run the plain version; CUDA
    tensors the kernel."""
    _check(r, nbr_map, ev, df_embed)
    if r.device.type == "cpu":
        return eam_pass3_plain(r, nbr_map, ev, df_embed, box_chunk=box_chunk)
    f3, _, _ = _launch("eam_pass3", 3, r, nbr_map, ev, False, df_embed)
    return f3
