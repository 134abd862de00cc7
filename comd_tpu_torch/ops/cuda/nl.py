"""The Verlet-list build and sweep on hand-written CUDA kernels.

Three kernels, one source (csrc/nl.cu), one build.  comd_tpu computes them
in XLA (there is no Pallas kernel to port); on the card they are kernels
because as torch ops they would cost ~10x the cell path (a [R, K] sweep
moves ~1.7 GB an elementwise op, ~30 of them a pass):

- NR ``nl_rows`` replaces comd_tpu/ops/neighborlist.py::build_atom_list
  and ::build_atom_list_split (~15 torch ops a shard here before): over
  tiles of 128 local cells, one launch sums min(n_atoms, A) a tile, a
  second scans each tile after the sums of the tiles before it, writes
  each cell's ``row_start`` and its valid rows (a warp segment a cell at
  A <= 32) and zeros the rows past the counts; two launches a build, the
  same bits as ``nl_rows_plain``, comd_tpu's rows.
- NL1 ``nl_build`` replaces comd_tpu/ops/neighborlist.py::build: one block
  a local cell stages the occupied slots of its 27 boxes once in shared
  memory, then a warp walks two rows of the cell at a time, tests
  r2 <= (rcut + skin)^2 and keeps the first K hits in candidate order with
  ballot/popc (the reference's gpu_kernels.cu:1494-2029); further blocks
  pad the invalid rows.  It reads NR's row_start.  The lists equal the
  plain version's bit for bit.
- NL2 ``nl_sweep`` replaces ::pair_sweep_nl: a small kernel packs the
  positions (and dfEmbed) into 16-byte records in a scratch tensor, then
  one warp walks four rows together, each list read up to its first
  padding entry; the entries inside the cutoff are queued per row in
  shared memory and drained eight lanes a row through K1's own pair
  function (csrc/pair.cuh), summed in a fixed order (the reference's
  warp_atom_nl, gpu_eam_thread_atom.h:144-266).  Wrappers ``eam_pass1``,
  ``eam_pass3``, ``lj_pass``; results per row; one launch counted a call.

What bounds them on the card: bytes, the [R, K] list written once (NL1)
and the real rows' list entries read once (NL2); csrc/nl.cu's header has
the numbers.  Beside each kernel sits its plain PyTorch version
(``*_plain``, ops/neighborlist.py's torch code); the wrappers take it only
for tensors on the CPU, a CUDA tensor launches the kernel or raises.
``LAUNCHES`` (ops/cuda/__init__.py) counts the launches under "nl_rows"
(one a build, its two kernels), "nl_build" and "nl_sweep", NL2's -P
spline variant apart under "nl_sweep_spline".
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from ...potentials.tables import as_dtype
from .. import neighborlist as nlmod
from ..neighborlist import NeighborList
from . import LAUNCHES, stencil
from .nvcc import CSRC, build_library
from .stencil import PairEvaluator

SOURCE = os.path.join(CSRC, "nl.cu")
_PAIR_ID = {"eam_pass1": 0, "eam_pass3": 1, "lj": 2}

_lib = None
_lib_lock = threading.Lock()
BUILD_SECONDS = None   # wall time of the nvcc build in this process


def build():
    """Compile csrc/nl.cu for sm_90a (first use) and bind it."""
    global _lib, BUILD_SECONDS
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS = build_library(SOURCE, "nl")
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.comd_nl_build.restype = i
        lib.comd_nl_build.argtypes = [i, p, i, p, p, p, p, p, i, i, i, i, d,
                                      p, p, p, p]
        lib.comd_nl_sweep.restype = i
        lib.comd_nl_sweep.argtypes = [
            i, i, i, i, p, i, p, p, p, p, p, i, i, d,
            ctypes.POINTER(stencil._ChebParams),
            ctypes.POINTER(stencil._TableParams),
            ctypes.POINTER(stencil._LjParams),
            ctypes.POINTER(stencil._SplineParams), p, p]
        lib.comd_nl_rows.restype = i
        lib.comd_nl_rows.argtypes = [p, p, i, i, i, i, p, p, p, p, i, p]
        lib.comd_nl_rows_tiles.restype = i
        lib.comd_nl_rows_tiles.argtypes = [i]
        lib.comd_nl_error_string.restype = ctypes.c_char_p
        lib.comd_nl_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def _raise(err: int, what: str):
    msg = build().comd_nl_error_string(err).decode()
    raise RuntimeError(f"{what} kernel launch failed: {msg} "
                       f"(cudaError {err})")


def _check_cuda(r, tensors):
    if r.device.type != "cuda":
        raise ValueError(f"the neighbor-list kernels run CUDA tensors, got "
                         f"{r.device}")
    if r.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {r.dtype}")
    if r.dim() != 3 or r.shape[0] != 3:
        raise ValueError(f"r must be [3, B, A], got {tuple(r.shape)}")
    for t in tensors:
        if t.device != r.device:
            raise ValueError("the neighbor-list operands lie on different "
                             "devices")
        if not t.is_contiguous():
            raise ValueError("the neighbor-list operands must be contiguous")


def _check_rows(a_list, a_valid, n_rows: int):
    if a_list.shape != (n_rows,) or a_list.dtype != torch.int32:
        raise ValueError(f"a_list must be [{n_rows}] int32")
    if a_valid.shape != (n_rows,) or a_valid.dtype != torch.bool:
        raise ValueError(f"a_valid must be [{n_rows}] bool")


# --------------------------------------------------------------------------
# NR: the build's rows
# --------------------------------------------------------------------------

def nl_rows(geom, n_atoms, A: int, n_rows: int, row_split=None, out=None):
    """The rows of a build: (a_list [R] int32, a_valid [R] bool, row_start
    [n_local] int32), as ``neighborlist.nl_rows_plain`` defines them (R =
    ``n_rows``, or Ri + Rb with ``row_split``, whose boundary mask may be
    a bool tensor on n_atoms' device).  ``out``, when given, is such a
    triple (contiguous, on n_atoms' device), written in place and
    returned.  CPU tensors run the plain version; CUDA tensors NR, two
    launches, one count."""
    n_local = geom.n_local
    if row_split is not None:
        n_rows = row_split[1] + row_split[2]
    if n_atoms.dim() != 1 or n_atoms.shape[0] < n_local or \
            n_atoms.dtype != torch.int32 or not n_atoms.is_contiguous():
        raise ValueError(f"nl_rows: n_atoms must be a contiguous int32 "
                         f"[>= {n_local}]")
    dev = n_atoms.device
    if out is not None:
        shapes = ((n_rows,), (n_rows,), (n_local,))
        dtypes = (torch.int32, torch.bool, torch.int32)
        if len(out) != 3 or any(
                t.shape != sh or t.dtype != dt or t.device != dev or
                not t.is_contiguous()
                for t, sh, dt in zip(out, shapes, dtypes)):
            raise ValueError(f"nl_rows: out must be contiguous [{n_rows}] "
                             f"int32, [{n_rows}] bool and [{n_local}] int32 "
                             f"on {dev}")
    if dev.type == "cpu":
        got = nlmod.nl_rows_plain(geom, n_atoms, A, n_rows, row_split)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    if n_local * A >= 2 ** 31:
        raise ValueError(f"nl_rows: {n_local} cells of {A} slots do not fit "
                         f"32-bit slot ids")
    is_b, ri = None, n_rows
    if row_split is not None:
        is_b = torch.as_tensor(row_split[0], device=dev)
        ri = row_split[1]
        if is_b.shape != (n_local,) or is_b.dtype != torch.bool or \
                not is_b.is_contiguous():
            raise ValueError(f"nl_rows: the boundary mask must be a "
                             f"contiguous [{n_local}] bool")
    if out is None:
        out = (torch.empty(n_rows, dtype=torch.int32, device=dev),
               torch.empty(n_rows, dtype=torch.bool, device=dev),
               torch.empty(n_local, dtype=torch.int32, device=dev))
    # the tile sums (int2 a tile): written whole by the first launch
    tiles = build().comd_nl_rows_tiles(n_local)
    tile_sums = torch.empty(2 * tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build().comd_nl_rows(
            n_atoms.data_ptr(), None if is_b is None else is_b.data_ptr(),
            n_local, A, n_rows, ri, out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), tile_sums.data_ptr(), tiles, stream)
    if err != 0:
        _raise(err, "nl_rows")
    LAUNCHES["nl_rows"] += 1
    return tuple(out)


# --------------------------------------------------------------------------
# NL1: the list build
# --------------------------------------------------------------------------

def nl_build_plain(r, a_list, a_valid, nbr_map, n_atoms, *, k: int,
                   rcut2: float):
    """Plain PyTorch NL1 -> (nl [R, k] int32, count [R] int32, overflow
    0-dim bool)."""
    nl, count = nlmod.candidate_lists(r, a_list, a_valid, nbr_map, k=k,
                                      rcut2=rcut2)
    return nl, count, ((count > k) & a_valid).any()


def nl_build(r, a_list, a_valid, nbr_map, n_atoms, *, row_start, k: int,
             rcut2: float, out=None):
    """The first ``k`` j of each row within sqrt(rcut2) (rcut + skin),
    in candidate order, self-padded: (nl [R, k] int32, count [R] int32,
    overflow 0-dim bool: a valid row has more than ``k``).  ``nbr_map``
    [n_local, 27] int32, ``n_atoms`` [B] int32; the rows and their
    ``row_start`` [n_local] int32 as ``nl_rows`` makes them (a cell's
    valid rows contiguous, in slot order).  ``out`` (contiguous [R, k]
    int32 on r's device), when given, receives the list in place and is
    returned as ``nl``.  CPU tensors run the plain version; CUDA tensors
    NL1."""
    n_rows = a_list.shape[0]
    _check_rows(a_list, a_valid, n_rows)
    if nbr_map.dim() != 2 or nbr_map.shape[1] != 27 or \
            nbr_map.dtype != torch.int32 or n_atoms.dtype != torch.int32:
        raise ValueError("nbr_map must be [n_local, 27] int32 and n_atoms "
                         "int32")
    n_local = nbr_map.shape[0]
    if row_start.shape != (n_local,) or row_start.dtype != torch.int32 or \
            row_start.device != r.device or not row_start.is_contiguous():
        raise ValueError(f"row_start must be a contiguous [{n_local}] int32 "
                         f"on {r.device}")
    if out is not None and (out.shape != (n_rows, k) or
                            out.dtype != torch.int32 or
                            not out.is_contiguous() or
                            out.device != r.device):
        raise ValueError(f"out must be a contiguous [{n_rows}, {k}] int32 "
                         f"tensor on {r.device}")
    if r.device.type == "cpu":
        nl, count, overflow = nl_build_plain(r, a_list, a_valid, nbr_map,
                                             n_atoms, k=k, rcut2=rcut2)
        if out is not None:
            nl = out.copy_(nl)
        return nl, count, overflow
    _check_cuda(r, (r, a_list, a_valid, nbr_map, n_atoms))
    B, A = r.shape[1], r.shape[2]
    dev = r.device
    nl = out if out is not None else torch.empty((n_rows, k),
                                                 dtype=torch.int32,
                                                 device=dev)
    count = torch.empty(n_rows, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build().comd_nl_build(
            0 if r.dtype == torch.float32 else 1, r.data_ptr(), B * A,
            a_list.data_ptr(), a_valid.data_ptr(), nbr_map.data_ptr(),
            n_atoms.data_ptr(), row_start.data_ptr(), n_local, n_rows, A,
            k, as_dtype(rcut2, r.dtype),
            nl.data_ptr(), count.data_ptr(), overflow.data_ptr(), stream)
    if err != 0:
        _raise(err, "nl_build")
    LAUNCHES["nl_build"] += 1
    return nl, count, overflow != 0


def build_list(geom, nbr_map, r, n_atoms, *, k: int, rcut2: float,
               n_rows: int, row_split=None, into: NeighborList = None):
    """Build the neighbor list of one shard: the rows (NR; interior rows
    first with ``row_split``), then NL1.  Returns (NeighborList,
    overflow); with ``into`` the list is written into that list's tensors
    (NR into its rows, NL1 into its ``nl``) and ``into`` returned.
    ops/neighborlist.build is its plain version."""
    A = r.shape[2]
    if into is None:
        a_list, a_valid, row_start = nl_rows(geom, n_atoms, A, n_rows,
                                             row_split)
        nl, _count, overflow = nl_build(r, a_list, a_valid, nbr_map,
                                        n_atoms, row_start=row_start, k=k,
                                        rcut2=rcut2)
        return NeighborList(a_list=a_list, a_valid=a_valid, nl=nl,
                            last_r=r, row_start=row_start), overflow
    nl_rows(geom, n_atoms, A, n_rows, row_split,
            out=(into.a_list, into.a_valid, into.row_start))
    _nl, _count, overflow = nl_build(r, into.a_list, into.a_valid, nbr_map,
                                     n_atoms, row_start=into.row_start, k=k,
                                     rcut2=rcut2, out=into.nl)
    into.last_r.copy_(r)
    return into, overflow


# --------------------------------------------------------------------------
# NL2: the list sweep
# --------------------------------------------------------------------------

def eam_pass1_plain(nlist: NeighborList, r, ev: PairEvaluator, *,
                    want_energy: bool = True):
    """Plain PyTorch NL2, EAM pass 1 -> (f1 [3, R], phi [R] | None,
    rho [R])."""
    f, scal = nlmod.pair_sweep_nl(nlist, r, stencil._pair1(ev, want_energy),
                                  ev.rcut2)
    return (f,) + (tuple(scal) if want_energy else (None, scal[0]))


def eam_pass3_plain(nlist: NeighborList, r, ev: PairEvaluator, dfe):
    """Plain PyTorch NL2, EAM pass 3 -> f3 [3, R]."""
    f, _ = nlmod.pair_sweep_nl(nlist, r, stencil._pair3(ev), ev.rcut2,
                               scalar_j=[dfe])
    return f


def lj_pass_plain(nlist: NeighborList, r, ev: PairEvaluator, *,
                  want_energy: bool = True):
    """Plain PyTorch NL2, LJ -> (f [3, R], e [R] | None), ``e`` the unscaled
    pair-energy sum."""
    f, scal = nlmod.pair_sweep_nl(nlist, r,
                                  stencil._pair_lj(ev, want_energy), ev.rcut2)
    return f, (scal[0] if want_energy else None)


def _sweep(pair: str, nlist: NeighborList, r, ev: PairEvaluator,
           want_energy: bool, dfe=None):
    """One NL2 launch: [3 + ns, R] per-row outputs."""
    n_rows, k = nlist.nl.shape
    _check_rows(nlist.a_list, nlist.a_valid, n_rows)
    if nlist.nl.dtype != torch.int32:
        raise ValueError("the list must be int32")
    if r.dtype != ev.dtype:
        raise ValueError(f"r dtype {r.dtype} != evaluator dtype {ev.dtype}")
    if (pair == "lj") != (ev.kind == "lj"):
        # the list paths run analytic LJ only: comd_tpu's ignore -I
        raise ValueError(f"evaluator kind {ev.kind!r} does not fit {pair}")
    tensors = [r, nlist.a_list, nlist.a_valid, nlist.nl]
    if dfe is not None:
        if dfe.shape != r.shape[1:] or dfe.dtype != r.dtype:
            raise ValueError(f"df_embed must be {tuple(r.shape[1:])} "
                             f"{r.dtype}")
        tensors.append(dfe)
    _check_cuda(r, tensors)
    stencil.check_tables(ev, r.device)
    B, A = r.shape[1], r.shape[2]
    p = stencil.pair_params(ev, pair, want_energy)
    n_s = stencil._n_scalars(pair, want_energy)
    out = torch.empty((3 + n_s, n_rows), dtype=r.dtype, device=r.device)
    rec = torch.empty((B * A, 4), dtype=r.dtype, device=r.device)   # scratch

    def ref(key):
        return ctypes.byref(p[key]) if p[key] is not None else None

    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = build().comd_nl_sweep(
            _PAIR_ID[pair], 0 if r.dtype == torch.float32 else 1, p["eval"],
            int(want_energy), r.data_ptr(), B * A,
            None if dfe is None else dfe.data_ptr(), rec.data_ptr(),
            nlist.a_list.data_ptr(), nlist.a_valid.data_ptr(),
            nlist.nl.data_ptr(), n_rows, k, ev.rcut2, ref("cheb"),
            ref("tab"), ref("lj"), ref("spline"), out.data_ptr(), stream)
    if err != 0:
        _raise(err, "nl_sweep")
    LAUNCHES["nl_sweep_spline" if ev.kind == "spline" else "nl_sweep"] += 1
    return out


def eam_pass1(nlist: NeighborList, r, ev: PairEvaluator, *,
              want_energy: bool = True):
    """EAM pass 1 over the list (eamForceCpuNL, eam.c:266-419): per row
    (f1 [3, R], phi_sum [R] or None without ``want_energy``, rhobar [R]),
    zero on invalid rows.  CPU tensors run the plain version; CUDA tensors
    NL2."""
    if r.device.type == "cpu":
        return eam_pass1_plain(nlist, r, ev, want_energy=want_energy)
    out = _sweep("eam_pass1", nlist, r, ev, want_energy)
    return (out[:3],) + ((out[3], out[4]) if want_energy else (None, out[3]))


def eam_pass3(nlist: NeighborList, r, ev: PairEvaluator, dfe):
    """EAM pass 3 over the list, ``dfe`` the halo-filled [B, A] dfEmbed:
    per row f3 [3, R].  CPU tensors run the plain version; CUDA tensors
    NL2."""
    if r.device.type == "cpu":
        return eam_pass3_plain(nlist, r, ev, dfe)
    return _sweep("eam_pass3", nlist, r, ev, False, dfe)


def lj_pass(nlist: NeighborList, r, ev: PairEvaluator, *,
            want_energy: bool = True):
    """LJ over the list (ljForceCpuNL, ljForce.c:146-265): per row (f [3, R],
    e [R] | None), ``e`` the unscaled sum of r6 (r6 - 1) - e_shift.  CPU
    tensors run the plain version; CUDA tensors NL2.  Analytic LJ only:
    comd_tpu's list paths ignore -I."""
    if ev.kind != "lj":
        raise ValueError(f"the list sweep runs analytic LJ, not "
                         f"{ev.kind!r}")
    if r.device.type == "cpu":
        return lj_pass_plain(nlist, r, ev, want_energy=want_energy)
    out = _sweep("lj", nlist, r, ev, want_energy)
    return out[:3], (out[3] if want_energy else None)
