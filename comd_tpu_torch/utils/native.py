"""ctypes loader for the native scene-generation kernels (native/comd_init.cpp).

Compiles the shared source with g++ on first use into the port's build
directory (``comd_tpu_torch/_build/``, git-ignored) and falls back to the
vectorized-numpy implementations in comd_tpu_torch.rng when no compiler is
available -- the same semantics as comd_tpu.utils.native, so both packages
generate bit-identical lattices and momenta from the same source.  The
native path is canonical (glibc log/sqrt, matching the reference binary
bit-for-bit); the numpy fallback is bit-identical on the integer streams and
1-ulp-close on gasdev.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def _src_path() -> str:
    return os.path.join(os.path.dirname(PKG_DIR), "native", "comd_init.cpp")


def _lib_path() -> str:
    return os.path.join(BUILD_DIR, "_comd_native.so")


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src, lib = _src_path(), _lib_path()
        if not os.path.exists(src):
            return None
        try:
            if (not os.path.exists(lib)
                    or os.path.getmtime(lib) < os.path.getmtime(src)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{lib}.{os.getpid()}.tmp"
                # -ffp-contract=off: no FMA contraction, so results are
                # bit-identical to the numpy reference path
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-ffp-contract=off",
                     "-fPIC", "-shared", "-fopenmp", src, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, lib)
            handle = ctypes.CDLL(lib)
        except (OSError, subprocess.CalledProcessError):
            return None
        handle.comd_gasdev3.restype = None
        handle.comd_gasdev3.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_double)]
        handle.comd_uniform3.restype = None
        handle.comd_uniform3.argtypes = handle.comd_gasdev3.argtypes
        handle.comd_fcc_lattice.restype = ctypes.c_int64
        handle.comd_fcc_lattice.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
        _lib = handle
        return _lib


def available() -> bool:
    return _load() is not None


def _as_i64_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_f64_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def gasdev3(gid: np.ndarray, call_site: int) -> np.ndarray | None:
    """[n, 3] gasdev draws; None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    gid = np.ascontiguousarray(gid, dtype=np.int64)
    out = np.empty((len(gid), 3), dtype=np.float64)
    lib.comd_gasdev3(_as_i64_ptr(gid), len(gid), call_site, _as_f64_ptr(out))
    return out


def uniform3(gid: np.ndarray, call_site: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    gid = np.ascontiguousarray(gid, dtype=np.int64)
    out = np.empty((len(gid), 3), dtype=np.float64)
    lib.comd_uniform3(_as_i64_ptr(gid), len(gid), call_site, _as_f64_ptr(out))
    return out


def fcc_lattice(nx: int, ny: int, nz: int, lat: float,
                local_min: np.ndarray, local_max: np.ndarray):
    """(r [n,3], gid [n]) or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(local_min, dtype=np.float64)
    hi = np.ascontiguousarray(local_max, dtype=np.float64)
    n = lib.comd_fcc_lattice(nx, ny, nz, lat, _as_f64_ptr(lo),
                             _as_f64_ptr(hi), None, None)
    r = np.empty((n, 3), dtype=np.float64)
    gid = np.empty((n,), dtype=np.int64)
    n2 = lib.comd_fcc_lattice(nx, ny, nz, lat, _as_f64_ptr(lo),
                              _as_f64_ptr(hi), _as_f64_ptr(r),
                              _as_i64_ptr(gid))
    if n2 != n:
        raise RuntimeError(f"native lattice count changed: {n} then {n2}")
    return r, gid
