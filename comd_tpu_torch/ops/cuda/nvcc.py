"""Build a csrc/*.cu source into a shared library with nvcc, at first use.

Each source is compiled on its own for sm_90a into the git-ignored
``comd_tpu_torch/_build/``, under a name that carries the hash of its
content and of the local headers it includes (``#include "x.cuh"``), and
loaded with ctypes.  ptxas's report (registers, spills) is
kept beside it as ``<stem>_ptxas.log``.  Two sources build in parallel when
two threads ask for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "comd_tpu_torch/csrc at first use on the card")
    return found


def source_digest(source: str) -> str:
    """Hash of ``source`` and of the local headers it includes, so that a
    changed header rebuilds every library built from it."""
    h = hashlib.sha1()
    with open(source, "rb") as fh:
        text = fh.read()
    h.update(text)
    for name in re.findall(rb'^#include "([^"]+)"', text, re.M):
        with open(os.path.join(os.path.dirname(source),
                               name.decode()), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def build_library(source: str, stem: str, extra_flags=()):
    """Compile ``source`` (a path) for sm_90a unless a library of the same
    content exists, and load it.  Returns (ctypes.CDLL, seconds spent)."""
    digest = source_digest(source)
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *extra_flags, "-o", tmp, source]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source}:\n"
                               f"{res.stderr[-4000:]}")
        with open(os.path.join(BUILD_DIR, f"{stem}_ptxas.log"), "w") as fh:
            fh.write(res.stderr)
        os.replace(tmp, path)
    return ctypes.CDLL(path), time.perf_counter() - t0
