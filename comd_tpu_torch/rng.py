"""Deterministic per-atom random streams, bit-identical to reference CoMD.

The reference (src-mpi/random.c:22-75) drives all stochastic initialization
(thermal velocities, random displacements) from a 61-bit-prime LCG seeded by a
Knuth multiplicative hash of the atom's global id.  Reproducing these streams
*exactly* is what lets our golden-value tests compare total energies against
the reference to near machine precision regardless of device count or atom
ordering: every atom's initial momentum depends only on its gid.

All functions here are vectorized numpy (host side, init only).  The hot path
never touches them.  The native C++ implementation (native/comd_init.cpp,
used preferentially at scale) is canonical: it evaluates log/sqrt through
glibc exactly as the reference binary did; numpy's SIMD log differs from
glibc by 1 ulp for ~0.1% of inputs, so this fallback is 1-ulp-close rather
than bit-identical to it.
"""
from __future__ import annotations

import numpy as np

_LCG_MULT = np.uint64(437799614237992725)
_LCG_MOD = np.uint64(2305843009213693951)  # 2^61 - 1
_CONVERT = 1.0 / 2305843009213693951.0
_KNUTH = np.uint32(2654435761)


def lcg61(seed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One step of the 61-bit prime-modulus LCG (src-mpi/random.c:41-49).

    Matches the C code exactly: the multiply wraps mod 2^64 *before* the
    mod 2^61-1 reduction.  Returns (uniform in [0,1], new seed).
    """
    seed = np.asarray(seed, dtype=np.uint64)
    with np.errstate(over="ignore"):
        seed = seed * _LCG_MULT  # wraps mod 2^64, same as C uint64_t
    seed = seed % _LCG_MOD
    return seed.astype(np.float64) * _CONVERT, seed


def mk_seed(gid: np.ndarray, call_site: int) -> np.ndarray:
    """Per-entity 64-bit seed from two Knuth hashes (src-mpi/random.c:65-75)."""
    gid = np.asarray(gid, dtype=np.uint32)
    with np.errstate(over="ignore"):
        s1 = gid * _KNUTH
        s2 = (gid + np.uint32(call_site)) * _KNUTH
    seed = np.uint64(0x100000000) * s1.astype(np.uint64) + s2.astype(np.uint64)
    # run off 10 values to wash out early low-bit correlations
    for _ in range(10):
        _, seed = lcg61(seed)
    return seed


def gasdev(seed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Box-Muller normal sample per element (src-mpi/random.c:21-32).

    Vectorized rejection sampling: each element keeps drawing pairs until its
    own (v1, v2) is accepted, exactly tracking the per-element seed, so the
    accepted sample sequence matches the scalar C loop bit for bit.
    """
    seed = np.asarray(seed, dtype=np.uint64).copy()
    out = np.zeros(seed.shape, dtype=np.float64)
    active = np.ones(seed.shape, dtype=bool)
    # acceptance probability is pi/4 per trial; a handful of rounds suffice,
    # but loop until done to be exact.
    while active.any():
        u1, s1 = lcg61(seed[active])
        u2, s2 = lcg61(s1)
        seed[active] = s2
        v1 = 2.0 * u1 - 1.0
        v2 = 2.0 * u2 - 1.0
        rsq = v1 * v1 + v2 * v2
        ok = (rsq < 1.0) & (rsq != 0.0)
        val = np.zeros_like(rsq)
        np.divide(-2.0 * np.log(rsq, where=ok), rsq, out=val, where=ok)
        idx = np.flatnonzero(active)
        out[idx[ok]] = (v2 * np.sqrt(val))[ok]
        active[idx] = ~ok
    return out, seed


def gasdev_n(gid: np.ndarray, call_site: int, n: int) -> np.ndarray:
    """Draw ``n`` sequential gasdev samples from each atom's stream.

    Mirrors setTemperature's three back-to-back gasdev() calls on one seed
    (src-mpi/initAtoms.c:172-175).  Returns shape ``(n,) + gid.shape``.
    """
    seed = mk_seed(gid, call_site)
    outs = []
    for _ in range(n):
        val, seed = gasdev(seed)
        outs.append(val)
    return np.stack(outs)


def uniform_n(gid: np.ndarray, call_site: int, n: int) -> np.ndarray:
    """Draw ``n`` sequential uniforms in [0,1] from each atom's stream.

    Mirrors randomDisplacements' three lcg61() calls (src-mpi/initAtoms.c:210-213).
    """
    seed = mk_seed(gid, call_site)
    outs = []
    for _ in range(n):
        val, seed = lcg61(seed)
        outs.append(val)
    return np.stack(outs)
