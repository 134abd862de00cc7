"""Initial condition generation: FCC lattice, Boltzmann velocities,
random displacements.  Host-side numpy, bit-compatible with the reference
(src-mpi/initAtoms.c:81-216) including gid assignment and the per-atom
deterministic RNG streams, so initial states are identical across any device
decomposition.
"""
from __future__ import annotations

import numpy as np

from .constants import KB_EV
from . import rng
from .utils import native


def create_fcc_lattice(nx: int, ny: int, nz: int, lat: float,
                       local_min, local_max):
    """FCC positions+gids inside [local_min, local_max)
    (createFccLattice, initAtoms.c:81-124).

    Returns (r [n,3] f64, gid [n] int64).
    """
    local_min = np.asarray(local_min, dtype=np.float64)
    local_max = np.asarray(local_max, dtype=np.float64)
    out = native.fcc_lattice(nx, ny, nz, lat, local_min, local_max)
    if out is not None:
        return out  # C loop order is already gid-ascending
    basis = np.array([[0.25, 0.25, 0.25],
                      [0.25, 0.75, 0.75],
                      [0.75, 0.25, 0.75],
                      [0.75, 0.75, 0.25]], dtype=np.float64)

    begin = np.floor(local_min / lat).astype(np.int64)
    end = np.ceil(local_max / lat).astype(np.int64)

    ix = np.arange(begin[0], end[0])
    iy = np.arange(begin[1], end[1])
    iz = np.arange(begin[2], end[2])
    IX, IY, IZ, IB = np.meshgrid(ix, iy, iz, np.arange(4), indexing="ij")
    cell = np.stack([IX, IY, IZ], axis=-1).reshape(-1, 3).astype(np.float64)
    ib = IB.reshape(-1)
    r = (cell + basis[ib]) * lat
    keep = np.all((r >= local_min) & (r < local_max), axis=1)
    r = r[keep]
    ib = ib[keep]
    cell = cell[keep].astype(np.int64)
    # gid = ib + 4*(iz + nz*(iy + ny*ix))   (initAtoms.c:114)
    gid = ib + 4 * (cell[:, 2] + nz * (cell[:, 1] + ny * cell[:, 0]))
    order = np.argsort(gid, kind="stable")
    return r[order], gid[order]


def _raw_momenta(gid: np.ndarray, mass: float, temperature: float):
    sigma = np.sqrt(KB_EV * temperature / mass)
    g = native.gasdev3(gid, 123)           # [n, 3] in (px, py, pz) call order
    if g is None:
        g = rng.gasdev_n(gid, 123, 3).T
    return (mass * sigma) * g              # [n, 3]


def temperature_params(mass: float, temperature: float, n_global: int):
    """Global (vcm, scale) of setTemperature (initAtoms.c:128-195), computed
    from the full deterministic gid range 0..n_global-1 WITHOUT needing the
    atoms themselves -- the per-atom RNG streams are gid-seeded, so any
    process can reproduce the global momentum sums bit-for-bit.  This is
    what makes per-shard initialization possible on multi-host slices: no
    rank ever materializes global positions, only this O(n) momentum pass.
    """
    if temperature == 0.0:
        return np.zeros(3), 1.0
    gid = np.arange(n_global, dtype=np.int64)
    p = _raw_momenta(gid, mass, temperature)
    vcm = p.sum(axis=0) / (mass * n_global)
    p -= mass * vcm
    e_kinetic = 0.5 * np.sum(p * p) / mass
    temp = (e_kinetic / n_global) / KB_EV / 1.5
    return vcm, np.sqrt(temperature / temp)


def apply_temperature(gid: np.ndarray, mass: float, temperature: float,
                      vcm: np.ndarray, scale: float):
    """Per-atom momenta for a gid subset given the global (vcm, scale);
    bitwise identical to set_temperature over the full set."""
    p = _raw_momenta(gid, mass, temperature)
    if temperature == 0.0:
        return p
    p -= mass * vcm
    p *= scale
    return p


def set_temperature(gid: np.ndarray, mass: float, temperature: float,
                    n_global: int):
    """Boltzmann momenta + VCM removal + exact rescale
    (setTemperature, initAtoms.c:162-198).  Returns p [n,3] f64."""
    vcm, scale = temperature_params(mass, temperature, n_global)
    return apply_temperature(gid, mass, temperature, vcm, scale)


def random_displacements(r: np.ndarray, gid: np.ndarray, delta: float):
    """Uniform displacement in [-delta, delta] per axis
    (randomDisplacements, initAtoms.c:204-216)."""
    if delta == 0.0:
        return r
    u = native.uniform3(gid, 457)          # [n, 3]
    if u is None:
        u = rng.uniform_n(gid, 457, 3).T
    return r + (2.0 * u - 1.0) * delta
