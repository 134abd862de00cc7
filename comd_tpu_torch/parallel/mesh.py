"""The mesh of shards: the port's counterpart of comd_tpu's device Mesh.

comd_tpu decomposes the box over a ``jax.sharding.Mesh`` with axes
('x', 'y', 'z') and runs one ``shard_map`` program over it
(sharded.make_mesh, the reference's MPI rank grid of
src-mpi/decomposition.c).  The port keeps that single-controller design
inside one process: a ``Mesh`` is the grid (px, py, pz), the shards'
coordinates in ``np.ndindex`` order (x-major, z fastest) and each shard's
ring neighbors along each axis.  All shards live on one torch device; each
owns one brick of the box in its own local frame.

``gen_shard_atoms`` generates one shard's atoms exactly as comd_tpu's
``_gen_shard_atoms`` does, so both packages partition the box alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import lattice
from ..config import Config


@dataclasses.dataclass(frozen=True)
class Mesh:
    grid: tuple            # (px, py, pz)
    device: torch.device   # every shard's device

    @property
    def size(self) -> int:
        return int(np.prod(self.grid))

    @property
    def coords(self) -> list:
        """Shard coordinates in shard order (x-major, as np.ndindex)."""
        return [tuple(int(c) for c in idx) for idx in np.ndindex(*self.grid)]

    def index(self, coord) -> int:
        return int(np.ravel_multi_index(tuple(coord), self.grid))

    def neighbor(self, s: int, axis: int, step: int) -> int:
        """The shard ``step`` (+1 or -1) along ``axis`` from shard ``s``, on
        the periodic ring of that axis (itself on an axis of size 1)."""
        c = list(self.coords[s])
        c[axis] = (c[axis] + step) % self.grid[axis]
        return self.index(c)

    def ring(self, axis: int, step: int) -> list:
        """neighbor(s, axis, step) for every shard s."""
        return [self.neighbor(s, axis, step) for s in range(self.size)]


def make_mesh(px: int, py: int, pz: int, device, devices=None) -> Mesh:
    """A px x py x pz mesh of shards on ``device``.  Shards spread over
    several devices (``devices`` with more than one entry) are not ported
    yet."""
    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            "shards on several devices are not ported to comd_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 14); every shard of the mesh lives on "
            "one device")
    if min(px, py, pz) < 1:
        raise ValueError(f"invalid mesh {(px, py, pz)}")
    return Mesh(grid=(int(px), int(py), int(pz)), device=torch.device(device))


def gen_shard_atoms(cfg: Config, lat: float, global_extent, local_extent,
                    coord):
    """(r in the global frame [n, 3], gid [n]) of ONE shard's brick,
    reproducing the single-domain partition exactly: assignment by
    displaced position with floor and edge-clip semantics.  Undisplaced
    sites within initial_delta of the brick are generated too (they may
    displace in); edge shards keep atoms displaced past the global boundary
    (the clip).  The per-rank analog of createFccLattice's local window
    (initAtoms.c:81-124); copied from comd_tpu.parallel.sharded."""
    pgrid = np.array([cfg.xproc, cfg.yproc, cfg.zproc])
    coord = np.asarray(coord)
    delta = cfg.initial_delta
    lmin = coord * local_extent
    lmax = lmin + local_extent
    gmin = np.maximum(lmin - (delta + 1e-9), 0.0)
    gmax = np.minimum(lmax + (delta + 1e-9), global_extent)
    r, gid = lattice.create_fcc_lattice(cfg.nx, cfg.ny, cfg.nz, lat,
                                        gmin, gmax)
    r = lattice.random_displacements(r, gid, delta)
    lo = np.where(coord == 0, -np.inf, lmin)
    hi = np.where(coord == pgrid - 1, np.inf, lmax)
    keep = np.all((r >= lo) & (r < hi), axis=1)
    return r[keep], gid[keep]
