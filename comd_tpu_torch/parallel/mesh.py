"""The mesh of shards: the port's counterpart of comd_tpu's device Mesh.

comd_tpu decomposes the box over a ``jax.sharding.Mesh`` with axes
('x', 'y', 'z') and runs one ``shard_map`` program over it
(sharded.make_mesh, the reference's MPI rank grid of
src-mpi/decomposition.c).  A ``Mesh`` here is the grid (px, py, pz), the
shards' coordinates in ``np.ndindex`` order (x-major, z fastest) and each
shard's ring neighbors along each axis; each shard owns one brick of the
box in its own local frame.

With several processes (the multi-process launch, parallel/dist.py),
process p of N owns the contiguous block of shards [p*S/N, (p+1)*S/N) in
shard order and holds them on its one device: comd_tpu's map of devices to
processes when each process has S/N devices (sharded.py:59-65, :679-686).
A single process owns every shard.

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
    device: torch.device   # this process's shards' device
    nprocs: int = 1        # processes of the launch
    proc: int = 0          # this process's index

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

    def owner(self, s: int) -> int:
        """The process that owns shard ``s``."""
        return s // (self.size // self.nprocs)

    @property
    def owned(self) -> range:
        """This process's shards, in shard order."""
        n = self.size // self.nprocs
        return range(self.proc * n, (self.proc + 1) * n)

    def slot(self, s: int) -> int:
        """Shard ``s``'s place in this process's list of shards."""
        return s - self.owned.start


def make_mesh(px: int, py: int, pz: int, device, nprocs: int = 1,
              proc: int = 0) -> Mesh:
    """A px x py x pz mesh of shards spread over ``nprocs`` processes, as
    seen by process ``proc``, whose shards live on ``device``."""
    if min(px, py, pz) < 1:
        raise ValueError(f"invalid mesh {(px, py, pz)}")
    size = px * py * pz
    if size % nprocs:
        raise ValueError(f"the {size} shards of the {px}x{py}x{pz} mesh do "
                         f"not split evenly over {nprocs} processes")
    return Mesh(grid=(int(px), int(py), int(pz)), device=torch.device(device),
                nprocs=int(nprocs), proc=int(proc))


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
