"""On-device atom redistribution ("rebucketing") and halo-cell filling.

Port of comd_tpu.ops.binning's serial half.  The reference redistributes
atoms after every drift with per-cell moves, stream compaction and an
in-cell gid sort (UpdateLinkCells/CompactAtoms, src-mpi/gpu_redistribute.h;
sortAtomsGpu, src-mpi/gpu_kernels.cu:1013-1043).  Here that is ONE
fixed-shape canonicalization: compute each atom's destination cell from its
coordinates (ownership rules of getBoxFromCoord, src-mpi/linkCells.c:
448-480), sort the flat atom array by (cell, gid) with one stable
``torch.sort`` on the int64 key ``box << 31 | gid``, and scatter into the
dense [nBoxes, MAXATOMS] layout.  The (cell, gid) order is canonical, so the
layout equals comd_tpu's slot for slot.

Halo cells are then filled by a static gather (serial/periodic case).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cells import CellGeometry

#: coordinate sentinel for empty slots; far from any real atom, and pairs of
#: empty slots coincide so r2==0 masks them out (reference instead stores one
#: atom "at infinity", src-mpi/initAtoms.c:30,55-57).
EMPTY_POS = 1.0e10
EMPTY_GID = np.int32(2**31 - 1)


@dataclasses.dataclass(frozen=True)
class GeomMaps:
    """The CellGeometry index maps as device tensors (built once)."""
    nbr_map: torch.Tensor       # [n_local, 27] int32
    halo_src: torch.Tensor      # [n_halo] int64
    halo_shift: torch.Tensor    # [n_halo, 3] dynamics dtype
    box_of_tuple: torch.Tensor  # [gx, gy, gz] int64 local numbering


def geom_maps(geom: CellGeometry, dtype: torch.dtype, device) -> GeomMaps:
    return GeomMaps(
        nbr_map=torch.as_tensor(geom.nbr_map, dtype=torch.int32,
                                device=device).contiguous(),
        halo_src=torch.as_tensor(geom.halo_src, dtype=torch.int64,
                                 device=device),
        halo_shift=torch.as_tensor(geom.halo_shift, dtype=dtype,
                                   device=device),
        box_of_tuple=torch.as_tensor(geom.local_box_of_tuple,
                                     dtype=torch.int64, device=device),
    )


def box_from_tuple(geom: CellGeometry, maps: GeomMaps, ix, iy, iz):
    """getBoxFromTuple (linkCells.c:299-346) on int64 tensors."""
    gx, gy, gz = geom.grid
    n_local = geom.n_local
    zp = n_local + 2 * gz * gy + 2 * gz * (gx + 2) + \
        (gx + 2) * (gy + 2) + (gx + 2) * (iy + 1) + (ix + 1)
    zm = n_local + 2 * gz * gy + 2 * gz * (gx + 2) + \
        (gx + 2) * (iy + 1) + (ix + 1)
    yp = n_local + 2 * gz * gy + gz * (gx + 2) + (gx + 2) * iz + (ix + 1)
    ym = n_local + 2 * gz * gy + iz * (gx + 2) + (ix + 1)
    xp = n_local + gy * gz + iz * gy + iy
    xm = n_local + iz * gy + iy
    if geom.use_hilbert:
        local = maps.box_of_tuple[ix.clamp(0, gx - 1), iy.clamp(0, gy - 1),
                                  iz.clamp(0, gz - 1)]
    else:
        local = ix + iy * gx + iz * gx * gy
    out = local
    out = torch.where(ix == -1, xm, out)
    out = torch.where(ix == gx, xp, out)
    out = torch.where(iy == -1, ym, out)
    out = torch.where(iy == gy, yp, out)
    out = torch.where(iz == -1, zm, out)
    out = torch.where(iz == gz, zp, out)
    return out


def box_from_coord(geom: CellGeometry, maps: GeomMaps, r: torch.Tensor):
    """getBoxFromCoord ownership rules (linkCells.c:448-480) on [3, N]
    coordinates.  The cell index is computed in f64 whatever r's dtype,
    as comd_tpu does (its numpy-f64 geometry constants promote f32)."""
    tup = []
    for a in range(3):
        g = geom.grid[a]
        ra = r[a].to(torch.float64)
        ia = torch.floor((ra - float(geom.local_min[a]))
                         * float(geom.inv_box_size[a])).to(torch.int64)
        inside = ra < float(geom.local_max[a])
        ia = torch.where(inside & (ia == g), g - 1, ia)
        ia = torch.where(inside, ia, g)
        tup.append(ia.clamp(-1, g))
    return box_from_tuple(geom, maps, *tup)


def wrap_pbc(r: torch.Tensor, global_extent) -> torch.Tensor:
    """Wrap coordinates into [0, L] per axis.

    The result may land exactly on L for values infinitesimally below 0 (fp
    rounding); rebucket() folds such boundary cases back through the halo
    map, so no strict [0, L) guarantee is needed here.
    """
    L = torch.as_tensor(np.asarray(global_extent), dtype=r.dtype,
                        device=r.device).reshape(3, *([1] * (r.dim() - 1)))
    r = r - L * torch.floor(r / L)
    return torch.where(r >= L, r - L, r)


def rebucket(geom: CellGeometry, maps: GeomMaps, r, p, gid, n_atoms, *,
             wrap_extent=None):
    """Re-bin all local atoms into the canonical (cell, gid) dense layout.

    Args:
      r, p: [3, B, A] with B >= n_local (only local boxes are read).
      gid:  [B, A] int32.
      n_atoms: [B] int32 occupancy.
      wrap_extent: if given (serial/periodic case), coordinates are wrapped
        into [0, L) so every atom lands in a local cell.

    Returns new tensors (r, p, gid, n_atoms, n_migrating, overflow) with
    halo boxes emptied and every box's atoms sorted by gid and compacted to
    the front.  ``n_migrating`` and ``overflow`` stay on the device.
    """
    A = r.shape[-1]
    B = r.shape[1]
    n_local = geom.n_local
    flat_n = n_local * A
    dev = r.device

    rl = r[:, :n_local].reshape(3, flat_n)
    pl = p[:, :n_local].reshape(3, flat_n)
    gl = gid[:n_local].reshape(flat_n)
    slot = torch.arange(A, device=dev, dtype=torch.int32).repeat(n_local)
    valid = slot < n_atoms[:n_local].repeat_interleave(A)

    if wrap_extent is not None:
        rl = wrap_pbc(rl, wrap_extent)

    box = box_from_coord(geom, maps, rl)

    if wrap_extent is not None:
        # an atom binned into a halo cell (a coordinate rounded exactly
        # onto L) is owned by the periodic-image local cell: fold it back
        # through the halo map (the reference's serial self-exchange with
        # PBC shift, src-mpi/parallel.c:112-117)
        in_halo = box >= n_local
        h = (box - n_local).clamp(0, geom.n_halo - 1)
        src = maps.halo_src[h]
        shf = maps.halo_shift.to(rl.dtype)[h]            # [N, 3]
        box = torch.where(in_halo, src, box)
        rl = torch.where(in_halo[None, :], rl - shf.T, rl)

    box = torch.where(valid, box, geom.n_total)          # empties sort last
    migrating = valid & (box >= n_local)
    n_migrating = migrating.sum(dtype=torch.int32)

    # canonical (cell, gid) order: one stable sort on box << 31 | gid
    # (gid < 2^31, so the key orders by box, then gid)
    key = (box << 31) | gl.to(torch.int64)
    key_s, perm = torch.sort(key, stable=True)
    box_s = key_s >> 31

    # rank within destination cell: position minus the start of its run,
    # the exclusive prefix sum of the per-box run lengths
    run_len = torch.zeros(geom.n_total + 1, dtype=torch.int64, device=dev)
    run_len.scatter_add_(0, box_s, torch.ones_like(box_s))
    run_start = torch.cumsum(run_len, 0) - run_len
    rank = torch.arange(flat_n, device=dev) - run_start[box_s]

    in_cell = box_s < n_local
    overflow = (in_cell & (rank >= A)).any()
    dest = torch.where(in_cell & (rank < A), box_s * A + rank, B * A)

    def scatter(flat_vals, fill):
        out = torch.full((B * A + 1,), fill, dtype=flat_vals.dtype,
                         device=dev)
        out[dest] = flat_vals[perm]          # slot B*A collects the drops
        return out[:B * A].reshape(B, A)

    new_r = torch.stack([scatter(rl[a], EMPTY_POS) for a in range(3)])
    new_p = torch.stack([scatter(pl[a], 0.0) for a in range(3)])
    new_gid = scatter(gl, int(EMPTY_GID))
    # occupancy counts every atom binned into a local box, kept or not
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[:n_local] = run_len[:n_local].to(torch.int32)
    return new_r, new_p, new_gid, counts, n_migrating, overflow


def refresh_halo_positions(geom: CellGeometry, maps: GeomMaps, r):
    """Rewrite the halo cells' positions from their periodic sources, in
    place (the lazy step's ghost refresh between rebuckets)."""
    r[:, geom.n_local:] = r[:, maps.halo_src] + maps.halo_shift.T[:, :, None]
    return r


def fill_halo_serial(geom: CellGeometry, maps: GeomMaps, r, gid, n_atoms):
    """Periodic-image halo fill for the single-domain case, in place.

    Serial CoMD degenerates its halo exchange into self-copies with PBC
    shifts (doc: src-mpi/CoMD.c:1127-1129); here that is one static gather.
    """
    n_local = geom.n_local
    refresh_halo_positions(geom, maps, r)
    gid[n_local:] = gid[maps.halo_src]
    n_atoms[n_local:] = n_atoms[maps.halo_src]
    return r, gid, n_atoms


def fill_halo_scalar_serial(geom: CellGeometry, maps: GeomMaps, x):
    """Halo fill for a per-atom scalar field [B, A] (EAM dfEmbed,
    eam.c:368-371), in place: one ``index_select`` of the mirrored rows."""
    x[geom.n_local:] = torch.index_select(x, 0, maps.halo_src)
    return x
