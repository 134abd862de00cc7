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
    """The CellGeometry index maps as device tensors (built once).

    ``half_nbr_map`` is the half-shell neighbor set: self first, then one
    offset of each +/- pair.  ``nbr_map`` orders its 27 offsets as
    9(dx+1) + 3(dy+1) + (dz+1), so the index of -o is 26 - (index of o) and
    columns 13..26 (self, then the offsets with index > 13) hold self and
    exactly one of every opposite pair.  It is taken by that geometric rule
    from ``nbr_map``'s columns, never by sorting box ids (which -H Hilbert
    numbering would scramble).  comd_tpu's half sweeps use the other half
    (positive offsets in dense x-fastest order), so folded results agree
    with comd_tpu's only up to reassociation and the unfolded halo rows
    differ.
    """
    nbr_map: torch.Tensor       # [n_local, 27] int32
    half_nbr_map: torch.Tensor  # [n_local, 14] int32, self first
    halo_src: torch.Tensor      # [n_halo] int64
    halo_shift: torch.Tensor    # [n_halo, 3] dynamics dtype
    box_of_tuple: torch.Tensor  # [gx, gy, gz] int64 local numbering


#: column of the self cell in ``nbr_map`` (offset (0, 0, 0))
SELF_COLUMN = 13
#: the 27 neighbor offsets in ``nbr_map``'s column order
NBR_OFFSETS = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                   indexing="ij"), axis=-1).reshape(27, 3)


def geom_maps(geom: CellGeometry, dtype: torch.dtype, device) -> GeomMaps:
    nbr = torch.as_tensor(geom.nbr_map, dtype=torch.int32, device=device)
    maps = GeomMaps(
        nbr_map=nbr.contiguous(),
        half_nbr_map=nbr[:, SELF_COLUMN:].contiguous(),
        halo_src=torch.as_tensor(geom.halo_src, dtype=torch.int64,
                                 device=device),
        halo_shift=torch.as_tensor(geom.halo_shift, dtype=dtype,
                                   device=device),
        box_of_tuple=torch.as_tensor(geom.local_box_of_tuple,
                                     dtype=torch.int64, device=device),
    )
    # the stencil kernels take a neighbor map and find its geometry, and
    # the brick plans built from it, on the tensor (``brick_plan_for``)
    for t, half in ((maps.nbr_map, False), (maps.half_nbr_map, True)):
        t.brick_plans = (geom, half, {})
    return maps


# --------------------------------------------------------------------------
# the brick plan of the cell-stencil kernels
# --------------------------------------------------------------------------

#: slots a stencil block aims to hold: a brick's cells times their capacity
BRICK_SLOTS = 256


def brick_shape(A: int, grid) -> tuple:
    """Brick of local cells for cell capacity ``A``: the largest power-of-
    two count of cells whose slots fit ``BRICK_SLOTS``, doubled along x, y,
    z in turn (4x2x2 at A = 16, 2x2x2 at A = 32, one cell from A = 129),
    clipped to the grid."""
    n = max(1, BRICK_SLOTS // A)
    shape = [1, 1, 1]
    axis = 0
    while 2 * shape[0] * shape[1] * shape[2] <= n:
        shape[axis] *= 2
        axis = (axis + 1) % 3
    return tuple(min(b, g) for b, g in zip(shape, grid))


@dataclasses.dataclass(frozen=True)
class BrickPlan:
    """Static brick plan of one geometry, for the full (27 columns) or half
    (14, self first) neighbor map; numpy arrays or device tensors.

    ``cells[b, c]``: local box id of cell c of brick b (c = x + bx (y + by
    z) within the brick), -1 past the grid's edge.  Brick b's region is
    ``region_box[region_ptr[b]:region_ptr[b + 1]]``, the box ids of the
    union of its cells' neighbor boxes, ordered by grid coordinates (z, y,
    x).  ``slot[b, c, k]``: the place in that region of column k's box of
    cell c (0 where the cell is -1).
    """
    shape: tuple            # (bx, by, bz) cells
    half: bool
    cells: object           # [n_bricks, cpb] int32
    region_ptr: object      # [n_bricks + 1] int32
    region_box: object      # [n_region] int32
    slot: object            # [n_bricks, cpb, n_nbr] int16
    max_region: int

    @property
    def n_bricks(self) -> int:
        return self.cells.shape[0]


def build_brick_plan(geom: CellGeometry, shape, half: bool) -> BrickPlan:
    """The brick plan (numpy) from the cells' grid coordinates
    (``geom.tuple_of_box``) and ``geom.nbr_map``, never from box ids (which
    -H Hilbert numbering scrambles).  Serves every shard of a mesh (they
    share one geometry), edge bricks where the grid does not divide, and
    grids smaller than one brick."""
    n_local = geom.n_local
    cols = np.arange(SELF_COLUMN, 27) if half else np.arange(27)
    t = geom.tuple_of_box[:n_local].astype(np.int64)        # [n_local, 3]
    boxes = geom.nbr_map[:, cols]                            # [n_local, n]
    ntup = t[:, None, :] + NBR_OFFSETS[cols][None]           # -1 .. g
    b = np.asarray(shape, np.int64)
    n_b = -(-np.asarray(geom.grid, np.int64) // b)           # bricks/axis
    bt = t // b
    brick = bt[:, 0] + n_b[0] * (bt[:, 1] + n_b[1] * bt[:, 2])
    w = t - bt * b
    within = w[:, 0] + b[0] * (w[:, 1] + b[1] * w[:, 2])
    n_bricks, cpb = int(np.prod(n_b)), int(np.prod(b))
    cells = np.full((n_bricks, cpb), -1, np.int32)
    cells[brick, within] = np.arange(n_local, dtype=np.int32)
    # one region entry per (brick, neighbor grid coordinate)
    gx, gy, gz = geom.grid
    code = ((ntup[..., 2] + 1) * (gy + 2) + ntup[..., 1] + 1) * (gx + 2) + \
        ntup[..., 0] + 1
    n_code = (gx + 2) * (gy + 2) * (gz + 2)
    key = (brick[:, None] * n_code + code).reshape(-1)
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    region_box = boxes.reshape(-1)[first].astype(np.int32)
    if not np.array_equal(region_box[inv.reshape(-1)], boxes.reshape(-1)):
        raise ValueError("the neighbor map gives one grid coordinate two "
                         "boxes")
    count = np.bincount(uniq // n_code, minlength=n_bricks)
    region_ptr = np.zeros(n_bricks + 1, np.int32)
    region_ptr[1:] = np.cumsum(count)
    slot = np.zeros((n_bricks, cpb, len(cols)), np.int16)
    slot[brick, within] = (inv.reshape(n_local, len(cols))
                           - region_ptr[brick][:, None])
    return BrickPlan(shape=tuple(int(v) for v in shape), half=half,
                     cells=cells, region_ptr=region_ptr,
                     region_box=region_box, slot=slot,
                     max_region=int(count.max()))


def brick_plan_for(nbr_map: torch.Tensor, A: int) -> BrickPlan:
    """The brick plan, as tensors on the map's device, of a neighbor map
    made by ``geom_maps`` (its ``nbr_map`` or ``half_nbr_map``) for cell
    capacity ``A``; built once per brick shape."""
    owner = getattr(nbr_map, "brick_plans", None)
    if owner is None:
        raise ValueError("the cell-stencil kernels take the nbr_map or "
                         "half_nbr_map of a GeomMaps (binning.geom_maps), "
                         "whose geometry gives the brick plan")
    geom, half, plans = owner
    shape = brick_shape(A, geom.grid)
    if shape not in plans:
        p = build_brick_plan(geom, shape, half)
        plans[shape] = dataclasses.replace(p, **{
            k: torch.as_tensor(getattr(p, k), device=nbr_map.device)
            for k in ("cells", "region_ptr", "region_box", "slot")})
    return plans[shape]


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


def _run_rank(box_s: torch.Tensor, n_bins: int):
    """(rank of each entry within its run of equal sorted box ids, per-box
    run lengths [n_bins]): position minus the start of its run, the
    exclusive prefix sum of the run lengths (comd_tpu's ops/scan.run_rank)."""
    run_len = torch.zeros(n_bins, dtype=torch.int64, device=box_s.device)
    run_len.scatter_add_(0, box_s, torch.ones_like(box_s))
    run_start = torch.cumsum(run_len, 0) - run_len
    rank = torch.arange(box_s.numel(), device=box_s.device) - run_start[box_s]
    return rank, run_len


def _sort_by_box_gid(box: torch.Tensor, gid: torch.Tensor):
    """Canonical (cell, gid) order: one stable sort on box << 31 | gid
    (gid < 2^31, so the key orders by box, then gid).  Returns the sorted
    box ids and the permutation."""
    key_s, perm = torch.sort((box << 31) | gid.to(torch.int64), stable=True)
    return key_s >> 31, perm


def rebucket(geom: CellGeometry, maps: GeomMaps, r, p, gid, n_atoms, *,
             wrap_extent=None, keep_halo: bool = False):
    """Re-bin all local atoms into the canonical (cell, gid) dense layout.

    Args:
      r, p: [3, B, A] with B >= n_local (only local boxes are read).
      gid:  [B, A] int32.
      n_atoms: [B] int32 occupancy.
      wrap_extent: if given (serial/periodic case), coordinates are wrapped
        into [0, L) so every atom lands in a local cell.
      keep_halo: sharded case -- atoms that bin into halo cells (they
        drifted off this shard) are kept in those halo cells so the staged
        exchange can ship them to their new owner (timestep.c:222-276).

    Returns new tensors (r, p, gid, n_atoms, n_migrating, overflow) with
    stale halo boxes emptied and every box's atoms sorted by gid and
    compacted to the front.  ``n_migrating`` and ``overflow`` stay on the
    device.
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

    box_s, perm = _sort_by_box_gid(box, gl)
    rank, run_len = _run_rank(box_s, geom.n_total + 1)

    max_box = geom.n_total if keep_halo else n_local
    in_cell = box_s < max_box
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
    # occupancy counts every atom binned into a kept box, stored or not
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[:max_box] = run_len[:max_box].to(torch.int32)
    return new_r, new_p, new_gid, counts, n_migrating, overflow


def append_arrivals(geom: CellGeometry, maps: GeomMaps, r, p, gid, n_atoms,
                    arr_r, arr_p, arr_gid, arr_valid):
    """Merge exchange arrivals into cells by coordinate binning.

    ``arr_*`` are flat arrival buffers ([3, M] / [M]).  Each valid arrival
    is binned with the ownership rules (getBoxFromCoord) into a local cell
    (a migrated atom) or a halo cell (a ghost) and appended after the
    cell's current contents; ``sort_cells`` restores the canonical in-cell
    gid order afterwards.  Reference analog: unloadAtomsBuffer ->
    computeBoxIds + UnloadAtomsBufferPacked (gpu_redistribute.h:497-620).

    Returns new tensors (r, p, gid, n_atoms, overflow); ``n_atoms`` counts
    every arrival binned into a cell, stored or not.
    """
    A = r.shape[-1]
    B = r.shape[1]
    box = box_from_coord(geom, maps, arr_r)
    box = torch.where(arr_valid, box, geom.n_total)
    # invalid entries sort last whatever their gid holds
    box_s, perm = _sort_by_box_gid(
        box, torch.where(arr_valid, arr_gid, int(EMPTY_GID)))
    rank, run_len = _run_rank(box_s, geom.n_total + 1)

    in_cell = box_s < geom.n_total
    slot = n_atoms.to(torch.int64)[box_s.clamp(max=B - 1)] + rank
    overflow = (in_cell & (slot >= A)).any()
    dest = torch.where(in_cell & (slot < A), box_s * A + slot, B * A)

    def scatter(field, vals):
        out = torch.cat([field.reshape(B * A), field.new_empty(1)])
        out[dest] = vals[perm]               # slot B*A collects the drops
        return out[:B * A].reshape(B, A)

    r = torch.stack([scatter(r[a], arr_r[a]) for a in range(3)])
    p = torch.stack([scatter(p[a], arr_p[a]) for a in range(3)])
    gid = scatter(gid, arr_gid)
    n_atoms = n_atoms + run_len[:B].to(torch.int32)
    return r, p, gid, n_atoms, overflow


def sort_cells(r, p, gid):
    """Canonical in-cell gid sort of every cell, [B, A] row-wise.

    With gid-canonical cells a ghost cell's slot order equals its owner
    cell's, so the EAM dfEmbed exchange is a plain slot-aligned block copy
    (replaces the reference's SortAtomsByGlobalId / hash-table machinery,
    gpu_redistribute.h:735-848, hashTable.c).  Returns new tensors."""
    gid, order = torch.sort(gid, dim=-1, stable=True)
    idx = order.expand(3, *order.shape)
    return torch.gather(r, -1, idx), torch.gather(p, -1, idx), gid


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
