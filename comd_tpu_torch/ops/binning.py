"""On-device atom redistribution ("rebucketing") and halo-cell filling.

Port of comd_tpu.ops.binning's serial half.  The reference redistributes
atoms after every drift with per-cell moves, stream compaction and an
in-cell gid sort (UpdateLinkCells/CompactAtoms, src-mpi/gpu_redistribute.h;
sortAtomsGpu, src-mpi/gpu_kernels.cu:1013-1043).  Here that is ONE
fixed-shape canonicalization: compute each atom's destination cell from its
coordinates (ownership rules of getBoxFromCoord, src-mpi/linkCells.c:
448-480) and write every cell's atoms in ascending gid order into the
dense [nBoxes, MAXATOMS] layout: on the card two kernels (csrc/
rebucket.cu: bin and stage, then a per-cell gid rank), on the CPU their
plain version, one stable ``torch.sort`` on the int64 key ``box << 31 |
gid`` and a scatter (ops/cuda/rebucket.py).  The (cell, gid) order is
canonical, so the layout equals comd_tpu's slot for slot.

Halo cells are then filled by a static gather (serial/periodic case).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cells import CellGeometry, boundary_lists
from .cuda import arrivals as arrivals_ops
from .cuda import rebucket as rebucket_ops
from .cuda import step as step_ops

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
    interior: "BoxSubset"       # -a 1: cells whose 27 neighbors are local
    boundary: "BoxSubset"       # -a 1: the other local cells
    images: "ImageMap"          # serial: each local cell's ghost images


@dataclasses.dataclass(frozen=True, eq=False)
class ImageMap:
    """The serial ghost images of each local cell, the inverse of
    ``halo_src`` as 32-bit CSR: local cell c is the periodic source of the
    halo rows ``row[start[c]:start[c + 1]]`` (box ids n_local + h, in
    ascending h), each shifted by its ``shift`` row.  Every halo row
    appears once; a cell on a face of the grid has one image, on an edge
    three, at a corner seven (more on an axis of one or two cells).  The
    step's trigger kernel writes them (ops/cuda/step.kick_drift_trigger's
    ``images``); its plain version refreshes through ``halo_src`` and
    ``halo_shift``, the maps' own.  The half-shell fold's plans over it
    (ops/sweep.fold_halo_serial) are kept in ``fold_plans``, one a field
    shape."""
    start: torch.Tensor         # [n_local + 1] int32
    row: torch.Tensor           # [n_halo] int32
    shift: torch.Tensor         # [n_halo, 3] dynamics dtype
    halo_src: torch.Tensor      # [n_halo] int64 (GeomMaps.halo_src)
    halo_shift: torch.Tensor    # [n_halo, 3] (GeomMaps.halo_shift)
    fold_plans: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_local(self) -> int:
        return self.start.shape[0] - 1


def image_map(geom: CellGeometry, halo_src: torch.Tensor,
              halo_shift: torch.Tensor) -> ImageMap:
    """The ImageMap of ``geom`` (numpy on the host, then on the device of
    the maps' ``halo_src``/``halo_shift``)."""
    src = np.asarray(geom.halo_src, np.int64)
    order = np.argsort(src, kind="stable")
    start = np.zeros(geom.n_local + 1, np.int32)
    start[1:] = np.cumsum(np.bincount(src, minlength=geom.n_local))
    dev = halo_src.device
    return ImageMap(
        start=torch.as_tensor(start, device=dev),
        row=torch.as_tensor((geom.n_local + order).astype(np.int32),
                            device=dev),
        shift=halo_shift[torch.as_tensor(order, device=dev)].contiguous(),
        halo_src=halo_src, halo_shift=halo_shift)


@dataclasses.dataclass(frozen=True, eq=False)
class BoxSubset:
    """A subset of a geometry's local cells, for the cell-stencil sweeps
    over part of the grid (the -a 1 interior/boundary split): its box ids,
    ascending, on the host (``ids``, int32, which the brick plan is built
    from) and on the maps' device (``index``, int64).  Compared and hashed
    by identity: the brick plans over it are cached on it."""
    ids: np.ndarray
    index: torch.Tensor

    @property
    def n(self) -> int:
        return len(self.ids)


#: column of the self cell in ``nbr_map`` (offset (0, 0, 0))
SELF_COLUMN = 13
#: the 27 neighbor offsets in ``nbr_map``'s column order
NBR_OFFSETS = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                   indexing="ij"), axis=-1).reshape(27, 3)


def geom_maps(geom: CellGeometry, dtype: torch.dtype, device) -> GeomMaps:
    nbr = torch.as_tensor(geom.nbr_map, dtype=torch.int32, device=device)
    subsets = [BoxSubset(ids=ids, index=torch.as_tensor(
        ids, dtype=torch.int64, device=device))
        for ids in boundary_lists(geom, ring=1)]
    halo_src = torch.as_tensor(geom.halo_src, dtype=torch.int64,
                               device=device)
    halo_shift = torch.as_tensor(geom.halo_shift, dtype=dtype, device=device)
    maps = GeomMaps(
        nbr_map=nbr.contiguous(),
        half_nbr_map=nbr[:, SELF_COLUMN:].contiguous(),
        halo_src=halo_src, halo_shift=halo_shift,
        box_of_tuple=torch.as_tensor(geom.local_box_of_tuple,
                                     dtype=torch.int64, device=device),
        interior=subsets[0], boundary=subsets[1],
        images=image_map(geom, halo_src, halo_shift),
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


def build_brick_plan(geom: CellGeometry, shape, half: bool,
                     ids=None) -> BrickPlan:
    """The brick plan (numpy) from the cells' grid coordinates
    (``geom.tuple_of_box``) and ``geom.nbr_map``, never from box ids (which
    -H Hilbert numbering scrambles).  Serves every shard of a mesh (they
    share one geometry), edge bricks where the grid does not divide, and
    grids smaller than one brick.  ``ids`` (local box ids, non-empty)
    restricts the plan to those cells: the others are -1, as past the
    grid's edge, the regions hold only their neighbor boxes, and bricks
    with none of them are dropped (the full set drops none)."""
    ids = (np.arange(geom.n_local) if ids is None
           else np.asarray(ids)).astype(np.int64)
    n_sel = len(ids)
    cols = np.arange(SELF_COLUMN, 27) if half else np.arange(27)
    t = geom.tuple_of_box[ids].astype(np.int64)              # [n_sel, 3]
    boxes = geom.nbr_map[ids][:, cols]                       # [n_sel, n]
    ntup = t[:, None, :] + NBR_OFFSETS[cols][None]           # -1 .. g
    b = np.asarray(shape, np.int64)
    n_b = -(-np.asarray(geom.grid, np.int64) // b)           # bricks/axis
    bt = t // b
    brick_all = bt[:, 0] + n_b[0] * (bt[:, 1] + n_b[1] * bt[:, 2])
    used, brick = np.unique(brick_all, return_inverse=True)
    brick = brick.reshape(-1)
    w = t - bt * b
    within = w[:, 0] + b[0] * (w[:, 1] + b[1] * w[:, 2])
    n_bricks, cpb = len(used), int(np.prod(b))
    cells = np.full((n_bricks, cpb), -1, np.int32)
    cells[brick, within] = ids.astype(np.int32)
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
    slot[brick, within] = (inv.reshape(n_sel, len(cols))
                           - region_ptr[brick][:, None])
    return BrickPlan(shape=tuple(int(v) for v in shape), half=half,
                     cells=cells, region_ptr=region_ptr,
                     region_box=region_box, slot=slot,
                     max_region=int(count.max()))


def brick_plan_for(nbr_map: torch.Tensor, A: int,
                   boxes: BoxSubset = None) -> BrickPlan:
    """The brick plan, as tensors on the map's device, of a neighbor map
    made by ``geom_maps`` (its ``nbr_map`` or ``half_nbr_map``) for cell
    capacity ``A``, over all local cells or the non-empty subset
    ``boxes`` (the maps' ``interior`` or ``boundary``); built once per
    brick shape and subset."""
    owner = getattr(nbr_map, "brick_plans", None)
    if owner is None:
        raise ValueError("the cell-stencil kernels take the nbr_map or "
                         "half_nbr_map of a GeomMaps (binning.geom_maps), "
                         "whose geometry gives the brick plan")
    geom, half, plans = owner
    key = (brick_shape(A, geom.grid), boxes)
    if key not in plans:
        p = build_brick_plan(geom, key[0], half,
                             None if boxes is None else boxes.ids)
        plans[key] = dataclasses.replace(p, **{
            k: torch.as_tensor(getattr(p, k), device=nbr_map.device)
            for k in ("cells", "region_ptr", "region_box", "slot")})
    return plans[key]


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
    """Wrap coordinates into [0, L] per axis; ``global_extent`` [3] on the
    host or, read without a copy, as a tensor of r's dtype and device.

    The result may land exactly on L for values infinitesimally below 0 (fp
    rounding); rebucket() folds such boundary cases back through the halo
    map, so no strict [0, L) guarantee is needed here.
    """
    L = torch.as_tensor(global_extent, dtype=r.dtype,
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
    device.  On the card the two kernels of csrc/rebucket.cu, on the CPU
    their plain version (ops/cuda/rebucket.py).
    """
    return rebucket_ops.rebucket(geom, maps, r, p, gid, n_atoms,
                                 wrap_extent=wrap_extent,
                                 keep_halo=keep_halo)


def rebucket_into(geom: CellGeometry, maps: GeomMaps, r, p, gid, n_atoms,
                  overflow, *, wrap_extent=None, last_r=None) -> None:
    """``rebucket`` of the single domain in place (the serial step's
    body): r, p, gid, n_atoms take the new layout with empty halo cells,
    ``overflow`` (0-dim bool) is or-ed with the flag and ``last_r``, given,
    takes the new positions in its local rows (ops/cuda/rebucket.py::
    rebucket_into)."""
    rebucket_ops.rebucket_into(geom, maps, r, p, gid, n_atoms, overflow,
                               wrap_extent=wrap_extent, last_r=last_r)


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
    every arrival binned into a cell, stored or not.  On the card the two
    kernels of csrc/arrivals.cu, on the CPU their plain version
    (ops/cuda/arrivals.py).
    """
    return arrivals_ops.append_arrivals(geom, maps, r, p, gid, n_atoms,
                                        arr_r, arr_p, arr_gid, arr_valid)


def append_stage(geom: CellGeometry, maps: GeomMaps, r, p, gid, n_atoms,
                 arrivals, overflow, axis: int = -1,
                 shifts=(0.0, 0.0)) -> None:
    """One exchange stage's arrivals appended to every shard of the lists,
    in place: ``arrivals[s]`` holds shard s's sources of direction 0 (from
    its minus neighbor) and 1, each (r, p, gid, mask) with the sender's
    cell counts or a flag an entry as the mask, direction d's positions
    shifted by ``shifts[d]`` along ``axis`` into the receiver's frame;
    ``overflow`` is set where a cell overflowed.  ``append_arrivals`` of
    each shard, direction 0 then 1, in two launches on the card
    (ops/cuda/arrivals.py::append_stage)."""
    arrivals_ops.append_stage(geom, maps, r, p, gid, n_atoms, arrivals,
                              overflow, axis, shifts)


def sort_cells(r, p, gid):
    """Canonical in-cell gid sort of every cell, [B, A] row-wise.

    With gid-canonical cells a ghost cell's slot order equals its owner
    cell's, so the EAM dfEmbed exchange is a plain slot-aligned block copy
    (replaces the reference's SortAtomsByGlobalId / hash-table machinery,
    gpu_redistribute.h:735-848, hashTable.c).  Returns new tensors; on the
    card csrc/arrivals.cu's sort_cells kernel."""
    return arrivals_ops.sort_cells(r, p, gid)


def sort_shards(r, p, gid, out=None) -> None:
    """``sort_cells`` of every shard of the lists in one launch, in place
    or into ``out``'s (r, p, gid) lists (ops/cuda/arrivals.py::
    sort_shards)."""
    arrivals_ops.sort_shards(r, p, gid, out)


def fill_halo_serial(geom: CellGeometry, maps: GeomMaps, r, gid, n_atoms):
    """Periodic-image halo fill for the single-domain case, in place: the
    positions, gids and counts in one launch (ops/cuda/step.refresh_halo).

    Serial CoMD degenerates its halo exchange into self-copies with PBC
    shifts (doc: src-mpi/CoMD.c:1127-1129); here that is one static gather.
    """
    step_ops.refresh_halo(geom, maps, r, gid, n_atoms)
    return r, gid, n_atoms


def fill_halo_scalar_serial(geom: CellGeometry, maps: GeomMaps, x):
    """Halo fill for a per-atom scalar field [B, A] (EAM dfEmbed,
    eam.c:368-371), in place: one ``index_select`` of the mirrored rows."""
    x[geom.n_local:] = torch.index_select(x, 0, maps.halo_src)
    return x
