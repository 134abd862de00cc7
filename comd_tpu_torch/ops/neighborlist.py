"""Verlet neighbor lists with the skin/2 rebuild trigger, in plain PyTorch.

Port of comd_tpu.ops.neighborlist.  Reference: CPU half-lists
(src-mpi/neighborList.c:50-247), GPU full lists built by ballot/popc
compaction kernels (gpu_kernels.cu:1494-2029); rebuild when any atom moved
more than skin/2 since the last build (neighborList.c:212-247).

Rows are the compacted local atoms (``a_list``, flat slot ids into the
dense [B, A] layout, valid rows first); a row's entries are flat slot ids
of the j inside rcut + skin, the first K in candidate order (the 27 boxes
of ``nbr_map`` in column order, slots 0..A-1 within each), the rest padded
with the row's own slot id, so a padded entry gives r2 == 0 and masks out.
Rows past the real atoms (``a_valid`` False) carry slot id 0 and an
all-padding list: comd_tpu builds slot 0's list there, which nothing reads
(no slot maps to those rows), so lists compare on valid rows.

Between rebuilds the cell layout is frozen: ghosts are refreshed by
slot-aligned position copies and only the skin trigger rebuckets.

``build`` and ``pair_sweep_nl`` here are the plain versions of the CUDA
kernels NL1 and NL2 (ops/cuda/nl.py, csrc/nl.cu), which compute the same
lists bit for bit and the same sums in another order.  The compaction is
a cumsum in candidate order (comd_tpu's stable ``lax.top_k`` over a 0/1
mask keeps the same first K).  comd_tpu's chunking by ``nl_chunk`` rows and
its top_k VMEM budget were TPU limits: the plain versions chunk by a memory
budget instead.

The row ops around the sweeps have plain versions here too, of kernels in
csrc/nl.cu and csrc/step.cu: ``nl_rows_plain`` (NR: the build's rows and
each cell's ``row_start``), ``embed_rows_plain`` (ER: pass 2 on the rows,
dfEmbed in the cell layout with its serial halo fill, U per row) and
``land_rows_plain`` (LR: the per-row force into the cell layout, the
second half kick and the atom count).  Local slot (c, s) is row
``row_start[c] + s`` when s < min(n_atoms[c], A) and that row is below the
row capacity; every other slot has no row.  Rows may come as segments
(the -a 1 split's interior and boundary sweeps), read in row order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cells
from ..cells import CellGeometry
from ..potentials.tables import as_dtype

#: bytes of temporaries a chunk of the plain build or sweep may hold
PLAIN_BUDGET = 1 << 28


@dataclasses.dataclass
class NeighborList:
    a_list: torch.Tensor   # [R] int32 flat slot ids of local atoms (compact)
    a_valid: torch.Tensor  # [R] bool
    nl: torch.Tensor       # [R, K] int32 flat slot ids (self-id padded)
    last_r: torch.Tensor   # [3, B, A] positions at build time
    row_start: torch.Tensor  # [n_local] int32: the row of each cell's slot 0


@dataclasses.dataclass
class RowForce:
    """A list force per row, as the sweeps leave it, for the landing
    (``land_rows``): ``parts`` the force's passes (EAM's f1 and f3, added
    row by row; LJ's f), each a tuple of one or two [3, R_s] row segments
    in row order (the -a 1 split's interior and boundary sweeps), over
    ``nlist``'s rows, built from the counts ``n_atoms``."""
    nlist: NeighborList
    n_atoms: torch.Tensor
    parts: tuple


def n_rows_for(geom: CellGeometry, max_atoms: int,
               factor: float = 1.0) -> int:
    """Static row capacity: every local slot (or ``factor`` of them),
    padded to a multiple of 128 as in comd_tpu."""
    n = int(geom.n_local * max_atoms * factor)
    return max(128, -(-n // 128) * 128)


def _compact(valid: torch.Tensor, size: int):
    """First ``size`` indices where ``valid`` [N] holds, ascending, filled
    with 0 (comd_tpu's compact_indices): (idx [size] int32, a_valid [size]
    bool, count)."""
    pos = torch.cumsum(valid, 0, dtype=torch.int64) - 1
    n_real = pos[-1] + 1
    dest = torch.where(valid, pos, size).clamp_max(size)
    idx = torch.zeros(size + 1, dtype=torch.int32, device=valid.device)
    idx[dest] = torch.arange(valid.numel(), dtype=torch.int32,
                             device=valid.device)
    ar = torch.arange(size, device=valid.device)
    return idx[:size], ar < n_real, n_real


def _occupied(geom: CellGeometry, n_atoms, A: int):
    slot = torch.arange(A, device=n_atoms.device)
    return slot[None, :] < n_atoms[:geom.n_local, None]     # [n_local, A]


def build_atom_list(geom: CellGeometry, n_atoms, A: int, n_rows: int):
    """Compact flat slot ids of all local atoms (BuildAtomLists analog,
    gpu_kernels.cu:409-454): (a_list [n_rows], a_valid [n_rows], count)."""
    return _compact(_occupied(geom, n_atoms, A).reshape(-1), n_rows)


def row_split_for(geom: CellGeometry, A: int):
    """Static row partition for the -a 1 NL split: (is_boundary [n_local],
    Ri, Rb) with interior rows first.  Rb holds every boundary-cell slot
    (so that segment never overflows), Ri every interior slot; both padded
    to multiples of 128.  The reference's i_list/b_list split
    (gpu_utility.c:73-163) for the NL methods (timestep.c:257-265)."""
    interior, boundary = cells.boundary_lists(geom, ring=1)
    is_boundary = np.zeros(geom.n_local, dtype=bool)
    is_boundary[boundary] = True

    def pad(n):
        return max(128, -(-n // 128) * 128)

    return is_boundary, pad(len(interior) * A), pad(len(boundary) * A)


def build_atom_list_split(geom: CellGeometry, n_atoms, A: int, row_split):
    """Compact slot ids as [interior rows (Ri)] ++ [boundary rows (Rb)]:
    interior-cell atoms' entries reference only local cells, so their
    sweeps can read pre-exchange state.  ``row_split``'s mask may be a
    tensor on n_atoms' device (read without a copy)."""
    is_boundary, Ri, Rb = row_split
    occ = _occupied(geom, n_atoms, A)
    is_b = torch.as_tensor(is_boundary, device=n_atoms.device)[:, None]
    idx_i, v_i, n_i = _compact((occ & ~is_b).reshape(-1), Ri)
    idx_b, v_b, n_b = _compact((occ & is_b).reshape(-1), Rb)
    return (torch.cat([idx_i, idx_b]), torch.cat([v_i, v_b]), n_i + n_b)


def _exclusive(x):
    return (torch.cumsum(x, 0) - x).to(torch.int32)


def nl_rows_plain(geom: CellGeometry, n_atoms, A: int, n_rows: int,
                  row_split=None):
    """The rows of a build (NR's plain version): (a_list [R] int32,
    a_valid [R] bool, row_start [n_local] int32).  a_list and a_valid are
    ``build_atom_list``'s (R = ``n_rows``) or, with ``row_split``
    (row_split_for), ``build_atom_list_split``'s (R = Ri + Rb, interior
    rows first), comd_tpu's bit for bit.  ``row_start[c]`` is where cell
    c's min(n_atoms[c], A) rows begin: the exclusive scan of those counts
    over the local cells (with the split over the interior cells from 0
    and over the boundary cells from Ri); a slot whose row would be at or
    past R (more atoms than ``n_rows`` holds) has none."""
    if row_split is not None:
        a_list, a_valid, _n = build_atom_list_split(geom, n_atoms, A,
                                                    row_split)
    else:
        a_list, a_valid, _n = build_atom_list(geom, n_atoms, A, n_rows)
    occ = n_atoms[:geom.n_local].clamp(0, A).to(torch.int64)
    if row_split is None:
        return a_list, a_valid, _exclusive(occ)
    is_b = torch.as_tensor(row_split[0], device=n_atoms.device)
    zero = torch.zeros_like(occ)
    start_i = _exclusive(torch.where(is_b, zero, occ))
    start_b = _exclusive(torch.where(is_b, occ, zero)) + row_split[1]
    return a_list, a_valid, torch.where(is_b, start_b, start_i)


def cell_row_starts(a_list, a_valid, n_local: int, A: int):
    """``row_start`` of a list made elsewhere (a comd_tpu list carried
    over): the row of each local cell's slot 0 where the cell has rows,
    else R (so none of its slots has one).  A cell's valid rows are
    contiguous and in slot order, as every build makes them.  Equals
    ``nl_rows_plain``'s on every cell with rows."""
    dev = a_list.device
    n_rows = a_list.shape[0]
    rows = torch.arange(n_rows, dtype=torch.int32, device=dev)
    cell = torch.where(a_valid, a_list // A, n_local).to(torch.int64)
    start = torch.full((n_local + 1,), n_rows, dtype=torch.int32,
                       device=dev)
    start[cell] = rows - a_list % A
    return start[:n_local]


def slot_rows(row_start, n_atoms, n_cells: int, A: int, n_rows: int):
    """The row of every slot of cells [0, n_cells) (``row_start`` and
    ``n_atoms`` indexed by cell) and whether it has one: ([n_cells, A]
    int64 clamped into [0, R), [n_cells, A] bool)."""
    slot = torch.arange(A, device=n_atoms.device)
    row = row_start[:n_cells, None].to(torch.int64) + slot
    has = (slot < n_atoms[:n_cells, None].clamp(0, A)) & (row < n_rows)
    return row.clamp(0, max(n_rows - 1, 0)), has


def _rows(segs):
    """Row segments as one tensor over the rows (the last dimension)."""
    segs = tuple(segs)
    return segs[0] if len(segs) == 1 else torch.cat(segs, dim=-1)


def embed_rows_plain(f_eval, nlist: NeighborList, n_atoms, rho, phi,
                     n_local: int, B: int, halo_src=None,
                     e_dtype=torch.float64):
    """Pass 2 on the rows of a list (ER's plain version): (dfEmbed [B, A],
    U [R] | None).  ``rho`` (and ``phi``, None without the energy terms)
    are the rows' density (pair energy) as a tuple of row segments.  Local
    slot (c, s) gets F'(rho[row]) of its row, a slot without one 0; halo
    cell h gets its serial source's values, ``halo_src[h - n_local]``, or 0
    without ``halo_src`` (a mesh transport fills it).  U = 0.5 phi +
    F(rho) in ``e_dtype`` on valid rows, 0 on the others."""
    rho = _rows(rho)
    A = nlist.last_r.shape[2]
    f_emb, df = f_eval(rho)
    row, has = slot_rows(nlist.row_start, n_atoms, n_local, A,
                         rho.shape[0])
    dfe = df.new_zeros((B, A))
    dfe[:n_local] = torch.where(has, df[row], torch.zeros((), dtype=df.dtype,
                                                          device=df.device))
    if halo_src is not None:
        dfe[n_local:] = torch.index_select(dfe, 0, halo_src)
    if phi is None:
        return dfe, None
    u = 0.5 * _rows(phi).to(e_dtype) + f_emb.to(e_dtype)
    return dfe, torch.where(nlist.a_valid, u, torch.zeros(
        (), dtype=e_dtype, device=u.device))


def land_rows_plain(f, p, nlist: NeighborList, n_atoms, parts, n_local_out,
                    n_local: int, kick=None, add: bool = False) -> None:
    """The landing of a list force (LR's plain version), in place: ``parts``
    the force's passes (EAM's f1 and f3, added row by row; LJ's f), each a
    tuple of [3, R_s] row segments.  Local slot (c, s) of ``f`` [3, B, A]
    gets its row's force, every other slot 0; then, with ``kick``, the
    half kick ``p += kick * f`` and ``n_local_out`` the local atoms of
    ``n_atoms`` (added to its value with ``add``)."""
    rows = _rows(parts[0])
    for more in parts[1:]:
        rows = rows + _rows(more)
    A = f.shape[2]
    row, has = slot_rows(nlist.row_start, n_atoms, n_local, A, rows.shape[1])
    f[:, :n_local] = torch.where(has, rows[:, row], torch.zeros(
        (), dtype=rows.dtype, device=rows.device))
    f[:, n_local:] = 0
    if kick is None:
        return
    p.add_(kick * f)
    count = n_atoms[:n_local].sum(dtype=torch.int32)
    n_local_out.copy_(n_local_out + count if add else count)


def slice_rows(nlist: NeighborList, start: int, stop: int) -> NeighborList:
    """Row-range view of a NeighborList (shares last_r)."""
    return NeighborList(a_list=nlist.a_list[start:stop],
                        a_valid=nlist.a_valid[start:stop],
                        nl=nlist.nl[start:stop], last_r=nlist.last_r,
                        row_start=nlist.row_start)


def _rows_a_chunk(per_row_bytes: int) -> int:
    return max(1, PLAIN_BUDGET // max(1, per_row_bytes))


def candidate_lists(r, a_list, a_valid, nbr_map, *, k: int, rcut2: float):
    """The first ``k`` j of each row inside rcut2, in candidate order, and
    the row's full count (NL1's plain version): (nl [R, k] int32, count
    [R] int32).  ``nbr_map`` is [n_local, 27] int32; invalid rows get an
    all-padding list and count 0."""
    B, A = r.shape[1], r.shape[2]
    r_flat = r.reshape(3, B * A)
    n_rows = a_list.shape[0]
    n_local = nbr_map.shape[0]
    rc2 = as_dtype(rcut2, r.dtype)
    dev = r.device
    slot = torch.arange(A, device=dev, dtype=torch.int64)
    nl = torch.empty((n_rows, k), dtype=torch.int32, device=dev)
    count = torch.empty(n_rows, dtype=torch.int32, device=dev)
    chunk = _rows_a_chunk(27 * A * (40 + 8 * r.element_size()))
    for c0 in range(0, n_rows, chunk):
        rows = a_list[c0:c0 + chunk].to(torch.int64)
        valid = a_valid[c0:c0 + chunk]
        C = rows.shape[0]
        box = (rows // A).clamp(0, n_local - 1)
        cand = (nbr_map[box].to(torch.int64)[:, :, None] * A
                + slot).reshape(C, 27 * A)              # [C, 27A]
        dr = r_flat[:, rows][:, :, None] - r_flat[:, cand]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        hit = (r2 <= rc2) & (r2 > 0) & valid[:, None]
        count[c0:c0 + C] = hit.sum(dim=1, dtype=torch.int32)
        # stable compaction: the hits' ranks in candidate order; hits past
        # k and non-hits land in a dump column cut off below
        pos = torch.cumsum(hit, 1) - 1
        dest = torch.where(hit & (pos < k), pos, k)
        out = rows[:, None].expand(C, k + 1).clone()
        out.scatter_(1, dest, cand)
        nl[c0:c0 + C] = out[:, :k]
    return nl, count


def build(geom: CellGeometry, nbr_map, r, n_atoms, *, k: int, rcut2: float,
          n_rows: int, row_split=None):
    """Build the neighbor list in plain PyTorch: (NeighborList, overflow),
    ``overflow`` a 0-dim bool, true when some valid row has more than ``k``
    entries.  ``row_split`` (row_split_for) orders rows interior first, as
    -a 1 sweeps them."""
    a_list, a_valid, row_start = nl_rows_plain(geom, n_atoms, r.shape[2],
                                               n_rows, row_split)
    nl, count = candidate_lists(r, a_list, a_valid, nbr_map, k=k,
                                rcut2=rcut2)
    return (NeighborList(a_list=a_list, a_valid=a_valid, nl=nl, last_r=r,
                         row_start=row_start),
            ((count > k) & a_valid).any())


def needs_rebuild(last_r, r: torch.Tensor, n_local: int,
                  skin: float) -> torch.Tensor:
    """Any local atom displaced more than skin/2 since the last build or
    rebucket (neighborList.c:212-247).  ``last_r`` may be a NeighborList or
    a [3, B, A] snapshot.  Returns a 0-dim bool tensor on r's device."""
    if isinstance(last_r, NeighborList):
        last_r = last_r.last_r
    d = r[:, :n_local] - last_r[:, :n_local]
    disp2 = d[0] ** 2 + d[1] ** 2 + d[2] ** 2
    return disp2.max() > (0.5 * skin) ** 2


def pair_sweep_nl(nlist: NeighborList, r, pair_fn, rcut2: float, *,
                  scalar_j=()):
    """Neighbor-list pair sweep (NL2's plain version), with the
    cell_pair_sweep pair-function contract: ``pair_fn(r2, mask, sj, si)``
    gets [C, K] pair tensors and returns (fcoef, scalars).  Returns per-ROW
    outputs (force [3, R], [scalars [R] ...]), zero on invalid rows; the
    caller lands them in the cell layout (``embed_rows_plain``,
    ``land_rows_plain``; ``scatter_rows`` is comd_tpu's form)."""
    B, A = r.shape[1], r.shape[2]
    r_flat = r.reshape(3, B * A)
    rc2 = as_dtype(rcut2, r.dtype)
    n_rows, k = nlist.nl.shape
    sj_flat = [s.reshape(-1) for s in scalar_j]
    forces, scal = [], []
    chunk = _rows_a_chunk(k * (16 + 24 * r.element_size()))
    for c0 in range(0, n_rows, chunk):
        rows = nlist.a_list[c0:c0 + chunk].to(torch.int64)
        nl_c = nlist.nl[c0:c0 + chunk].to(torch.int64)
        valid = nlist.a_valid[c0:c0 + chunk]
        dr = r_flat[:, rows][:, :, None] - r_flat[:, nl_c]    # [3, C, K]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        mask = (r2 <= rc2) & (r2 > 0) & valid[:, None]
        sj = [s[nl_c] for s in sj_flat]
        si = [s[rows][:, None] for s in sj_flat]
        fcoef, scalars = pair_fn(r2, mask, sj, si)
        forces.append((fcoef[None] * dr).sum(dim=-1))
        scal.append([s.sum(dim=-1) for s in scalars])
    force = torch.cat(forces, dim=1)
    return force, [torch.cat([c[q] for c in scal])
                   for q in range(len(scal[0]))]


def scatter_rows(nlist: NeighborList, vals, B: int, A: int,
                 fill: float = 0.0):
    """Per-row values [..., R] to the dense [..., B, A] layout; invalid rows
    are dropped (into a spare last slot that is cut off)."""
    dest = torch.where(nlist.a_valid, nlist.a_list.to(torch.int64), B * A)
    out = torch.full(vals.shape[:-1] + (B * A + 1,), fill, dtype=vals.dtype,
                     device=vals.device)
    out.index_copy_(vals.dim() - 1, dest, vals)
    return out[..., :B * A].reshape(vals.shape[:-1] + (B, A))
