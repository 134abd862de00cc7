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
(``scatter_rows`` drops those rows), so lists compare on valid rows.

Between rebuilds the cell layout is frozen: ghosts are refreshed by
slot-aligned position copies and only the skin trigger rebuckets.

``build`` and ``pair_sweep_nl`` here are the plain versions of the CUDA
kernels NL1 and NL2 (ops/cuda/nl.py, csrc/nl.cu), which compute the same
lists bit for bit and the same sums in another order.  The compaction is
a cumsum in candidate order (comd_tpu's stable ``lax.top_k`` over a 0/1
mask keeps the same first K).  comd_tpu's chunking by ``nl_chunk`` rows and
its top_k VMEM budget were TPU limits: the plain versions chunk by a memory
budget instead.
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


def atom_rows(geom: CellGeometry, n_atoms, A: int, n_rows: int,
              row_split=None):
    """(a_list, a_valid) of a build: all local atoms, or with
    ``row_split`` (row_split_for) interior rows first."""
    if row_split is not None:
        a_list, a_valid, _n = build_atom_list_split(geom, n_atoms, A,
                                                    row_split)
    else:
        a_list, a_valid, _n = build_atom_list(geom, n_atoms, A, n_rows)
    return a_list, a_valid


def cell_row_starts(a_list, a_valid, n_local: int, A: int):
    """The row of each local cell's slot 0 in a compacted row layout, where
    a cell's valid rows are contiguous and in slot order (``atom_rows``,
    with or without the row split): [n_local] int32, 0 for a cell without
    rows.  NL1 gives each cell one block over rows row_start[c] + slot.
    Torch ops on a_list's device, no host sync; every valid row of a cell
    writes the same value."""
    dev = a_list.device
    rows = torch.arange(a_list.shape[0], dtype=torch.int32, device=dev)
    cell = torch.where(a_valid, a_list // A, n_local).to(torch.int64)
    start = torch.zeros(n_local + 1, dtype=torch.int32, device=dev)
    start[cell] = rows - a_list % A
    return start[:n_local]


def slice_rows(nlist: NeighborList, start: int, stop: int) -> NeighborList:
    """Row-range view of a NeighborList (shares last_r)."""
    return NeighborList(a_list=nlist.a_list[start:stop],
                        a_valid=nlist.a_valid[start:stop],
                        nl=nlist.nl[start:stop], last_r=nlist.last_r)


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
    a_list, a_valid = atom_rows(geom, n_atoms, r.shape[2], n_rows, row_split)
    nl, count = candidate_lists(r, a_list, a_valid, nbr_map, k=k,
                                rcut2=rcut2)
    return (NeighborList(a_list=a_list, a_valid=a_valid, nl=nl, last_r=r),
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
    caller scatters them to slots with ``scatter_rows``."""
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
