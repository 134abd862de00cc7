"""Cell pair sweeps in plain PyTorch (the cell-stencil kernels' plain
versions).

``cell_pair_sweep`` ports comd_tpu.ops.sweep.cell_pair_sweep, the gather
form over ``geom.nbr_map``: for a chunk of C cells it materializes the pair
geometry [C, A, 27A] and reduces over the j axis.  ``cell_pair_sweep_half``
is the Newton's-3rd-law half sweep in the same gather form over the
14-column half map, and ``fold_halo_serial`` folds its halo rows back to
their owners.  Empty slots carry the far-away EMPTY_POS sentinel, so the
cutoff mask removes them without occupancy branches.  The CUDA kernels
(csrc/stencil.cu) compute the same sums; these versions run the CPU tensors
and are the card's comparison reference.  comd_tpu's other sweep
formulations (dense slices, windows, transposed stencils, the half sweep's
overlap-added chunk spills and locality plane) exist for TPU layout
reasons and are not ported.  The fold runs on csrc/comm.cu's ``fold_halo``
(ops/cuda/comm.py) on the card and on its plain version on the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..potentials.tables import as_dtype
from .cuda import comm


def cell_pair_sweep(
    r: torch.Tensor,                   # [3, B, A]
    nbr_map: torch.Tensor,             # [n_local, 27] int32
    pair_fn: Callable,                 # (r2, mask, sj, si) -> (fcoef, scalars)
    rcut2: float,
    *,
    scalar_j: Sequence[torch.Tensor] = (),   # per-atom fields [B, A]
    chunk: int = 256,
    boxes: Optional[torch.Tensor] = None,    # [n] int64 local box ids
):
    """Run ``pair_fn`` over all (atom i, 27-cell neighbor j) pairs of every
    local cell, or of the cells ``boxes`` only.

    ``pair_fn(r2, mask, sj, si)`` receives the squared distances
    [C, A, 27A], the validity mask, each per-atom field gathered at the j
    atoms ([C, 1, 27A]) and at the i atoms ([C, A, 1]); it returns
    ``(fcoef, scalars)``: ``fcoef`` multiplies dr = r_i - r_j and is summed
    into the force on i, each entry of ``scalars`` is summed over j.

    Returns (force [3, n, A], [scalars [n, A] ...]), n = n_local or one
    row per entry of ``boxes``.  Every cell's sums are independent of
    ``chunk``, which only bounds memory, and of the other cells swept.
    """
    A = r.shape[-1]
    n = nbr_map.shape[0] if boxes is None else boxes.shape[0]
    rc2 = as_dtype(rcut2, r.dtype)
    chunk = max(1, chunk)
    forces, scalars_out = [], []
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        C = c1 - c0
        rows = slice(c0, c1) if boxes is None else boxes[c0:c1]
        nbr = nbr_map[rows].to(torch.int64)             # [C, 27]
        ri = r[:, rows]                                 # [3, C, A]
        rj = r[:, nbr].reshape(3, C, 27 * A)
        dr = ri[:, :, :, None] - rj[:, :, None, :]      # [3, C, A, 27A]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        mask = (r2 <= rc2) & (r2 > 0)
        sj = [s[nbr].reshape(C, 1, 27 * A) for s in scalar_j]
        si = [s[rows][:, :, None] for s in scalar_j]
        fcoef, scalars = pair_fn(r2, mask, sj, si)
        forces.append((fcoef[None] * dr).sum(dim=-1))   # [3, C, A]
        scalars_out.append([s.sum(dim=-1) for s in scalars])
    force = torch.cat(forces, dim=1)
    scalars = [torch.cat([c[k] for c in scalars_out], dim=0)
               for k in range(len(scalars_out[0]))]
    return force, scalars


def cell_pair_sweep_half(
    r: torch.Tensor,                   # [3, B, A]
    half_nbr_map: torch.Tensor,        # [n_local, 14] int32, self first
    pair_fn: Callable,                 # (r2, mask, sj, si) -> (fcoef, scalars)
    rcut2: float,
    *,
    scalar_j: Sequence[torch.Tensor] = (),   # per-atom fields [B, A]
    chunk: int = 256,
):
    """Half-shell sweep: every unordered pair within the cutoff evaluated
    once and delivered to both atoms.

    The i atoms are those of the LOCAL cells only; their j partners are the
    slots of the 14 half-map cells (the self cell with ``slot_i < slot_j``,
    applied on top of the cutoff mask, then 13 offsets, one of each +/-
    pair).  Each unordered pair -- counting a halo image as its own
    partner -- is then swept exactly once.  ``pair_fn`` has the
    ``cell_pair_sweep`` contract (j fields [C, 1, 14A], i fields [C, A, 1]);
    its scalars must be symmetric (phi, rho, the LJ pair energy): the i side
    receives ``+fcoef * dr`` and the scalars summed over j, the j side
    ``-fcoef * dr`` and the same scalars summed over i, added at the j
    cell's box id.

    Returns DENSE contributions on every box, local and halo:
    (force [3, B, A], [scalars [B, A] ...]).  Halo rows hold what belongs
    to their source cells; ``fold_halo_serial`` delivers it.
    """
    B, A = r.shape[1], r.shape[2]
    n_local, n_half = half_nbr_map.shape
    rc2 = as_dtype(rcut2, r.dtype)
    chunk = max(1, chunk)
    self_ok = torch.ones((A, n_half * A), dtype=torch.bool, device=r.device)
    self_ok[:, :A] = torch.triu(self_ok[:, :A], diagonal=1)  # slot_i < slot_j
    force = torch.zeros_like(r)
    scalars = None
    for c0 in range(0, n_local, chunk):
        c1 = min(c0 + chunk, n_local)
        C = c1 - c0
        nbr = half_nbr_map[c0:c1].to(torch.int64)       # [C, 14]
        ri = r[:, c0:c1]                                # [3, C, A]
        rj = r[:, nbr].reshape(3, C, n_half * A)
        dr = ri[:, :, :, None] - rj[:, :, None, :]      # [3, C, A, 14A]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        mask = self_ok & (r2 <= rc2) & (r2 > 0)
        sj = [s[nbr].reshape(C, 1, n_half * A) for s in scalar_j]
        si = [s[c0:c1][:, :, None] for s in scalar_j]
        fcoef, sc = pair_fn(r2, mask, sj, si)
        if scalars is None:
            scalars = [torch.zeros((B, A), dtype=r.dtype, device=r.device)
                       for _ in sc]
        prods = fcoef[None] * dr                         # [3, C, A, 14A]
        force[:, c0:c1] += prods.sum(dim=-1)
        fj = -prods.sum(dim=-2).reshape(3, C * n_half, A)
        force.index_add_(1, nbr.reshape(-1), fj)
        for out, s in zip(scalars, sc):
            out[c0:c1] += s.sum(dim=-1)
            out.index_add_(0, nbr.reshape(-1),
                           s.sum(dim=-2).reshape(C * n_half, A))
    return force, scalars or []


def fold_plan_serial(maps, x: torch.Tensor) -> comm.FoldPlan:
    """The serial fold's plan for fields like ``x`` ([B, A] or [3, B,
    A]), made once (kept on ``maps.images``): every local cell that halo
    images mirror gets them added in ascending halo row, the order in
    which comd_tpu's scatter-add and the CPU ``index_add_`` add them."""
    im = maps.images
    key = (tuple(x.shape), x.dtype)
    plan = im.fold_plans.get(key)
    if plan is None:
        start = im.start.cpu().numpy()
        rows = im.row.cpu().numpy()
        dst = np.repeat(np.arange(im.n_local), np.diff(start))
        zero = np.zeros(rows.size, np.int64)
        plan = im.fold_plans[key] = comm.FoldPlan(
            comm.FoldMap(zero, dst, zero, rows), x.shape, x.dtype, x.device,
            1)
    return plan


def fold_halo_serial(geom, maps, x: torch.Tensor) -> torch.Tensor:
    """Fold halo-row contributions back into their owner cells (serial
    periodic case), in place on ``x`` [..., n_total, A] (the caller's
    fresh sweep output); returns its local rows [..., n_local, A], a view.
    A local cell that several halo images mirror receives all of them, in
    ascending halo row, each add rounded alone (one ``fold_halo`` launch
    on the card; its plain version, image rank by image rank, on the
    CPU).  Port of comd_tpu.ops.sweep.fold_halo_serial, the half-shell
    force exchange."""
    comm.fold_halo(fold_plan_serial(maps, x), [x])
    return x[..., :geom.n_local, :]
