"""27-neighbor-cell pair sweep in plain PyTorch (the cell-stencil kernel's
plain version).

Port of comd_tpu.ops.sweep.cell_pair_sweep, the gather form over
``geom.nbr_map``: for a chunk of C cells it materializes the pair geometry
[C, A, 27A] and reduces over the j axis.  Empty slots carry the far-away
EMPTY_POS sentinel, so the cutoff mask removes them without occupancy
branches.  The CUDA kernel (csrc/stencil.cu) computes the same sums; this
version runs the CPU tensors and is the card's comparison reference.
comd_tpu's other sweep formulations (dense slices, windows, transposed
stencils) exist for TPU layout reasons and are not ported.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..potentials.tables import as_dtype


def cell_pair_sweep(
    r: torch.Tensor,                   # [3, B, A]
    nbr_map: torch.Tensor,             # [n_local, 27] int32
    pair_fn: Callable,                 # (r2, mask, sj, si) -> (fcoef, scalars)
    rcut2: float,
    *,
    scalar_j: Sequence[torch.Tensor] = (),   # per-atom fields [B, A]
    chunk: int = 256,
):
    """Run ``pair_fn`` over all (atom i, 27-cell neighbor j) pairs of every
    local cell.

    ``pair_fn(r2, mask, sj, si)`` receives the squared distances
    [C, A, 27A], the validity mask, each per-atom field gathered at the j
    atoms ([C, 1, 27A]) and at the i atoms ([C, A, 1]); it returns
    ``(fcoef, scalars)``: ``fcoef`` multiplies dr = r_i - r_j and is summed
    into the force on i, each entry of ``scalars`` is summed over j.

    Returns (force [3, n_local, A], [scalars [n_local, A] ...]).  Every
    cell's sums are independent of ``chunk``, which only bounds memory.
    """
    A = r.shape[-1]
    n_local = nbr_map.shape[0]
    rc2 = as_dtype(rcut2, r.dtype)
    chunk = max(1, chunk)
    forces, scalars_out = [], []
    for c0 in range(0, n_local, chunk):
        c1 = min(c0 + chunk, n_local)
        C = c1 - c0
        nbr = nbr_map[c0:c1].to(torch.int64)            # [C, 27]
        ri = r[:, c0:c1]                                # [3, C, A]
        rj = r[:, nbr].reshape(3, C, 27 * A)
        dr = ri[:, :, :, None] - rj[:, :, None, :]      # [3, C, A, 27A]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        mask = (r2 <= rc2) & (r2 > 0)
        sj = [s[nbr].reshape(C, 1, 27 * A) for s in scalar_j]
        si = [s[c0:c1][:, :, None] for s in scalar_j]
        fcoef, scalars = pair_fn(r2, mask, sj, si)
        forces.append((fcoef[None] * dr).sum(dim=-1))   # [3, C, A]
        scalars_out.append([s.sum(dim=-1) for s in scalars])
    force = torch.cat(forces, dim=1)
    scalars = [torch.cat([c[k] for c in scalars_out], dim=0)
               for k in range(len(scalars_out[0]))]
    return force, scalars
