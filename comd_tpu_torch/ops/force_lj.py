"""Lennard-Jones force and energy over link cells.

Physics of the reference CPU oracle (ljForceCpuNL, src-mpi/ljForce.c:
146-265), as comd_tpu.ops.force_lj computes it:

  e_pair = r6*(r6-1) - eShift          (unscaled; x 4*epsilon at the end)
  f_i   += 4*eps*r6*invr2*(12*r6-6) * (r_i - r_j)

``lj_force`` sweeps the full 27-cell shell on K1 (every pair visited from
both sides, energy halved), and ``lj_force_split`` in two launches, the
interior and the boundary cells (-a 1 on a mesh); ``lj_force_interp`` does
so from the -I
1000-point quadratic table of the shifted energy (comd_tpu's
lj_force_interp, gpu_utility.c:348-374), on K1's LJ-table variant;
``lj_force_half``  evaluates each pair once on
K2 and folds the halo rows back to their owners; ``lj_force_nl`` and
``lj_force_nl_split`` sweep Verlet lists on NL2 (the *_nl methods and the
-L pairlist).  All run the CUDA kernels of ops/cuda on CUDA tensors and
their plain PyTorch versions on CPU tensors, over the shards of a mesh
(as in ops/force_eam.py: the cell paths take the shards' stack and launch
once over it, the list paths a list a shard; a single domain is a mesh of
one).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..potentials.lj import LjPotential
from ..potentials.tables import as_dtype
from . import neighborlist as nlmod
from .cuda import nl, require_stack, stencil
from .cuda.stencil import PairEvaluator


def make_lj_evaluator(pot: LjPotential, dtype: torch.dtype) -> PairEvaluator:
    """The LJ pair constants rounded to ``dtype``, as comd_tpu rounds them
    (``dtype.type(...)`` in make_lj_pair_fn)."""
    return PairEvaluator(
        kind="lj", dtype=dtype, rcut2=as_dtype(pot.cutoff * pot.cutoff, dtype),
        s6=as_dtype(pot.s6, dtype), eps4=as_dtype(4.0 * pot.epsilon, dtype),
        e_shift=as_dtype(pot.e_shift, dtype))


#: intervals of the -I table (initLJinterpolation, gpu_utility.c:348-374)
LJ_TABLE_N = 1000


def lj_table(pot: LjPotential) -> tuple:
    """The -I table as comd_tpu's lj_force_interp builds it, in f64:
    (values [n+3], n, x0 = sigma/2, inv_dx = n / (rcut - x0)), values[i] =
    4 eps (r6 (r6 - 1) - e_shift) at r = x0 + (i - 1) / inv_dx."""
    n = LJ_TABLE_N
    x0 = 0.5 * pot.sigma
    inv_dx = n / (pot.cutoff - x0)
    x = x0 + (np.arange(n + 3) - 1) / inv_dx
    r2x = 1.0 / (x * x)
    r6x = pot.s6 * r2x ** 3
    return (4.0 * pot.epsilon * (r6x * (r6x - 1.0) - pot.e_shift), n, x0,
            inv_dx)


def make_lj_table_evaluator(pot: LjPotential, dtype: torch.dtype,
                            device) -> PairEvaluator:
    """The -I evaluator: ``lj_table`` rounded once to ``dtype`` and padded
    to [n+4] with its last value, because the 4-point stencil at the
    clamped index n (r at the cutoff) reads entry n+3, which comd_tpu's
    clamped gather reads as the last entry."""
    vals, n, x0, inv_dx = lj_table(pot)
    pad4 = np.concatenate([vals, vals[-1:]])
    return PairEvaluator(
        kind="lj_table", dtype=dtype,
        rcut2=as_dtype(pot.cutoff * pot.cutoff, dtype),
        phi=torch.as_tensor(pad4, dtype=dtype, device=device), n=n,
        x0=as_dtype(x0, dtype), inv_dx=as_dtype(inv_dx, dtype))


def _energy(pot: LjPotential, e, e_dtype):
    # the atom sum counts every pair twice (full sweep, or both deliveries
    # of the half sweep) -> x0.5, then the global 4*epsilon (ljForce.c:
    # 256-261)
    return (0.5 * 4.0 * pot.epsilon) * e.to(e_dtype)


def shard_sums(u: torch.Tensor) -> torch.Tensor:
    """[S] each shard's own sum of the stack ``u`` [S, ...], in shard
    order (the bits of the shard's sum alone)."""
    return torch.stack([u[s].sum() for s in range(u.shape[0])])


def _stacked(u):
    return (u, shard_sums(u)) if u is not None else (None, None)


def lj_force(nbr_map: torch.Tensor, pot: LjPotential, rs: torch.Tensor,
             ev: PairEvaluator, *, e_dtype: torch.dtype = torch.float64,
             want_energy: bool = True, box_chunk: int = 256):
    """LJ on K1 for every shard of the stack ``rs`` [S, 3, B, A], one
    launch.  Returns (force [S, 3, n_local, A], U [S, n_local, A] | None,
    ePot a shard [S] | None); U and ePot in ``e_dtype``."""
    require_stack("the positions", rs, 4)
    f, e = stencil.lj_pass(rs, nbr_map, ev, want_energy=want_energy,
                           box_chunk=box_chunk)
    return (f,) + _stacked(_energy(pot, e, e_dtype) if want_energy
                           else None)


def lj_force_split(nbr_map: torch.Tensor, pot: LjPotential,
                   rs: torch.Tensor, ev: PairEvaluator, interior,
                   boundary, *,
                   r_pre: Optional[torch.Tensor] = None,
                   e_dtype: torch.dtype = torch.float64,
                   want_energy: bool = True, box_chunk: int = 256):
    """``lj_force`` with the interior/boundary split (-a 1 of the cell
    methods on a mesh, comd_tpu's lj_force_split): K1 over the interior
    cells (binning.BoxSubset ``interior``) on the pre-exchange positions
    ``r_pre`` and over the boundary cells on ``rs``, each one launch over
    the stack; each launch's outputs are zero outside its subset, so they
    add up to comd_tpu's scatter.  Analytic LJ always (``ev`` of kind
    "lj"): comd_tpu's sharded dispatch takes the split before -I.  Returns
    what lj_force does."""
    r_pre = rs if r_pre is None else r_pre
    require_stack("the positions", rs, 4)
    require_stack("r_pre", r_pre, 4)
    kw = dict(want_energy=want_energy, box_chunk=box_chunk)
    f_i, e_i = stencil.lj_pass(r_pre, nbr_map, ev, boxes=interior, **kw)
    f_b, e_b = stencil.lj_pass(rs, nbr_map, ev, boxes=boundary, **kw)
    return (f_i + f_b,) + _stacked(_energy(pot, e_i + e_b, e_dtype)
                                   if want_energy else None)


def lj_force_interp(nbr_map: torch.Tensor, rs: torch.Tensor,
                    ev: PairEvaluator, *,
                    e_dtype: torch.dtype = torch.float64,
                    want_energy: bool = True, box_chunk: int = 256):
    """Table-interpolated LJ (-I, comd_tpu's lj_force_interp) on K1 for
    every shard of the stack, ``ev`` from ``make_lj_table_evaluator``.
    The table carries 4 eps and the shift, so U = 0.5 e (the atom sum
    counts every pair twice).  comd_tpu computes the energy on every step;
    here only when ``want_energy``, as for analytic LJ (the printed rows
    are the same).  Returns what lj_force does."""
    require_stack("the positions", rs, 4)
    f, e = stencil.lj_pass(rs, nbr_map, ev, want_energy=want_energy,
                           box_chunk=box_chunk)
    return (f,) + _stacked(0.5 * e.to(e_dtype) if want_energy else None)


def lj_force_half(half_nbr_map: torch.Tensor, pot: LjPotential,
                  rs: torch.Tensor, ev: PairEvaluator,
                  fold: Callable, *, e_dtype: torch.dtype = torch.float64,
                  want_energy: bool = True, box_chunk: int = 256):
    """LJ on K2 for every shard of the stack, each pair evaluated once, one
    launch; ``fold`` maps the dense [S, .., B, A] contributions to [S, ..,
    n_local, A] (the mesh's halo fold, run over all shards).  Returns what
    lj_force does."""
    require_stack("the positions", rs, 4)
    fd, ed = stencil.lj_pass_half(rs, half_nbr_map, ev,
                                  want_energy=want_energy,
                                  box_chunk=box_chunk)
    f = fold(fd)
    return (f,) + _stacked(_energy(pot, fold(ed), e_dtype) if want_energy
                           else None)


def _nl_result(pot: LjPotential, nlist, n_atoms, f_rows, e_rows, e_dtype):
    """Per-row sweep results to (RowForce, U [R] | None, ePot | None); no
    dense field is built (``land_rows`` lands the force).  ``f_rows`` and
    ``e_rows`` are tuples of row segments; the energy's are joined on
    energy steps only, so that ePot is one sum over the rows."""
    force = nlmod.RowForce(nlist, n_atoms, (tuple(f_rows),))
    if e_rows is None:
        return force, None, None
    e = e_rows[0] if len(e_rows) == 1 else torch.cat(e_rows)
    u = _energy(pot, e, e_dtype)        # zero on invalid rows
    return force, u, u.sum()


def lj_force_nl(nlists: Sequence[nlmod.NeighborList], pot: LjPotential,
                rs: Sequence[torch.Tensor], ev: PairEvaluator, *,
                n_atoms: Sequence[torch.Tensor],
                e_dtype: torch.dtype = torch.float64,
                want_energy: bool = True):
    """LJ over Verlet lists (ljForceCpuNL, ljForce.c:146-265; the -L
    pairlist) on NL2 for every shard (``n_atoms``: the counts by cell the
    lists were built from).  Returns, per shard, (RowForce, U [R] | None,
    ePot | None)."""
    out = []
    for lst, r, n in zip(nlists, rs, n_atoms):
        f, e = nl.lj_pass(lst, r, ev, want_energy=want_energy)
        out.append(_nl_result(pot, lst, n, (f,),
                              None if e is None else (e,), e_dtype))
    return out


def lj_force_nl_split(nlists: Sequence[nlmod.NeighborList], pot: LjPotential,
                      rs: Sequence[torch.Tensor], ev: PairEvaluator,
                      n_rows_interior: int, *,
                      n_atoms: Sequence[torch.Tensor],
                      r_pre: Optional[Sequence[torch.Tensor]] = None,
                      e_dtype: torch.dtype = torch.float64,
                      want_energy: bool = True):
    """``lj_force_nl`` with the interior/boundary row split (-a 1): the
    interior rows [0, Ri) sweep the pre-exchange positions ``r_pre``, the
    boundary rows the refreshed ones; the two sweeps' rows stay segments.
    Lists built with row_split."""
    r_pre = rs if r_pre is None else r_pre
    out = []
    for lst, r, rp, n in zip(nlists, rs, r_pre, n_atoms):
        n_rows = lst.a_list.shape[0]
        f_i, e_i = nl.lj_pass(nlmod.slice_rows(lst, 0, n_rows_interior), rp,
                              ev, want_energy=want_energy)
        f_b, e_b = nl.lj_pass(nlmod.slice_rows(lst, n_rows_interior, n_rows),
                              r, ev, want_energy=want_energy)
        out.append(_nl_result(pot, lst, n, (f_i, f_b),
                              (e_i, e_b) if want_energy else None, e_dtype))
    return out
