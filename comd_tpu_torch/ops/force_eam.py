"""EAM three-pass force with the mid-force dfEmbed halo fill.

Algorithm per the reference (src-mpi/eam.c:44-86):

  pass 1 (pairs): U_i += 0.5*phi(r_ij); rhobar_i += rho(r_ij);
                  f_i -= phi'(r_ij) * rhat
  pass 2 (atoms): U_i += F(rhobar_i); dfEmbed_i = F'(rhobar_i)
  -- halo fill of dfEmbed (haloExchange(forceExchange), eam.c:241/370) --
  pass 3 (pairs): f_i -= (dfEmbed_i + dfEmbed_j) * rho'(r_ij) * rhat

Passes 1 and 3 run on the CUDA cell-stencil kernels (ops/cuda/stencil.py;
their plain PyTorch versions on CPU tensors), with the pair evaluator of
``make_pair_evaluator`` (Chebyshev, tables or the -P spline): the
full-shell K1 in
``eam_force`` (and, split into interior and boundary cells under -a 1 on a
mesh, in ``eam_force_split``) and the half-shell K2 in ``eam_force_half``;
over Verlet
lists (the *_nl methods) on the list sweep NL2 (ops/cuda/nl.py) in
``eam_force_nl`` and ``eam_force_nl_split``.  Pass 2 is
per-atom, 27x fewer evaluations than a pair pass: the direct quadratic
interpolation of F (eam.c:557-579), on the cell paths one ``embed_fill``
launch over every shard (ops/cuda/step.py: dfEmbed with its serial halo
fill or zero halo rows, and the masked U), on the lists' rows one
``embed_rows`` launch a shard (the same, from the rows: dfEmbed in the
cell layout, U a row).  The list forces stay per row
(``neighborlist.RowForce``) for the step's ``land_rows``.  These are
comd_tpu's eam_force_pallas contracts (half=False and half=True), taken
over the shards of a mesh.  On the cell paths every argument and result
that is per shard is one stack [S, ...] with the shard first, comd_tpu's
mesh layout (a single domain is a stack of one), and each pass is one
launch over it; a list of per-shard tensors raises.  The list paths take
a list with one entry per shard.  The halo fill and fold are the mesh's
exchanges, run once over all shards.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..potentials import tables
from ..potentials.eam import EamPotential
from . import neighborlist as nlmod
from .cuda import nl, require_stack, stencil, step
from .cuda.stencil import PairEvaluator


def make_pair_evaluator(pot: EamPotential, dtype: torch.dtype, device,
                        impl: str, spline: bool = False) -> PairEvaluator:
    """The pair evaluator, chosen as comd_tpu's make_evaluators chooses it:
    ``spline`` (-P) -> the cubic splines in r^2 of phi and rho, whatever
    ``interp_impl``; else "cheb" -> the Chebyshev fit, "rows"/"twolevel"
    -> the exact quadratic table interpolation."""
    rcut2 = tables.as_dtype(pot.cutoff * pot.cutoff, dtype)
    if impl == "cheb" and not spline:
        return PairEvaluator(kind="cheb", dtype=dtype, rcut2=rcut2,
                             cheb=pot.cheb_pair)
    if impl not in ("rows", "twolevel", "cheb"):
        raise ValueError(f"invalid interp_impl {impl!r}")
    if pot.phi.n != pot.rho.n or pot.phi.x0 != pot.rho.x0 or \
            pot.phi.inv_dx != pot.rho.inv_dx:
        raise ValueError("phi and rho tables must share one grid")
    if spline:
        # n and values exactly as comd_tpu (gpu_utility.c:498-500): the
        # padded table from values[0], so values[n] is readable
        sp = [tables.make_spline(t.padded[1:], t.n, t.x0, t.inv_dx)
              for t in (pot.phi, pot.rho)]
        c = tables.as_dtype
        return PairEvaluator(
            kind="spline", dtype=dtype, rcut2=rcut2,
            phi=torch.as_tensor(sp[0].coeffs, dtype=dtype, device=device),
            rho=torch.as_tensor(sp[1].coeffs, dtype=dtype, device=device),
            n=sp[0].n, x0=c(sp[0].x0, dtype), xn=c(sp[0].xn, dtype),
            inv_dx=c(sp[0].inv_dx, dtype),
            x0_inv_dx=c(sp[0].x0 * sp[0].inv_dx, dtype))
    return PairEvaluator(
        kind="table", dtype=dtype, rcut2=rcut2,
        phi=pot.phi.device_table(dtype, device),
        rho=pot.rho.device_table(dtype, device),
        n=pot.phi.n, x0=pot.phi.x0,
        inv_dx=tables.as_dtype(pot.phi.inv_dx, dtype))


def make_f_eval(pot: EamPotential, dtype: torch.dtype,
                device) -> tables.EmbedTable:
    """Pass-2 embedding evaluator F(rhobar) -> (F, dF/drhobar): the direct
    quadratic interpolation of the F table, whatever ``interp_impl`` the
    pair passes use (F is not Chebyshev-fit: rhobar's domain edge has
    sqrt-like curvature that a global fit handles poorly)."""
    return tables.EmbedTable(
        table=pot.f.device_table(dtype, device), n=pot.f.n, x0=pot.f.x0,
        inv_dx=tables.as_dtype(pot.f.inv_dx, dtype))


def _embed(f_eval, rs, phi, rhobar, n_atoms, halo_src, e_dtype):
    """Pass 2 of every shard, one ``step.embed_fill`` launch, from the
    stacks of its pair energy ``phi`` (None without the energy terms) and
    density ``rhobar`` ([S, n_local, A]): (dfEmbed [S, B, A], U [S,
    n_local, A] | None), the halo rows of dfEmbed F' of the serial sources
    ``halo_src`` or 0, U masked past each shard's ``n_atoms``."""
    return step.embed_fill(f_eval, rhobar, phi, n_atoms, rs.shape[2],
                           halo_src, e_dtype)


def _stacks(rs, n_atoms, r_pre=None):
    """The force's operands as the mesh's stacks: positions [S, 3, B, A],
    counts [S, B] (a list of per-shard tensors raises)."""
    require_stack("the positions", rs, 4)
    require_stack("n_atoms", n_atoms, 2)
    if r_pre is not None:
        require_stack("r_pre", r_pre, 4)


def eam_force(
    nbr_map: torch.Tensor,       # [n_local, 27] int32 on r's device
    rs: torch.Tensor,            # [S, 3, B, A] stack, halo cells filled
    ev: PairEvaluator,
    f_eval: tables.EmbedTable,   # make_f_eval
    fill_halo_scalar: Callable,  # (dfEmbed [S, B, A], rhobar [S, n_local,
                                 # A]) -> dfEmbed, halo rows filled
    *,
    n_atoms: torch.Tensor,       # [S, B] int32
    halo_src: Optional[torch.Tensor] = None,
    passes: bool = False,
    e_dtype: torch.dtype = torch.float64,
    want_energy: bool = True,
    box_chunk: int = 256,
):
    """The full-shell force of every shard of a mesh (a stack of one on a
    single domain), one launch a phase over the stack: pass 1, pass 2, the
    dfEmbed fill (the mesh's halo exchange), pass 3 -- comd_tpu's
    per-shard eam_force under shard_map, with the fill as its collective.
    ``fill_halo_scalar`` also gets the stack's rhobar, which the fused
    transport evaluates at its planes.  With ``halo_src`` (a single
    domain's periodic sources, ``maps.halo_src``) pass 2 fills the halo
    rows itself and ``fill_halo_scalar`` is not called.

    Returns (force [S, 3, n_local, A], U [S, n_local, A] | None, dfEmbed
    [S, B, A]), U 0 in the slots at or past each shard's ``n_atoms``.
    ``passes=True`` returns the force as its two passes (f1, f3) for the
    step's landing to add.  ``want_energy=False`` (dynamics-only steps
    between reporting boundaries) skips the phi-value work and returns
    U=None.  ``box_chunk`` only chunks the plain version (CPU tensors).
    """
    _stacks(rs, n_atoms)
    f1, phi, rhobar = stencil.eam_pass1(rs, nbr_map, ev,
                                        want_energy=want_energy,
                                        box_chunk=box_chunk)
    # pass 2 (eam.c:351-366): every slot gets F(rhobar); empty slots are
    # masked past n_atoms
    dfe, u = _embed(f_eval, rs, phi, rhobar, n_atoms, halo_src, e_dtype)
    if halo_src is None:
        dfe = fill_halo_scalar(dfe, rhobar)
    f3 = stencil.eam_pass3(rs, nbr_map, ev, dfe, box_chunk=box_chunk)
    return (f1, f3) if passes else f1 + f3, u, dfe


def eam_force_split(
    nbr_map: torch.Tensor,       # [n_local, 27] int32 of a GeomMaps
    rs: torch.Tensor,            # [S, 3, B, A] post-exchange
    ev: PairEvaluator,
    f_eval: tables.EmbedTable,
    fill_halo_scalar: Callable,  # as in eam_force
    interior,                    # binning.BoxSubset: cells reading no halo
    boundary,                    # binning.BoxSubset: the other local cells
    *,
    r_pre: Optional[torch.Tensor] = None,
    n_atoms: torch.Tensor,       # [S, B] int32
    passes: bool = False,
    e_dtype: torch.dtype = torch.float64,
    want_energy: bool = True,
    box_chunk: int = 256,
):
    """``eam_force`` with the interior/boundary split (-a 1 of the cell
    methods on a mesh; the reference's timestep.c:257-265, comd_tpu's
    eam_force_split): K1 sweeps the interior cells of every shard on the
    pre-exchange positions ``r_pre`` and the boundary cells on ``rs``, two
    launches a pass over the stack.  Interior cells read no halo cell, so
    their pass 3 runs on the pre-fill dfEmbed, before the fill; the
    boundary's after it.  Each subset's outputs are zero outside it, so
    their sum is comd_tpu's scatter of the two lists.  Pass 2 is per slot
    and runs once on the summed rhobar (the same numbers as per subset).
    On one stream nothing overlaps; the split keeps comd_tpu's data flow.
    Returns what eam_force does (``passes``: f1 and the two pass-3
    subsets' sum)."""
    r_pre = rs if r_pre is None else r_pre
    _stacks(rs, n_atoms, r_pre)
    kw = dict(want_energy=want_energy, box_chunk=box_chunk)
    f_i, phi_i, rho_i = stencil.eam_pass1(r_pre, nbr_map, ev, boxes=interior,
                                          **kw)
    f_b, phi_b, rho_b = stencil.eam_pass1(rs, nbr_map, ev, boxes=boundary,
                                          **kw)
    f1 = f_i + f_b
    rhobar = rho_i + rho_b
    phi = phi_i + phi_b if want_energy else None
    dfe, u = _embed(f_eval, rs, phi, rhobar, n_atoms, None, e_dtype)
    # interior pass 3 reads only local dfEmbed: before the fill
    f3_i = stencil.eam_pass3(r_pre, nbr_map, ev, dfe, box_chunk=box_chunk,
                             boxes=interior)
    dfe = fill_halo_scalar(dfe, rhobar)
    f3 = f3_i + stencil.eam_pass3(rs, nbr_map, ev, dfe, box_chunk=box_chunk,
                                  boxes=boundary)
    return (f1, f3) if passes else f1 + f3, u, dfe


def eam_force_half(
    half_nbr_map: torch.Tensor,  # [n_local, 14] int32 on r's device
    rs: torch.Tensor,            # [S, 3, B, A], halo cells filled
    ev: PairEvaluator,
    f_eval: tables.EmbedTable,   # make_f_eval
    fill_halo_scalar: Callable,  # as in eam_force
    fold: Callable,              # [S, .., B, A] -> [S, .., n_local, A]
    *,
    n_atoms: torch.Tensor,       # [S, B] int32
    halo_src: Optional[torch.Tensor] = None,
    e_dtype: torch.dtype = torch.float64,
    want_energy: bool = True,
    box_chunk: int = 256,
):
    """EAM with Newton's-3rd-law half sweeps for passes 1 and 3 (each pair
    evaluated once, the reference's half-list kernels, eam.c:266-419), for
    every shard of a mesh, one K2 launch a pass over the stack.

    Pass 1 on K2, then ``fold`` delivers the halo rows of rhobar and
    phi_sum to their owners; pass 2 as in ``eam_force`` (with its
    ``halo_src`` and ``n_atoms``); the dfEmbed halo fill; pass 3 on K2;
    the two dense force passes are folded once (fold is linear).  ``fold``
    and ``fill_halo_scalar`` run over all shards.  Returns (force [S, 3,
    n_local, A], U [S, n_local, A] | None, dfEmbed [S, B, A]).
    """
    _stacks(rs, n_atoms)
    f1d, phi_d, rho_d = stencil.eam_pass1_half(rs, half_nbr_map, ev,
                                               want_energy=want_energy,
                                               box_chunk=box_chunk)
    rhobar = fold(rho_d)
    phi = fold(phi_d) if want_energy else None
    dfe, u = _embed(f_eval, rs, phi, rhobar, n_atoms, halo_src, e_dtype)
    if halo_src is None:
        dfe = fill_halo_scalar(dfe, rhobar)
    f = fold(f1d + stencil.eam_pass3_half(rs, half_nbr_map, ev, dfe,
                                          box_chunk=box_chunk))
    return f, u, dfe


def eam_force_nl(
    nlists: Sequence[nlmod.NeighborList],   # per shard
    rs: Sequence[torch.Tensor],  # per shard: [3, B, A], halo cells filled
    ev: PairEvaluator,
    f_eval: tables.EmbedTable,
    fill_halo_scalar: Callable,  # dfEmbed per shard -> halo rows filled
    *,
    n_atoms: Sequence[torch.Tensor],   # per shard: [B] int32
    halo_src: Optional[torch.Tensor] = None,
    e_dtype: torch.dtype = torch.float64,
    want_energy: bool = True,
):
    """EAM over Verlet lists (thread_atom_nl / warp_atom_nl; the
    reference's eamForceCpuNL, eam.c:266-419, and its *_nl GPU kernels,
    gpu_eam_thread_atom.h:144-266) for every shard: pass 1 on NL2 per
    shard, pass 2 on the rows (``embed_rows``: dfEmbed in the cell layout,
    its halo rows the serial sources' with ``halo_src``, else 0 and the
    dfEmbed fill once over all shards: the NL path has no fused
    transport), pass 3 on NL2.  Returns, per shard, (RowForce of f1 and f3,
    ePot | None, dfEmbed [B, A]); ``nlist.row_start`` has a shard's
    n_local cells."""
    p1 = [nl.eam_pass1(lst, r, ev, want_energy=want_energy)
          for lst, r in zip(nlists, rs)]
    emb = [step.embed_rows(f_eval, lst, n, (rho,),
                           None if phi is None else (phi,),
                           lst.row_start.shape[0], r.shape[1], halo_src,
                           e_dtype)
           for lst, r, n, (_f, phi, rho) in zip(nlists, rs, n_atoms, p1)]
    dfe = [d for d, _u in emb]
    if halo_src is None:
        dfe = fill_halo_scalar(dfe)
    return [(nlmod.RowForce(lst, n, ((f1,), (nl.eam_pass3(lst, r, ev, d),))),
             None if u is None else u.sum(), d)
            for lst, r, n, (f1, _p, _r), (_d, u), d
            in zip(nlists, rs, n_atoms, p1, emb, dfe)]


def eam_force_nl_split(
    nlists: Sequence[nlmod.NeighborList],   # per shard, built with row_split
    rs: Sequence[torch.Tensor],  # per shard: [3, B, A] post-exchange
    ev: PairEvaluator,
    f_eval: tables.EmbedTable,
    fill_halo_scalar: Callable,
    n_rows_interior: int,        # rows [0, Ri) are interior-cell atoms
    *,
    n_atoms: Sequence[torch.Tensor],   # per shard: [B] int32
    r_pre: Optional[Sequence[torch.Tensor]] = None,
    e_dtype: torch.dtype = torch.float64,
    want_energy: bool = True,
):
    """``eam_force_nl`` with the interior/boundary row split (-a 1 on the
    NL methods, the reference's timestep.c:257-265 / :328-351): interior
    rows reference only local cells, so their passes 1 and 3 read the
    pre-exchange positions ``r_pre`` and the pre-fill dfEmbed, and pass 3's
    interior rows run before the fill.  Each sweep's rows stay a segment
    of their own, read in row order by ``embed_rows`` and the landing.  On
    one stream nothing overlaps; the split keeps comd_tpu's data flow.
    Returns what eam_force_nl does (a mesh's: zero halo rows, then the
    fill)."""
    r_pre = rs if r_pre is None else r_pre
    parts = []
    for lst, r, rp, n in zip(nlists, rs, r_pre, n_atoms):
        n_rows = lst.a_list.shape[0]
        seg = (nlmod.slice_rows(lst, 0, n_rows_interior),
               nlmod.slice_rows(lst, n_rows_interior, n_rows))
        p1 = [nl.eam_pass1(sl, x, ev, want_energy=want_energy)
              for sl, x in zip(seg, (rp, r))]
        dfe, u = step.embed_rows(
            f_eval, lst, n, tuple(p[2] for p in p1),
            tuple(p[1] for p in p1) if want_energy else None,
            lst.row_start.shape[0], r.shape[1], None, e_dtype)
        # interior pass 3 reads only local dfEmbed: before the fill
        f3_i = nl.eam_pass3(seg[0], rp, ev, dfe)
        parts.append((lst, seg, r, n, tuple(p[0] for p in p1), f3_i,
                      None if u is None else u.sum(), dfe))
    dfe = fill_halo_scalar([p[7] for p in parts])
    return [(nlmod.RowForce(lst, n, (f1, (f3_i, nl.eam_pass3(seg[1], r, ev,
                                                              d)))),
             e_pot, d)
            for (lst, seg, r, n, f1, f3_i, e_pot, _d), d in zip(parts, dfe)]
