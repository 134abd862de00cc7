"""EAM three-pass force with the mid-force dfEmbed halo fill.

Algorithm per the reference (src-mpi/eam.c:44-86):

  pass 1 (pairs): U_i += 0.5*phi(r_ij); rhobar_i += rho(r_ij);
                  f_i -= phi'(r_ij) * rhat
  pass 2 (atoms): U_i += F(rhobar_i); dfEmbed_i = F'(rhobar_i)
  -- halo fill of dfEmbed (haloExchange(forceExchange), eam.c:241/370) --
  pass 3 (pairs): f_i -= (dfEmbed_i + dfEmbed_j) * rho'(r_ij) * rhat

Passes 1 and 3 run on the CUDA cell-stencil kernel (ops/cuda/stencil.py;
its plain PyTorch version on CPU tensors).  Pass 2 is per-atom, 27x fewer
evaluations than a pair pass, and stays torch ops: the direct quadratic
interpolation of F (eam.c:557-579).  This is comd_tpu's eam_force_pallas
contract (half=False).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..cells import CellGeometry
from ..potentials import tables
from ..potentials.eam import EamPotential
from .cuda import stencil
from .cuda.stencil import PairEvaluator


def make_pair_evaluator(pot: EamPotential, dtype: torch.dtype, device,
                        impl: str) -> PairEvaluator:
    """The pair evaluator for ``interp_impl``: "cheb" -> the Chebyshev fit,
    "rows"/"twolevel" -> the exact quadratic table interpolation."""
    rcut2 = tables.as_dtype(pot.cutoff * pot.cutoff, dtype)
    if impl == "cheb":
        return PairEvaluator(kind="cheb", dtype=dtype, rcut2=rcut2,
                             cheb=pot.cheb_pair)
    if impl not in ("rows", "twolevel"):
        raise ValueError(f"invalid interp_impl {impl!r}")
    if pot.phi.n != pot.rho.n or pot.phi.x0 != pot.rho.x0 or \
            pot.phi.inv_dx != pot.rho.inv_dx:
        raise ValueError("phi and rho tables must share one grid")
    return PairEvaluator(
        kind="table", dtype=dtype, rcut2=rcut2,
        phi=pot.phi.device_table(dtype, device),
        rho=pot.rho.device_table(dtype, device),
        n=pot.phi.n, x0=pot.phi.x0,
        inv_dx=tables.as_dtype(pot.phi.inv_dx, dtype))


def make_f_eval(pot: EamPotential, dtype: torch.dtype, device) -> Callable:
    """Pass-2 embedding evaluator F(rhobar) -> (F, dF/drhobar): the direct
    quadratic interpolation of the F table, whatever ``interp_impl`` the
    pair passes use (F is not Chebyshev-fit: rhobar's domain edge has
    sqrt-like curvature that a global fit handles poorly)."""
    tab = pot.f.device_table(dtype, device)
    n, x0 = pot.f.n, pot.f.x0
    inv_dx = tables.as_dtype(pot.f.inv_dx, dtype)
    return lambda rho: tables.interpolate(tab, n, x0, inv_dx, rho)


def eam_force(
    geom: CellGeometry,
    nbr_map: torch.Tensor,       # [n_local, 27] int32 on r's device
    r: torch.Tensor,             # [3, B, A] with halo cells filled
    ev: PairEvaluator,
    f_eval: Callable,            # make_f_eval
    fill_halo_scalar: Callable,  # [B, A] field -> field with halo filled
    *,
    e_dtype: torch.dtype = torch.float64,
    want_energy: bool = True,
    box_chunk: int = 256,
):
    """Returns (force [3, n_local, A], U_raw [n_local, A], dfEmbed [B, A]).

    ``want_energy=False`` (dynamics-only steps between reporting
    boundaries) skips the phi-value work and returns U_raw=None.
    ``box_chunk`` only chunks the plain version (CPU tensors).
    """
    B, A = r.shape[1], r.shape[2]
    n_local = geom.n_local

    f1, phi_sum, rhobar = stencil.eam_pass1(
        r, nbr_map, ev, want_energy=want_energy, box_chunk=box_chunk)

    # pass 2 (eam.c:351-366): every slot gets F(rhobar); empty slots are
    # masked by the caller (finalize_eam_energy)
    f_emb, df_emb = f_eval(rhobar)
    u = (0.5 * phi_sum.to(e_dtype) + f_emb.to(e_dtype)
         if want_energy else None)

    df_embed = torch.zeros((B, A), dtype=r.dtype, device=r.device)
    df_embed[:n_local] = df_emb
    df_embed = fill_halo_scalar(df_embed)

    f3 = stencil.eam_pass3(r, nbr_map, ev, df_embed, box_chunk=box_chunk)
    return f1 + f3, u, df_embed


def finalize_eam_energy(u, valid_mask, e_dtype=torch.float64):
    """Mask the embedding energy of empty slots and reduce in ``e_dtype``.

    Pass 2 assigns F(rhobar=0) != 0 to every slot; only slots holding real
    atoms contribute (reference loops over nAtoms per box, eam.c:353-366).
    """
    u = torch.where(valid_mask, u, torch.zeros((), dtype=u.dtype,
                                               device=u.device))
    return u, u.to(e_dtype).sum()
