"""Kernel-initiated halo transports on the fill and push kernels
(comd_tpu's pallas_comm).

The reference's kernel-initiated transport (src-mpi/comm_ki.cuh:187-310)
lets the GPU post its halo sends itself instead of bouncing through the
host; comd_tpu rebuilt it as Pallas kernels that push each halo plane to the
ring neighbor with a remote copy (``--commImpl ki``), and one that fuses the
x-stage push into the embedding-derivative evaluation (``ki_fused``).  Here
the planes move with the hand-written kernels of ops/cuda/comm.py:

  * ``exchange_scalar_ki``: the 3-stage dfEmbed fill as one ``halo_fill``
    launch for every shard of the mesh (stages x, y, z in order inside it);
  * ``exchange_scalar_ki_fused``: the same launch with the x stage
    evaluating F'(rhobar) of the x-face planes and writing it into the x
    neighbor's halo rows (K4); y and z forward the assembled field;
  * ``exchange_atoms_ki``: the 3-stage atom exchange, one ``ring_push``
    launch a stage that moves each face's cell blocks (r, p, gid, counts)
    of both directions into per-shard arrival buffers, then the arrivals
    re-binned by coordinate exactly as the collective path does.

The launch plans (row lists, rings, vector widths, grid) are made on first
use and kept on the ``Halo``, one a field shape.  The staged x -> y -> z
order and the growing cross-sections are those of exchange.exchange_scalar
/ exchange_atoms, so all three transports give the same state bit for bit.
The kernels move raw 32-bit words, so the gid and count fields travel as
int32 and comd_tpu's _pack_ints (ints through float buffers) has no
counterpart.
"""
from __future__ import annotations

import torch

from ..ops import binning
from ..ops.cuda.comm import FillPlan, PushPlan, halo_fill, ring_push
from ..potentials.tables import EmbedTable
from .exchange import Halo


def fill_plan(h: Halo, x0: torch.Tensor) -> FillPlan:
    """The dfEmbed fill's plan for fields like ``x0`` ([B, A]): for each
    stage, my minus-face plane lands in my minus neighbor's plus halo
    (direction 0), my plus-face plane in my plus neighbor's minus halo."""
    key = ("fill", tuple(x0.shape), x0.dtype)
    plan = h.launch_plans.get(key)
    if plan is None:
        stages = [[(h.force_send[a][0], h.force_recv[a][1], h.minus[a]),
                   (h.force_send[a][1], h.force_recv[a][0], h.plus[a])]
                  for a in range(3)]
        plan = h.launch_plans[key] = FillPlan(stages, x0.shape, x0.dtype,
                                              h.mesh.device)
    return plan


def atom_plan(h: Halo, axis: int, fields) -> PushPlan:
    """The atom exchange's plan for stage ``axis`` and fields like
    ``fields`` (one tensor a shard each): direction 0 pushes my plus planes
    to my plus neighbor (arrivals from my minus neighbor), direction 1 my
    minus planes to my minus neighbor."""
    key = ("atoms", axis) + tuple((tuple(f[0].shape), f[0].dtype)
                                  for f in fields)
    plan = h.launch_plans.get(key)
    if plan is None:
        plan = h.launch_plans[key] = PushPlan(
            [(h.atom_send[axis][1], h.plus[axis]),
             (h.atom_send[axis][0], h.minus[axis])],
            [(f[0].shape, f[0].dtype) for f in fields], h.mesh.device)
    return plan


def exchange_scalar_ki(h: Halo, x: list) -> list:
    """dfEmbed halo exchange in one kernel launch, in place on every
    shard's [B, A] field: the same 3-stage growing-cross-section schedule
    as exchange.exchange_scalar (haloExchange.c:345-475)."""
    return halo_fill(fill_plan(h, x[0]), x)


def exchange_atoms_ki(h: Halo, r: list, p: list, gid: list, n_atoms: list):
    """3-stage staged atom exchange, one kernel launch a stage (the
    reference's exchangeData_Atoms_KI, comm_ki.cuh:437-496).  Each face's
    two send planes of whole cells (r, p, gid and the counts) are pushed,
    both directions before any unload, into per-shard arrival buffers laid
    out as comd_tpu's [8, n, A] arrivals (typed: r and p [3, n, A], gid
    [n, A], counts [n]); arrivals are re-binned by coordinate as in
    exchange.exchange_atoms.  Returns new lists (r, p, gid, n_atoms) and the
    overflow flag."""
    geom, maps = h.geom, h.maps
    r, p, gid, n_atoms = list(r), list(p), list(gid), list(n_atoms)
    A = r[0].shape[-1]
    slot = torch.arange(A, device=h.mesh.device)[None, :]
    overflow = torch.zeros((), dtype=torch.bool, device=h.mesh.device)
    for axis in range(3):
        ext = h.ext[axis]
        fields = (r, p, gid, n_atoms)
        got_r, got_p, got_g, got_n = ring_push(atom_plan(h, axis, fields),
                                               fields)
        # direction 0: from my minus neighbor (its plus planes), shift -ext;
        # direction 1: from my plus neighbor, shift +ext
        for s in range(len(r)):
            for d, shift in ((0, -ext), (1, +ext)):
                valid = (slot < got_n[d, s][:, None]).reshape(-1)
                arr_r = got_r[d, s].reshape(3, -1)
                arr_r[axis] += shift        # the sender's frame -> ours
                r[s], p[s], gid[s], n_atoms[s], ovf = \
                    binning.append_arrivals(
                        geom, maps, r[s], p[s], gid[s], n_atoms[s], arr_r,
                        got_p[d, s].reshape(3, -1), got_g[d, s].reshape(-1),
                        valid)
                overflow = overflow | ovf
    return r, p, gid, n_atoms, overflow


def exchange_scalar_ki_fused(h: Halo, x: list, rhobar_l: list,
                             f_eval: EmbedTable) -> list:
    """dfEmbed exchange with the x-stage pushes fused into the embedding
    evaluation (the reference's exchangeData_Force_KI fusion,
    comm_ki.cuh:187-310), in one kernel launch: the x stage computes
    F'(rhobar) of each +-x face plane of every shard and writes it into the
    x neighbor's halo rows.  ``f_eval`` is pass 2's evaluator, so the plane
    values equal the interior ones bit for bit.  The y and z stages forward
    columns that hold x-stage arrivals, so they copy the assembled field.
    In place on every shard's [B, A] field."""
    return halo_fill(fill_plan(h, x[0]), x, rhobar_l, f_eval)
