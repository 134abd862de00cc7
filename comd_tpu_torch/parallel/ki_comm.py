"""Kernel-initiated halo transports on K3 and K4 (comd_tpu's pallas_comm).

The reference's kernel-initiated transport (src-mpi/comm_ki.cuh:187-310)
lets the GPU post its halo sends itself instead of bouncing through the
host; comd_tpu rebuilt it as Pallas kernels that push each halo plane to the
ring neighbor with a remote copy (``--commImpl ki``), and one that fuses the
x-stage push into the embedding-derivative evaluation (``ki_fused``).  Here
the planes move with the hand-written kernels of ops/cuda/comm.py:

  * ``exchange_scalar_ki``: the 3-stage dfEmbed exchange, one K3 launch per
    (stage, direction) for every shard of the mesh;
  * ``exchange_atoms_ki``: the 3-stage atom exchange, each face's cell
    blocks (r, p, gid, counts) pushed by one K3 launch per direction into
    per-shard arrival buffers, then re-binned by coordinate exactly as the
    collective path does;
  * ``exchange_scalar_ki_fused``: the x stage on K4, which evaluates
    F'(rhobar) of the x-face planes in the kernel and writes it into the x
    neighbor's halo rows; the y and z stages forward the assembled field
    on K3.

The staged x -> y -> z order and the growing cross-sections are those of
exchange.exchange_scalar / exchange_atoms, so all three transports give
the same state bit for bit.  K3 moves raw 32-bit words, so the gid and
count fields travel as int32 planes and comd_tpu's _pack_ints (ints
through float buffers) has no counterpart.
"""
from __future__ import annotations

import torch

from ..ops import binning
from ..ops.cuda.comm import pass2_push, ring_push
from ..potentials.tables import EmbedTable
from .exchange import Halo


def _push_scalar_stage(h: Halo, x: list, axis: int) -> None:
    send_m, send_p = h.force_send[axis]
    recv_m, recv_p = h.force_recv[axis]
    # my minus-face plane lands in my minus neighbor's plus halo, and back
    ring_push([(x, x)], h.minus[axis], send_m, recv_p)
    ring_push([(x, x)], h.plus[axis], send_p, recv_m)


def exchange_scalar_ki(h: Halo, x: list) -> list:
    """dfEmbed halo exchange on K3, in place on every shard's [B, A] field:
    the same 3-stage growing-cross-section schedule as
    exchange.exchange_scalar (haloExchange.c:345-475), each plane pushed by
    the kernel."""
    for axis in range(3):
        _push_scalar_stage(h, x, axis)
    return x


def exchange_atoms_ki(h: Halo, r: list, p: list, gid: list, n_atoms: list):
    """3-stage staged atom exchange on K3 (the reference's
    exchangeData_Atoms_KI, comm_ki.cuh:437-496).  Each face's two send
    planes of whole cells (r, p, gid and the counts) are pushed, both
    directions before any unload, into per-shard arrival buffers laid out
    as comd_tpu's [8, n, A] arrivals (typed: r and p [3, n, A], gid [n, A],
    counts [n]); arrivals are re-binned by coordinate as in
    exchange.exchange_atoms.  Returns new lists (r, p, gid, n_atoms) and the
    overflow flag."""
    geom, maps = h.geom, h.maps
    r, p, gid, n_atoms = list(r), list(p), list(gid), list(n_atoms)
    S = len(r)
    A = r[0].shape[-1]
    slot = torch.arange(A, device=h.mesh.device)[None, :]
    overflow = torch.zeros((), dtype=torch.bool, device=h.mesh.device)
    for axis in range(3):
        ext = h.ext[axis]
        got = []
        for d, to in ((1, h.plus[axis]), (0, h.minus[axis])):
            ids = h.atom_send[axis][d]
            n = ids.numel()
            buf = ([r[0].new_empty((3, n, A)) for _ in range(S)],
                   [p[0].new_empty((3, n, A)) for _ in range(S)],
                   [gid[0].new_empty((n, A)) for _ in range(S)],
                   [n_atoms[0].new_empty((n,)) for _ in range(S)])
            ring_push(list(zip((r, p, gid, n_atoms), buf)), to, ids)
            got.append(buf)
        # got[0]: from my minus neighbor (its plus planes), shift -ext;
        # got[1]: from my plus neighbor, shift +ext
        for s in range(S):
            for (br, bp, bg, bn), shift in ((got[0], -ext), (got[1], +ext)):
                valid = (slot < bn[s][:, None]).reshape(-1)
                arr_r = br[s].reshape(3, -1)
                arr_r[axis] += shift        # the sender's frame -> ours
                r[s], p[s], gid[s], n_atoms[s], ovf = \
                    binning.append_arrivals(
                        geom, maps, r[s], p[s], gid[s], n_atoms[s], arr_r,
                        bp[s].reshape(3, -1), bg[s].reshape(-1), valid)
                overflow = overflow | ovf
    return r, p, gid, n_atoms, overflow


def exchange_scalar_ki_fused(h: Halo, x: list, rhobar_l: list,
                             f_eval: EmbedTable) -> list:
    """dfEmbed exchange with the x-stage pushes fused into the embedding
    evaluation (the reference's exchangeData_Force_KI fusion,
    comm_ki.cuh:187-310): K4 computes F'(rhobar) of each +-x face plane of
    every shard and writes it into the x neighbor's halo rows.  ``f_eval``
    is pass 2's evaluator, so the plane values equal the interior ones bit
    for bit.  The y and z stages forward columns that hold x-stage
    arrivals, so they stay K3 pushes of the assembled field.  In place on
    every shard's [B, A] field."""
    send_m, send_p = h.force_send[0]
    recv_m, recv_p = h.force_recv[0]
    pass2_push(rhobar_l, x, h.minus[0], send_m, recv_p, f_eval)
    pass2_push(rhobar_l, x, h.plus[0], send_p, recv_m, f_eval)
    for axis in (1, 2):
        _push_scalar_stage(h, x, axis)
    return x
