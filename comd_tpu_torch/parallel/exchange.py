"""Staged halo and migration exchange over a mesh of shards.

Port of comd_tpu.parallel.exchange: the reference's 6-message staged
pattern (src-mpi/haloExchange.c:8-29) -- x, then y, then z, with received
edge and corner data forwarded by the later stages.  comd_tpu runs it as
``lax.ppermute`` collectives inside ``shard_map``; here every shard of a
``Mesh`` lives in one process, so a ppermute along an axis is a ring shift
over the shards' tensors (plain torch gathers and scatters).  These
functions are the ``--commImpl collective`` transport and the plain
versions the kernel-initiated transports (ki_comm.py) are held against.

Design, as in comd_tpu:

  * Positions are stored in shard-local frames, so the PBC shift on receive
    is a uniform +/- local extent per axis (haloExchange.c:310-323).
  * The atom exchange ships two planes of whole cells per face (the outer
    local plane: ghosts; the halo plane: migrants) over the full extended
    cross-section; receivers re-bin arrivals by coordinate
    (ops.binning.append_arrivals), so ghosts land in halo cells and
    migrants in local cells alike.  With ``atom_cap`` the real atoms of the
    two planes are packed into a capped buffer plus a count, and an
    undersized capacity raises the overflow flag.
  * The dfEmbed exchange ships one plane per face with the growing
    cross-section (x: local, y: x-extended, z: fully extended;
    haloExchange.c:345-475) and writes the receiver's halo cells directly:
    canonical in-cell gid order makes ghost cells slot-aligned with their
    owner cells.

The numpy half (``make_plan``) is copied from comd_tpu, so both packages
build the same lists and the shards are slot-aligned alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cells import CellGeometry
from ..ops import binning
from ..ops.binning import EMPTY_GID, GeomMaps
from ..potentials.tables import as_dtype
from .mesh import Mesh


# --------------------------------------------------------------------------
# the plan (numpy, copied from comd_tpu)
# --------------------------------------------------------------------------

def _cells_where(geom: CellGeometry, axis: int, values, cross) -> np.ndarray:
    """Box ids whose tuple has t[axis] in ``values`` and the other axes
    within ``cross`` bounds; ordered lexicographically by tuple so sender and
    receiver lists correspond element-wise."""
    t = geom.tuple_of_box
    mask = np.isin(t[:, axis], values)
    for a in range(3):
        if a == axis:
            continue
        lo, hi = cross[a]
        mask &= (t[:, a] >= lo) & (t[:, a] <= hi)
    ids = np.flatnonzero(mask)
    order = np.lexsort((t[ids, 2], t[ids, 1], t[ids, 0]))
    return ids[order].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static send/recv cell lists for the 3-stage exchange."""
    # atom exchange: [axis][dir] -> box id array (dir 0 = minus, 1 = plus)
    atom_send: tuple
    # force exchange: send and recv lists, growing cross-section
    force_send: tuple
    force_recv: tuple
    axis_names: tuple[str, str, str]
    local_extent: np.ndarray  # [3]
    # count-packed atom messages: per-axis entry capacity (0 = ship the
    # full-capacity cell planes); overflow aborts like a cell overflow
    atom_cap: tuple = (0, 0, 0)


def make_plan(geom: CellGeometry, axis_names=("x", "y", "z"), *,
              msg_factor: float = 0.0, max_atoms: int = 0) -> ExchangePlan:
    g = geom.grid
    full = {a: (-1, g[a]) for a in range(3)}
    local = {a: (0, g[a] - 1) for a in range(3)}

    atom_send = []
    for axis in range(3):
        minus = _cells_where(geom, axis, [-1, 0], full)
        plus = _cells_where(geom, axis, [g[axis] - 1, g[axis]], full)
        atom_send.append((minus, plus))

    # force exchange: growing cross-section (x local, y x-extended, z full)
    crosses = [
        {0: local[0], 1: local[1], 2: local[2]},
        {0: full[0], 1: local[1], 2: local[2]},
        {0: full[0], 1: full[1], 2: local[2]},
    ]
    force_send, force_recv = [], []
    for axis in range(3):
        c = crosses[axis]
        send_minus = _cells_where(geom, axis, [0], c)
        send_plus = _cells_where(geom, axis, [g[axis] - 1], c)
        recv_minus = _cells_where(geom, axis, [-1], c)       # from minus nbr
        recv_plus = _cells_where(geom, axis, [g[axis]], c)   # from plus nbr
        force_send.append((send_minus, send_plus))
        force_recv.append((recv_minus, recv_plus))

    # packed-message capacities: the two send planes per face average ~50%
    # slot occupancy (the outer local plane carries the real atoms, the
    # halo plane only migrants), so factor*nmsg*A bounds the real entries
    # with headroom; overflow aborts like a cell overflow.
    atom_cap = (0, 0, 0)
    if msg_factor > 0:
        if max_atoms <= 0:
            raise ValueError("msg_factor > 0 requires max_atoms")
        atom_cap = tuple(
            max(256, -(-int(msg_factor * len(atom_send[a][0]) * max_atoms)
                       // 128) * 128)
            for a in range(3))

    return ExchangePlan(
        atom_send=tuple(atom_send),
        force_send=tuple(force_send),
        force_recv=tuple(force_recv),
        axis_names=tuple(axis_names),
        local_extent=(geom.local_max - geom.local_min),
        atom_cap=atom_cap,
    )


def atom_msg_bytes(plan: ExchangePlan, A: int, itemsize: int) -> dict:
    """Static per-step atom-exchange traffic per shard over the 6 faces:
    full-capacity planes vs count-packed buffers."""
    full = packed = 0
    for axis in range(3):
        nmsg = len(plan.atom_send[axis][0])
        # r+p (6 coords x itemsize) + gid (4) per slot entry; counts ~0
        per_entry = 6 * itemsize + 4
        full += 2 * (nmsg * A * per_entry + nmsg * 4)
        cap = plan.atom_cap[axis] or nmsg * A
        packed += 2 * (cap * per_entry + 4)
    return {"full_bytes": full, "packed_bytes": packed,
            "ratio": full / max(packed, 1)}


# --------------------------------------------------------------------------
# the plan on the device, with the mesh's rings
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Halo:
    """Everything an exchange needs: the mesh and its rings, the shards'
    common geometry and maps, the plan and its lists as int32 device
    tensors (for torch indexing and the kernels alike), the per-axis PBC
    shifts rounded to the dynamics dtype, and the kernels' launch plans
    (ki_comm.py: one a field shape, made on first use)."""
    mesh: Mesh
    geom: CellGeometry
    maps: GeomMaps
    plan: ExchangePlan
    minus: tuple          # [axis] -> ring: shard s -> its minus neighbor
    plus: tuple           # [axis] -> ring: shard s -> its plus neighbor
    atom_send: tuple      # [axis] -> (minus, plus) box ids
    force_send: tuple     # [axis] -> (minus, plus)
    force_recv: tuple     # [axis] -> (minus, plus)
    ext: tuple            # [axis] local extent as a dtype-rounded float
    launch_plans: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)


def make_halo(mesh: Mesh, geom: CellGeometry, maps: GeomMaps,
              plan: ExchangePlan, dtype: torch.dtype) -> Halo:
    def lists(src):
        return tuple(tuple(torch.as_tensor(v, dtype=torch.int32,
                                           device=mesh.device) for v in pair)
                     for pair in src)

    return Halo(
        mesh=mesh, geom=geom, maps=maps, plan=plan,
        minus=tuple(tuple(mesh.ring(a, -1)) for a in range(3)),
        plus=tuple(tuple(mesh.ring(a, +1)) for a in range(3)),
        atom_send=lists(plan.atom_send),
        force_send=lists(plan.force_send),
        force_recv=lists(plan.force_recv),
        ext=tuple(as_dtype(float(e), dtype) for e in plan.local_extent))


# --------------------------------------------------------------------------
# the collective transport (plain torch; one list entry per shard)
# --------------------------------------------------------------------------

def _atom_message(h: Halo, axis: int, d: int, r, p, gid, n_atoms):
    """One shard's atom message for face (axis, d): the cells of its two
    send planes, as full-capacity planes or count-packed (capacity
    ``atom_cap``).  Returns (r [3, M], p [3, M], gid [M], valid [M],
    overflow)."""
    A = r.shape[-1]
    ids = h.atom_send[axis][d]
    slot_ok = (torch.arange(A, device=r.device)[None, :]
               < n_atoms[ids][:, None]).reshape(-1)
    rm = r[:, ids].reshape(3, -1)
    pm = p[:, ids].reshape(3, -1)
    gm = gid[ids].reshape(-1)
    cap = h.plan.atom_cap[axis]
    if not cap:
        return rm, pm, gm, slot_ok, torch.zeros((), dtype=torch.bool,
                                                  device=r.device)
    # count-packed: real entries compacted to the front of [cap] (the
    # reference's on-device size scan + packed AtomMsg,
    # gpu_kernels.cu:684-690); entries past cap are dropped and flagged
    pos = torch.cumsum(slot_ok, 0) - 1
    count = slot_ok.sum()
    dest = torch.where(slot_ok & (pos < cap), pos, cap)
    r6 = r.new_zeros((6, cap + 1))
    r6[:, dest] = torch.cat([rm, pm])
    g = gid.new_full((cap + 1,), int(EMPTY_GID))
    g[dest] = gm
    valid = torch.arange(cap, device=r.device) < count
    return r6[:3, :cap], r6[3:, :cap], g[:cap], valid, count > cap


def exchange_atoms(h: Halo, r: list, p: list, gid: list, n_atoms: list):
    """3-stage staged atom exchange (ghosts + migration + forwarding).

    Cells must be freshly rebucketed (``keep_halo=True``).  Returns new
    lists (r, p, gid, n_atoms) and the overflow flag (a 0-dim bool, any
    shard, any face); the caller applies ``sort_cells`` afterwards to
    restore the canonical in-cell order.
    """
    geom, maps = h.geom, h.maps
    r, p, gid, n_atoms = list(r), list(p), list(gid), list(n_atoms)
    overflow = torch.zeros((), dtype=torch.bool, device=h.mesh.device)
    for axis in range(3):
        ext = h.ext[axis]
        # pack both directions of every shard before any unload
        msgs = [[_atom_message(h, axis, d, r[s], p[s], gid[s], n_atoms[s])
                 for d in (0, 1)] for s in range(len(r))]
        for m in msgs:
            overflow = overflow | m[0][4] | m[1][4]
        for s in range(len(r)):
            from_minus = msgs[h.minus[axis][s]][1]
            from_plus = msgs[h.plus[axis][s]][0]
            for (ar, ap, ag, valid, _o), shift in ((from_minus, -ext),
                                                   (from_plus, +ext)):
                ar = ar.clone()
                ar[axis] += shift          # the sender's frame -> ours
                r[s], p[s], gid[s], n_atoms[s], ovf = \
                    binning.append_arrivals(geom, maps, r[s], p[s], gid[s],
                                            n_atoms[s], ar, ap, ag, valid)
                overflow = overflow | ovf
    return r, p, gid, n_atoms, overflow


def exchange_positions(h: Halo, r: list) -> list:
    """Slot-aligned ghost-position refresh between rebuckets, in place on
    every shard's [3, B, A] positions: the cell layout is frozen, so a
    plane-block copy with the per-axis PBC shift refreshes every ghost
    (the reference's hash-table slot-reuse path, hashTable.c)."""
    for axis in range(3):
        send_m, send_p = h.force_send[axis]
        recv_m, recv_p = h.force_recv[axis]
        ext = h.ext[axis]
        got_p = [r[h.plus[axis][s]][:, send_m] for s in range(len(r))]
        got_m = [r[h.minus[axis][s]][:, send_p] for s in range(len(r))]
        for s in range(len(r)):
            got_p[s][axis] += ext
            got_m[s][axis] -= ext
            r[s][:, recv_p] = got_p[s]
            r[s][:, recv_m] = got_m[s]
    return r


def fold_halo(h: Halo, x: list) -> list:
    """Half-shell force exchange: fold the ghost-cell accumulations of every
    shard's dense [..., n_total, A] field back into their owner cells across
    the mesh, then return the local rows [..., n_local, A].

    ``exchange_scalar`` reversed: stages z -> y -> x with the same growing
    cross-sections, halo planes sent back and ADDED into the sender-side
    local planes, so edge and corner contributions forward across two or
    three hops (haloExchange.c:345-475 run backwards).  An axis of size 1
    folds a shard's own periodic images."""
    x = [v.clone() for v in x]
    for axis in (2, 1, 0):
        send_m, send_p = h.force_send[axis]
        recv_m, recv_p = h.force_recv[axis]
        # my -1 halo plane belongs to the minus neighbor's top local plane
        got_p = [x[h.plus[axis][s]].index_select(-2, recv_m)
                 for s in range(len(x))]
        got_m = [x[h.minus[axis][s]].index_select(-2, recv_p)
                 for s in range(len(x))]
        for s in range(len(x)):
            x[s].index_add_(x[s].dim() - 2, send_p, got_p[s])
            x[s].index_add_(x[s].dim() - 2, send_m, got_m[s])
    return [v[..., :h.geom.n_local, :] for v in x]


def exchange_scalar(h: Halo, x: list) -> list:
    """Staged halo exchange of a per-atom scalar field [B, A] (EAM dfEmbed),
    in place on every shard's field.  Slot-aligned cell-block copies; the
    growing cross-section forwards edge and corner values (eam.c:59-72,
    haloExchange.c:345-475)."""
    for axis in range(3):
        send_m, send_p = h.force_send[axis]
        recv_m, recv_p = h.force_recv[axis]
        got_p = [x[h.plus[axis][s]][send_m] for s in range(len(x))]
        got_m = [x[h.minus[axis][s]][send_p] for s in range(len(x))]
        for s in range(len(x)):
            x[s][recv_p] = got_p[s]
            x[s][recv_m] = got_m[s]
    return x
