"""Staged halo and migration exchange over a mesh of shards.

Port of comd_tpu.parallel.exchange: the reference's 6-message staged
pattern (src-mpi/haloExchange.c:8-29) -- x, then y, then z, with received
edge and corner data forwarded by the later stages.  comd_tpu runs it as
``lax.ppermute`` collectives inside ``shard_map``; here a ppermute along
an axis is a ring shift over the shards' tensors (plain torch gathers and
scatters).  These functions are the ``--commImpl collective`` transport
and the plain versions the kernel-initiated transports (ki_comm.py) are
held against.  A stage's atom messages are one ``atom_pack`` launch over
every shard and both faces (ops/cuda/comm.py; ``_atom_message`` stays the
plain reference).  Each takes the lists of this process's shards (the
mesh's ``owned``, all of them in a single process):

  * a message to a shard of the same process is the tensor itself;
  * in a multi-process launch, every message of a stage for a shard of
    another process goes into one flat byte buffer a peer process, in
    shard order of the receivers and minus before plus, and moves with one
    send and one receive a peer (``dist.exchange``).  The bytes travel
    unchanged (no dtype cast) and the shapes are static, so the receive
    buffers are made once and kept on the ``Halo``.

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
from ..ops.cuda.comm import AtomPackPlan, RowMap, atom_pack
from ..potentials.tables import as_dtype
from . import dist
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
    shifts rounded to the dynamics dtype, the kernels' launch plans
    (ki_comm.py: one a field shape, made on first use; and the composed
    position refresh, ``position_map``), and for the
    exchanges across processes the routes (``_route``), the receive
    buffers (one set a stage and message layout) and the traffic counters
    (bytes sent, by kind of exchange under ("bytes", kind), and
    ``dist.exchange``'s timing), all made on first use; and, for the ki
    transports across processes, ``ipc``: the link (ki_comm.Link: this
    process's arena of receive planes, the peers' opened arenas, the
    call counters of the stage schedule) and the stages' plans and
    planes, made on the first ki call."""
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
    bufs: dict = dataclasses.field(default_factory=dict, compare=False,
                                   repr=False)
    traffic: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)
    routes: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)
    ipc: dict = dataclasses.field(default_factory=dict, compare=False,
                                  repr=False)


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
# delivery: within the process, or across processes
# --------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    """A tensor's size in a message: its bytes padded to a multiple of 8,
    so that every field of a message starts aligned for any dtype."""
    return -(-t.numel() * t.element_size() // 8) * 8


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, flat, padded to ``_nbytes(t)``."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    pad = _nbytes(t) - b.numel()
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def _from_bytes(buf: torch.Tensor, off: int, like: torch.Tensor):
    """The tensor shaped as ``like`` at byte ``off`` of ``buf``, and the
    offset past it (``_as_bytes`` reversed; a view, no copy)."""
    n = like.numel() * like.element_size()
    t = buf[off:off + n].view(like.dtype).reshape(like.shape)
    return t, off + _nbytes(like)


def _route(h: Halo, axis: int):
    """Where one stage's messages along ``axis`` go, made once a Halo:
    (local, sends, recvs).  ``local``: (receiver slot, k, sender slot)
    within the process; ``sends``: {peer: [(sender slot, k), ...]};
    ``recvs``: {peer: [(receiver slot, k), ...]}.  k = 0 is the message
    from the receiver's plus neighbor (its "to minus" message), k = 1 the
    one from its minus neighbor.  Sender and receiver walk the same
    (receiver, k) pairs in the same order: the receivers in shard order,
    for each one k = 0 then k = 1."""
    key = ("route", axis)
    if key not in h.routes:
        mesh, me = h.mesh, h.mesh.proc
        src_of = (h.plus[axis], h.minus[axis])
        local, sends, recvs = [], {}, {}
        for dst in range(mesh.size):
            for k in (0, 1):
                src = src_of[k][dst]
                if mesh.owner(dst) == me and mesh.owner(src) == me:
                    local.append((mesh.slot(dst), k, mesh.slot(src)))
                elif mesh.owner(dst) == me:
                    recvs.setdefault(mesh.owner(src), []).append(
                        (mesh.slot(dst), k))
                elif mesh.owner(src) == me:
                    sends.setdefault(mesh.owner(dst), []).append(
                        (mesh.slot(src), k))
        h.routes[key] = (local, sends, recvs)
    return h.routes[key]


def _deliver(h: Halo, key, axis: int, msgs: list) -> list:
    """Deliver one stage's messages along ``axis``.  ``msgs[i]`` holds the
    i-th owned shard's two messages, (to its minus neighbor, to its plus
    neighbor), each a tuple of tensors; every shard's messages have the
    same shapes and dtypes; a message that goes to a shard of this process
    may be None where the caller reads it itself.  Returns for each owned
    shard (from its plus neighbor, from its minus neighbor): the tensors
    themselves where the sender is in this process, views of the receive
    buffer of ``key`` and this layout where it is not (valid until the
    next such call).

    With 2 processes on 2 shards along ``axis`` both directions go to the
    same peer in its one buffer; on an axis of size 1 a shard is its own
    neighbor and nothing leaves the process."""
    local, sends, recvs = _route(h, axis)
    got = [[None, None] for _ in msgs]
    for i, k, j in local:
        got[i][k] = msgs[j][k]
    if not recvs:
        return got
    like = next(m for pair in msgs for m in pair if m is not None)
    nb = sum(_nbytes(t) for t in like)
    layout = tuple((tuple(t.shape), t.dtype) for t in like)
    sends = {q: torch.cat([_as_bytes(t) for j, k in v for t in msgs[j][k]])
             for q, v in sends.items()}
    count = ("bytes", key[0])
    h.traffic[count] = h.traffic.get(count, 0) + sum(
        b.numel() for b in sends.values())
    bufs = dist.exchange(sends, {q: nb * len(v) for q, v in recvs.items()},
                         h.bufs.setdefault((key, layout), {}), h.traffic)
    for q, slots in recvs.items():
        off = 0
        for i, k in slots:
            msg = []
            for t in like:
                x, off = _from_bytes(bufs[q], off, t)
                msg.append(x)
            got[i][k] = tuple(msg)
    return got


# --------------------------------------------------------------------------
# the collective transport (plain torch; one list entry per shard)
# --------------------------------------------------------------------------

def _atom_message(h: Halo, axis: int, d: int, r, p, gid, n_atoms):
    """One shard's atom message for face (axis, d): the cells of its two
    send planes, as full-capacity planes or count-packed (capacity
    ``atom_cap``).  Returns (r [3, M], p [3, M], gid [M], valid [M],
    overflow), each contiguous.  The plain reference of ``atom_pack``,
    which ``atom_arrivals`` runs."""
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
    # gpu_kernels.cu:684-690); entries past cap are dropped and flagged.
    # The six coordinate rows share one flat buffer whose last entry
    # collects the drops, so r and p come out as contiguous [3, cap]
    pos = torch.cumsum(slot_ok, 0) - 1
    count = slot_ok.sum()
    keep = slot_ok & (pos < cap)
    dest = torch.where(keep, pos, cap)
    row = torch.arange(6, device=r.device)[:, None] * cap
    flat = r.new_zeros(6 * cap + 1)
    flat[torch.where(keep, row + pos, 6 * cap)] = torch.cat([rm, pm])
    r6 = flat[:6 * cap].view(6, cap)
    g = gid.new_full((cap + 1,), int(EMPTY_GID))
    g[dest] = gm
    valid = torch.arange(cap, device=r.device) < count
    return r6[:3], r6[3:], g[:cap], valid, count > cap


def pack_plan(h: Halo, axis: int, r0: torch.Tensor) -> AtomPackPlan:
    """Stage ``axis``'s atom-message plan and buffers for positions like
    ``r0`` ([3, B, A]), made once a Halo: the face cells of
    ``atom_send[axis]``, the plan's ``atom_cap[axis]`` (0: full planes),
    this process's shards."""
    key = ("atom pack", axis, tuple(r0.shape), r0.dtype)
    plan = h.launch_plans.get(key)
    if plan is None:
        plan = h.launch_plans[key] = AtomPackPlan(
            h.atom_send[axis], h.plan.atom_cap[axis], len(h.mesh.owned),
            r0.shape, r0.dtype, h.mesh.device)
    return plan


def atom_arrivals(h: Halo, axis: int, r: list, p: list, gid: list,
                  n_atoms: list, overflow: torch.Tensor) -> list:
    """Stage ``axis``'s atom messages of every shard, packed (both
    directions of every shard before any unload: one ``atom_pack`` launch
    on the card) and delivered.  Returns for each shard its arrivals of
    direction 0 (from its minus neighbor) and 1 (from its plus neighbor),
    each (r [3, M], p [3, M], gid [M], valid [M]) in the sender's frame; a
    packed message's overflow is or-ed into ``overflow`` in place.  The
    messages live in the plan's buffers until the stage's next call."""
    msgs = atom_pack(pack_plan(h, axis, r[0]), r, p, gid, n_atoms, overflow)
    got = _deliver(h, ("atoms", axis), axis, msgs)
    return [(from_minus, from_plus) for from_plus, from_minus in got]


def exchange_atoms(h: Halo, r: list, p: list, gid: list, n_atoms: list):
    """3-stage staged atom exchange (ghosts + migration + forwarding), in
    place on the shards' tensors.

    Cells must be freshly rebucketed (``keep_halo=True``).  Each stage's
    arrivals are appended to every shard in one ``binning.append_stage``
    (two launches on the card), direction 0 shifted by -ext along the
    stage's axis and direction 1 by +ext.  Returns lists (r, p, gid,
    n_atoms) of the given tensors, overwritten, and the overflow flag (a
    0-dim bool, any of this process's shards, any face); the caller sorts
    the cells afterwards (``binning.sort_shards``) to restore the
    canonical in-cell order.
    """
    r, p, gid, n_atoms = list(r), list(p), list(gid), list(n_atoms)
    overflow = torch.zeros((), dtype=torch.bool, device=h.mesh.device)
    for axis in range(3):
        arrivals = atom_arrivals(h, axis, r, p, gid, n_atoms, overflow)
        binning.append_stage(h.geom, h.maps, r, p, gid, n_atoms, arrivals,
                             overflow, axis, (-h.ext[axis], h.ext[axis]))
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
        got = _deliver(h, ("positions", axis), axis,
                       [((x[:, send_m],), (x[:, send_p],)) for x in r])
        for s in range(len(r)):
            (got_p,), (got_m,) = got[s]
            got_p[axis] += ext
            got_m[axis] -= ext
            r[s][:, recv_p] = got_p
            r[s][:, recv_m] = got_m
    return r


def position_map(h: Halo) -> RowMap:
    """``exchange_positions`` of a mesh in one process composed into one
    row map, made once a Halo (kept in ``launch_plans``): for every halo
    row of every shard, the local row whose positions the three stages
    finally copy into it and the sign (-1, 0, +1) of the shift each
    coordinate gets on the way.

    Composed, not derived: ``exchange_positions`` itself runs on a CPU
    copy of the mesh whose positions are tagged (each row's three
    coordinates its global row id s * B + row) and whose shifts are 1/4,
    so a halo row comes out as its source's id plus sign_c / 4.  Why one
    launch of the map keeps every bit: each halo row is written by one
    stage only (the growing cross-sections), coordinate c is shifted only
    in stage c, and ext[c] is rounded to the dtype already, so each
    coordinate of a row takes at most one rounded add of +-ext[c] either
    way.  Checked here: every halo row a destination once, no local row a
    destination, every source a local row, every sign -1, 0 or +1."""
    key = "position map"
    if key not in h.launch_plans:
        h.launch_plans[key] = _compose_positions(h)
    return h.launch_plans[key]


def _compose_positions(h: Halo) -> RowMap:
    if h.mesh.nprocs != 1:
        raise ValueError("the composed position refresh is one process's: "
                         "across processes each stage is a launch")
    S, B, nl = h.mesh.size, h.geom.n_total, h.geom.n_local
    recv = np.sort(np.concatenate([v for pair in h.plan.force_recv
                                   for v in pair]))
    if not np.array_equal(recv, np.arange(nl, B)):
        raise RuntimeError("the stages do not write every halo row once")
    cpu = dataclasses.replace(
        make_halo(dataclasses.replace(h.mesh, device=torch.device("cpu")),
                  h.geom, h.maps, h.plan, torch.float64),
        ext=(0.25, 0.25, 0.25))
    tags = torch.arange(S * B, dtype=torch.float64).view(S, 1, B, 1)
    r = [t.expand(3, B, 1).clone() for t in tags]
    v = torch.stack(exchange_positions(cpu, r))[..., 0].numpy()   # [S, 3, B]
    src = np.rint(v[:, 0])
    signs = np.rint(4.0 * (v - src[:, None])).astype(np.int64)
    if (np.rint(v) != src[:, None]).any() or \
            (v != src[:, None] + 0.25 * signs).any() or \
            (np.abs(signs) > 1).any():
        raise RuntimeError("a halo row mixes sources or takes two shifts")
    src = src.astype(np.int64)
    local = np.arange(S)[:, None] * B + np.arange(nl)
    if (src[:, :nl] != local).any() or signs[:, :, :nl].any():
        raise RuntimeError("the refresh writes a local row")
    src = src[:, nl:].reshape(-1)
    if (src % B >= nl).any():
        raise RuntimeError("a halo row's source is not a local row")
    return RowMap(dst=np.repeat(np.arange(S), B - nl),
                  dst_row=np.tile(np.arange(nl, B), S), src=src // B,
                  src_row=src % B,
                  signs=signs[:, :, nl:].transpose(0, 2, 1).reshape(-1, 3))


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
        got = _deliver(h, ("fold", axis), axis,
                       [((v.index_select(-2, recv_m),),
                         (v.index_select(-2, recv_p),)) for v in x])
        for s in range(len(x)):
            (got_p,), (got_m,) = got[s]
            x[s].index_add_(x[s].dim() - 2, send_p, got_p)
            x[s].index_add_(x[s].dim() - 2, send_m, got_m)
    return [v[..., :h.geom.n_local, :] for v in x]


def exchange_scalar(h: Halo, x: list) -> list:
    """Staged halo exchange of a per-atom scalar field [B, A] (EAM dfEmbed),
    in place on every shard's field.  Slot-aligned cell-block copies; the
    growing cross-section forwards edge and corner values (eam.c:59-72,
    haloExchange.c:345-475)."""
    for axis in range(3):
        send_m, send_p = h.force_send[axis]
        recv_m, recv_p = h.force_recv[axis]
        got = _deliver(h, ("scalar", axis), axis,
                       [((v[send_m],), (v[send_p],)) for v in x])
        for s in range(len(x)):
            (got_p,), (got_m,) = got[s]
            x[s][recv_p] = got_p
            x[s][recv_m] = got_m
    return x
