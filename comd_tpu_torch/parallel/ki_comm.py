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
    of both directions into per-shard arrival buffers, then every shard's
    arrivals re-binned by coordinate in one unload exactly as the
    collective path does (``binning.append_stage``: csrc/arrivals.cu's
    bin and place launches, reading the buffers where they lie);
  * ``exchange_positions_ki``: the ghost-position refresh between
    rebuckets as one ``position_fill`` launch over the three stages
    composed (exchange.position_map); in one process every --commImpl
    takes it, as comd_tpu runs one exchange_positions under each;
  * ``fold_halo_ki``: the half-shell fold (exchange.fold_halo's stages z,
    y, x), one ``fold_halo`` launch a stage over every shard, in place,
    under every --commImpl (comd_tpu runs one fold_halo under each);
    across processes each stage's messages for another process move as
    exchange.fold_halo's do (``exchange._deliver``) and its receiver
    copies them into its own halo rows of the stage's axis, which the
    stage launch then adds.

Across processes (a multi-process launch) every stage is one launch of
this process's shards, as comd_tpu's kernels push into a neighbor on
another device: a receiver in this process gets its rows directly, a
receiver in another process gets a receive plane in that process's arena
(``Link``: one cudaMalloc a process, opened by the peers through its CUDA
IPC handle), and unpacks it into its halo rows itself, as comd_tpu's
``x.at[recv].set`` does after its remote copy (fill: one indexed copy a
plane; positions: the same, the sender having added the shift; atoms: the
unload reads the planes beside the arrival buffers).
The stages are ordered on the stream, with no host wait, by counters that
only grow (``epoch_values``; csrc/comm.cu says how): the Pallas kernels'
neighbor barrier and DMA semaphores, the reference's ready flags
(comm.cc:326-397).
On the CPU the same stages run on the plain versions and the planes for
other processes move with ``dist.exchange`` in ``exchange._route``'s
order; the receiver unpacks them with the same code.

The launch plans (row lists, destination maps, planes, vector widths,
grid) are made on first use and kept on the ``Halo``, one a field shape.
The staged x -> y -> z order and the growing cross-sections are those of
exchange.exchange_scalar / exchange_atoms, so all three transports give the
same state bit for bit, in one process or several.  The kernels move raw
32-bit words, so the gid and count fields travel as int32 and comd_tpu's
_pack_ints (ints through float buffers) has no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import binning
from ..ops.cuda import comm
from ..ops.cuda.comm import (FillPlan, FoldMap, FoldPlan, PositionPlan,
                              PushPlan, RowMap, fold_halo, halo_fill,
                              position_fill, ring_push)
from ..potentials.tables import EmbedTable
from . import dist, exchange
from .exchange import Halo

# the stage kinds, each with its counters
KINDS = ("fill", "atoms", "positions")


# --------------------------------------------------------------------------
# in one process
# --------------------------------------------------------------------------

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


def position_plan(h: Halo, r0: torch.Tensor) -> PositionPlan:
    """The ghost-position refresh's plan in one process for positions like
    ``r0`` ([3, B, A]): the three stages composed into one row map
    (``exchange.position_map``), every halo row of every shard once."""
    key = ("positions", tuple(r0.shape), r0.dtype)
    plan = h.launch_plans.get(key)
    if plan is None:
        plan = h.launch_plans[key] = PositionPlan(
            exchange.position_map(h), r0.shape, r0.dtype, h.mesh.device,
            h.ext, h.mesh.size)
    return plan


def exchange_positions_ki(h: Halo, r: list) -> list:
    """The slot-aligned ghost-position refresh, in place on every shard's
    [3, B, A] positions, bit for bit exchange.exchange_positions'.  In one
    process one ``position_fill`` launch over the composed map (whatever
    the transport: comd_tpu runs the same exchange under every one);
    across processes one launch a stage, rows for another process's
    shards into its receive planes, shifted on the sender."""
    if h.mesh.nprocs > 1:
        return _positions_across(h, r)
    return position_fill(position_plan(h, r[0]), r)


def fold_plan(h: Halo, axis: int, x0: torch.Tensor) -> FoldPlan:
    """Stage ``axis`` of the half-shell fold for fields like ``x0`` ([B,
    A] or [3, B, A]), made once a Halo: exchange.fold_halo's adds in its
    order, every owned shard's local face rows ``send_p`` getting the rows
    ``recv_m`` of its plus neighbor, then ``send_m`` the rows ``recv_p`` of
    its minus neighbor.  A neighbor in another process is this shard's own
    halo plane on that side (``recv_p`` for the plus neighbor, ``recv_m``
    for the minus one), into which ``_fold_unpack`` copies what it sent.
    A stage reads halo rows of its axis and writes local ones, so no row
    it reads is a row it writes."""
    key = ("fold", axis, tuple(x0.shape), x0.dtype)
    plan = h.launch_plans.get(key)
    if plan is None:
        send, recv = h.plan.force_send[axis], h.plan.force_recv[axis]
        n = len(send[0])
        local, _sends, recvs = exchange._route(h, axis)
        src_of = {(i, k): (j, recv[k]) for i, k, j in local}
        for slots in recvs.values():
            for i, k in slots:
                src_of[i, k] = (i, recv[1 - k])
        parts = []
        for i in range(len(h.mesh.owned)):
            for k in (0, 1):        # from the plus neighbor, then the minus
                j, rows = src_of[i, k]
                parts.append((np.full(n, i), send[1 - k], np.full(n, j),
                              rows))
        plan = h.launch_plans[key] = FoldPlan(
            FoldMap(*(np.concatenate(v) for v in zip(*parts))), x0.shape,
            x0.dtype, h.mesh.device, len(h.mesh.owned))
    return plan


def _fold_unpack(h: Halo, axis: int, x: list) -> None:
    """Across processes: stage ``axis``'s fold messages for and from
    another process delivered (``exchange._deliver``, as exchange.fold_halo
    sends them), each copied into its receiver's own halo plane on the
    sender's side, in place."""
    local, _sends, recvs = exchange._route(h, axis)
    recv_m, recv_p = h.force_recv[axis]
    fed = {(j, k) for _i, k, j in local}
    dim = x[0].dim() - 2
    msgs = [tuple(None if (j, k) in fed else (v.index_select(dim, rows),)
                  for k, rows in ((0, recv_m), (1, recv_p)))
            for j, v in enumerate(x)]
    got = exchange._deliver(h, ("fold", axis), axis, msgs)
    for _q, slots in sorted(recvs.items()):
        for i, k in slots:
            x[i][..., (recv_p, recv_m)[k], :] = got[i][k][0]


def fold_halo_ki(h: Halo, x: list) -> list:
    """The half-shell fold of every shard's dense [..., B, A] field, in
    place: stages z, y, x, one ``fold_halo`` launch each over every owned
    shard (``fold_plan``), bit for bit exchange.fold_halo's sums.  Returns
    the local rows [..., n_local, A] of each field, views of it.  Across
    processes a stage first delivers its messages for other processes
    (``_fold_unpack``)."""
    for axis in (2, 1, 0):
        if h.mesh.nprocs > 1:
            _fold_unpack(h, axis, x)
        fold_halo(fold_plan(h, axis, x[0]), x)
    return [v[..., :h.geom.n_local, :] for v in x]


def exchange_scalar_ki(h: Halo, x: list) -> list:
    """dfEmbed halo exchange in one kernel launch (one a stage across
    processes), in place on every shard's [B, A] field: the same 3-stage
    growing-cross-section schedule as exchange.exchange_scalar
    (haloExchange.c:345-475)."""
    if h.mesh.nprocs > 1:
        return _fill_across(h, x)
    return halo_fill(fill_plan(h, x[0]), x)


def exchange_scalar_ki_fused(h: Halo, x: list, rhobar_l: list,
                             f_eval: EmbedTable) -> list:
    """dfEmbed exchange with the x-stage pushes fused into the embedding
    evaluation (the reference's exchangeData_Force_KI fusion,
    comm_ki.cuh:187-310), in one kernel launch (one a stage across
    processes): the x stage computes F'(rhobar) of each +-x face plane of
    every shard, on the sender, and writes it into the x neighbor's halo
    rows (or its receive plane).  ``f_eval`` is pass 2's evaluator, so the
    plane values equal the interior ones bit for bit.  The y and z stages
    forward columns that hold x-stage arrivals, so they copy the assembled
    field.  In place on every shard's [B, A] field."""
    if h.mesh.nprocs > 1:
        return _fill_across(h, x, rhobar_l, f_eval)
    return halo_fill(fill_plan(h, x[0]), x, rhobar_l, f_eval)


def _unload(h: Halo, axis: int, fields, arrivals: list, overflow):
    """Append one stage's arrivals to every shard, in place on the lists'
    tensors: ``arrivals[s]`` holds shard s's of direction 0 (from its
    minus neighbor, shift -ext) and 1 (from its plus neighbor, +ext), each
    (r [3, n, A], p, gid [n, A], counts [n]); the overflow flag is set in
    place (``binning.append_stage``: two launches on the card)."""
    binning.append_stage(h.geom, h.maps, *fields, arrivals, overflow, axis,
                         (-h.ext[axis], h.ext[axis]))


def push_arrivals(h: Halo, axis: int, fields) -> list:
    """Stage ``axis``'s push (one ``ring_push`` launch) of every shard's
    ``fields`` (r, p, gid, n_atoms lists).  Returns for each shard its
    arrivals of direction 0 (from its minus neighbor) and 1, each (r [3,
    n, A], p, gid [n, A], counts [n]) as views of the pushed buffers."""
    got = ring_push(atom_plan(h, axis, fields), fields)
    return [[[g[d, s] for g in got] for d in (0, 1)]
            for s in range(len(fields[0]))]


def exchange_atoms_ki(h: Halo, r: list, p: list, gid: list, n_atoms: list):
    """3-stage staged atom exchange, one kernel launch a stage (the
    reference's exchangeData_Atoms_KI, comm_ki.cuh:437-496), in place on
    the shards' tensors.  Each face's two send planes of whole cells (r,
    p, gid and the counts) are pushed, both directions before any unload,
    into per-shard arrival buffers laid out as comd_tpu's [8, n, A]
    arrivals (typed: r and p [3, n, A], gid [n, A], counts [n]), or into
    receivers' plane sets in other processes; arrivals are re-binned by
    coordinate as in exchange.exchange_atoms, every shard's of a stage in
    two launches.  Returns lists (r, p, gid, n_atoms) of the given
    tensors, overwritten, and the overflow flag."""
    if h.mesh.nprocs > 1:
        return _atoms_across(h, r, p, gid, n_atoms)
    fields = (list(r), list(p), list(gid), list(n_atoms))
    overflow = torch.zeros((), dtype=torch.bool, device=h.mesh.device)
    for axis in range(3):
        _unload(h, axis, fields, push_arrivals(h, axis, fields), overflow)
    return fields + (overflow,)


# --------------------------------------------------------------------------
# across processes: the stage schedule, the arena, the stages
# --------------------------------------------------------------------------

def epoch_values(n: int) -> dict:
    """The counter values of call ``n`` (1, 2, ...) of one (kind, axis)
    stage across processes, the same on both sides of every (sender,
    receiver) pair of processes: the sender waits until the receiver has
    released call n - 1's planes ("free" >= n - 1), pushes, and writes
    "data" = n into the receiver's arena; the receiver waits for "data" >=
    n, unpacks, and writes "free" = n into the sender's arena.  Both count
    their calls of each (kind, axis) alike, because every process makes
    the same calls in the same order (the lazy and list triggers are
    allgathered, so every process rebuckets on the same steps)."""
    return {"wait_free": n - 1, "write_data": n, "wait_data": n,
            "write_free": n}


class Schedule:
    """This process's calls of each (kind, axis) stage so far."""

    def __init__(self):
        self.calls = {}

    def next(self, kind: str, axis: int) -> dict:
        """The counter values of the next call of (kind, axis)."""
        n = self.calls[kind, axis] = self.calls.get((kind, axis), 0) + 1
        return epoch_values(n)


def counter_word(role: str, kind: str, axis: int, peer: int,
                 nprocs: int) -> int:
    """The index of a 32-bit counter in an arena's counter block: "data"
    of (kind, axis) written by sender ``peer``, "free" of (kind, axis)
    written by receiver ``peer``, or "probe" written by ``peer`` once when
    the link is made."""
    if role == "probe":
        return 2 * len(KINDS) * 3 * nprocs + peer
    base = {"data": 0, "free": len(KINDS) * 3 * nprocs}[role]
    return base + (KINDS.index(kind) * 3 + axis) * nprocs + peer


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


def atom_slabs(n: int, A: int, dtype: torch.dtype) -> list:
    """(shape, dtype) of one sender's atom message of ``n`` cells: r and p
    [3, n, A], gid [n, A] and the counts [n] (int32)."""
    return [((3, n, A), dtype), ((3, n, A), dtype), ((n, A), torch.int32),
            ((n,), torch.int32)]


def plane_bytes(h: Halo, kind: str, axis: int, A: int,
                dtype: torch.dtype) -> int:
    """Bytes of one receive plane of stage (kind, axis), a multiple of 16:
    a fill plane [n_rows, A], a position plane [3, n_rows, A], or an atom
    plane set (``atom_slabs``)."""
    if kind in ("fill", "positions"):
        n = len(h.plan.force_send[axis][0]) * A * dtype.itemsize
        return _align(3 * n if kind == "positions" else n, 16)
    return comm.set_layout(atom_slabs(len(h.plan.atom_send[axis][0]), A,
                                      dtype))[1]


def arena_layout(h: Halo, A: int, dtype: torch.dtype) -> tuple:
    """This process's arena: ({(kind, axis, sender process): byte offset
    of the planes it sends here}, {(kind, axis): plane bytes}, bytes).
    The counter block comes first; then, stage by stage, the planes of
    each sender process in ``exchange._route``'s order (the order in which
    the sender walks them too)."""
    P = h.mesh.nprocs
    at = _align(4 * (2 * len(KINDS) * 3 + 1) * P, 256)
    offsets, sizes = {}, {}
    for kind in KINDS:
        for axis in range(3):
            pb = sizes[kind, axis] = plane_bytes(h, kind, axis, A, dtype)
            recvs = exchange._route(h, axis)[2]
            for q in sorted(recvs):
                offsets[kind, axis, q] = at
                at += len(recvs[q]) * pb
    return offsets, sizes, at


def _peers(h: Halo) -> list:
    """The processes this one sends planes to (and receives from)."""
    return sorted({q for axis in range(3)
                   for q in exchange._route(h, axis)[1]})


class Link:
    """This process's side of the ki transports across processes: the
    arena layout, the stage schedule and, on the card, the arena (its
    receive planes and counters), the peers' arenas opened through their
    IPC handles, and where this process's planes go in each of them.  Made
    at the first cross-process ki call, by every process at once."""

    def __init__(self, h: Halo, A: int, dtype: torch.dtype):
        mesh = h.mesh
        self.A, self.dtype = A, dtype
        self.device = mesh.device
        self.nprocs, self.me = mesh.nprocs, mesh.proc
        self.offsets, self.sizes, self.nbytes = arena_layout(h, A, dtype)
        self.schedule = Schedule()
        self.arena = None
        self.peer_views = {}     # process -> uint8 view of its arena
        self.peer_offsets = {}   # process -> {(kind, axis): my planes' off}
        if self.device.type == "cuda":
            self._open(h)

    def _open(self, h: Halo) -> None:
        """Allocate the arena, gather every process's handle, layout and
        card, open the peers' arenas and probe the counters; a step that
        fails on any process raises on all of them."""
        P, me = self.nprocs, self.me
        err = None
        try:
            self.arena = comm.Arena(self.nbytes, self.device)
            handle = np.frombuffer(self.arena.handle, np.uint8)
        except RuntimeError as e:
            err, handle = e, np.zeros(64, np.uint8)
        table = np.full((len(KINDS), 3, P), -1, np.int64)
        for (kind, axis, q), off in self.offsets.items():
            table[KINDS.index(kind), axis, q] = off
        info = np.array([self.nbytes, self.device.index], np.int64)
        handles, tables, infos = (dist.allgather(handle),
                                  dist.allgather(table),
                                  dist.allgather(info))
        if not dist.all_ok(err is None):
            raise err or RuntimeError("the ki arena failed on another "
                                      "process")
        dist.at_destroy(self.close)
        try:
            for q in _peers(h):
                base = self.arena.open(q, handles[q].tobytes(),
                                       int(infos[q, 1]))
                self.peer_views[q] = comm.device_bytes(base,
                                                       int(infos[q, 0]))
                self.peer_offsets[q] = {
                    (kind, axis): int(tables[q, k, axis, me])
                    for k, kind in enumerate(KINDS) for axis in range(3)}
                # the counters reach the peer's arena (once)
                self.write(q, counter_word("probe", "", 0, me, P), 1)
            own = counter_word("probe", "", 0, me, P)
            self.write(me, own, 1)
            self.wait(own, 1)
            torch.cuda.synchronize(self.device)
        except RuntimeError as e:
            err = e
        if not dist.all_ok(err is None):
            raise err or RuntimeError("opening the ki arenas failed on "
                                      "another process")

    def close(self) -> None:
        if self.arena is not None:
            self.peer_views = {}
            self.arena.close()
            self.arena = None

    # ---- counters (the card) ----

    def _addr(self, proc: int, word: int) -> int:
        base = self.arena.ptr if proc == self.me else \
            self.peer_views[proc].data_ptr()
        return base + 4 * word

    def write(self, proc: int, word: int, value: int) -> None:
        """The stream writes ``value`` to counter ``word`` of process
        ``proc``'s arena, after every earlier write of the stream."""
        comm.stream_write(self._addr(proc, word), value, self.device)

    def wait(self, word: int, value: int) -> None:
        """The stream waits until counter ``word`` of this process's arena
        has reached ``value``."""
        comm.stream_wait(self._addr(self.me, word), value, self.device)

    # ---- buffers ----

    def outbox(self, kind: str, axis: int, q: int, nbytes: int):
        """Where this process's planes of stage (kind, axis) for process
        ``q`` go: a view of q's arena (the card) or a host buffer that
        ``dist.exchange`` sends (the CPU)."""
        if self.arena is None:
            return torch.zeros(nbytes, dtype=torch.uint8)
        off = self.peer_offsets[q][kind, axis]
        return self.peer_views[q][off:off + nbytes]

    def inbox(self, kind: str, axis: int, q: int, nbytes: int):
        """Where process ``q``'s planes of stage (kind, axis) arrive: a view
        of this process's arena (the card); None on the CPU, where
        ``dist.exchange`` returns them."""
        if self.arena is None:
            return None
        off = self.offsets[kind, axis, q]
        return self.arena.view[off:off + nbytes]

    # ---- one stage ----

    def begin(self, kind: str, axis: int, st: "_Stage") -> dict:
        """Before the push of stage (kind, axis): its counter values, and
        on the card the wait until every receiver has released its
        planes."""
        v = self.schedule.next(kind, axis)
        if self.arena is not None and v["wait_free"] > 0:
            for q in st.sends:
                self.wait(counter_word("free", kind, axis, q, self.nprocs),
                          v["wait_free"])
        return v

    def deliver(self, h: Halo, kind: str, axis: int, v: dict,
                st: "_Stage") -> dict:
        """After the push: the planes that arrived here, {sender process:
        uint8 buffer}.  The card: the data counters written into the
        receivers' arenas, then the wait on this process's own; the CPU:
        one ``dist.exchange`` of the outboxes."""
        sent = sum(len(v_) for v_ in st.sends.values()) * st.pb
        count = ("planes", kind)
        h.traffic[count] = h.traffic.get(count, 0) + sent
        if not st.recvs:
            return {}
        if self.arena is None:
            nbytes = {q: len(sl) * st.pb for q, sl in st.recvs.items()}
            return dist.exchange(st.outbox, nbytes,
                                 h.bufs.setdefault(("ki", kind, axis,
                                                    st.pb), {}), h.traffic)
        for q in st.sends:
            self.write(q, counter_word("data", kind, axis, self.me,
                                       self.nprocs), v["write_data"])
        for q in st.recvs:
            self.wait(counter_word("data", kind, axis, q, self.nprocs),
                      v["wait_data"])
        return st.inbox

    def release(self, kind: str, axis: int, v: dict, st: "_Stage") -> None:
        """After the unpack (the card): the free counters written into the
        senders' arenas."""
        if self.arena is None:
            return
        for q in st.recvs:
            self.write(q, counter_word("free", kind, axis, self.me,
                                       self.nprocs), v["write_free"])


class _Stage(NamedTuple):
    """One stage across processes, made once a field layout."""
    plan: object      # FillPlan or PushPlan, its planes in the outboxes
    pb: int           # bytes of a plane (fill) or plane set (atoms)
    sends: dict       # receiver process -> [(sender slot, k)], in order
    recvs: dict       # sender process -> [(receiver slot, k)], in order
    outbox: dict      # receiver process -> uint8 buffer of its planes
    inbox: dict       # sender process -> uint8 view of my arena (card)


def _link(h: Halo, A: int, dtype: torch.dtype) -> Link:
    link = h.ipc.get("link")
    if link is None:
        link = h.ipc["link"] = Link(h, A, dtype)
    elif (link.A, link.dtype) != (A, dtype):
        raise ValueError(f"the ki arena holds planes of A = {link.A} "
                         f"{link.dtype}, not A = {A} {dtype}")
    return link


def _typed(buf: torch.Tensor, off: int, shape, dtype) -> torch.Tensor:
    """The bytes of ``buf`` from ``off`` as a ``dtype`` tensor of
    ``shape``."""
    n = int(np.prod(shape)) * dtype.itemsize
    return buf[off:off + n].view(dtype).reshape(shape)


def _stage(h: Halo, link: Link, kind: str, axis: int, make):
    """The routes, outboxes and inboxes of stage (kind, axis), and the
    destination maps of its two kernel directions: ``to[d][j]`` is the
    receiver slot of sender slot j's direction-d rows in this process, or
    S + the index of its plane in another.  ``make(to, planes)`` makes the
    plan.  The kernel's direction of a message k of ``_route`` (k = 0: to
    the sender's minus neighbor) is k for the fill and 1 - k for the atoms
    (ki_comm's directions, as fill_plan and atom_plan set them)."""
    local, sends, recvs = exchange._route(h, axis)
    S = len(h.mesh.owned)
    pb = link.sizes[kind, axis]
    to = [[None] * S for _ in range(2)]

    def d_of(k):
        return 1 - k if kind == "atoms" else k
    for i, k, j in local:
        to[d_of(k)][j] = i
    outbox, planes = {}, []
    for q in sorted(sends):
        buf = outbox[q] = link.outbox(kind, axis, q, len(sends[q]) * pb)
        for m, (j, k) in enumerate(sends[q]):
            to[d_of(k)][j] = S + len(planes)
            planes.append((buf, m * pb))
    assert all(t is not None for d in to for t in d), "a message has no route"
    inbox = {q: link.inbox(kind, axis, q, len(sl) * pb)
             for q, sl in recvs.items()} if link.arena is not None else {}
    return _Stage(make(to, planes), pb, sends, recvs, outbox, inbox)


def _fill_stage(h: Halo, link: Link, axis: int, x0: torch.Tensor) -> _Stage:
    key = ("fill stage", axis, tuple(x0.shape), x0.dtype)
    if key not in h.ipc:
        n, A = len(h.plan.force_send[axis][0]), x0.shape[1]

        def make(to, planes):
            return FillPlan(
                [[(h.force_send[axis][k], h.force_recv[axis][1 - k], to[k])
                  for k in (0, 1)]], x0.shape, x0.dtype, h.mesh.device,
                [_typed(b, off, (n, A), x0.dtype) for b, off in planes],
                count_as="halo_fill_stage")
        h.ipc[key] = _stage(h, link, "fill", axis, make)
    return h.ipc[key]


def _atom_stage(h: Halo, link: Link, axis: int, fields) -> _Stage:
    key = ("atom stage", axis) + tuple((tuple(f[0].shape), f[0].dtype)
                                       for f in fields)
    if key not in h.ipc:
        pb = link.sizes["atoms", axis]

        def make(to, planes):
            return PushPlan(
                [(h.atom_send[axis][1], to[0]), (h.atom_send[axis][0], to[1])],
                [(f[0].shape, f[0].dtype) for f in fields], h.mesh.device,
                [b[off:off + pb] for b, off in planes])
        h.ipc[key] = _stage(h, link, "atoms", axis, make)
    return h.ipc[key]


def _fill_push(h: Halo, link: Link, axis: int, x: list, rhobar=None,
               emb=None):
    """Stage ``axis`` of the fill across processes, up to its push: one
    launch of this process's shards (F'(rhobar) on the sender in the x
    stage when ``rhobar`` is given) into this process's fields and the
    other processes' planes.  Returns (stage, counter values)."""
    st = _fill_stage(h, link, axis, x[0])
    v = link.begin("fill", axis, st)
    if axis == 0 and rhobar is not None:
        halo_fill(st.plan, x, rhobar, emb)
    else:
        halo_fill(st.plan, x)
    return st, v


def _fill_unpack(h: Halo, axis: int, st: _Stage, got: dict, x: list):
    """Each plane that arrived from another process (``got``: {sender
    process: bytes}) copied into its receiver's halo rows, in place."""
    shape = (st.plan.n_rows[0], st.plan.shape[1])
    for q, slots in sorted(st.recvs.items()):
        for m, (i, k) in enumerate(slots):
            x[i][h.force_recv[axis][1 - k]] = _typed(got[q], m * st.pb,
                                                     shape, x[i].dtype)


def _fill_across(h: Halo, x: list, rhobar=None, emb=None) -> list:
    """The dfEmbed fill across processes, stage by stage: the push, the
    planes delivered, the unpack, the planes released.  In place."""
    link = _link(h, x[0].shape[1], x[0].dtype)
    for axis in range(3):
        st, v = _fill_push(h, link, axis, x, rhobar, emb)
        _fill_unpack(h, axis, st, link.deliver(h, "fill", axis, v, st), x)
        link.release("fill", axis, v, st)
    return x


def _atoms_push(h: Halo, link: Link, axis: int, fields):
    """Stage ``axis`` of the atom exchange across processes, up to its
    push: one launch of this process's shards.  Returns (stage, counter
    values, this process's arrival buffers)."""
    st = _atom_stage(h, link, axis, fields)
    v = link.begin("atoms", axis, st)
    return st, v, ring_push(st.plan, fields)


def _atoms_unpack(h: Halo, axis: int, st: _Stage, got: list, inbox: dict,
                  r, p, gid, n_atoms, overflow):
    """Every shard's arrivals of both directions re-binned, from this
    process's arrival buffers ``got`` or from the plane sets of other
    processes (``inbox``: {sender process: bytes}), together in one
    unload as in one process.  In place on the lists' tensors; returns
    the overflow flag (set in place)."""
    remote = {}      # (receiver slot, direction) -> its arrivals
    for q, slots in sorted(st.recvs.items()):
        for m, (i, k) in enumerate(slots):
            remote[i, 1 - k] = st.plan.set_views(
                inbox[q][m * st.pb:(m + 1) * st.pb])
    arrivals = [[remote.get((s, d)) or [g[d, s] for g in got]
                 for d in (0, 1)] for s in range(len(r))]
    _unload(h, axis, (r, p, gid, n_atoms), arrivals, overflow)
    return overflow


def _atoms_across(h: Halo, r: list, p: list, gid: list, n_atoms: list):
    """The atom exchange across processes, stage by stage: the push, the
    plane sets delivered, the re-binning, the planes released; in place
    on the shards' tensors."""
    r, p, gid, n_atoms = list(r), list(p), list(gid), list(n_atoms)
    link = _link(h, r[0].shape[-1], r[0].dtype)
    overflow = torch.zeros((), dtype=torch.bool, device=h.mesh.device)
    for axis in range(3):
        st, v, got = _atoms_push(h, link, axis, (r, p, gid, n_atoms))
        inbox = link.deliver(h, "atoms", axis, v, st)
        _atoms_unpack(h, axis, st, got, inbox, r, p, gid, n_atoms, overflow)
        link.release("atoms", axis, v, st)
    return r, p, gid, n_atoms, overflow


def _position_stage(h: Halo, link: Link, axis: int,
                    r0: torch.Tensor) -> _Stage:
    """Stage ``axis`` of the position refresh across processes: direction
    k of ``_route`` sends the face rows ``force_send[axis][k]`` into the
    rows ``force_recv[axis][1 - k]`` of a shard of this process, or row by
    row into a receive plane [3, n, A], with coordinate ``axis`` shifted
    by +ext (k = 0, the message to the minus neighbor) or -ext."""
    key = ("position stage", axis, tuple(r0.shape), r0.dtype)
    if key not in h.ipc:
        send, recv = h.plan.force_send[axis], h.plan.force_recv[axis]
        n, S = len(send[0]), len(h.mesh.owned)
        rows = np.arange(n)

        def make(to, planes):
            parts = []
            for k in (0, 1):
                signs = np.zeros((n, 3), np.int64)
                signs[:, axis] = 1 - 2 * k
                for j, t in enumerate(to[k]):
                    parts.append((np.full(n, t),
                                  recv[1 - k] if t < S else rows,
                                  np.full(n, j), send[k], signs))
            return PositionPlan(
                RowMap(*(np.concatenate(v) for v in zip(*parts))),
                r0.shape, r0.dtype, h.mesh.device, h.ext, S,
                [_typed(b, off, (3, n) + tuple(r0.shape[2:]), r0.dtype)
                 for b, off in planes], count_as="position_fill_stage")
        h.ipc[key] = _stage(h, link, "positions", axis, make)
    return h.ipc[key]


def _positions_push(h: Halo, link: Link, axis: int, r: list):
    """Stage ``axis`` of the position refresh across processes, up to its
    push: one launch of this process's shards, its own receivers' rows
    written and the other processes' into their planes, all shifted.
    Returns (stage, counter values)."""
    st = _position_stage(h, link, axis, r[0])
    v = link.begin("positions", axis, st)
    position_fill(st.plan, r)
    return st, v


def _positions_unpack(h: Halo, axis: int, st: _Stage, got: dict, r: list):
    """Each plane that arrived from another process (``got``: {sender
    process: bytes}), shifted by its sender, copied into its receiver's
    halo rows, in place."""
    shape = (3, len(h.plan.force_send[axis][0])) + tuple(r[0].shape[2:])
    for q, slots in sorted(st.recvs.items()):
        for m, (i, k) in enumerate(slots):
            r[i][:, h.force_recv[axis][1 - k]] = _typed(got[q], m * st.pb,
                                                        shape, r[i].dtype)


def _positions_across(h: Halo, r: list) -> list:
    """The position refresh across processes, stage by stage: the push,
    the planes delivered, the unpack, the planes released.  In place."""
    link = _link(h, r[0].shape[-1], r[0].dtype)
    for axis in range(3):
        st, v = _positions_push(h, link, axis, r)
        _positions_unpack(h, axis, st,
                          link.deliver(h, "positions", axis, v, st), r)
        link.release("positions", axis, v, st)
    return r
