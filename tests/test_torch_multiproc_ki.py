"""``--commImpl ki|ki_fused`` across processes (the multi-process launch)
on the CPU.

Across processes every stage of the dfEmbed fill and of the atom
exchange is one push of a process's shards: receivers in the process get
their rows directly, receivers in other processes get a receive plane,
which they unpack themselves.  On the CPU the plain versions push and the
planes move over gloo (``dist.exchange``); the card's CUDA IPC arena and
stream counters are held by chip_smoke.py phase 17.  The checks:

  - launches (f64, 0.8 A displacements, so atoms change shard and the
    atom stages cross): process 0 prints the single-process rows under the
    same --commImpl digit for digit -- 2 processes on 2x2x2 under ki and
    ki_fused, 4 on 2x2x1 under ki_fused (x and y cross, z is the shard
    itself), 2 with -a 1 under ki_fused, 2 with -m thread_atom_nl under ki
    (8^3: the fill is collective, the atom exchange ki);
  - in one process, for 2, 4 and 8 processes of a 2x2x2 mesh: every
    process's stage pushes, then every process's unpacks, with the planes
    handed from sender to receiver as the routes say, give the
    single-process fill (ki and ki_fused, F' on the sender) and atom
    exchange bit for bit; each sender's planes fill exactly the region its
    receiver's arena layout keeps for them;
  - the stage schedule's counters: a model of the arena counters, with
    processes running ahead of each other in random order, never lets a
    push overwrite a plane its receiver has not unpacked and never lets an
    unpack read a plane of another call, over fills and atom stages with
    rebuckets; without the "free" wait the model does catch an overwrite.
"""
import os
import random

import numpy as np
import pytest
import torch

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.ops import binning
from comd_tpu_torch.ops.cuda.comm import halo_fill_plain
from comd_tpu_torch.parallel import exchange, ki_comm
from comd_tpu_torch.parallel.mesh import make_mesh

from test_torch_multiproc import EAM6, MESH222, ROOT, check_launch

torch.set_num_threads(1)

POTS = os.path.join(ROOT, "pots")

EAM8 = [a if a != "6" else "8" for a in EAM6]


# --------------------------------------------------------------------------
# launches: process 0 against the single process, same --commImpl
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,args", [
    (2, EAM6 + MESH222 + ["--commImpl", "ki"]),
    (2, EAM6 + MESH222 + ["--commImpl", "ki_fused"]),
    (4, EAM6 + ["-i", "2", "-j", "2", "-k", "1", "--commImpl", "ki_fused"]),
    (2, EAM6 + MESH222 + ["-a", "1", "--commImpl", "ki_fused"]),
    (2, EAM8 + MESH222 + ["-m", "thread_atom_nl", "--commImpl", "ki"]),
], ids=["ki-2", "ki_fused-2", "ki_fused-4-2x2x1", "ki_fused-2-a1",
        "ki-2-nl"])
def test_ki_launch_prints_single_rows(n, args):
    out = check_launch(n, args, 3)
    assert "no atoms lost" in out
    assert f"--commImpl {args[args.index('--commImpl') + 1]}" in out


# --------------------------------------------------------------------------
# in one process: the stages of every process, planes handed over
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_sim():
    """A thermalized 8^3 EAM run on the 2x2x2 mesh in one process (f64)."""
    sim = init_simulation(Config(
        nx=8, ny=8, nz=8, doeam=True, temperature=600.0, dtype="float64",
        max_atoms=48, pot_dir=POTS, device="cpu", xproc=2, yproc=2,
        zproc=2, comm_impl="ki_fused"))
    sim.step_block(5)
    return sim


def _processes(sim, n: int, A: int, dtype):
    """The Halo and Link of each of ``n`` processes of sim's mesh."""
    out = []
    for proc in range(n):
        h = exchange.make_halo(make_mesh(2, 2, 2, "cpu", nprocs=n,
                                         proc=proc),
                               sim.geom, sim.maps, sim.plan, dtype)
        out.append((h, ki_comm.Link(h, A, dtype)))
    return out


def _handed(procs, b: int, st_of, kind: str, axis: int) -> dict:
    """The planes process ``b`` receives in stage (kind, axis): each
    sender's outbox for b, which must fill exactly the region of b's arena
    that b's layout keeps for that sender."""
    lb = procs[b][1]
    got = {}
    for a in st_of[b].recvs:
        box = st_of[a].outbox[b]
        assert box.numel() == len(st_of[b].recvs[a]) * st_of[b].pb
        assert st_of[a].sends[b] and len(st_of[a].sends[b]) == \
            len(st_of[b].recvs[a])
        off = lb.offsets[kind, axis, a]
        assert off % 16 == 0 and off + box.numel() <= lb.nbytes
        got[a] = box
    return got


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("fused", [False, True], ids=["ki", "ki_fused"])
def test_fill_across_processes_in_one_process(mesh_sim, n, fused):
    """Every process's fill stages, planes handed to their receivers,
    equal the single-process fill bit for bit (F' on the sender under
    ki_fused)."""
    sim = mesh_sim
    h1 = sim.halo
    B, A = sim.states[0].gid.shape
    nl = sim.geom.n_local
    rng = np.random.default_rng(11)
    rho = [torch.from_numpy(rng.uniform(0.5, 3.0, (nl, A)))
           for _ in range(8)]
    x = []
    for r in rho:
        v = torch.from_numpy(rng.uniform(-1, 1, (B, A)))
        v[:nl] = sim.f_eval(r)[1]
        x.append(v)
    extra = (rho, sim.f_eval) if fused else ()
    want = halo_fill_plain(ki_comm.fill_plan(h1, x[0]),
                           [v.clone() for v in x], *extra)
    procs = _processes(sim, n, A, torch.float64)
    mine = [[x[s].clone() for s in h.mesh.owned] for h, _l in procs]
    for axis in range(3):
        st_of = []
        for (h, link), xs in zip(procs, mine):
            own_rho = [rho[s] for s in h.mesh.owned] if fused else None
            st, _v = ki_comm._fill_push(h, link, axis, xs, own_rho,
                                        sim.f_eval if fused else None)
            assert len(st.plan.planes) == sum(len(v) for v in
                                              st.sends.values())
            st_of.append(st)
        for b, ((h, _l), xs) in enumerate(zip(procs, mine)):
            ki_comm._fill_unpack(h, axis, st_of[b],
                                 _handed(procs, b, st_of, "fill", axis), xs)
    got = [v for xs in mine for v in xs]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_atoms_across_processes_in_one_process(mesh_sim, n):
    """Every process's atom stages, plane sets handed to their receivers,
    equal the single-process exchange bit for bit, migrants included."""
    sim = mesh_sim
    B, A = sim.states[0].gid.shape
    rng = np.random.default_rng(5)
    reb = []
    for s in sim.states:       # a kick that moves atoms across faces
        r = s.r + torch.from_numpy(rng.normal(0, 0.6, s.r.shape))
        reb.append(binning.rebucket(sim.geom, sim.maps, r, s.p, s.gid,
                                    s.n_atoms, keep_halo=True)[:4])
    fields = [list(f) for f in zip(*reb)]
    want = ki_comm.exchange_atoms_ki(sim.halo,
                                     *[[t.clone() for t in f] for f in fields])
    procs = _processes(sim, n, A, torch.float64)
    mine = [[[f[s] for s in h.mesh.owned] for f in fields]
            for h, _l in procs]
    ovf = [torch.zeros((), dtype=torch.bool) for _ in procs]
    for axis in range(3):
        pushed = [ki_comm._atoms_push(h, link, axis, tuple(f))
                  for (h, link), f in zip(procs, mine)]
        st_of = [st for st, _v, _g in pushed]
        for b, ((h, _l), f) in enumerate(zip(procs, mine)):
            ovf[b] = ki_comm._atoms_unpack(
                h, axis, st_of[b], pushed[b][2],
                _handed(procs, b, st_of, "atoms", axis), *f, ovf[b])
    for k in range(4):
        got = [t for f in mine for t in f[k]]
        assert all(torch.equal(a, b) for a, b in zip(got, want[k]))
    assert bool(torch.stack(ovf).any()) == bool(want[4])


# --------------------------------------------------------------------------
# the stage schedule's counters
# --------------------------------------------------------------------------

def _run_model(calls, nprocs: int, seed: int, wait_free: bool = True):
    """Run ``calls`` ((kind, axis) stages, the same on every process) on a
    model of the arena counters, all-to-all, each process advancing op by
    op in random order as far as its waits let it: per stage a wait on
    every receiver's "free" counter, the push of a tagged plane to each,
    the "data" writes, the waits on its own data counters, the unpacks
    and the "free" writes.  Returns the faults seen (a push over a plane
    not yet unpacked, an unpack of another call's plane); raises on a
    deadlock."""
    mem = [dict() for _ in range(nprocs)]      # arena counters
    plane = {}                                 # (sender, receiver, kind,
    read = {}                                  #  axis) -> call tag
    faults = []

    def ops(p):
        sched = ki_comm.Schedule()
        peers = [q for q in range(nprocs) if q != p]
        for kind, axis in calls:
            v = sched.next(kind, axis)
            n = v["write_data"]
            for q in peers:
                if wait_free:
                    yield ("wait", ki_comm.counter_word(
                        "free", kind, axis, q, nprocs), v["wait_free"])
            for q in peers:
                yield ("push", (p, q, kind, axis), n)
            for q in peers:
                yield ("write", q, ki_comm.counter_word(
                    "data", kind, axis, p, nprocs), v["write_data"])
            for q in peers:
                yield ("wait", ki_comm.counter_word(
                    "data", kind, axis, q, nprocs), v["wait_data"])
            for q in peers:
                yield ("unpack", (q, p, kind, axis), n)
            for q in peers:
                yield ("write", q, ki_comm.counter_word(
                    "free", kind, axis, p, nprocs), v["write_free"])

    progs = [ops(p) for p in range(nprocs)]
    nxt = [next(g, None) for g in progs]
    rng = random.Random(seed)
    while any(op is not None for op in nxt):
        ready = [p for p, op in enumerate(nxt) if op is not None and (
            op[0] != "wait" or mem[p].get(op[1], 0) >= op[2])]
        assert ready, "the schedule deadlocks"
        p = rng.choice(ready)
        op = nxt[p]
        if op[0] == "write":
            mem[op[1]][op[2]] = op[3]
        elif op[0] == "push":
            if plane.get(op[1]) is not None and not read.get(op[1]):
                faults.append(("overwrite", op))
            plane[op[1]], read[op[1]] = op[2], False
        elif op[0] == "unpack":
            if plane.get(op[1]) != op[2]:
                faults.append(("stale", op))
            read[op[1]] = True
        nxt[p] = next(progs[p], None)
    return faults


def test_stage_schedule_counters():
    """Fills (three stages a force), atom stages (three a rebucket, on
    the same steps everywhere) and position stages (three a step that
    does not rebucket), three processes all to all, and two whose x
    stages alone cross: the counters order every push after the
    receiver's last unpack and every unpack after its push, whatever
    order the processes run in."""
    rng = random.Random(3)
    calls, refreshed = [], []
    for step in range(12):
        if step % 4 == 0 or rng.random() < 0.3:
            calls += [("atoms", a) for a in range(3)]
            refreshed += [("atoms", a) for a in range(3)]
        else:
            refreshed += [("positions", a) for a in range(3)]
        calls += [("fill", a) for a in range(3)]
        refreshed += [("fill", a) for a in range(3)]
    assert ki_comm.epoch_values(1) == {"wait_free": 0, "write_data": 1,
                                       "wait_data": 1, "write_free": 1}
    assert ki_comm.KINDS == ("fill", "atoms", "positions")
    words = {ki_comm.counter_word(r, k, a, q, 3) for r in ("data", "free")
             for k in ki_comm.KINDS for a in range(3) for q in range(3)}
    assert len(words) == 54 and max(words) < \
        ki_comm.counter_word("probe", "", 0, 0, 3)
    # 2 processes on 2x2x2: only the x stages cross
    x_only = [c for c in calls if c[1] == 0]
    for seed in range(20):
        assert _run_model(calls, 3, seed) == []
        assert _run_model(x_only, 2, seed) == []
        assert _run_model(refreshed, 3, seed) == []
        assert _run_model([c for c in refreshed if c[1] == 0], 2,
                          seed) == []
    # without the wait on "free" a sender whose other stages stay in its
    # process runs ahead into a plane its receiver has not unpacked yet
    assert any(f[0] == "overwrite" for seed in range(20)
               for f in _run_model(x_only, 2, seed, wait_free=False))
