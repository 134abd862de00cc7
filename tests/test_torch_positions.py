"""The mesh's ghost-position refresh as one row map, on the CPU.

Between rebuckets a lazy mesh step refreshes every ghost row's positions
from its owner row (comd_tpu's exchange_positions: three ppermutes, a
per-axis periodic shift).  The port runs it as one ``position_fill``
launch over the three stages composed into one row map
(parallel/exchange.py::position_map), and across processes as one launch
a stage (parallel/ki_comm.py).  On the CPU the wrapper runs its plain
version (``position_fill_plain``: one gather, one add, one put a target),
which these tests hold, bit for bit, against:

  - comd_tpu's exchange_positions under shard_map on the 8-device virtual
    CPU mesh and the port's staged exchange.exchange_positions, on the
    2x2x2, 3x2x1 and 1x1x2 geometries of tests/test_torch_exchange.py, f32
    and f64, every halo row written;
  - the map's own invariants, against the cell tuples: every halo row of
    every shard once, no local row a destination, every source a local
    row, the source the owner cell (the destination's cell wrapped into the
    neighbor shard), the sign of each coordinate's shift the side of the
    halo it lies on;
  - the ctypes argument struct against csrc/comm.cu's PositionArgs;
  - the stage form across processes, every process's stages run in one
    process (2 and 4 processes, ki and ki_fused), its planes handed to
    their receivers: the refresh of the single process;
  - a lazy 2x2x2 mesh run (f64, refresh steps and rebuckets) through the
    step's dispatch against the same run on the staged exchange;
  - the plan's refusals (a row written twice, a row both read and
    written, a plane not written row by row, a sign out of range,
    positions not [3, B, A] float).

The kernel itself is held on the card (tests/test_torch_kernel_cuda.py,
chip_smoke.py phase 21).
"""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from comd_tpu import cells as jcells
from comd_tpu.parallel import exchange as jex
from comd_tpu.parallel.sharded import make_mesh as j_make_mesh

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import shards_to_numpy
from comd_tpu_torch.ops.cuda import comm as cm
from comd_tpu_torch.ops.cuda.comm import (PositionPlan, RowMap,
                                          position_fill,
                                          position_fill_plain)
from comd_tpu_torch.parallel import exchange as tex, ki_comm
from comd_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
SPEC = P("x", "y", "z")

# tests/test_torch_exchange.py's meshes: (box in unit cells, mesh,
# max_atoms)
MESHES = {"2x2x2": ((8, 8, 8), (2, 2, 2), 48),
          "3x2x1": ((9, 6, 6), (3, 2, 1), 32),
          "1x1x2": ((6, 6, 6), (1, 1, 2), 32)}


def _shard_map(mesh, fn, x):
    """``fn`` on every shard's block of ``x`` ([Px, Py, Pz, ...] numpy)
    under comd_tpu's shard_map; the output stacked as numpy."""
    def body(v):
        return fn(v[0, 0, 0])[None, None, None]

    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(SPEC,), out_specs=SPEC,
        check_vma=False))(jnp.asarray(x)))


def _stack(xs, grid):
    return np.stack([x.numpy() for x in xs]).reshape(
        tuple(grid) + tuple(xs[0].shape))


@pytest.fixture(scope="module", params=list(MESHES))
def setup(request):
    """The port's sharded EAM init (f64) and comd_tpu's geometry and mesh
    for the same shards."""
    box, grid, A = MESHES[request.param]
    sim = init_simulation(Config(
        nx=box[0], ny=box[1], nz=box[2], doeam=True, temperature=600.0,
        dtype="float64", max_atoms=A, box_chunk=64, pot_dir=POTS,
        device="cpu", xproc=grid[0], yproc=grid[1], zproc=grid[2]))
    tg = sim.geom
    jg = jcells.make_geometry(tg.local_min, tg.local_max, 1.0,
                              use_hilbert=tg.use_hilbert,
                              cell_size=tg.box_size)
    np.testing.assert_array_equal(jg.tuple_of_box, tg.tuple_of_box)
    return sim, jg, j_make_mesh(*grid), grid


def _halo(sim, dtype):
    return tex.make_halo(sim.mesh, sim.geom, sim.maps, sim.plan, dtype)


def _bits(x):
    """A float array's bits as integers: -0.0 and +0.0 differ."""
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int64)


def _same_bits(a, b) -> bool:
    return np.array_equal(_bits(a.numpy()), _bits(b.numpy()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_plain_matches_comd_tpu_and_staged(setup, dtype):
    """position_fill on the composed map (the plain version on the CPU)
    equals comd_tpu's exchange_positions and the port's staged one bit for
    bit, on positions displaced off the lattice (a slot of -0.0 in each
    local row) and halo rows of noise that must all be overwritten."""
    sim, jg, jmesh, grid = setup
    h = _halo(sim, dtype)
    nl = sim.geom.n_local
    st = shards_to_numpy(sim.states, grid)
    rng = np.random.default_rng(5)
    r = st["r"] + rng.uniform(-0.3, 0.3, st["r"].shape)
    r[..., :nl, 0] = -0.0       # a copy with no shift keeps the sign of 0
    r[..., nl:, :] = rng.uniform(-50, 50, r[..., nl:, :].shape)
    r = r.astype(np.float32 if dtype == torch.float32 else np.float64)
    start = [torch.from_numpy(np.array(r[idx])) for idx in
             np.ndindex(*grid)]
    jp = jex.make_plan(jg)
    want_j = _shard_map(jmesh, lambda v: jex.exchange_positions(jp, jg, v),
                        r)
    want_t = tex.exchange_positions(h, [x.clone() for x in start])
    plan = ki_comm.position_plan(h, start[0])
    assert plan is ki_comm.position_plan(h, start[1])          # made once
    got = position_fill(plan, [x.clone() for x in start])
    np.testing.assert_array_equal(_bits(_stack(got, grid)), _bits(want_j))
    assert all(_same_bits(a, b) for a, b in zip(got, want_t))
    assert all(_same_bits(a[:, :nl], b[:, :nl]) and
               (a[:, nl:] != b[:, nl:]).all() for a, b in zip(got, start))
    assert plan.n_rows == len(start) * (sim.geom.n_total - nl)


def test_position_map_invariants(setup):
    """The composed map against the cell tuples: every halo row of every
    shard a destination once, no local row a destination; each source a
    local row of the owner cell, the destination's cell wrapped onto the
    neighbor shard on each side it lies out of; the shift on coordinate c
    +1 on the plus halo side (a row from the plus neighbor), -1 on the
    minus side, 0 inside."""
    sim, _jg, _jmesh, grid = setup
    h = _halo(sim, torch.float64)
    m = tex.position_map(h)
    assert m is tex.position_map(h)                           # made once
    geom, S = sim.geom, sim.mesh.size
    nl, B = geom.n_local, geom.n_total
    g = np.array(geom.grid)
    key = m.dst * B + m.dst_row
    assert np.array_equal(np.sort(key), (np.arange(S)[:, None] * B +
                                         np.arange(nl, B)).reshape(-1))
    assert (m.src_row < nl).all() and (m.dst_row >= nl).all()
    t = geom.tuple_of_box[m.dst_row]                           # [N, 3]
    want_signs = np.where(t == g, 1, np.where(t < 0, -1, 0))
    np.testing.assert_array_equal(m.signs, want_signs)
    np.testing.assert_array_equal(geom.tuple_of_box[m.src_row],
                                  t - want_signs * g)
    coords = np.array(sim.mesh.coords)
    np.testing.assert_array_equal(
        coords[m.src], (coords[m.dst] + want_signs) % np.array(grid))


def _cu_struct(name: str) -> tuple:
    """csrc/comm.cu's struct ``name`` as (member, kind, dims) and the
    source's integer constants."""
    with open(cm.SOURCE) as fh:
        text = fh.read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = ([0-9]+);", text)}
    consts["kMaxPlanes"] = 2 * consts["kMaxShards"]
    assert re.search(r"constexpr int kMaxPlanes = 2 \* kMaxShards;", text)
    body = re.search(r"\nstruct " + name + r" \{\n(.*?)\n\};", text,
                     re.S).group(1)
    members = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(?:const )?(\w+(?: \w+)?)(\*?) (\w+)"
                         r"((?:\[\w+\])*);", line)
        assert m, line
        base, ptr, member, dims = m.groups()
        members.append((member, "pointer" if ptr else base,
                        [consts[d] if d in consts else int(d)
                         for d in re.findall(r"\[(\w+)\]", dims)]))
    return members, consts


def test_args_mirror_the_source():
    """ops/cuda/comm.py's _PositionArgs holds csrc/comm.cu's PositionArgs
    member for member, in order and kind (an int, a long long, a double, a
    pointer; the array extents), and the limits equal the kernel's, so the
    mirror cannot drift."""
    members, consts = _cu_struct("PositionArgs")
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_longlong: "long long", ctypes.c_double: "double"}
    mirror = []
    for name, t in cm._PositionArgs._fields_:
        dims = []
        while hasattr(t, "_length_"):
            dims.append(t._length_)
            t = t._type_
        mirror.append((name, kinds[t], dims))
    assert members == mirror
    assert (consts["kMaxShards"], consts["kMaxPlanes"],
            consts["kThreads"] // 32) == (cm.MAX_SHARDS, cm.MAX_PLANES,
                                          cm.WARPS)
    assert ctypes.sizeof(cm._PositionArgs) < 4096   # a kernel's parameters


@pytest.fixture(scope="module", params=["ki", "ki_fused"])
def mesh_sim(request):
    """A thermalized 8^3 EAM run on the 2x2x2 mesh in one process (f64)."""
    sim = init_simulation(Config(
        nx=8, ny=8, nz=8, doeam=True, temperature=600.0, dtype="float64",
        max_atoms=48, pot_dir=POTS, device="cpu", xproc=2, yproc=2,
        zproc=2, comm_impl=request.param))
    sim.step_block(5)
    return sim


@pytest.mark.parametrize("n", [2, 4])
def test_stages_across_processes_in_one_process(mesh_sim, n):
    """Every process's position stages (one launch each: its receivers'
    rows written and the other processes' planes filled, shifted on the
    sender), the planes handed to their receivers and unpacked, equal the
    single-process refresh bit for bit; each sender's planes fill exactly
    the region its receiver's arena keeps for them."""
    sim = mesh_sim
    A = sim.states[0].gid.shape[1]
    rng = np.random.default_rng(9)
    r = [s.r + torch.from_numpy(rng.uniform(-0.2, 0.2, s.r.shape))
         for s in sim.states]
    for x in r:
        x[:, :sim.geom.n_local, 0] = -0.0
    want = tex.exchange_positions(sim.halo, [x.clone() for x in r])
    procs = []
    for proc in range(n):
        h = tex.make_halo(make_mesh(2, 2, 2, "cpu", nprocs=n, proc=proc),
                          sim.geom, sim.maps, sim.plan, torch.float64)
        procs.append((h, ki_comm.Link(h, A, torch.float64)))
    mine = [[r[s].clone() for s in h.mesh.owned] for h, _l in procs]
    crossed = 0
    for axis in range(3):
        st_of = [ki_comm._positions_push(h, link, axis, xs)[0]
                 for (h, link), xs in zip(procs, mine)]
        for b, ((h, lb), xs) in enumerate(zip(procs, mine)):
            got = {}
            for a in st_of[b].recvs:
                box = st_of[a].outbox[b]
                assert box.numel() == len(st_of[b].recvs[a]) * st_of[b].pb
                off = lb.offsets["positions", axis, a]
                assert off % 16 == 0 and off + box.numel() <= lb.nbytes
                got[a] = box
            crossed += len(got)
            ki_comm._positions_unpack(h, axis, st_of[b], got, xs)
        assert all(st.plan.count_as == "position_fill_stage"
                   for st in st_of)
    assert crossed > 0
    flat = [v for xs in mine for v in xs]
    assert all(_same_bits(a, b) for a, b in zip(flat, want))


def test_position_plane_bytes():
    """A position receive plane holds the three coordinate rows of a
    stage's face cells: 3 x a fill plane, 16-byte aligned."""
    sim = init_simulation(Config(
        nx=8, ny=8, nz=8, doeam=True, temperature=600.0, dtype="float32",
        max_atoms=32, pot_dir=POTS, device="cpu", xproc=2, yproc=2,
        zproc=2))
    h = tex.make_halo(make_mesh(2, 2, 2, "cpu", nprocs=2), sim.geom,
                      sim.maps, sim.plan, torch.float32)
    for axis in range(3):
        n = len(sim.plan.force_send[axis][0])
        for A in (16, 13):
            fill = ki_comm.plane_bytes(h, "fill", axis, A, torch.float32)
            pos = ki_comm.plane_bytes(h, "positions", axis, A,
                                      torch.float32)
            assert pos == -(-3 * n * A * 4 // 16) * 16 and pos % 16 == 0
            assert fill == -(-n * A * 4 // 16) * 16
    offsets, sizes, nbytes = ki_comm.arena_layout(h, 16, torch.float32)
    assert {k for k, _a, _q in offsets} == {"fill", "atoms", "positions"}
    assert nbytes >= sum(sizes[k, a] for k, a, _q in offsets)


def test_lazy_mesh_run_through_the_dispatch_equals_staged(monkeypatch):
    """A lazy 2x2x2 mesh run (f64, displaced atoms: refresh steps and
    rebuckets) whose refreshes go through the step's dispatch (the
    composed map, position_fill's plain version here) ends with the bits
    of the same run on the staged exchange.exchange_positions: r, p and
    ePot."""
    cfg = Config(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
                 initial_delta=0.4, dtype="float64", pot_dir=POTS,
                 device="cpu", xproc=2, yproc=2, zproc=2)
    calls = []
    orig = cm.position_fill_plain

    def counted(plan, r):
        calls.append(plan.count_as)
        return orig(plan, r)

    runs = []
    for staged in (False, True):
        with monkeypatch.context() as m:
            m.setattr(cm, "position_fill_plain", counted)
            if staged:
                m.setattr(ki_comm, "exchange_positions_ki",
                          tex.exchange_positions)
            sim = init_simulation(cfg)
            calls.clear()
            sim.step_block(10)
            sim.step_block(10)
            runs.append((sim, list(calls)))
    (new, new_calls), (old, old_calls) = runs
    assert 1 <= new.n_rebucket < 20 and new.n_rebucket == old.n_rebucket
    assert new_calls == ["position_fill"] * (20 - new.n_rebucket)
    assert old_calls == []
    assert new.e_potential == old.e_potential
    for a, b in zip(new.states, old.states):
        assert _same_bits(a.r, b.r) and _same_bits(a.p, b.p)


def test_plan_refuses_what_the_kernel_cannot_take():
    """A plan is refused for a row written twice, a row both read and
    written (the launch has no barrier), a receive plane not written row
    by row once, a sign outside -1..1, and positions not [3, B, A]
    float."""
    sim = init_simulation(Config(
        nx=8, ny=8, nz=8, doeam=True, temperature=600.0, dtype="float32",
        max_atoms=32, pot_dir=POTS, device="cpu", xproc=2, yproc=2,
        zproc=2))
    h = _halo(sim, torch.float32)
    m = tex.position_map(h)
    A = sim.states[0].gid.shape[1]
    r0 = torch.zeros((3, sim.geom.n_total, A), dtype=torch.float32)
    S = sim.mesh.size

    def plan(rows, shape=r0.shape, dtype=torch.float32, planes=()):
        return PositionPlan(rows, shape, dtype, "cpu", h.ext, S, planes)

    plan(m)
    twice = RowMap(*(np.concatenate([v, v[:1]]) for v in m))
    with pytest.raises(ValueError, match="twice"):
        plan(twice)
    loop = m._replace(src=m.dst.copy(), src_row=m.dst_row.copy())
    with pytest.raises(ValueError, match="reads is a row it writes"):
        plan(loop)
    with pytest.raises(ValueError, match="signs"):
        plan(m._replace(signs=2 * m.signs))
    with pytest.raises(ValueError, match=r"\[3, B, A\]"):
        plan(m, shape=r0.shape[1:])
    with pytest.raises(ValueError, match=r"\[3, B, A\]"):
        plan(m, dtype=torch.int32)
    n = 4
    to_plane = RowMap(dst=np.full(n - 1, S), dst_row=np.arange(n - 1),
                      src=np.zeros(n - 1, int), src_row=np.arange(n - 1),
                      signs=np.zeros((n - 1, 3), int))
    with pytest.raises(ValueError, match="row by row"):
        plan(to_plane, planes=[torch.zeros(3, n, A)])
    ok = plan(to_plane, planes=[torch.zeros(3, n - 1, A)])
    assert ok.n_rows == n - 1
    r = [torch.zeros_like(r0) for _ in range(S)]
    position_fill_plain(ok, r)
    assert torch.equal(ok.planes[0], r[0][:, :n - 1])
