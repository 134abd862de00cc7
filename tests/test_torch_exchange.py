"""The port's mesh exchange against comd_tpu's, bit for bit.

comd_tpu runs its exchange as collectives inside ``shard_map`` over the
8-device virtual CPU mesh of tests/conftest.py; the port runs the same
stages over a list of shards in one process.  Both get the same per-shard
states (the port's sharded EAM init, f64: at comd_tpu's multidevice size,
8^3 unit cells with max_atoms=48 on 2x2x2, and on a 3x2x1 mesh of a 9x6x6
box and a 1x1x2 mesh of a 6^3 box, which comd_tpu's own tests never ran),
carried across as numpy blocks with a leading [Px, Py, Pz] index.  The exchange only moves data, so every result
must be equal bit for bit:

  - the plan's lists, ``local_extent``, ``atom_cap`` and ``atom_msg_bytes``
    on 2x2x2, 3x2x1 and 1x1x2 shard geometries;
  - ``exchange_scalar``, ``exchange_positions``, ``fold_halo``;
  - ``rebucket(keep_halo=True)`` of displaced atoms, then
    ``exchange_atoms`` with full planes and count-packed (one
    ``atom_pack`` call a stage), then ``sort_cells``; and the overflow
    flag of an undersized packed message;
  - K3's and K4's plain versions (``ring_push_plain``, ``pass2_push_plain``)
    against comd_tpu's ``_ring_push`` and ``_pass2_push`` in interpret mode
    on a 1-D mesh, as tests/test_pallas_comm.py runs them: K3 bitwise (the
    atom buffer's int fields through comd_tpu's float packing); K4's local
    plane within 1e-12 relative in f64 (a direct table read against the
    two-level one), and each received plane equal to the neighbor's;
  - the plain whole fill of the fill kernel (``halo_fill_plain``: ``ki``,
    and ``ki_fused`` from F' of rhobar as pass 2 computes it) against
    comd_tpu's ``exchange_scalar`` on 2x2x2 and 3x2x1, f32 and f64 (comd_tpu's
    interpret-mode pushes run only on 1-D meshes, so the per-push tests
    above cover the kernels' functions);
  - the launch plans: each field at its own vector width, both directions
    of a stage in one plan, rows and limits checked when the plan is made,
    and a plan refused for a field or mesh the kernels cannot take.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from comd_tpu import cells as jcells
from comd_tpu.ops import binning as jbin
from comd_tpu.parallel import exchange as jex
from comd_tpu.parallel.pallas_comm import (_pack_ints, _pass2_push,
                                           _ring_push, _unpack_ints,
                                           make_df_eval_for_kernel)
from comd_tpu.parallel.sharded import make_mesh as j_make_mesh
from comd_tpu.potentials.eam import init_eam_pot as j_init_eam

from comd_tpu_torch import Config, cells as tcells, init_simulation
from comd_tpu_torch.interop import shards_from_numpy, shards_to_numpy
from comd_tpu_torch.ops import binning as tbin
from comd_tpu_torch.ops.cuda import comm as cm
from comd_tpu_torch.ops.cuda.comm import (FillPlan, PushPlan,
                                          halo_fill_plain, pass2_push_plain,
                                          ring_push_plain)
from comd_tpu_torch.ops.force_eam import make_f_eval
from comd_tpu_torch.parallel import exchange as tex, ki_comm
from comd_tpu_torch.parallel.mesh import make_mesh
from comd_tpu_torch.potentials.eam import init_eam_pot

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
SPEC = P("x", "y", "z")


def _shard_map(mesh, fn, *arrays):
    """Run ``fn`` on every shard's block of ``arrays`` ([Px, Py, Pz, ...]
    numpy) under comd_tpu's shard_map; outputs come back stacked as numpy."""
    def body(*xs):
        out = fn(*[x[0, 0, 0] for x in xs])
        return jax.tree.map(lambda o: jnp.asarray(o)[None, None, None], out)

    out = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(SPEC,) * len(arrays), out_specs=SPEC,
        check_vma=False))(*[jnp.asarray(a) for a in arrays])
    return jax.tree.map(np.asarray, out)


# the meshes the exchange is held on: (box in unit cells, mesh, max_atoms
# with room for the displaced atoms of the atom-exchange test)
MESHES = {"2x2x2": ((8, 8, 8), (2, 2, 2), 48),     # comd_tpu's multidevice
          "3x2x1": ((9, 6, 6), (3, 2, 1), 32),     # 3-wide and 1-wide axes
          "1x1x2": ((6, 6, 6), (1, 1, 2), 32)}


def _stack(xs, grid):
    """Per-shard tensors -> [Px, Py, Pz, ...] numpy."""
    return np.stack([x.numpy() for x in xs]).reshape(
        tuple(grid) + tuple(xs[0].shape))


def _split(a, grid):
    """[Px, Py, Pz, ...] numpy -> per-shard tensors."""
    return [torch.from_numpy(np.array(a[idx])) for idx in np.ndindex(*grid)]


def _make_setup(name):
    """Port sharded init (EAM, f64) with comd_tpu's geometry and mesh for
    the same shards."""
    box, grid, A = MESHES[name]
    sim = init_simulation(Config(
        nx=box[0], ny=box[1], nz=box[2], doeam=True, temperature=600.0,
        dtype="float64", max_atoms=A, box_chunk=64, pot_dir=POTS,
        device="cpu", xproc=grid[0], yproc=grid[1], zproc=grid[2]))
    tg = sim.geom
    jg = jcells.make_geometry(tg.local_min, tg.local_max, 1.0,
                              use_hilbert=tg.use_hilbert,
                              cell_size=tg.box_size)
    assert jg.grid == tg.grid and min(tg.grid) >= 2
    np.testing.assert_array_equal(jg.tuple_of_box, tg.tuple_of_box)
    st = shards_to_numpy(sim.states, grid)
    return sim, jg, j_make_mesh(*grid), st, grid


@pytest.fixture(scope="module", params=list(MESHES))
def setup(request):
    return _make_setup(request.param)


@pytest.fixture(scope="module")
def cube():
    return _make_setup("2x2x2")


def test_mesh_rings_and_devices():
    """Shard order is np.ndindex's; a ring of size 2 reaches one neighbor
    both ways, a ring of size 1 is the shard itself; a single process owns
    every shard, and shards that do not split evenly over the processes
    of a launch raise ValueError naming both numbers."""
    m = make_mesh(3, 2, 1, "cpu")
    assert m.coords == [idx for idx in np.ndindex(3, 2, 1)]
    assert m.ring(0, +1) == [2, 3, 4, 5, 0, 1]
    assert m.ring(0, -1) == [4, 5, 0, 1, 2, 3]
    assert m.ring(1, +1) == m.ring(1, -1) == [1, 0, 3, 2, 5, 4]
    assert m.ring(2, +1) == m.ring(2, -1) == list(range(6))
    assert list(m.owned) == list(range(6))
    with pytest.raises(ValueError, match=r"the 8 shards .* over 3 processes"):
        make_mesh(2, 2, 2, "cpu", nprocs=3)


def _halo(sim, plan):
    return tex.make_halo(sim.mesh, sim.geom, sim.maps, plan, sim.dtype)


@pytest.mark.parametrize("box,mesh", [((8, 8, 8), (2, 2, 2)),
                                      ((9, 6, 6), (3, 2, 1)),
                                      ((6, 6, 8), (1, 1, 2))])
def test_plan_matches_comd_tpu(box, mesh):
    lat = 3.615
    local = np.array(box, np.float64) * lat / np.array(mesh)
    geoms = [m.make_geometry(np.zeros(3), local, 5.2)
             for m in (jcells, tcells)]
    assert geoms[0].grid == geoms[1].grid and min(geoms[1].grid) >= 2
    jp = jex.make_plan(geoms[0], msg_factor=0.6, max_atoms=48)
    tp = tex.make_plan(geoms[1], msg_factor=0.6, max_atoms=48)
    for name in ("atom_send", "force_send", "force_recv"):
        for (jm, jp_), (tm, tp_) in zip(getattr(jp, name), getattr(tp, name)):
            for a, b in ((jm, tm), (jp_, tp_)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jp.local_extent, tp.local_extent)
    assert jp.atom_cap == tp.atom_cap and min(tp.atom_cap) >= 256
    assert jex.atom_msg_bytes(jp, 48, 8) == tex.atom_msg_bytes(tp, 48, 8)


def test_exchange_scalar_bit_equal(setup):
    sim, jg, jmesh, st, grid = setup
    jp = jex.make_plan(jg)
    B, A = st["gid"].shape[3:]
    x = np.random.default_rng(0).uniform(-1, 1, grid + (B, A))
    got_j = _shard_map(jmesh, lambda v: jex.exchange_scalar(jp, jg, v), x)
    got_t = tex.exchange_scalar(_halo(sim, sim.plan), _split(x, grid))
    np.testing.assert_array_equal(_stack(got_t, grid), got_j)
    # every halo row was written (the stages reach edges and corners)
    halo = slice(sim.geom.n_local, None)
    assert (got_j[..., halo, :] != x[..., halo, :]).all()


def test_exchange_positions_bit_equal(setup):
    sim, jg, jmesh, st, grid = setup
    jp = jex.make_plan(jg)
    r = st["r"] + np.random.default_rng(1).uniform(-0.1, 0.1, st["r"].shape)
    got_j = _shard_map(jmesh, lambda v: jex.exchange_positions(jp, jg, v), r)
    got_t = tex.exchange_positions(_halo(sim, sim.plan), _split(r, grid))
    np.testing.assert_array_equal(_stack(got_t, grid), got_j)


def test_fold_halo_bit_equal(setup):
    sim, jg, jmesh, st, grid = setup
    jp = jex.make_plan(jg)
    B, A = st["gid"].shape[3:]
    x = np.random.default_rng(2).uniform(-1, 1, grid + (3, B, A))
    got_j = _shard_map(jmesh, lambda v: jex.fold_halo(jp, jg, v), x)
    got_t = tex.fold_halo(_halo(sim, sim.plan), _split(x, grid))
    assert got_t[0].shape == (3, sim.geom.n_local, A)
    np.testing.assert_array_equal(_stack(got_t, grid), got_j)


def _displaced(sim, st, seed, scale):
    """Local atoms displaced by uniform(-scale, scale): some cross cell and
    shard faces."""
    A = st["r"].shape[-1]
    nl = sim.geom.n_local
    valid = np.arange(A) < st["n_atoms"][..., :nl, None]
    d = np.random.default_rng(seed).uniform(-scale, scale,
                                            st["r"][..., :nl, :].shape)
    r = st["r"].copy()
    r[..., :nl, :] = np.where(valid[:, :, :, None], r[..., :nl, :] + d,
                              r[..., :nl, :])
    return r


@pytest.mark.parametrize("factor", [0.0, 0.6])
def test_rebucket_exchange_atoms_bit_equal(setup, factor, monkeypatch):
    """Drift, rebucket with halo landers kept, the staged atom exchange
    (full planes, then count-packed; each stage's messages of every shard
    from one atom_pack call, the plain version here), and the canonical
    sort."""
    sim, jg, jmesh, st, grid = setup
    packs = []
    orig = cm.atom_pack_plain

    def counted(plan, *a):
        packs.append(plan.cap)
        return orig(plan, *a)

    monkeypatch.setattr(cm, "atom_pack_plain", counted)
    A = sim.cfg.max_atoms
    jp = jex.make_plan(jg, msg_factor=factor, max_atoms=A)
    tp = tex.make_plan(sim.geom, msg_factor=factor, max_atoms=A)
    r = _displaced(sim, st, 3, 1.2)
    args = (r, st["p"], st["gid"], st["n_atoms"])

    def jstep(r_, p_, g_, n_):
        r1, p1, g1, n1, nmig, ovf = jbin.rebucket(jg, r_, p_, g_, n_,
                                                  keep_halo=True)
        r2, p2, g2, n2, ovf2 = jex.exchange_atoms(jp, jg, r1, p1, g1, n1)
        r3, p3, g3 = jbin.sort_cells(r2, p2, g2)
        return (r1, p1, g1, n1, nmig, ovf), (r2, p2, g2, n2, ovf2), \
            (r3, p3, g3)

    j1, j2, j3 = _shard_map(jmesh, jstep, *args)
    t1 = [tbin.rebucket(sim.geom, sim.maps, *a, keep_halo=True)
          for a in zip(*[_split(x, grid) for x in args])]
    for k in range(6):
        np.testing.assert_array_equal(_stack([o[k] for o in t1], grid),
                                      j1[k])
    assert int(j1[4].sum()) > 0               # atoms left their shards
    t2 = tex.exchange_atoms(_halo(sim, tp), *[[o[k] for o in t1]
                                              for k in range(4)])
    assert packs == list(tp.atom_cap)
    for k in range(4):
        np.testing.assert_array_equal(_stack(t2[k], grid), j2[k])
    assert not bool(t2[4]) and not j2[4].any()
    t3 = [tbin.sort_cells(*a) for a in zip(*t2[:3])]
    for k in range(3):
        np.testing.assert_array_equal(_stack([o[k] for o in t3], grid),
                                      j3[k])


def test_packed_overflow_flag_matches(cube):
    """An undersized packed-message capacity raises the overflow flag in
    both packages (the z stage ships the most entries)."""
    sim, jg, jmesh, st, grid = cube
    A = sim.cfg.max_atoms
    jp = jex.make_plan(jg, msg_factor=1e-6, max_atoms=A)
    tp = tex.make_plan(sim.geom, msg_factor=1e-6, max_atoms=A)
    args = (st["r"], st["p"], st["gid"], st["n_atoms"])
    j = _shard_map(jmesh, lambda *a: jex.exchange_atoms(jp, jg, *a)[4],
                   *args)
    t = tex.exchange_atoms(_halo(sim, tp), *[_split(x, grid) for x in args])
    assert bool(t[4]) and bool(j.any())


def test_shards_round_trip(cube):
    _sim, _jg, _m, st, grid = cube
    back = shards_to_numpy(shards_from_numpy(st, "cpu"), grid)
    assert sorted(back) == sorted(st)
    for k in st:
        assert back[k].dtype == st[k].dtype
        np.testing.assert_array_equal(back[k], st[k])


# --------------------------------------------------------------------------
# K3 / K4 plain versions against comd_tpu's kernels, 1-D mesh
# --------------------------------------------------------------------------

N_RING = 8


def _ring_mesh():
    return JMesh(np.array(jax.devices()[:N_RING]), ("x",))


def _jax_ring(fn, x):
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=_ring_mesh(), in_specs=(P("x"),), out_specs=P("x"),
        check_vma=False))(x))


@pytest.mark.parametrize("direction", [+1, -1])
def test_ring_push_plain_matches_pallas(direction):
    """K3 on a dfEmbed-like plane: each shard's [16, 32] block lands on its
    ring neighbor, bit for bit with comd_tpu's _ring_push."""
    x = np.random.default_rng(4).uniform(-1, 1, (N_RING * 16, 32))
    got_j = _jax_ring(lambda v: _ring_push(
        v, "x", direction, interpret=True, collective_id=7,
        single_axis=True), jnp.asarray(x))
    mesh = make_mesh(N_RING, 1, 1, "cpu")
    src = [torch.from_numpy(b) for b in x.reshape(N_RING, 16, 32)]
    plan = PushPlan([(torch.arange(16, dtype=torch.int32),
                      mesh.ring(0, direction))],
                    [((16, 32), torch.float64)], "cpu")
    dst, = ring_push_plain(plan, [src])
    np.testing.assert_array_equal(dst[0].numpy(),
                                  got_j.reshape(N_RING, 16, 32))


def test_ring_push_plain_atom_buffer_matches_pallas():
    """The atom message: comd_tpu pushes one [8, n, A] float buffer with the
    ints packed in; the port pushes typed r, p, gid and count fields.  Rows
    ``send`` of each shard arrive in the neighbor's buffer, and unpack to
    the same values."""
    rng = np.random.default_rng(5)
    B, n, A = 12, 5, 16
    r = rng.uniform(0, 10, (N_RING, 3, B, A))
    p = rng.normal(size=(N_RING, 3, B, A))
    gid = rng.integers(0, 2**31 - 1, (N_RING, B, A)).astype(np.int32)
    cnt = rng.integers(0, A + 1, (N_RING, B)).astype(np.int32)
    ids = np.array([7, 0, 3, 11, 5])
    packed = np.concatenate(
        [r[:, :, ids], p[:, :, ids],
         np.asarray(_pack_ints(jnp.asarray(gid[:, None, ids]), jnp.float64)),
         np.asarray(_pack_ints(jnp.asarray(np.broadcast_to(
             cnt[:, None, ids, None], (N_RING, 1, n, A))), jnp.float64))],
        axis=1)                                       # [N_RING, 8, n, A]
    got = _jax_ring(lambda v: _ring_push(
        v, "x", +1, interpret=True, collective_id=16, single_axis=True),
        jnp.asarray(packed.reshape(N_RING * 8, n, A))).reshape(
            N_RING, 8, n, A)
    mesh = make_mesh(N_RING, 1, 1, "cpu")
    srcs = [[torch.from_numpy(np.array(a[s])) for s in range(N_RING)]
            for a in (r, p, gid, cnt)]
    plan = PushPlan([(torch.as_tensor(ids, dtype=torch.int32),
                      mesh.ring(0, +1))],
                    [(f[0].shape, f[0].dtype) for f in srcs], "cpu")
    dsts = [o[0] for o in ring_push_plain(plan, srcs)]
    for s in range(N_RING):
        np.testing.assert_array_equal(dsts[0][s].numpy(), got[s, 0:3])
        np.testing.assert_array_equal(dsts[1][s].numpy(), got[s, 3:6])
        np.testing.assert_array_equal(
            dsts[2][s].numpy(),
            np.asarray(_unpack_ints(jnp.asarray(got[s, 6]), jnp.float64)))
        np.testing.assert_array_equal(
            dsts[3][s].numpy(),
            np.asarray(_unpack_ints(jnp.asarray(got[s, 7]),
                                    jnp.float64))[:, 0])


def test_pass2_push_plain_matches_pallas():
    """K4: F'(rhobar) of each shard's plane, kept locally and written into
    the ring neighbor's dfEmbed rows (f64)."""
    jpot = j_init_eam(POTS, "Cu_u6.eam", "funcfl")
    eval_df, consts = make_df_eval_for_kernel(jpot, jnp.float64)
    rng = np.random.default_rng(6)
    lo, hi = jpot.f.x0, jpot.f.x0 + (jpot.f.n - 1) / jpot.f.inv_dx
    rho = rng.uniform(lo, hi, (N_RING * 8, 16))

    def body(v):
        return _pass2_push(v, eval_df, "x", +1, interpret=True,
                           collective_id=11, single_axis=True, consts=consts)

    loc_j, recv_j = jax.jit(jax.shard_map(
        body, mesh=_ring_mesh(), in_specs=(P("x"),),
        out_specs=(P("x"), P("x")), check_vma=False))(jnp.asarray(rho))
    loc_j = np.asarray(loc_j).reshape(N_RING, 8, 16)
    recv_j = np.asarray(recv_j).reshape(N_RING, 8, 16)

    f_eval = make_f_eval(init_eam_pot(POTS, "Cu_u6.eam", "funcfl"),
                         torch.float64, "cpu")
    mesh = make_mesh(N_RING, 1, 1, "cpu")
    rows = torch.arange(8, dtype=torch.int32)
    rhos = [torch.from_numpy(b) for b in rho.reshape(N_RING, 8, 16)]
    dfe = [torch.zeros(10, 16, dtype=torch.float64) for _ in range(N_RING)]
    recv = torch.arange(2, 10, dtype=torch.int32)
    local = pass2_push_plain(rhos, dfe, mesh.ring(0, +1), rows, recv, f_eval)
    loc_t = np.stack([v.numpy() for v in local])
    np.testing.assert_allclose(loc_t, loc_j, rtol=1e-12, atol=0)
    for s in range(N_RING):
        # the neighbor's plane arrives as computed there
        np.testing.assert_array_equal(dfe[(s + 1) % N_RING][2:].numpy(),
                                      loc_t[s])
        np.testing.assert_array_equal(recv_j[(s + 1) % N_RING], loc_j[s])
        assert not dfe[s][:2].any()
    # and equals pass 2's own F' of the same rhobar, bit for bit
    np.testing.assert_array_equal(
        loc_t, np.stack([f_eval(v)[1].numpy() for v in rhos]))


# --------------------------------------------------------------------------
# the fill kernel's plain version and the launch plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("setup", ["2x2x2", "3x2x1"], indirect=True)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_fill_plain_matches_exchange_scalar(setup, dtype):
    """The whole fill of ``ki`` and of ``ki_fused`` (the x stage from F' of
    rhobar, with pass 2's evaluator) equals comd_tpu's staged
    exchange_scalar of the field whose local rows pass 2 filled, bit for
    bit."""
    sim, jg, jmesh, st, grid = setup
    h = _halo(sim, sim.plan)
    B, A = st["gid"].shape[3:]
    nl = sim.geom.n_local
    f_eval = make_f_eval(init_eam_pot(POTS, "Cu_u6.eam", "funcfl"), dtype,
                         "cpu")
    rng = np.random.default_rng(7)
    rhobar = rng.uniform(0.5, 3.0, grid + (nl, A))
    rho_t = [v.to(dtype) for v in _split(rhobar, grid)]
    x = rng.uniform(-1, 1, grid + (B, A))
    x_t = [v.to(dtype) for v in _split(x, grid)]
    for xs, rho in zip(x_t, rho_t):
        xs[:nl] = f_eval(rho)[1]          # pass 2's dfEmbed
    x0 = _stack(x_t, grid)
    jp = jex.make_plan(jg)
    got_j = _shard_map(jmesh, lambda v: jex.exchange_scalar(jp, jg, v), x0)
    plan = ki_comm.fill_plan(h, x_t[0])
    assert plan is ki_comm.fill_plan(h, x_t[1])          # made once
    for rho in (None, rho_t):
        got_t = halo_fill_plain(plan, [v.clone() for v in x_t], rho, f_eval)
        np.testing.assert_array_equal(_stack(got_t, grid), got_j)


def test_plans_per_field_widths_and_rows(cube):
    """The atom stage's plan moves r, p and gid in 16-byte vectors (4
    words) at A = 16, f32 and f64, and the counts ([B]) in single words;
    both directions sit in one plan; the fill's plan keeps each stage's
    face rows, the field's vector width and its launch grid."""
    sim, _jg, _m, _st, _grid = cube
    h = _halo(sim, sim.plan)
    B, S = sim.geom.n_total, sim.mesh.size
    for dtype in (torch.float32, torch.float64):
        fields = [((3, B, 16), dtype), ((3, B, 16), dtype),
                  ((B, 16), torch.int32), ((B,), torch.int32)]
        plan = PushPlan([(h.atom_send[0][1], h.plus[0]),
                         (h.atom_send[0][0], h.minus[0])], fields, "cpu")
        n = h.atom_send[0][0].numel()
        assert [f.vec_bytes // 4 for f in plan.fields] == [4, 4, 4, 1]
        assert [f.row_vecs for f in plan.fields] == \
            [16 * dtype.itemsize // 16] * 2 + [4, 1]
        assert [f.lg for f in plan.fields] == \
            [2 if dtype == torch.float32 else 3] * 2 + [2, 0]
        assert [f.out_shape for f in plan.fields] == [
            (2, S, 3, n, 16), (2, S, 3, n, 16), (2, S, n, 16), (2, S, n)]
        assert len(plan.dirs) == 2 and plan.n_rows == n
        assert [d[1] for d in plan.dirs] == [list(h.plus[0]),
                                             list(h.minus[0])]
    x0 = torch.zeros((B, 48), dtype=torch.float64)
    fp = ki_comm.fill_plan(h, x0)
    assert fp.n_rows == [h.force_send[a][0].numel() for a in range(3)]
    assert all(len(dirs) == 2 for dirs in fp.stages)
    assert (fp.vec, fp.row_vecs, fp.vec_lg, fp.elem_lg) == (16, 24, 5, 5)
    # a warp a row: 8 rows a block, z (the widest stage) sets the grid
    assert fp.grid == (-(-fp.n_rows[2] // 8), 2 * S)
    assert fp.rho_rows <= sim.geom.n_local
    assert ki_comm.fill_plan(h, x0.float()) is not fp
    assert ki_comm.atom_plan(h, 1, [[torch.zeros(3, B, 48)]]) is \
        ki_comm.atom_plan(h, 1, [[torch.zeros(3, B, 48)]])


def test_plans_refuse_what_the_kernels_cannot_take(cube):
    sim, _jg, _m, _st, _grid = cube
    h = _halo(sim, sim.plan)
    B, S = sim.geom.n_total, sim.mesh.size
    send, ring = h.atom_send[0][0], h.minus[0]
    good = [((B, 16), torch.float32)]
    for fields, match in (
            ([((B, 16), torch.int16)], "4- or 8-byte"),
            ([((B, 16), torch.bool)], "4- or 8-byte"),
            ([((2, 3, B, 16), torch.float32)], r"\[P, B, A\]"),
            ([((B, 16), torch.float32), ((B + 1,), torch.int32)],
             "differ in rows"),
            (good * 5, "1 to 4 fields")):
        with pytest.raises(ValueError, match=match):
            PushPlan([(send, ring)], fields, "cpu")
    for dirs, match in (
            ([(send, ring)] * 3, "1 or 2 directions"),
            ([(send, ring), (send[:-1].clone(), ring)], "different rows"),
            ([(send.long(), ring)], "int32"),
            ([(send, [0] * S)], "permutation"),
            ([(send + B, ring)], "outside"),
            ([(send, list(range(65)))], "1 to 64 shards")):
        with pytest.raises(ValueError, match=match):
            PushPlan(dirs, good, "cpu")
    st = [(h.force_send[0][0], h.force_recv[0][1], h.minus[0])]
    for stages, shape, dtype, match in (
            ([st] * 4, (B, 16), torch.float32, "1 to 3 stages"),
            ([st], (B, 16, 1), torch.float32, r"\[B, A\]"),
            ([st], (B, 16), torch.int16, "4- or 8-byte"),
            ([st], (B, 5), torch.int16, "4- or 8-byte"),
            ([[(h.force_send[0][0], h.force_recv[1][1], h.minus[0])]],
             (B, 16), torch.float32, "differ in length"),
            ([st, st + st], (B, 16), torch.float32, "same 1 or 2")):
        with pytest.raises(ValueError, match=match):
            FillPlan(stages, shape, dtype, "cpu")
    assert cm._lanes_lg(1) == 0 and cm._lanes_lg(4) == 2
    assert cm._lanes_lg(5) == 3 and cm._lanes_lg(24) == 5
    assert cm._lanes_lg(100) == 5
