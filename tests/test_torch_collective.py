"""The collective transport's and the list paths' exchanges and the
half-shell fold on their launch plans, on the CPU.

In one process the port runs the dfEmbed fill of ``--commImpl
collective`` and of the list paths as one ``halo_fill`` launch (K3's
copies), the collective atom messages as one ``atom_pack`` launch a stage
and the half-shell fold as one ``fold_halo`` launch (serially) or one a
stage (on a mesh).  On the CPU each wrapper runs its plain version, which
these tests hold, bit for bit, against:

  - ``atom_pack_plain`` against the port's ``exchange._atom_message`` on
    rebucketed, displaced 2x2x2, 3x2x1 and 1x1x2 shards, f32 and f64,
    count-packed, full planes and a capacity that overflows: every output
    (r, p, gid, valid) and the overflow flag;
  - the fill of a lazy 2x2x2 collective run and of a 2x2x2 list run
    (-m thread_atom_nl) through the step's dispatch: one ``halo_fill`` a
    force, the staged ``exchange.exchange_scalar`` never called, and the
    filled fields of the first and last force equal to comd_tpu's
    ``exchange_scalar`` under shard_map on the 8-device virtual CPU mesh;
  - the serial fold against comd_tpu's ``fold_halo_serial`` (f64) and the
    clone + ``index_add_`` it replaces (f32), on grids whose corner cells
    have 7 images and more; the mesh fold (``ki_comm.fold_halo_ki``: one
    launch a stage) against comd_tpu's ``fold_halo`` (f64) and the port's
    staged torch ``exchange.fold_halo`` (f32) on the three meshes;
  - a 2x2x2 --halfShell run (f32) through the dispatch against the same
    run on the torch fold;
  - the fold plans' device records (the destination, the sources inline,
    the spill) decoded with numpy against the FoldMap they were made
    from, in its per-destination order: the serial plan at 8^3, a map
    that spills, ki_comm.fold_plan on the three meshes;
  - the plans' refusals and the ctypes argument structs against
    csrc/comm.cu's AtomPackArgs and FoldArgs and its constants.

The kernels themselves are held on the card (tests/test_torch_kernel_cuda.py,
chip_smoke.py phase 22).
"""
import ctypes
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from comd_tpu import cells as jcells
from comd_tpu.ops.sweep import fold_halo_serial as j_fold_serial
from comd_tpu.parallel import exchange as jex
from comd_tpu.parallel.sharded import make_mesh as j_make_mesh

from comd_tpu_torch import Config, cells as tcells, init_simulation
from comd_tpu_torch.ops import binning as tbin
from comd_tpu_torch.ops.cuda import comm as cm
from comd_tpu_torch.ops.sweep import fold_halo_serial, fold_plan_serial
from comd_tpu_torch.parallel import exchange as tex, ki_comm

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


def _bits(t):
    """A tensor's bits: floats as integers (-0.0 and +0.0 differ)."""
    x = t.numpy()
    if x.dtype.kind == "f":
        return x.view(np.int32 if x.dtype == np.float32 else np.int64)
    return x


def _same(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(_bits(a), _bits(b))


def _jgeom(tg):
    return jcells.make_geometry(tg.local_min, tg.local_max, 1.0,
                                use_hilbert=tg.use_hilbert,
                                cell_size=tg.box_size)


@pytest.fixture(scope="module", params=list(MESHES))
def setup(request):
    """The port's sharded EAM init (f64) on one of the meshes, its shards
    displaced by up to 1.2 A and rebucketed with their halo landers kept
    (the state an atom exchange starts from), and comd_tpu's geometry and
    mesh for the same shards."""
    box, grid, A = MESHES[request.param]
    sim = init_simulation(Config(
        nx=box[0], ny=box[1], nz=box[2], doeam=True, temperature=600.0,
        dtype="float64", max_atoms=A, box_chunk=64, pot_dir=POTS,
        device="cpu", xproc=grid[0], yproc=grid[1], zproc=grid[2]))
    rng = np.random.default_rng(3)
    reb = []
    for s in sim.states:
        nl = sim.geom.n_local
        valid = torch.arange(A) < s.n_atoms[:nl, None]
        r = s.r.clone()
        d = torch.from_numpy(rng.uniform(-1.2, 1.2, r[:, :nl].shape))
        r[:, :nl] = torch.where(valid, r[:, :nl] + d, r[:, :nl])
        reb.append(tbin.rebucket(sim.geom, sim.maps, r, s.p, s.gid,
                                 s.n_atoms, keep_halo=True)[:4])
    return sim, reb, _jgeom(sim.geom), j_make_mesh(*grid), grid


@pytest.mark.parametrize("cap", ["full", "packed", "overflow"])
def test_atom_pack_plain_matches_atom_message(setup, cap):
    """One stage's messages of every shard and both faces from
    ``atom_pack`` (its plain version here) equal ``_atom_message``'s bit
    for bit, r, p, gid, valid and the overflow flag, at every stage, f32
    and f64; full planes carry every slot, a packed message (the default
    factor 0.6) its real slots first, and a capacity of 16 overflows on
    every stage."""
    sim, reb, _jg, _jm, _grid = setup
    A = sim.cfg.max_atoms
    plan = tex.make_plan(sim.geom, msg_factor=0.0 if cap == "full" else 0.6,
                         max_atoms=A)
    if cap == "overflow":
        plan = dataclasses.replace(plan, atom_cap=(16, 16, 16))
    h = tex.make_halo(sim.mesh, sim.geom, sim.maps, plan, sim.dtype)
    flags = []
    for dtype in (torch.float64, torch.float32):
        r, p = ([t[k].to(dtype) for t in reb] for k in (0, 1))
        gid, n_atoms = ([t[k] for t in reb] for k in (2, 3))
        for axis in range(3):
            pp = tex.pack_plan(h, axis, r[0])
            assert pp is tex.pack_plan(h, axis, r[1])          # made once
            ovf = torch.zeros((), dtype=torch.bool)
            got = cm.atom_pack(pp, r, p, gid, n_atoms, ovf)
            want_ovf = False
            for s in range(len(r)):
                for d in (0, 1):
                    want = tex._atom_message(h, axis, d, r[s], p[s],
                                             gid[s], n_atoms[s])
                    assert all(_same(a, b)
                               for a, b in zip(got[s][d], want[:4]))
                    want_ovf |= bool(want[4])
            assert bool(ovf) == want_ovf
            flags.append(want_ovf)
            assert pp.n_out == (plan.atom_cap[axis] or
                                len(plan.atom_send[axis][0]) * A)
    assert all(flags) if cap == "overflow" else not any(flags)


def _spy_fills(monkeypatch):
    """Every fill the step makes through ki_comm.exchange_scalar_ki, its
    fields before and after (clones), and the plain fill's calls; the
    staged torch fill raises."""
    fills, calls = [], []
    orig_ki, orig_plain = ki_comm.exchange_scalar_ki, cm.halo_fill_plain

    def ki(h, x):
        before = [v.clone() for v in x]
        out = orig_ki(h, x)
        fills.append((before, [v.clone() for v in out]))
        return out

    def plain(plan, x, rhobar=None, emb=None):
        calls.append(rhobar is None)
        return orig_plain(plan, x, rhobar, emb)

    def staged(*_a, **_k):
        raise AssertionError("the staged torch fill ran in one process")

    monkeypatch.setattr(ki_comm, "exchange_scalar_ki", ki)
    monkeypatch.setattr(cm, "halo_fill_plain", plain)
    monkeypatch.setattr(tex, "exchange_scalar", staged)
    return fills, calls


@pytest.mark.parametrize("run", ["lazy", "nl"])
def test_fill_through_the_dispatch_equals_comd_tpu(monkeypatch, run):
    """A 2x2x2 collective run (lazy cell path, or -m thread_atom_nl) fills
    dfEmbed with one halo_fill a force (K3's copies, no F') and never
    through the staged torch fill; the first and the last fill equal
    comd_tpu's exchange_scalar of the same fields bit for bit."""
    fills, calls = _spy_fills(monkeypatch)
    kw = (dict(nx=6, ny=6, nz=6, initial_delta=0.4) if run == "lazy" else
          dict(nx=8, ny=8, nz=8, temperature=1200.0, initial_delta=0.1,
               method="thread_atom_nl"))
    kw.setdefault("temperature", 600.0)
    sim = init_simulation(Config(
        doeam=True, dtype="float64", pot_dir=POTS, device="cpu",
        comm_impl="collective", xproc=2, yproc=2, zproc=2, **kw))
    steps = 10
    sim.step_block(steps)
    assert len(fills) == len(calls) == 1 + steps and all(calls)
    assert sim.n_rebucket >= 1 or run == "nl"
    jg, jmesh = _jgeom(sim.geom), j_make_mesh(2, 2, 2)
    jp = jex.make_plan(jg)
    for before, after in (fills[0], fills[-1]):
        want = _shard_map(jmesh, lambda v: jex.exchange_scalar(jp, jg, v),
                          _stack(before, (2, 2, 2)))
        np.testing.assert_array_equal(_stack(after, (2, 2, 2)), want)


def _fold_inputs(shape, n, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, shape)).to(dtype)
            for _ in range(n)]


@pytest.mark.parametrize("extent", [(4, 4, 4), (2, 3, 2)],
                         ids=["4x4x4", "2x3x2"])
def test_fold_serial_matches_comd_tpu(extent):
    """The serial fold (one fold_halo launch; the plain version here),
    in place, equals comd_tpu's fold_halo_serial in f64 and the clone +
    index_add_ it replaces in f32 bit for bit, for [3, B, A] and [B, A]
    fields; a corner cell adds its 7 images (more on an axis of 2 cells)
    in ascending halo row."""
    geom = tcells.make_geometry(np.zeros(3), np.array(extent) * 5.0, 5.0)
    assert geom.grid == extent
    maps = tbin.geom_maps(geom, torch.float64, "cpu")
    jg = _jgeom(geom)
    nl, B, A = geom.n_local, geom.n_total, 13
    for shape in ((3, B, A), (B, A)):
        x64 = _fold_inputs(shape, 1, torch.float64, 11)[0]
        want = np.asarray(j_fold_serial(jg, jnp.asarray(x64.numpy())))
        got = fold_halo_serial(geom, maps, x64.clone())
        np.testing.assert_array_equal(got.numpy(), want)
        x32 = x64.to(torch.float32)
        torch_fold = x32[..., :nl, :].clone().index_add_(
            x32.dim() - 2, maps.halo_src, x32[..., nl:, :])
        x = x32.clone()
        got = fold_halo_serial(geom, maps, x)
        assert _same(got, torch_fold)
        assert got.data_ptr() == x.data_ptr()              # in place
    plan = fold_plan_serial(maps, x)
    images = np.bincount(geom.halo_src, minlength=nl)
    assert plan.n_entries == (images > 0).sum() and \
        plan.n_adds == B - nl and len(plan.ranks) == images.max() >= 7
    assert plan is fold_plan_serial(maps, x)                # made once


def test_fold_mesh_matches_comd_tpu(setup):
    """The mesh fold (ki_comm.fold_halo_ki: one fold_halo launch a stage
    over every shard, the plain version here), in place, equals comd_tpu's
    fold_halo in f64 and the port's staged torch exchange.fold_halo in f32
    bit for bit, for [3, B, A] and [B, A] fields; the plans add the plus
    neighbor's rows first, each stage's entries its local face rows."""
    sim, _reb, jg, jmesh, grid = setup
    h, A = sim.halo, sim.cfg.max_atoms
    B, S = sim.geom.n_total, sim.mesh.size
    jp = jex.make_plan(jg)
    for shape in ((3, B, A), (B, A)):
        x = _fold_inputs(shape, S, torch.float64, 12)
        want = _shard_map(jmesh, lambda v: jex.fold_halo(jp, jg, v),
                          _stack(x, grid))
        got = ki_comm.fold_halo_ki(h, [v.clone() for v in x])
        np.testing.assert_array_equal(_stack(got, grid), want)
        x32 = [v.to(torch.float32) for v in x]
        want = tex.fold_halo(h, x32)
        got = ki_comm.fold_halo_ki(h, [v.clone() for v in x32])
        assert all(_same(a, b) for a, b in zip(got, want))
    for axis in range(3):
        plan = ki_comm.fold_plan(h, axis, x[0])
        n = len(sim.plan.force_send[axis][0])
        assert plan.n_adds == 2 * S * n and plan.n_shards == S
        assert plan is ki_comm.fold_plan(h, axis, x[1])     # made once


def test_half_mesh_run_through_the_dispatch_equals_torch_fold(monkeypatch):
    """A 2x2x2 --halfShell collective run (f32, 10 steps) whose folds go
    through the dispatch (fold_halo_ki: three stage launches a fold) ends
    with the bits of the same run on the staged torch exchange.fold_halo:
    r, p and ePot; and no fold reaches the torch version."""
    cfg = Config(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
                 initial_delta=0.2, half_shell=True, dtype="float32",
                 pot_dir=POTS, device="cpu", comm_impl="collective",
                 xproc=2, yproc=2, zproc=2)
    calls = []
    orig = cm.fold_halo_plain

    def counted(plan, x):
        calls.append(plan.n_shards)
        return orig(plan, x)

    runs = []
    for torch_fold in (False, True):
        with monkeypatch.context() as m:
            m.setattr(cm, "fold_halo_plain", counted)
            if torch_fold:
                m.setattr(ki_comm, "fold_halo_ki", tex.fold_halo)
            else:
                def refuse(*_a, **_k):
                    raise AssertionError("the torch fold ran")
                m.setattr(tex, "fold_halo", refuse)
            sim = init_simulation(cfg)
            calls.clear()
            sim.step_block(10)
            runs.append((sim, list(calls)))
    (new, new_calls), (old, old_calls) = runs
    # three folds a force (rhobar, phi on energy steps, the force), three
    # stages each
    assert len(new_calls) >= 3 * 2 * 10 and len(new_calls) % 3 == 0
    assert set(new_calls) == {8} and old_calls == []
    assert new.e_potential == old.e_potential
    for a, b in zip(new.states, old.states):
        assert _same(a.r, b.r) and _same(a.p, b.p)


def test_plans_refuse_what_the_kernels_cannot_take(setup):
    """A fold plan is refused for a row it both reads and writes (its
    launch has no barrier), an add outside the shards or rows, more than
    255 sources a destination (its record's 8-bit count), and an integer
    field; a pack plan for faces of different lengths and
    positions that are not [3, B, A] float."""
    sim, reb, _jg, _jm, _grid = setup
    B, A = sim.geom.n_total, sim.cfg.max_atoms
    ok = cm.FoldMap(np.zeros(2, int), np.array([0, 0]), np.zeros(2, int),
                    np.array([B - 1, B - 2]))
    plan = cm.FoldPlan(ok, (B, A), torch.float32, "cpu", 1)
    assert plan.n_entries == 1 and plan.n_adds == 2 and len(plan.ranks) == 2
    x = [torch.ones(B, A)]
    cm.fold_halo(plan, x)
    assert (x[0][0] == 3).all() and (x[0][1:] == 1).all()
    with pytest.raises(ValueError, match="reads is a row it writes"):
        cm.FoldPlan(ok._replace(src_row=np.array([B - 1, 0])), (B, A),
                    torch.float32, "cpu", 1)
    with pytest.raises(ValueError, match="outside"):
        cm.FoldPlan(ok._replace(src=np.array([0, 1])), (B, A),
                    torch.float32, "cpu", 1)
    with pytest.raises(ValueError, match="255 sources"):
        cm.FoldPlan(cm.FoldMap(np.zeros(256, int), np.zeros(256, int),
                               np.zeros(256, int), np.full(256, B - 1)),
                    (B, A), torch.float32, "cpu", 1)
    with pytest.raises(ValueError, match="float"):
        cm.FoldPlan(ok, (B, A), torch.int32, "cpu", 1)
    h = sim.halo
    ids = h.atom_send[0]
    with pytest.raises(ValueError, match="different numbers"):
        cm.AtomPackPlan((ids[0], ids[1][:-1]), 0, sim.mesh.size,
                        reb[0][0].shape, torch.float64, "cpu")
    with pytest.raises(ValueError, match=r"\[3, B, A\]"):
        cm.AtomPackPlan(ids, 0, sim.mesh.size, reb[0][2].shape,
                        torch.float64, "cpu")


def _decoded_adds(plan) -> list:
    """A fold plan's device records and spill read back with numpy: every
    add as (destination shard, row, source shard, row), destination by
    destination, each destination's sources in the order the kernel adds
    them (its K inline sources, then its spill)."""
    rec = plan.record.numpy().astype(np.int64)
    spill = plan.spill.numpy().astype(np.int64)
    K = 4 * plan.record_vecs - 2
    assert rec.shape == (plan.n_entries, 4 * plan.record_vecs)
    bits, mask = cm.SHARD_BITS, (1 << cm.SHARD_BITS) - 1
    adds = []
    for w in rec:
        n, at = int(w[1] & 0xff), int(w[1] >> 8)
        words = list(w[2:2 + min(n, K)]) + list(spill[at:at + max(n - K, 0)])
        adds += [(int(w[0] & mask), int(w[0] >> bits), int(v & mask),
                  int(v >> bits)) for v in words]
    return adds


def _fold_map_adds(adds, B) -> list:
    """A FoldMap's adds grouped by destination in a stable order: the
    order in which a fold adds them."""
    dst, dst_row, src, src_row = (np.asarray(v, np.int64) for v in adds)
    order = np.argsort(dst * B + dst_row, kind="stable")
    return [tuple(int(v[k]) for v in (dst, dst_row, src, src_row))
            for k in order]


def _captured_plans(monkeypatch) -> list:
    """Every FoldPlan made from here on, beside the FoldMap it was given."""
    made = []

    class Captured(cm.FoldPlan):
        def __init__(self, adds, *args, **kwargs):
            super().__init__(adds, *args, **kwargs)
            made.append((adds, self))

    monkeypatch.setattr(cm, "FoldPlan", Captured)
    monkeypatch.setattr(ki_comm, "FoldPlan", Captured)
    return made


def test_fold_records_decode_to_the_serial_fold_map(monkeypatch):
    """The serial fold plan's records at 8^3 (f32 --halfShell, [3, B, A]
    and [B, A]) decode to the FoldMap's adds in its per-destination order:
    three 16-byte words a record, so a corner cell's 7 images lie inline
    and nothing spills; a map with a destination of 12 sources and one of
    1 spills the 12's last two, in order, and folds as its adds say."""
    made = _captured_plans(monkeypatch)
    sim = init_simulation(Config(nx=8, ny=8, nz=8, doeam=True,
                                 half_shell=True, dtype="float32",
                                 pot_dir=POTS, device="cpu"))
    B, A = sim.geom.n_total, sim.cfg.max_atoms
    for shape in ((3, B, A), (B, A)):
        fold_plan_serial(sim.maps, torch.zeros(shape))
    assert len(made) == 2
    for adds, plan in made:
        assert plan.record_vecs == 3 and plan.spill.numel() == 1
        assert max(np.bincount(np.asarray(adds.dst_row))) == 7
        assert _decoded_adds(plan) == _fold_map_adds(adds, B)
    made.clear()
    big = cm.FoldMap(np.zeros(13, int), np.r_[np.full(12, 2), 0],
                     np.zeros(13, int), np.arange(20, 7, -1))
    plan = cm.FoldPlan(big, (B, A), torch.float64, "cpu", 1)
    assert plan.record_vecs == 3 and plan.n_entries == 2
    assert plan.spill.numpy().tolist() == [10 << cm.SHARD_BITS,
                                           9 << cm.SHARD_BITS, 0]
    assert _decoded_adds(plan) == _fold_map_adds(big, B)
    x = torch.rand(B, A, dtype=torch.float64)
    want = x.clone()
    for t, r in zip(big.dst_row, big.src_row):
        want[t] += x[r]
    got = cm.fold_halo(plan, [x.clone()])[0]
    assert torch.equal(got, want)


def test_fold_records_decode_to_the_mesh_fold_map(setup, monkeypatch):
    """ki_comm.fold_plan's records on each mesh (a fresh Halo, three
    stages, [B, A] and [3, B, A]) decode to the FoldMap's adds in its
    per-destination order (the plus neighbor's row before the minus
    neighbor's): one 16-byte word a record, two sources inline."""
    sim, _reb, _jg, _jm, _grid = setup
    made = _captured_plans(monkeypatch)
    h = tex.make_halo(sim.mesh, sim.geom, sim.maps, sim.plan, sim.dtype)
    B, A = sim.geom.n_total, sim.cfg.max_atoms
    for shape in ((B, A), (3, B, A)):
        for axis in range(3):
            ki_comm.fold_plan(h, axis, torch.zeros(shape))
    assert len(made) == 6
    for adds, plan in made:
        assert plan.record_vecs == 1 and plan.spill.numel() == 1
        assert _decoded_adds(plan) == _fold_map_adds(adds, B)


def _cu_struct(name: str) -> list:
    """csrc/comm.cu's struct ``name`` as (member, kind, dims)."""
    with open(cm.SOURCE) as fh:
        text = fh.read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = ([0-9]+);", text)}
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


@pytest.mark.parametrize("name,mirror", [("AtomPackArgs", "_AtomPackArgs"),
                                         ("FoldArgs", "_FoldArgs")])
def test_args_mirror_the_source(name, mirror):
    """ops/cuda/comm.py's ctypes structs hold csrc/comm.cu's members in
    order and kind (an int, a long long, a pointer; the array extents),
    and the pack's chunk and the fold records' shard bits and width equal
    the kernel's."""
    members, consts = _cu_struct(name)
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_longlong: "long long"}
    got = []
    for member, t in getattr(cm, mirror)._fields_:
        dims = []
        while hasattr(t, "_length_"):
            dims.append(t._length_)
            t = t._type_
        got.append((member, kinds[t], dims))
    assert members == got
    assert consts["kPackCells"] == cm.PACK_CELLS
    assert consts["kFoldRecordVecs"] == cm.FOLD_RECORD_VECS
    assert consts["kMaxShards"] == cm.MAX_SHARDS == 1 << cm.SHARD_BITS
    assert consts["kShardBits"] == cm.SHARD_BITS
    assert ctypes.sizeof(getattr(cm, mirror)) < 4096
