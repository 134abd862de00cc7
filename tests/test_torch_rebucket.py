"""The redistribution's wrappers (ops/cuda/rebucket.py) against comd_tpu,
bit for bit, on the CPU (their plain version: csrc/rebucket.cu's kernels
are held to it on the card in test_torch_kernel_cuda.py and chip_smoke.py).

Both packages rebucket the same numpy-made inputs: comd_tpu's 6^3 state
with seeded displacements across cell faces and the periodic boundary, and
synthetic cells (random occupancy, random gids, positions around the
cells) on a serial domain with and without the wrap, with a wrap extent
past the domain (every atom beyond it binned into a halo cell and folded
back), on a shard of a 2x2x2 mesh under keep_halo, on a Hilbert-numbered
grid, at an odd capacity and at one above 32, and with a crowded cell
(overflow).  The dispatch (``binning.rebucket``) must give comd_tpu's
outputs exactly; the serial step's in-place body (``rebucket_into``, then
the halo fill) comd_tpu's rebucket and ``fill_halo_serial``, with the lazy
baseline's local rows the new positions and the overflow flag or-ed.
"""
import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu import cells as jcells
from comd_tpu.ops import binning as jbin

from comd_tpu_torch import cells as tcells
from comd_tpu_torch.ops import binning as tbin
from comd_tpu_torch.ops.cuda import LAUNCHES
from comd_tpu_torch.ops.cuda import rebucket as rb

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
NAMES = ("r", "p", "gid", "n_atoms", "n_migrating", "overflow")
CUT = 4.0            # the synthetic grids' least cell edge


@pytest.fixture(scope="module", params=["float64", "float32"])
def ref(request):
    sim = j_init(JConfig(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
                         dtype=request.param, interp_impl="rows",
                         pot_dir=POTS, n_steps=0))
    s = sim.state
    return sim, {k: np.array(getattr(s, k))
                 for k in ("r", "p", "gid", "n_atoms")}


def _on_the_faces(r, n_atoms, n_local, extent, rng):
    """A few valid local atoms moved onto the periodic faces and just
    across them: 0, L, -tiny, the float below L, the float above L."""
    dt = r.dtype.type
    cells, slots = np.nonzero(np.arange(r.shape[-1])[None, :]
                              < n_atoms[:n_local, None])
    pick = rng.choice(len(cells), size=10, replace=False)
    for k, i in enumerate(pick):
        a = k % 3
        L = dt(extent[a])
        r[a, cells[i], slots[i]] = (
            dt(0), L, dt(-1e-7), np.nextafter(L, dt(0)),
            np.nextafter(L, dt(2 * L)), dt(2) * L, -L, dt(-0.0),
            L + L, dt(1e-30))[k]
    return r


def _displaced(sim, st, seed, scale, crowd=0, faces=False):
    """comd_tpu's state with the local atoms displaced by uniform(-scale,
    scale) per axis; ``crowd`` atoms piled into local cell 0; ``faces``:
    some on the periodic faces (``_on_the_faces``)."""
    rng = np.random.default_rng(seed)
    r = st["r"].copy()
    n_local, A = sim.geom.n_local, r.shape[-1]
    valid = np.arange(A)[None, :] < st["n_atoms"][:n_local, None]
    d = rng.uniform(-scale, scale, size=(3, n_local, A)).astype(r.dtype)
    r[:, :n_local] = np.where(valid[None], r[:, :n_local] + d,
                              r[:, :n_local])
    if crowd:
        cells, slots = np.nonzero(valid)
        pick = rng.choice(len(cells), size=crowd, replace=False)
        centre = 0.5 * sim.geom.box_size
        for a in range(3):
            r[a, cells[pick], slots[pick]] = (
                centre[a] + rng.uniform(-0.5, 0.5, size=crowd)).astype(
                    r.dtype)
    if faces:
        r = _on_the_faces(r, st["n_atoms"], n_local, sim.global_extent, rng)
    return dict(st, r=r)


def synthetic(lo, hi, A, dtype, seed, use_hilbert=False, spread=0.75,
              fill=0.5):
    """Geometries of the domain [lo, hi) (comd_tpu's and the port's) and
    cells of capacity ``A`` holding up to ``fill * A`` atoms each (random
    counts, gids a random permutation, the rest of a cell's slots holding
    junk), each within ``spread`` cell edges of its cell's centre per
    axis."""
    rng = np.random.default_rng(seed)
    jg = jcells.make_geometry(lo, hi, CUT, use_hilbert=use_hilbert)
    tg = tcells.make_geometry(lo, hi, CUT, use_hilbert=use_hilbert)
    assert jg.grid == tg.grid and jg.use_hilbert == use_hilbert
    B, nl = tg.n_total, tg.n_local
    counts = rng.integers(0, int(fill * A) + 1, size=nl).astype(np.int32)
    r = rng.uniform(-50.0, 50.0, size=(3, B, A)).astype(dtype)
    p = rng.standard_normal((3, B, A)).astype(dtype)
    gid = rng.integers(0, 2 ** 30, size=(B, A)).astype(np.int32)
    n_atoms = rng.integers(0, A + 1, size=B).astype(np.int32)
    n_atoms[:nl] = counts
    total = int(counts.sum())
    ids = rng.permutation(4 * total)[:total].astype(np.int32)
    centre = np.asarray(lo)[:, None] + (tg.tuple_of_box[:nl].T + 0.5) * \
        tg.box_size[:, None]                                  # [3, nl]
    k = 0
    for c in range(nl):
        for s in range(counts[c]):
            gid[c, s] = ids[k]
            r[:, c, s] = centre[:, c] + rng.uniform(
                -spread, spread, size=3) * tg.box_size
            k += 1
    return jg, tg, dict(r=r, p=p, gid=gid, n_atoms=n_atoms)


def _comd(geom, st, wrap, keep_halo=False):
    out = jbin.rebucket(geom, jnp.asarray(st["r"]), jnp.asarray(st["p"]),
                        jnp.asarray(st["gid"]), jnp.asarray(st["n_atoms"]),
                        wrap_extent=wrap, keep_halo=keep_halo)
    return [np.asarray(x) for x in out]


def _tensors(st):
    return [torch.from_numpy(st[k].copy()) for k in ("r", "p", "gid",
                                                     "n_atoms")]


def _port(geom, st, wrap, keep_halo=False):
    maps = tbin.geom_maps(geom, torch.from_numpy(st["r"]).dtype, "cpu")
    out = tbin.rebucket(geom, maps, *_tensors(st), wrap_extent=wrap,
                        keep_halo=keep_halo)
    return [x.numpy() for x in out], maps


def _equal(got, want):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


def _cases(sim, st):
    """(name, comd_tpu geometry, the port's, state, wrap extent,
    keep_halo) of every case, at the state's dtype."""
    dt = st["r"].dtype
    L = sim.global_extent
    tg = tcells.make_geometry(np.zeros(3), L, float(sim.geom.box_size.min()),
                              cell_size=sim.geom.box_size)
    shard_lo = np.array([0.5, 0.0, 0.5]) * 8 * CUT
    cases = [
        ("state wrap", sim.geom, tg, _displaced(sim, st, 0, 1.5), L, False),
        ("state far", sim.geom, tg, _displaced(sim, st, 1, 4.0), L, False),
        ("state faces", sim.geom, tg,
         _displaced(sim, st, 2, 0.5, faces=True), L, False),
        ("state no wrap", sim.geom, tg, _displaced(sim, st, 3, 1.5), None,
         False),
        ("state crowded", sim.geom, tg, _displaced(sim, st, 4, 0.2,
                                                   crowd=40), L, False)]
    jg, g, s = synthetic(np.zeros(3), np.full(3, 5 * CUT), 16, dt, 5,
                         spread=0.9)
    # a wrap extent past the domain: the atoms beyond it bin into halo
    # cells and fold back through the halo map
    cases.append(("fold", jg, g, s, np.full(3, 5.5 * CUT), False))
    jg, g, s = synthetic(shard_lo, shard_lo + 4 * CUT, 16, dt, 6,
                         spread=1.0)
    cases.append(("shard keep_halo", jg, g, s, None, True))
    cases.append(("shard no keep", jg, g, s, None, False))
    jg, g, s = synthetic(np.zeros(3), np.full(3, 4.2 * CUT), 16, dt, 7,
                         use_hilbert=True, spread=1.0)
    cases.append(("hilbert", jg, g, s, np.full(3, 4.2 * CUT), False))
    for A, seed in ((13, 8), (40, 9)):
        jg, g, s = synthetic(np.zeros(3), np.array([3.1, 4.3, 3.6]) * CUT,
                             A, dt, seed, spread=0.9)
        cases.append((f"A={A}", jg, g, s, np.array([3.1, 4.3, 3.6]) * CUT,
                      False))
    return cases


CASES = ("state wrap", "state far", "state faces", "state no wrap",
         "state crowded", "fold", "shard keep_halo", "shard no keep",
         "hilbert", "A=13", "A=40")


def _case(ref, name):
    sim, st = ref
    return next(c for c in _cases(sim, st) if c[0] == name)


@pytest.mark.parametrize("name", CASES)
def test_rebucket_matches_comd_tpu(ref, name):
    """binning.rebucket (the wrappers' dispatch: the plain version on the
    CPU, no kernel launch counted) equals comd_tpu's rebucket bit for
    bit; each case does what it is named for."""
    _n, jg, tg, st, wrap, keep = _case(ref, name)
    before = dict(LAUNCHES)
    got, _maps = _port(tg, st, wrap, keep)
    assert LAUNCHES == before
    want = _comd(jg, st, wrap, keep)
    _equal(got, want)
    nl = tg.n_local
    n_in = int(st["n_atoms"][:nl].clip(0, st["r"].shape[-1]).sum())
    kept = int(want[3].sum())
    if name == "state crowded":
        assert bool(want[5]) and want[3][:nl].max() > st["r"].shape[-1]
    elif not name.startswith("state"):
        # the synthetic cells stay within their capacity
        assert not bool(want[5])
    if wrap is None:
        assert int(want[4]) > 0 and (keep or kept == n_in - int(want[4]))
        if keep:
            assert kept == n_in and want[3][nl:].sum() == int(want[4])
    else:
        assert int(want[4]) == 0 and kept == n_in
    if name == "fold":
        # atoms beyond the domain were folded back into it
        r_in = st["r"][:, :nl][:, np.arange(st["r"].shape[-1])[None, :]
                               < st["n_atoms"][:nl, None]]
        assert (r_in >= 5 * CUT).any()
        assert (want[0][:, :nl][:, want[2][:nl] != tbin.EMPTY_GID]
                < 5 * CUT).all()
    if name == "hilbert":
        assert tg.use_hilbert


@pytest.mark.parametrize("had_overflow", [False, True])
@pytest.mark.parametrize("name", ("state wrap", "state faces",
                                  "state crowded", "fold", "hilbert",
                                  "A=13", "A=40"))
def test_serial_body_in_place(ref, name, had_overflow):
    """The serial step's body: ``rebucket_into`` in place, then the halo
    fill (ops/cuda/step.refresh_halo) equals comd_tpu's rebucket and
    fill_halo_serial; the baseline's local rows take the new positions
    (its halo rows untouched) and the overflow flag is or-ed."""
    _n, jg, tg, st, wrap, _keep = _case(ref, name)
    want = _comd(jg, st, wrap)
    rj, gj, nj = (np.asarray(x) for x in jbin.fill_halo_serial(
        jg, jnp.asarray(want[0]), jnp.asarray(want[2]),
        jnp.asarray(want[3])))
    maps = tbin.geom_maps(tg, torch.from_numpy(st["r"]).dtype, "cpu")
    r, p, gid, n = _tensors(st)
    last = torch.full_like(r, 7.0)
    ovf = torch.tensor(had_overflow)
    ext = torch.as_tensor(wrap, dtype=r.dtype)
    tbin.rebucket_into(tg, maps, r, p, gid, n, ovf, wrap_extent=ext,
                       last_r=last)
    tbin.fill_halo_serial(tg, maps, r, gid, n)
    np.testing.assert_array_equal(r.numpy(), rj)
    np.testing.assert_array_equal(p.numpy(), want[1])
    np.testing.assert_array_equal(gid.numpy(), gj)
    np.testing.assert_array_equal(n.numpy(), nj)
    nl = tg.n_local
    assert torch.equal(last[:, :nl], r[:, :nl])
    assert bool((last[:, nl:] == 7.0).all())
    assert bool(ovf) == (had_overflow or bool(want[5]))


def test_serial_step_runs_the_in_place_body(ref, monkeypatch):
    """The serial lazy step's rebucket branch goes through
    ``rebucket_into`` with the step's own buffers and its baseline."""
    from comd_tpu_torch import Config, init_simulation
    sim_j, _st = ref
    dt = str(np.dtype(_st["r"].dtype))
    sim = init_simulation(Config(nx=6, ny=6, nz=6, doeam=True,
                                 temperature=600.0, dtype=dt,
                                 interp_impl="rows", pot_dir=POTS,
                                 device="cpu"))
    assert sim.uses_lazy
    seen = []
    orig = rb.rebucket_into

    def spy(geom, maps, r, p, gid, n, ovf, **kw):
        seen.append((r, p, gid, n, ovf, kw["last_r"]))
        return orig(geom, maps, r, p, gid, n, ovf, **kw)

    monkeypatch.setattr(rb, "rebucket_into", spy)
    sim.step_block(1)
    sim.last_r[0, int(torch.nonzero(sim.state.n_atoms)[0]), 0] += sim.skin
    sim.step_block(1)
    assert len(seen) == 1 and sim.n_rebucket == 1
    s = sim.state
    r, p, gid, n, ovf, last = seen[0]
    assert r is s.r and p is s.p and gid is s.gid and n is s.n_atoms
    assert ovf is s.overflow and last is sim.last_r


def test_operand_checks():
    """The wrappers refuse what the kernels do not take, before the
    dispatch (on the CPU as on the card)."""
    jg, tg, st = synthetic(np.zeros(3), np.full(3, 3 * CUT), 8, np.float32,
                           11)
    maps = tbin.geom_maps(tg, torch.float32, "cpu")
    r, p, gid, n = _tensors(st)
    ok = dict(r=r, p=p, gid=gid, n_atoms=n)
    bad = [dict(ok, r=r.double()), dict(ok, r=r[:2]),
           dict(ok, r=r.transpose(1, 2).contiguous().transpose(1, 2)),
           dict(ok, p=p.double()), dict(ok, p=p[:, :-1]),
           dict(ok, gid=gid.long()), dict(ok, gid=gid[:-1]),
           dict(ok, n_atoms=n.long()), dict(ok, n_atoms=n[:-1]),
           dict(ok, r=r[:, :tg.n_local], p=p[:, :tg.n_local],
                gid=gid[:tg.n_local], n_atoms=n[:tg.n_local])]
    for kw in bad:
        with pytest.raises(ValueError):
            rb.rebucket(tg, maps, **kw, keep_halo=True)
    # the smallest A whose place block would take over 48 KB of shared
    # memory (one cell a block, a count and 2A gids)
    wide = torch.zeros((3, tg.n_total, 6144), dtype=torch.float32)
    with pytest.raises(ValueError):
        rb.rebucket(tg, maps, wide, wide, torch.zeros(
            wide.shape[1:], dtype=torch.int32), n)
    ovf = torch.zeros((), dtype=torch.bool)
    for kw in (dict(overflow=torch.zeros(1, dtype=torch.bool)),
               dict(overflow=torch.zeros((), dtype=torch.int32)),
               dict(overflow=ovf, last_r=r.double()),
               dict(overflow=ovf, last_r=r[:, :-1])):
        with pytest.raises(ValueError):
            rb.rebucket_into(tg, maps, r, p, gid, n, **kw)
    rb.rebucket_into(tg, maps, r, p, gid, n, ovf, last_r=r.clone())


def test_capacity_and_args_layout():
    """The staging capacity C (>= 2A, >= 32), the block-form place
    launch's shared memory (16 cells a block at A = 16; one from A = 256;
    over 48 KB from A = 6144) and csrc/rebucket.cu's Args as ctypes lays
    it out: 18 pointers, 9 doubles, 11 ints, 264 bytes (the last int, the
    place launch's form, padded to 8)."""
    assert [rb.stage_capacity(a) for a in (1, 13, 16, 40)] == [32, 32, 32,
                                                               80]
    assert rb.place_smem(16) == 4 * 16 * 33
    assert rb.place_smem(13) == 4 * 19 * 33
    assert rb.place_smem(256) == 4 * 513
    assert rb.place_smem(6143) <= rb.SMEM_LIMIT < rb.place_smem(6144)
    assert ctypes.sizeof(rb._Args) == 264
    assert rb._Args.local_min.offset == 18 * 8
    assert rb._Args.grid.offset == 18 * 8 + 9 * 8
    assert rb._Args.or_overflow.offset == 256 - 4
    assert rb._Args.form.offset == 256


@pytest.mark.parametrize("A", [1, 5, 13, 16, 17, 32, 33, 40])
def test_place_form_by_A(A):
    """The wrapper's place form: the warp form up to A = 32, a cell a
    segment of A rounded up to a power of two lanes (13 and 16 two cells
    a warp, 17 and 32 one), whose first round of records covers every
    slot of the cell; the block form above, whose shared memory fits."""
    if A > 32:
        assert rb.place_form(A) == "block"
        assert rb.place_smem(A) <= rb.SMEM_LIMIT
        return
    assert rb.place_form(A) == "warp"
    L = rb.place_lanes(A)
    assert L & (L - 1) == 0 and A <= L < 2 * A and 32 % L == 0
    assert L <= rb.stage_capacity(A)         # a lane's first record staged
    assert {13: 16, 16: 16, 17: 32, 32: 32}.get(A, L) == L


def _cu_args() -> tuple:
    """csrc/rebucket.cu's RebucketArgs as (name, kind, dims) members and
    its integer constants (kThreads, kSmemLimit, kEmptyGid)."""
    import re
    with open(rb.SOURCE) as fh:
        text = fh.read()
    consts = {k: eval(v, {}) for k, v in re.findall(
        r"constexpr int (k\w+) = ([0-9][0-9 *]*);", text)}
    body = re.search(r"\nstruct RebucketArgs \{\n(.*?)\n\};", text,
                     re.S).group(1)
    members = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(?:const )?(\w+(?: \w+)?)(\*?) (\w+)"
                         r"((?:\[\w+\])*);", line)
        assert m, line
        base, ptr, name, dims = m.groups()
        members.append((name, "pointer" if ptr else base,
                        [int(d) for d in re.findall(r"\[(\w+)\]", dims)]))
    return members, consts


def test_args_mirror_the_source():
    """ops/cuda/rebucket.py's _Args holds csrc/rebucket.cu's RebucketArgs
    member for member, in order and kind (a pointer, an int, a double; the
    array extents), and its constants equal the kernel's (the block size,
    the shared memory limit, the empty gid), so the mirror cannot
    drift."""
    members, consts = _cu_args()
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_double: "double"}
    mirror = []
    for name, t in rb._Args._fields_:
        dims = []
        while hasattr(t, "_length_"):
            dims.append(t._length_)
            t = t._type_
        mirror.append((name, kinds[t], dims))
    assert members == mirror
    assert (consts["kThreads"], consts["kSmemLimit"], consts["kEmptyGid"]) \
        == (rb.THREADS, rb.SMEM_LIMIT, int(tbin.EMPTY_GID))
