"""The step's small ops (comd_tpu_torch/ops/cuda/step.py) against comd_tpu.

The four wrappers' plain versions -- what a CPU tensor runs, and what the
card's kernels (csrc/step.cu) are held to bit for bit -- against
comd_tpu's own expressions on the same numpy-seeded arrays, f32 and f64,
on a 5^3 box's cell layout (B = 343 cells, 125 local, A = 16):
  - kick_drift_trigger: the half kick and drift of comd_tpu/sim.py:367-370
    and comd_tpu.ops.neighborlist.needs_rebuild; the trigger also on
    states displaced exactly at, one ulp under and one ulp over (skin/2)^2
    (in the dynamics dtype, where comd_tpu compares); with ``add`` over
    eight shards, the or of comd_tpu's needs_rebuild over them (its
    sharded step's ``any`` over the mesh); with the serial image map
    (binning.ImageMap: the inverse of halo_src, checked on 6^3 and 7x5x4
    grids) the kick and drift followed by comd_tpu's ghost refresh
    (comd_tpu/sim.py:353-358), r and p bit for bit in every slot, also at
    an odd number of slots a row;
  - refresh_halo: the ghost refresh of comd_tpu/sim.py:353-358, and with
    gid and n_atoms comd_tpu.ops.binning.fill_halo_serial bit for bit;
  - embed_fill: comd_tpu.potentials.tables.interpolate on the F table,
    the placement and serial halo fill of comd_tpu/ops/force_eam.py:
    371-380 and binning.fill_halo_scalar_serial, and finalize_eam_energy's
    mask (force_eam.py:603); the zero-halo form a mesh fills;
  - land: the landing, second kick and atom count of comd_tpu/sim.py:
    380-383, and the count summed over two shards.
Tolerances: f32 1 ulp, f64 1e-15 relative (comd_tpu's XLA may contract
a*b + c into an FMA; the port rounds every operation, as PyTorch does);
the trigger's decisions, the halo rows' copies and the atom counts equal.
Then the slice: 20 lazy EAM steps of the port (which runs the four ops
through their wrappers, counted here: refresh_halo only in the
rebuckets' halo fills) against comd_tpu's step_block from one state, at tests/test_torch_trajectory.py's bounds (f64 rows: r and p
within 1e-8, gid and counts equal, ePot within 1e-10 relative; a rebucket
inside the run).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import binning as jbin
from comd_tpu.ops import force_eam as jforce
from comd_tpu.ops import neighborlist as jnl
from comd_tpu.potentials import tables as jtables
from comd_tpu.potentials.eam import init_eam_pot as j_eam_pot

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.cells import make_geometry
from comd_tpu_torch.interop import FIELDS, state_from_numpy
from comd_tpu_torch.ops import binning, force_eam
from comd_tpu_torch.ops.cuda import step
from comd_tpu_torch.potentials.eam import init_eam_pot as t_eam_pot

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
DTYPES = ["float32", "float64"]
DT, MASS, SKIN = 1.0, 63.55 * 103.6427, 0.5


def _close(a, b, dtype):
    """f32: within 1 ulp of the larger magnitude; f64: 1e-15 relative."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.dtype(dtype)
    if dtype == "float32":
        tol = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    else:
        tol = 1e-15 * np.abs(b)
    assert np.all(np.abs(a.astype(np.float64) - b) <= tol), \
        float(np.max(np.abs(a.astype(np.float64) - b)))


def _c(x, dtype):
    """A step constant rounded to the dtype, as Physics._c and comd_tpu's
    ``dtype.type(x)``."""
    return float(np.asarray(x, dtype=np.dtype(dtype)))


@pytest.fixture(scope="module")
def geoms():
    """(comd_tpu sim, port sim) of a 5^3 EAM box per dtype, sharing one
    cell layout."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            kw = dict(nx=5, ny=5, nz=5, doeam=True, dtype=dtype,
                      interp_impl="rows", pot_dir=POTS)
            jsim = j_init(JConfig(n_steps=0, **kw))
            tsim = init_simulation(Config(device="cpu", **kw))
            assert tsim.geom.grid == jsim.geom.grid
            np.testing.assert_array_equal(tsim.geom.halo_src,
                                          jsim.geom.halo_src)
            np.testing.assert_array_equal(tsim.geom.halo_shift,
                                          jsim.geom.halo_shift)
            cache[dtype] = (jsim, tsim)
        return cache[dtype]

    return get


def _fields(shape, dtype, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_kick_drift_trigger_matches_comd_tpu(geoms, dtype):
    jsim, tsim = geoms(dtype)
    nl = tsim.geom.n_local
    shape = tsim.state.r.shape
    p, f, r = _fields(shape, dtype, 1)
    f *= 1e-2
    rng = np.random.default_rng(2)
    last = (r + 1e-2 * rng.standard_normal(shape)).astype(dtype)
    kick, drift = _c(0.5 * DT, dtype), _c(DT * (1.0 / MASS), dtype)
    # comd_tpu/sim.py:367-373
    pj = jnp.asarray(p) + jnp.asarray(p).dtype.type(0.5 * DT) * \
        jnp.asarray(f)
    rj = jnp.asarray(r) + pj * pj.dtype.type(DT * (1.0 / MASS))
    for skin in (SKIN, 1e-3, 10.0):
        pt, rt = torch.from_numpy(p.copy()), torch.from_numpy(r.copy())
        flag = step.kick_drift_trigger(pt, rt, torch.from_numpy(f),
                                       torch.from_numpy(last), nl, kick,
                                       drift, skin)
        _close(pt.numpy(), np.asarray(pj), dtype)
        _close(rt.numpy(), np.asarray(rj), dtype)
        dirty = jnl.needs_rebuild(jnp.asarray(last), rj, nl, skin)
        assert flag.dtype == torch.bool and flag.shape == ()
        assert bool(flag) == bool(dirty)
    # -S 0: the kick and drift only
    pt, rt = torch.from_numpy(p.copy()), torch.from_numpy(r.copy())
    assert step.kick_drift_trigger(pt, rt, torch.from_numpy(f), None, nl,
                                   kick, drift) is None
    _close(rt.numpy(), np.asarray(rj), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("firing", [(), (5,), (0, 7)],
                         ids=["none", "one", "two"])
def test_trigger_add_ors_the_shards(geoms, dtype, firing):
    """The stacks of the first k of eight shards in one call (k = 1..8),
    into one flag: the flag equals the or of comd_tpu's needs_rebuild
    over those shards; the shards in ``firing`` have one local slot a skin
    from its baseline, the others none past skin/2, and one launch with a
    flag on a shard of its own writes that shard's trigger."""
    _jsim, tsim = geoms(dtype)
    nl = tsim.geom.n_local
    shape = tsim.state.r.shape
    kick, drift = _c(0.5 * DT, dtype), _c(DT * (1.0 / MASS), dtype)
    fields, wants = [], []
    for i in range(8):
        p, f, r = _fields(shape, dtype, 10 + i)
        f *= 1e-3
        p *= 1e-3
        last = r.copy()
        if i in firing:
            last[0, nl // 2, 1] += SKIN
        rj = jnp.asarray(r) + (jnp.asarray(p) + jnp.asarray(p).dtype.type(
            0.5 * DT) * jnp.asarray(f)) * jnp.asarray(p).dtype.type(
            DT * (1.0 / MASS))
        wants.append(bool(jnl.needs_rebuild(jnp.asarray(last), rj, nl,
                                            SKIN)))
        fields.append((p, r, f, last))
    flag = torch.zeros((), dtype=torch.bool)
    for k in range(1, 9):
        p, r, f, last = (torch.from_numpy(np.stack([x[j] for x in
                                                    fields[:k]]))
                         for j in range(4))
        out = step.kick_drift_trigger(p, r, f, last, nl, kick, drift, SKIN,
                                      flag)
        assert out is flag
        assert bool(flag) == any(wants[:k])
    assert any(wants) == bool(firing)
    p, f, r = _fields(shape, dtype, 30)
    assert not bool(step.kick_drift_trigger(
        torch.from_numpy(p), torch.from_numpy(r), torch.from_numpy(f * 0),
        torch.from_numpy(r.copy()), nl, kick, 0.0, SKIN, flag))


def _square_sum_to(target, dtype):
    """(a, b) with fl(fl(a a) + fl(b b)) == target in ``dtype``: a a a few
    ulps below target, b b the rest."""
    t = np.dtype(dtype).type(target)
    a = np.sqrt(t)
    for _ in range(8):
        a = np.nextafter(a, t.dtype.type(0))
        aa = a * a
        if aa < t:
            b = np.sqrt(t - aa)
            for cand in (b, np.nextafter(b, b.dtype.type(0)),
                         np.nextafter(b, b.dtype.type(np.inf))):
                if aa + cand * cand == t:
                    return a, cand
    raise AssertionError(f"no (a, b) for {target!r}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["under", "at", "over"])
@pytest.mark.parametrize("skin", [SKIN, 0.4725, 0.45])
def test_trigger_at_the_threshold(geoms, dtype, where, skin):
    """One local slot displaced by exactly (skin/2)^2, one ulp under or
    over it in the dtype; every other slot still: the trigger fires only
    over the threshold, as comd_tpu's needs_rebuild decides.  (0.5/2)^2
    is exact in both dtypes; (skin/2)^2 rounds down in f32 for the 63^3
    headline's skin, 0.4725, and up for 0.45 (then a comparison in f64
    would fire at the f32 threshold): comd_tpu compares in the dtype."""
    jsim, tsim = geoms(dtype)
    nl = tsim.geom.n_local
    shape = tsim.state.r.shape
    (r,) = _fields(shape, dtype, 3, n=1)
    thr = np.dtype(dtype).type(_c((0.5 * skin) ** 2, dtype))
    target = {"under": np.nextafter(thr, thr.dtype.type(0)), "at": thr,
              "over": np.nextafter(thr, thr.dtype.type(np.inf))}[where]
    a, b = _square_sum_to(target, dtype)
    last = r.copy()
    box = nl // 2
    r[0, box, 3], r[1, box, 3] = a, b
    last[0, box, 3], last[1, box, 3] = 0, 0
    zeros = np.zeros(shape, dtype)
    flag = step.kick_drift_trigger(
        torch.from_numpy(zeros.copy()), torch.from_numpy(r),
        torch.from_numpy(zeros), torch.from_numpy(last), nl,
        _c(0.5 * DT, dtype), _c(DT / MASS, dtype), skin)
    dirty = jnl.needs_rebuild(jnp.asarray(last), jnp.asarray(r), nl, skin)
    assert bool(flag) == bool(dirty) == (where == "over")


@pytest.mark.parametrize("dtype", DTYPES)
def test_refresh_halo_matches_comd_tpu(geoms, dtype):
    jsim, tsim = geoms(dtype)
    geom, nl = jsim.geom, jsim.geom.n_local
    (r,) = _fields(tsim.state.r.shape, dtype, 4, n=1)
    # comd_tpu/sim.py:353-358
    src = jnp.asarray(geom.halo_src)
    shift = jnp.asarray(geom.halo_shift, dtype=r.dtype)
    rj = jnp.asarray(r).at[:, nl:].set(jnp.asarray(r)[:, src]
                                       + shift.T[:, :, None])
    rt = torch.from_numpy(r.copy())
    assert step.refresh_halo(tsim.geom, tsim.maps, rt) is rt
    _close(rt.numpy(), np.asarray(rj), dtype)
    np.testing.assert_array_equal(rt.numpy()[:, :nl], r[:, :nl])


@pytest.fixture(scope="module")
def f_tables():
    """(comd_tpu's F table, the port's EmbedTable) per dtype."""
    jpot = j_eam_pot(POTS, "Cu_u6.eam", "funcfl")
    tpot = t_eam_pot(POTS, "Cu_u6.eam", "funcfl")
    return {dtype: (jpot.f, force_eam.make_f_eval(
        tpot, getattr(torch, dtype), "cpu")) for dtype in DTYPES}


@pytest.mark.parametrize("grid,hilbert", [((6, 6, 6), False),
                                          ((7, 5, 4), False),
                                          ((8, 8, 8), True)])
def test_image_map_inverts_halo_src(grid, hilbert):
    """The serial image map lists every halo row once, under its source
    cell (halo_src), with that row's shift; a cell on one face of the
    grid has one image, on an edge three, at a corner seven, and an
    inner cell none."""
    geom = make_geometry(np.zeros(3), np.asarray(grid, np.float64), 1.0,
                         use_hilbert=hilbert)
    assert geom.grid == grid
    maps = binning.geom_maps(geom, torch.float64, "cpu")
    img = maps.images
    nl, n_halo = geom.n_local, geom.n_halo
    start, row = img.start.numpy(), img.row.numpy()
    assert img.start.dtype == img.row.dtype == torch.int32
    assert img.n_local == nl and start[0] == 0 and start[-1] == n_halo
    assert np.all(np.diff(start) >= 0)
    np.testing.assert_array_equal(np.sort(row), nl + np.arange(n_halo))
    cell = np.repeat(np.arange(nl), np.diff(start))
    np.testing.assert_array_equal(geom.halo_src[row - nl], cell)
    np.testing.assert_array_equal(img.shift.numpy(),
                                  geom.halo_shift[row - nl])
    t = geom.tuple_of_box[:nl]
    sides = ((t == 0) | (t == np.asarray(grid) - 1)).sum(axis=1)
    np.testing.assert_array_equal(np.diff(start), 2 ** sides - 1)
    assert np.diff(start).max() == 7


def _head_case(tsim, dtype, odd, seed):
    """Fields [3, B, A] (A - 1 slots a row with ``odd``) and a baseline a
    little off r, numpy-seeded."""
    B, A = tsim.state.r.shape[1:]
    shape = (3, B, A - 1 if odd else A)
    p, f, r = _fields(shape, dtype, seed)
    f *= 1e-2
    rng = np.random.default_rng(seed + 1)
    last = (r + 1e-2 * rng.standard_normal(shape)).astype(dtype)
    return p, f, r, last


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("odd", [False, True], ids=["A", "odd_A"])
def test_fused_head_matches_comd_tpu_refresh(geoms, dtype, odd):
    """kick_drift_trigger with the image map: comd_tpu's half kick and
    drift (comd_tpu/sim.py:367-370), then its ghost refresh (the lazy
    step's ``refresh``, :353-358), r and p bit for bit in every slot; the
    trigger as comd_tpu's needs_rebuild, and as without the images."""
    jsim, tsim = geoms(dtype)
    geom, nl = jsim.geom, jsim.geom.n_local
    p, f, r, last = _head_case(tsim, dtype, odd, 40)
    kick, drift = _c(0.5 * DT, dtype), _c(DT * (1.0 / MASS), dtype)
    pj = jnp.asarray(p) + jnp.asarray(p).dtype.type(0.5 * DT) * \
        jnp.asarray(f)
    rj = jnp.asarray(r) + pj * pj.dtype.type(DT * (1.0 / MASS))
    src = jnp.asarray(geom.halo_src)
    shift = jnp.asarray(geom.halo_shift, dtype=rj.dtype)
    dirty = jnl.needs_rebuild(jnp.asarray(last), rj, nl, SKIN)
    rj = rj.at[:, nl:].set(rj[:, src] + shift.T[:, :, None])
    pt, rt = torch.from_numpy(p.copy()), torch.from_numpy(r.copy())
    flag = step.kick_drift_trigger(pt, rt, torch.from_numpy(f),
                                   torch.from_numpy(last), nl, kick, drift,
                                   SKIN, images=tsim.maps.images)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert bool(flag) == bool(dirty)
    # the same bits as the head without images, then the refresh
    p2, r2 = torch.from_numpy(p.copy()), torch.from_numpy(r.copy())
    flag2 = step.kick_drift_trigger(p2, r2, torch.from_numpy(f),
                                    torch.from_numpy(last), nl, kick, drift,
                                    SKIN)
    step.refresh_halo(tsim.geom, tsim.maps, r2)
    assert torch.equal(p2, pt) and torch.equal(r2, rt)
    assert bool(flag2) == bool(flag)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("odd", [False, True], ids=["A", "odd_A"])
def test_halo_fill_matches_comd_tpu(geoms, dtype, odd):
    """refresh_halo with gid and n_atoms, and binning.fill_halo_serial
    through it: comd_tpu.ops.binning.fill_halo_serial's r, gid and n_atoms
    bit for bit; the local rows untouched."""
    jsim, tsim = geoms(dtype)
    geom, nl = jsim.geom, jsim.geom.n_local
    B, A = tsim.state.r.shape[1:]
    a = A - 1 if odd else A
    (r,) = _fields((3, B, a), dtype, 41, n=1)
    rng = np.random.default_rng(42)
    gid = rng.integers(0, 2 ** 31 - 1, (B, a)).astype(np.int32)
    n_atoms = rng.integers(0, a + 1, B).astype(np.int32)
    rj, gj, nj = jbin.fill_halo_serial(geom, jnp.asarray(r),
                                       jnp.asarray(gid),
                                       jnp.asarray(n_atoms))
    rt, gt, nt = (torch.from_numpy(x.copy()) for x in (r, gid, n_atoms))
    assert step.refresh_halo(tsim.geom, tsim.maps, rt, gt, nt) is rt
    for got, want in ((rt, rj), (gt, gj), (nt, nj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rt.numpy()[:, :nl], r[:, :nl])
    rb, gb, nb = binning.fill_halo_serial(
        tsim.geom, tsim.maps, *(torch.from_numpy(x.copy())
                                for x in (r, gid, n_atoms)))
    assert torch.equal(rb, rt) and torch.equal(gb, gt) and \
        torch.equal(nb, nt)


@pytest.mark.parametrize("elem,A,ptrs,want", [
    (4, 16, [0, 4096], 4), (8, 16, [0, 4096], 2), (4, 15, [0], 1),
    (8, 15, [0], 1), (4, 18, [0], 1), (8, 18, [0], 2), (4, 32, [0, 8], 1),
    (8, 16, [16, 4104], 1)])
def test_halo_fill_vector_width_by_shape(elem, A, ptrs, want):
    """refresh_halo's thread takes the slots whose positions fill a
    16-byte access (4 f32, 2 f64) when A is a multiple of them and r and
    gid are 16-byte aligned, else one slot."""
    assert step.halo_width(A, elem, ptrs) == want


def _density(tab, shape, dtype, seed):
    """rhobar over F's table and past both ends (clamped, and frac = 0
    past the last entry), some slots on grid points."""
    rng = np.random.default_rng(seed)
    x_end = tab.x0 + (tab.n + 2) / tab.inv_dx
    rho = rng.uniform(tab.x0 - 0.1 * x_end, 1.1 * x_end, shape)
    rho.flat[::7] = tab.x0 + rng.integers(0, tab.n, rho.size)[::7] \
        / tab.inv_dx
    return rho.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("energy", [True, False])
@pytest.mark.parametrize("serial", [True, False])
def test_embed_fill_matches_comd_tpu(geoms, f_tables, dtype, energy,
                                     serial):
    jsim, tsim = geoms(dtype)
    geom, nl = jsim.geom, jsim.geom.n_local
    B, A = tsim.state.r.shape[1:]
    jtab, f_eval = f_tables[dtype]
    rho = _density(jtab, (nl, A), dtype, 5)
    (phi,) = _fields((nl, A), dtype, 6, n=1)
    n_atoms = np.random.default_rng(7).integers(0, A + 1, B).astype(
        np.int32)
    # comd_tpu: tables.interpolate (tables.py:60), force_eam.py:371-380,
    # the serial fill and finalize_eam_energy (:603)
    padded = jnp.asarray(jtab.padded, dtype=dtype)
    f_j, df_j = jtables.interpolate(padded, jtab.n, jtab.x0, jtab.inv_dx,
                                    jnp.asarray(rho))
    dfe_j = jnp.zeros((B, A), dtype=dtype).at[:nl].set(df_j)
    if serial:
        dfe_j = jbin.fill_halo_scalar_serial(geom, dfe_j)
    dfe, u = step.embed_fill(
        f_eval, torch.from_numpy(rho),
        torch.from_numpy(phi) if energy else None,
        torch.from_numpy(n_atoms), B,
        tsim.maps.halo_src if serial else None, torch.float64)
    _close(dfe.numpy()[:nl], np.asarray(df_j), dtype)
    if serial:
        # the halo rows: F' of their sources, the same bits as the copy
        np.testing.assert_array_equal(
            dfe.numpy()[nl:], dfe.numpy()[tsim.geom.halo_src])
        _close(dfe.numpy(), np.asarray(dfe_j), dtype)
    else:
        assert not dfe.numpy()[nl:].any()
    if not energy:
        assert u is None
        return
    u_j = 0.5 * jnp.asarray(phi).astype(jnp.float64) + \
        f_j.astype(jnp.float64)
    valid = np.arange(A)[None, :] < n_atoms[:nl, None]
    u_j, e_j = jforce.finalize_eam_energy(u_j, jnp.asarray(valid))
    assert u.dtype == torch.float64
    _close(u.numpy(), np.asarray(u_j), "float64")
    assert not u.numpy()[~valid].any()
    assert float(u.sum()) == pytest.approx(float(e_j), rel=1e-14)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("two", [True, False])
def test_land_matches_comd_tpu(geoms, dtype, two):
    jsim, tsim = geoms(dtype)
    nl = tsim.geom.n_local
    shape = tsim.state.r.shape
    B, A = shape[1:]
    p, f_old = _fields(shape, dtype, 8, n=2)
    f1, f3 = _fields((3, nl, A), dtype, 9, n=2)
    n_atoms = np.random.default_rng(10).integers(0, A + 1, B).astype(
        np.int32)
    kick = _c(0.5 * DT, dtype)
    # comd_tpu/sim.py:380-383 (force_eam.py:380's f1 + f3)
    f_loc = (jnp.asarray(f1) + jnp.asarray(f3)) if two else jnp.asarray(f1)
    fj = jnp.zeros_like(jnp.asarray(f_old)).at[:, :nl].set(f_loc)
    pj = jnp.asarray(p) + jnp.asarray(p).dtype.type(0.5 * DT) * fj
    n_j = int(jnp.sum(jnp.asarray(n_atoms)[:nl]).astype(jnp.int32))
    ft, pt = torch.from_numpy(f_old.copy()), torch.from_numpy(p.copy())
    n_out = torch.tensor(-5, dtype=torch.int32)
    step.land(ft, pt, torch.from_numpy(f1),
              torch.from_numpy(f3) if two else None,
              torch.from_numpy(n_atoms), n_out, nl, kick)
    _close(ft.numpy(), np.asarray(fj), dtype)
    _close(pt.numpy(), np.asarray(pj), dtype)
    assert int(n_out) == n_j
    # a mesh of two shards in one call: the counts of both
    two_f = torch.from_numpy(np.stack([f_old, f_old]))
    two_p = torch.from_numpy(np.stack([p, p]))
    step.land(two_f, two_p, torch.from_numpy(np.stack([f1, f1])), None,
              torch.from_numpy(np.stack([n_atoms, n_atoms])), n_out, nl,
              kick)
    assert int(n_out) == 2 * n_j


def test_wrappers_check_their_operands(geoms):
    """The checks run before the dispatch, so the CPU tests reach them."""
    _jsim, tsim = geoms("float32")
    s, nl = tsim.state, tsim.geom.n_local
    A = s.r.shape[2]
    with pytest.raises(ValueError):
        step.kick_drift_trigger(s.p, s.r, s.f.double(), None, nl, 0.5, 0.1)
    for kw in (dict(handles=(1, 2)), dict(flag=torch.zeros(()))):
        with pytest.raises(ValueError):     # handles off the card, a
            step.kick_drift_trigger(         # float flag
                s.p.clone(), s.r.clone(), s.f, s.r.clone(), nl, 0.5, 0.1,
                **kw)
    with pytest.raises(ValueError):         # a list of shards: no stack
        step.kick_drift_trigger([s.p.clone()], [s.r.clone()], [s.f], None,
                                nl, 0.5, 0.1)
    with pytest.raises(ValueError):
        step.land(s.f, s.p, s.f[:, :nl].transpose(1, 2), None, s.n_atoms,
                  s.n_local, nl, 0.5)
    with pytest.raises(ValueError):
        step.land(s.f, s.p, s.f[:, :nl], None, s.n_atoms.long(),
                  s.n_local, nl, 0.5)
    with pytest.raises(ValueError):
        step.embed_fill(tsim.f_eval, s.r[0, :nl].double(), None,
                        s.n_atoms, s.r.shape[1])
    with pytest.raises(ValueError):
        step.embed_fill(tsim.f_eval, s.r[0, :nl], None, None, s.r.shape[1])
    with pytest.raises(ValueError):
        step.embed_fill(tsim.f_eval, s.r[0, :nl], None, s.n_atoms,
                        s.r.shape[1], tsim.maps.halo_src[1:])
    with pytest.raises(ValueError):
        step.refresh_halo(tsim.geom, tsim.maps, s.r[:, :, :A - 1])
    with pytest.raises(ValueError):     # gid without n_atoms
        step.refresh_halo(tsim.geom, tsim.maps, s.r.clone(), s.gid.clone())
    with pytest.raises(ValueError):     # int64 counts
        step.refresh_halo(tsim.geom, tsim.maps, s.r.clone(), s.gid.clone(),
                          s.n_atoms.long())
    with pytest.raises(ValueError):     # the images of another n_local
        step.kick_drift_trigger(s.p.clone(), s.r.clone(), s.f, None, nl - 1,
                                0.5, 0.1, images=tsim.maps.images)
    with pytest.raises(ValueError):     # f64 images for f32 positions
        other = binning.geom_maps(tsim.geom, torch.float64, "cpu").images
        step.kick_drift_trigger(s.p.clone(), s.r.clone(), s.f, None, nl,
                                0.5, 0.1, images=other)


@pytest.mark.parametrize("elem,e_elem,A,ptrs,want", [
    (4, None, 16, [0, 4096], 4), (8, None, 16, [0, 4096], 2),
    (4, 4, 16, [0], 4), (4, 8, 16, [0], 2), (8, 8, 16, [0], 2),
    (8, 4, 16, [0], 2), (4, None, 15, [0], 1), (8, None, 15, [0], 1),
    (4, None, 18, [0], 1), (8, None, 18, [0], 2), (4, 8, 18, [0], 2),
    (4, None, 16, [0, 8], 1), (8, None, 16, [16, 4104], 1)])
def test_embed_fill_vector_width_by_shape(elem, e_elem, A, ptrs, want):
    """embed_fill's thread takes the slots whose values, and U's with
    energy, fill a 16-byte access (4 f32; 2 f64, or f32 with U in f64)
    when A is a multiple of them and every pointer is 16-byte aligned,
    else one slot."""
    assert step.embed_width(A, elem, ptrs, e_elem) == want


def test_embed_fill_refuses_64_bit_indices(geoms):
    """The kernel's indices are 32 bits: 2^31 slots or more are refused
    (before the dispatch, so the CPU reaches the check)."""
    _jsim, tsim = geoms("float32")
    s, nl = tsim.state, tsim.geom.n_local
    rho = s.r[0, :nl].contiguous()
    with pytest.raises(ValueError, match="32-bit"):
        step.embed_fill(tsim.f_eval, rho, None, s.n_atoms,
                        2 ** 31 // rho.shape[1] + 1)


def test_lazy_steps_through_the_step_ops_match_comd_tpu(monkeypatch):
    """20 lazy EAM steps (f64, exact tables) from one comd_tpu state: each
    step runs kick_drift_trigger (with the ghost refresh), embed_fill and
    land once, and refresh_halo runs once a rebucket (its halo fill);
    the state ends where comd_tpu's does."""
    kw = dict(nx=6, ny=6, nz=6, doeam=True, temperature=1200.0,
              dtype="float64", interp_impl="rows", pot_dir=POTS)
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    tsim.state = state_from_numpy(
        {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
    calls = dict.fromkeys(("kick_drift_trigger", "refresh_halo",
                           "embed_fill", "land"), 0)
    for name in calls:
        orig = getattr(step, name)

        def counted(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(step, name, counted)
    jsim.step_block(20)
    tsim.step_block(20)
    assert tsim.uses_lazy and 1 <= tsim.n_rebucket < 20
    assert calls == dict(kick_drift_trigger=20,
                         refresh_halo=tsim.n_rebucket, embed_fill=20,
                         land=20)
    js, ts = jsim.state, tsim.state
    np.testing.assert_array_equal(ts.gid.numpy(), np.asarray(js.gid))
    np.testing.assert_array_equal(ts.n_atoms.numpy(), np.asarray(js.n_atoms))
    np.testing.assert_allclose(ts.r.numpy(), np.asarray(js.r), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0,
                               atol=1e-8)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, rel=1e-10)
    assert int(ts.n_local) == int(js.n_local) == 864
    assert not bool(ts.overflow)
