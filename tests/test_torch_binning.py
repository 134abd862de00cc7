"""comd_tpu_torch rebucket / halo fill against comd_tpu, bit for bit.

Both packages start from the same comd_tpu state; numpy-seeded
displacements push atoms across cell faces and the periodic boundary, then
both rebucket.  The port's single stable sort on ``box << 31 | gid`` must
give comd_tpu's two-key lax.sort layout exactly: gid, n_atoms, overflow,
n_migrating and the positions/momenta (the wrap and the halo fold are the
same f32/f64 ops in the same order, so the floats are bit-equal too).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import binning as jbin
from comd_tpu.ops import neighborlist as jnl

from comd_tpu_torch.ops import binning as tbin
from comd_tpu_torch.ops.neighborlist import needs_rebuild

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")


@pytest.fixture(scope="module", params=["float64", "float32"])
def ref(request):
    sim = j_init(JConfig(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
                         dtype=request.param, interp_impl="rows",
                         pot_dir=POTS, n_steps=0))
    s = sim.state
    return sim, {k: np.array(getattr(s, k))
                 for k in ("r", "p", "gid", "n_atoms")}


def _displaced(sim, st, seed, scale, crowd=0):
    """Local atoms displaced by uniform(-scale, scale) per axis; ``crowd``
    atoms are piled into local cell 0 to overflow its capacity."""
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
    return r


def _both(sim, st, r, wrap):
    ext = sim.global_extent if wrap else None
    out_j = jbin.rebucket(sim.geom, jnp.asarray(r), jnp.asarray(st["p"]),
                          jnp.asarray(st["gid"]), jnp.asarray(st["n_atoms"]),
                          wrap_extent=ext)
    maps = tbin.geom_maps(sim.geom, torch.from_numpy(r).dtype, "cpu")
    out_t = tbin.rebucket(sim.geom, maps, torch.from_numpy(r),
                          torch.from_numpy(st["p"]),
                          torch.from_numpy(st["gid"]),
                          torch.from_numpy(st["n_atoms"]), wrap_extent=ext)
    return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t], maps


@pytest.mark.parametrize("seed,scale,wrap", [
    (0, 1.5, True), (1, 4.0, True), (2, 1.5, False)])
def test_rebucket_bit_equal(ref, seed, scale, wrap):
    sim, st = ref
    r = _displaced(sim, st, seed, scale)
    oj, ot, _ = _both(sim, st, r, wrap)
    names = ("r", "p", "gid", "n_atoms", "n_migrating", "overflow")
    for name, a, b in zip(names, ot, oj):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the displacement really moved atoms between cells
    assert not np.array_equal(oj[2][:sim.geom.n_local],
                              st["gid"][:sim.geom.n_local])
    assert int(oj[3][:sim.geom.n_local].sum()) == \
        int(st["n_atoms"][:sim.geom.n_local].sum()) - int(oj[4])
    if not wrap:
        assert int(oj[4]) > 0      # halo landers counted as migrating


def test_rebucket_overflow_flag(ref):
    sim, st = ref
    r = _displaced(sim, st, 3, 0.2, crowd=40)
    oj, ot, _ = _both(sim, st, r, True)
    assert bool(oj[5]) and bool(ot[5])
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a, b)


def test_fill_halo_serial_bit_equal(ref):
    sim, st = ref
    r = _displaced(sim, st, 4, 1.0)
    oj, ot, maps = _both(sim, st, r, True)
    rj, gj, nj = jbin.fill_halo_serial(sim.geom, jnp.asarray(oj[0]),
                                       jnp.asarray(oj[2]), jnp.asarray(oj[3]))
    rt, gt, nt = tbin.fill_halo_serial(sim.geom, maps, torch.from_numpy(ot[0]),
                                       torch.from_numpy(ot[2]),
                                       torch.from_numpy(ot[3]))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    x = np.random.default_rng(5).standard_normal(st["gid"].shape)
    xj = jbin.fill_halo_scalar_serial(sim.geom, jnp.asarray(x))
    xt = tbin.fill_halo_scalar_serial(sim.geom, maps, torch.from_numpy(x))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


@pytest.mark.parametrize("scale", [0.05, 0.3])
def test_needs_rebuild_same_decision(ref, scale):
    sim, st = ref
    r = _displaced(sim, st, 6, scale)
    skin = 0.4725
    dj = bool(jnl.needs_rebuild(jnp.asarray(st["r"]), jnp.asarray(r),
                                sim.geom.n_local, skin))
    dt = bool(needs_rebuild(torch.from_numpy(st["r"]), torch.from_numpy(r),
                            sim.geom.n_local, skin))
    assert dt == dj == (scale > 0.5 * skin / np.sqrt(3))
