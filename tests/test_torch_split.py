"""-a 1 of the cell methods on a mesh: K1 over the interior and the boundary
cells apart (ops/force_eam.eam_force_split, ops/force_lj.lj_force_split).

On the CPU, with the kernels' plain versions:
  - the brick plans over the interior and the boundary subsets
    (binning.brick_plan_for with a BoxSubset) together cover every local
    cell exactly once, hold no brick without a cell of their subset, and
    map every region index back to the box the neighbor map gives; an
    empty subset (a grid of 2 cells along an axis) makes no plan;
  - the plain K1 over the interior plus the boundary equals the plain full
    sweep bit for bit (f64), for EAM passes 1 (with and without energy)
    and 3 and LJ;
  - the -a 1 mesh against the port's own -a 0 run of the same flags: the
    final states within 1e-12, under collective, -P and ki_fused (its
    fill's plain version, F' of the split's summed rhobar), on a 2x1x1
    mesh of 12x6x6 (4^3 cells a shard, 8 interior) and, with no interior
    cell, 8^3 on 2x2x2 (2^3 cells a shard);
  - LJ under -I and -a 1 runs analytic LJ, as comd_tpu's dispatch does.
The -a 1 mesh against comd_tpu's: tests/test_torch_split_mesh.py.
"""
import os

import numpy as np
import pytest
import torch

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.cells import make_geometry
from comd_tpu_torch.interop import shards_to_numpy
from comd_tpu_torch.ops import binning
from comd_tpu_torch.ops.cuda import stencil as st

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
MESH = dict(xproc=2, yproc=2, zproc=2)
KW = dict(temperature=1200.0, initial_delta=0.1, dtype="float64",
          pot_dir=POTS, gpu_async=1)
CELL = 3.0


def _geom(grid, hilbert=False):
    return make_geometry(np.zeros(3), CELL * np.asarray(grid, np.float64),
                         CELL, use_hilbert=hilbert)


@pytest.mark.parametrize("grid,hilbert,n_interior", [
    ((4, 4, 4), False, 8), ((4, 4, 4), True, 8), ((5, 3, 7), False, 15),
    ((21, 21, 21), False, 19 ** 3), ((2, 2, 2), False, 0)])
def test_subset_plans_cover_each_cell_once(grid, hilbert, n_interior):
    geom = _geom(grid, hilbert)
    maps = binning.geom_maps(geom, torch.float64, "cpu")
    assert (maps.interior.n, maps.boundary.n) == (
        n_interior, geom.n_local - n_interior)
    t = geom.tuple_of_box[maps.interior.ids]
    assert ((t >= 1) & (t < np.asarray(grid) - 1)).all()
    seen = []
    for subset in (maps.interior, maps.boundary):
        if subset.n == 0:
            continue
        plan = binning.brick_plan_for(maps.nbr_map, 16, subset)
        assert binning.brick_plan_for(maps.nbr_map, 16, subset) is plan
        cells = plan.cells.numpy()
        mine = cells[cells >= 0]
        np.testing.assert_array_equal(np.sort(mine), subset.ids)
        assert (cells >= 0).any(axis=1).all()        # no brick left empty
        ptr, region = plan.region_ptr.numpy(), plan.region_box.numpy()
        slot = plan.slot.numpy()
        for b in range(plan.n_bricks):
            ok = cells[b] >= 0
            reg = region[ptr[b]:ptr[b + 1]]
            np.testing.assert_array_equal(reg[slot[b][ok]],
                                          geom.nbr_map[cells[b][ok]])
            # the region holds only boxes its subset's cells use
            assert set(slot[b][ok].reshape(-1).tolist()) == \
                set(range(len(reg)))
        seen.append(mine)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(geom.n_local))
    # the full plan is the one it was before subsets existed
    full = binning.brick_plan_for(maps.nbr_map, 16)
    np.testing.assert_array_equal(
        full.cells.numpy(),
        binning.build_brick_plan(geom, full.shape, False).cells)


@pytest.fixture(scope="module")
def thermal():
    """A thermalized serial 6^3 EAM state (4^3 cells, 8 interior), f64."""
    sim = init_simulation(Config(nx=6, ny=6, nz=6, doeam=True,
                                 temperature=600.0, dtype="float64",
                                 pot_dir=POTS, device="cpu"))
    sim.step_block(5)
    assert sim.maps.interior.n == 8
    return sim


@pytest.mark.parametrize("fn", ["eam_pass1", "eam_pass1_no_energy",
                                "eam_pass3", "lj"])
def test_plain_split_equals_full_sweep(thermal, fn):
    sim = thermal
    r, nbr, maps = sim.state.r, sim.maps.nbr_map, sim.maps
    ev = sim.pair_eval
    if fn == "lj":
        from comd_tpu_torch.ops.force_lj import make_lj_evaluator
        from comd_tpu_torch.potentials.lj import init_lj_pot
        # the EAM state's positions through the LJ pair (2 sigma = 4.6 A,
        # inside the cells)
        ev = make_lj_evaluator(init_lj_pot(2.0), r.dtype)

        def run(boxes=None):
            return st.lj_pass(r, nbr, ev, boxes=boxes)
    elif fn == "eam_pass3":
        dfe = torch.rand(r.shape[1:], dtype=r.dtype,
                         generator=torch.Generator().manual_seed(3))

        def run(boxes=None):
            return (st.eam_pass3(r, nbr, ev, dfe, boxes=boxes),)
    else:
        energy = fn == "eam_pass1"

        def run(boxes=None):
            return st.eam_pass1(r, nbr, ev, want_energy=energy, boxes=boxes)
    full = run()
    parts = [run(maps.interior), run(maps.boundary)]
    for k, want in enumerate(full):
        if want is None:
            assert parts[0][k] is None and parts[1][k] is None
            continue
        for sub, other in ((maps.interior, maps.boundary),
                           (maps.boundary, maps.interior)):
            got = parts[0][k] if sub is maps.interior else parts[1][k]
            zero = got.index_select(got.dim() - 2, other.index)
            assert not bool(zero.any())           # zero outside the subset
        assert torch.equal(parts[0][k] + parts[1][k], want)


def _final(sim):
    return shards_to_numpy(sim.states, sim.mesh.grid)


def _run(sim, blocks=2):
    for _ in range(blocks):
        sim.step_block(10)


@pytest.mark.parametrize("case,extra", [
    ("collective", dict()), ("spline", dict(spline=True)),
    ("ki_fused", dict(comm_impl="ki_fused")),
    ("no_interior", dict(nx=8, ny=8, nz=8, **MESH))])
def test_split_mesh_matches_a0(case, extra):
    kw = dict(KW, doeam=True, nx=12, ny=6, nz=6, xproc=2, yproc=1, zproc=1)
    kw.update(extra)
    sims = []
    for a in (1, 0):
        sim = init_simulation(Config(device="cpu", **dict(kw, gpu_async=a)))
        assert sim.uses_split == (a == 1)
        _run(sim, 1 if case == "no_interior" else 2)
        sims.append(sim)
    split, ref = sims
    assert split.maps.interior.n == (0 if case == "no_interior" else 8)
    if case != "no_interior":
        assert split.n_rebucket == ref.n_rebucket >= 1
    got, want = _final(split), _final(ref)
    for k in ("gid", "n_atoms"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("r", "p", "f"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
    assert split.e_potential == pytest.approx(ref.e_potential, rel=1e-12)
    assert not split.overflow


def test_split_takes_analytic_lj_under_interp():
    """comd_tpu's sharded dispatch takes the -a 1 split before -I: the
    split runs analytic LJ, the same numbers as without -I; -a 0 keeps
    K1's LJ table."""
    kw = dict(KW, nx=12, ny=6, nz=6, xproc=2, yproc=1, zproc=1)
    sims = {(a, i): init_simulation(Config(device="cpu", **dict(
        kw, gpu_async=a, lj_interpolation=i)))
        for a, i in ((1, True), (1, False), (0, True))}
    assert sims[1, True].pair_eval.kind == "lj"
    assert sims[0, True].pair_eval.kind == "lj_table"
    assert sims[1, True].e_potential == sims[1, False].e_potential
