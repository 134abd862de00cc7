"""The cell-stencil kernels' brick plan (ops/binning.build_brick_plan).

The kernels K1 and K2 (csrc/stencil.cu) run one block per brick of local
cells and stage the union of the brick's neighbor boxes (its region) once;
the plan says, for every brick, its cells, the box ids of its region and
where each (cell, neighbor column) box lies in that region.  These checks
run on the CPU, on geometries alone or on a small thermalized state:

- every (local cell, neighbor column) of ``nbr_map`` (27 columns) and of
  ``half_nbr_map`` (14) is covered exactly once, and every region index
  maps back to the box id the neighbor map gives;
- with row-major and -H Hilbert cell numbering, on every shard of 2x2x2
  and 3x2x1 meshes, on grids the brick does not divide and on a 2^3 grid;
- a numpy walk of the plan counts the same candidate pairs and pairs
  inside the cutoff as chip_smoke.pair_work does from the neighbor map.
"""
import os
import sys

import numpy as np
import pytest
import torch

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.cells import make_geometry
from comd_tpu_torch.ops import binning

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

POTS = os.path.join(ROOT, "pots")
CELL = 3.0    # cell edge of the geometries below (any value >= the cutoff)


def _geom(grid, hilbert=False, lo=(0.0, 0.0, 0.0)):
    lo = np.asarray(lo, np.float64)
    return make_geometry(lo, lo + CELL * np.asarray(grid, np.float64), CELL,
                         use_hilbert=hilbert)


def _shards(mesh, grid, hilbert):
    """The geometry of every shard of a ``mesh`` of shards with ``grid``
    cells each (each in its own frame, as parallel/sharded.py builds it)."""
    out = []
    for z in range(mesh[2]):
        for y in range(mesh[1]):
            for x in range(mesh[0]):
                lo = CELL * np.asarray(grid, np.float64) * (x, y, z)
                out.append(_geom(grid, hilbert, lo))
    return out


# (case, geometries, brick shapes): the shapes the kernels pick at A = 16,
# 32 and 256 (brick_shape clips them to the grid), and shapes that leave
# edge bricks
GEOMETRIES = {
    "row-major 4^3": ([_geom((4, 4, 4))], [(4, 2, 2), (2, 2, 2)]),
    "hilbert 4^3": ([_geom((4, 4, 4), True)], [(4, 2, 2), (2, 2, 2)]),
    "hilbert 8^3": ([_geom((8, 8, 8), True)], [(4, 2, 2), (2, 2, 1)]),
    "edge bricks 5x3x7": ([_geom((5, 3, 7))], [(4, 2, 2), (3, 2, 2)]),
    "edge bricks hilbert 4^3": ([_geom((4, 4, 4), True)], [(3, 3, 3)]),
    "2^3, smaller than a brick": ([_geom((2, 2, 2))],
                                  [(4, 2, 2), (1, 1, 1)]),
    "2x2x2 mesh, hilbert 4^3 shards": (_shards((2, 2, 2), (4, 4, 4), True),
                                       [(4, 2, 2)]),
    "3x2x1 mesh, 3x2x3 shards": (_shards((3, 2, 1), (3, 2, 3), False),
                                 [(4, 2, 2), (2, 2, 2)]),
}


def _columns(geom, half):
    return geom.nbr_map[:, binning.SELF_COLUMN:] if half else geom.nbr_map


def _plans(case, half):
    geoms, shapes = GEOMETRIES[case]
    return [(g, binning.build_brick_plan(g, s, half))
            for g in geoms for s in shapes]


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("case", list(GEOMETRIES))
def test_every_cell_column_once(case, half):
    """Every local cell lies in exactly one brick, so each (cell, column)
    of the neighbor map is swept exactly once; padding cells are -1."""
    for geom, plan in _plans(case, half):
        cells = plan.cells.reshape(-1)
        got = np.sort(cells[cells >= 0])
        np.testing.assert_array_equal(got, np.arange(geom.n_local))
        n_cols = 14 if half else 27
        assert plan.slot.shape == (plan.n_bricks, cells.size // plan.n_bricks,
                                   n_cols)
        assert plan.n_bricks == np.prod(
            -(-np.asarray(geom.grid) // np.asarray(plan.shape)))
        # a brick's cells are a box of the grid: grid coordinates within
        # the brick's shape of its first cell's
        t = geom.tuple_of_box
        for b in range(plan.n_bricks):
            mine = plan.cells[b][plan.cells[b] >= 0]
            span = t[mine].max(0) - t[mine].min(0)
            assert (span < np.asarray(plan.shape)).all()


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("case", list(GEOMETRIES))
def test_region_indices_map_back_to_box_ids(case, half):
    """region_box[region_ptr[b] + slot[b, c, k]] is column k's box of cell
    c; a brick's region holds each box once and only boxes it uses."""
    for geom, plan in _plans(case, half):
        cols = _columns(geom, half)
        for b in range(plan.n_bricks):
            lo, hi = plan.region_ptr[b], plan.region_ptr[b + 1]
            region = plan.region_box[lo:hi]
            assert hi - lo <= plan.max_region
            assert len(np.unique(region)) == len(region)
            ok = plan.cells[b] >= 0
            slots = plan.slot[b][ok]
            assert slots.min() >= 0 and slots.max() < len(region)
            np.testing.assert_array_equal(region[slots],
                                          cols[plan.cells[b][ok]])
            assert set(slots.reshape(-1).tolist()) == set(range(len(region)))
        assert int(plan.region_ptr[-1]) == len(plan.region_box)


@pytest.mark.parametrize("A,shape", [(1, (8, 8, 4)), (16, (4, 2, 2)),
                                     (32, (2, 2, 2)), (64, (2, 2, 1)),
                                     (128, (2, 1, 1)), (129, (1, 1, 1)),
                                     (256, (1, 1, 1)), (512, (1, 1, 1))])
def test_brick_shape_by_capacity(A, shape):
    """About 256 slots a brick (the kernels' block), clipped to the grid."""
    assert binning.brick_shape(A, (42, 42, 42)) == shape
    clipped = binning.brick_shape(A, (2, 2, 2))
    assert clipped == tuple(min(s, 2) for s in shape)


def test_kernels_find_the_plan_of_their_map():
    """The stencil wrappers look the plan up from the neighbor map they are
    given: the full or half map of a GeomMaps, built once per shape."""
    geom = _geom((4, 4, 4), True)
    maps = binning.geom_maps(geom, torch.float32, "cpu")
    full = binning.brick_plan_for(maps.nbr_map, 16)
    half = binning.brick_plan_for(maps.half_nbr_map, 16)
    assert not full.half and half.half and full.shape == (4, 2, 2)
    assert binning.brick_plan_for(maps.nbr_map, 16) is full
    assert isinstance(full.cells, torch.Tensor)
    ref = binning.build_brick_plan(geom, (4, 2, 2), True)
    np.testing.assert_array_equal(half.slot.numpy(), ref.slot)
    with pytest.raises(ValueError, match="GeomMaps"):
        binning.brick_plan_for(maps.nbr_map.clone(), 16)


@pytest.fixture(scope="module")
def thermal():
    """Thermalized 10^3 EAM state (T = 600 K, 5 steps) on the CPU."""
    sim = init_simulation(Config(nx=10, ny=10, nz=10, doeam=True,
                                 temperature=600.0, dtype="float32",
                                 pot_dir=POTS, device="cpu"))
    sim.step_block(5)
    return sim


def _walk(sim, plan):
    """(candidate pairs, pairs inside the cutoff) of a sweep that follows
    the plan: brick by brick, each cell against the region boxes its columns
    point to (the half plan's self column takes j > i)."""
    r = sim.state.r.numpy()
    n = sim.state.n_atoms.numpy().astype(np.int64)
    rcut2 = r.dtype.type(sim.pair_eval.rcut2)
    A = r.shape[2]
    upper = np.triu(np.ones((A, A), bool), k=1)
    cand = inside = 0
    for b in range(plan.n_bricks):
        region = plan.region_box[plan.region_ptr[b]:plan.region_ptr[b + 1]]
        for c, cell in enumerate(plan.cells[b]):
            if cell < 0:
                continue
            boxes = region[plan.slot[b, c]]                # [n_cols]
            ri = r[:, cell, :, None, None]                 # [3, A, 1, 1]
            rj = r[:, boxes][:, None]                      # [3, 1, n, A]
            dx, dy, dz = ri[0] - rj[0], ri[1] - rj[1], ri[2] - rj[2]
            r2 = (dx * dx + dy * dy) + dz * dz
            ok = (r2 <= rcut2) & (r2 > 0)
            if plan.half:
                ok[:, 0] &= upper
                cand += n[cell] * (n[cell] - 1) // 2 + \
                    n[cell] * int(n[boxes[1:]].sum())
            else:
                cand += n[cell] * int(n[boxes].sum())
            inside += int(ok.sum())
    return cand, inside


@pytest.mark.parametrize("half", [False, True])
def test_plan_walk_counts_pair_work(thermal, half):
    """The plan's sweep meets every pair chip_smoke.pair_work counts from
    the neighbor map (with the A = 16 brick and an edge-brick shape)."""
    sim = thermal
    A = sim.state.r.shape[2]
    want = chip_smoke.pair_work(sim, half)
    assert want[1] > 0
    for shape in (binning.brick_shape(A, sim.geom.grid), (3, 2, 2)):
        plan = binning.build_brick_plan(sim.geom, shape, half)
        assert _walk(sim, plan) == want


def test_breakdown_variants_apply(tmp_path):
    """stencil_breakdown.py times copies of csrc/stencil.cu with parts cut
    out: each of its edits applies exactly once to the current source."""
    import stencil_breakdown
    from comd_tpu_torch.ops.cuda import stencil as st
    paths = stencil_breakdown.variant_sources(st.SOURCE, str(tmp_path))
    assert set(paths) == set(stencil_breakdown.EDITS)
    full = open(paths["full"]).read()
    assert full == open(st.SOURCE).read()
    assert all(open(p).read() != full for k, p in paths.items()
               if k != "full")


def test_nl_breakdown_variants_apply(tmp_path):
    """stencil_breakdown.py --nl times copies of csrc/nl.cu with parts cut
    out: each of NL_EDITS applies exactly once to the current source."""
    import stencil_breakdown
    from comd_tpu_torch.ops.cuda import nl as nlk
    paths = stencil_breakdown.variant_sources(nlk.SOURCE, str(tmp_path),
                                              stencil_breakdown.NL_EDITS)
    assert set(paths) == set(stencil_breakdown.NL_EDITS)
    full = open(paths["full"]).read()
    assert full == open(nlk.SOURCE).read()
    assert all(open(p).read() != full for k, p in paths.items()
               if k != "full")
