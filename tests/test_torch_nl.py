"""The port's Verlet neighbor lists (-m *_nl, -L) against comd_tpu, serial.

Both packages start from one comd_tpu state (6^3 FCC Cu, f64, T = 1200 K,
0.05 A initial displacements), carried over with ``state_from_numpy``:
  - the build: a_list, a_valid, the lists on valid rows and the overflow
    bit equal bit for bit in f64, with and without the -a 1 row split and
    with a K too small; in f32 the lists equal except for pairs within 2
    ulps of (rcut + skin)^2 (comd_tpu's XLA may contract r2 into FMAs);
  - the list sweep's plain version (EAM pass 1 and 3, Chebyshev and exact
    table; LJ) on comd_tpu's own list, carried over with
    ``nlist_from_numpy``, against pair_sweep_nl + scatter_rows: 1e-12
    relative to the largest value;
  - eam_force_nl(_split) and lj_force_nl(_split), their per-row forces
    landed by land_rows: force 1e-12 relative, ePot 1e-9;
  - 20-step trajectories through at least one rebuild, -m thread_atom_nl
    EAM and -L LJ: ePot within 1e-9 at t = 0 and 1e-7 after (the
    tolerances of tests/test_neighborlist.py), no atom lost.
The 2x2x2 mesh runs are in tests/test_torch_nl_mesh.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import binning as jbin
from comd_tpu.ops import force_eam as jeam, force_lj as jlj
from comd_tpu.ops import neighborlist as jnl

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import (FIELDS, NL_FIELDS, nlist_from_numpy,
                                    nlist_to_numpy, state_from_numpy)
from comd_tpu_torch.ops import force_eam, force_lj
from comd_tpu_torch.ops import neighborlist as nlmod
from comd_tpu_torch.ops.cuda import nl as cuda_nl
from comd_tpu_torch.ops.cuda import step as step_ops

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
BASE = dict(nx=6, ny=6, nz=6, temperature=1200.0, initial_delta=0.05,
            dtype="float64", interp_impl="rows", pot_dir=POTS)


def _carry(jsim, **kw):
    """The port's simulation of ``kw`` holding comd_tpu's state."""
    tsim = init_simulation(Config(device="cpu", **kw))
    assert tsim.geom.grid == jsim.geom.grid
    assert tsim.cfg.max_atoms == jsim.cfg.max_atoms
    tsim.state = state_from_numpy(
        {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
    return tsim


@pytest.fixture(scope="module", params=["eam", "lj"])
def pair(request):
    """(comd_tpu sim, port sim) at t = 0 from one state, and the kwargs."""
    kw = dict(BASE, doeam=request.param == "eam", method="thread_atom_nl")
    jsim = j_init(JConfig(**kw))
    return jsim, _carry(jsim, **kw), kw


def _build_both(jsim, tsim, r_np, k, split):
    jp = jsim._nl_build_params()
    tp = tsim.nl_build_params()
    assert (tp["k"], tp["rcut2"], tp["n_rows"]) == (jp["k"], jp["rcut2"],
                                                    jp["n_rows"])
    A = tsim.cfg.max_atoms
    j_split = jnl.row_split_for(jsim.geom, A) if split else None
    t_split = nlmod.row_split_for(tsim.geom, A) if split else None
    if split:
        np.testing.assert_array_equal(t_split[0], j_split[0])
        assert t_split[1:] == j_split[1:]
    j_list, j_ovf = jnl.build(jsim.geom, jnp.asarray(r_np),
                              jsim.state.n_atoms, k=k, rcut2=jp["rcut2"],
                              n_rows=jp["n_rows"], chunk=512,
                              row_split=j_split)
    t_list, t_ovf = nlmod.build(tsim.geom, tsim.maps.nbr_map,
                                torch.from_numpy(np.array(r_np)),
                                tsim.state.n_atoms,
                                k=k, rcut2=tp["rcut2"], n_rows=tp["n_rows"],
                                row_split=t_split)
    return j_list, bool(j_ovf), t_list, bool(t_ovf), tp


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("small_k", [False, True])
def test_build_matches_comd_tpu_f64(pair, split, small_k):
    jsim, tsim, _kw = pair
    k = 8 if small_k else jsim._nl_build_params()["k"]
    j_list, j_ovf, t_list, t_ovf, _tp = _build_both(
        jsim, tsim, np.asarray(jsim.state.r), k, split)
    v = np.asarray(j_list.a_valid)
    np.testing.assert_array_equal(t_list.a_list.numpy(),
                                  np.asarray(j_list.a_list))
    np.testing.assert_array_equal(t_list.a_valid.numpy(), v)
    np.testing.assert_array_equal(t_list.nl.numpy()[v],
                                  np.asarray(j_list.nl)[v])
    assert t_ovf == j_ovf == small_k
    assert v.sum() == jsim.n_global


def test_build_matches_comd_tpu_f32(pair):
    jsim, tsim, _kw = pair
    r = np.asarray(jsim.state.r).astype(np.float32)
    k = jsim._nl_build_params()["k"]
    j_list, j_ovf, t_list, t_ovf, tp = _build_both(jsim, tsim, r, k, False)
    assert t_ovf == j_ovf is False
    v = np.asarray(j_list.a_valid)
    rc2 = np.float32(tp["rcut2"])
    r_flat = r.reshape(3, -1).astype(np.float64)
    n_diff = 0
    for row in np.flatnonzero(v):
        got = set(t_list.nl[row].tolist())
        want = set(np.asarray(j_list.nl[row]).tolist())
        for j in got ^ want:
            i = int(t_list.a_list[row])
            r2 = float(((r_flat[:, i] - r_flat[:, j]) ** 2).sum())
            assert abs(r2 - rc2) <= 2 * np.spacing(rc2), (row, j, r2)
            n_diff += 1
    assert n_diff <= 4


def _comd_sweep(jsim, j_list, kind, impl):
    """comd_tpu's pair_sweep_nl + scatter_rows: per pass, the [.., B, A]
    outputs."""
    r = jsim.state.r
    B, A = r.shape[1], r.shape[2]
    pot = jsim.pot
    rc2 = pot.cutoff ** 2

    def scatter(f, scal):
        return [jnl.scatter_rows(j_list, x, B, A) for x in [f] + list(scal)]

    if kind == "lj":
        return {e: scatter(*jnl.pair_sweep_nl(
            j_list, r, jlj.make_lj_pair_fn(pot, r.dtype, e), rc2))
            for e in (True, False)}
    ev_phi, ev_rho = jeam.make_evaluators(pot, r.dtype, False, impl)
    out = {e: scatter(*jnl.pair_sweep_nl(
        j_list, r, jeam.make_pair1(ev_phi, ev_rho, e), rc2))
        for e in (True, False)}
    rho = out[True][2]
    _f, dfe = jeam.make_f_eval(pot, r.dtype, impl)(rho)
    dfe = jbin.fill_halo_scalar_serial(jsim.geom, jnp.where(
        jnp.asarray(np.arange(B) < jsim.geom.n_local)[:, None], dfe, 0.0))
    out["pass3"] = scatter(*jnl.pair_sweep_nl(
        j_list, r, jeam.make_pair3(ev_rho), rc2, scalar_j=[dfe]))
    return out, np.asarray(dfe)


def test_sweep_matches_pair_sweep_nl(pair):
    """NL2's plain version on comd_tpu's list against pair_sweep_nl +
    scatter_rows (EAM with the exact table and with the Chebyshev fit):
    forces and scalars within 1e-12 of their largest value."""
    jsim, tsim, kw = pair
    lst = nlist_from_numpy(
        {k: np.asarray(getattr(jsim.nlist, k)) for k in NL_FIELDS}, "cpu",
        tsim.geom.n_local)
    back = nlist_to_numpy(lst)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jsim.nlist, k)))
    r = tsim.state.r
    B, A = r.shape[1], r.shape[2]
    for impl in (("rows", "cheb") if kw["doeam"] else ("lj",)):
        if kw["doeam"]:
            ev = force_eam.make_pair_evaluator(tsim.pot, r.dtype, "cpu",
                                               impl)
            want, dfe = _comd_sweep(jsim, jsim.nlist, "eam", impl)
            got = {e: cuda_nl.eam_pass1(lst, r, ev, want_energy=e)
                   for e in (True, False)}
            got["pass3"] = (cuda_nl.eam_pass3(lst, r, ev,
                                              torch.tensor(dfe)),)
        else:
            ev = tsim.pair_eval
            want = _comd_sweep(jsim, jsim.nlist, "lj", impl)
            got = {e: cuda_nl.lj_pass(lst, r, ev, want_energy=e)
                   for e in (True, False)}
        for key, outs in got.items():
            outs = [x for x in outs if x is not None]
            assert len(outs) == len(want[key]), (impl, key)
            for g, w in zip(outs, want[key]):
                g = nlmod.scatter_rows(lst, g, B, A).numpy()
                w = np.asarray(w)
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=1e-12 * np.abs(w).max())


@pytest.mark.parametrize("split", [False, True])
def test_force_nl_matches_comd_tpu(pair, split):
    """eam_force_nl(_split) and lj_force_nl(_split) on comd_tpu's state,
    each package on its own list built with the same row split; the
    port's per-row force landed in the cell layout by land_rows (no
    kick)."""
    jsim, tsim, kw = pair
    k = jsim._nl_build_params()["k"]
    j_list, _jo, t_list, _to, _tp = _build_both(
        jsim, tsim, np.asarray(jsim.state.r), k, split)
    r_j, r_t = jsim.state.r, tsim.state.r
    n_t = [tsim.state.n_atoms]
    Ri = nlmod.row_split_for(tsim.geom, tsim.cfg.max_atoms)[1]
    if kw["doeam"]:
        def j_fill(x, rhobar_l=None):
            return jbin.fill_halo_scalar_serial(jsim.geom, x)
        jargs = dict(interp_impl="rows", e_dtype=jnp.float64)
        if split:
            fj, ej, _d = jeam.eam_force_nl_split(j_list, jsim.pot, r_j,
                                                 j_fill, Ri, **jargs)
            (ft, et, _dt), = force_eam.eam_force_nl_split(
                [t_list], [r_t], tsim.pair_eval, tsim.f_eval, tsim._fill,
                Ri, n_atoms=n_t)
        else:
            fj, ej, _d = jeam.eam_force_nl(j_list, jsim.pot, r_j, j_fill,
                                           **jargs)
            (ft, et, _dt), = force_eam.eam_force_nl(
                [t_list], [r_t], tsim.pair_eval, tsim.f_eval, tsim._fill,
                n_atoms=n_t)
    else:
        if split:
            fj, _u, ej = jlj.lj_force_nl_split(j_list, jsim.pot, r_j, Ri)
            (ft, _ut, et), = force_lj.lj_force_nl_split(
                [t_list], tsim.pot, [r_t], tsim.pair_eval, Ri, n_atoms=n_t)
        else:
            fj, _u, ej = jlj.lj_force_nl(j_list, jsim.pot, r_j)
            (ft, _ut, et), = force_lj.lj_force_nl(
                [t_list], tsim.pot, [r_t], tsim.pair_eval, n_atoms=n_t)
    assert isinstance(ft, nlmod.RowForce)
    f_dense = torch.full_like(r_t, np.nan)
    step_ops.land_rows(f_dense, None, ft.nlist, ft.n_atoms, ft.parts, None,
                       tsim.geom.n_local)
    ft = f_dense
    fj = np.asarray(fj)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0,
                               atol=1e-12 * np.abs(fj).max())
    assert np.abs(fj).max() > 0.1
    assert float(et) == pytest.approx(float(ej), abs=1e-9)


@pytest.mark.parametrize("doeam", [True, False], ids=["eam_nl", "lj_L"])
def test_nl_trajectory_matches_comd_tpu(doeam):
    """20 steps, -m thread_atom_nl EAM or -L LJ, from one state, through
    at least one rebuild of the list."""
    kw = dict(BASE, doeam=doeam, **({"method": "thread_atom_nl"} if doeam
                                    else {"use_pairlist": True}))
    jsim = j_init(JConfig(**kw))
    tsim = _carry(jsim, **kw)
    assert tsim.uses_nl and not tsim.uses_lazy
    tsim.build_neighbor_list()
    tsim.compute_force()
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-9)
    jsim.step_block(10)
    tsim.step_block(10)
    jsim.step_block(10)
    tsim.step_block(10)
    assert tsim.n_nl_build >= 2               # the init build and a rebuild
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-7)
    assert tsim.kinetic_energy() == pytest.approx(jsim.kinetic_energy(),
                                                  abs=1e-7)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 864
    assert not tsim.overflow
    np.testing.assert_array_equal(tsim.state.gid.numpy(),
                                  np.asarray(jsim.state.gid))


def test_undersized_k_overflows_at_init():
    """nl_max_neighbors too small raises the overflow flag at t = 0."""
    sim = init_simulation(Config(device="cpu", doeam=True,
                                 method="thread_atom_nl",
                                 nl_max_neighbors=16, **BASE))
    assert sim.overflow
    assert sim.nl_build_params()["k"] == 16


def _padding_at_tail(a_list, a_valid, nl):
    """Per valid row: every entry before the first padding entry (the row's
    own slot id) is real and every entry from there on is padding (the
    invariant NL2's early stop reads).  Returns the rows' padding mask."""
    nl, a_list = np.asarray(nl), np.asarray(a_list)
    v = np.asarray(a_valid)
    pad = nl == a_list[:, None]
    first = np.where(pad.any(1), pad.argmax(1), nl.shape[1])
    tail = np.arange(nl.shape[1])[None, :] >= first[:, None]
    np.testing.assert_array_equal(pad[v], tail[v])
    return pad


@pytest.mark.parametrize("lists", ["k", "k8", "split"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_padding_only_at_row_tails(pair, dtype, lists):
    """NL2 stops a row at its first chunk holding padding.  On comd_tpu's
    list and on the port's plain list (f32 and f64; K as the run sizes
    it, K = 8 with every row overflowing, and the -a 1 row split): a valid
    row's real entries come first and its padding after them, the real
    ones number min(count, K); the port's invalid rows are all padding
    (comd_tpu's hold slot 0's list, which no sweep reads)."""
    jsim, tsim, _kw = pair
    r = np.asarray(jsim.state.r).astype(dtype)
    k = 8 if lists == "k8" else jsim._nl_build_params()["k"]
    j_list, _jo, t_list, _to, tp = _build_both(jsim, tsim, r, k,
                                               lists == "split")
    _padding_at_tail(j_list.a_list, j_list.a_valid, j_list.nl)
    pad = _padding_at_tail(t_list.a_list.numpy(), t_list.a_valid.numpy(),
                           t_list.nl.numpy())
    v = t_list.a_valid.numpy()
    assert pad[~v].all()
    _nl, count = nlmod.candidate_lists(t_list.last_r, t_list.a_list,
                                       t_list.a_valid, tsim.maps.nbr_map,
                                       k=k, rcut2=tp["rcut2"])
    np.testing.assert_array_equal((~pad).sum(1),
                                  np.minimum(count.numpy(), k))
    if lists == "k8":
        assert not pad[v].any()           # no row of K = 8 ends early
    else:
        assert pad[v].any(1).all()


@pytest.mark.parametrize("split", [False, True])
def test_cell_row_starts_match_atom_rows(pair, split):
    """NL1's, ER's and LR's per-cell row offsets: each valid row of the
    build's rows (``nl_rows_plain``) sits at row_start[a_list // A] +
    a_list % A (with and without the row split, also with an emptied
    cell); without the split row_start is the exclusive cumsum of
    min(n_atoms, A) over the local cells, with it the interior cells'
    from 0 and the boundary cells' from Ri; ``cell_row_starts`` (a list
    made elsewhere) gives the same on every cell with rows."""
    _jsim, tsim, _kw = pair
    geom, A = tsim.geom, tsim.cfg.max_atoms
    row_split = nlmod.row_split_for(geom, A) if split else None
    n_rows = (row_split[1] + row_split[2] if split
              else nlmod.n_rows_for(geom, A))
    for emptied in (False, True):
        n_atoms = tsim.state.n_atoms.clone()
        if emptied:
            n_atoms[geom.n_local // 3] = 0
        a_list, a_valid, start = nlmod.nl_rows_plain(geom, n_atoms, A,
                                                     n_rows, row_split)
        assert start.dtype == torch.int32 and start.shape == (geom.n_local,)
        rows = torch.nonzero(a_valid).flatten()
        al = a_list[rows].to(torch.int64)
        np.testing.assert_array_equal(
            (start.to(torch.int64)[al // A] + al % A).numpy(), rows.numpy())
        occ = n_atoms[:geom.n_local].clamp(max=A).to(torch.int64)
        has = occ > 0
        derived = nlmod.cell_row_starts(a_list, a_valid, geom.n_local, A)
        np.testing.assert_array_equal(derived[has].numpy(),
                                      start[has].numpy())
        if not split:
            excl = torch.cumsum(occ, 0) - occ
            np.testing.assert_array_equal(start.numpy(), excl.numpy())
        else:
            is_b = torch.as_tensor(row_split[0])
            for mask, base in ((~is_b, 0), (is_b, row_split[1])):
                o = occ[mask]
                np.testing.assert_array_equal(
                    start[mask].numpy(), (torch.cumsum(o, 0) - o + base)
                    .numpy())
