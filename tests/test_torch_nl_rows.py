"""The list paths' row ops against comd_tpu, on the CPU (plain versions).

The row ops between the list sweeps are hand-written kernels on the card
(NR ``nl_rows`` in csrc/nl.cu, ER ``embed_rows`` and LR ``land_rows`` in
csrc/step.cu); on CPU tensors their wrappers run the plain versions in
ops/neighborlist.py, held here against comd_tpu's XLA code:
  - NR: a_list and a_valid equal comd_tpu's ``build_atom_list`` and
    ``build_atom_list_split`` bit for bit (6^3, 7^3 and 9^3 grids, a cell
    with n > A and an emptied one, a row capacity too small for every
    atom), and each valid row sits at ``row_start[c] + s``; the wrapper
    writes the same rows in place;
  - ER: dfEmbed equals comd_tpu's pass 2 + ``scatter_rows`` +
    ``fill_halo_scalar_serial`` (eam_force_nl's) within 1e-12 of its
    largest value in f64 and 2 ulp in f32, with zero halo rows as the mesh
    leaves them, and U a row and ePot within 1e-12 (f64); one or two row
    segments give the same bits, and the port's previous composition
    (interpolate, where, scatter_rows, the index_select fill) the same
    bits;
  - LR: the landing of one or two passes, from one or two row segments,
    with and without the kick, equals the port's previous composition
    (``scatter_rows(f1 + f3)``, then ``land``) and comd_tpu's
    ``scatter_rows`` of the same sum bit for bit;
  - the slice: 10 steps through a rebuild of serial -m thread_atom_nl EAM
    and -L LJ, and of a 2x2x2 -a 1 thread_atom_nl mesh, against comd_tpu
    (its serial run; its sharded run under collective) at the tolerances
    of tests/test_torch_nl.py and test_torch_nl_mesh.py.
Inputs are made from numpy seeds; f64 unless a case says f32.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import binning as jbin
from comd_tpu.ops import force_eam as jeam
from comd_tpu.ops import neighborlist as jnl

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import FIELDS, shards_to_numpy, state_from_numpy
from comd_tpu_torch.ops import force_eam
from comd_tpu_torch.ops import neighborlist as nlmod
from comd_tpu_torch.ops.cuda import nl as cuda_nl
from comd_tpu_torch.ops.cuda import step as step_ops

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
BASE = dict(temperature=1200.0, initial_delta=0.05, interp_impl="rows",
            pot_dir=POTS)
_SIMS = {}


def _pair(n: int, dtype: str = "float64", doeam: bool = True, **kw):
    """(comd_tpu sim, port sim holding its state, kwargs) at n^3, made
    once a module."""
    key = (n, dtype, doeam, tuple(sorted(kw.items())))
    if key not in _SIMS:
        kw = dict(BASE, nx=n, ny=n, nz=n, dtype=dtype, doeam=doeam,
                  **({"method": "thread_atom_nl"} if doeam
                     else {"use_pairlist": True}), **kw)
        jsim = j_init(JConfig(**kw))
        tsim = init_simulation(Config(device="cpu", **kw))
        assert tsim.geom.grid == jsim.geom.grid
        assert tsim.cfg.max_atoms == jsim.cfg.max_atoms
        tsim.state = state_from_numpy(
            {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
        _SIMS[key] = (jsim, tsim, kw)
    return _SIMS[key]


def _counts(tsim, crowd: bool) -> np.ndarray:
    """The state's counts, or with ``crowd`` one local cell past A (its
    first A slots real) and one emptied."""
    n = tsim.state.n_atoms.numpy().copy()
    if crowd:
        nl = tsim.geom.n_local
        n[nl // 2] = tsim.cfg.max_atoms + 3
        n[nl // 3] = 0
    return n


def _rows_of(tsim, n_atoms, factor: float = 1.0, split: bool = False):
    A = tsim.cfg.max_atoms
    row_split = nlmod.row_split_for(tsim.geom, A) if split else None
    return A, row_split, nlmod.n_rows_for(tsim.geom, A, factor)


@pytest.mark.parametrize("crowd", [False, True], ids=["state", "crowd"])
@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("n", [6, 7, 9])
def test_nl_rows_match_build_atom_list(n, split, crowd):
    """NR's plain version against comd_tpu's build_atom_list(_split), bit
    for bit; each valid row at row_start[c] + s; the wrapper (the plain
    version on the CPU) the same rows, also in place."""
    jsim, tsim, _kw = _pair(n)
    counts = _counts(tsim, crowd)
    n_t = torch.from_numpy(counts)
    A, row_split, n_rows = _rows_of(tsim, n_t, split=split)
    if split:
        j_list, j_valid, _n = jnl.build_atom_list_split(
            jsim.geom, jnp.asarray(counts), A,
            jnl.row_split_for(jsim.geom, A))
    else:
        j_list, j_valid, _n = jnl.build_atom_list(
            jsim.geom, jnp.asarray(counts), A, n_rows)
    a_list, a_valid, start = nlmod.nl_rows_plain(tsim.geom, n_t, A, n_rows,
                                                 row_split)
    np.testing.assert_array_equal(a_list.numpy(), np.asarray(j_list))
    np.testing.assert_array_equal(a_valid.numpy(), np.asarray(j_valid))
    assert a_list.dtype == start.dtype == torch.int32
    assert int(a_valid.sum()) == int(np.minimum(
        counts[:tsim.geom.n_local], A).sum())
    rows = torch.nonzero(a_valid).flatten()
    al = a_list[rows].to(torch.int64)
    np.testing.assert_array_equal(
        (start.to(torch.int64)[al // A] + al % A).numpy(), rows.numpy())
    out = (torch.full_like(a_list, -7), torch.ones_like(a_valid),
           torch.full_like(start, -7))
    got = cuda_nl.nl_rows(tsim.geom, n_t, A, n_rows, row_split, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, (a_list, a_valid, start)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [6, 9])
def test_nl_rows_past_the_row_capacity(n):
    """A row capacity a quarter of the slots (comd_tpu's nl_rows_factor):
    comd_tpu's first R rows, every row valid, and a slot whose row would
    be at or past R has none (row_start + s >= R), so ER and LR give it
    0."""
    jsim, tsim, _kw = _pair(n)
    counts = _counts(tsim, False)
    n_t = torch.from_numpy(counts)
    A, _s, n_rows = _rows_of(tsim, n_t, factor=0.25)
    assert n_rows < int(np.minimum(counts[:tsim.geom.n_local], A).sum())
    j_list, j_valid, _n = jnl.build_atom_list(jsim.geom, jnp.asarray(counts),
                                              A, n_rows)
    a_list, a_valid, start = nlmod.nl_rows_plain(tsim.geom, n_t, A, n_rows)
    np.testing.assert_array_equal(a_list.numpy(), np.asarray(j_list))
    np.testing.assert_array_equal(a_valid.numpy(), np.asarray(j_valid))
    assert bool(a_valid.all())
    row, has = nlmod.slot_rows(start, n_t, tsim.geom.n_local, A, n_rows)
    assert int(has.sum()) == n_rows
    np.testing.assert_array_equal(
        np.sort(a_list.numpy()),
        np.flatnonzero(has.reshape(-1).numpy()))
    assert torch.equal(row[has], torch.arange(n_rows))


def _list(tsim, split: bool, dtype):
    """The port's list on the state (plain NL1), with or without the row
    split, positions in ``dtype``."""
    p = tsim.nl_build_params()
    r = tsim.state.r.to(dtype)
    lst, _o = nlmod.build(tsim.geom, tsim.maps.nbr_map, r,
                          tsim.state.n_atoms, k=p["k"], rcut2=p["rcut2"],
                          n_rows=p["n_rows"],
                          row_split=nlmod.row_split_for(
                              tsim.geom, tsim.cfg.max_atoms)
                          if split else None)
    return lst


def _row_inputs(tsim, lst, dtype, seed: int):
    """rho and phi a row as NL2 leaves them (0 on invalid rows), made from
    a numpy seed: rho across F's table, phi a pair energy sum."""
    rng = np.random.default_rng(seed)
    R = lst.a_list.shape[0]
    v = lst.a_valid.numpy()
    f = tsim.pot.f
    hi = f.x0 + (f.n - 1) / f.inv_dx
    rho = np.where(v, rng.uniform(0.0, 1.1 * hi, R), 0.0)
    phi = np.where(v, rng.uniform(-1.0, 0.5, R), 0.0)
    return (torch.as_tensor(rho, dtype=dtype),
            torch.as_tensor(phi, dtype=dtype))


def _segs(x, cut):
    """``x`` [..., R] as one segment or as two (copies, rows [0, cut) and
    [cut, R))."""
    if cut is None:
        return (x,)
    return (x[..., :cut].clone(), x[..., cut:].clone())


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("energy", [True, False], ids=["energy", "force"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_embed_rows_match_comd_tpu(dtype, energy, split):
    """ER's plain version against comd_tpu's pass 2 of eam_force_nl (F and
    F' a row, the masked U, scatter_rows, the serial fill) on one list
    (the port's, equal to comd_tpu's bit for bit), the serial fill and
    zero halo rows; one and two segments (the split's Ri, or a cut at R/3)
    the same bits; the port's previous composition the same bits."""
    jsim, tsim, _kw = _pair(7)
    tdt = getattr(torch, dtype)
    lst = _list(tsim, split, tdt)
    geom, maps = tsim.geom, tsim.maps
    B, A = tsim.state.r.shape[1:]
    f_eval = force_eam.make_f_eval(tsim.pot, tdt, "cpu")
    rho, phi = _row_inputs(tsim, lst, tdt, 11)
    R = rho.shape[0]
    cut = nlmod.row_split_for(geom, A)[1] if split else R // 3
    e_dtype = torch.float64
    n_t = tsim.state.n_atoms
    ph = phi if energy else None
    for halo in (maps.halo_src, None):
        got = [nlmod.embed_rows_plain(
            f_eval, lst, n_t, _segs(rho, c),
            None if ph is None else _segs(ph, c), geom.n_local, B, halo,
            e_dtype) for c in (None, cut)]
        # one and two segments, and the wrapper (plain on the CPU)
        wrap = step_ops.embed_rows(f_eval, lst, n_t, _segs(rho, cut),
                                   None if ph is None else _segs(ph, cut),
                                   geom.n_local, B, halo, e_dtype)
        for g in got[1:] + [wrap]:
            assert torch.equal(g[0], got[0][0])
            assert (g[1] is None) == (not energy)
            assert g[1] is None or torch.equal(g[1], got[0][1])
        dfe, u = got[0]
        # the port's previous composition: _embed_rows + scatter_rows +
        # fill_halo_scalar_serial
        f_emb, df = f_eval(rho)
        df = torch.where(lst.a_valid, df, torch.zeros((), dtype=tdt))
        old = nlmod.scatter_rows(lst, df, B, A)
        if halo is not None:
            old[geom.n_local:] = torch.index_select(old, 0, halo)
        assert torch.equal(dfe, old)
        if energy:
            u_old = 0.5 * phi.to(e_dtype) + f_emb.to(e_dtype)
            u_old = torch.where(lst.a_valid, u_old,
                                torch.zeros((), dtype=e_dtype))
            assert torch.equal(u, u_old)
        # comd_tpu's pass 2 on the same rows
        jdt = jnp.float64 if dtype == "float64" else jnp.float32
        j_list = jnl.NeighborList(
            a_list=jnp.asarray(lst.a_list.numpy()),
            a_valid=jnp.asarray(lst.a_valid.numpy()),
            nl=jnp.asarray(lst.nl.numpy()),
            last_r=jnp.asarray(lst.last_r.numpy()))
        j_rho = jnp.asarray(rho.numpy())
        j_f, j_df = jeam.make_f_eval(jsim.pot, jdt, "rows")(j_rho)
        j_dfe = jnl.scatter_rows(
            j_list, jnp.where(j_list.a_valid, j_df, 0.0).astype(jdt), B, A)
        if halo is not None:
            j_dfe = jbin.fill_halo_scalar_serial(jsim.geom, j_dfe)
        j_dfe = np.asarray(j_dfe)
        if dtype == "float64":
            np.testing.assert_allclose(dfe.numpy(), j_dfe, rtol=0,
                                       atol=1e-12 * np.abs(j_dfe).max())
        else:
            ulp = np.spacing(np.abs(j_dfe).astype(np.float32))
            assert (np.abs(dfe.numpy() - j_dfe) <= 2 * ulp).all()
        if halo is None:
            assert not dfe[geom.n_local:].any()
        if energy and dtype == "float64":
            j_u = 0.5 * jnp.asarray(phi.numpy()).astype(jnp.float64) + \
                j_f.astype(jnp.float64)
            j_u = np.asarray(jnp.where(j_list.a_valid, j_u, 0.0))
            np.testing.assert_allclose(u.numpy(), j_u, rtol=0,
                                       atol=1e-12 * np.abs(j_u).max())
            assert float(u.sum()) == pytest.approx(float(j_u.sum()),
                                                   rel=1e-12)


@pytest.mark.parametrize("kick", [True, False], ids=["kick", "nokick"])
@pytest.mark.parametrize("passes", [2, 1])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_land_rows_match_previous_composition(dtype, passes, kick):
    """LR's plain version (and the wrapper, plain on the CPU) against the
    port's previous composition, scatter_rows(f1 + f3) then ``land`` (or,
    without the kick, the zero field with the local rows copied in), bit
    for bit, from one and from two row segments (the split's Ri), planes
    strided as NL2 leaves them; the force field also equal to comd_tpu's
    scatter_rows of the same sum."""
    jsim, tsim, _kw = _pair(7)
    tdt = getattr(torch, dtype)
    lst = _list(tsim, True, tdt)
    geom = tsim.geom
    nl = geom.n_local
    s = tsim.state
    B, A = s.r.shape[1:]
    R = lst.a_list.shape[0]
    rng = np.random.default_rng(23)
    v = lst.a_valid.numpy()
    # [5, R] like an NL2 pass-1 output; the force its planes 0..2
    f1 = torch.as_tensor(np.where(v, rng.normal(size=(5, R)), 0.0),
                         dtype=tdt)[:3]
    f3 = torch.as_tensor(np.where(v, rng.normal(size=(3, R)), 0.0),
                         dtype=tdt)
    p0 = s.p.to(tdt)
    kick_c = float(np.asarray(0.5 * tsim.cfg.dt, dtype=dtype))
    rows = f1 + f3 if passes == 2 else f1
    # the previous composition
    f_old = torch.full((3, B, A), np.nan, dtype=tdt)
    p_old = p0.clone()
    n_old = torch.zeros((), dtype=torch.int32)
    dense = nlmod.scatter_rows(lst, rows, B, A)
    if kick:
        step_ops.land_plain(f_old, p_old, dense[:, :nl], None, s.n_atoms,
                            n_old, nl, kick_c)
    else:
        f_old = torch.zeros_like(f_old)
        f_old[:, :nl] = dense[:, :nl]
    j_list = jnl.NeighborList(
        a_list=jnp.asarray(lst.a_list.numpy()),
        a_valid=jnp.asarray(lst.a_valid.numpy()),
        nl=jnp.asarray(lst.nl.numpy()),
        last_r=jnp.asarray(lst.last_r.numpy()))
    j_rows = jnp.asarray(f1.numpy()) + (jnp.asarray(f3.numpy())
                                        if passes == 2 else 0.0)
    j_dense = np.array(jnl.scatter_rows(j_list, j_rows, B, A))
    j_dense[:, nl:] = 0.0
    cut = nlmod.row_split_for(geom, A)[1]
    for c in (None, cut):
        parts = (_segs(f1, c),) + ((_segs(f3, c),) if passes == 2 else ())
        for fn in (nlmod.land_rows_plain, step_ops.land_rows):
            f = torch.full((3, B, A), np.nan, dtype=tdt)
            p = p0.clone()
            n_out = torch.full((), 5, dtype=torch.int32)
            fn(f, p if kick else None, lst, s.n_atoms, parts,
               n_out if kick else None, nl, kick_c if kick else None)
            assert torch.equal(f, f_old)
            np.testing.assert_array_equal(f.numpy(), j_dense)
            if kick:
                assert torch.equal(p, p_old)
                assert int(n_out) == int(n_old) == int(
                    s.n_atoms[:nl].sum())
            else:
                assert torch.equal(p, p0) and int(n_out) == 5


def _step(jsim, tsim, blocks):
    for b in blocks:
        jsim.step_block(b)
        tsim.step_block(b)


@pytest.mark.parametrize("doeam", [True, False], ids=["eam_nl", "lj_L"])
def test_slice_serial_matches_comd_tpu(doeam):
    """10 steps of -m thread_atom_nl EAM or -L LJ from one state, through
    a rebuild (-S 0.05), the row ops on every step: ePot within 1e-9 at
    t = 0 and 1e-7 after, the kinetic energy within 1e-7, gids equal."""
    kw = dict(BASE, nx=6, ny=6, nz=6, dtype="float64", doeam=doeam,
              relative_skin_distance=0.05,
              **({"method": "thread_atom_nl"} if doeam
                 else {"use_pairlist": True}))
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    tsim.state = state_from_numpy(
        {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
    tsim.build_neighbor_list()
    tsim.compute_force()
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-9)
    _step(jsim, tsim, (5, 5))
    assert tsim.n_nl_build >= 2
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-7)
    assert tsim.kinetic_energy() == pytest.approx(jsim.kinetic_energy(),
                                                  abs=1e-7)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 864
    assert not tsim.overflow
    np.testing.assert_array_equal(tsim.state.gid.numpy(),
                                  np.asarray(jsim.state.gid))


def test_slice_mesh_matches_comd_tpu_collective():
    """A 2x2x2 -a 1 thread_atom_nl EAM mesh (the row split: two segments
    a sweep) against comd_tpu's sharded collective run, 8^3 f64, 10 steps
    through a rebuild (-S 0.05): the initial ePot within 1e-9, every
    shard's gid and n_atoms equal and r within 1e-10 at the end, ePot
    within 1e-7."""
    kw = dict(BASE, nx=8, ny=8, nz=8, dtype="float64", doeam=True,
              method="thread_atom_nl", initial_delta=0.1,
              relative_skin_distance=0.05, gpu_async=1,
              comm_impl="collective", xproc=2, yproc=2, zproc=2)
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    assert tsim.nl_row_split is not None
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-9)
    _step(jsim, tsim, (5, 5))
    assert tsim.n_nl_build >= 2
    js = {k: np.asarray(getattr(jsim.state, k))
          for k in ("r", "gid", "n_atoms")}
    ts = shards_to_numpy(tsim.states, (2, 2, 2))
    for k in ("gid", "n_atoms"):
        np.testing.assert_array_equal(ts[k], js[k])
    np.testing.assert_allclose(ts["r"], js["r"], rtol=0, atol=1e-10)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-7)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 2048
    assert not tsim.overflow
