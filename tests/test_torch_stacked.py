"""The one-card mesh's state held stacked, as comd_tpu holds it: every
per-shard field one [S, ...] tensor, each shard's SimState its views, and
each phase of the cell paths one launch over the stack.

  - The stacked entry points' plain versions (the CPU's: K1 passes 1 and 3,
    with and without the energy, over every cell and over the -a 1
    interior and boundary subsets; K1's LJ; K2's three passes; the head
    kick_drift_trigger with its or over the shards; pass 2 embed_fill;
    the landing with the summed atom count) equal a loop of the one-shard
    plain versions bit for bit, in f64 and f32, on the 2x2x2 mesh (S = 8,
    10^3 unit cells: one interior cell of 3^3 a shard) and on 3x1x1
    (S = 3, 18x6x6: 8 interior cells of 4^3 a shard).
  - A 2x2x2 f64 EAM mesh at 6^3 with -r 0.8 (atoms change shard), ten lazy
    steps with a rebucket, through stub graphs that warm both branches on
    clones of the buffers (``_scratch``): its state is views of one stack
    a field before, inside and after ``_scratch``, and it equals comd_tpu's
    sharded run on the 8 virtual CPU devices (gid and n_atoms bit for bit,
    r, p and f within 1e-9, ePot within 1e-9 eV).
  - The entry points refuse per-shard tensors that are not one stack.
"""
import os

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from comd_tpu_torch import Config, init_simulation, stepgraph
from comd_tpu_torch.interop import shards_from_numpy, shards_to_numpy
from comd_tpu_torch.ops import force_eam, force_lj
from comd_tpu_torch.ops.cuda import stencil as st
from comd_tpu_torch.ops.cuda import step
from comd_tpu_torch.potentials.lj import init_lj_pot
from comd_tpu_torch.sim import _SHARD_FIELDS, stack_of

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
FIELDS = ("r", "p", "f", "gid", "n_atoms")
MESHES = {"2x2x2": dict(nx=10, ny=10, nz=10, xproc=2, yproc=2, zproc=2),
          "3x1x1": dict(nx=18, ny=6, nz=6, xproc=3, yproc=1, zproc=1)}
_SIMS = {}


def _mesh(mesh: str, dtype: str):
    """An initialized EAM mesh (T = 600 K, 0.1 A displacements), cached."""
    key = (mesh, dtype)
    if key not in _SIMS:
        _SIMS[key] = init_simulation(Config(
            doeam=True, temperature=600.0, initial_delta=0.1, dtype=dtype,
            interp_impl="rows", pot_dir=POTS, device="cpu",
            **MESHES[mesh]))
    return _SIMS[key]


def _same(got, want, what):
    """``got`` (a stack's result) equals the shards' results ``want``."""
    if isinstance(got, torch.Tensor) or got is None:
        got, want = (got,), tuple((w,) for w in want)
    for k, g in enumerate(got):
        if g is None:
            assert all(w[k] is None for w in want), what
            continue
        assert g.shape[0] == len(want), what
        for s, w in enumerate(want):
            assert g.dtype == w[k].dtype and torch.equal(g[s], w[k]), \
                f"{what}: output {k}, shard {s}"


def _one_shard(fn, n, *stacks, **kw):
    """``fn`` (a one-shard plain version) on each shard of the stacks."""
    return [fn(*(None if x is None else x[s] for x in stacks), **kw)
            for s in range(n)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_stacked_plain_equals_shard_loop(mesh, dtype):
    sim = _mesh(mesh, dtype)
    S = len(sim.states)
    assert S == (8 if mesh == "2x2x2" else 3)
    maps, ev, nl = sim.maps, sim.pair_eval, sim.geom.n_local
    r = stack_of(s.r for s in sim.states)
    n_atoms = stack_of(s.n_atoms for s in sim.states)
    assert r.shape[0] == S and r.is_contiguous()
    assert maps.interior.n > 0 and maps.boundary.n > 0
    B = r.shape[2]
    dfe = (0.01 * r[:, 0]).contiguous()

    # K1 passes 1 and 3 and LJ, every cell and the -a 1 subsets
    for boxes in (None, maps.interior, maps.boundary):
        for e in (True, False):
            _same(st.eam_pass1(r, maps.nbr_map, ev, want_energy=e,
                               boxes=boxes),
                  _one_shard(st.eam_pass1_plain, S, r, nbr_map=maps.nbr_map,
                             ev=ev, want_energy=e, boxes=boxes),
                  f"K1 pass 1 energy={e} boxes={boxes and boxes.n}")
        _same(st.eam_pass3(r, maps.nbr_map, ev, dfe, boxes=boxes),
              [st.eam_pass3_plain(r[s], maps.nbr_map, ev, dfe[s],
                                  boxes=boxes) for s in range(S)],
              f"K1 pass 3 boxes={boxes and boxes.n}")
    lj_ev = force_lj.make_lj_evaluator(init_lj_pot(2.5), r.dtype)
    for e in (True, False):
        _same(st.lj_pass(r, maps.nbr_map, lj_ev, want_energy=e,
                         boxes=maps.interior),
              _one_shard(st.lj_pass_plain, S, r, nbr_map=maps.nbr_map,
                         ev=lj_ev, want_energy=e, boxes=maps.interior),
              f"K1 LJ energy={e}")
    # K2
    _same(st.eam_pass1_half(r, maps.half_nbr_map, ev),
          _one_shard(st.eam_pass1_half_plain, S, r,
                     half_nbr_map=maps.half_nbr_map, ev=ev), "K2 pass 1")
    _same(st.eam_pass3_half(r, maps.half_nbr_map, ev, dfe),
          [st.eam_pass3_half_plain(r[s], maps.half_nbr_map, ev, dfe[s])
           for s in range(S)], "K2 pass 3")
    _same(st.lj_pass_half(r, maps.half_nbr_map, lj_ev),
          _one_shard(st.lj_pass_half_plain, S, r,
                     half_nbr_map=maps.half_nbr_map, ev=lj_ev), "K2 LJ")

    # the head: one shard displaced past skin/2, so the or fires
    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    p, f = (stack_of(getattr(s, k) for s in sim.states) for k in "pf")
    last = r.clone()
    for moved in (None, S - 1):
        if moved is not None:
            last[moved, 0, nl // 2, 0] += 2.0 * sim.skin
        p1, r1, p2, r2 = p.clone(), r.clone(), p.clone(), r.clone()
        flag = step.kick_drift_trigger(p1, r1, f, last, nl, kick, drift,
                                       sim.skin)
        flags = [step.kick_drift_trigger_plain(p2[s], r2[s], f[s], last[s],
                                               nl, kick, drift, sim.skin)
                 for s in range(S)]
        assert torch.equal(p1, p2) and torch.equal(r1, r2)
        assert bool(flag) == any(bool(x) for x in flags) == \
            (moved is not None)

    # pass 2 on K1's rhobar (a view of its output: the shards apart)
    _f1, phi, rho = st.eam_pass1(r, maps.nbr_map, ev)
    e_dtype = sim.cfg.torch_energy_dtype
    for energy in (True, False):
        for src in (None, maps.halo_src):
            ph = phi if energy else None
            _same(step.embed_fill(sim.f_eval, rho, ph, n_atoms, B, src,
                                  e_dtype),
                  [step.embed_fill_plain(sim.f_eval, rho[s],
                                         None if ph is None else ph[s],
                                         n_atoms[s], B, src, e_dtype)
                   for s in range(S)],
                  f"embed_fill energy={energy} serial={src is not None}")

    # the landing of two passes: the count summed over the shards
    f1, f3 = _f1, st.eam_pass3(r, maps.nbr_map, ev, dfe)
    for two in (True, False):
        fa, pa, fb, pb = f.clone(), p.clone(), f.clone(), p.clone()
        n_a = torch.zeros((), dtype=torch.int32)
        n_b = torch.zeros((), dtype=torch.int32)
        step.land(fa, pa, f1, f3 if two else None, n_atoms, n_a, nl, kick)
        count = 0
        for s in range(S):
            step.land_plain(fb[s], pb[s], f1[s], f3[s] if two else None,
                            n_atoms[s], n_b, nl, kick)
            count += int(n_b)
        assert torch.equal(fa, fb) and torch.equal(pa, pb)
        assert int(n_a) == count == sim.n_global


def _stub_steps(sim):
    """Stub graphs whose replay calls the step again; each capture first
    warms both branches on clones of the buffers (``_scratch``)."""
    return stepgraph.GraphSteps(
        "cpu", capture=lambda fn, pool: (_Replay(fn), 0.0, 0.0),
        scratch=sim._scratch)


class _Replay:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _views_of_stacks(sim) -> bool:
    """Every shard's fields are the [i] views of the buffers' stacks."""
    b = sim._bufs
    ok = all(b[f].shape[0] == len(sim.states) and b[f].is_contiguous()
             for f in _SHARD_FIELDS + ("last_r",))
    for i, s in enumerate(sim.states):
        for f in _SHARD_FIELDS:
            ok = ok and getattr(s, f).data_ptr() == b[f][i].data_ptr()
        ok = ok and sim.last_r[i].data_ptr() == b["last_r"][i].data_ptr()
    return ok


def test_mesh_state_stacked_matches_comd_tpu():
    kw = dict(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
              initial_delta=0.8, dtype="float64", pot_dir=POTS,
              xproc=2, yproc=2, zproc=2)
    jsim = j_init(JConfig(**kw))
    keys = FIELDS + ("e_potential", "n_local", "overflow")
    start = {k: np.asarray(getattr(jsim.state, k)) for k in keys}
    tsim = init_simulation(Config(device="cpu", comm_impl="collective",
                                  **kw))
    tsim.states = shards_from_numpy(start, "cpu")
    tsim.step_block(0)                   # binds the buffers
    assert _views_of_stacks(tsim)
    r_buf = tsim._bufs["r"].data_ptr()
    with tsim._scratch():                # a capture's warm-up: clones
        assert _views_of_stacks(tsim)
        assert tsim._bufs["r"].data_ptr() != r_buf
    assert _views_of_stacks(tsim) and tsim._bufs["r"].data_ptr() == r_buf
    tsim._graphs = _stub_steps(tsim)     # each capture warms on clones
    for _ in range(2):
        jsim.step_block(5)
        tsim.step_block(5)
    assert tsim._graphs.captures == 2
    assert tsim._bufs["r"].data_ptr() == r_buf and _views_of_stacks(tsim)
    assert tsim.n_rebucket >= 1
    ts = shards_to_numpy(tsim.states, (2, 2, 2))
    js = {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}
    np.testing.assert_array_equal(ts["gid"], js["gid"])
    np.testing.assert_array_equal(ts["n_atoms"], js["n_atoms"])
    for k in ("r", "p", "f"):
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-9)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, abs=1e-9)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 864


def test_entry_points_refuse_shards_not_one_stack():
    sim = _mesh("3x1x1", "float64")
    maps, ev, nl = sim.maps, sim.pair_eval, sim.geom.n_local
    apart = [s.r.clone() for s in sim.states]          # three allocations
    counts = [s.n_atoms.clone() for s in sim.states]
    with pytest.raises(ValueError):
        stack_of(apart)
    with pytest.raises(ValueError):
        st.eam_pass1(apart, maps.nbr_map, ev)
    with pytest.raises(ValueError):
        force_eam.eam_force(maps.nbr_map, apart, ev, sim.f_eval, sim._fill,
                            n_atoms=counts)
    with pytest.raises(ValueError):
        force_lj.lj_force(maps.nbr_map, init_lj_pot(2.5), apart,
                          force_lj.make_lj_evaluator(init_lj_pot(2.5),
                                                     torch.float64))
    with pytest.raises(ValueError):
        step.kick_drift_trigger(apart, apart, apart, None, nl, 0.5, 0.1)
    with pytest.raises(ValueError):
        step.embed_fill(sim.f_eval, [x[0, :nl] for x in apart], None,
                        counts, apart[0].shape[1])
    with pytest.raises(ValueError):
        step.land(apart, apart, [x[:, :nl] for x in apart], None, counts,
                  torch.zeros((), dtype=torch.int32), nl, 0.5)
    # views of one stack are one stack: the shards' own views
    r = stack_of(s.r for s in sim.states)
    assert r.shape == (3,) + tuple(sim.states[0].r.shape)
    assert r.data_ptr() == sim.states[0].r.data_ptr()
