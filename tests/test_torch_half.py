"""The half-shell kernel's plain version (K2) against comd_tpu's half sweeps.

Inputs: one comd_tpu state at 6^3 (EAM: commensurate A = 16 on a 4^3 grid;
LJ: A = 32 on a 3^3 grid), T = 600 K with reference-RNG displacements, and a
numpy-seeded halo-filled dfEmbed field, handed to both packages.

- f32: the port's half sweep plus fold against comd_tpu's Pallas K2
  (``stencil_sweep_half``, interpret mode) plus its fold: forces atol
  1e-4 eV/A, phi, rhobar and pair energy rtol 1e-5.  The two half sets
  differ (the port's is ``nbr_map[:, 13:]``, comd_tpu's the positive dense
  offsets), so only folded results are comparable, up to reassociation.
- f64: against comd_tpu's XLA ``cell_pair_sweep_half`` with the ``rows``
  evaluators, rtol 1e-12 (forces also atol 1e-12 * max|f|: a sum of pair
  forces can cancel to ~0).
- Half against full inside the port (f64): ePot to 1e-9, forces to
  1e-12 * max|f|, and sum f = 0 (each pair delivered with both signs).
- The goldens with ``--halfShell`` through the plain versions, and 20-step
  f64 lazy trajectories with a rebucket inside, against comd_tpu.
- The serial fold through the step's dispatch (``fold_halo``'s plain
  version, in place) against the clone + ``index_add_`` it replaced: a
  10-step f32 --halfShell run, EAM and LJ, ends with the same bits.

The CUDA kernel itself is compared with this plain version on the card by
tests/test_torch_kernel_cuda.py.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import binning as jbin
from comd_tpu.ops import force_eam as jforce
from comd_tpu.ops import force_lj as jlj
from comd_tpu.ops.pallas.stencil import (eam_pass1_stencil, eam_pass3_stencil,
                                         lj_force_stencil_half)
from comd_tpu.ops.sweep import cell_pair_sweep_half as j_half
from comd_tpu.ops.sweep import fold_halo_serial as j_fold

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import (FIELDS, lj_potential_from_fields,
                                    state_from_numpy)
from comd_tpu_torch.ops.binning import SELF_COLUMN, geom_maps
from comd_tpu_torch.ops import force_lj as tlj
from comd_tpu_torch.ops.force_eam import make_pair_evaluator
from comd_tpu_torch.ops.cuda import stencil as st
from comd_tpu_torch.ops.sweep import fold_halo_serial
from comd_tpu_torch.potentials import eam as team

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
GOLDEN_LJ = -1.243619295058
GOLDEN_EAM_ADAMS = -3.538079224691


def _jstate(doeam, dtype, interp="auto"):
    return j_init(JConfig(nx=6, ny=6, nz=6, doeam=doeam, temperature=600.0,
                          initial_delta=0.1, dtype=dtype, interp_impl=interp,
                          pot_dir=POTS, n_steps=0))


def _dfe(sim, r):
    dfe = np.random.default_rng(7).uniform(
        -100.0, -90.0, size=r.shape[1:]).astype(r.dtype)
    return np.array(jbin.fill_halo_scalar_serial(sim.geom, jnp.asarray(dfe)))


def _eam_setup(dtype, interp):
    sim = _jstate(True, dtype, interp)
    r = np.array(sim.state.r)
    pot = team.read_funcfl(os.path.join(POTS, "Cu_u6.eam"))
    tdt = torch.from_numpy(r).dtype
    ev = make_pair_evaluator(pot, tdt, "cpu",
                             "cheb" if interp == "cheb" else "rows")
    return sim, r, _dfe(sim, r), ev, geom_maps(sim.geom, tdt, "cpu")


def _lj_setup(dtype):
    sim = _jstate(False, dtype)
    r = np.array(sim.state.r)
    pot = lj_potential_from_fields(dataclasses.asdict(sim.pot))
    tdt = torch.from_numpy(r).dtype
    return sim, r, pot, tlj.make_lj_evaluator(pot, tdt), \
        geom_maps(sim.geom, tdt, "cpu")


def _port_eam_half(sim, maps, r, dfe, ev):
    """The port's folded half passes on the plain path."""
    rt, dt = torch.from_numpy(r), torch.from_numpy(dfe)
    fold = lambda x: fold_halo_serial(sim.geom, maps, x)  # noqa: E731
    f1, phi, rho = st.eam_pass1_half(rt, maps.half_nbr_map, ev)
    f3 = st.eam_pass3_half(rt, maps.half_nbr_map, ev, dt)
    return [fold(x).numpy() for x in (f1, phi, rho, f3)]


def _close(ft, fj, atol, rtol):
    np.testing.assert_allclose(ft, fj, rtol=rtol,
                               atol=atol + rtol * np.abs(fj).max())


def _one(res):
    """One shard's results from the force of a stack of one."""
    return tuple(None if x is None else x[0] for x in res)


@pytest.fixture(scope="module")
def eam32():
    sim, r, dfe, ev, maps = _eam_setup("float32", "cheb")
    assert r.shape[-1] == 16 and sim.geom.grid == (4, 4, 4)
    rj = jnp.asarray(r)
    fold = lambda x: j_fold(sim.geom, x)  # noqa: E731
    f1, phi, rho = eam_pass1_stencil(sim.geom, sim.pot, rj, chunk=128,
                                     interpret=True, half=True)
    f3 = eam_pass3_stencil(sim.geom, sim.pot, rj, jnp.asarray(dfe),
                           chunk=128, interpret=True, half=True)
    jax_out = [np.asarray(fold(x)) for x in (f1, phi, rho, f3)]
    return sim, r, dfe, ev, maps, jax_out


@pytest.fixture(scope="module")
def eam64():
    sim, r, dfe, ev, maps = _eam_setup("float64", "rows")
    ephi, erho = jforce.make_evaluators(sim.pot, jnp.float64, False, "rows")
    rcut2 = sim.pot.cutoff ** 2
    rj = jnp.asarray(r)
    fold = lambda x: j_fold(sim.geom, x)  # noqa: E731
    f1, (phi, rho) = j_half(sim.geom, rj, jforce.make_pair1(ephi, erho),
                            rcut2, chunk=32)
    f3, _ = j_half(sim.geom, rj, jforce.make_pair3(erho), rcut2,
                   scalar_j=[jnp.asarray(dfe)], chunk=32)
    jax_out = [np.asarray(fold(x)) for x in (f1, phi, rho, f3)]
    return sim, r, dfe, ev, maps, jax_out


def test_half_map_is_self_then_one_of_each_pair():
    sim, _r, _dfe, _ev, maps = _eam_setup("float64", "rows")
    full = maps.nbr_map.numpy()
    half = maps.half_nbr_map.numpy()
    assert half.shape == (sim.geom.n_local, 14)
    np.testing.assert_array_equal(half[:, 0], np.arange(sim.geom.n_local))
    np.testing.assert_array_equal(half, full[:, SELF_COLUMN:])
    # column k of the full map holds offset o(k), column 26 - k offset -o(k)
    offs = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                indexing="ij"), axis=-1).reshape(27, 3)
    np.testing.assert_array_equal(offs[::-1], -offs)
    assert {tuple(o) for o in offs[SELF_COLUMN + 1:]} | \
        {tuple(-o) for o in offs[SELF_COLUMN + 1:]} == \
        {tuple(o) for o in offs if o.any()}


@pytest.mark.parametrize("out", ["f1", "phi", "rho", "f3"])
def test_half_plain_matches_pallas_half_f32(eam32, out):
    sim, r, dfe, ev, maps, jax_out = eam32
    k = ["f1", "phi", "rho", "f3"].index(out)
    got = _port_eam_half(sim, maps, r, dfe, ev)[k]
    if out in ("f1", "f3"):
        _close(got, jax_out[k], 1e-4, 0.0)
        assert np.abs(jax_out[k]).max() > 0.1
    else:
        np.testing.assert_allclose(got, jax_out[k], rtol=1e-5, atol=0)


def test_half_no_energy_variant_f32(eam32):
    sim, r, _dfe, ev, maps, (f1, _phi, rho, _f3) = eam32
    rt = torch.from_numpy(r)
    fd, phi, rd = st.eam_pass1_half(rt, maps.half_nbr_map, ev,
                                    want_energy=False)
    assert phi is None
    _close(fold_halo_serial(sim.geom, maps, fd).numpy(), f1, 1e-4, 0.0)
    np.testing.assert_allclose(fold_halo_serial(sim.geom, maps, rd).numpy(),
                               rho, rtol=1e-5, atol=0)


@pytest.mark.parametrize("out", ["f1", "phi", "rho", "f3"])
def test_half_plain_matches_xla_half_f64(eam64, out):
    sim, r, dfe, ev, maps, jax_out = eam64
    k = ["f1", "phi", "rho", "f3"].index(out)
    got = _port_eam_half(sim, maps, r, dfe, ev)[k]
    _close(got, jax_out[k], 0.0, 1e-12)


def test_lj_half_matches_pallas_half_f32():
    sim, r, pot, ev, maps = _lj_setup("float32")
    assert r.shape[-1] == 32 and sim.geom.grid == (3, 3, 3)
    fj, uj, ej = lj_force_stencil_half(
        sim.geom, sim.pot, jnp.asarray(r), lambda x: j_fold(sim.geom, x),
        chunk=128, interpret=True)
    ft, ut, et = _one(tlj.lj_force_half(
        maps.half_nbr_map, pot, torch.from_numpy(r)[None], ev,
        lambda xs: torch.stack([fold_halo_serial(sim.geom, maps, x)
                                for x in xs])))
    _close(ft.numpy(), np.asarray(fj), 1e-4, 0.0)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(uj)).max())
    assert float(et) == pytest.approx(float(ej), rel=1e-6)


def test_lj_half_matches_xla_half_f64():
    sim, r, pot, ev, maps = _lj_setup("float64")
    fj, uj, ej = jlj.lj_force_half(sim.geom, sim.pot, jnp.asarray(r),
                                   lambda x: j_fold(sim.geom, x), chunk=32)
    ft, ut, et = _one(tlj.lj_force_half(
        maps.half_nbr_map, pot, torch.from_numpy(r)[None], ev,
        lambda xs: torch.stack([fold_halo_serial(sim.geom, maps, x)
                                for x in xs])))
    _close(ft.numpy(), np.asarray(fj), 0.0, 1e-12)
    _close(ut.numpy(), np.asarray(uj), 0.0, 1e-12)
    assert float(et) == pytest.approx(float(ej), rel=1e-12)


@pytest.mark.parametrize("doeam", [True, False])
def test_half_matches_full_in_port_f64(doeam):
    kw = dict(nx=6, ny=6, nz=6, doeam=doeam, temperature=600.0,
              initial_delta=0.1, dtype="float64", pot_dir=POTS, device="cpu")
    full = init_simulation(Config(**kw))
    half = init_simulation(Config(half_shell=True, **kw))
    assert half.e_potential == pytest.approx(full.e_potential, abs=1e-9)
    ff, fh = full.state.f.numpy(), half.state.f.numpy()
    np.testing.assert_allclose(fh, ff, rtol=0, atol=1e-12 * np.abs(ff).max())
    n_local = half.geom.n_local
    total = fh[:, :n_local].sum(axis=(1, 2))
    assert np.abs(total).max() < 1e-12 * np.abs(ff).max() * half.n_global


@pytest.mark.parametrize("doeam,golden", [(False, GOLDEN_LJ),
                                          (True, GOLDEN_EAM_ADAMS)])
def test_goldens_half_shell(doeam, golden):
    sim = init_simulation(Config(
        nx=6, ny=6, nz=6, doeam=doeam, half_shell=True, temperature=0.0,
        dtype="float64", pot_dir=POTS, device="cpu"))
    assert sim.sum_atoms() == sim.n_global == 864
    assert sim.e_potential / sim.n_global == pytest.approx(golden, abs=1e-9)


# LJ's cells have more slack than EAM's, so its runs are hotter, start
# displaced and take longer steps to reach the rebucket trigger in 20 steps
@pytest.mark.parametrize("doeam,half,temp,dt,delta", [
    (True, True, 1200.0, 1.0, 0.0), (False, True, 3000.0, 2.0, 0.3),
    (False, False, 3000.0, 2.0, 0.3)])
def test_f64_trajectory_matches_comd_tpu(doeam, half, temp, dt, delta):
    kw = dict(nx=6, ny=6, nz=6, doeam=doeam, temperature=temp, dt=dt,
              initial_delta=delta, dtype="float64", interp_impl="rows",
              half_shell=half, pot_dir=POTS)
    jsim = j_init(JConfig(**kw))
    tsim = init_simulation(Config(device="cpu", **kw))
    assert tsim.cfg.max_atoms == jsim.cfg.max_atoms
    tsim.state = state_from_numpy(
        {k: np.asarray(getattr(jsim.state, k)) for k in FIELDS}, "cpu")
    jsim.step_block(20)
    tsim.step_block(20)
    assert tsim.uses_lazy and tsim.n_rebucket >= 1
    js, ts = jsim.state, tsim.state
    np.testing.assert_array_equal(ts.gid.numpy(), np.asarray(js.gid))
    np.testing.assert_array_equal(ts.n_atoms.numpy(), np.asarray(js.n_atoms))
    for k in ("r", "p"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=0,
                                   atol=1e-8)
    assert tsim.e_potential == pytest.approx(jsim.e_potential, rel=1e-10)
    assert tsim.sum_atoms() == jsim.sum_atoms() == 864


def test_half_wrappers_run_plain_on_cpu_without_launching(eam32):
    sim, r, dfe, ev, maps, _ = eam32
    rt, dt = torch.from_numpy(r), torch.from_numpy(dfe)
    hm = maps.half_nbr_map
    st.reset_launch_counts()
    got1 = st.eam_pass1_half(rt, hm, ev)
    got3 = st.eam_pass3_half(rt, hm, ev, dt)
    assert all(v == 0 for v in st.LAUNCHES.values())
    for a, b in zip(got1, st.eam_pass1_half_plain(rt, hm, ev)):
        assert torch.equal(a, b)
    assert torch.equal(got3, st.eam_pass3_half_plain(rt, hm, ev, dt))


def test_half_wrappers_never_fall_back_off_cpu(eam32):
    """A tensor that is not on the CPU takes the kernel path or raises."""
    sim, r, dfe, ev, maps, _ = eam32
    rm = torch.empty(r.shape, dtype=torch.float32, device="meta")
    hm = torch.empty(maps.half_nbr_map.shape, dtype=torch.int32,
                     device="meta")
    dm = torch.empty(dfe.shape, dtype=torch.float32, device="meta")
    st.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        st.eam_pass1_half(rm, hm, ev)
    with pytest.raises(ValueError, match="CUDA tensors"):
        st.eam_pass3_half(rm, hm, ev, dm)
    assert all(v == 0 for v in st.LAUNCHES.values())


def test_half_wrappers_check_the_map(eam32):
    sim, r, _dfe, ev, maps, _ = eam32
    with pytest.raises(ValueError, match="14"):
        st.eam_pass1_half(torch.from_numpy(r), maps.nbr_map, ev)


@pytest.mark.parametrize("doeam", [True, False], ids=["eam", "lj"])
def test_serial_fold_through_the_dispatch_equals_index_add(doeam,
                                                           monkeypatch):
    """A serial --halfShell run (f32, 10 steps) whose folds go through the
    dispatch (one fold_halo call a fold, in place; its plain version here)
    ends with the bits of the same run on the clone + index_add_ the fold
    replaced: r, p and ePot."""
    from comd_tpu_torch import sim as tsim
    from comd_tpu_torch.ops.cuda import comm as cm
    cfg = Config(nx=6, ny=6, nz=6, doeam=doeam, temperature=600.0,
                 initial_delta=0.2, half_shell=True, dtype="float32",
                 pot_dir=POTS, device="cpu")
    calls = []
    orig = cm.fold_halo_plain

    def counted(plan, x):
        calls.append(plan.n_entries)
        return orig(plan, x)

    def index_add(geom, maps, x):
        nl = geom.n_local
        return x[..., :nl, :].clone().index_add_(x.dim() - 2, maps.halo_src,
                                                 x[..., nl:, :])

    runs = []
    for old in (False, True):
        with monkeypatch.context() as m:
            m.setattr(cm, "fold_halo_plain", counted)
            if old:
                m.setattr(tsim, "fold_halo_serial", index_add)
            sim = init_simulation(cfg)
            calls.clear()
            sim.step_block(10)
            runs.append((sim, len(calls)))
    (new, n_new), (ref, n_ref) = runs
    assert n_new >= 10 * (2 if doeam else 1) and n_ref == 0
    assert new.e_potential == ref.e_potential
    for f in ("r", "p"):
        assert torch.equal(getattr(new.state, f), getattr(ref.state, f))
