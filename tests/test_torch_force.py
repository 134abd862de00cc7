"""The port's whole EAM force against comd_tpu, and the EAM goldens.

f32: ``eam_force`` (passes 1 and 3 on the stencil's plain version, the
Chebyshev evaluator) against comd_tpu's ``eam_force_pallas`` in interpret
mode -- forces atol 1e-4 eV/A, energies and dfEmbed rtol 1e-5 (sweep order
and comd_tpu's two-level pass-2 lookup differ at the ulp level).
f64: the exact table evaluator against comd_tpu's ``eam_force`` with
``interp_impl="rows"`` -- rtol 1e-12.  The goldens (reference CoMD
cohesive energies, T = 0, 6^3, f64) hold within 1e-9.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import binning as jbin
from comd_tpu.ops import force_eam as jforce

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.ops import binning as tbin
from comd_tpu_torch.ops import force_eam as tforce
from comd_tpu_torch.potentials import eam as team

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
GOLDEN_EAM_ADAMS = -3.538079224691
GOLDEN_EAM_MISHIN = -3.539999969176


def _jfill(geom):
    return lambda x, rhobar_l=None: jbin.fill_halo_scalar_serial(geom, x)


def _port_force(sim, r, n_atoms, impl, want_energy=True):
    pot = team.read_funcfl(os.path.join(POTS, "Cu_u6.eam"))
    rt = torch.from_numpy(r)
    maps = tbin.geom_maps(sim.geom, rt.dtype, "cpu")
    ev = tforce.make_pair_evaluator(pot, rt.dtype, "cpu", impl)
    f_eval = tforce.make_f_eval(pot, rt.dtype, "cpu")
    f, u, dfe = tforce.eam_force(
        maps.nbr_map, rt[None], ev, f_eval,
        lambda xs, _rhobar: torch.stack([
            tbin.fill_halo_scalar_serial(sim.geom, maps, x) for x in xs]),
        n_atoms=torch.from_numpy(n_atoms)[None], want_energy=want_energy)
    return f[0], None if u is None else u[0], dfe[0]


def _ref_state(dtype, interp):
    sim = j_init(JConfig(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
                         initial_delta=0.1, dtype=dtype, interp_impl=interp,
                         pot_dir=POTS, n_steps=0))
    return sim, np.array(sim.state.r), np.array(sim.state.n_atoms)


def _valid(sim, n_atoms, A):
    return (np.arange(A)[None, :] < n_atoms[:sim.geom.n_local, None])


@pytest.fixture(scope="module")
def f32_pallas():
    sim, r, n_atoms = _ref_state("float32", "cheb")
    out = jforce.eam_force_pallas(sim.geom, sim.pot, jnp.asarray(r),
                                  _jfill(sim.geom), chunk=128,
                                  interpret=True)
    return sim, r, n_atoms, [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def f64_rows():
    sim, r, n_atoms = _ref_state("float64", "rows")
    out = jforce.eam_force(sim.geom, sim.pot, jnp.asarray(r),
                           _jfill(sim.geom), chunk=32, interp_impl="rows",
                           sweep_impl="gather")
    return sim, r, n_atoms, [np.asarray(x) for x in out]


def test_eam_force_matches_pallas_f32(f32_pallas):
    sim, r, n_atoms, (fj, uj, dj) = f32_pallas
    ft, ut, dt = _port_force(sim, r, n_atoms, "cheb")
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=0)
    # the port masks U's empty slots in pass 2: comd_tpu's masked U
    valid = _valid(sim, n_atoms, r.shape[-1])
    u_j, e_j = jforce.finalize_eam_energy(jnp.asarray(uj), jnp.asarray(valid))
    np.testing.assert_allclose(ut.numpy(), np.asarray(u_j), rtol=1e-5,
                               atol=0)
    assert float(ut.sum()) == pytest.approx(float(e_j), rel=1e-6)


def test_eam_force_dynamics_only_variant_f32(f32_pallas):
    sim, r, n_atoms, (fj, _uj, _dj) = f32_pallas
    ft, ut, _dt = _port_force(sim, r, n_atoms, "cheb", want_energy=False)
    assert ut is None
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=1e-4)


def test_eam_force_matches_rows_f64(f64_rows):
    sim, r, n_atoms, (fj, uj, dj) = f64_rows
    ft, ut, dt = _port_force(sim, r, n_atoms, "rows")
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-12,
                               atol=1e-12 * np.abs(fj).max())
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-12, atol=0)
    valid = _valid(sim, n_atoms, r.shape[-1])
    u_j, e_j = jforce.finalize_eam_energy(jnp.asarray(uj), jnp.asarray(valid))
    np.testing.assert_allclose(ut.numpy(), np.asarray(u_j), rtol=1e-12,
                               atol=0)
    assert float(ut.sum()) == pytest.approx(float(e_j), rel=1e-12)


@pytest.mark.parametrize("pot_type,golden,hilbert", [
    ("funcfl", GOLDEN_EAM_ADAMS, False),
    ("setfl", GOLDEN_EAM_MISHIN, False),
    ("funcfl", GOLDEN_EAM_ADAMS, True)])
def test_eam_goldens(pot_type, golden, hilbert):
    sim = init_simulation(Config(
        nx=6, ny=6, nz=6, doeam=True, pot_type=pot_type, temperature=0.0,
        dtype="float64", do_hilbert=hilbert, pot_dir=POTS, device="cpu"))
    assert sim.sum_atoms() == sim.n_global == 864
    assert sim.geom.use_hilbert == hilbert
    assert sim.e_potential / sim.n_global == pytest.approx(golden, abs=1e-9)
