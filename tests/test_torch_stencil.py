"""The cell-stencil kernel's plain version against comd_tpu's kernels.

comd_tpu runs its Pallas stencil kernel (EAM pass 1 and pass 3, f32, the
fused Chebyshev evaluator) in interpret mode on the CPU, once per pass for
this module; the port's plain PyTorch version must agree to fp
reassociation (forces atol 1e-4 eV/A, phi-sum/rhobar rtol 1e-5: the
27-neighbor order differs).  At f64 the exact table evaluator is held
against comd_tpu's ``rows`` gather sweep to rtol 1e-12 (forces also atol
1e-12 * max|f|, since a sum of pair forces can cancel to ~0).

The CUDA kernel itself is compared with this plain version on the card by
tests/test_torch_kernel_cuda.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import binning as jbin
from comd_tpu.ops import force_eam as jforce
from comd_tpu.ops.pallas.stencil import eam_pass1_stencil, eam_pass3_stencil
from comd_tpu.ops.sweep import cell_pair_sweep as j_sweep

from comd_tpu_torch.ops.binning import geom_maps
from comd_tpu_torch.ops.force_eam import make_pair_evaluator
from comd_tpu_torch.ops.cuda import stencil as st
from comd_tpu_torch.potentials import eam as team

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")


def _setup(dtype, interp):
    """comd_tpu state at 6^3 (commensurate A = 16 on a 4^3 grid) with
    reference-RNG displacements, a numpy-seeded halo-filled dfEmbed field,
    and the port's evaluator on CPU tensors."""
    sim = j_init(JConfig(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
                         initial_delta=0.1, dtype=dtype, interp_impl=interp,
                         pot_dir=POTS, n_steps=0))
    r = np.array(sim.state.r)
    dfe = np.random.default_rng(7).uniform(
        -100.0, -90.0, size=r.shape[1:]).astype(r.dtype)
    dfe = np.array(jbin.fill_halo_scalar_serial(sim.geom, jnp.asarray(dfe)))
    pot = team.read_funcfl(os.path.join(POTS, "Cu_u6.eam"))
    tdt = torch.from_numpy(r).dtype
    ev = make_pair_evaluator(pot, tdt, "cpu",
                             "cheb" if interp == "cheb" else "rows")
    nbr = geom_maps(sim.geom, tdt, "cpu").nbr_map
    return sim, r, dfe, ev, nbr


@pytest.fixture(scope="module")
def f32():
    sim, r, dfe, ev, nbr = _setup("float32", "cheb")
    assert r.shape[-1] == 16 and sim.geom.grid == (4, 4, 4)
    rj = jnp.asarray(r)
    f1, phi, rho = eam_pass1_stencil(sim.geom, sim.pot, rj, chunk=128,
                                     interpret=True)
    f3 = eam_pass3_stencil(sim.geom, sim.pot, rj, jnp.asarray(dfe),
                           chunk=128, interpret=True)
    jax_out = [np.asarray(x) for x in (f1, phi, rho, f3)]
    return sim, r, dfe, ev, nbr, jax_out


@pytest.fixture(scope="module")
def f64():
    sim, r, dfe, ev, nbr = _setup("float64", "rows")
    ephi, erho = jforce.make_evaluators(sim.pot, jnp.float64, False, "rows")
    rcut2 = sim.pot.cutoff ** 2
    rj = jnp.asarray(r)
    f1, (phi, rho) = j_sweep(sim.geom, rj, jforce.make_pair1(ephi, erho),
                             rcut2, chunk=32)
    f3, _ = j_sweep(sim.geom, rj, jforce.make_pair3(erho), rcut2,
                    scalar_j=[jnp.asarray(dfe)], chunk=32)
    jax_out = [np.asarray(x) for x in (f1, phi, rho, f3)]
    return sim, r, dfe, ev, nbr, jax_out


def _assert_close_forces(ft, fj, atol, rtol):
    np.testing.assert_allclose(ft, fj, rtol=rtol,
                               atol=atol + rtol * np.abs(fj).max())


def test_pass1_plain_matches_pallas_f32(f32):
    sim, r, _dfe, ev, nbr, (f1, phi, rho, _f3) = f32
    ft, pt, rt = st.eam_pass1_plain(torch.from_numpy(r), nbr, ev)
    _assert_close_forces(ft.numpy(), f1, 1e-4, 0.0)
    np.testing.assert_allclose(pt.numpy(), phi, rtol=1e-5, atol=0)
    np.testing.assert_allclose(rt.numpy(), rho, rtol=1e-5, atol=0)
    assert np.abs(f1).max() > 0.1          # a real, non-lattice force field


def test_pass3_plain_matches_pallas_f32(f32):
    sim, r, dfe, ev, nbr, (_f1, _phi, _rho, f3) = f32
    ft = st.eam_pass3_plain(torch.from_numpy(r), nbr, ev,
                            torch.from_numpy(dfe))
    _assert_close_forces(ft.numpy(), f3, 1e-4, 0.0)
    assert np.abs(f3).max() > 0.1


def test_pass1_no_energy_variant_f32(f32):
    """want_energy=False skips the phi chain, as the Pallas pass does."""
    sim, r, _dfe, ev, nbr, (f1, _phi, rho, _f3) = f32
    ft, pt, rt = st.eam_pass1_plain(torch.from_numpy(r), nbr, ev,
                                    want_energy=False)
    assert pt is None
    _assert_close_forces(ft.numpy(), f1, 1e-4, 0.0)
    np.testing.assert_allclose(rt.numpy(), rho, rtol=1e-5, atol=0)


def test_pass1_table_matches_rows_f64(f64):
    sim, r, _dfe, ev, nbr, (f1, phi, rho, _f3) = f64
    ft, pt, rt = st.eam_pass1_plain(torch.from_numpy(r), nbr, ev)
    _assert_close_forces(ft.numpy(), f1, 0.0, 1e-12)
    np.testing.assert_allclose(pt.numpy(), phi, rtol=1e-12, atol=0)
    np.testing.assert_allclose(rt.numpy(), rho, rtol=1e-12, atol=0)


def test_pass3_table_matches_rows_f64(f64):
    sim, r, dfe, ev, nbr, (_f1, _phi, _rho, f3) = f64
    ft = st.eam_pass3_plain(torch.from_numpy(r), nbr, ev,
                            torch.from_numpy(dfe))
    _assert_close_forces(ft.numpy(), f3, 0.0, 1e-12)


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_plain_independent_of_box_chunk(f64, chunk):
    sim, r, dfe, ev, nbr, _ = f64
    rt, dt = torch.from_numpy(r), torch.from_numpy(dfe)
    base = st.eam_pass1_plain(rt, nbr, ev, box_chunk=16)
    got = st.eam_pass1_plain(rt, nbr, ev, box_chunk=chunk)
    for a, b in zip(got, base):
        assert torch.equal(a, b)
    assert torch.equal(st.eam_pass3_plain(rt, nbr, ev, dt, box_chunk=chunk),
                       st.eam_pass3_plain(rt, nbr, ev, dt, box_chunk=16))


def test_wrapper_runs_plain_on_cpu_without_launching(f32):
    sim, r, dfe, ev, nbr, _ = f32
    rt, dt = torch.from_numpy(r), torch.from_numpy(dfe)
    st.reset_launch_counts()
    got1 = st.eam_pass1(rt, nbr, ev)
    got3 = st.eam_pass3(rt, nbr, ev, dt)
    assert all(v == 0 for v in st.LAUNCHES.values())
    for a, b in zip(got1, st.eam_pass1_plain(rt, nbr, ev)):
        assert torch.equal(a, b)
    assert torch.equal(got3, st.eam_pass3_plain(rt, nbr, ev, dt))


def test_wrapper_never_falls_back_off_cpu(f32):
    """A tensor that is not on the CPU takes the kernel path or raises; it
    is never handed to the plain version."""
    sim, r, dfe, ev, nbr, _ = f32
    rm = torch.empty(r.shape, dtype=torch.float32, device="meta")
    nm = torch.empty(nbr.shape, dtype=torch.int32, device="meta")
    st.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        st.eam_pass1(rm, nm, ev)
    assert st.LAUNCHES["eam_pass1"] == 0


def test_wrapper_checks_operands(f32):
    sim, r, dfe, ev, nbr, _ = f32
    rt = torch.from_numpy(r)
    with pytest.raises(ValueError, match="dtype"):
        st.eam_pass1(rt.double(), nbr, ev)
    with pytest.raises(ValueError, match="int32"):
        st.eam_pass1(rt, nbr.long(), ev)
    with pytest.raises(ValueError, match="df_embed"):
        st.eam_pass3(rt, nbr, ev, torch.from_numpy(dfe)[:-1])
