"""The CUDA cell-stencil kernel on the card, against its plain version.

Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda

Imports torch and comd_tpu_torch only (the card's machine has no jax).
Without a CUDA device every test skips.  Tolerances: f32/Chebyshev forces
atol 1e-4 eV/A and phi-sum/rhobar rtol 1e-5 (the kernel sums in another
order); f64/table rtol 1e-12 (forces also atol 1e-12 * max|f|).
"""
import os

import numpy as np
import pytest
import torch

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import FIELDS, state_from_numpy
from comd_tpu_torch.ops import binning
from comd_tpu_torch.ops.cuda import stencil as st

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
GOLDEN_EAM_ADAMS = -3.538079224691
GOLDEN_EAM_MISHIN = -3.539999969176

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _sim(dtype, impl, n, device, **kw):
    sim = init_simulation(Config(nx=n, ny=n, nz=n, doeam=True,
                                 temperature=600.0, dtype=dtype,
                                 interp_impl=impl, pot_dir=POTS,
                                 device=device, **kw))
    sim.step_block(5)                    # atoms off their lattice sites
    return sim


def _close(a, b, atol, rtol):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol + rtol * np.abs(b).max())


@pytest.mark.parametrize("dtype,impl,n,max_atoms", [
    ("float32", "cheb", 6, 0), ("float32", "cheb", 10, 0),
    ("float64", "rows", 6, 0), ("float64", "rows", 10, 0),
    ("float32", "cheb", 6, 64)])
def test_kernel_matches_plain(cuda_device, dtype, impl, n, max_atoms):
    sim = _sim(dtype, impl, n, "cuda", max_atoms=max_atoms)
    if max_atoms:
        assert sim.cfg.max_atoms == st.MAX_A
    r, nbr, ev = sim.state.r, sim.maps.nbr_map, sim.pair_eval
    f_atol, s_rtol, f_rtol = ((1e-4, 1e-5, 0.0) if dtype == "float32"
                              else (0.0, 1e-12, 1e-12))
    st.reset_launch_counts()
    fk, pk, rk = st.eam_pass1(r, nbr, ev, want_energy=True)
    fk2, pk2, rk2 = st.eam_pass1(r, nbr, ev, want_energy=False)
    fp, pp, rp = st.eam_pass1_plain(r, nbr, ev, want_energy=True)
    assert pk2 is None
    for f in (fk, fk2):
        _close(f, fp, f_atol, f_rtol)
    for s_k, s_p in ((pk, pp), (rk, rp), (rk2, rp)):
        np.testing.assert_allclose(s_k.cpu().numpy(), s_p.cpu().numpy(),
                                   rtol=s_rtol, atol=0)
    _f, dfe_l = sim.f_eval(rp)
    dfe = torch.zeros(r.shape[1:], dtype=r.dtype, device=r.device)
    dfe[:sim.geom.n_local] = dfe_l
    binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
    f3k = st.eam_pass3(r, nbr, ev, dfe)
    _close(f3k, st.eam_pass3_plain(r, nbr, ev, dfe), f_atol, f_rtol)
    assert st.LAUNCHES == {"eam_pass1": 2, "eam_pass3": 1}


def test_kernel_rejects_oversized_cells(cuda_device):
    sim = _sim("float32", "cheb", 6, "cuda")
    big = torch.full((3, sim.geom.n_total, st.MAX_A + 8), 1e10,
                     dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="capacity"):
        st.eam_pass1(big, sim.maps.nbr_map, sim.pair_eval)


@pytest.mark.parametrize("pot_type,golden", [("funcfl", GOLDEN_EAM_ADAMS),
                                             ("setfl", GOLDEN_EAM_MISHIN)])
def test_goldens_on_card(cuda_device, pot_type, golden):
    sim = init_simulation(Config(nx=6, ny=6, nz=6, doeam=True,
                                 pot_type=pot_type, temperature=0.0,
                                 dtype="float64", pot_dir=POTS,
                                 device="cuda"))
    assert sim.e_potential / sim.n_global == pytest.approx(golden, abs=1e-9)


def test_card_trajectory_matches_cpu(cuda_device):
    """10 f64 steps on the card (kernel) and on the CPU (plain version)
    from one state: the kernel changes only the summation order."""
    kw = dict(nx=6, ny=6, nz=6, doeam=True, temperature=1200.0,
              dtype="float64", pot_dir=POTS)
    cpu = init_simulation(Config(device="cpu", **kw))
    gpu = init_simulation(Config(device="cuda", **kw))
    gpu.state = state_from_numpy(
        {k: getattr(cpu.state, k).numpy() for k in FIELDS}, "cuda")
    cpu.step_block(10)
    gpu.step_block(10)
    for k in ("r", "p"):
        np.testing.assert_allclose(getattr(gpu.state, k).cpu().numpy(),
                                   getattr(cpu.state, k).numpy(),
                                   rtol=0, atol=1e-10)
    assert torch.equal(gpu.state.gid.cpu(), cpu.state.gid)
    assert gpu.e_potential == pytest.approx(cpu.e_potential, rel=1e-12)
