"""The port's Lennard-Jones path against comd_tpu.

Inputs: one comd_tpu LJ state at 6^3 (A = 32 on a 3^3 grid), T = 600 K with
reference-RNG displacements, handed to both packages; the potential is
carried over with ``interop.lj_potential_from_fields``.

- K1's LJ variant, plain version: f32 against comd_tpu's Pallas
  ``lj_force_stencil`` in interpret mode (forces atol 1e-4 eV/A, per-atom
  energy rtol 1e-5: the 27-neighbor order differs); f64 against comd_tpu's
  XLA ``force_lj.lj_force``, rtol 1e-12 (forces also atol 1e-12 * max|f|).
- The LJ golden -1.243619295058 (T = 0, 6^3, f64) within 1e-9, and f32
  within 5e-7 as comd_tpu's own test holds it.
- The wrapper launches nothing on the CPU and raises on a tensor that is
  neither on the CPU nor on a card.

The CUDA kernel itself, and the 5-sigma golden (A ~ 256: minutes on the
CPU), are held on the card by tests/test_torch_kernel_cuda.py.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init
from comd_tpu.ops import force_lj as jlj
from comd_tpu.ops.pallas.stencil import lj_force_stencil
from comd_tpu.potentials import lj as jpot

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import lj_potential_from_fields
from comd_tpu_torch.ops import force_lj as tlj
from comd_tpu_torch.ops.binning import geom_maps
from comd_tpu_torch.ops.cuda import stencil as st
from comd_tpu_torch.potentials import lj as tpot

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
GOLDEN_LJ = -1.243619295058


def _setup(dtype):
    sim = j_init(JConfig(nx=6, ny=6, nz=6, temperature=600.0,
                         initial_delta=0.1, dtype=dtype, pot_dir=POTS,
                         n_steps=0))
    r = np.array(sim.state.r)
    pot = lj_potential_from_fields(dataclasses.asdict(sim.pot))
    tdt = torch.from_numpy(r).dtype
    return sim, r, pot, tlj.make_lj_evaluator(pot, tdt), \
        geom_maps(sim.geom, tdt, "cpu")


def _close(ft, fj, atol, rtol):
    np.testing.assert_allclose(ft, fj, rtol=rtol,
                               atol=atol + rtol * np.abs(fj).max())


def _one(res):
    """One shard's results from the force of a stack of one."""
    return tuple(None if x is None else x[0] for x in res)


@pytest.fixture(scope="module")
def f32():
    sim, r, pot, ev, maps = _setup("float32")
    assert r.shape[-1] == 32 and sim.geom.grid == (3, 3, 3)
    fj, uj, ej = lj_force_stencil(sim.geom, sim.pot, jnp.asarray(r),
                                  chunk=128, interpret=True)
    return sim, r, pot, ev, maps, [np.asarray(x) for x in (fj, uj, ej)]


@pytest.mark.parametrize("factor", [2.5, 5.0])
def test_potential_carried_over(factor):
    jp = jpot.init_lj_pot(factor)
    tp = lj_potential_from_fields(dataclasses.asdict(jp))
    assert tp == tpot.init_lj_pot(factor)
    assert (tp.s6, tp.e_shift, tp.cutoff) == (jp.s6, jp.e_shift, jp.cutoff)
    assert tp.describe() == jp.describe()
    with pytest.raises(KeyError):
        lj_potential_from_fields({"sigma": 2.315})


def test_lj_plain_matches_pallas_f32(f32):
    sim, r, pot, ev, maps, (fj, uj, ej) = f32
    ft, ut, et = _one(tlj.lj_force(maps.nbr_map, pot,
                                   torch.from_numpy(r)[None], ev))
    _close(ft.numpy(), fj, 1e-4, 0.0)
    np.testing.assert_allclose(ut.numpy(), uj, rtol=1e-5,
                               atol=1e-6 * np.abs(uj).max())
    assert float(et) == pytest.approx(float(ej), rel=1e-6)
    assert np.abs(fj).max() > 0.1          # a real, non-lattice force field


def test_lj_no_energy_variant_f32(f32):
    sim, r, pot, ev, maps, (fj, _uj, _ej) = f32
    ft, ut, et = _one(tlj.lj_force(maps.nbr_map, pot,
                                   torch.from_numpy(r)[None], ev,
                                   want_energy=False))
    assert ut is None and et is None
    _close(ft.numpy(), fj, 1e-4, 0.0)


def test_lj_plain_matches_xla_f64():
    sim, r, pot, ev, maps = _setup("float64")
    fj, uj, ej = jlj.lj_force(sim.geom, sim.pot, jnp.asarray(r), chunk=32)
    ft, ut, et = _one(tlj.lj_force(maps.nbr_map, pot,
                                   torch.from_numpy(r)[None], ev))
    _close(ft.numpy(), np.asarray(fj), 0.0, 1e-12)
    _close(ut.numpy(), np.asarray(uj), 0.0, 1e-12)
    assert float(et) == pytest.approx(float(ej), rel=1e-12)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 5e-7)])
def test_lj_golden(dtype, tol):
    sim = init_simulation(Config(nx=6, ny=6, nz=6, temperature=0.0,
                                 dtype=dtype, pot_dir=POTS, device="cpu"))
    assert sim.sum_atoms() == sim.n_global == 864
    assert sim.e_potential / sim.n_global == pytest.approx(GOLDEN_LJ,
                                                           abs=tol)


def test_lj_wrapper_runs_plain_on_cpu_without_launching(f32):
    sim, r, pot, ev, maps, _ = f32
    rt = torch.from_numpy(r)
    st.reset_launch_counts()
    got = st.lj_pass(rt, maps.nbr_map, ev)
    got_h = st.lj_pass_half(rt, maps.half_nbr_map, ev)
    assert all(v == 0 for v in st.LAUNCHES.values())
    for a, b in zip(got, st.lj_pass_plain(rt, maps.nbr_map, ev)):
        assert torch.equal(a, b)
    for a, b in zip(got_h, st.lj_pass_half_plain(rt, maps.half_nbr_map, ev)):
        assert torch.equal(a, b)


def test_lj_wrapper_never_falls_back_off_cpu(f32):
    sim, r, pot, ev, maps, _ = f32
    rm = torch.empty(r.shape, dtype=torch.float32, device="meta")
    st.reset_launch_counts()
    for fn, nbr in ((st.lj_pass, maps.nbr_map),
                    (st.lj_pass_half, maps.half_nbr_map)):
        nm = torch.empty(nbr.shape, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(rm, nm, ev)
    assert all(v == 0 for v in st.LAUNCHES.values())
