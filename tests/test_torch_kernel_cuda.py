"""The CUDA kernels on the card against their plain versions: the
cell-stencil kernels (K1, K2), the halo push kernels (K3, K4) and the
archive probes' kernels (P1-P6: window_pair, row_lookup, lane_lookup).

Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda

Imports torch and comd_tpu_torch only (the card's machine has no jax).
Without a CUDA device every test skips.  Tolerances: f32/Chebyshev forces
atol 1e-4 eV/A and phi-sum/rhobar rtol 1e-5 (the kernels sum in another
order, K2 with atomics in an order that changes from run to run); f64
rtol 1e-12 (forces also atol 1e-12 * max|f|).  K2's outputs are compared
dense and unfolded: kernel and plain version use the same half map.  K1
adds each atom's pairs in one fixed order, so two launches on the same
inputs must give the same bits.  K3
and K4 only move and evaluate values, so they are held bit for bit (K4
against pass 2's own F' at the same rows), and a sharded run gives the
same bits under every transport.
"""
import os

import numpy as np
import pytest
import torch

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import FIELDS, state_from_numpy
from comd_tpu_torch.ops import binning
from comd_tpu_torch.ops.cuda import comm as cm
from comd_tpu_torch.ops.cuda import probe as cuda_probe
from comd_tpu_torch.ops.cuda import stencil as st
from comd_tpu_torch.probes import lookup, window

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
GOLDEN_EAM_ADAMS = -3.538079224691
GOLDEN_EAM_MISHIN = -3.539999969176
GOLDEN_LJ = -1.243619295058
GOLDEN_LJ_5SIGMA = -1.406590686466

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _sim(dtype, impl, n, device, doeam=True, **kw):
    sim = init_simulation(Config(nx=n, ny=n, nz=n, doeam=doeam,
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
        assert sim.cfg.max_atoms == max_atoms
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
    assert (st.LAUNCHES["eam_pass1"], st.LAUNCHES["eam_pass3"]) == (2, 1)


def _tols(dtype):
    return (1e-4, 1e-5, 0.0) if dtype == "float32" else (0.0, 1e-12, 1e-12)


@pytest.mark.parametrize("dtype,impl,n,max_atoms", [
    ("float32", "cheb", 6, 0), ("float32", "cheb", 10, 0),
    ("float64", "rows", 6, 0), ("float32", "cheb", 6, 40),
    ("float64", "rows", 6, 40)])
def test_half_kernel_matches_plain(cuda_device, dtype, impl, n, max_atoms):
    """K2, EAM passes 1 (with and without energy) and 3, dense outputs;
    at A = 40 a cell's threads span two warps."""
    sim = _sim(dtype, impl, n, "cuda", half_shell=True, max_atoms=max_atoms)
    r, hm, ev = sim.state.r, sim.maps.half_nbr_map, sim.pair_eval
    f_atol, s_rtol, f_rtol = _tols(dtype)
    st.reset_launch_counts()
    fk, pk, rk = st.eam_pass1_half(r, hm, ev, want_energy=True)
    fk2, pk2, rk2 = st.eam_pass1_half(r, hm, ev, want_energy=False)
    fp, pp, rp = st.eam_pass1_half_plain(r, hm, ev, want_energy=True)
    assert pk2 is None and fk.shape == (3, sim.geom.n_total, r.shape[2])
    for f in (fk, fk2):
        _close(f, fp, f_atol, f_rtol)
    for s_k, s_p in ((pk, pp), (rk, rp), (rk2, rp)):
        _close(s_k, s_p, 0.0, s_rtol)
    dfe = sim.state.r.new_zeros(r.shape[1:])
    dfe[:sim.geom.n_local] = sim.f_eval(rp[:sim.geom.n_local])[1]
    binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
    _close(st.eam_pass3_half(r, hm, ev, dfe),
           st.eam_pass3_half_plain(r, hm, ev, dfe), f_atol, f_rtol)
    assert (st.LAUNCHES["half_eam_pass1"], st.LAUNCHES["half_eam_pass3"]) \
        == (2, 1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lj_kernels_match_plain(cuda_device, dtype):
    """K1's and K2's LJ variants, with and without energy."""
    sim = _sim(dtype, "auto", 8, "cuda", doeam=False)
    r, ev = sim.state.r, sim.pair_eval
    f_atol, s_rtol, f_rtol = _tols(dtype)
    st.reset_launch_counts()
    for fn, plain, nbr in ((st.lj_pass, st.lj_pass_plain, sim.maps.nbr_map),
                           (st.lj_pass_half, st.lj_pass_half_plain,
                            sim.maps.half_nbr_map)):
        fp, ep = plain(r, nbr, ev)
        fk, ek = fn(r, nbr, ev)
        fk2, ek2 = fn(r, nbr, ev, want_energy=False)
        assert ek2 is None
        for f in (fk, fk2):
            _close(f, fp, f_atol, f_rtol)
        _close(ek, ep, 1e-6 * float(ep.abs().max()), s_rtol)
    assert (st.LAUNCHES["lj"], st.LAUNCHES["half_lj"]) == (2, 2)


def _dfe(sim, r, seed=3):
    """A numpy-seeded halo-filled dfEmbed field on r's device."""
    d = np.random.default_rng(seed).uniform(-100.0, -90.0,
                                            size=tuple(r.shape[1:]))
    dfe = torch.as_tensor(d, dtype=r.dtype, device=r.device)
    binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
    return dfe


def _same(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_k1_bit_for_bit_across_launches(cuda_device, dtype, impl):
    """K1 sums each i's pairs in one fixed order with no atomics on the i
    side: two launches on the same inputs give the same bits (EAM passes 1
    with and without energy and 3, LJ with and without energy)."""
    sim = _sim(dtype, impl, 10, "cuda")
    r, nbr, ev = sim.state.r, sim.maps.nbr_map, sim.pair_eval
    for energy in (True, False):
        assert _same(st.eam_pass1(r, nbr, ev, want_energy=energy),
                     st.eam_pass1(r, nbr, ev, want_energy=energy))
    dfe = _dfe(sim, r)
    assert torch.equal(st.eam_pass3(r, nbr, ev, dfe),
                       st.eam_pass3(r, nbr, ev, dfe))
    lj = _sim(dtype, "auto", 8, "cuda", doeam=False)
    for energy in (True, False):
        args = (lj.state.r, lj.maps.nbr_map, lj.pair_eval)
        assert _same(st.lj_pass(*args, want_energy=energy),
                     st.lj_pass(*args, want_energy=energy))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_5sigma_lj_lists_drain_many_times(cuda_device, dtype):
    """5-sigma LJ: A ~ 256 on a 2^3 grid and ~550 pairs an atom inside the
    cutoff, so every thread's list fills and drains many times; K1 and K2
    with and without energy against their plain versions."""
    sim = _sim(dtype, "auto", 8, "cuda", doeam=False, lj_cutoff_factor=5.0)
    assert sim.cfg.max_atoms > 128 and sim.geom.grid == (2, 2, 2)
    r, ev = sim.state.r, sim.pair_eval
    f_atol, s_rtol, f_rtol = _tols(dtype)
    for fn, plain, nbr in ((st.lj_pass, st.lj_pass_plain, sim.maps.nbr_map),
                           (st.lj_pass_half, st.lj_pass_half_plain,
                            sim.maps.half_nbr_map)):
        fp, ep = plain(r, nbr, ev)
        for energy in (True, False):
            fk, ek = fn(r, nbr, ev, want_energy=energy)
            _close(fk, fp, f_atol, f_rtol)
            if energy:
                _close(ek, ep, 1e-6 * float(ep.abs().max()), s_rtol)


@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_empty_and_one_atom_cells(cuda_device, dtype, impl):
    """Cells emptied to the sentinel and cells holding one atom behind
    empty slots: K1 and K2, EAM passes 1 and 3, against the plain
    versions."""
    sim = _sim(dtype, impl, 6, "cuda")
    r = sim.state.r.clone()
    n_local, A = sim.geom.n_local, r.shape[2]
    cells = torch.arange(n_local, device=r.device)
    single = cells[cells % 5 == 1]
    empty = cells[(cells % 3 == 0) & (cells % 5 != 1)]
    r[:, single, 3] = r[:, single, 0]
    keep = r[:, single, 3].clone()
    r[:, empty] = binning.EMPTY_POS
    r[:, single] = binning.EMPTY_POS
    r[:, single, 3] = keep
    binning.refresh_halo_positions(sim.geom, sim.maps, r)
    assert A > 4 and int((r[0, :n_local] < 1e9).sum()) > 0
    ev, dfe = sim.pair_eval, _dfe(sim, r)
    f_atol, s_rtol, f_rtol = _tols(dtype)
    for nbr, p1, p1p, p3, p3p in (
            (sim.maps.nbr_map, st.eam_pass1, st.eam_pass1_plain,
             st.eam_pass3, st.eam_pass3_plain),
            (sim.maps.half_nbr_map, st.eam_pass1_half,
             st.eam_pass1_half_plain, st.eam_pass3_half,
             st.eam_pass3_half_plain)):
        fk, pk, rk = p1(r, nbr, ev)
        fp, pp, rp = p1p(r, nbr, ev)
        _close(fk, fp, f_atol, f_rtol)
        for s_k, s_p in ((pk, pp), (rk, rp)):
            _close(s_k, s_p, 0.0, s_rtol)
        assert float(fk[:, empty].abs().max()) == 0.0 or nbr.shape[1] == 14
        _close(p3(r, nbr, ev, dfe), p3p(r, nbr, ev, dfe), f_atol, f_rtol)


@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_grid_smaller_than_a_brick(cuda_device, dtype, impl):
    """A 2^3 grid, smaller than the A = 16 brick of 4x2x2 cells: one brick
    clipped to the grid, K1 and K2 against their plain versions."""
    sim = _sim(dtype, impl, 3, "cuda")
    A = sim.state.r.shape[2]
    assert sim.geom.grid == (2, 2, 2)
    assert any(b > 2 for b in binning.brick_shape(A, (64, 64, 64)))
    r, ev = sim.state.r, sim.pair_eval
    f_atol, s_rtol, f_rtol = _tols(dtype)
    dfe = _dfe(sim, r)
    for nbr, p1, p1p, p3, p3p in (
            (sim.maps.nbr_map, st.eam_pass1, st.eam_pass1_plain,
             st.eam_pass3, st.eam_pass3_plain),
            (sim.maps.half_nbr_map, st.eam_pass1_half,
             st.eam_pass1_half_plain, st.eam_pass3_half,
             st.eam_pass3_half_plain)):
        fk, pk, rk = p1(r, nbr, ev)
        fp, pp, rp = p1p(r, nbr, ev)
        _close(fk, fp, f_atol, f_rtol)
        for s_k, s_p in ((pk, pp), (rk, rp)):
            _close(s_k, s_p, 0.0, s_rtol)
        _close(p3(r, nbr, ev, dfe), p3p(r, nbr, ev, dfe), f_atol, f_rtol)


@pytest.mark.parametrize("doeam,n,factor,golden", [
    (False, 6, 2.5, GOLDEN_LJ), (False, 8, 5.0, GOLDEN_LJ_5SIGMA),
    (True, 6, 2.5, GOLDEN_EAM_ADAMS)])
@pytest.mark.parametrize("half", [False, True])
def test_lj_and_half_goldens_on_card(cuda_device, doeam, n, factor, golden,
                                     half):
    """The LJ goldens (5 sigma: A ~ 256 on a 2^3 grid, the kernels' tiled
    i and j loops) and the Adams golden with --halfShell, f64, T = 0."""
    sim = init_simulation(Config(nx=n, ny=n, nz=n, doeam=doeam,
                                 lj_cutoff_factor=factor, half_shell=half,
                                 temperature=0.0, dtype="float64",
                                 pot_dir=POTS, device="cuda"))
    if factor == 5.0:
        assert sim.cfg.max_atoms > 128 and sim.geom.grid == (2, 2, 2)
    assert sim.e_potential / sim.n_global == pytest.approx(golden, abs=1e-9)


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


MESH = dict(xproc=2, yproc=2, zproc=2)
# 864 atoms displaced so that some change shard within a few steps
TRAJ = dict(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
            initial_delta=0.8, pot_dir=POTS, **MESH)


def _mesh_sim(dtype, **kw):
    sim = init_simulation(Config(nx=8, ny=8, nz=8, doeam=True,
                                 temperature=600.0, dtype=dtype,
                                 pot_dir=POTS, device="cuda", **MESH, **kw))
    sim.step_block(5)
    return sim


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ring_push_matches_plain(cuda_device, dtype):
    """K3: the six dfEmbed pushes of the staged exchange, in order, and the
    six atom messages (r, p, gid, counts), bit for bit."""
    sim = _mesh_sim(dtype, comm_impl="ki")
    h = sim.halo
    torch.manual_seed(0)
    a = [torch.randn(s.gid.shape, dtype=sim.dtype, device=cuda_device)
         for s in sim.states]
    b = [v.clone() for v in a]
    st.reset_launch_counts()
    for axis in range(3):
        (s_m, s_p), (r_m, r_p) = h.force_send[axis], h.force_recv[axis]
        for to, send, recv in ((h.minus[axis], s_m, r_p),
                               (h.plus[axis], s_p, r_m)):
            cm.ring_push([(a, a)], to, send, recv)
            cm.ring_push_plain([(b, b)], to, send, recv)
            assert _equal(a, b)
    fields = [[getattr(s, k) for s in sim.states]
              for k in ("r", "p", "gid", "n_atoms")]
    for axis in range(3):
        for d, to in ((0, h.minus[axis]), (1, h.plus[axis])):
            ids = h.atom_send[axis][d]
            outs = []
            for fn in (cm.ring_push, cm.ring_push_plain):
                buf = [[f[0].new_zeros(
                    (3, ids.numel(), f[0].shape[2]) if f[0].dim() == 3
                    else (ids.numel(),) + tuple(f[0].shape[1:]))
                    for _ in f] for f in fields]
                fn(list(zip(fields, buf)), to, ids)
                outs.append(buf)
            for fk, fp in zip(*outs):
                assert _equal(fk, fp)
            assert outs[0][2][0].ne(0).any()          # gids arrived
    assert st.LAUNCHES["ring_push"] == 12


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pass2_push_matches_pass2(cuda_device, dtype):
    """K4: F'(rhobar) of both x-face planes equals pass 2's F' of the same
    rows bit for bit, and lands in the neighbors' rows as the plain version
    puts it."""
    sim = _mesh_sim(dtype, comm_impl="ki_fused")
    h = sim.halo
    rhobar = [st.eam_pass1(s.r, sim.maps.nbr_map, sim.pair_eval,
                           want_energy=False)[2] for s in sim.states]
    st.reset_launch_counts()
    (s_m, s_p), (r_m, r_p) = h.force_send[0], h.force_recv[0]
    for to, send, recv in ((h.minus[0], s_m, r_p), (h.plus[0], s_p, r_m)):
        a = [torch.zeros_like(s.gid, dtype=sim.dtype) for s in sim.states]
        b = [v.clone() for v in a]
        local = cm.pass2_push(rhobar, a, to, send, recv, sim.f_eval)
        plain = cm.pass2_push_plain(rhobar, b, to, send, recv, sim.f_eval)
        ref = [sim.f_eval(rho)[1][send] for rho in rhobar]
        assert _equal(local, ref) and _equal(plain, ref) and _equal(a, b)
        assert all(v[recv].ne(0).all() for v in a)
    assert st.LAUNCHES["pass2_push"] == 2


@pytest.mark.parametrize("comm_impl", ["ki", "ki_fused"])
def test_transports_bit_equal_on_card(cuda_device, comm_impl):
    """Eager f64 steps (an atom exchange every step) on the full-shell K1,
    whose sums are deterministic: K3/K4 give the collective run's bits."""
    sims = []
    for ci in ("collective", comm_impl):
        sim = init_simulation(Config(dtype="float64", lazy_shell=False,
                                     comm_impl=ci, device="cuda", **TRAJ))
        sim.step_block(5)
        sims.append(sim)
    assert sims[1].e_potential == sims[0].e_potential
    for x, y in zip(*[s.states for s in sims]):
        for k in ("r", "p", "f", "gid", "n_atoms"):
            assert torch.equal(getattr(x, k), getattr(y, k)), k


@pytest.mark.parametrize("probe,lj,chunks", [(1, False, 2), (2, False, 1),
                                             (3, False, 2), (3, True, 2)])
def test_window_pair_matches_plain(cuda_device, probe, lj, chunks):
    """The probes' window kernel (P1, P2, P3 EAM and LJ) against its plain
    version (another summation order, FMA contraction in the Clenshaw
    chains): every element within 1e-5 of the sum of its terms'
    magnitudes, every output within 1e-5 of its largest value, all values
    finite."""
    sp = window.spec(probe, lj)
    rp = torch.from_numpy(window.make_inputs(probe, chunks)).to(cuda_device)
    st.reset_launch_counts()
    got = window.window_pair(rp, sp)
    want = window.window_pair_plain(rp, sp)
    assert len(got) == len(want) == sp.n_out
    for a, b in zip(got, want):
        assert a.shape == (window.SLOTS, chunks * window.CHUNK)
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert window.element_error(
        got, want, window.window_pair_magnitude(rp, sp)) <= 1e-5
    assert st.LAUNCHES["window_pair"] == 1


@pytest.mark.parametrize("scale", [lookup.SCALE, 1.0])
def test_lookups_match_plain_bitwise(cuda_device, scale):
    """P4's row lookup and P5's (= P6's) lane lookup against their plain
    versions bit for bit: the probes' tables and tables whose columns
    differ, an x length off the float4 width, 64 lanes (two column
    slices), indices past the table."""
    rng = np.random.default_rng(3)
    x4, t4 = (torch.from_numpy(a).to(cuda_device)
              for a in lookup.make_inputs(4, 1 << 16))
    t4b = torch.from_numpy(rng.normal(size=(512, 4)).astype(np.float32)
                           ).to(cuda_device)
    st.reset_launch_counts()
    for x in (x4, x4[:1001], x4 * 1.1 - 20.0):
        for tab in (t4, t4b):
            assert torch.equal(lookup.row_lookup(x, tab, scale),
                               lookup.row_lookup_plain(x, tab, scale))
    x5, t5 = (torch.from_numpy(a).to(cuda_device)
              for a in lookup.make_inputs(5, 1 << 16))
    t5b = torch.from_numpy(rng.normal(size=(512, 128)).astype(np.float32)
                           ).to(cuda_device)
    for x, tab in ((x5, t5), (x5, t5b), (x5[:, :64].contiguous(),
                                         t5b[:, :64].contiguous()),
                   (x5 * 1.1 - 20.0, t5b)):
        got = lookup.lane_lookup(x, tab, scale)
        assert torch.equal(got, lookup.lane_lookup_plain(x, tab, scale))
        assert torch.equal(lookup.onehot_lookup(x, tab, scale), got)
    assert (st.LAUNCHES["row_lookup"], st.LAUNCHES["lane_lookup"]) == (6, 8)


def test_probe_kernels_refuse_what_they_do_not_take(cuda_device):
    x, tab = (torch.from_numpy(a).to(cuda_device)
              for a in lookup.make_inputs(5, 1024))
    with pytest.raises(ValueError, match="float32"):
        cuda_probe.lane_lookup(x.double(), tab.double(), 1.0)
    with pytest.raises(ValueError, match="lanes"):
        cuda_probe.lane_lookup(x, tab[:, :64].contiguous(), 1.0)
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_probe.lane_lookup(x[:, :40].contiguous(),
                               tab[:, :40].contiguous(), 1.0)
    with pytest.raises(ValueError, match="table"):
        cuda_probe.row_lookup(x, tab, 1.0)
    with pytest.raises(ValueError, match="aligned"):
        cuda_probe.row_lookup(x.reshape(-1)[1:], tab[:, :4].contiguous(), 1.0)
    rp = torch.from_numpy(window.make_inputs(1, 1)).to(cuda_device)
    with pytest.raises(ValueError, match="fit"):
        cuda_probe.window_pair(rp, window.spec(1), 512)


def test_sharded_card_matches_cpu(cuda_device):
    """10 f64 lazy steps of the ki_fused mesh on the card against the
    collective mesh on the CPU (plain versions): summation order only."""
    cpu = init_simulation(Config(dtype="float64", device="cpu", **TRAJ))
    gpu = init_simulation(Config(dtype="float64", device="cuda",
                                 comm_impl="ki_fused", **TRAJ))
    cpu.step_block(10)
    gpu.step_block(10)
    assert gpu.n_rebucket == cpu.n_rebucket >= 1
    for c, g in zip(cpu.states, gpu.states):
        assert torch.equal(g.gid.cpu(), c.gid)
        for k in ("r", "p"):
            np.testing.assert_allclose(getattr(g, k).cpu().numpy(),
                                       getattr(c, k).numpy(), rtol=0,
                                       atol=1e-10)
    assert gpu.e_potential == pytest.approx(cpu.e_potential, rel=1e-12)
