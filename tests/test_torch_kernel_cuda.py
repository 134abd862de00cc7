"""The CUDA kernels on the card against their plain versions: the
cell-stencil kernels (K1, K2), the halo kernels (the dfEmbed fill, K3's
and K4's functions in one launch; the atom stage push, K3), the archive
probes' kernels (P1-P6: window_pair, row_lookup, lane_lookup) and the
neighbor-list kernels (NL1 nl_build: the same lists, counts and overflow
flag bit for bit; NL2 nl_sweep: the pair sums at the stencil tolerances,
the same bits on two launches) and the list paths' row ops (NR nl_rows,
ER embed_rows, LR land_rows: bit for bit).

Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda

Imports torch and comd_tpu_torch only (the card's machine has no jax).
Without a CUDA device every test skips.  Tolerances: f32/Chebyshev forces
atol 1e-4 eV/A and phi-sum/rhobar rtol 1e-5 (the kernels sum in another
order, K2 with atomics in an order that changes from run to run); f64
rtol 1e-12 (forces also atol 1e-12 * max|f|).  K2's outputs are compared
dense and unfolded: kernel and plain version use the same half map.  K1
adds each atom's pairs in one fixed order, so two launches on the same
inputs must give the same bits.  The
halo kernels only move and evaluate values, so they are held bit for bit
(K4 against pass 2's own F' at the same rows), a fill is one launch and an
atom exchange three, and a sharded run gives the same bits under every
transport.  The step's CUDA graphs (comd_tpu_torch/stepgraph.py) give
the eager loop's state bit for bit, serial (K1, NL2) and on a 2x2x2 mesh
in one process, lazy (the rebucket a conditional node) and -S 0, with
one host sync a lazy block (the rebucket counter) and none on -S 0; the
trigger kernel sets the IF nodes' handles so that each body runs when
the trigger says, serially and or-ed over eight shards, and with the
serial image map writes the ghost images bit for bit as the plain head
does, in a graph with the one handle of the serial step too.  The atom
exchange's unload (csrc/arrivals.cu: bin and place a stage, the sort of
every shard) equals its plain versions bit for bit at every stage under
each transport, and in a crowded cell up to C arrivals (past C the counts
and the flag); a mesh redistribution is 3 bin, 3 place and 1 sort launch.
"""
import dataclasses
import os
import types
import warnings

import numpy as np
import pytest
import torch

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch.interop import FIELDS, state_from_numpy
from comd_tpu_torch.ops import binning
from comd_tpu_torch.ops import neighborlist as nlmod
from comd_tpu_torch.ops.cuda import comm as cm
from comd_tpu_torch.ops.cuda import nl as cuda_nl
from comd_tpu_torch.ops.cuda import probe as cuda_probe
from comd_tpu_torch.ops.cuda import stencil as st
from comd_tpu_torch.ops.cuda import step as step_ops
from comd_tpu_torch.parallel import exchange, ki_comm
from comd_tpu_torch.parallel.mesh import make_mesh
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
    step_ops.refresh_halo_plain(sim.geom, sim.maps, r)
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


# the exchange tests' meshes: (box, mesh); on 3x2x1 the z ring is the
# shard itself
MESHES = {"2x2x2": ((8, 8, 8), MESH),
          "3x2x1": ((9, 6, 6), dict(xproc=3, yproc=2, zproc=1))}


def _mesh_sim(dtype, mesh="2x2x2", **kw):
    box, grid = MESHES[mesh]
    sim = init_simulation(Config(nx=box[0], ny=box[1], nz=box[2], doeam=True,
                                 temperature=600.0, dtype=dtype,
                                 pot_dir=POTS, device="cuda", **grid, **kw))
    sim.step_block(5)
    return sim


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ring_push_matches_plain(cuda_device, dtype, mesh):
    """K3: the atom message of every stage (r, p, gid, counts; both
    directions in one launch, each field at its own vector width), bit for
    bit, three launches for the three stages."""
    sim = _mesh_sim(dtype, mesh, comm_impl="ki")
    h = sim.halo
    fields = [[getattr(s, k) for s in sim.states]
              for k in ("r", "p", "gid", "n_atoms")]
    st.reset_launch_counts()
    for axis in range(3):
        plan = ki_comm.atom_plan(h, axis, fields)
        assert [f.vec_bytes for f in plan.fields] == [16, 16, 16, 4]
        got = cm.ring_push(plan, fields)
        want = cm.ring_push_plain(plan, fields)
        assert _equal(got, want)
        assert got[2].ne(0).any()                     # gids arrived
    assert st.LAUNCHES["ring_push"] == 3


@pytest.mark.parametrize("fused", [False, True], ids=["ki", "ki_fused"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_halo_fill_matches_plain(cuda_device, dtype, mesh, fused):
    """The dfEmbed fill in one launch (stages x, y, z; with ``fused`` the
    x stage evaluates F'(rhobar), K4) against its plain version, bit for
    bit, on a field whose local rows pass 2 filled and whose halo rows hold
    noise: every halo row is written."""
    sim = _mesh_sim(dtype, mesh, comm_impl="ki_fused" if fused else "ki")
    h, nl = sim.halo, sim.geom.n_local
    rhobar = [st.eam_pass1(s.r, sim.maps.nbr_map, sim.pair_eval,
                           want_energy=False)[2] for s in sim.states]
    torch.manual_seed(1)
    x = []
    for s, rho in zip(sim.states, rhobar):
        d = torch.randn(s.gid.shape, dtype=sim.dtype, device=cuda_device)
        d[:nl] = sim.f_eval(rho)[1]
        x.append(d)
    extra = (rhobar, sim.f_eval) if fused else ()
    plan = ki_comm.fill_plan(h, x[0])
    st.reset_launch_counts()
    a = cm.halo_fill(plan, [v.clone() for v in x], *extra)
    b = cm.halo_fill_plain(plan, [v.clone() for v in x], *extra)
    assert st.LAUNCHES["halo_fill"] == 1
    assert _equal(a, b)
    assert all((v[nl:] != w[nl:]).all() for v, w in zip(a, x))


def test_comm_kernels_refuse_what_they_do_not_take(cuda_device):
    """A call hands the kernels only tensors of its plan's shape, dtype and
    device, at the plan's alignment."""
    sim = _mesh_sim("float32")
    h, states = sim.halo, sim.states
    x = [torch.zeros_like(s.gid, dtype=torch.float32) for s in states]
    plan = ki_comm.fill_plan(h, x[0])
    with pytest.raises(ValueError, match="expected contiguous"):
        cm.halo_fill(plan, x[:-1] + [x[-1][:, :-1]])
    with pytest.raises(ValueError, match="shards"):
        cm.halo_fill(plan, x[:-1])
    fields = [[getattr(s, k) for s in states]
              for k in ("r", "p", "gid", "n_atoms")]
    aplan = ki_comm.atom_plan(h, 0, fields)
    flat = torch.zeros(states[0].gid.numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    gid = fields[2][:-1] + [flat[1:].view(states[0].gid.shape)]
    with pytest.raises(ValueError, match="aligned"):
        cm.ring_push(aplan, fields[:2] + [gid] + fields[3:])
    with pytest.raises(ValueError, match="fused fill"):
        cm.halo_fill(plan, x, [s.r[0] for s in states],
                     dataclasses.replace(sim.f_eval,
                                         table=sim.f_eval.table.double()))


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
    assert st.LAUNCHES["halo_fill"] == 2


def _scratch_link(h, A, dtype):
    """A stand-in for ki_comm.Link whose receive planes for other
    processes are local zeroed buffers on the card, so that a stage's
    kernel and plain version can be held against each other in one
    process."""
    return types.SimpleNamespace(
        sizes=ki_comm.arena_layout(h, A, dtype)[1], arena=None,
        outbox=lambda kind, axis, q, n: torch.zeros(
            n, dtype=torch.uint8, device=h.mesh.device),
        inbox=lambda *a: None)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stage_pushes_into_planes_match_plain(cuda_device, dtype, n):
    """The stages across processes, process 0's view of a 2x2x2 mesh on
    n processes: each fill stage (one ordinary launch; the x stage also
    fused) and each atom stage writes this process's fields and the
    receive planes of the others exactly as its plain version does."""
    sim = _mesh_sim(dtype, comm_impl="ki_fused")
    mesh = make_mesh(2, 2, 2, cuda_device, nprocs=n, proc=0)
    h = exchange.make_halo(mesh, sim.geom, sim.maps, sim.plan, sim.dtype)
    own = list(mesh.owned)
    A = sim.states[0].gid.shape[1]
    link = _scratch_link(h, A, sim.dtype)
    rhobar = [st.eam_pass1(sim.states[s].r, sim.maps.nbr_map, sim.pair_eval,
                           want_energy=False)[2] for s in own]
    torch.manual_seed(2)
    x = [torch.randn(sim.states[s].gid.shape, dtype=sim.dtype,
                     device=cuda_device) for s in own]
    crossed = 0
    st.reset_launch_counts()
    for axis in range(3):
        stage = ki_comm._fill_stage(h, link, axis, x[0])
        for extra in ((), (rhobar, sim.f_eval)) if axis == 0 else ((),):
            for p in stage.plan.planes:
                p.zero_()
            a = cm.halo_fill(stage.plan, [v.clone() for v in x], *extra)
            planes = [p.clone() for p in stage.plan.planes]
            b = cm.halo_fill_plain(stage.plan, [v.clone() for v in x],
                                   *extra)
            assert _equal(a, b) and _equal(planes, stage.plan.planes)
            assert all(p.ne(0).any() for p in planes)
        crossed += len(stage.plan.planes)
        fields = [[getattr(sim.states[s], k) for s in own]
                  for k in ("r", "p", "gid", "n_atoms")]
        astage = ki_comm._atom_stage(h, link, axis, fields)
        got = cm.ring_push(astage.plan, fields)
        sets = [b.clone() for b in astage.plan.sets]
        want = cm.ring_push_plain(astage.plan, fields)
        for d, (_send, to) in enumerate(astage.plan.dirs):
            for j, t in enumerate(to):
                if t < len(own):
                    assert all(torch.equal(g[d, t], w[d, t])
                               for g, w in zip(got, want))
        assert _equal(sets, astage.plan.sets)
    assert crossed > 0
    assert (st.LAUNCHES["halo_fill_stage"], st.LAUNCHES["ring_push"]) == \
        (4, 3)


def _bit_equal(a, b):
    """Lists of float tensors equal bit for bit (-0.0 is not +0.0)."""
    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32
                      else torch.int64)
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def _position_case(dtype, grid, A, seed=4):
    """A 2x2x2 or 2x2x1 mesh on the card and positions [3, B, A] of its
    shards: the state's displaced where A is its own, noise at another A
    (an odd A: one slot a thread), halo rows of noise either way, the
    first slot of every local row -0.0."""
    sim = init_simulation(Config(
        nx=8, ny=8, nz=8, doeam=True, temperature=600.0, dtype=dtype,
        pot_dir=POTS, device="cuda", xproc=grid[0], yproc=grid[1],
        zproc=grid[2]))
    nl = sim.geom.n_local
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = []
    for s in sim.states:
        x = 20 * torch.rand((3, s.r.shape[1], A), dtype=sim.dtype,
                            device="cuda", generator=gen) - 5
        if A == s.r.shape[2]:
            x[:, :nl] = s.r[:, :nl] + 0.5 * x[:, :nl] / 20
        x[:, :nl, 0] = -0.0     # a copy with no shift keeps the sign of 0
        r.append(x)
    return sim, r


@pytest.mark.parametrize("A", [16, 13])
@pytest.mark.parametrize("grid", [(2, 2, 2), (2, 2, 1)],
                         ids=["2x2x2", "2x2x1"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_position_fill_matches_plain(cuda_device, dtype, grid, A):
    """The ghost-position refresh in one launch over the composed map
    against its plain version and the staged exchange.exchange_positions,
    bit for bit (on 2x2x1 a shard is its own z neighbor); every halo row
    written, no local row touched."""
    sim, r = _position_case(dtype, grid, A)
    h, nl = sim.halo, sim.geom.n_local
    plan = ki_comm.position_plan(h, r[0])
    assert plan.vec == (16 if A % 4 == 0 or dtype == "float64" and A % 2 == 0
                        else r[0].element_size())
    st.reset_launch_counts()
    got = cm.position_fill(plan, [x.clone() for x in r])
    assert st.LAUNCHES["position_fill"] == 1
    plain = cm.position_fill_plain(plan, [x.clone() for x in r])
    staged = exchange.exchange_positions(h, [x.clone() for x in r])
    assert _bit_equal(got, plain) and _bit_equal(got, staged)
    assert all(_bit_equal([a[:, :nl]], [b[:, :nl]]) and
               (a[:, nl:] != b[:, nl:]).all() for a, b in zip(got, r))


def test_position_fill_replayed_in_a_cuda_graph(cuda_device):
    """The refresh launch captured in a CUDA graph and replayed twice from
    the restored positions: each replay equals the plain version."""
    from comd_tpu_torch.stepgraph import cuda_capture
    sim, r = _position_case("float32", (2, 2, 2), 16)
    plan = ki_comm.position_plan(sim.halo, r[0])
    want = cm.position_fill_plain(plan, [x.clone() for x in r])
    work = [x.clone() for x in r]
    cm.position_fill(plan, work)
    graph = cuda_capture(lambda: cm.position_fill(plan, work),
                         torch.cuda.graph_pool_handle())[0]
    for _ in range(2):
        for w, x in zip(work, r):
            w.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert _bit_equal(work, want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_position_stages_into_planes_match_plain(cuda_device, dtype, n):
    """The refresh's stages across processes, process 0's view of a 2x2x2
    mesh on n processes, with local scratch planes: each stage launch
    writes this process's positions and the other processes' planes
    (shifted on the sender) exactly as its plain version does."""
    sim, r = _position_case(dtype, (2, 2, 2), 16)
    mesh = make_mesh(2, 2, 2, cuda_device, nprocs=n, proc=0)
    h = exchange.make_halo(mesh, sim.geom, sim.maps, sim.plan, sim.dtype)
    own = [r[s] for s in mesh.owned]
    link = _scratch_link(h, own[0].shape[2], sim.dtype)
    crossed = 0
    st.reset_launch_counts()
    for axis in range(3):
        stage = ki_comm._position_stage(h, link, axis, own[0])
        for p in stage.plan.planes:
            p.zero_()
        a = cm.position_fill(stage.plan, [v.clone() for v in own])
        planes = [p.clone() for p in stage.plan.planes]
        b = cm.position_fill_plain(stage.plan, [v.clone() for v in own])
        assert _bit_equal(a, b) and _bit_equal(planes, stage.plan.planes)
        assert all(p.ne(0).any() for p in planes)
        crossed += len(planes)
    assert crossed > 0
    assert st.LAUNCHES["position_fill_stage"] == 3


@pytest.mark.parametrize("comm_impl", ["ki", "ki_fused"])
def test_transports_bit_equal_on_card(cuda_device, comm_impl):
    """Eager f64 steps (an atom exchange every step) on the full-shell K1,
    whose sums are deterministic: the halo kernels give the collective
    run's bits, with one fill launch a step under every transport and
    three atom-stage launches a step (ring_push under ki and ki_fused,
    atom_pack under collective)."""
    sims = []
    for ci in ("collective", comm_impl):
        sim = init_simulation(Config(dtype="float64", lazy_shell=False,
                                     comm_impl=ci, device="cuda", **TRAJ))
        st.reset_launch_counts()
        sim.step_block(5)
        assert (st.LAUNCHES["halo_fill"], st.LAUNCHES["ring_push"],
                st.LAUNCHES["atom_pack"]) == (
            (5, 0, 15) if ci == "collective" else (5, 15, 0))
        sims.append(sim)
    assert sims[1].e_potential == sims[0].e_potential
    for x, y in zip(*[s.states for s in sims]):
        for k in ("r", "p", "f", "gid", "n_atoms"):
            assert torch.equal(getattr(x, k), getattr(y, k)), k


def _hold_window(got, want, scale, n_cols):
    """The window kernel's sums against the plain version's first
    ``n_cols`` columns (another summation order, FMA contraction in the
    Clenshaw chains): every element within 1e-5 of the sum of its terms'
    magnitudes, every output within 1e-5 of its largest value, all finite."""
    want = [b[:, :n_cols] for b in want]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == (window.SLOTS, n_cols)
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert window.element_error(
        got, want, [s[:, :n_cols] for s in scale]) <= 1e-5


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("probe,lj,chunks", [(1, False, 2), (2, False, 1),
                                             (3, False, 2), (3, True, 2)])
def test_window_pair_matches_plain(cuda_device, probe, lj, chunks):
    """The probes' window kernel (P1, P2, P3 EAM and LJ) against its plain
    version; one launch a call, and two launches give the same bits (each
    output's terms are summed in one fixed order)."""
    sp = window.spec(probe, lj)
    rp = torch.from_numpy(window.make_inputs(probe, chunks)).to(cuda_device)
    st.reset_launch_counts()
    got = window.window_pair(rp, sp)
    assert st.LAUNCHES["window_pair"] == 1
    again = window.window_pair(rp, sp)
    assert len(got) == sp.n_out
    _hold_window(got, window.window_pair_plain(rp, sp),
                 window.window_pair_magnitude(rp, sp), chunks * window.CHUNK)
    assert _same_bits(got, again)
    assert st.LAUNCHES["window_pair"] == 2


@pytest.mark.parametrize("probe,span", [(1, 8.0), (2, 10.0), (3, 10.0)])
def test_window_pair_dense_input(cuda_device, probe, span):
    """Positions in a small box put most candidate pairs inside the cutoff
    (against ~1% at the probes' own), so every lane's list fills and each
    warp drains many times in its walk: the same checks and the same bits
    on two launches."""
    sp = window.spec(probe)
    L = window.make_inputs(probe, 2).shape[2]
    rng = np.random.RandomState(5)
    rp = torch.from_numpy(rng.uniform(0, span, (3, window.SLOTS, L)).astype(
        np.float32)).to(cuda_device)
    D = window.n_columns(sp, L)
    assert window.n_in_cutoff(rp, sp) > 0.3 * window.n_pairs(sp, D)
    got = window.window_pair(rp, sp)
    _hold_window(got, window.window_pair_plain(rp, sp),
                 window.window_pair_magnitude(rp, sp), D)
    assert _same_bits(got, window.window_pair(rp, sp))


@pytest.mark.parametrize("probe,lj,chunks,n_cols", [
    (1, False, 4, 1021), (3, False, 8, 2045), (3, True, 1, 253),
    (2, False, 1, 1)])
def test_window_pair_ragged_columns(cuda_device, probe, lj, chunks, n_cols):
    """A column count that is not a multiple of the plan's columns a block
    (P1 at 4 chunks: 2 a block, 4 offset groups; P3 at 8: 4 a block, 2
    groups; 253 and 1 columns: 1 a block, up to 8 groups)."""
    sp = window.spec(probe, lj)
    rp = torch.from_numpy(window.make_inputs(probe, chunks)).to(cuda_device)
    plan = cuda_probe.card_window_plan(rp.device.index, sp, window.SLOTS,
                                       rp.shape[2], n_cols)
    assert n_cols % plan.cols_per_block or plan.cols_per_block == 1
    got = cuda_probe.window_pair(rp, sp, n_cols)
    _hold_window(got, window.window_pair_plain(rp, sp),
                 window.window_pair_magnitude(rp, sp), n_cols)
    assert _same_bits(got, cuda_probe.window_pair(rp, sp, n_cols))


@pytest.mark.parametrize("scale", [lookup.SCALE, 1.0])
def test_lookups_match_plain_bitwise(cuda_device, scale):
    """P4's row lookup and P5's (= P6's) lane lookup against their plain
    versions bit for bit: the probes' tables and tables whose columns
    differ, an x length off the float4 width, 64 lanes (two column
    slices), indices past the table, x of one row and of a row count off
    the kernels' steps."""
    rng = np.random.default_rng(3)
    x4, t4 = (torch.from_numpy(a).to(cuda_device)
              for a in lookup.make_inputs(4, 1 << 16))
    t4b = torch.from_numpy(rng.normal(size=(512, 4)).astype(np.float32)
                           ).to(cuda_device)
    st.reset_launch_counts()
    for x in (x4, x4[:1001], x4 * 1.1 - 20.0, x4[:1], x4[:4 * 1003]):
        for tab in (t4, t4b):
            assert torch.equal(lookup.row_lookup(x, tab, scale),
                               lookup.row_lookup_plain(x, tab, scale))
    x5, t5 = (torch.from_numpy(a).to(cuda_device)
              for a in lookup.make_inputs(5, 1 << 16))
    t5b = torch.from_numpy(rng.normal(size=(512, 128)).astype(np.float32)
                           ).to(cuda_device)
    for x, tab in ((x5, t5), (x5, t5b), (x5[:, :64].contiguous(),
                                         t5b[:, :64].contiguous()),
                   (x5 * 1.1 - 20.0, t5b), (x5[:1], t5b), (x5[:317], t5b)):
        got = lookup.lane_lookup(x, tab, scale)
        assert torch.equal(got, lookup.lane_lookup_plain(x, tab, scale))
        assert torch.equal(lookup.onehot_lookup(x, tab, scale), got)
    assert (st.LAUNCHES["row_lookup"], st.LAUNCHES["lane_lookup"]) == (10,
                                                                       12)


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


@pytest.mark.parametrize("doeam", [True, False], ids=["eam", "lj"])
@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_k1_subsets_match_plain(cuda_device, dtype, impl, doeam):
    """K1 over the -a 1 interior and boundary cells of a 12^3 2x2x2 mesh's
    first shard (4^3 cells, 8 interior) against its plain version, zero
    outside its subset, one counted launch a subset; the two launches add
    up to the full one.  An empty subset (8^3: 2^3 cells a shard) launches
    nothing."""
    sim = _sim(dtype, impl, 12, "cuda", doeam=doeam, gpu_async=1, **MESH)
    maps, ev, nbr = sim.maps, sim.pair_eval, sim.maps.nbr_map
    r = sim.states[0].r
    assert sim.uses_split and maps.interior.n > 0
    f_atol, s_rtol, f_rtol = _tols(dtype)
    dfe = torch.rand(r.shape[1:], dtype=r.dtype, device=r.device)
    if doeam:
        calls = [(st.eam_pass1, st.eam_pass1_plain, (r, nbr, ev),
                  dict(want_energy=e)) for e in (True, False)]
        calls.append((lambda *a, **k: (st.eam_pass3(*a, **k),),
                      lambda *a, **k: (st.eam_pass3_plain(*a, **k),),
                      (r, nbr, ev, dfe), dict()))
    else:
        calls = [(st.lj_pass, st.lj_pass_plain, (r, nbr, ev),
                  dict(want_energy=e)) for e in (True, False)]
    for fn, plain, args, kw in calls:
        st.reset_launch_counts()
        parts = [fn(*args, boxes=b, **kw) for b in (maps.interior,
                                                    maps.boundary)]
        assert sum(st.LAUNCHES.values()) == 2
        full = fn(*args, **kw)
        for b, other, got in zip((maps.interior, maps.boundary),
                                 (maps.boundary, maps.interior), parts):
            want = plain(*args, boxes=b, **kw)
            _close(got[0], want[0], f_atol, f_rtol)
            for g, w in zip(got[1:], want[1:]):
                if w is not None:
                    np.testing.assert_allclose(g.cpu().numpy(),
                                               w.cpu().numpy(),
                                               rtol=s_rtol, atol=0)
            assert not bool(got[0].index_select(1, other.index).any())
        for a, b, c in zip(*parts, full):
            if c is not None:
                _close(a + b, c, f_atol, f_rtol)
    empty = _sim(dtype, impl, 8, "cuda", doeam=doeam, gpu_async=1, **MESH)
    assert empty.maps.interior.n == 0
    st.reset_launch_counts()
    r8 = empty.states[0].r
    out = (st.eam_pass1 if doeam else st.lj_pass)(
        r8, empty.maps.nbr_map, empty.pair_eval, boxes=empty.maps.interior)
    assert sum(st.LAUNCHES.values()) == 0 and not bool(out[0].any())


def test_split_card_matches_cpu(cuda_device):
    """10 f64 lazy steps of the -a 1 mesh (12^3, 2x2x2, ki_fused) on the
    card against the same run on the CPU (plain versions): summation order
    only; every force two K1 launches a pass, each over every shard."""
    kw = dict(TRAJ, nx=12, ny=12, nz=12, dtype="float64", gpu_async=1,
              comm_impl="ki_fused")
    cpu = init_simulation(Config(device="cpu", **kw))
    st.reset_launch_counts()
    gpu = init_simulation(Config(device="cuda", **kw))
    cpu.step_block(10)
    gpu.step_block(10)
    assert st.LAUNCHES["eam_pass1"] == st.LAUNCHES["eam_pass3"] == 2 * 11
    assert gpu.n_rebucket == cpu.n_rebucket
    for c, g in zip(cpu.states, gpu.states):
        assert torch.equal(g.gid.cpu(), c.gid)
        for k in ("r", "p"):
            np.testing.assert_allclose(getattr(g, k).cpu().numpy(),
                                       getattr(c, k).numpy(), rtol=0,
                                       atol=1e-10)
    assert gpu.e_potential == pytest.approx(cpu.e_potential, rel=1e-12)


def _nl_sim(dtype, impl="cheb", doeam=True, **kw):
    """A thermalized 8^3 neighbor-list run on the card (A = 32 classic
    cells, K = 96 EAM / 160 LJ)."""
    return _sim(dtype, impl, 8, "cuda", doeam=doeam,
                method="thread_atom_nl", **kw)


def _crowd(sim):
    """sim's state with one local cell emptied and another filled to its
    capacity A (the extra atoms beside its first one), halo refreshed:
    (r, n_atoms)."""
    s = sim.state
    r, gid, n_atoms = s.r.clone(), s.gid.clone(), s.n_atoms.clone()
    A = r.shape[2]
    n = n_atoms[:sim.geom.n_local]
    full = int(torch.argmax(torch.where(n < A, n, -1)))
    empty = (full + sim.geom.n_local // 2) % sim.geom.n_local
    k = int(n_atoms[full])
    g = torch.Generator().manual_seed(7)
    shift = (torch.rand((3, A - k), generator=g, dtype=torch.float64)
             - 0.5).to(r) * 1.5
    r[:, full, k:] = r[:, full, :1] + shift
    n_atoms[full] = A
    r[:, empty] = binning.EMPTY_POS
    n_atoms[empty] = 0
    binning.fill_halo_serial(sim.geom, sim.maps, r, gid, n_atoms)
    return r, n_atoms


@pytest.mark.parametrize("case", ["thermal", "crowded", "lj5sigma"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("split", [False, True])
def test_nl_build_matches_plain(cuda_device, dtype, split, case):
    """NL1: lists, counts and overflow flag bit for bit, with and without
    the -a 1 row split, and with a K too small (overflow set, the first K
    entries still equal); one launch a call.  Cases: a thermalized 8^3 EAM
    state; the same with an empty cell and a cell at its capacity A; 5-sigma
    LJ -L (A = 256, 27 A candidates staged in chunks)."""
    if case == "lj5sigma":
        sim = _sim(dtype, "auto", 8, "cuda", doeam=False,
                   lj_cutoff_factor=5.0, use_pairlist=True)
        assert 27 * sim.cfg.max_atoms > 1024      # NL1's staging chunk
    else:
        sim = _nl_sim(dtype)
    s = sim.state
    r, n_atoms = _crowd(sim) if case == "crowded" else (s.r, s.n_atoms)
    params = sim.nl_build_params()
    row_split = nlmod.row_split_for(sim.geom, sim.cfg.max_atoms) \
        if split else None
    n_rows = (row_split[1] + row_split[2]) if split else params["n_rows"]
    a_list, a_valid, start = nlmod.nl_rows_plain(sim.geom, n_atoms,
                                                 r.shape[2], n_rows,
                                                 row_split)
    for k in (params["k"], 8):
        st.reset_launch_counts()
        got = cuda_nl.nl_build(r, a_list, a_valid, sim.maps.nbr_map,
                               n_atoms, row_start=start, k=k,
                               rcut2=params["rcut2"])
        assert st.LAUNCHES["nl_build"] == 1
        want = cuda_nl.nl_build_plain(r, a_list, a_valid,
                                      sim.maps.nbr_map, n_atoms, k=k,
                                      rcut2=params["rcut2"])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert bool(got[2]) == (k == 8)
        if case == "crowded":
            assert int(want[1].max()) > 0


def _nl_list(sim, lists):
    """sim's own list ("built"), or one built by the plain NL1 on its
    state with K = 8, every valid row overflowing ("k8"), or with the -a 1
    row split ("split")."""
    if lists == "built":
        return sim.nlist
    s, p = sim.state, sim.nl_build_params()
    row_split = None
    n_rows, k = p["n_rows"], p["k"]
    if lists == "split":
        row_split = nlmod.row_split_for(sim.geom, sim.cfg.max_atoms)
        n_rows = row_split[1] + row_split[2]
    else:
        k = 8
    a_list, a_valid, start = nlmod.nl_rows_plain(sim.geom, s.n_atoms,
                                                 s.r.shape[2], n_rows,
                                                 row_split)
    nl, count, _o = cuda_nl.nl_build_plain(s.r, a_list, a_valid,
                                           sim.maps.nbr_map, s.n_atoms, k=k,
                                           rcut2=p["rcut2"])
    if lists == "k8":
        assert bool((count[a_valid] > k).all())   # no padding in any row
    return nlmod.NeighborList(a_list=a_list, a_valid=a_valid, nl=nl,
                              last_r=s.r, row_start=start)


def _nl_sweeps(sim, lists="built"):
    """(name, kernel call, plain call) of every NL2 variant on sim's state
    and list (EAM: pass 1 with and without energy, pass 3; LJ: with and
    without energy)."""
    s, ev = sim.state, sim.pair_eval
    lst = _nl_list(sim, lists)
    if not sim.is_eam:
        return [(f"lj {e}", lambda e=e: cuda_nl.lj_pass(lst, s.r, ev,
                                                        want_energy=e),
                 lambda e=e: cuda_nl.lj_pass_plain(lst, s.r, ev,
                                                   want_energy=e))
                for e in (True, False)]
    _f, _phi, rho = cuda_nl.eam_pass1_plain(lst, s.r, ev)
    dfe = nlmod.scatter_rows(lst, sim.f_eval(rho)[1], *s.r.shape[1:])
    binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
    return [(f"pass1 {e}", lambda e=e: cuda_nl.eam_pass1(lst, s.r, ev,
                                                         want_energy=e),
             lambda e=e: cuda_nl.eam_pass1_plain(lst, s.r, ev,
                                                 want_energy=e))
            for e in (True, False)] + [
        ("pass3", lambda: (cuda_nl.eam_pass3(lst, s.r, ev, dfe),),
         lambda: (cuda_nl.eam_pass3_plain(lst, s.r, ev, dfe),))]


@pytest.mark.parametrize("lists", ["built", "k8", "split"])
@pytest.mark.parametrize("doeam", [True, False], ids=["eam", "lj"])
@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_nl_sweep_matches_plain(cuda_device, dtype, impl, doeam, lists):
    """NL2 against its plain version per row (invalid rows zero in both),
    the same bits on two launches, one launch a call; on the run's own
    list, on a K = 8 list whose rows have no padding (the early stop's
    edge) and on a list built with the -a 1 row split."""
    sim = _nl_sim(dtype, impl, doeam)
    f_atol, s_rtol, f_rtol = _tols(dtype)
    for name, kern, plain in _nl_sweeps(sim, lists):
        st.reset_launch_counts()
        got = kern()
        assert st.LAUNCHES["nl_sweep"] == 1, name
        want = plain()
        assert len(got) == len(want), name
        _close(got[0], want[0], f_atol, f_rtol)
        for g, w in zip(got[1:], want[1:]):
            assert (g is None) == (w is None), name
            if g is not None:
                _close(g, w, 0.0, s_rtol)
        again = kern()
        assert all(a is b or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("split,case", [
    (False, "thermal"), (True, "thermal"), (False, "crowded"),
    (True, "crowded"), (False, "short")])
def test_nl_rows_matches_plain(cuda_device, split, case):
    """NR (nl_rows: the scan and the fill) against nl_rows_plain bit for
    bit, with and without the -a 1 row split (the boundary mask on the
    card), new tensors and in place over poisoned ones, one count a call:
    a thermalized 8^3 state, the same with an empty cell and cells at and
    past A, and a row capacity a quarter of the slots (no split)."""
    sim = _nl_sim("float32")
    if case == "crowded":
        _r, n_atoms = _crowd(sim)
        n_atoms = n_atoms.clone()
        n_atoms[sim.geom.n_local // 5] = sim.cfg.max_atoms + 4
    else:
        n_atoms = sim.state.n_atoms
    A = sim.cfg.max_atoms
    row_split = None
    if split:
        is_b, ri, rb = nlmod.row_split_for(sim.geom, A)
        row_split = (torch.as_tensor(is_b, device="cuda"), ri, rb)
    n_rows = nlmod.n_rows_for(sim.geom, A, 0.25 if case == "short" else 1.0)
    want = nlmod.nl_rows_plain(sim.geom, n_atoms, A, n_rows, row_split)
    st.reset_launch_counts()
    got = cuda_nl.nl_rows(sim.geom, n_atoms, A, n_rows, row_split)
    out = tuple(torch.full_like(w, 3) if w.dtype != torch.bool
                else torch.ones_like(w) for w in want)
    again = cuda_nl.nl_rows(sim.geom, n_atoms, A, n_rows, row_split,
                            out=out)
    assert st.LAUNCHES["nl_rows"] == 2
    assert all(a is b for a, b in zip(again, out))
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.equal(a, w)


def _rows_state(n_local: int, A: int, seed: int, split: bool,
                factor: float = 1.0, short: bool = False):
    """Synthetic counts of ``n_local`` cells and seven halo cells, drawn
    from [-2, A + 5] with a numpy seed, one cell emptied, on the card;
    with ``split`` a random boundary mask (boundary cells in every tile)
    and row_split_for's capacities (``short``: the interior one half its
    rows).  Returns (geom, n_atoms [B] int32, row_split | None, n_rows)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(-2, A + 6, size=n_local + 7).astype(np.int32)
    n[n_local // 3] = 0
    geom = types.SimpleNamespace(n_local=n_local)
    n_atoms = torch.from_numpy(n).cuda()

    def pad(k):
        return max(128, -(-k // 128) * 128)

    if not split:
        return geom, n_atoms, None, pad(int(n_local * A * factor))
    is_b = rng.random(n_local) < 0.4
    ri = pad(int((~is_b).sum()) * A)
    if short:
        ri = max(1, int(np.clip(n[:n_local], 0, A)[~is_b].sum()) // 2)
    rb = pad(int(is_b.sum()) * A)
    return (geom, n_atoms, (torch.from_numpy(is_b).cuda(), ri, rb),
            ri + rb)


def _unaligned(t):
    """A copy of ``t`` one element into a larger tensor: contiguous, not
    16-byte aligned."""
    big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    big[1:] = t
    return big[1:]


@pytest.mark.parametrize("n_local,A,split,factor,short", [
    (1300, 32, False, 1.0, False), (1300, 32, True, 1.0, False),
    (1300, 32, False, 0.25, False), (1300, 13, True, 1.0, False),
    (100, 32, True, 1.0, False), (100, 32, False, 1.0, False),
    (700, 40, True, 1.0, False), (700, 40, False, 0.25, False),
    (1300, 32, True, 1.0, True), (1, 32, False, 1.0, False)])
def test_nl_rows_tiles_match_plain(cuda_device, n_local, A, split, factor,
                                   short):
    """NR's tiled form against nl_rows_plain bit for bit on synthetic
    counts: several 128-cell tiles with a partial last one (1300 cells)
    and fewer cells than a tile (100, 1), the -a 1 split with boundary cells in every tile (a boundary
    segment starting mid-tile), counts past A, negative and zero, a
    capacity a quarter of the slots, an interior capacity below its
    count, A = 13 (16-lane segments) and A = 40 (a thread a slot); new
    tensors, twice in place over poisoned ones (the same bits: the tile
    sums are rewritten every build), and into views that are not 16-byte
    aligned, from unaligned counts and mask (the scalar loads and
    stores); one count a call."""
    geom, n_atoms, row_split, n_rows = _rows_state(n_local, A, 3 + n_local,
                                                   split, factor, short)
    want = nlmod.nl_rows_plain(geom, n_atoms, A, n_rows, row_split)
    st.reset_launch_counts()
    outs = [cuda_nl.nl_rows(geom, n_atoms, A, n_rows, row_split)]
    out = tuple(torch.full_like(w, 3) if w.dtype != torch.bool
                else torch.ones_like(w) for w in want)
    for _ in range(2):
        got = cuda_nl.nl_rows(geom, n_atoms, A, n_rows, row_split, out=out)
        assert all(g is o for g, o in zip(got, out))
        outs.append(tuple(g.clone() for g in got))
    views = tuple(_unaligned(torch.full_like(w, 5) if w.dtype != torch.bool
                             else torch.ones_like(w)) for w in want)
    split_view = None if row_split is None else (
        _unaligned(row_split[0]),) + row_split[1:]
    outs.append(cuda_nl.nl_rows(geom, _unaligned(n_atoms), A, n_rows,
                                split_view, out=views))
    assert st.LAUNCHES["nl_rows"] == 4
    for got in outs:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("A", [32, 30, 13, 40])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_embed_rows_forms_match_plain(cuda_device, dtype, A):
    """ER's vector form (16 bytes of slots: A = 32 by a shift, A = 40 in
    f32 and A = 30 in f64 by a divide) and its scalar form (A = 13, and A
    = 30 in f32) against embed_rows_plain bit for bit, on NR's plain lists
    of 1300 synthetic cells (counts past A, negative and zero), with and
    without the -a 1 split: with and without energy (U in f64 and f32),
    the serial fill from random local sources and zero halo rows, rho
    and phi in one segment and in two cut inside a cell's vector, an
    a_valid that is not 16-byte aligned (U's byte loads); two launches
    give the same bits; one launch a call."""
    from comd_tpu_torch.ops.cuda import LAUNCHES
    sim = _nl_sim(dtype)
    f = sim.f_eval
    hi = sim.pot.f.x0 + (sim.pot.f.n - 1) / sim.pot.f.inv_dx
    tdt = sim.state.r.dtype
    rng = np.random.default_rng(A)
    n_local, B = 1300, 1307
    for split in (False, True):
        geom, n_atoms, row_split, R = _rows_state(n_local, A, 17 + A, split)
        a_list, a_valid, row_start = nlmod.nl_rows_plain(
            geom, n_atoms, A, R, row_split)
        v = a_valid.cpu().numpy()
        rho = torch.as_tensor(np.where(v, rng.uniform(0.0, 1.1 * hi, R), 0),
                              dtype=tdt, device="cuda")
        phi = torch.as_tensor(np.where(v, rng.uniform(-1.0, 0.5, R), 0),
                              dtype=tdt, device="cuda")
        # a cut two rows into a cell with at least four rows
        full = int(np.flatnonzero(np.clip(n_atoms[:n_local].cpu().numpy(),
                                          0, A) >= 4)[5])
        cut = int(row_start[full]) + 2
        halo = torch.as_tensor(rng.integers(0, n_local, B - n_local),
                               dtype=torch.int64, device="cuda")
        for valid in (a_valid, _unaligned(a_valid)):
            lst = nlmod.NeighborList(
                a_list=a_list, a_valid=valid,
                nl=torch.zeros((R, 1), dtype=torch.int32, device="cuda"),
                last_r=torch.empty((3, B, A), dtype=tdt, device="cuda"),
                row_start=row_start)
            for energy in (True, False):
                for src in (halo, None):
                    for segs in ((lambda x: (x,)),
                                 (lambda x: (x[:cut].clone(),
                                             x[cut:].clone()))):
                        for e_dtype in (torch.float64, torch.float32):
                            args = (f, lst, n_atoms, segs(rho),
                                    segs(phi) if energy else None, n_local,
                                    B, src, e_dtype)
                            want = nlmod.embed_rows_plain(*args)
                            n0 = LAUNCHES["embed_rows"]
                            got = step_ops.embed_rows(*args)
                            again = step_ops.embed_rows(*args)
                            assert LAUNCHES["embed_rows"] == n0 + 2
                            for g in (got, again):
                                assert torch.equal(g[0], want[0])
                                assert (g[1] is None) == (not energy)
                                if energy:
                                    assert g[1].dtype == e_dtype
                                    assert torch.equal(g[1], want[1])


def _row_ops_inputs(sim, split: bool, seed: int):
    """A list of sim's state (the plain build, with or without the row
    split) and per-row rho, phi and two force passes as NL2 leaves them
    (0 on invalid rows; the first pass's planes strided as pass 1's
    [5, R] output), from a numpy seed."""
    s, p = sim.state, sim.nl_build_params()
    A = sim.cfg.max_atoms
    row_split = nlmod.row_split_for(sim.geom, A) if split else None
    lst, _o = nlmod.build(sim.geom, sim.maps.nbr_map, s.r, s.n_atoms,
                          k=p["k"], rcut2=p["rcut2"], n_rows=p["n_rows"],
                          row_split=row_split)
    R = lst.a_list.shape[0]
    rng = np.random.default_rng(seed)
    v = lst.a_valid.cpu().numpy()
    f = sim.pot.f
    hi = f.x0 + (f.n - 1) / f.inv_dx

    def rows(x):
        return torch.as_tensor(np.where(v, x, 0.0), dtype=s.r.dtype,
                               device="cuda")

    rho = rows(rng.uniform(0.0, 1.1 * hi, R))
    phi = rows(rng.uniform(-1.0, 0.5, R))
    f1 = rows(rng.normal(size=(5, R)))[:3]
    f3 = rows(rng.normal(size=(3, R)))
    cut = row_split[1] if split else R // 3
    return lst, rho, phi, f1, f3, cut


def _two(x, cut):
    return (x[..., :cut].clone(), x[..., cut:].clone())


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_embed_rows_matches_plain(cuda_device, dtype, impl, split):
    """ER against embed_rows_plain on the same CUDA tensors, bit for bit:
    with and without energy, the serial fill and zero halo rows, rows in
    one segment and in two (the split's interior and boundary, or a cut
    at R/3), the energy in f64 and f32; one launch a call."""
    from comd_tpu_torch.ops.cuda import LAUNCHES
    sim = _nl_sim(dtype, impl)
    lst, rho, phi, _f1, _f3, cut = _row_ops_inputs(sim, split, 3)
    s, nl = sim.state, sim.geom.n_local
    B = s.r.shape[1]
    for energy in (True, False):
        for halo in (sim.maps.halo_src, None):
            for segs in ((lambda x: (x,)), (lambda x: _two(x, cut))):
                for e_dtype in (torch.float64, torch.float32):
                    args = (sim.f_eval, lst, s.n_atoms, segs(rho),
                            segs(phi) if energy else None, nl, B, halo,
                            e_dtype)
                    n0 = LAUNCHES["embed_rows"]
                    got = step_ops.embed_rows(*args)
                    assert LAUNCHES["embed_rows"] == n0 + 1
                    want = nlmod.embed_rows_plain(*args)
                    assert torch.equal(got[0], want[0])
                    assert (got[1] is None) == (want[1] is None) == \
                        (not energy)
                    if energy:
                        assert got[1].dtype == e_dtype
                        assert torch.equal(got[1], want[1])
                        assert got[1].sum().item() == want[1].sum().item()


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_land_rows_matches_plain(cuda_device, dtype, impl, split):
    """LR against land_rows_plain on the same CUDA tensors, bit for bit:
    one and two passes, with the kick (and the count, also added to an
    earlier shard's) and without (f only), rows in one segment and in
    two; one launch a call."""
    from comd_tpu_torch.ops.cuda import LAUNCHES
    sim = _nl_sim(dtype, impl)
    lst, _rho, _phi, f1, f3, cut = _row_ops_inputs(sim, split, 5)
    s, nl = sim.state, sim.geom.n_local
    kick = sim._c(0.5 * sim.cfg.dt)
    for two in (True, False):
        for segs in ((lambda x: (x,)), (lambda x: _two(x, cut))):
            parts = (segs(f1),) + ((segs(f3),) if two else ())
            for k, add in ((kick, False), (kick, True), (None, False)):
                outs = []
                for fn in (step_ops.land_rows, nlmod.land_rows_plain):
                    f = torch.full_like(s.f, float("nan"))
                    p = s.p.clone()
                    n_out = torch.full((), 7, dtype=torch.int32,
                                       device="cuda")
                    n0 = LAUNCHES["land_rows"]
                    fn(f, p, lst, s.n_atoms, parts, n_out, nl, k, add)
                    assert LAUNCHES["land_rows"] == n0 + (
                        fn is step_ops.land_rows)
                    outs.append((f, p, n_out))
                (fk, pk, nk), (fp, pp, np_) = outs
                assert torch.equal(fk, fp) and torch.equal(pk, pp)
                assert int(nk) == int(np_)
                if k is None:
                    assert torch.equal(pk, s.p) and int(nk) == 7


@pytest.mark.parametrize("comm_impl", ["ki", "collective"])
def test_nl_card_matches_cpu(cuda_device, comm_impl):
    """20 f64 thread_atom_nl EAM steps through a rebuild on the card (NL1,
    NL2) against the CPU (plain versions) from one state, serial and on a
    2x2x2 mesh (the -a auto row split): summation order only."""
    for mesh in ({}, MESH):
        kw = dict(nx=8, ny=8, nz=8, doeam=True, temperature=1200.0,
                  initial_delta=0.1, dtype="float64",
                  method="thread_atom_nl", pot_dir=POTS, **mesh)
        cpu = init_simulation(Config(device="cpu", **kw))
        gpu = init_simulation(Config(device="cuda", comm_impl=comm_impl,
                                     **kw))
        for sim in (cpu, gpu):
            sim.step_block(10)
            sim.step_block(10)
        assert gpu.n_nl_build == cpu.n_nl_build >= 2
        assert gpu.e_potential == pytest.approx(cpu.e_potential, rel=1e-12)
        assert gpu.sum_atoms() == cpu.n_global and not gpu.overflow


def test_nl_golden_on_card(cuda_device):
    sim = init_simulation(Config(nx=6, ny=6, nz=6, doeam=True,
                                 method="thread_atom_nl", temperature=0.0,
                                 dtype="float64", pot_dir=POTS,
                                 device="cuda"))
    assert sim.e_potential / sim.n_global == pytest.approx(GOLDEN_EAM_ADAMS,
                                                           abs=1e-9)


# --------------------------------------------------------------------------
# the -P spline and -I LJ-table variants of K1, K2 and NL2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("half", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spline_kernels_match_plain(cuda_device, dtype, half):
    """K1's and K2's -P spline variants, EAM passes 1 (with and without
    energy) and 3, at the stencil tolerances; counted apart from the other
    evaluators; K1 the same bits on two launches."""
    sim = _sim(dtype, "auto", 8, "cuda", spline=True, half_shell=half)
    assert sim.pair_eval.kind == "spline"
    r, ev = sim.state.r, sim.pair_eval
    nbr = sim.maps.half_nbr_map if half else sim.maps.nbr_map
    p1, p1_plain, p3, p3_plain = (
        (st.eam_pass1_half, st.eam_pass1_half_plain, st.eam_pass3_half,
         st.eam_pass3_half_plain) if half else
        (st.eam_pass1, st.eam_pass1_plain, st.eam_pass3, st.eam_pass3_plain))
    f_atol, s_rtol, f_rtol = _tols(dtype)
    st.reset_launch_counts()
    fp, pp, rp = p1_plain(r, nbr, ev, want_energy=True)
    for energy in (True, False):
        got = p1(r, nbr, ev, want_energy=energy)
        _close(got[0], fp, f_atol, f_rtol)
        _close(got[2], rp, 0.0, s_rtol)
        if energy:
            _close(got[1], pp, 0.0, s_rtol)
        else:
            assert got[1] is None
        if not half:
            again = p1(r, nbr, ev, want_energy=energy)
            assert _same(got, again)
    dfe = _dfe(sim, r)
    f3 = p3(r, nbr, ev, dfe)
    _close(f3, p3_plain(r, nbr, ev, dfe), f_atol, f_rtol)
    pre = "spline_half_" if half else "spline_"
    n1 = 2 if half else 4
    assert (st.LAUNCHES[pre + "eam_pass1"], st.LAUNCHES[pre + "eam_pass3"]) \
        == (n1, 1)
    assert st.LAUNCHES["eam_pass1"] == st.LAUNCHES["half_eam_pass1"] == 0


@pytest.mark.parametrize("lists", ["built", "k8", "split"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nl_sweep_spline_matches_plain(cuda_device, dtype, lists):
    """NL2's -P spline variant against its plain version per row, the
    same bits on two launches, counted as nl_sweep_spline."""
    sim = _nl_sim(dtype, "auto", spline=True)
    f_atol, s_rtol, f_rtol = _tols(dtype)
    for name, kern, plain in _nl_sweeps(sim, lists):
        st.reset_launch_counts()
        got = kern()
        assert (st.LAUNCHES["nl_sweep_spline"], st.LAUNCHES["nl_sweep"]) \
            == (1, 0), name
        want = plain()
        _close(got[0], want[0], f_atol, f_rtol)
        for g, w in zip(got[1:], want[1:]):
            assert (g is None) == (w is None), name
            if g is not None:
                _close(g, w, 0.0, s_rtol)
        assert all(a is b or torch.equal(a, b) for a, b in zip(got, kern()))


def _pair_rows(ev, dists, dtype):
    """One list row a pair at each distance of ``dists`` (along x, the
    pairs 20 A apart in z): (r [3, n, 2], NeighborList, dfEmbed [n, 2])."""
    n = len(dists)
    r = np.zeros((3, n, 2))
    r[2] = 20.0 * np.arange(n)[:, None]
    r[0, :, 1] = -np.asarray(dists, dtype=np.float64)
    r = torch.as_tensor(r, dtype=dtype, device="cuda")
    i = torch.arange(n, dtype=torch.int32, device="cuda") * 2
    nl = torch.stack([i + 1, i, i, i], dim=1).contiguous()
    valid = torch.ones_like(i, dtype=torch.bool)
    lst = nlmod.NeighborList(a_list=i, a_valid=valid, nl=nl, last_r=r,
                             row_start=torch.arange(n, dtype=torch.int32,
                                                    device="cuda"))
    d = np.random.default_rng(5).uniform(-100.0, -90.0, size=(n, 2))
    return r, lst, torch.as_tensor(d, dtype=dtype, device="cuda")


def _cutoff_distance(rcut2: float, np_dtype):
    """The largest distance d of ``np_dtype`` whose d * d (rounded) is
    within the cutoff: the pair at the cutoff."""
    d = np.sqrt(np_dtype(rcut2))
    while d * d > np_dtype(rcut2):
        d = np.nextafter(d, np_dtype(0))
    while np.nextafter(d, np_dtype(np.inf)) ** 2 <= np_dtype(rcut2):
        d = np.nextafter(d, np_dtype(np.inf))
    return d


@pytest.mark.parametrize("pot_type", ["funcfl", "setfl"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spline_index_at_knots_and_edges(cuda_device, dtype, pot_type):
    """The spline variant on single pairs (NL2 rows of one entry each) at
    the knots, next to x0 (r -> 0) and at the cutoff (Mishin's setfl
    tables end at the cutoff: r clipped to xn, the interval to n - 1):
    the same bits as the plain version, passes 1 and 3, so the kernel
    picks each pair's interval as the plain version does."""
    sim = init_simulation(Config(nx=4, ny=4, nz=4, doeam=True, spline=True,
                                 pot_type=pot_type, dtype=dtype,
                                 pot_dir=POTS, device="cuda"))
    ev = sim.pair_eval
    np_dtype = np.float32 if dtype == "float32" else np.float64
    dx = 1.0 / ev.inv_dx
    cut = _cutoff_distance(ev.rcut2, np_dtype)
    knots = [ev.x0 + k * dx for k in (1, 2, 3, ev.n // 2, ev.n - 1)]
    dists = [1e-3, 0.5 * dx] + [np_dtype(x) for x in knots
                                if x * x <= ev.rcut2] + [cut]
    if pot_type == "setfl":
        assert np_dtype(cut) * np_dtype(ev.inv_dx) >= ev.n - 1
    r, lst, dfe = _pair_rows(ev, dists, sim.dtype)
    for energy in (True, False):
        got = cuda_nl.eam_pass1(lst, r, ev, want_energy=energy)
        want = cuda_nl.eam_pass1_plain(lst, r, ev, want_energy=energy)
        assert _same(got, want), energy
    assert torch.equal(cuda_nl.eam_pass3(lst, r, ev, dfe),
                       cuda_nl.eam_pass3_plain(lst, r, ev, dfe))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lj_table_kernel_matches_plain(cuda_device, dtype):
    """K1's -I LJ-table variant with and without energy, one pair put at
    the cutoff, where the table index reaches n and the 4-point stencil
    reads the pad entry; the same bits on two launches; counted as
    lj_table; K2 and NL2 refuse the table (comd_tpu runs -I full shell
    and ignores it on the lists)."""
    sim = _sim(dtype, "auto", 6, "cuda", doeam=False, lj_interpolation=True)
    ev = sim.pair_eval
    assert ev.kind == "lj_table"
    np_dtype = np.float32 if dtype == "float32" else np.float64
    r = sim.state.r.clone()
    cut = _cutoff_distance(ev.rcut2, np_dtype)
    assert np.floor((cut - np_dtype(ev.x0)) * np_dtype(ev.inv_dx)) == ev.n
    r[:, 0, 1] = r[:, 0, 0]
    r[0, 0, 1] += float(cut)
    assert float(((r[:, 0, 1] - r[:, 0, 0]) ** 2).sum()) <= ev.rcut2
    nbr = sim.maps.nbr_map
    f_atol, s_rtol, f_rtol = _tols(dtype)
    st.reset_launch_counts()
    fp, ep = st.lj_pass_plain(r, nbr, ev)
    for energy in (True, False):
        got = st.lj_pass(r, nbr, ev, want_energy=energy)
        _close(got[0], fp, f_atol, f_rtol)
        if energy:
            _close(got[1], ep, 0.0, s_rtol)
        assert _same(got, st.lj_pass(r, nbr, ev, want_energy=energy))
    assert (st.LAUNCHES["lj_table"], st.LAUNCHES["lj"]) == (4, 0)
    with pytest.raises(ValueError, match="full shell"):
        st.lj_pass_half(r, sim.maps.half_nbr_map, ev)
    with pytest.raises(ValueError, match="analytic LJ"):
        cuda_nl.lj_pass(None, r, ev)


def test_multiproc_share_the_card(cuda_device):
    """Two processes sharing the card (gloo, every message staged through
    pinned host buffers), EAM f32 at 12^3 on 2x2x2 with 0.8 A
    displacements: process 0 prints the single process's printThings rows
    digit for digit, the other process prints nothing of the run.  The
    kernels are built here first, so the processes only load them."""
    from comd_tpu_torch.ops.cuda import stencil as st
    from test_torch_multiproc import launch, rows
    st.build()
    args = ["-e", "-x", "12", "-y", "12", "-z", "12", "-r", "0.8", "-N",
            "10", "-n", "5", "-i", "2", "-j", "2", "-k", "2"]
    single, outs = launch(2, args, device="cuda")
    for rc, _out, err in outs:
        assert rc == 0, err[-3000:]
    assert len(rows(single)) == 3 and rows(outs[0][1]) == rows(single)
    assert "2 processes (gloo, staged through pinned host buffers)" in \
        outs[0][1]
    assert not outs[1][1].strip()


# --------------------------------------------------------------------------
# the step's CUDA graphs (stepgraph.py) against the eager loop
# --------------------------------------------------------------------------

def _card_run(kw, graphs: bool, blocks=(10, 10)):
    sim = init_simulation(Config(temperature=1200.0, dtype="float32",
                                 pot_dir=POTS, device="cuda", **kw))
    sim.cuda_graphs = graphs
    sim.step_block(blocks[0])
    n_reb = sim.n_rebucket
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sim.step_block(blocks[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in got)
    return sim, syncs, sim.n_rebucket - n_reb


@pytest.mark.parametrize("kw", [
    dict(nx=10, ny=10, nz=10, doeam=True),
    dict(nx=10, ny=10, nz=10, doeam=True, method="thread_atom_nl"),
    dict(nx=10, ny=10, nz=10, doeam=True, comm_impl="ki_fused",
         xproc=2, yproc=2, zproc=2),
    dict(nx=10, ny=10, nz=10, doeam=True, comm_impl="collective",
         xproc=2, yproc=2, zproc=2),
    dict(nx=10, ny=10, nz=10, doeam=False),
    dict(nx=10, ny=10, nz=10, doeam=True, lazy_shell=False),
    dict(nx=10, ny=10, nz=10, doeam=True, lazy_shell=False,
         comm_impl="ki_fused", xproc=2, yproc=2, zproc=2, gpu_async=0),
    dict(nx=12, ny=12, nz=12, doeam=True, lazy_shell=False,
         comm_impl="ki_fused", xproc=2, yproc=2, zproc=2, gpu_async=1,
         initial_delta=0.8)],
    ids=["eam", "eam_nl", "mesh_ki_fused", "mesh_collective", "lj",
         "eam_S0", "mesh_S0_a0", "mesh_S0_a1"])
def test_graphs_equal_eager_on_card(cuda_device, kw):
    """The steps replayed as CUDA graphs against the eager loop of the same
    step functions: r, p, gid, counts, ePot and the rebucket count bit for
    bit (K1, NL2 and the halo kernels are deterministic); in a block once
    captured one host sync on the graph path (the rebucket counter's
    read; none on -S 0), the eager loop's trigger reads beside it."""
    (g, g_syncs, g_reb), (e, e_syncs, e_reb) = [
        _card_run(kw, graphs) for graphs in (True, False)]
    assert g._graphs is not None and g._graphs.replays > 0
    assert e._graphs is None
    states = (lambda s: s.states if hasattr(s, "states") else [s.state])
    for a, b in zip(states(g), states(e)):
        for k in ("r", "p", "gid", "n_atoms"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert g.e_potential == e.e_potential
    assert (g.n_rebucket, g_reb) == (e.n_rebucket, e_reb)
    lazy = kw.get("lazy_shell", True)
    assert g_syncs == (1 if lazy else 0)
    assert e_syncs == g_syncs + (10 if lazy else 0)


@pytest.mark.parametrize("shards", [1, 8])
def test_if_node_takes_its_branch(cuda_device, shards):
    """kick_drift_trigger sets the IF nodes' handles in a captured graph
    (no kernel of its own): each body runs at a replay exactly when the
    trigger (or its negation) holds, as the plain version takes the
    branch on the host; over a stack of eight shards in one launch, one
    shard displaced, the or of them."""
    from comd_tpu_torch.ops.cuda import graph_if
    from comd_tpu_torch.stepgraph import cuda_capture
    B, A, nl, skin = 40, 8, 27, 0.5
    shape = (shards, 3, B, A)
    zero = torch.zeros(shape, dtype=torch.float32, device=cuda_device)
    last = torch.stack([
        torch.rand(shape[1:], generator=torch.Generator().manual_seed(i))
        for i in range(shards)]).to(cuda_device)
    r = last.clone()
    hits = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    bodies = graph_if.BodyPool(cuda_device)
    step_ops.kick_drift_trigger(zero.clone(), r, zero, last, nl, 0.0,
                                0.0, skin)     # the scratch, made outside

    def step():
        cond = graph_if.condition(cuda_device)
        assert len(cond.handles) == 2
        cond.flag = step_ops.kick_drift_trigger(
            zero.clone(), r, zero, last, nl, 0.0, 0.0, skin,
            handles=cond.handles)
        graph_if.if_node(cond, 0, lambda: hits[0].add_(1), bodies)
        graph_if.if_node(cond, 1, lambda: hits[1].add_(1), bodies)

    graph = cuda_capture(step, torch.cuda.graph_pool_handle())[0]
    want = torch.zeros(2, dtype=torch.int32)
    moved = shards // 2                 # the one shard that may fire
    for d in (0.0, 0.3, 0.0, 0.2, 0.3):
        r[moved].copy_(last[moved])
        r[moved][0, nl // 2, 1] += d        # fires past skin/2 = 0.25
        graph.replay()
        fired = torch.tensor(d > 0.25)
        graph_if.if_node_plain(fired, lambda: want[0].add_(1))
        graph_if.if_node_plain(fired, lambda: want[1].add_(1), True)
    assert hits.cpu().tolist() == want.tolist() == [2, 3]


def _stack_equal(got, want) -> bool:
    if isinstance(got, torch.Tensor) or got is None:
        got, want = (got,), (want,)
    return all((a is None) == (b is None) and
               (a is None or (a.dtype == b.dtype and torch.equal(a, b)))
               for a, b in zip(got, want))


def _stack_of_results(outs):
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(None if outs[0][k] is None else
                 torch.stack([o[k] for o in outs])
                 for k in range(len(outs[0])))


@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_stacked_launches_equal_shard_launches(cuda_device, dtype, impl):
    """One launch over the stack of a 12^3 2x2x2 mesh's shards (8 interior
    cells a shard) against the 8 launches of S = 1 on the shards' slices,
    bit for bit: K1 passes 1 (with and without energy) and 3 and LJ over
    every cell and the -a 1 interior and boundary subsets, the head (its
    flag the or, one shard displaced), pass 2 (with and without energy,
    serial and zero halo, on K1's strided rhobar) and the landing (the
    count of every shard); K2 in f64, bit for bit where two runs of the
    S = 1 launches agree bit for bit with each other, else within 1e-12 of
    the largest value (K2's j side adds with atomics, in an order that
    changes from launch to launch).  Each stacked call is one counted
    launch."""
    from comd_tpu_torch.ops import force_lj
    from comd_tpu_torch.ops.cuda import LAUNCHES
    from comd_tpu_torch.potentials.lj import init_lj_pot
    from comd_tpu_torch.sim import stack_of
    sim = _sim(dtype, impl, 12, "cuda", xproc=2, yproc=2, zproc=2)
    S, nl, maps, ev = len(sim.states), sim.geom.n_local, sim.maps, \
        sim.pair_eval
    assert S == 8 and maps.interior.n > 0
    r, p, f, n_atoms = (stack_of(getattr(x, k) for x in sim.states)
                        for k in ("r", "p", "f", "n_atoms"))
    B = r.shape[2]
    dfe = (0.01 * r[:, 0]).contiguous()
    lj_ev = force_lj.make_lj_evaluator(init_lj_pot(2.5), r.dtype)

    def check(name, key, stacked, one):
        n0 = LAUNCHES[key]
        got = stacked()
        assert LAUNCHES[key] == n0 + 1, name
        assert _stack_equal(got, _stack_of_results([one(i)
                                                    for i in range(S)])), \
            name

    for boxes in (None, maps.interior, maps.boundary):
        for e in (True, False):
            check(f"pass 1 {e} {boxes and boxes.n}", "eam_pass1",
                  lambda: st.eam_pass1(r, maps.nbr_map, ev, want_energy=e,
                                       boxes=boxes),
                  lambda i: st.eam_pass1(r[i], maps.nbr_map, ev,
                                         want_energy=e, boxes=boxes))
            check(f"lj {e} {boxes and boxes.n}", "lj",
                  lambda: st.lj_pass(r, maps.nbr_map, lj_ev, want_energy=e,
                                     boxes=boxes),
                  lambda i: st.lj_pass(r[i], maps.nbr_map, lj_ev,
                                       want_energy=e, boxes=boxes))
        check(f"pass 3 {boxes and boxes.n}", "eam_pass3",
              lambda: st.eam_pass3(r, maps.nbr_map, ev, dfe, boxes=boxes),
              lambda i: st.eam_pass3(r[i], maps.nbr_map, ev, dfe[i],
                                     boxes=boxes))
    if dtype == "float64":
        hn = maps.half_nbr_map
        for name, key, stacked, one in (
                ("K2 pass 1", "half_eam_pass1",
                 lambda: st.eam_pass1_half(r, hn, ev),
                 lambda i: st.eam_pass1_half(r[i], hn, ev)),
                ("K2 pass 3", "half_eam_pass3",
                 lambda: st.eam_pass3_half(r, hn, ev, dfe),
                 lambda i: st.eam_pass3_half(r[i], hn, ev, dfe[i])),
                ("K2 LJ", "half_lj", lambda: st.lj_pass_half(r, hn, lj_ev),
                 lambda i: st.lj_pass_half(r[i], hn, lj_ev))):
            got = stacked()
            runs = [_stack_of_results([one(i) for i in range(S)])
                    for _ in range(2)]
            if _stack_equal(runs[0], runs[1]):
                assert _stack_equal(got, runs[0]), name
            else:    # the j side's atomics: the launches differ themselves
                for a, b in zip(got if isinstance(got, tuple) else (got,),
                                runs[0] if isinstance(runs[0], tuple)
                                else (runs[0],)):
                    if a is not None:
                        _close(a, b, 0.0, 1e-12)
    # the head: one shard displaced, so that the or fires
    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    last = r.clone()
    last[S // 2, 0, nl // 2, 0] += 2.0 * sim.skin
    pa, ra, pb, rb = p.clone(), r.clone(), p.clone(), r.clone()
    n0 = LAUNCHES["kick_drift_trigger"]
    flag = step_ops.kick_drift_trigger(pa, ra, f, last, nl, kick, drift,
                                       sim.skin)
    assert LAUNCHES["kick_drift_trigger"] == n0 + 1
    flags = [step_ops.kick_drift_trigger(pb[i], rb[i], f[i], last[i], nl,
                                         kick, drift, sim.skin)
             for i in range(S)]
    assert torch.equal(pa, pb) and torch.equal(ra, rb)
    assert bool(flag) and [bool(x) for x in flags] == [
        i == S // 2 for i in range(S)]
    # pass 2 on K1's rhobar, a view of its output
    _f1, phi, rho = st.eam_pass1(r, maps.nbr_map, ev)
    e_dtype = sim.cfg.torch_energy_dtype
    for energy in (True, False):
        for src in (None, maps.halo_src):
            ph = phi if energy else None
            check(f"embed_fill {energy} {src is not None}", "embed_fill",
                  lambda: step_ops.embed_fill(sim.f_eval, rho, ph, n_atoms,
                                              B, src, e_dtype),
                  lambda i: step_ops.embed_fill(
                      sim.f_eval, rho[i], None if ph is None else ph[i],
                      n_atoms[i], B, src, e_dtype))
    # the landing of two passes
    f3 = st.eam_pass3(r, maps.nbr_map, ev, dfe)
    fa, pa, fb, pb = f.clone(), p.clone(), f.clone(), p.clone()
    n_a = torch.zeros((), dtype=torch.int32, device=cuda_device)
    n_b = torch.zeros((), dtype=torch.int32, device=cuda_device)
    step_ops.land(fa, pa, _f1, f3, n_atoms, n_a, nl, kick)
    total = 0
    for i in range(S):
        step_ops.land(fb[i], pb[i], _f1[i], f3[i], n_atoms[i], n_b, nl,
                      kick)
        total += int(n_b)
    assert torch.equal(fa, fb) and torch.equal(pa, pb)
    assert int(n_a) == total == sim.n_global


def _step_ops_cases(sim):
    """(the step module, [(name, call)]) for csrc/step.cu's four kernels
    on clones of ``sim``'s state: ``call(fn)`` runs ``fn`` (a wrapper or
    its plain version) and returns the tensors it wrote.  kick_drift_trigger
    on the state and at the threshold (one slot displaced by exactly
    (skin/2)^2 in the dtype, for the run's skin and for 0.45 A),
    with the serial image map (also at an odd number of slots a row),
    refresh_halo (the positions alone, and the whole fill with gid and
    n_atoms, also at an odd number of slots), embed_fill with and without
    energy, serial and zero halo, land with one and two force passes."""
    from comd_tpu_torch.ops.cuda import step
    s, nl = sim.state, sim.geom.n_local
    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    skin = sim.skin
    last = s.r.clone()
    last[:, :nl] += 1e-2 * torch.sin(torch.arange(
        last[:, :nl].numel(), device=last.device,
        dtype=last.dtype)).reshape(last[:, :nl].shape)
    np_dtype = s.r.cpu().numpy().dtype

    def at_threshold(skin):
        """One slot displaced by (a, b, 0) with fl(fl(a a) + fl(b b))
        equal to (skin/2)^2 in the dtype, the others still."""
        thr = np_dtype.type((0.5 * skin) ** 2)
        a = np.sqrt(thr)
        for _ in range(8):
            a = np.nextafter(a, np_dtype.type(0))
            b = np.sqrt(thr - a * a) if a * a < thr else np_dtype.type(0)
            if a * a + b * b == thr:
                break
        assert a * a + b * b == thr
        at, at_last = s.r.clone(), s.r.clone()
        at[0, nl // 2, 0], at[1, nl // 2, 0] = float(a), float(b)
        at_last[0, nl // 2, 0], at_last[1, nl // 2, 0] = 0.0, 0.0
        return at, at_last
    zero = torch.zeros_like(s.p)
    rho = (s.r[0, :nl] - s.r[0, :nl].min()).abs().contiguous() * 0.05
    phi = s.r[1, :nl].contiguous()
    f1, f3 = s.r[:, :nl].contiguous(), s.p[:, :nl].contiguous()

    def kdt(fn, p, r, f, lst, skin=skin, images=None):
        p, r = p.clone(), r.clone()
        return (p, r, fn(p, r, f, lst, nl, kick, drift, skin,
                         images=images))

    def cut(x):
        """x [..., A] cut to A - 1 slots (odd where A is even)."""
        return x[..., :x.shape[-1] - 1].contiguous()

    def fill(fn, r, gid, n):
        r, gid, n = r.clone(), gid.clone(), n.clone()
        return (fn(sim.geom, sim.maps, r, gid, n), gid, n)

    def land(fn, two):
        f, p, n = s.f.clone(), s.p.clone(), s.n_local.clone()
        fn(f, p, f1, f3 if two else None, s.n_atoms, n, nl, kick)
        return f, p, n

    cases = [("kick_drift_trigger", lambda fn: kdt(fn, s.p, s.r, s.f, last)),
             ("kick_drift_trigger at the threshold",
              lambda fn, t=at_threshold(skin): kdt(fn, zero, t[0], zero,
                                                   t[1])),
             # (0.45/2)^2 rounds up in f32: a comparison in f64 would fire
             ("kick_drift_trigger at the rounded-up threshold",
              lambda fn, t=at_threshold(0.45): kdt(fn, zero, t[0], zero,
                                                   t[1], 0.45)),
             ("kick_drift_trigger images",
              lambda fn: kdt(fn, s.p, s.r, s.f, last,
                             images=sim.maps.images)),
             ("kick_drift_trigger images odd A",
              lambda fn: kdt(fn, cut(s.p), cut(s.r), cut(s.f), cut(last),
                             images=sim.maps.images)),
             ("refresh_halo",
              lambda fn: (fn(sim.geom, sim.maps, s.r.clone()),)),
             ("refresh_halo fill", lambda fn: fill(fn, s.r, s.gid,
                                                   s.n_atoms)),
             ("refresh_halo fill odd A",
              lambda fn: fill(fn, cut(s.r), cut(s.gid), s.n_atoms))]
    # an odd number of slots a row: embed_fill's one-slot form
    odd = rho.shape[1] - 1 - rho.shape[1] % 2
    rho_1, phi_1 = rho[:, :odd].contiguous(), phi[:, :odd].contiguous()
    for energy in (True, False):
        for src in (sim.maps.halo_src, None):
            cases.append((f"embed_fill energy={energy} "
                          f"serial={src is not None}",
                          lambda fn, e=energy, h=src: fn(
                              sim.f_eval, rho, phi if e else None,
                              s.n_atoms, s.r.shape[1], h)))
        cases.append((f"embed_fill energy={energy} serial=True odd A",
                      lambda fn, e=energy: fn(
                          sim.f_eval, rho_1, phi_1 if e else None,
                          s.n_atoms, s.r.shape[1], sim.maps.halo_src)))
    for two in (True, False):
        cases.append((f"land passes={1 + two}",
                      lambda fn, t=two: land(fn, t)))
    return step, cases


@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_step_kernels_match_plain(cuda_device, dtype, impl):
    """csrc/step.cu's kernels against their plain versions on the same
    CUDA tensors (thermalized 10^3 state), bit for bit, each launch
    counted; the trigger placed at the threshold does not fire."""
    from comd_tpu_torch.ops.cuda import LAUNCHES
    sim = _sim(dtype, impl, 10, "cuda")
    step, cases = _step_ops_cases(sim)
    for name, call in cases:
        key = name.split()[0]
        n0 = LAUNCHES[key]
        got = call(getattr(step, key))
        assert LAUNCHES[key] == n0 + 1, name
        want = call(getattr(step, key + "_plain"))
        for a, b in zip(got, want):
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), name
    for name, call in cases:
        if name.startswith("kick_drift_trigger at"):
            assert not bool(call(step.kick_drift_trigger)[2]), name


@pytest.mark.parametrize("dtype,impl", [("float32", "cheb"),
                                        ("float64", "rows")])
def test_trigger_images_in_a_graph_match_plain(cuda_device, dtype, impl):
    """The serial step's head as its graph holds it: one condition of one
    handle, the trigger launch with the image map setting it, one IF node;
    one replay writes p, r (every halo row) and the flag as the plain
    head does, bit for bit, and the body runs as the flag says."""
    from comd_tpu_torch.ops.cuda import graph_if
    from comd_tpu_torch.stepgraph import cuda_capture
    sim = _sim(dtype, impl, 10, "cuda")
    s, nl = sim.state, sim.geom.n_local
    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    box = int(torch.nonzero(s.n_atoms[:nl])[0])     # an occupied cell
    for moved in (0.0, sim.skin):
        last = s.r.clone()
        last[0, box, 0] += moved
        p, r = s.p.clone(), s.r.clone()
        hit = torch.zeros((), dtype=torch.int32, device=cuda_device)
        bodies = graph_if.BodyPool(cuda_device)
        out = {}

        def head():
            cond = graph_if.condition(cuda_device, 1)
            assert len(cond.handles) == 1
            out["flag"] = cond.flag = step_ops.kick_drift_trigger(
                p, r, s.f, last, nl, kick, drift, sim.skin,
                handles=cond.handles, images=sim.maps.images)
            graph_if.if_node(cond, 0, lambda: hit.add_(1), bodies)

        graph = cuda_capture(head, torch.cuda.graph_pool_handle())[0]
        graph.replay()
        torch.cuda.synchronize()
        pp, rp = s.p.clone(), s.r.clone()
        want = step_ops.kick_drift_trigger_plain(
            pp, rp, s.f, last, nl, kick, drift, sim.skin,
            images=sim.maps.images)
        assert torch.equal(p, pp) and torch.equal(r, rp)
        assert bool(out["flag"]) == bool(want) == (moved > 0)
        assert int(hit) == int(bool(want))
        del graph


def _rb_synthetic(lo, hi, A, dtype, seed, use_hilbert=False, spread=0.75,
                  fill=0.5, cut=4.0):
    """A domain [lo, hi) (cells of edge >= ``cut``) and its cells of
    capacity ``A`` on the card: up to ``fill * A`` atoms a local cell
    (random gids, unique), each within ``spread`` cell edges of its cell's
    centre per axis, junk in the other slots.  Returns (geom, maps,
    [r, p, gid, n_atoms])."""
    from comd_tpu_torch.cells import make_geometry
    rng = np.random.default_rng(seed)
    geom = make_geometry(lo, hi, cut, use_hilbert=use_hilbert)
    B, nl = geom.n_total, geom.n_local
    counts = rng.integers(0, int(fill * A) + 1, size=nl)
    r = rng.uniform(-50.0, 50.0, size=(3, B, A))
    p = rng.standard_normal((3, B, A))
    gid = rng.integers(0, 2 ** 30, size=(B, A))
    n_atoms = rng.integers(0, A + 1, size=B)
    n_atoms[:nl] = counts
    ids = rng.permutation(4 * int(counts.sum()))
    centre = np.asarray(lo)[:, None] + (geom.tuple_of_box[:nl].T + 0.5) * \
        geom.box_size[:, None]
    k = 0
    for c in range(nl):
        for s in range(counts[c]):
            gid[c, s] = ids[k]
            r[:, c, s] = centre[:, c] + rng.uniform(
                -spread, spread, size=3) * geom.box_size
            k += 1
    dt = getattr(torch, dtype)
    maps = binning.geom_maps(geom, dt, "cuda")
    return geom, maps, [torch.as_tensor(r, dtype=dt, device="cuda"),
                        torch.as_tensor(p, dtype=dt, device="cuda"),
                        torch.as_tensor(gid, dtype=torch.int32,
                                        device="cuda"),
                        torch.as_tensor(n_atoms, dtype=torch.int32,
                                        device="cuda")]


def _rb_crowd(geom, fields, cell, n, seed):
    """``n`` atoms of other local cells moved into local cell ``cell``."""
    rng = np.random.default_rng(seed)
    r, _p, _g, n_atoms = fields
    A = r.shape[2]
    counts = n_atoms[:geom.n_local].cpu().numpy()
    occ = [(c, s) for c in range(geom.n_local) if c != cell
           for s in range(min(counts[c], A))]
    pick = rng.choice(len(occ), size=n, replace=False)
    t = geom.tuple_of_box[cell]
    centre = geom.local_min + (t + 0.5) * geom.box_size
    for i in pick:
        c, s = occ[i]
        r[:, c, s] = torch.as_tensor(centre + rng.uniform(-0.4, 0.4, 3) *
                                     geom.box_size, dtype=r.dtype)


def _rb_case(name, dtype):
    """(geom, maps, fields, wrap extent, keep_halo) of a named case; a
    name ending in a number (``crowd32``) is that case at that A."""
    cut = 4.0
    kind = name.rstrip("0123456789")
    A = int(name[len(kind):]) if kind != name else None
    if name == "state":
        sim = _sim(dtype, "rows", 10, "cuda")
        sim.step_block(10)
        s = sim.state
        g = torch.Generator(device="cpu").manual_seed(3)
        r = s.r.clone()
        nl = sim.geom.n_local
        # up to 1 A: across the periodic boundary (0.90 A from the planes)
        r[:, :nl] += ((torch.rand(r[:, :nl].shape, generator=g) - 0.5) * 2
                      ).to(r.dtype).to("cuda")
        return (sim.geom, sim.maps, [r, s.p.clone(), s.gid.clone(),
                                     s.n_atoms.clone()], sim._extent, False)
    if kind == "shard":
        lo = np.array([4.0, 0.0, 4.0]) * cut
        geom, maps, f = _rb_synthetic(lo, lo + 4 * cut, A or 16, dtype, 21,
                                      spread=1.0)
        return geom, maps, f, None, True
    if name == "fold":
        geom, maps, f = _rb_synthetic(np.zeros(3), np.full(3, 5 * cut), 16,
                                      dtype, 22, spread=0.9)
        return geom, maps, f, np.full(3, 5.5 * cut), False
    if name == "hilbert":
        geom, maps, f = _rb_synthetic(np.zeros(3), np.full(3, 8.3 * cut), 16,
                                      dtype, 23, use_hilbert=True)
        assert geom.use_hilbert
        return geom, maps, f, np.full(3, 8.3 * cut), False
    A = A or {"odd": 13, "wide": 40, "crowd": 16, "past": 16}[name]
    ext = np.array([3.1, 4.3, 3.6]) * cut
    # the crowded cases keep every atom within its own cell
    crowded = kind in ("crowd", "past")
    geom, maps, f = _rb_synthetic(np.zeros(3), ext, A, dtype, 24,
                                  spread=0.4 if crowded else 0.75)
    if kind == "crowd":        # A < count <= C: exact
        _rb_crowd(geom, f, 5, A + 1, 25)
    if kind == "past":         # count > C: the layout differs there
        _rb_crowd(geom, f, 5, 3 * A, 26)
    return geom, maps, f, ext, False


# the place launch's warp form at A = 13, 16, 32 (a cell of A < n <= C
# in rounds of L lanes, n > C), its block form at A = 33 and 40; serially
# in place and on a shard under keep_halo
RB_CASES = ("state", "shard", "fold", "hilbert", "odd", "wide", "crowd",
            "past") + tuple(f"{kind}{A}" for A in (13, 32, 33, 40)
                            for kind in ("crowd", "past", "shard"))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", RB_CASES)
def test_rebucket_kernels_match_plain(cuda_device, dtype, name):
    """csrc/rebucket.cu's two launches against rebucket_plain on the same
    CUDA tensors, bit for bit up to C = stage_capacity(A) atoms a cell
    (the crowded cell holds over A: the overflow flag set, the A smallest
    gids kept); past C (``past``: 3A atoms in one cell) the counts,
    n_migrating and the flag still agree, and every other cell's layout;
    the serial in-place body (rebucket_into: the baseline's local rows,
    the flag or-ed) against its plain version.  The place launch in the
    form ``place_form(A)`` gives (the warp form up to A = 32)."""
    from comd_tpu_torch.ops.cuda import LAUNCHES
    from comd_tpu_torch.ops.cuda import rebucket as rb
    geom, maps, f, ext, keep = _rb_case(name, dtype)
    kind = name.rstrip("0123456789")
    n0 = (LAUNCHES["rebucket_bin"], LAUNCHES["rebucket_place"])
    got = rb.rebucket(geom, maps, *f, wrap_extent=ext, keep_halo=keep)
    assert (LAUNCHES["rebucket_bin"], LAUNCHES["rebucket_place"]) == (
        n0[0] + 1, n0[1] + 1)
    want = rb.rebucket_plain(geom, maps, *f, wrap_extent=ext,
                             keep_halo=keep)
    torch.cuda.synchronize()
    C = rb.stage_capacity(f[0].shape[2])
    big = want[3] > C
    assert bool(big.any()) == (kind == "past")
    if name != "state":
        assert bool(want[5]) == (kind in ("crowd", "past"))
    for a, b in zip(got[3:], want[3:]):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    ok = ~big
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        assert torch.equal(a[..., ok, :], b[..., ok, :]), name
    if keep or ext is None:
        return
    # the serial body in place, from the same inputs
    outs = []
    for fn in (rb.rebucket_into, rb.rebucket_into_plain):
        t = [x.clone() for x in f]
        last = torch.full_like(t[0], 7.0)
        ovf = torch.zeros((), dtype=torch.bool, device="cuda")
        fn(geom, maps, *t, ovf, wrap_extent=ext, last_r=last)
        outs.append(t + [last, ovf])
    for a, b in zip(*outs):
        if big.any() and a.dim() > 0 and a.shape[-1] == f[0].shape[2]:
            a, b = a[..., ok, :], b[..., ok, :]
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["state", "crowd", "crowd32"])
def test_rebucket_body_replayed_in_a_cuda_graph(cuda_device, dtype, name):
    """The serial rebucket body (rebucket_into with the baseline, then the
    halo fill) captured in one CUDA graph and replayed twice from the
    restored state with nothing cleared between: both replays equal the
    plain versions bit for bit (the crowded cases set the overflow
    scratch word), and after each the workspace's counters and scratch
    words are clear."""
    from comd_tpu_torch.ops.cuda import rebucket as rb
    from comd_tpu_torch.stepgraph import cuda_capture
    geom, maps, f, ext, _keep = _rb_case(name, dtype)
    if not isinstance(ext, torch.Tensor):
        # as the serial step gives it: a tensor of r's dtype on the card
        # (host values would be copied to the card inside the capture)
        ext = torch.as_tensor(np.asarray(ext, np.float64), dtype=f[0].dtype,
                              device="cuda")
    want = [x.clone() for x in f]
    want_last = torch.full_like(f[0], 7.0)
    want_ovf = torch.zeros((), dtype=torch.bool, device="cuda")
    rb.rebucket_into_plain(geom, maps, *want, want_ovf, wrap_extent=ext,
                           last_r=want_last)
    step_ops.refresh_halo_plain(geom, maps, want[0], want[2], want[3])
    if name != "state":
        assert bool(want_ovf)
    work = [x.clone() for x in f]
    last = torch.full_like(f[0], 7.0)
    ovf = torch.zeros((), dtype=torch.bool, device="cuda")

    def body():
        rb.rebucket_into(geom, maps, *work, ovf, wrap_extent=ext,
                         last_r=last)
        step_ops.refresh_halo(geom, maps, work[0], work[2], work[3])

    body()                        # the workspace, made uncaptured
    torch.cuda.synchronize()
    graph = cuda_capture(body, torch.cuda.graph_pool_handle())[0]
    for _ in range(2):
        for w, x in zip(work, f):
            w.copy_(x)
        last.fill_(7.0)
        ovf.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert _equal(work, want) and torch.equal(last, want_last)
        assert torch.equal(ovf, want_ovf)
        assert not any(w.counts.any()
                       for w in rb._WORK[torch.cuda.current_device()])


def test_rebucket_kernels_refuse_what_they_do_not_take(cuda_device):
    """The wrappers raise on operands the kernels do not take, on the
    card: mixed devices, maps of another dtype under the wrap."""
    from comd_tpu_torch.ops.cuda import rebucket as rb
    geom, maps, f, ext, _keep = _rb_case("odd", "float32")
    with pytest.raises(ValueError):
        rb.rebucket(geom, maps, f[0], f[1].cpu(), f[2], f[3])
    maps64 = binning.geom_maps(geom, torch.float64, "cuda")
    with pytest.raises(ValueError):
        rb.rebucket(geom, maps64, *f, wrap_extent=ext)
    with pytest.raises(ValueError):
        rb.rebucket(geom, maps, *f, wrap_extent=torch.zeros(
            3, dtype=torch.float64, device="cuda"))


# --------------------------------------------------------------------------
# the atom exchange's unload (csrc/arrivals.cu)
# --------------------------------------------------------------------------

def _displaced_shards(sim, seed, scale=0.6):
    """Every shard's atoms displaced by up to ``scale`` A (numpy, seeded)
    and rebucketed with the halo landers kept: (r, p, gid, n_atoms)
    lists."""
    rng = np.random.default_rng(seed)
    nl, A = sim.geom.n_local, sim.cfg.max_atoms
    reb = []
    for s in sim.states:
        r = s.r.clone()
        valid = torch.arange(A, device="cuda")[None, :] < \
            s.n_atoms[:nl, None]
        d = torch.as_tensor(rng.uniform(-scale, scale, (3, nl, A)),
                            dtype=r.dtype, device="cuda")
        r[:, :nl] += torch.where(valid[None], d, torch.zeros_like(d))
        reb.append(binning.rebucket(sim.geom, sim.maps, r, s.p, s.gid,
                                    s.n_atoms, keep_halo=True)[:4])
    return [list(f) for f in zip(*reb)]


@pytest.mark.parametrize("transport", ["ki", "collective", "packed"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_arrivals_kernels_match_plain(cuda_device, dtype, mesh, transport):
    """csrc/arrivals.cu's bin and place launches against
    append_stage_plain on the same CUDA tensors, bit for bit, at every
    stage of a displaced mesh state's exchange (ki: the sender's counts
    read where ring_push left them; collective: a flag an entry, full
    planes or count-packed), one launch of each a stage; then the sort
    of every shard in one launch against sort_shards_plain."""
    from comd_tpu_torch.ops.cuda import arrivals as av
    sim = _mesh_sim(dtype, mesh, comm_impl="ki",
                    halo_msg_factor=0.6 if transport == "packed" else 0.0)
    h = sim.halo
    fields = _displaced_shards(sim, 7)
    overflow = torch.zeros((), dtype=torch.bool, device="cuda")
    for axis in range(3):
        if transport == "ki":
            arrivals = ki_comm.push_arrivals(h, axis, fields)
        else:
            arrivals = exchange.atom_arrivals(h, axis, *fields, overflow)
        plain = [[t.clone() for t in f] for f in fields]
        ovf_plain = overflow.clone()
        st.reset_launch_counts()
        shifts = (-h.ext[axis], h.ext[axis])
        av.append_stage(h.geom, h.maps, *fields, arrivals, overflow, axis,
                        shifts)
        assert (st.LAUNCHES["arrivals_bin"],
                st.LAUNCHES["arrivals_place"]) == (1, 1)
        av.append_stage_plain(h.geom, h.maps, *plain, arrivals, ovf_plain,
                              axis, shifts)
        for a, b in zip(fields, plain):
            assert _equal(a, b), axis
        assert torch.equal(overflow, ovf_plain)
    want = [[t.clone() for t in f] for f in fields[:3]]
    av.sort_shards_plain(*want)
    st.reset_launch_counts()
    av.sort_shards(*fields[:3])
    assert st.LAUNCHES["sort_cells"] == 1
    for a, b in zip(fields[:3], want):
        assert _equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("crowd", ["within C", "past C"])
def test_arrivals_crowd_matches_plain(cuda_device, dtype, crowd):
    """A cell that receives A < n <= C arrivals: the kernels' slots equal
    the plain version's, the flag set; past C (n = 3A) the counts and the
    flag equal, and every other cell's slots."""
    from comd_tpu_torch.ops.cuda import arrivals as av
    geom, maps, f = _rb_synthetic(np.array([4.0, 4.0, 8.0]) * 4.0,
                                  np.array([8.0, 8.0, 12.0]) * 4.0, 16,
                                  dtype, 31)
    A = 16
    C = av.stage_capacity(A)
    n = A + 3 if crowd == "within C" else 3 * A
    rng = np.random.default_rng(32)
    M = 8 * A
    cell = geom.local_min + geom.box_size * (np.array([1, 2, 1]) + 0.5)
    r = np.ascontiguousarray(rng.uniform(
        geom.local_min - geom.box_size, geom.local_max + geom.box_size,
        (M, 3)).T)
    r[:, :n] = cell[:, None] + rng.uniform(-0.4, 0.4, (3, n)) * \
        geom.box_size[:, None]
    dt = f[0].dtype
    src = (torch.as_tensor(r, dtype=dt, device="cuda"),
           torch.randn((3, M), dtype=dt, device="cuda"),
           torch.as_tensor(rng.permutation(2 ** 20)[:M] + 2 ** 30,
                           dtype=torch.int32, device="cuda"),
           torch.as_tensor(rng.uniform(size=M) < 0.9, device="cuda"))
    src[3][:n] = True
    got, want = [[t.clone()] for t in f], [[t.clone()] for t in f]
    ovf = [torch.zeros((), dtype=torch.bool, device="cuda") for _ in "ab"]
    av.append_stage(geom, maps, *got, [[src]], ovf[0])
    av.append_stage_plain(geom, maps, *want, [[src]], ovf[1])
    assert bool(ovf[0]) and torch.equal(*ovf)
    assert torch.equal(got[3][0], want[3][0])
    added = want[3][0] - f[3]
    assert int(added.max()) == n and int((added > C).sum()) == (
        crowd == "past C")
    ok = added <= C
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a[0][..., ok, :], b[0][..., ok, :])


def _stage_against_plain(geom, maps, fields, src):
    """One append_stage of ``src`` (one shard, one direction) on copies of
    ``fields`` by the kernels and by the plain version: equal bit for bit,
    the bin launch's list as long as the cells the plain version gave
    arrivals, and the workspace's counters left clear.  Returns (the kernels' fields, the cells with arrivals)."""
    from comd_tpu_torch.ops.cuda import arrivals as av
    got, want = [[t.clone()] for t in fields], [[t.clone()] for t in fields]
    ovf = [torch.zeros((), dtype=torch.bool, device="cuda") for _ in "ab"]
    st.reset_launch_counts()
    av.append_stage(geom, maps, *got, [[src]], ovf[0])
    assert (st.LAUNCHES["arrivals_bin"], st.LAUNCHES["arrivals_place"]) == (
        1, 1)
    av.append_stage_plain(geom, maps, *want, [[src]], ovf[1])
    assert torch.equal(*ovf)
    for a, b in zip(got, want):
        assert torch.equal(a[0], b[0])
    cells = int((want[3][0] > fields[3]).sum())
    assert av.list_length(torch.device("cuda")) == cells
    assert not av._LAST[torch.cuda.current_device()][0].counts.any()
    return [t[0] for t in got], cells


@pytest.mark.parametrize("case", ["no cell", "every local cell"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_arrivals_list_edge_stages(cuda_device, dtype, case):
    """A stage in which no cell gets an arrival (every flag clear: the
    place launch finds an empty list and touches nothing) and one in which
    every local cell gets one (a list of every local cell), each followed
    by a stage of random arrivals: the kernels
    equal the plain version bit for bit at each, the list as long as the
    cells that got arrivals."""
    geom, maps, f = _rb_synthetic(np.zeros(3), np.full(3, 24.0), 16, dtype,
                                  33, cut=4.0)
    nl = geom.n_local
    rng = np.random.default_rng(34)
    centre = geom.local_min[:, None] + (geom.tuple_of_box[:nl].T + 0.5) * \
        geom.box_size[:, None]
    dt = f[0].dtype

    def source(r, valid, gid0):
        M = r.shape[1]
        return (torch.as_tensor(np.ascontiguousarray(r), dtype=dt,
                                device="cuda"),
                torch.as_tensor(rng.standard_normal((3, M)), dtype=dt,
                                device="cuda"),
                torch.as_tensor(rng.permutation(2 ** 20)[:M] + gid0,
                                dtype=torch.int32, device="cuda"),
                torch.as_tensor(valid, device="cuda"))

    r = centre + rng.uniform(-0.3, 0.3, centre.shape) * \
        geom.box_size[:, None]
    every = case == "every local cell"
    got, cells = _stage_against_plain(
        geom, maps, f, source(r, np.full(nl, every), 2 ** 30))
    assert cells == (nl if every else 0)
    M = 4 * nl
    r = rng.uniform(geom.local_min - geom.box_size,
                    geom.local_max + geom.box_size, (M, 3)).T
    _got, cells = _stage_against_plain(
        geom, maps, got, source(r, rng.uniform(size=M) < 0.5, 2 ** 29))
    assert cells > 0


def test_arrivals_stages_twice_without_cleanup(cuda_device):
    """The three stages of a displaced 2x2x2 state's exchange, then the
    same three again from the same state with nothing cleared between:
    each stage's kernels equal append_stage_plain bit for bit and the
    first round's results, the list as long as the cells the plain
    version gave arrivals, and the counters clear after every stage."""
    from comd_tpu_torch.ops.cuda import arrivals as av
    sim = _mesh_sim("float32", comm_impl="ki")
    h = sim.halo
    start = _displaced_shards(sim, 9)
    dev = torch.device("cuda")
    rounds = []
    for _ in range(2):
        fields = [[t.clone() for t in x] for x in start]
        ovf = torch.zeros((), dtype=torch.bool, device="cuda")
        lengths = []
        for axis in range(3):
            arrivals = ki_comm.push_arrivals(h, axis, fields)
            before = [n.clone() for n in fields[3]]
            plain = [[t.clone() for t in x] for x in fields]
            ovf_plain = ovf.clone()
            shifts = (-h.ext[axis], h.ext[axis])
            av.append_stage(h.geom, h.maps, *fields, arrivals, ovf, axis,
                            shifts)
            av.append_stage_plain(h.geom, h.maps, *plain, arrivals,
                                  ovf_plain, axis, shifts)
            for a, b in zip(fields, plain):
                assert _equal(a, b), axis
            assert torch.equal(ovf, ovf_plain)
            lengths.append(av.list_length(dev))
            assert lengths[-1] == sum(int((n1 > n0).sum()) for n0, n1 in
                                      zip(before, plain[3]))
            assert not av._LAST[torch.cuda.current_device()][0].counts.any()
        rounds.append((fields, lengths))
    (first, n_first), (second, n_second) = rounds
    assert n_first == n_second and min(n_first) > 0
    for a, b in zip(first, second):
        assert _equal(a, b)


def test_unload_replayed_in_a_cuda_graph(cuda_device):
    """The ki unload of a displaced 2x2x2 state (3 ring_push, 3 bin, 3
    place launches, the sort into other tensors) captured in one CUDA
    graph and replayed twice from the restored state: both replays equal
    the plain versions' result bit for bit (the counters left clear by
    the first replay's place launches, the list written anew)."""
    from comd_tpu_torch.ops.cuda import arrivals as av
    from comd_tpu_torch.stepgraph import cuda_capture
    sim = _mesh_sim("float32", comm_impl="ki")
    h = sim.halo
    start = _displaced_shards(sim, 11)
    want = [[t.clone() for t in x] for x in start]
    ovf = torch.zeros((), dtype=torch.bool, device="cuda")
    for axis in range(3):
        av.append_stage_plain(h.geom, h.maps, *want,
                              ki_comm.push_arrivals(h, axis, want), ovf,
                              axis, (-h.ext[axis], h.ext[axis]))
    want_out = [[torch.empty_like(t) for t in x] for x in want[:3]]
    av.sort_shards_plain(*want[:3], want_out)
    work = [[t.clone() for t in x] for x in start]
    out = [[torch.empty_like(t) for t in x] for x in start[:3]]

    def restore():
        for w, b in zip(work, start):
            for x, y in zip(w, b):
                x.copy_(y)

    def unload():
        ki_comm.exchange_atoms_ki(h, *work)
        av.sort_shards(*work[:3], out)

    unload()                      # the workspaces and the grid, uncaptured
    torch.cuda.synchronize()
    graph = cuda_capture(unload, torch.cuda.graph_pool_handle())[0]
    for _ in range(2):
        restore()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, want_out):
            assert _equal(a, b)
        assert _equal(work[3], want[3])


@pytest.mark.parametrize("A", [13, 16, 32, 33, 256, 300, 3072])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sort_cells_kernel_matches_plain(cuda_device, dtype, A):
    """The sort launch against sort_cells_plain, bit for bit, on rows with
    many tied EMPTY_GIDs holding junk positions (kept in slot order), in
    both forms: the warp form at an odd A, A = 16 (two cells a warp) and
    A = 32, the block form at A = 33, 256, 300 (one cell a block, a
    thread several slots) and MAX_A; into other tensors and in place; one
    launch for 3 shards."""
    from comd_tpu_torch.ops.cuda import arrivals as av
    assert av.sort_form(A) == ("warp" if A <= 32 else "block")
    assert A <= av.MAX_A
    g = torch.Generator(device="cpu").manual_seed(A)
    B = 500
    dt = getattr(torch, dtype)
    shards = []
    for _ in range(3):
        gid = torch.randint(0, 2 ** 30, (B, A), generator=g,
                            dtype=torch.int32)
        gid[torch.rand((B, A), generator=g) < 0.5] = binning.EMPTY_GID
        shards.append([torch.randn((3, B, A), generator=g, dtype=dt).cuda(),
                       torch.randn((3, B, A), generator=g, dtype=dt).cuda(),
                       gid.cuda()])
    want = [av.sort_cells_plain(*s) for s in shards]
    lists = [[s[k] for s in shards] for k in range(3)]
    out = [[torch.empty_like(t) for t in f] for f in lists]
    st.reset_launch_counts()
    av.sort_shards(*lists, out)
    assert st.LAUNCHES["sort_cells"] == 1
    for s, w in enumerate(want):
        assert _equal([o[s] for o in out], w)
    av.sort_shards(*lists)
    for s, w in zip(shards, want):
        assert _equal(s, w)
    assert _equal(av.sort_cells(*want[0]), want[0])


@pytest.mark.parametrize("comm_impl", ["ki_fused", "ki", "collective"])
def test_mesh_redistribution_launches(cuda_device, comm_impl, monkeypatch):
    """One mesh redistribution (``_rebucket_step``) of the 2x2x2 mesh in
    one process: csrc/rebucket.cu's two launches a shard, then the atom
    exchange's 3 stages, each one bin and one place launch over all eight
    shards (and one ring_push under ki), and one sort launch; the same
    state as the plain versions' bit for bit."""
    sim = _mesh_sim("float32", comm_impl=comm_impl)
    twin = _mesh_sim("float32", comm_impl=comm_impl)
    st.reset_launch_counts()
    sim._rebucket_step()
    torch.cuda.synchronize()
    want = {"rebucket_bin": 8, "rebucket_place": 8, "arrivals_bin": 3,
            "arrivals_place": 3, "sort_cells": 1,
            "ring_push": 0 if comm_impl == "collective" else 3}
    assert {k: st.LAUNCHES[k] for k in want} == want
    from comd_tpu_torch.ops.cuda import arrivals as av
    from comd_tpu_torch.ops.cuda import rebucket as rb
    monkeypatch.setattr(rb, "rebucket", rb.rebucket_plain)
    monkeypatch.setattr(av, "append_stage", av.append_stage_plain)
    monkeypatch.setattr(av, "sort_shards", av.sort_shards_plain)
    twin._rebucket_step()
    for a, b in zip(sim.states, twin.states):
        for k in ("r", "p", "gid", "n_atoms"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("comm_impl", ["ki_fused", "ki", "collective"])
def test_mesh_refresh_launches(cuda_device, comm_impl, monkeypatch):
    """The 2x2x2 mesh's ghost refresh in one process under every
    transport: one position_fill launch, the staged exchange's bits; in
    the step's graphs one launch a step that does not rebucket (the IF
    body credited a replay, taken back a rebucket)."""
    sim = _mesh_sim("float32", comm_impl=comm_impl)
    twin = _mesh_sim("float32", comm_impl=comm_impl)
    st.reset_launch_counts()
    sim._refresh()
    torch.cuda.synchronize()
    assert st.LAUNCHES["position_fill"] == 1
    monkeypatch.setattr(ki_comm, "exchange_positions_ki",
                        exchange.exchange_positions)
    twin._refresh()
    assert _bit_equal([s.r for s in sim.states], [s.r for s in twin.states])
    monkeypatch.undo()
    reb = sim.n_rebucket
    st.reset_launch_counts()
    sim.step_block(10)
    sim.step_block(10)
    assert sim._graphs is not None and sim._graphs.replays > 0
    assert st.LAUNCHES["position_fill"] == 20 - (sim.n_rebucket - reb)


def test_arrivals_kernels_refuse_what_they_do_not_take(cuda_device):
    """The wrappers raise on operands on two devices, before a launch."""
    from comd_tpu_torch.ops.cuda import arrivals as av
    geom, maps, f = _rb_synthetic(np.zeros(3), np.full(3, 12.0), 16,
                                  "float32", 41, cut=4.0)
    src = (f[0][:, :4].reshape(3, -1).contiguous(),
           f[1][:, :4].reshape(3, -1).contiguous(),
           f[2][:4].reshape(-1).contiguous(), f[3][:4].contiguous())
    ovf = torch.zeros((), dtype=torch.bool, device="cuda")
    for bad in ((src[0].cpu(),) + src[1:], src[:3] + (src[3].cpu(),)):
        with pytest.raises(ValueError):
            av.append_stage(geom, maps, *[[t] for t in f], [[bad]], ovf)
    with pytest.raises(ValueError):
        av.append_stage(geom, maps, *[[t] for t in f], [[src]], ovf.cpu())
    with pytest.raises(ValueError):
        av.sort_shards([f[0]], [f[1]], [f[2].cpu()])


def _pack_edges(r, p, gid) -> None:
    """atom_pack against atom_pack_plain on synthetic messages of the
    shards' fields (r, p, gid), bit for bit: messages of 2 chunks + 1
    cells (PACK_CELLS a chunk; random cells, a cell at times twice; counts
    0 to A + 2), count-packed with room, with a cap that overflows inside
    the second chunk, all counts zero, full planes; each launched twice
    into the same buffers, poisoned between the launches, the same
    bits."""
    S, (B, A) = len(r), r[0].shape[1:]
    rng = np.random.default_rng(21)
    counts = [torch.as_tensor(rng.integers(0, A + 3, B), dtype=torch.int32,
                              device="cuda") for _ in range(S)]
    zero = [torch.zeros_like(c) for c in counts]
    chunk = cm.PACK_CELLS
    n = 2 * chunk + 1
    ids = tuple(torch.as_tensor(rng.integers(0, B, n),
                                dtype=torch.int32, device="cuda")
                for _ in range(2))
    first = counts[0][ids[0].long()].clamp(0, A)
    inside = int(first[:chunk + 5].sum()) + 1
    for cnt, cap, tag in ((counts, n * A, "packed"),
                          (counts, inside, "overflow"),
                          (zero, 256, "zero"), (counts, 0, "full")):
        kp, pp = (cm.AtomPackPlan(ids, cap, S, r[0].shape, r[0].dtype,
                                  "cuda") for _ in range(2))
        flags = [torch.zeros((), dtype=torch.bool, device="cuda")
                 for _ in range(3)]
        runs = []
        for f in flags[:2]:
            st.reset_launch_counts()
            cm.atom_pack(kp, r, p, gid, cnt, f)
            assert st.LAUNCHES["atom_pack"] == 1
            runs.append([kp.rp.clone(), kp.gid.clone(), kp.valid.clone()])
            kp.rp.fill_(float("nan"))
            kp.gid.fill_(-7)
            kp.valid.fill_(tag != "zero")
        cm.atom_pack_plain(pp, r, p, gid, cnt, flags[2])
        for got in runs:
            assert _bit_equal([got[0]], [pp.rp]), tag
            assert torch.equal(got[1], pp.gid), tag
            assert torch.equal(got[2], pp.valid), tag
        assert [bool(f) for f in flags] == [tag == "overflow"] * 3


@pytest.mark.parametrize("cap", ["packed", "full", "overflow", "edges"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_atom_pack_matches_plain(cuda_device, dtype, mesh, cap):
    """csrc/comm.cu's atom_pack against atom_pack_plain on the same CUDA
    tensors, bit for bit in every buffer (r, p, gid, valid) and the
    overflow flag, at every stage of a displaced mesh state's collective
    exchange, one launch a stage: count-packed at the plan's caps, full
    planes, and a cap of 16 that overflows; "edges": the chunks' edges on
    synthetic messages (``_pack_edges``)."""
    import dataclasses
    sim = _mesh_sim(dtype, mesh, comm_impl="collective")
    r, p, gid, n_atoms = _displaced_shards(sim, 8)
    if cap == "edges":
        _pack_edges(r, p, gid)
        return
    caps = {"packed": sim.plan.atom_cap, "full": (0, 0, 0),
            "overflow": (16, 16, 16)}[cap]
    h = exchange.make_halo(sim.mesh, sim.geom, sim.maps,
                           dataclasses.replace(sim.plan, atom_cap=caps),
                           sim.dtype)
    S = len(r)
    overflow = torch.zeros((), dtype=torch.bool, device="cuda")
    flags = []
    for axis in range(3):
        kp, pp = (cm.AtomPackPlan(h.atom_send[axis], caps[axis], S,
                                  r[0].shape, r[0].dtype, "cuda")
                  for _ in range(2))
        fk = torch.zeros((), dtype=torch.bool, device="cuda")
        fp = torch.zeros((), dtype=torch.bool, device="cuda")
        st.reset_launch_counts()
        cm.atom_pack(kp, r, p, gid, n_atoms, fk)
        assert st.LAUNCHES["atom_pack"] == 1
        cm.atom_pack_plain(pp, r, p, gid, n_atoms, fp)
        assert _bit_equal([kp.rp], [pp.rp])
        assert torch.equal(kp.gid, pp.gid) and torch.equal(kp.valid, pp.valid)
        assert bool(fk) == bool(fp)
        flags.append(bool(fp))
        arrivals = exchange.atom_arrivals(h, axis, r, p, gid, n_atoms,
                                          overflow)
        binning.append_stage(h.geom, h.maps, r, p, gid, n_atoms, arrivals,
                             overflow, axis, (-h.ext[axis], h.ext[axis]))
    assert all(flags) if cap == "overflow" else not any(flags)


def _spill_map(B: int) -> cm.FoldMap:
    """A fold of two shards whose 40 destinations (rows 0-19 of each)
    take 1 to 16 sources (random rows 100 and up of either shard, in
    random order), so records spill past their K inline sources."""
    rng = np.random.default_rng(17)
    n = rng.integers(1, 17, 40)
    dst = np.repeat(np.arange(40) // 20, n)
    dst_row = np.repeat(np.arange(40) % 20, n)
    src = rng.integers(0, 2, n.sum())
    src_row = rng.integers(100, B, n.sum())
    order = rng.permutation(n.sum())
    return cm.FoldMap(dst[order], dst_row[order], src[order], src_row[order])


@pytest.mark.parametrize("A", [None, 13])
@pytest.mark.parametrize("where", ["serial", "2x2x2", "3x2x1", "spill"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fold_halo_matches_plain(cuda_device, dtype, where, A):
    """csrc/comm.cu's fold_halo against fold_halo_plain on the same CUDA
    tensors, bit for bit, [3, B, A] and [B, A] fields (also at A = 13:
    one slot a move): serially one launch, on a mesh one a stage
    (ki_comm.fold_halo_ki), "spill" one launch of a two-shard map whose
    records spill past their inline sources; in place; the same bits on
    two runs."""
    from comd_tpu_torch.ops.sweep import fold_plan_serial
    if where in ("serial", "spill"):
        sim = _sim(dtype, "rows" if dtype == "float64" else "cheb", 8,
                   "cuda", half_shell=True)
    else:
        sim = _mesh_sim(dtype, where, comm_impl="collective")
    B = sim.geom.n_total
    A = A or sim.cfg.max_atoms
    S = 1 if where == "serial" else 2 if where == "spill" else \
        len(sim.states)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for shape in ((3, B, A), (B, A)):
        x = [torch.rand(shape, dtype=sim.dtype, device="cuda",
                        generator=gen) - 0.5 for _ in range(S)]
        if where == "serial":
            plans = [fold_plan_serial(sim.maps, x[0])]
        elif where == "spill":
            plans = [cm.FoldPlan(_spill_map(B), shape, sim.dtype, "cuda", 2)]
            assert plans[0].record_vecs == cm.FOLD_RECORD_VECS and \
                plans[0].spill.numel() > 1
        else:
            plans = [ki_comm.fold_plan(sim.halo, axis, x[0])
                     for axis in (2, 1, 0)]
        runs = []
        for _ in range(2):
            got = [v.clone() for v in x]
            st.reset_launch_counts()
            if where in ("serial", "spill"):
                cm.fold_halo(plans[0], got)
            else:
                ki_comm.fold_halo_ki(sim.halo, got)
            assert st.LAUNCHES["fold_halo"] == len(plans)
            runs.append(got)
        want = [v.clone() for v in x]
        for plan in plans:
            cm.fold_halo_plain(plan, want)
        assert _bit_equal(runs[0], want) and _bit_equal(runs[1], want)


def test_torch_exchanges_never_run_on_card(cuda_device, monkeypatch):
    """In one process on the card no lazy or -S 0 mesh step, list step or
    half-shell step reaches the staged torch fill
    (exchange.exchange_scalar), the torch atom packing
    (exchange._atom_message), the torch mesh fold (exchange.fold_halo),
    index_add_, or a plain version of halo_fill, atom_pack or fold_halo:
    each is replaced by a function that raises, and the steps still run
    (launching halo_fill, atom_pack and fold_halo)."""
    def refuse(name):
        def fn(*_a, **_k):
            raise AssertionError(f"{name} ran on the card")
        return fn

    for mod, name in ((exchange, "exchange_scalar"),
                      (exchange, "_atom_message"), (exchange, "fold_halo"),
                      (cm, "halo_fill_plain"), (cm, "atom_pack_plain"),
                      (cm, "fold_halo_plain")):
        monkeypatch.setattr(mod, name, refuse(name))
    monkeypatch.setattr(torch.Tensor, "index_add_", refuse("index_add_"))
    runs = {
        "lazy collective": dict(nx=8, ny=8, nz=8, comm_impl="collective",
                                **MESH),
        "-S 0 collective": dict(nx=8, ny=8, nz=8, comm_impl="collective",
                                lazy_shell=False, **MESH),
        "list collective": dict(nx=8, ny=8, nz=8, comm_impl="collective",
                                method="thread_atom_nl", **MESH),
        "list ki": dict(nx=8, ny=8, nz=8, comm_impl="ki",
                        method="thread_atom_nl", **MESH),
        "half mesh": dict(nx=8, ny=8, nz=8, comm_impl="ki_fused",
                          half_shell=True, **MESH),
        "half serial": dict(nx=8, ny=8, nz=8, half_shell=True)}
    for tag, kw in runs.items():
        st.reset_launch_counts()
        sim = init_simulation(Config(doeam=True, temperature=600.0,
                                     initial_delta=0.3, dtype="float32",
                                     pot_dir=POTS, device="cuda", **kw))
        sim.step_block(10)
        sim.step_block(10)
        torch.cuda.synchronize()
        assert sim.sum_atoms() == sim.n_global and not sim.overflow, tag
        n = st.LAUNCHES
        if tag.startswith("half"):
            assert n["fold_halo"] >= 2 * 21, tag
        else:
            assert n["halo_fill"] == 21, tag
        if "collective" in tag:
            assert n["atom_pack"] == 3 * (sim.n_rebucket + 1) and \
                n["ring_push"] == 0, tag
