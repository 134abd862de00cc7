"""The pair-window probes P1-P3 of the port (comd_tpu_torch.probes.window)
against the archive's Pallas kernels (tools/archive/pallas_probe.py,
pallas_probe2.py, pallas_probe3.py) in interpret mode, on the same inputs.

The archive's kernels run in their own pl.pallas_call with the probes' own
specs at one or two chunks (P3's loop variants B and C, whose unrolled
interpret-mode traces take ~5-17 s each, are in
test_torch_probe_variants.py).  Tolerance: every element within 1e-5 of
its own scale, the sum of its terms' magnitudes (window_pair_magnitude),
and every output within 1e-5 of its largest value (the two sum in another
order).  P3's LJ sums reach ~1e12 at a few near-coincident pairs, so only
the first check sees the other elements; a numpy LJ with a wrong constant
shows it.
"""
import dataclasses
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from comd_tpu_torch.ops.cuda import probe as cuda_probe
from comd_tpu_torch.probes import window
from probe_archive import (WINDOW_MODULES, bit_equal,
                           check_plain_against_archive, load, norm_rel)

torch.set_num_threads(1)


class _Captured(Exception):
    pass


def _main_input(monkeypatch, probe):
    """The rp the archive's main() hands its kernel: main runs until its
    first call of the kernel, which a stand-in records and stops."""
    mod = load(WINDOW_MODULES[probe])
    got = []

    def grab(rp, *args, **kwargs):
        got.append(np.asarray(rp))
        raise _Captured

    fake_pl = types.SimpleNamespace(**vars(pl))
    fake_pl.pallas_call = lambda *args, **kwargs: grab
    monkeypatch.setattr(mod, "pl", fake_pl)
    if probe == 3:       # P3 hands rp to a jitted scan of the kernel
        fake_jax = types.SimpleNamespace(**vars(jax))
        fake_jax.jit = lambda fn: grab
        monkeypatch.setattr(mod, "jax", fake_jax)
    monkeypatch.setattr(sys, "argv", [f"{WINDOW_MODULES[probe]}.py", "A"])
    with pytest.raises(_Captured):
        mod.main()
    return got[0]


@pytest.mark.parametrize("probe", [1, 2, 3])
def test_constants_match_archive(probe):
    mod = load(WINDOW_MODULES[probe])
    sp = window.spec(probe)
    A = mod.A if probe < 3 else mod.A_
    assert (A, mod.C, mod.PAD, mod.W) == (window.SLOTS, window.CHUNK,
                                          sp.pad, sp.window)
    assert sp.offsets == tuple(mod.OFFSETS)
    if probe == 1:
        assert (sp.physics, sp.rcut2, sp.phi) == ("inv_r2", 36.0, ())
        return
    f32 = [float(np.float32(c)) for c in mod.COEF]
    assert list(sp.phi) == f32
    assert list(sp.dphi) == [float(np.float32(c)) for c in mod.DCOEF]
    assert list(sp.rho) == (f32[::-1] if probe == 2 else f32[1:])
    if probe == 3:
        assert window.spec(3, lj=True).offsets == sp.offsets


@pytest.mark.parametrize("probe", [1, 2, 3])
def test_make_inputs_bit_equal_archive(monkeypatch, probe):
    rp = _main_input(monkeypatch, probe)
    assert bit_equal(window.make_inputs(probe), rp)


@pytest.mark.parametrize("probe,variant,lj,n_chunks", [
    (1, "A", False, 2), (2, "A", False, 1),
    (3, "A", False, 1), (3, "A", True, 1)])
def test_plain_matches_archive_kernel(probe, variant, lj, n_chunks):
    check_plain_against_archive(probe, variant, lj, n_chunks)


def test_window_pair_runs_plain_on_cpu():
    sp = window.spec(1)
    rp = torch.from_numpy(window.make_inputs(1, 1))
    for a, b in zip(window.window_pair(rp, sp), window.window_pair_plain(
            rp, sp, col_chunk=96)):
        assert torch.equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the CUDA wrapper: a CPU tensor is refused."""
    rp = torch.from_numpy(window.make_inputs(1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.window_pair(rp, window.spec(1), 256)


def test_pair_counts():
    assert window.n_pairs(window.P3, 8 * window.CHUNK) == 56_623_104
    assert window.n_pairs(window.P3, 72 * window.CHUNK) == 509_607_936
    rp = window.make_inputs(3, 72)
    assert rp.shape == (3, 32, 19_584)
    assert window.n_columns(window.P3, rp.shape[2]) == 18_432
    with pytest.raises(ValueError):
        window.n_columns(window.P3, rp.shape[2] - 1)


def test_command_on_cpu(capsys):
    assert window.main(["3", "--lj", "--chunks", "1", "--reps", "1",
                        "--device", "cpu"]) == 0
    line = capsys.readouterr().out
    assert "P3 LJ on cpu: 1 chunks" in line and "Gpairs/s" in line
    with pytest.raises(SystemExit):
        window.main(["1", "--lj", "--device", "cpu"])


def _lj_numpy(rp, sp, c6):
    """P3's LJ sums in numpy f32 with the force coefficient's constant
    ``c6`` (6 is right): fx, u, rho [A, D]."""
    D = window.n_columns(sp, rp.shape[2])
    ri = rp[:, :, sp.pad:sp.pad + D]
    out = np.zeros((3, rp.shape[1], D), np.float32)
    for d in sp.offsets:
        rj = rp[:, :, sp.pad + d:sp.pad + d + D]
        dx, dy, dz = ri[:, :, None] - rj[:, None]
        r2 = dx * dx + dy * dy + dz * dz
        m = (r2 <= sp.rcut2) & (r2 > 0)
        inv = np.where(m, np.float32(1) / np.where(m, r2, np.float32(1)),
                       np.float32(0))
        r6 = inv * inv * inv
        fc = np.where(m, r6 * inv * (np.float32(12) * r6 - np.float32(c6)),
                      np.float32(0))
        e = np.where(m, r6 * (r6 - np.float32(1)), np.float32(0))
        out += np.stack([(fc * dx).sum(1), e.sum(1), e.sum(1)])
    return [torch.from_numpy(o) for o in out]


@pytest.mark.parametrize("c6,right", [(6.0, True), (7.0, False)])
def test_element_check_catches_a_wrong_lj_constant(c6, right):
    """12 r6 - 7 for 12 r6 - 6 stays within 1e-5 of each output's largest
    value (set by near-coincident pairs) but not of each element's own
    scale."""
    sp = window.P3_LJ
    rp = torch.from_numpy(window.make_inputs(3, 1))
    want = window.window_pair_plain(rp, sp)
    scale = window.window_pair_magnitude(rp, sp)
    got = _lj_numpy(rp.numpy(), sp, c6)
    assert max(norm_rel(a.numpy(), b.numpy())
               for a, b in zip(got, want)) <= 1e-5
    assert (window.element_error(got, want, scale) <= 1e-5) == right


@pytest.mark.parametrize("probe,lj", [(1, False), (2, False), (3, True)])
def test_element_check_catches_a_dropped_offset(probe, lj):
    sp = window.spec(probe, lj)
    rp = torch.from_numpy(window.make_inputs(probe, 1))
    want = window.window_pair_plain(rp, sp)
    scale = window.window_pair_magnitude(rp, sp)
    assert window.element_error(want, want, scale) == 0.0
    bad = window.window_pair_plain(
        rp, dataclasses.replace(sp, offsets=sp.offsets[:-1]))
    assert window.element_error(bad, want, scale) > 1e-3


@pytest.mark.parametrize("probe,lj", [(1, False), (2, False), (3, False),
                                      (3, True)])
def test_magnitude_and_pairs_in_cutoff(probe, lj):
    """Each element's scale bounds its sum; the pairs inside the cutoff
    are counted as numpy counts them."""
    sp = window.spec(probe, lj)
    rp = window.make_inputs(probe, 1)
    t = torch.from_numpy(rp)
    for s, b in zip(window.window_pair_magnitude(t, sp, col_chunk=100),
                    window.window_pair_plain(t, sp)):
        assert bool((s >= b.abs() * (1 - 1e-6)).all())
    D = window.n_columns(sp, rp.shape[2])
    ri = rp[:, :, sp.pad:sp.pad + D]
    n = 0
    for d in sp.offsets:
        dr = ri[:, :, None] - rp[:, None, :, sp.pad + d:sp.pad + d + D]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        n += int(((r2 <= sp.rcut2) & (r2 > 0)).sum())
    assert window.n_in_cutoff(t, sp, col_chunk=100) == n
    assert 0 < n < window.n_pairs(sp, D) // 50


# --------------------------------------------------------------------------
# the window kernel's launch plan (ops/cuda/probe.py), made on the host
# --------------------------------------------------------------------------

H100_WARPS = 132 * 32    # window warps an H100 holds: 4 blocks of 8 an SM


@pytest.mark.parametrize("probe,lj,chunks,n_cols,resident", [
    (1, False, 1, 256, H100_WARPS), (2, False, 1, 256, H100_WARPS),
    (3, False, 1, 253, H100_WARPS), (3, True, 1, 61, 10 ** 6),
    (3, False, 1, 256, 1), (1, False, 1, 7, 40), (3, False, 2, 509, 900)])
def test_window_plan_covers_every_pair_once(probe, lj, chunks, n_cols,
                                            resident):
    """The warps of the plan, as the kernel computes their work, cover
    every (i-slot, column, offset, j-slot) exactly once: lanes are the
    i-slots, each warp walks all A j-slots of its offsets, and the
    columns' offset groups partition the offsets."""
    sp = window.spec(probe, lj)
    rp = window.make_inputs(probe, chunks)
    A, L = rp.shape[1], rp.shape[2]
    plan = cuda_probe.window_plan(sp, A, L, n_cols, resident)
    assert plan.n_slots == A <= 32 and plan.warps <= cuda_probe.WINDOW_WARPS
    assert plan.threads == 32 * plan.warps
    K = len(sp.offsets)
    seen = np.zeros((A, n_cols, K, A), np.int32)
    for block in range(plan.blocks):
        for warp in range(plan.warps):
            work = plan.warp_work(block, warp)
            if work is not None:
                c, k0, k1 = work
                seen[:, c, k0:k1, :] += 1
    assert (seen == 1).all()
    assert plan.warp_work(plan.blocks, 0) is None


@pytest.mark.parametrize("n_offsets,n_cols,resident,want", [
    (8, 1024, H100_WARPS, (2, 4, 2)),      # P1 at 4 chunks
    (27, 2048, H100_WARPS, (14, 2, 4)),    # P2, P3 at 8 chunks
    (27, 18432, H100_WARPS, (27, 1, 8)),   # P3 at 72 chunks
    (27, 10, 10 ** 6, (4, 7, 1)),          # as many groups as a block takes
    (8, 10, 10 ** 6, (1, 8, 1)), (1, 5, 10 ** 6, (1, 1, 8))])
def test_split_offsets(n_offsets, n_cols, resident, want):
    """The fewest offset groups that fill about one wave of the card, no
    group empty, at most 8 warps a block."""
    group, n_groups, cpb = cuda_probe.split_offsets(n_offsets, n_cols,
                                                    resident)
    assert (group, n_groups, cpb) == want
    assert group * n_groups >= n_offsets > group * (n_groups - 1)
    assert cpb * n_groups <= cuda_probe.WINDOW_WARPS


@pytest.mark.parametrize("probe,lj", [(1, False), (2, False), (3, True)])
def test_window_plan_made_once(probe, lj):
    """A plan is made once per spec and shape: the cached plan is the same
    object on every call, equals a fresh one, and carries the same kernel
    parameters (offsets, coefficients, split)."""
    sp = window.spec(probe, lj)
    L = window.make_inputs(probe, 2).shape[2]
    D = window.n_columns(sp, L)
    plan = cuda_probe.window_plan(sp, 32, L, D, H100_WARPS)
    assert cuda_probe.window_plan(sp, 32, L, D, H100_WARPS) is plan
    fresh = cuda_probe.window_plan.__wrapped__(sp, 32, L, D, H100_WARPS)
    assert fresh == plan and fresh is not plan
    assert bytes(fresh.params) == bytes(plan.params)
    p = plan.params
    assert (p.n_slots, p.row_len, p.n_cols, p.pad, p.n_offsets) == (
        32, L, D, sp.pad, len(sp.offsets))
    assert (p.group, p.n_groups, p.cols_per_block) == (
        plan.group, plan.n_groups, plan.cols_per_block)
    assert list(p.offsets)[:len(sp.offsets)] == list(sp.offsets)
    assert list(p.phi)[:len(sp.phi)] == list(sp.phi)
    assert np.float32(p.rcut2) == np.float32(sp.rcut2)


def test_window_plan_refuses_what_the_kernel_does_not_take():
    sp = window.P3
    L = window.make_inputs(3, 1).shape[2]
    with pytest.raises(ValueError, match="slots"):
        cuda_probe.window_plan(sp, 33, L, 256, H100_WARPS)
    with pytest.raises(ValueError, match="fit"):
        cuda_probe.window_plan(sp, 32, L, L, H100_WARPS)
    with pytest.raises(ValueError, match="Clenshaw"):
        cuda_probe.window_plan(dataclasses.replace(sp, rho=sp.rho[:5]), 32,
                               L, 256, H100_WARPS)


@pytest.mark.parametrize("probe", [1, 3])
def test_in_cutoff_counts(probe):
    """Per offset and output the pairs inside the cutoff; they add up to
    n_in_cutoff."""
    sp = window.spec(probe)
    t = torch.from_numpy(window.make_inputs(probe, 1))
    counts = window.in_cutoff_counts(t, sp, col_chunk=100)
    assert counts.shape == (len(sp.offsets), 32, window.n_columns(
        sp, t.shape[2]))
    assert int(counts.sum()) == window.n_in_cutoff(t, sp)
    d = sp.offsets.index(0)          # offset 0: the pair (a, a) has r2 = 0
    rp = t.numpy()
    ri = rp[:, :, sp.pad:sp.pad + 5]
    dr = ri[:, :, None] - ri[:, None]
    r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
    want = ((r2 <= sp.rcut2) & (r2 > 0)).sum(1)
    assert (counts[d, :, :5].numpy() == want).all()
