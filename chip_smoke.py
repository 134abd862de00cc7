#!/usr/bin/env python3
"""Smoke run of comd_tpu_torch's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each, failing (non-zero exit, no result line) on
the first error:
  1. device   -- a CUDA card is required; prints nvidia-smi's name and
                 power limit
  2. build    -- compiles the kernel sources (csrc/stencil.cu, comm.cu,
                 probe.cu) with nvcc, one process each, in parallel; prints
                 registers and spill stores (stencil.cu's by variant) and
                 fails if an f32 stencil kernel spills
  3. kernel   -- K1 against its plain PyTorch version on the same CUDA
                 tensors (thermalized 10^3 lattice, T = 600 K), EAM pass 1
                 and pass 3, f32/Chebyshev and f64/table
  4. golden   -- T = 0 Adams Cu cohesive energy at 6^3, f64, through K1:
                 -3.538079224691 eV/atom within 1e-9
  5. main     -- the headline run: 63^3 FCC Cu (1,000,188 atoms), EAM
                 funcfl, f32, auto commensurate cells, lazy-shell stepping,
                 10 x step_block(10); checks atom count, overflow, energy
                 drift and that every step launched both K1 passes, then
                 times each pass against its plain version at that shape
                 and checks that two launches of K1 pass 1 (with and
                 without energy) and pass 3 give the same bits.
  6. half kernel -- K2 against its plain version on the same CUDA tensors
                 (thermalized 10^3): EAM passes 1 (with and without energy)
                 and 3 at f32/Chebyshev and f64/table, and LJ; K1's LJ
                 variant likewise.  Dense unfolded outputs are compared (both
                 use the same half map).  Tolerances: f32 forces atol 1e-4
                 eV/A and scalars 1e-5 of their largest value (another
                 summation order, K2's with atomics in run-to-run order);
                 f64 1e-12 relative.
  7. goldens  -- f64 through the kernels, within 1e-9: Adams 6^3 with
                 --halfShell; LJ 6^3 full and half; 5-sigma LJ 8^3 (A = 256
                 on a 2^3 grid) full and half.
  8. half main -- the headline run with --halfShell (K2 for passes 1 and 3),
                 the same checks; K2 against K1's force at the initial and
                 final states; K2's times beside K1's and the plain versions.
  9. LJ main  -- 63^3 LJ f32 (A = 32, 35^3 cells), full (K1) and
                 --halfShell (K2), 100 steps each, the same checks and times.
 10. comm kernels -- K3 (ring_push) and K4 (pass2_push) against their plain
                 versions on a thermalized 10^3 EAM state on a 2x2x2 mesh of
                 shards, f32 and f64, bitwise: K3 for the dfEmbed planes of
                 all three stages and for the atom buffers, K4 against pass
                 2's F' at the same rows.
 11. sharded goldens -- f64, T = 0, within 1e-9: Adams 6^3 on 2x2x2 with
                 --commImpl ki_fused, full shell and --halfShell; LJ 12x8x4
                 on 3x2x1 with --commImpl ki (2 cells per shard axis).
 12. sharded main -- the 63^3 headline on a 2x2x2 mesh of shards on the one
                 card, --commImpl ki_fused, then collective: the run_main
                 checks, K1 passes 1 and 3, K3 and K4 launched on every step,
                 the final r and ePot of the two transports equal bit for
                 bit, the initial ePot within 1e-6 of phase 5's; K3 and K4
                 against their plain versions at that state and their times
                 beside their plain versions and bounds.  Eight shards on
                 one card measure the decomposition's overhead against the
                 serial run, not scaling.
 13. probes   -- the archive probes through their commands
                 (comd_tpu_torch.probes.window P1, P2, P3, P3 --lj;
                 .lookup P4, P5, P6), then window_pair against its plain
                 version (P1, P2, P3 EAM and LJ at the probes' shapes and
                 P3 at 72 chunks, 509.6M pairs ~ one K1 pass of phase 5:
                 each element within 1e-5 of the sum of its terms'
                 magnitudes and each output within 1e-5 of its largest
                 value, all finite) and row_lookup / lane_lookup bit for
                 bit at scale 1e-12 and 1, also on tables whose columns
                 differ; times beside plain versions and bounds (flops
                 the function needs: r2 on every pair, the pair function
                 on the pairs inside the cutoff), the 72-chunk time per
                 pair beside K1's pass 1.
Then the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Each main path runs with the launch counts set to 0 just before it and
read just after.  Imports torch, numpy and comd_tpu_torch only; builds
everything from this checkout (the three kernel sources with one nvcc each,
in parallel).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
POTS = os.path.join(ROOT, "pots")
GOLDEN_EAM_ADAMS = -3.538079224691
GOLDEN_LJ = -1.243619295058
GOLDEN_LJ_5SIGMA = -1.406590686466
SOURCE = "comd_tpu_torch/csrc/stencil.cu"
COMM_SOURCE = "comd_tpu_torch/csrc/comm.cu"
PROBE_SOURCE = "comd_tpu_torch/csrc/probe.cu"
PROBE_KEYS = ("window_pair", "row_lookup", "lane_lookup")
REPLACES = {"stencil": "comd_tpu/ops/pallas/stencil.py:48",
            "half": "comd_tpu/ops/pallas/stencil.py:204",
            "ring_push": "comd_tpu/parallel/pallas_comm.py:39",
            "pass2_push": "comd_tpu/parallel/pallas_comm.py:265",
            "window_pair": "tools/archive/pallas_probe.py:22, "
                           "tools/archive/pallas_probe2.py:38, "
                           "tools/archive/pallas_probe3.py:62,94",
            "row_lookup": "tools/archive/gather_probe.py:94",
            "lane_lookup": "tools/archive/gather_probe2.py:59,87"}
MESH = dict(xproc=2, yproc=2, zproc=2)
HEADLINE_N = 63      # unit cells per axis of the main paths (1,000,188 atoms)
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_rel(a, b) -> float:
    """max |a - b| / |b| over entries where b != 0 (0 where both are 0)."""
    import torch
    d = (a - b).abs()
    den = b.abs()
    bad = (den == 0) & (d != 0)
    if bool(bad.any()):
        return float("inf")
    return float(torch.where(den > 0, d / den.clamp_min(1e-300),
                             torch.zeros_like(d)).max())


def norm_rel(a, b) -> float:
    """max |a - b| / max |b|: dense half-shell sums hold partial sums on
    halo rows, some near zero, so they are held against their largest
    value."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def compare_passes(sim, tag: str, f_atol: float, s_rtol: float,
                   f_rtol: float = 0.0):
    """K1 vs plain version for EAM pass 1 and pass 3 on sim's state.
    Returns {pass: max_abs_err of the force}."""
    import torch
    from comd_tpu_torch.ops import binning
    from comd_tpu_torch.ops.cuda import stencil as st
    r, nbr, ev = sim.state.r, sim.maps.nbr_map, sim.pair_eval
    chunk = sim.cfg.resolved_box_chunk
    errs = {}
    fk, phik, rhok = st.eam_pass1(r, nbr, ev, want_energy=True)
    fp, phip, rhop = st.eam_pass1_plain(r, nbr, ev, want_energy=True,
                                        box_chunk=chunk)
    torch.cuda.synchronize()
    errs["eam_pass1"] = float((fk - fp).abs().max())
    fmax = float(fp.abs().max())
    check(errs["eam_pass1"] <= f_atol + f_rtol * fmax,
          f"{tag} pass 1 force err {errs['eam_pass1']:.3e}")
    e_phi, e_rho = max_rel(phik, phip), max_rel(rhok, rhop)
    check(e_phi <= s_rtol and e_rho <= s_rtol,
          f"{tag} pass 1 scalar rel err phi {e_phi:.3e} rho {e_rho:.3e}")
    # pass 1 without the energy chain: same force and density
    fk2, phik2, rhok2 = st.eam_pass1(r, nbr, ev, want_energy=False)
    e_f2 = float((fk2 - fp).abs().max())
    check(phik2 is None and e_f2 <= f_atol + f_rtol * fmax
          and max_rel(rhok2, rhop) <= s_rtol,
          f"{tag} pass 1 want_energy=False: force err {e_f2:.3e}")
    # pass 3 on the dfEmbed field of the plain pass 1
    _f, dfe_l = sim.f_eval(rhop)
    dfe = torch.zeros(r.shape[1:], dtype=r.dtype, device=r.device)
    dfe[:sim.geom.n_local] = dfe_l
    binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
    f3k = st.eam_pass3(r, nbr, ev, dfe)
    f3p = st.eam_pass3_plain(r, nbr, ev, dfe, box_chunk=chunk)
    torch.cuda.synchronize()
    errs["eam_pass3"] = float((f3k - f3p).abs().max())
    f3max = float(f3p.abs().max())
    check(errs["eam_pass3"] <= f_atol + f_rtol * f3max,
          f"{tag} pass 3 force err {errs['eam_pass3']:.3e}")
    say("kernel", f"{tag}: pass1 |df|max {errs['eam_pass1']:.3e} "
        f"(|f|max {fmax:.3e}), phi rel {e_phi:.3e}, rho rel {e_rho:.3e}; "
        f"pass3 |df|max {errs['eam_pass3']:.3e} (|f|max {f3max:.3e})")
    return errs, (r, nbr, ev, dfe, chunk)


def compare_half(sim, tag: str, f_atol: float, s_rtol: float,
                 f_rtol: float = 0.0):
    """K2 vs plain version for EAM passes 1 (with and without energy) and 3
    on sim's state, dense unfolded outputs.  Returns ({half pass: max abs
    force err}, (r, half map, evaluator, dfEmbed, chunk))."""
    import torch
    from comd_tpu_torch.ops import binning
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.ops.sweep import fold_halo_serial
    r, hm, ev = sim.state.r, sim.maps.half_nbr_map, sim.pair_eval
    chunk = sim.cfg.resolved_box_chunk
    errs = {}
    fp, phip, rhop = st.eam_pass1_half_plain(r, hm, ev, want_energy=True,
                                             box_chunk=chunk)
    fmax = float(fp.abs().max())
    e_f = []
    for energy in (True, False):
        fk, phik, rhok = st.eam_pass1_half(r, hm, ev, want_energy=energy)
        torch.cuda.synchronize()
        e_f.append(float((fk - fp).abs().max()))
        e_s = max(norm_rel(rhok, rhop),
                  norm_rel(phik, phip) if energy else 0.0)
        check(e_f[-1] <= f_atol + f_rtol * fmax and e_s <= s_rtol
              and (phik is None) != energy,
              f"{tag} half pass 1 (energy {energy}): force err "
              f"{e_f[-1]:.3e}, scalar err {e_s:.3e}")
    errs["half_eam_pass1"] = max(e_f)
    rhobar = fold_halo_serial(sim.geom, sim.maps, rhop)
    dfe = torch.zeros(r.shape[1:], dtype=r.dtype, device=r.device)
    dfe[:sim.geom.n_local] = sim.f_eval(rhobar)[1]
    binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
    f3k = st.eam_pass3_half(r, hm, ev, dfe)
    f3p = st.eam_pass3_half_plain(r, hm, ev, dfe, box_chunk=chunk)
    torch.cuda.synchronize()
    errs["half_eam_pass3"] = float((f3k - f3p).abs().max())
    f3max = float(f3p.abs().max())
    check(errs["half_eam_pass3"] <= f_atol + f_rtol * f3max,
          f"{tag} half pass 3 force err {errs['half_eam_pass3']:.3e}")
    say("half", f"{tag}: K2 pass1 |df|max {errs['half_eam_pass1']:.3e} "
        f"(|f|max {fmax:.3e}); pass3 |df|max "
        f"{errs['half_eam_pass3']:.3e} (|f|max {f3max:.3e})")
    return errs, (r, hm, ev, dfe, chunk)


def compare_lj(sim, tag: str, f_atol: float, s_rtol: float,
               f_rtol: float = 0.0):
    """K1's and K2's LJ variants vs their plain versions on sim's state,
    with and without energy.  Returns {kernel: max abs force err}."""
    import torch
    from comd_tpu_torch.ops.cuda import stencil as st
    r, ev = sim.state.r, sim.pair_eval
    chunk = sim.cfg.resolved_box_chunk
    errs = {}
    for key, fn, plain, nbr in (
            ("lj", st.lj_pass, st.lj_pass_plain, sim.maps.nbr_map),
            ("half_lj", st.lj_pass_half, st.lj_pass_half_plain,
             sim.maps.half_nbr_map)):
        fp, ep = plain(r, nbr, ev, box_chunk=chunk)
        fmax = float(fp.abs().max())
        e_f = []
        for energy in (True, False):
            fk, ek = fn(r, nbr, ev, want_energy=energy)
            torch.cuda.synchronize()
            e_f.append(float((fk - fp).abs().max()))
            e_s = norm_rel(ek, ep) if energy else 0.0
            check(e_f[-1] <= f_atol + f_rtol * fmax and e_s <= s_rtol
                  and (ek is None) != energy,
                  f"{tag} {key} (energy {energy}): force err "
                  f"{e_f[-1]:.3e}, energy err {e_s:.3e}")
        errs[key] = max(e_f)
        say("lj", f"{tag}: {key} |df|max {errs[key]:.3e} "
            f"(|f|max {fmax:.3e})")
    return errs


def pair_work(sim, half: bool, chunk: int = 1024):
    """(candidate pairs, pairs inside the cutoff) of one sweep on sim's
    state: candidates are occupied i-slot x occupied j-slot pairs of the
    27 (or, half shell, 14 with the self-cell triangle) neighbor cells."""
    import torch
    r = sim.state.r
    n = sim.state.n_atoms.to(torch.int64)
    nbr = (sim.maps.half_nbr_map if half else sim.maps.nbr_map).to(
        torch.int64)
    n_local, n_nbr = nbr.shape
    A = r.shape[2]
    nl = n[:n_local]
    if half:
        cand = (nl * n[nbr[:, 1:]].sum(1) + nl * (nl - 1) // 2).sum()
    else:
        cand = (nl * n[nbr].sum(1)).sum()
    ok = torch.ones((A, n_nbr * A), dtype=torch.bool, device=r.device)
    if half:
        ok[:, :A] = torch.triu(ok[:, :A], diagonal=1)
    inside = 0
    for c0 in range(0, n_local, chunk):
        nb = nbr[c0:c0 + chunk]
        ri = r[:, c0:c0 + len(nb)]
        rj = r[:, nb].reshape(3, len(nb), n_nbr * A)
        dr = ri[:, :, :, None] - rj[:, :, None, :]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        inside += int(((r2 <= sim.pair_eval.rcut2) & (r2 > 0) & ok).sum())
    return int(cand), inside


def bound(sim, key: str, energy: bool = False):
    """(bound_ms, bound_by, flops, candidate pairs) of one launch of
    ``key`` on sim's state: the bound is the larger of flops / f32 peak and
    bytes / HBM rate.

    Flops: 8 per candidate pair (3 differences, 3 products, 2 sums for r2)
    plus, per pair inside the cutoff, the evaluator (Chebyshev: 4 for the
    transform and argument, 2 per output to start the recurrence, 2 + 2
    per output for each further term, 3 for the derivative factor, 1 per
    derivative output; LJ: 1 division, 3 for r6, 5 for the coefficient),
    the pair's coefficient (EAM pass 1: 1, pass 3: 3), 6 for the force
    sum, 1 per scalar sum, and, half shell, 3 + 1 per scalar for the
    j side.  A division counts as one.  Bytes: positions, neighbor map and
    dfEmbed read once, the outputs written once."""
    from comd_tpu_torch.ops.cuda import stencil as st
    half = key.startswith("half_")
    pair = key[5:] if half else key
    ev, r = sim.pair_eval, sim.state.r
    B, A = r.shape[1], r.shape[2]
    n_local = sim.geom.n_local
    esize = r.element_size()

    def cheb(wants, n_der):
        n_terms = st._cheb_params(ev, wants).n_terms
        n_out = len(wants)
        return 4 + 2 * n_out + (n_terms - 2) * (2 + 2 * n_out) + 3 + n_der

    if pair == "eam_pass1":
        wants = ([("phi", "val")] if energy else []) + \
            [("phi", "der"), ("rho", "val")]
        ns = len(wants) - 1
        per = cheb(wants, 1) + 1 + 6 + ns
    elif pair == "eam_pass3":
        ns = 0
        per = cheb([("rho", "der")], 1) + 3 + 6
    else:
        ns = 1 if energy else 0
        per = 1 + 3 + 5 + 6 + (4 if energy else 0)
    if half:
        per += 3 + ns
    cand, inside = pair_work(sim, half)
    flops = 8 * cand + per * inside
    n_nbr = 14 if half else 27
    nbytes = (3 * B * A * esize + n_local * n_nbr * 4
              + (B * A * esize if pair == "eam_pass3" else 0)
              + (3 + ns) * (B if half else n_local) * A * esize)
    t_ops, t_bytes = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, cand)


def kernel_row(sim, key: str, launches: dict, err: float, ms: float,
               plain_ms: float) -> dict:
    """The kernels-line entry of launch counter ``key``, timed on sim's
    state (pass 1 and LJ without energy, as 99 of 100 steps run them), and
    its [timing] line: time a candidate pair (occupied i-slot x occupied
    j-slot), the needed-flop rate, and the launch shape (brick, threads,
    shared memory, resident blocks an SM, list capacity)."""
    from comd_tpu_torch.ops.cuda import stencil as st
    half = key.startswith("half_")
    b_ms, b_by, flops, cand = bound(sim, key)
    pair = key[5:] if half else key
    nbr = sim.maps.half_nbr_map if half else sim.maps.nbr_map
    shp = st.launch_shape(pair, half, sim.state.r, nbr, sim.pair_eval)
    say("timing", f"{key} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}); {1e9 * ms / cand:.3f} ps a "
        f"candidate pair ({cand:,}), {flops / ms / 1e9:.3f} TFLOP/s "
        f"needed; brick {shp['brick']} x {shp['bricks']}, "
        f"{shp['threads']} threads, {shp['smem_bytes']} B shared, "
        f"{shp['blocks_per_sm']} blocks/SM, list {shp['list_cap']}")
    if half:
        tiles = sim.geom.n_local * 14
        say("timing", f"{key} j-side flushes: {shp['region_boxes']:,} "
            f"staged region boxes against {tiles:,} (cell, column) tiles "
            f"of the tile-flush design, {tiles / shp['region_boxes']:.2f}x "
            f"fewer global atomics at most")
    return {"name": key if half else f"stencil_{key}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES["half" if half
                                                   else "stencil"],
            "launches": launches[key], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def half_vs_full(sim) -> float:
    """max |f_K2 - f_K1| of the EAM force on sim's state (f32: the two
    differ by summation order only)."""
    from comd_tpu_torch.ops import binning, force_eam
    s = sim.state
    f_half, _u, _e = sim.force(s.r, s.n_atoms, want_energy=False)
    f_full, _u, _d = force_eam.eam_force(
        sim.maps.nbr_map, [s.r], sim.pair_eval, sim.f_eval,
        lambda xs, _rhobar: [binning.fill_halo_scalar_serial(
            sim.geom, sim.maps, x) for x in xs],
        want_energy=False)[0]
    return float((f_half - f_full).abs().max())


def check_comm(sim, tag: str) -> dict:
    """K3 and K4 against their plain versions on sim's shards (CUDA
    tensors), bitwise.  K3: every dfEmbed push of the staged exchange, in
    order (the y and z planes carry what x and y delivered), and the atom
    message of every face.  K4: both x-stage pushes; its local planes equal
    pass 2's F' at the same rows and the written rows equal the plain
    version's.  Returns ({kernel: max abs error}, (dfEmbed, rhobar))."""
    import torch
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.cuda import stencil as st
    h, states = sim.halo, sim.states
    nbr, ev = sim.maps.nbr_map, sim.pair_eval
    rhobar = [st.eam_pass1(s.r, nbr, ev, want_energy=False)[2]
              for s in states]
    dfe = []
    for s, rho in zip(states, rhobar):
        d = torch.zeros_like(s.gid, dtype=s.r.dtype)
        d[:rho.shape[0]] = sim.f_eval(rho)[1]
        dfe.append(d)

    def diff(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))

    err = {"ring_push": 0.0, "pass2_push": 0.0}
    a = [d.clone() for d in dfe]
    b = [d.clone() for d in dfe]
    n_push = 0
    for axis in range(3):
        (s_m, s_p), (r_m, r_p) = h.force_send[axis], h.force_recv[axis]
        for to, send, recv in ((h.minus[axis], s_m, r_p),
                               (h.plus[axis], s_p, r_m)):
            cm.ring_push([(a, a)], to, send, recv)
            cm.ring_push_plain([(b, b)], to, send, recv)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{tag}: K3 dfEmbed push, axis {axis}: "
                  f"|diff| {diff(a, b):.3e}")
            n_push += 1
    fields = [[s.r for s in states], [s.p for s in states],
              [s.gid for s in states], [s.n_atoms for s in states]]
    for axis in range(3):
        for d, to in ((0, h.minus[axis]), (1, h.plus[axis])):
            ids = h.atom_send[axis][d]
            outs = []
            for fn in (cm.ring_push, cm.ring_push_plain):
                buf = [[torch.full((f[0].shape[0], ids.numel(), f[0].shape[2])
                                   if f[0].dim() == 3 else
                                   (ids.numel(),) + tuple(f[0].shape[1:]),
                                   -1, dtype=f[0].dtype, device=f[0].device)
                        for _ in f] for f in fields]
                fn(list(zip(fields, buf)), to, ids)
                outs.append(buf)
            torch.cuda.synchronize()
            for fk, fp in zip(*outs):
                check(all(torch.equal(x, y) for x, y in zip(fk, fp)),
                      f"{tag}: K3 atom message, axis {axis}, dir {d}")
            n_push += 1
    (s_m, s_p), (r_m, r_p) = h.force_send[0], h.force_recv[0]
    for to, send, recv in ((h.minus[0], s_m, r_p), (h.plus[0], s_p, r_m)):
        a = [d.clone() for d in dfe]
        b = [d.clone() for d in dfe]
        loc_k = cm.pass2_push(rhobar, a, to, send, recv, sim.f_eval)
        loc_p = cm.pass2_push_plain(rhobar, b, to, send, recv, sim.f_eval)
        ref = [sim.f_eval(rho)[1][send] for rho in rhobar]
        torch.cuda.synchronize()
        e = max(diff(loc_k, ref), diff(a, b))
        err["pass2_push"] = max(err["pass2_push"], e)
        check(all(torch.equal(x, y) for x, y in zip(loc_k, ref)) and
              all(torch.equal(x, y) for x, y in zip(loc_p, ref)) and
              all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{tag}: K4 against pass 2's F': |diff| {e:.3e}")
    say("comm", f"{tag}: K3 bitwise on {n_push} pushes (6 dfEmbed planes, "
        f"6 atom messages), K4 bitwise on both x pushes")
    return err, (dfe, rhobar)


def comm_bound(sim, rows: int, n_launch: int, read_table: bool) -> tuple:
    """(bound_ms, "bytes") of one launch of ``n_launch`` K3 or K4 pushes
    moving ``rows`` cell rows of every shard in all: each value read once
    and written once (K4: read rho, write the local plane and the
    neighbor's rows), the row lists read once, K4's table once."""
    A = sim.cfg.max_atoms
    esize = sim.states[0].r.element_size()
    S = len(sim.states)
    per_value = 3 if read_table else 2
    nbytes = S * rows * A * esize * per_value + rows * 4 * 2
    if read_table:
        nbytes += n_launch * sim.f_eval.table.numel() * esize
    return 1e3 * nbytes / PEAK_BYTES / n_launch, "bytes"


def window_bound(sp, n_cols: int, row_len: int, n_close: int) -> tuple:
    """(bound_ms, bound_by, flops) of one window_pair launch of probe spec
    ``sp`` over ``n_cols`` columns of an rp with ``row_len`` lanes, whose
    data put ``n_close`` candidate pairs inside the cutoff.

    Flops, as ``bound()`` counts K1's (an FMA as 2, a division or
    reciprocal as 1, compares, selects, clip and conversions as 0): 8 per
    candidate pair for r2 (3 differences, 3 products, 2 sums), then per
    pair inside the cutoff what the sums need of it: P1 4 (reciprocal, the
    force product and sum, the r2 sum); LJ 13 (reciprocal, r6 2, the
    coefficient 4, the energy 2, the force product and sum 2, 2 sums);
    Clenshaw 2 for t2, 3 (N - 2) + 4 for a chain of N coefficients, 1 for
    -2 dphi, 2 for the force and 2 sums.  The kernel evaluates every
    candidate pair branch-free; the terms outside the cutoff are zeros the
    function does not need, so they are not counted.  Bytes: rp read once,
    the outputs written once."""
    from comd_tpu_torch.probes import window
    A = window.SLOTS
    if sp.physics == "inv_r2":
        per = 4
    elif sp.physics == "lj":
        per = 13
    else:
        per = 2 + sum(3 * (len(c) - 2) + 4
                      for c in (sp.phi, sp.dphi, sp.rho)) + 1 + 2 + 2
    flops = 8 * window.n_pairs(sp, n_cols) + per * n_close
    nbytes = 4 * (3 * A * row_len + sp.n_out * A * n_cols)
    t_ops, t_bytes = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops)


def lookup_bound(x, tab, flops_per_value: int) -> tuple:
    """(bound_ms, bound_by) of one lookup launch: x read and the output
    written once, the table read once; flops per value from the kernel
    (P4 8: u, 3 adds, 2 products, the scale and the add to x; P5 4)."""
    nbytes = 4 * (2 * x.numel() + tab.numel())
    t_ops = 1e3 * flops_per_value * x.numel() / PEAK_F32_FLOPS
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def run_probes(k1_pass1: tuple) -> dict:
    """Phase 13: the probe commands P1-P6 with the launch counts zeroed
    just before and read just after; then each kernel against its plain
    version at the probes' own shapes (window_pair: every element within
    1e-5 of its own scale, the sum of its terms' magnitudes, and every
    output within 1e-5 of its largest value, all finite; the lookups bit
    for bit at scale 1e-12 and 1, on the probes' tables and on tables
    whose columns differ); times beside plain versions and bounds; P3's
    physics at 72 chunks beside K1's pass 1 (``k1_pass1``: ms, slot pairs,
    occupied candidate pairs, flops the function needs).
    Returns the three kernels-line rows."""
    import numpy as np
    import torch
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.probes import lookup, time_ms, window
    st.reset_launch_counts()
    for argv in (["1"], ["2"], ["3"], ["3", "--lj"]):
        window.main(argv)
    for probe in ("4", "5", "6"):
        lookup.main([probe])
    launches = {k: st.LAUNCHES[k] for k in PROBE_KEYS}
    for k, n in launches.items():
        check(n > 0, f"probes: {k} launched {n} times by the commands")
    say("probes", f"launches in the probe commands' run: {launches}")

    timed = {}
    for sp, chunks in ((window.P1, None), (window.P2, None),
                       (window.P3, None), (window.P3_LJ, None),
                       (window.P3, 72), (window.P3_LJ, 72)):
        probe = int(sp.name[1])
        rp = torch.from_numpy(window.make_inputs(probe, chunks)).cuda()
        got = window.window_pair(rp, sp)
        want = window.window_pair_plain(rp, sp)
        scale = window.window_pair_magnitude(rp, sp)
        n_close = window.n_in_cutoff(rp, sp)
        check(all(bool(torch.isfinite(t).all()) for t in got + want),
              f"window_pair {sp.name}: non-finite sums")
        rel = max(norm_rel(a, b) for a, b in zip(got, want))
        elem = window.element_error(got, want, scale)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        n_cols = got[0].shape[1]
        tag = f"{sp.name} {n_cols // window.CHUNK} chunks"
        check(rel <= 1e-5 and elem <= 1e-5,
              f"window_pair {tag}: max|a-b|/max|b| {rel:.3e}, max|a-b|/S "
              f"{elem:.3e}")
        del got, want, scale
        ms = time_ms(lambda: window.window_pair(rp, sp), 20)
        plain_ms = time_ms(lambda: window.window_pair_plain(rp, sp), 2)
        b_ms, b_by, flops = window_bound(sp, n_cols, rp.shape[2], n_close)
        pairs = window.n_pairs(sp, n_cols)
        say("timing", f"window_pair {tag} ({pairs:,} pairs, {n_close:,} "
            f"inside the cutoff): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms; bound {b_ms:.4f} ms ({b_by}); {pairs / ms / 1e6:.2f} "
            f"Gpairs/s, {flops / ms / 1e9:.3f} TFLOP/s needed; max|a-b|/S "
            f"{elem:.2e}, max|a-b|/max|b| {rel:.2e}")
        timed[tag] = (err, ms, plain_ms, b_ms, b_by, pairs, flops)
        del rp
    k1_ms, k1_slots, k1_cand, k1_flops = k1_pass1
    for name in ("P3", "P3 LJ"):
        _e, ms, _p, _b, _by, pairs, flops = timed[f"{name} 72 chunks"]
        say("probes", f"{name} at 72 chunks: {pairs:,} candidate pairs in "
            f"{ms:.4f} ms = {1e9 * ms / pairs:.3f} ps a pair, "
            f"{flops / ms / 1e9:.3f} TFLOP/s needed; K1 EAM pass 1 (phase "
            f"5): {k1_slots:,} slot pairs ({k1_cand:,} occupied) in "
            f"{k1_ms:.4f} ms = {1e9 * k1_ms / k1_slots:.3f} "
            f"({1e9 * k1_ms / k1_cand:.3f}) ps a pair, "
            f"{k1_flops / k1_ms / 1e9:.3f} TFLOP/s needed")

    rng = np.random.default_rng(7)
    x4, t4 = (torch.from_numpy(a).cuda() for a in lookup.make_inputs(4))
    x5, t5 = (torch.from_numpy(a).cuda() for a in lookup.make_inputs(5))
    other4 = torch.from_numpy(rng.normal(size=tuple(t4.shape)).astype(
        np.float32)).cuda()
    other5 = torch.from_numpy(rng.normal(size=tuple(t5.shape)).astype(
        np.float32)).cuda()
    for scale in (lookup.SCALE, 1.0):
        for tab in (t4, other4):
            check(torch.equal(lookup.row_lookup(x4, tab, scale),
                              lookup.row_lookup_plain(x4, tab, scale)),
                  f"row_lookup differs from its plain version (scale "
                  f"{scale})")
        for tab in (t5, other5):
            got = lookup.lane_lookup(x5, tab, scale)
            check(torch.equal(got, lookup.lane_lookup_plain(x5, tab, scale))
                  and torch.equal(lookup.onehot_lookup(x5, tab, scale), got),
                  f"lane_lookup differs from its plain version (scale "
                  f"{scale})")
    say("probes", "row_lookup (P4) and lane_lookup (P5 = P6) bit for bit "
        "against their plain versions at scale 1e-12 and 1, on the probes' "
        "tables and on tables whose columns differ")

    e, ms, plain_ms, b_ms, b_by, _pairs, _fl = timed["P3 8 chunks"]
    rows = {"window_pair": (e, ms, plain_ms, b_ms, b_by)}
    for key, fn, plain, x, tab, per in (
            ("row_lookup", lookup.row_lookup, lookup.row_lookup_plain, x4, t4,
             8),
            ("lane_lookup", lookup.lane_lookup, lookup.lane_lookup_plain, x5,
             t5, 4)):
        ms = time_ms(lambda: fn(x, tab), 20)
        plain_ms = time_ms(lambda: plain(x, tab), 20)
        b_ms, b_by = lookup_bound(x, tab, per)
        say("timing", f"{key} {x.numel():,} lookups: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
            f"{x.numel() / ms / 1e6:.2f} G lookups/s, "
            f"{8 * x.numel() / ms / 1e9:.3f} TB/s of x and out")
        rows[key] = (0.0, ms, plain_ms, b_ms, b_by)
    return {k: {"name": k, "route": "cuda", "source": PROBE_SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            for k, (e, ms, plain_ms, b_ms, b_by) in rows.items()}


def run_main(tag: str, keys, n_blocks: int = 10, block: int = 10,
             on_init=None, **kw):
    """One main path at full width through the user entry points
    (init_simulation, step_block), launch counts zeroed just before and read
    just after.  ``on_init(sim)`` runs on the initial state, its launches
    taken out of the counts.  Checks atom count, overflow,
    |eFinal/eInitial - 1| < 1e-4 and that each kernel in ``keys`` launched at
    least once per step.  Returns (sim, launches in this run)."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import stencil as st
    n = HEADLINE_N
    cfg = Config(nx=n, ny=n, nz=n, temperature=600.0, dtype="float32",
                 max_atoms=0, cell_mode="auto", pot_dir=POTS, device="cuda",
                 **kw)
    st.reset_launch_counts()
    t0 = time.perf_counter()
    sim = init_simulation(cfg)
    t_init = time.perf_counter() - t0
    n = sim.n_global
    e0 = (sim.e_potential + sim.kinetic_energy()) / n
    at_init = dict(st.LAUNCHES)
    if on_init is not None:
        on_init(sim)
        st.LAUNCHES.update(at_init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        sim.step_block(block)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches = dict(st.LAUNCHES)
    n_steps = n_blocks * block
    e1 = (sim.e_potential + sim.kinetic_energy()) / n
    n_atoms = sim.sum_atoms()
    check(n_atoms == n, f"{tag}: atoms lost: {n_atoms} of {n}")
    check(not sim.overflow, f"{tag}: capacity overflow")
    check(abs(e1 / e0 - 1.0) < 1e-4, f"{tag}: eFinal/eInitial {e1 / e0!r}")
    for k in keys:
        check(launches[k] - at_init[k] >= n_steps,
              f"{tag}: {k} launched {launches[k] - at_init[k]} times in "
              f"{n_steps} steps")
    ms_step = 1e3 * t_loop / n_steps
    sim.ms_step = ms_step
    say(tag, f"{HEADLINE_N}^3 n={n} A={sim.cfg.max_atoms} "
        f"grid={sim.geom.grid} "
        f"mode={sim.cfg.cell_mode} skin={sim.skin:.4f} "
        f"rebuckets={sim.n_rebucket} init {t_init:.2f} s; "
        f"{n_steps} steps {ms_step:.3f} ms/step "
        f"{n * n_steps / t_loop:.4e} atom-steps/s; eInitial {e0:.12f} "
        f"eFinal {e1:.12f} ratio-1 {e1 / e0 - 1.0:.3e}; launches "
        f"{ {k: launches[k] for k in keys} }")
    return sim, launches


def golden(tag: str, value: float, **kw) -> None:
    from comd_tpu_torch import Config, init_simulation
    sim = init_simulation(Config(temperature=0.0, initial_delta=0.0,
                                 dtype="float64", pot_dir=POTS,
                                 device="cuda", **kw))
    e_atom = sim.e_potential / sim.n_global
    check(abs(e_atom - value) < 1e-9, f"golden {tag} {e_atom!r} vs {value}")
    say("golden", f"{tag} A={sim.cfg.max_atoms} grid={sim.geom.grid} f64: "
        f"{e_atom:.12f} eV/atom (|diff| {abs(e_atom - value):.2e})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.cuda import probe as pr
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.probes import time_ms

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("device", f"{kind}, {count} visible, torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda m: m.build(), (st, cm, pr)))
    t_build = time.perf_counter() - t0
    for mod, stem in ((st, "stencil"), (cm, "comm"), (pr, "probe")):
        log = os.path.join(st.BUILD_DIR, f"{stem}_ptxas.log")
        entries = []       # (mangled name, registers, spill store bytes)
        if os.path.exists(log):
            for block in open(log).read().split(
                    "Compiling entry function '")[1:]:
                regs = re.search(r"Used (\d+) registers", block)
                spill = re.search(r"(\d+) bytes spill stores", block)
                entries.append((block.split("'")[0],
                                int(regs.group(1)) if regs else 0,
                                int(spill.group(1)) if spill else 0))
        regs = [e[1] for e in entries]
        say("build", f"{stem}.cu: nvcc sm_90a in {mod.BUILD_SECONDS:.1f} s; "
            f"{len(entries)} kernels, registers {min(regs, default=0)}.."
            f"{max(regs, default=0)}, max spill stores "
            f"{max((e[2] for e in entries), default=0)} bytes")
        if stem == "stencil":
            # stencil_kernel<T, PAIR, EVAL, ...>: f32 K1/K2 on the main
            # paths are the Chebyshev (EVAL 0) and LJ variants
            spill = {}
            for name, nreg, nspill in entries:
                m = re.search(r"stencil_kernelI([fd])Li(\d)ELi(\d)E", name)
                if m:
                    tag = ("f32" if m.group(1) == "f" else "f64") + (
                        " table" if m.group(3) == "1" else "")
                    spill[tag] = max(spill.get(tag, 0), nspill)
            say("build", "stencil.cu spill stores by variant (bytes, max): "
                + ", ".join(f"{k} {v}" for k, v in sorted(spill.items())))
            check(spill.get("f32", 0) == 0,
                  f"f32 stencil kernels spill {spill.get('f32')} bytes")
    say("build", f"three sources in {t_build:.1f} s")

    # 3. K1 vs plain version on a thermalized 10^3 lattice
    for dtype, impl, f_atol, s_rtol, f_rtol in (
            ("float32", "cheb", 1e-4, 1e-5, 0.0),
            ("float64", "rows", 0.0, 1e-12, 1e-12)):
        sim = init_simulation(Config(
            nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
            dtype=dtype, interp_impl=impl, pot_dir=POTS, device="cuda"))
        sim.step_block(10)      # thermalize: atoms off their sites
        compare_passes(sim, f"10^3 {dtype}/{sim.pair_eval.kind} "
                       f"A={sim.cfg.max_atoms}", f_atol, s_rtol, f_rtol)

    # 4. golden on the card (f64, exact table evaluator through K1)
    golden("Adams Cu 6^3 T=0", GOLDEN_EAM_ADAMS, nx=6, ny=6, nz=6,
           doeam=True)

    # 5. main path at full width: the 63^3 headline run
    serial_epot = []
    sim, launches = run_main(
        "main", ("eam_pass1", "eam_pass3"), doeam=True,
        on_init=lambda x: serial_epot.append(x.e_potential))
    serial_ms = sim.ms_step
    rows = {}
    # K1 vs plain at the main path's shape (not counted: read above)
    errs, (r, nbr, ev, dfe, chunk) = compare_passes(
        sim, f"{HEADLINE_N}^3 float32/cheb", 1e-4, 1e-5)
    k1_ms = {
        "eam_pass1": (
            time_ms(lambda: st.eam_pass1(r, nbr, ev, want_energy=False), 20),
            time_ms(lambda: st.eam_pass1_plain(
                r, nbr, ev, want_energy=False, box_chunk=chunk), 2)),
        "eam_pass3": (
            time_ms(lambda: st.eam_pass3(r, nbr, ev, dfe), 20),
            time_ms(lambda: st.eam_pass3_plain(r, nbr, ev, dfe,
                                               box_chunk=chunk), 2)),
    }
    for k, (ms, plain) in k1_ms.items():
        rows[k] = kernel_row(sim, k, launches, errs[k], ms, plain)
    # K1 pass 1 beside the window probe (phase 13): its time, slot pairs,
    # occupied candidate pairs and flops (its bound is operations)
    check(rows["eam_pass1"]["bound_by"] == "operations",
          "K1 pass 1 bound by bytes")
    _b, _by, k1_flops, k1_cand = bound(sim, "eam_pass1")
    k1_pass1 = (k1_ms["eam_pass1"][0],
                sim.geom.n_local * 27 * sim.cfg.max_atoms ** 2, k1_cand,
                k1_flops)
    # K1 sums each i's pairs in one fixed order: two launches, same bits
    for energy in (True, False):
        a = st.eam_pass1(r, nbr, ev, want_energy=energy)
        b = st.eam_pass1(r, nbr, ev, want_energy=energy)
        check(all(x is y or torch.equal(x, y) for x, y in zip(a, b)),
              f"K1 pass 1 (energy {energy}) differs between two launches")
    check(torch.equal(st.eam_pass3(r, nbr, ev, dfe),
                      st.eam_pass3(r, nbr, ev, dfe)),
          "K1 pass 3 differs between two launches")
    say("kernel", f"{HEADLINE_N}^3: two launches of K1 pass 1 (with and "
        f"without energy) and pass 3 give the same bits")
    del sim, r, nbr, ev, dfe

    # 6. K2 (EAM, LJ) and K1's LJ variant vs plain versions at 10^3
    for dtype, impl, f_atol, s_rtol, f_rtol in (
            ("float32", "cheb", 1e-4, 1e-5, 0.0),
            ("float64", "rows", 0.0, 1e-12, 1e-12)):
        for doeam in (True, False):
            sim = init_simulation(Config(
                nx=10, ny=10, nz=10, doeam=doeam, half_shell=True,
                temperature=600.0, dtype=dtype, interp_impl=impl,
                pot_dir=POTS, device="cuda"))
            sim.step_block(10)
            tag = (f"10^3 {dtype}/{sim.pair_eval.kind} "
                   f"A={sim.cfg.max_atoms}")
            if doeam:
                compare_half(sim, tag, f_atol, s_rtol, f_rtol)
            else:
                compare_lj(sim, tag, f_atol, s_rtol, f_rtol)

    # 7. goldens through the kernels (f64)
    golden("Adams Cu 6^3 T=0 --halfShell", GOLDEN_EAM_ADAMS, nx=6, ny=6,
           nz=6, doeam=True, half_shell=True)
    for half in (False, True):
        hs = " --halfShell" if half else ""
        golden(f"LJ 6^3 T=0{hs}", GOLDEN_LJ, nx=6, ny=6, nz=6,
               half_shell=half)
        golden(f"LJ 5sigma 8^3 T=0{hs}", GOLDEN_LJ_5SIGMA, nx=8, ny=8, nz=8,
               lj_cutoff_factor=5.0, half_shell=half)

    # 8. the headline run with --halfShell (K2)
    # K2's force against K1's at the initial and final states, bound 1e-4
    # eV/A (f32, the two differ by summation order only)
    d_init = []
    sim, launches = run_main("half main", ("half_eam_pass1",
                                           "half_eam_pass3"),
                             on_init=lambda x: d_init.append(half_vs_full(x)),
                             doeam=True, half_shell=True)
    d_final = half_vs_full(sim)
    check(max(d_init[0], d_final) <= 1e-4, f"half vs full force: initial "
          f"{d_init[0]:.3e}, final {d_final:.3e}")
    errs, (r, hm, ev, dfe, chunk) = compare_half(
        sim, f"{HEADLINE_N}^3 float32/cheb", 1e-4, 1e-5)
    nbr = sim.maps.nbr_map
    times = {
        "half_eam_pass1": (
            time_ms(lambda: st.eam_pass1_half(r, hm, ev, want_energy=False),
                    20),
            time_ms(lambda: st.eam_pass1_half_plain(
                r, hm, ev, want_energy=False, box_chunk=chunk), 2)),
        "half_eam_pass3": (
            time_ms(lambda: st.eam_pass3_half(r, hm, ev, dfe), 20),
            time_ms(lambda: st.eam_pass3_half_plain(r, hm, ev, dfe,
                                                    box_chunk=chunk), 2)),
    }
    k1_here = (time_ms(lambda: st.eam_pass1(r, nbr, ev, want_energy=False),
                       20),
               time_ms(lambda: st.eam_pass3(r, nbr, ev, dfe), 20))
    for k, (ms, plain) in times.items():
        rows[k] = kernel_row(sim, k, launches, errs[k], ms, plain)
    say("timing", f"K1 at the same state: pass1 {k1_here[0]:.4f} ms, "
        f"pass3 {k1_here[1]:.4f} ms; |f_half - f_full|max final "
        f"{d_final:.3e} (initial {d_init[0]:.3e})")
    del sim, r, hm, nbr, ev, dfe

    # 9. LJ at 63^3: full shell (K1) and --halfShell (K2)
    for half, key in ((False, "lj"), (True, "half_lj")):
        sim, launches = run_main("LJ half main" if half else "LJ main",
                                 (key,), half_shell=half)
        errs = compare_lj(sim, f"{HEADLINE_N}^3 float32", 1e-4, 1e-5)
        r, ev, chunk = sim.state.r, sim.pair_eval, sim.cfg.resolved_box_chunk
        fn, plain = ((st.lj_pass_half, st.lj_pass_half_plain) if half
                     else (st.lj_pass, st.lj_pass_plain))
        nbr = sim.maps.half_nbr_map if half else sim.maps.nbr_map
        ms = time_ms(lambda: fn(r, nbr, ev, want_energy=False), 20)
        plain_ms = time_ms(lambda: plain(r, nbr, ev, want_energy=False,
                                         box_chunk=chunk), 2)
        rows[key] = kernel_row(sim, key, launches, errs[key], ms, plain_ms)
        del sim, r, ev, nbr

    # 10. K3 and K4 against their plain versions, thermalized 10^3 EAM
    for dtype in ("float32", "float64"):
        sim = init_simulation(Config(
            nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
            dtype=dtype, pot_dir=POTS, device="cuda", comm_impl="ki_fused",
            **MESH))
        sim.step_block(10)
        check_comm(sim, f"10^3 {dtype} 2x2x2 A={sim.cfg.max_atoms} "
                        f"grid={sim.geom.grid}")
        del sim

    # 11. sharded goldens (f64, T = 0)
    for half in (False, True):
        golden(f"Adams Cu 6^3 T=0 2x2x2 ki_fused"
               f"{' --halfShell' if half else ''}", GOLDEN_EAM_ADAMS,
               nx=6, ny=6, nz=6, doeam=True, half_shell=half,
               comm_impl="ki_fused", **MESH)
    golden("LJ 12x8x4 T=0 3x2x1 ki", GOLDEN_LJ, nx=12, ny=8, nz=4, xproc=3,
           yproc=2, zproc=1, comm_impl="ki")

    # 12. the headline on a 2x2x2 mesh of shards: ki_fused, then collective
    final = {}
    for ci in ("ki_fused", "collective"):
        keys = ("eam_pass1", "eam_pass3") + (
            ("ring_push", "pass2_push") if ci == "ki_fused" else ())
        e0 = []
        sim, launches_ci = run_main(
            f"sharded main {ci}", keys, doeam=True, comm_impl=ci,
            on_init=lambda x: e0.append(x.e_potential), **MESH)
        rel = abs(e0[0] / serial_epot[0] - 1.0)
        check(rel < 1e-6, f"sharded {ci}: initial ePot {e0[0]!r} vs serial "
              f"{serial_epot[0]!r}")
        say("sharded main", f"{ci}: initial ePot rel. diff to the serial "
            f"run {rel:.3e}; {sim.ms_step:.3f} ms/step on 8 shards against "
            f"{serial_ms:.3f} serial (phase 5)")
        final[ci] = ([s.r for s in sim.states], sim.e_potential)
        if ci == "ki_fused":
            launches = launches_ci
            sharded = sim
        else:
            del sim
    same_r = all(torch.equal(a, b) for a, b in zip(final["ki_fused"][0],
                                                     final["collective"][0]))
    check(same_r and final["ki_fused"][1] == final["collective"][1],
          f"ki_fused and collective differ: r equal {same_r}, ePot "
          f"{final['ki_fused'][1]!r} vs {final['collective'][1]!r}")
    say("sharded main", f"final r and ePot of ki_fused and collective equal "
        f"bit for bit (ePot {final['ki_fused'][1]:.6f})")
    del final
    errs, (dfe, rhobar) = check_comm(sharded, f"{HEADLINE_N}^3 float32 2x2x2")
    h = sharded.halo
    x = [d.clone() for d in dfe]
    yz = [(h.minus[a], h.force_send[a][0], h.force_recv[a][1])
          for a in (1, 2)] + [(h.plus[a], h.force_send[a][1],
                               h.force_recv[a][0]) for a in (1, 2)]
    xs = [(h.minus[0], h.force_send[0][0], h.force_recv[0][1]),
          (h.plus[0], h.force_send[0][1], h.force_recv[0][0])]

    def pushes(fn):
        for to, send, recv in yz:
            fn([(x, x)], to, send, recv)

    def fused(fn):
        for to, send, recv in xs:
            fn(rhobar, x, to, send, recv, sharded.f_eval)

    times = {
        "ring_push": (time_ms(lambda: pushes(cm.ring_push), 20) / 4,
                      time_ms(lambda: pushes(cm.ring_push_plain), 20) / 4,
                      comm_bound(sharded, sum(v[1].numel() for v in yz), 4,
                                 False)),
        "pass2_push": (time_ms(lambda: fused(cm.pass2_push), 20) / 2,
                       time_ms(lambda: fused(cm.pass2_push_plain), 20) / 2,
                       comm_bound(sharded, sum(v[1].numel() for v in xs), 2,
                                  True)),
    }
    for k, (ms, plain_ms, (b_ms, b_by)) in times.items():
        say("timing", f"{k} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}); {launches[k]} launches in "
            f"the main path's run (init and 100 steps)")
        rows[k] = {"name": k, "route": "cuda", "source": COMM_SOURCE,
                   "replaces": REPLACES[k], "launches": launches[k],
                   "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    del sharded, x, dfe, rhobar

    # 13. the archive probes P1-P6 on their kernels
    rows.update(run_probes(k1_pass1))

    kernels = [rows[k] for k in ("eam_pass1", "eam_pass3", "lj",
                                 "half_eam_pass1", "half_eam_pass3",
                                 "half_lj", "ring_push", "pass2_push")
               + PROBE_KEYS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
