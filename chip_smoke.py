#!/usr/bin/env python3
"""Smoke run of comd_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, failing (non-zero exit, no result line) on the first
error:
  1. device   -- a CUDA card is required; prints nvidia-smi's name and
                 power limit
  2. build    -- compiles the cell-stencil kernel (csrc/stencil.cu) with nvcc
  3. kernel   -- the kernel against its plain PyTorch version on the same
                 CUDA tensors (thermalized 10^3 lattice, T = 600 K), EAM
                 pass 1 and pass 3, f32/Chebyshev and f64/table
  4. golden   -- T = 0 Adams Cu cohesive energy at 6^3, f64, through the
                 kernel: -3.538079224691 eV/atom within 1e-9
  5. main     -- the headline run: 63^3 FCC Cu (1,000,188 atoms), EAM
                 funcfl, f32, auto commensurate cells, lazy-shell stepping,
                 10 x step_block(10); checks atom count, overflow, energy
                 drift and that every step launched both kernel passes, then
                 times each pass against its plain version at that shape.
Then the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Imports torch and comd_tpu_torch only; builds everything from this
checkout.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
POTS = os.path.join(ROOT, "pots")
GOLDEN_EAM_ADAMS = -3.538079224691
REPLACES = "comd_tpu/ops/pallas/stencil.py:48"
SOURCE = "comd_tpu_torch/csrc/stencil.cu"


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def compare_passes(sim, tag: str, f_atol: float, s_rtol: float,
                   f_rtol: float = 0.0):
    """Kernel vs plain version for pass 1 and pass 3 on sim's state.
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import stencil as st

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("device", f"{kind}, {count} visible, torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    st.build()
    log = os.path.join(st.BUILD_DIR, "stencil_ptxas.log")
    regs, spills = [], []
    if os.path.exists(log):
        text = open(log).read()
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             text)]
    say("build", f"nvcc sm_90a in {st.BUILD_SECONDS:.1f} s; "
        f"registers {min(regs, default=0)}..{max(regs, default=0)}, "
        f"max spill stores {max(spills, default=0)} bytes")

    # 3. kernel vs plain version on a thermalized 10^3 lattice
    for dtype, impl, f_atol, s_rtol, f_rtol in (
            ("float32", "cheb", 1e-4, 1e-5, 0.0),
            ("float64", "rows", 0.0, 1e-12, 1e-12)):
        sim = init_simulation(Config(
            nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
            dtype=dtype, interp_impl=impl, pot_dir=POTS, device="cuda"))
        sim.step_block(10)      # thermalize: atoms off their sites
        compare_passes(sim, f"10^3 {dtype}/{sim.pair_eval.kind} "
                       f"A={sim.cfg.max_atoms}", f_atol, s_rtol, f_rtol)

    # 4. golden on the card (f64, exact table evaluator through the kernel)
    sim = init_simulation(Config(
        nx=6, ny=6, nz=6, doeam=True, temperature=0.0, initial_delta=0.0,
        dtype="float64", pot_dir=POTS, device="cuda"))
    e_atom = sim.e_potential / sim.n_global
    check(abs(e_atom - GOLDEN_EAM_ADAMS) < 1e-9,
          f"golden {e_atom!r} vs {GOLDEN_EAM_ADAMS}")
    say("golden", f"Adams Cu 6^3 T=0 f64: {e_atom:.12f} eV/atom "
        f"(|diff| {abs(e_atom - GOLDEN_EAM_ADAMS):.2e})")

    # 5. main path at full width: the 63^3 headline run
    cfg = Config(nx=63, ny=63, nz=63, doeam=True, temperature=600.0,
                 dtype="float32", max_atoms=0, cell_mode="auto",
                 pot_dir=POTS, device="cuda")
    st.reset_launch_counts()
    t0 = time.perf_counter()
    sim = init_simulation(cfg)
    t_init = time.perf_counter() - t0
    n = sim.n_global
    e0 = (sim.e_potential + sim.kinetic_energy()) / n
    at_init = dict(st.LAUNCHES)
    n_blocks, block = 10, 10
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
    check(n_atoms == n, f"atoms lost: {n_atoms} of {n}")
    check(not bool(sim.state.overflow), "cell capacity overflow")
    check(abs(e1 / e0 - 1.0) < 1e-4, f"eFinal/eInitial {e1 / e0!r}")
    for k in launches:
        check(launches[k] - at_init[k] >= n_steps,
              f"{k} launched {launches[k] - at_init[k]} times in "
              f"{n_steps} steps")
    ms_step = 1e3 * t_loop / n_steps
    say("main", f"63^3 n={n} A={sim.cfg.max_atoms} grid={sim.geom.grid} "
        f"mode={sim.cfg.cell_mode} skin={sim.skin:.4f} "
        f"rebuckets={sim.n_rebucket} init {t_init:.2f} s; "
        f"{n_steps} steps {ms_step:.3f} ms/step "
        f"{n * n_steps / t_loop:.4e} atom-steps/s; eInitial {e0:.12f} "
        f"eFinal {e1:.12f} ratio-1 {e1 / e0 - 1.0:.3e}; launches {launches}")

    # kernel vs plain at the main path's shape (not counted: read above)
    errs, (r, nbr, ev, dfe, chunk) = compare_passes(
        sim, "63^3 float32/cheb", 1e-4, 1e-5)
    times = {
        "eam_pass1": (
            cuda_ms(lambda: st.eam_pass1(r, nbr, ev, want_energy=False), 20),
            cuda_ms(lambda: st.eam_pass1_plain(
                r, nbr, ev, want_energy=False, box_chunk=chunk), 2)),
        "eam_pass3": (
            cuda_ms(lambda: st.eam_pass3(r, nbr, ev, dfe), 20),
            cuda_ms(lambda: st.eam_pass3_plain(r, nbr, ev, dfe,
                                               box_chunk=chunk), 2)),
    }
    for k, (ms, plain) in times.items():
        say("timing", f"{k} kernel {ms:.4f} ms, plain {plain:.4f} ms "
            f"(box_chunk {chunk})")

    kernels = [{"name": f"stencil_{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in ("eam_pass1", "eam_pass3")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
