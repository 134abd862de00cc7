#!/usr/bin/env python3
"""Where the time of a comd_tpu_torch step goes on one NVIDIA GPU.

    python3 profile_step.py                        # serial EAM headline
    python3 profile_step.py --mesh 2 2 2 --comm ki_fused
    python3 profile_step.py --mesh 2 2 2 --comm collective --half
    python3 profile_step.py --method thread_atom_nl      # Verlet lists
    python3 profile_step.py --lj --pairlist              # LJ -L
    python3 profile_step.py --spline                     # -e -P
    python3 profile_step.py --lj --interp                # -I
    python3 profile_step.py --mesh 2 2 2 --gpuAsync 1    # -a 1: the split
    python3 profile_step.py -S 0                   # a rebucket every step
    python3 profile_step.py --eager                # the eager loop
    python3 profile_step.py --tree _scratch/parent  # another checkout's
                                                    # package, same run

Runs the 63^3 EAM headline (f32, lazy stepping; the run of chip_smoke.py
phases 5, 8 and 12), or with ``--method``/``--lj``/``--pairlist`` the
neighbor-list runs of phase 14, through ``init_simulation`` and
``step_block``, stepping through the step's CUDA graphs
(comd_tpu_torch/stepgraph.py: one a step, the rebucket a conditional
node of it; with ``-S 0`` a rebucket every step) or, with ``--eager``,
the eager loop of the same step functions: warm-up
blocks of 10 steps up to the first rebucket (its kernels load on first
use), ``--steps`` steps (blocks of 10) timed by the host clock, then as
many under torch.profiler (device activity only).  Prints one JSON
line: ms/step, the device's busy time per step (the sum of the kernels'
durations: one stream, so they do not overlap) and its idle share of the
unprofiled wall clock, kernel launches per step, the kernels that take the
most device time, the device time of one launch of each hand-written
kernel (K1/K2, the halo and list kernels, the step's
kick_drift_trigger, refresh_halo, embed_fill and land, the list
paths' embed_rows, land_rows and nl_rows, the
redistribution's rebucket_bin and rebucket_place, and on a mesh the atom
exchange's arrivals_bin, arrivals_place and sort_cells, and the ghost
refresh's position_fill, the collective atom messages' atom_pack and the
half-shell fold's fold_halo), the gap in the
trace from the end of a step's last kick_drift_trigger to the start of
its force's first pair kernel (median, least and largest over the
profiled steps: the median is a step's that does not rebucket, where
the branch sits and, on a mesh, the position exchange), the graphs'
capture and instantiation seconds, and
one redistribution run eagerly (host ms to enqueue it, ms to its end,
device ms, device operations and the eight that take the most device
time: serially csrc/rebucket.cu's two launches, the halo fill and the
counter's add; on a mesh also the exchange's ring_push and
csrc/arrivals.cu's launches, and the copies into the step's buffers),
and on a mesh one ghost refresh run eagerly (the lazy step's other IF
body: its device operations and device ms; one position_fill launch).
Needs a CUDA device; prints the card's name and power limit beside the
numbers.  The JSON also holds the sha256 of every shard's positions and
the potential energy after the timed and profiled steps (before the eager
redistribution), so that two trees driven through ``--tree`` in one call
show whether they step the same bits.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def head_gaps(prof, device_type) -> list:
    """Microseconds from the end of each step's last kick_drift_trigger
    kernel to the start of the next pair kernel (K1/K2's stencil_kernel,
    NL2's pack or sweep) in ``prof``'s device trace."""
    evs = sorted((e for e in prof.events()
                  if e.device_type == device_type.CUDA),
                 key=lambda e: e.time_range.start)
    gaps, end = [], None
    for e in evs:
        if "kick_drift_trigger_kernel" in e.name:
            end = e.time_range.end
        elif end is not None and any(k in e.name for k in (
                "stencil_kernel", "nl_pack_kernel", "nl_sweep_kernel")):
            gaps.append(e.time_range.start - end)
            end = None
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=63, help="unit cells per axis")
    ap.add_argument("--mesh", type=int, nargs=3, default=(1, 1, 1))
    ap.add_argument("--comm", default="collective",
                    choices=["collective", "ki", "ki_fused"])
    ap.add_argument("--half", action="store_true", help="--halfShell")
    ap.add_argument("--method", default="thread_atom", help="-m")
    ap.add_argument("--lj", action="store_true", help="Lennard-Jones")
    ap.add_argument("--pairlist", action="store_true", help="-L")
    ap.add_argument("--spline", action="store_true", help="-P")
    ap.add_argument("--interp", action="store_true", help="-I")
    ap.add_argument("--gpuAsync", type=int, default=-1, choices=[-1, 0, 1],
                    help="-a (-1: auto)")
    ap.add_argument("-S", dest="lazy", type=int, default=1, choices=[0, 1],
                    help="lazy shell (0: a rebucket every step)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--eager", action="store_true",
                    help="step the eager loop, not the CUDA graphs")
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose comd_tpu_torch runs (default: "
                         "this one)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    px, py, pz = args.mesh
    sim = init_simulation(Config(
        nx=args.n, ny=args.n, nz=args.n, doeam=not args.lj,
        temperature=600.0, dtype="float32",
        pot_dir=os.path.join(ROOT, "pots"), device="cuda", xproc=px,
        yproc=py, zproc=pz, comm_impl=args.comm, half_shell=args.half,
        method=args.method, use_pairlist=args.pairlist, spline=args.spline,
        lj_interpolation=args.interp, gpu_async=args.gpuAsync,
        lazy_shell=bool(args.lazy)))
    sim.cuda_graphs = not args.eager
    # warm up through a rebucket: its kernels load on their first launch
    for _ in range(20):
        sim.step_block(10)
        if sim.n_rebucket:
            break
    blocks = args.steps // 10
    steps = 10 * blocks
    # the wall clock without the profiler, then the device's kernels under
    # it (CUDA activity only: the host-side tracing would slow the loop)
    torch.cuda.synchronize()
    rebuckets = sim.n_rebucket
    t0 = time.perf_counter()
    for _ in range(blocks):
        sim.step_block(10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rebuckets = sim.n_rebucket - rebuckets
    replays = sim._graphs.replays if sim._graphs else 0
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(blocks):
            sim.step_block(10)
        torch.cuda.synchronize()
    kern = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and dev_us > 0 and \
                "Loading" not in e.key:
            kern[e.key] = (dev_us, e.count)
    busy_us = sum(v[0] for v in kern.values())
    digest = hashlib.sha256()
    for st in (sim.states if hasattr(sim, "states") else [sim.state]):
        digest.update(st.r.cpu().numpy().tobytes())
    e_pot = sim.e_potential
    gaps = sorted(head_gaps(prof, DeviceType))
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]
    # one redistribution run eagerly, op by op, as the eager loop runs it:
    # the host's time to enqueue it, its time to the end, its kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim._rebucket_step()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim._rebucket_step()
        torch.cuda.synchronize()
    reb = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "Loading" not in e.key]
    # on a mesh the lazy step's other IF body, the ghost refresh, eagerly
    refresh = None
    if hasattr(sim, "states") and sim._refresh is not None:
        sim._refresh()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sim._refresh()
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "Loading" not in e.key]
        refresh = {
            "device_ops": sum(e.count for e in ops),
            "device_ms": sum(getattr(e, "self_device_time_total", getattr(
                e, "self_cuda_time_total", 0.0)) for e in ops) / 1e3,
            "ops": {e.key[:60]: e.count for e in ops}}
    print(smi)
    print(json.dumps({
        "run": (f"{args.n}^3 {'LJ' if args.lj else 'EAM'} f32 -m "
                f"{args.method}" + (" -L" if args.pairlist else "")
                + f", mesh {px}x{py}x{pz}, --commImpl {args.comm}"
                + (" --halfShell" if args.half else "")
                + (" -P" if args.spline else "")
                + (" -I" if args.interp else "")
                + (f" -a {args.gpuAsync}" if args.gpuAsync >= 0 else "")
                + ("" if args.lazy else " -S 0")
                + (", eager loop" if args.eager else ", CUDA graphs")),
        "tree": os.path.abspath(args.tree),
        "final_r_sha256": digest.hexdigest(),
        "e_potential": e_pot,
        "ms_per_step": 1e3 * wall / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches_per_step": sum(v[1] for v in kern.values()) / steps,
        "rebuckets_in_timed_steps": rebuckets,
        "eager_rebucket": {
            "host_ms": 1e3 * enqueue, "ms": 1e3 * whole,
            "device_ms": sum(getattr(e, "self_device_time_total",
                                     getattr(e, "self_cuda_time_total", 0.0))
                             for e in reb) / 1e3,
            "device_ops": sum(e.count for e in reb),
            # its operations by device time: on the card the serial one is
            # csrc/rebucket.cu's bin and place launches, refresh_halo and
            # the counter's add; a mesh's adds the exchange's kernels
            "top_ops": [
                {"name": e.key[:90], "us": getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)),
                 "calls": e.count}
                for e in sorted(reb, key=lambda e: -getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)))[:8]]},
        "eager_refresh": refresh,
        "graph_replays_per_step": (
            (sim._graphs.replays - replays) / steps if sim._graphs else 0.0),
        "graph_capture_s": sim._graphs.capture_s if sim._graphs else None,
        "graph_instantiate_s": (sim._graphs.instantiate_s if sim._graphs
                                else None),
        "hand_written_launches": {k: v for k, v in LAUNCHES.items() if v},
        "head_to_force_gap_us": {
            "median": gaps[len(gaps) // 2] if gaps else None,
            "least": gaps[0] if gaps else None,
            "largest": gaps[-1] if gaps else None, "steps": len(gaps)},
        "top_kernels_ms_per_step": [
            {"name": k[:90], "ms": us / 1e3 / steps, "calls": n / steps}
            for k, (us, n) in top],
        # the device time of one launch of each hand-written kernel
        "hand_written_us_per_launch": {
            k[:90]: us / n for k, (us, n) in kern.items()
            if any(w in k for w in ("stencil_kernel", "halo_fill_kernel",
                                    "ring_push_kernel", "nl_build_kernel",
                                    "nl_pack_kernel", "nl_sweep_kernel",
                                    "kick_drift_trigger_kernel",
                                    "refresh_halo_kernel",
                                    "embed_fill_kernel", "land_kernel",
                                    "embed_rows_kernel", "land_rows_kernel",
                                    "nl_rows_tile_kernel",
                                    "nl_rows_fill_kernel",
                                    # a parent tree's (--tree) NR scan
                                    "nl_rows_scan_kernel",
                                    "rebucket_bin_kernel",
                                    "rebucket_place_kernel",
                                    "rebucket_place_warp_kernel",
                                    "arrivals_bin_kernel",
                                    "arrivals_place_kernel",
                                    "sort_cells_kernel",
                                    "sort_cells_warp_kernel",
                                    "position_fill_kernel",
                                    "atom_pack_kernel",
                                    "fold_halo_kernel"))},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
