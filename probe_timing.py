#!/usr/bin/env python3
"""Time the probe kernels (window_pair, row_lookup, lane_lookup) of one or
more source trees on one GPU, in turns, and split window_pair's time.

    python3 probe_timing.py [TREE ...] [--breakdown]

Each TREE is a checkout of this repository (default: this one).  One
worker process a tree builds that tree's comd_tpu_torch/csrc/probe.cu and
times its kernels at the probes' own shapes (P1, P2, P3, P3 LJ; P3 and
P3 LJ at 72 chunks; P4 row_lookup, P5 lane_lookup), three ways each:

  ms         CUDA events around 20 back-to-back calls (probes.time_ms)
  host_ms    the host's wall clock a call over 20 calls (the device runs
             behind): the wrapper's own cost
  device_ms  the kernel's time a call under torch.profiler (the mean of
             the kernel records it keeps: it drops some at times)

The workers run in the order given and then in reverse (give the parent
and this tree: parent, change, change, parent).  With ``--breakdown`` a
last worker times copies of this tree's probe.cu with parts of
window_pair cut out (text edits, each checked to apply once; device ms,
each build in turn and again in reverse):

  full      the kernel as the port builds it
  walk      the r2 tests alone (a hit adds r2 to a register; no list)
  nodrain   the tests and the list appends, lists emptied undrained
  nopair    the drain without the pair function (the terms are r2, dx)

so walk is the r2 walk, nodrain - walk the appends, nopair - nodrain the
drain's scan, search and sums, full - nopair the pair function.  Only
``full`` computes the right values.  Then two tried alternatives of the
walk, each also right: one_test (r2 <= rcut2 alone in the walk; r2 = 0
listed and given zero terms in the drain) and batch4 (capacity checks
every 4 candidates, lists of 8, 6 blocks an SM).  The
breakdown worker also splits the host's time of a lane_lookup and a P3
window call into its parts.  Prints the card's name and power
limit, one JSON line a worker, then one JSON line of each tree's means.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = (("P1", 1, False, None), ("P2", 2, False, None),
         ("P3", 3, False, None), ("P3 LJ", 3, True, None),
         ("P3 72", 3, False, 72), ("P3 LJ 72", 3, True, 72))

_APPEND = """            st_shared2(tail, r2, dx);
            tail += 8 * kListStride;"""
_DRAIN = "if (__any_sync(kAll, tail > limit)) {"
_PAIR = "pair_terms<kPhys, kNPhi, kNDphi, kNRho>(p, en.x, en.y, t);"
EDITS = {
    "full": [],
    "walk": [(_APPEND, "            acc[0] += r2;")],
    "nodrain": [(_DRAIN, _DRAIN + " tail = head; } if (false) {")],
    "nopair": [(_PAIR, "t[0] = en.x; t[1] = en.y; "
                "if constexpr (NT == 3) t[2] = en.x;")],
    # tried alternatives of the walk
    "one_test": [("if (r2 <= p.rcut2 && r2 > 0.f) {", "if (r2 <= p.rcut2) {"),
                 (_PAIR, "if (en.x > 0.f) { " + _PAIR + " } else { "
                  "for (int q = 0; q < NT; ++q) t[q] = 0.f; }")],
    "batch4": [("constexpr int kListCap = 16;", "constexpr int kListCap = 8;"),
               ("constexpr int kBatch = 8;", "constexpr int kBatch = 4;"),
               ("__launch_bounds__(kMaxWarps * kWarp, 4)",
                "__launch_bounds__(kMaxWarps * kWarp, 6)")],
}


def _host_and_device_ms():
    """chip_smoke.host_and_device_ms of this checkout."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.host_and_device_ms


def _inputs(torch):
    from comd_tpu_torch.probes import lookup, window
    calls = {}
    for name, probe, lj, chunks in CASES:
        sp = window.spec(probe, lj)
        rp = torch.from_numpy(window.make_inputs(probe, chunks)).cuda()
        calls[name] = (lambda rp=rp, sp=sp: window.window_pair(rp, sp))
    x4, t4 = (torch.from_numpy(a).cuda() for a in lookup.make_inputs(4))
    x5, t5 = (torch.from_numpy(a).cuda() for a in lookup.make_inputs(5))
    calls["P4 row_lookup"] = lambda: lookup.row_lookup(x4, t4)
    calls["P5 lane_lookup"] = lambda: lookup.lane_lookup(x5, t5)
    return calls


def worker(tree: str) -> dict:
    """Times of ``tree``'s probe kernels, {case: {ms, host_ms, device_ms}}."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from comd_tpu_torch.ops.cuda import probe as pr
    from comd_tpu_torch.probes import time_ms
    host_and_device_ms = _host_and_device_ms()
    pr.build()
    out = {}
    for name, fn in _inputs(torch).items():
        ms = time_ms(fn, 20)
        host, dev = host_and_device_ms(fn, kernels_per_call=1)
        out[name] = {"ms": ms, "host_ms": host, "device_ms": dev}
    return out


def breakdown() -> dict:
    """Device ms of each window_pair variant of EDITS at the window cases,
    {variant: {case: [ms, ...]}}."""
    sys.path.insert(0, ROOT)
    import torch
    from comd_tpu_torch.ops.cuda import probe as pr
    from comd_tpu_torch.ops.cuda.nvcc import build_library
    host_and_device_ms = _host_and_device_ms()
    text = open(pr.SOURCE).read()
    out_dir = os.path.join(os.path.dirname(pr.SOURCE), os.pardir, "_build",
                           "probe_variants")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, edits in EDITS.items():
        body = text
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"variant {name}: the edit of "
                                   f"{old[:40]!r} does not apply once")
            body = body.replace(old, new)
        paths[name] = os.path.join(out_dir, f"probe_{name}.cu")
        with open(paths[name], "w") as fh:
            fh.write(body)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(lambda p: build_library(p, "probe"), paths.values()))
    source, libs = pr.SOURCE, {}
    for name, path in paths.items():      # bind each (built above)
        pr._lib, pr.SOURCE = None, path
        libs[name] = pr.build()
        for physics, counts in (("inv_r2", (0, 0, 0)), ("lj", (0, 0, 0)),
                                ("cheb", (17, 16, 17)), ("cheb", (17, 16, 16))):
            # sets this build's shared-memory limit of each variant
            pr.occupancy.__wrapped__(0, "window_pair", 256, physics=physics,
                                     counts=counts)
    pr.SOURCE = source
    calls = {k: v for k, v in _inputs(torch).items()
             if not k.endswith("lookup")}
    times = {name: {} for name in paths}
    for name in list(paths) + list(paths)[::-1]:
        pr._lib = libs[name]      # the same plans: ``full``'s occupancy
        for case, fn in calls.items():
            times[name].setdefault(case, []).append(
                host_and_device_ms(fn, kernels_per_call=1)[1])
    pr._lib = libs["full"]
    return {"device_ms": times, "host_us": host_parts(torch, pr)}


def host_parts(torch, pr) -> dict:
    """Host microseconds a call of a lane_lookup (P5) and a P3 window call,
    and of their parts: the output's allocation, the stream query, and the
    bare ctypes launch on a kept output (mean of 2,000 calls each)."""
    import time
    from comd_tpu_torch.probes import lookup, window
    x, tab = (torch.from_numpy(a).cuda() for a in lookup.make_inputs(5))
    rp = torch.from_numpy(window.make_inputs(3)).cuda()
    sp = window.P3
    D = window.n_columns(sp, rp.shape[2])
    plan = pr.card_window_plan(0, sp, 32, rp.shape[2], D)
    blocks = pr._lookup_blocks(0, "lane_lookup", tab.shape[0])
    out = torch.empty_like(x)
    outs = rp.new_empty((3, 32, D))
    lib = pr._lib
    o0, step = outs.data_ptr(), 32 * D * 4

    def stream():
        return torch.cuda.current_stream(x.device).cuda_stream

    parts = {
        "lane_lookup call": lambda: lookup.lane_lookup(x, tab),
        "window P3 call": lambda: window.window_pair(rp, sp),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "current_stream": stream,
        "lane_lookup ctypes launch": lambda: lib.comd_lane_lookup(
            x.data_ptr(), tab.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], tab.shape[0], 1e-12, blocks, stream()),
        "window ctypes launch": lambda: lib.comd_window_pair(
            plan.params, 1, *plan.counts, rp.data_ptr(), o0, o0 + step,
            o0 + 2 * step, stream()),
    }
    got = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        got[name] = 1e6 * (time.perf_counter() - t0) / 2000
        torch.cuda.synchronize()
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[ROOT])
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--breakdown-worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    if args.breakdown_worker:
        print(json.dumps(breakdown()))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("probe_timing: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def run(flags):
        res = subprocess.run([sys.executable, os.path.abspath(__file__)]
                             + flags, capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"worker {flags} failed:\n"
                               f"{res.stderr[-4000:]}")
        return json.loads(res.stdout.strip().splitlines()[-1])

    runs = {}
    for tree in args.trees + args.trees[::-1]:
        got = run(["--worker", tree])
        print(json.dumps({"tree": tree, "times": got}), flush=True)
        runs.setdefault(tree, []).append(got)
    means = {}
    for tree, rs in runs.items():
        means[tree] = {case: {k: sum(r[case][k] for r in rs) / len(rs)
                              for k in rs[0][case]} for case in rs[0]}
    print(json.dumps({"means": means}), flush=True)
    if args.breakdown:
        got = run(["--breakdown-worker"])
        print(json.dumps({"breakdown_device_ms": {
            name: {case: sum(v) / len(v) for case, v in t.items()}
            for name, t in got["device_ms"].items()}}), flush=True)
        print(json.dumps({"host_us": got["host_us"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
