"""The round-3 archive probes (tools/archive/) on the port's kernels.

``window`` holds P1-P3, the pair-window probes: a branch-free pair sum over
static lane offsets with no cell indirection, the calibration of what the
pair kernels K1/K2 could reach.  ``lookup`` holds P4-P6, the table-lookup
probes: the work of EAM pass 2 and of the exact-table evaluator.  Each is a
command (``python -m comd_tpu_torch.probes.window``, ``...lookup``) that
times its kernel on the card.  The archive's relay protocol, batch scripts
and scan-marginal timing are not ported: ``time_ms``, a CUDA event pair
around repeated calls, times them (and chip_smoke.py's other kernels).
"""
from __future__ import annotations

import time

import torch


def time_ms(fn, reps: int, device="cuda") -> float:
    """Mean ms of fn() over ``reps`` calls after one warm-up call: CUDA
    events on a card, the host clock on the CPU."""
    device = torch.device(device)
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize(device)
        return t0.elapsed_time(t1) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t) / reps
