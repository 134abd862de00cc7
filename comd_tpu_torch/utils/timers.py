"""Hierarchical performance timers (src-mpi/performanceTimers.c).

Same 12 timer names and report format as the reference (enum at
performanceTimers.c:55-68; report :127-194), including the figure of merit in
microseconds/atom/task and atoms/microsecond (:176-193).  The cross-rank
min/max/avg/stddev statistics (:291-335) gather each timer's total over
the processes of a multi-process launch (parallel/dist.py), one rank a
process; a single process prints the degenerate statistics of one rank.

Note: the step block enqueues its kernels asynchronously on the card, so the
in-loop phase timers (velocity/position/redistribute/force) stay empty; the
rows time the init phases and the per-block reductions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

TIMER_NAMES = [
    "total",
    "loop",
    "timestep",
    "  position",
    "  velocity",
    "  neighborList",
    "  redistribute",
    "    atomHalo",
    "  force",
    "    eamHalo",
    "commHalo",
    "commReduce",
]


@dataclass
class Timer:
    total: float = 0.0
    count: int = 0
    _start: float = 0.0
    running: bool = False

    def start(self):
        self._start = time.perf_counter()
        self.running = True

    def stop(self):
        if self.running:
            self.total += time.perf_counter() - self._start
            self.count += 1
            self.running = False


@dataclass
class PerfTimers:
    timers: dict = field(default_factory=lambda: {
        name.strip(): Timer() for name in TIMER_NAMES})

    def start(self, name: str):
        self.timers[name].start()

    def stop(self, name: str):
        self.timers[name].stop()

    class _Scope:
        def __init__(self, t):
            self.t = t

        def __enter__(self):
            self.t.start()
            return self

        def __exit__(self, *a):
            self.t.stop()

    def scope(self, name: str):
        return self._Scope(self.timers[name])

    def report(self, n_global_atoms: int, n_steps: int) -> str:
        """Single-process timing report (performanceTimers.c:127-194)."""
        lines = [
            "",
            "Timings",
            "-------",
            f"{'Timer':<16}{'# Calls':>10}{'Avg/Call (s)':>15}"
            f"{'Total (s)':>12}{'% Loop':>9}",
        ]
        loop = self.timers["loop"].total or 1e-30
        for disp in TIMER_NAMES:
            t = self.timers[disp.strip()]
            if t.count == 0:
                continue
            lines.append(
                f"{disp:<16}{t.count:>10}{t.total / t.count:>15.4f}"
                f"{t.total:>12.4f}{100.0 * t.total / loop:>8.2f}")
        if self.timers["velocity"].count == 0:
            lines.append(
                "# in-loop phases (velocity/position/redistribute/force) "
                "run asynchronously on the device and are not timed "
                "separately.  Rows above time the init phases and the "
                "per-block reductions.")
        ts = self.timers["timestep"]
        if ts.total > 0 and n_steps > 0 and n_global_atoms > 0:
            us_per_atom = 1.0e6 * ts.total / (n_steps * n_global_atoms)
            lines += [
                "",
                "---------------------------------------------------",
                " Average atom update rate: "
                f"{us_per_atom:10.4f} us/atom/task",
                "---------------------------------------------------",
                "",
                "---------------------------------------------------",
                " Average all atom update rate: "
                f"{us_per_atom:10.4f} us/atom",
                "---------------------------------------------------",
                "",
                "---------------------------------------------------",
                " Average atom rate: "
                f"{1.0 / us_per_atom:10.4f} atoms/us",
                "---------------------------------------------------",
            ]
        return "\n".join(lines)

    def rank_stats(self) -> str:
        """Cross-rank timer statistics (performanceTimers.c:291-335): each
        timer's total gathered over the processes (comd_tpu's
        utils/timers.py:122-144), collective in a multi-process launch.
        Every process has run the same timers."""
        import numpy as np
        from ..parallel import dist
        names = [n.strip() for n in TIMER_NAMES
                 if self.timers[n.strip()].count > 0]
        allt = dist.allgather(np.array([self.timers[n].total
                                        for n in names]))
        lines = [
            "",
            "Timing Statistics Across " f"{allt.shape[0]} Ranks:",
            f"{'Timer':<16}{'Rank: Min(s)':>14}{'Rank: Max(s)':>14}"
            f"{'Avg(s)':>10}{'Stdev(s)':>10}",
        ]
        for i, n in enumerate(names):
            col = allt[:, i]
            lines.append(
                f"{n:<16}{col.min():>14.4f}{col.max():>14.4f}"
                f"{col.mean():>10.4f}{col.std():>10.4f}")
        return "\n".join(lines)

    def atom_rate(self, n_global_atoms: int, n_steps: int) -> float:
        """atoms/us figure of merit (performanceTimers.c:176-193)."""
        ts = self.timers["timestep"].total
        if ts <= 0:
            return 0.0
        return n_steps * n_global_atoms / (1.0e6 * ts)
