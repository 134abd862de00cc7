"""Phase-attributed profiling (the reference's -s mode + timer hierarchy).

The step enqueues its kernels asynchronously, so the run's own timers
cannot attribute time to its phases.  This module runs each phase of the
step on its own, on clones of the state (the run's state, counters and
timers are untouched), and times it with comd_tpu's marginal-block method:
the best of 5 blocks of ``long`` calls minus the best of 5 of ``short``,
so fixed overheads cancel.  On the card the blocks are timed with CUDA
events; on the CPU with the wall clock.  The table is comparable to the
reference's hierarchical timer report (performanceTimers.c:55-68) and to
comd_tpu's -s table: the phase names are comd_tpu's.

Phases (reference enum names), each the code the step runs:
  velocity      the second half kick (timestep.c:109-133) with the force
                landing and atom count: one ``land`` launch over every
                shard (``land_rows`` from the rows a shard on the list
                paths)
  position      the drift (timestep.c:122-133) with the first half kick
                and the skin trigger: one ``kick_drift_trigger`` launch
                over every shard (ops/cuda/step.py), serially on the lazy
                and list steps with the ghost refresh it writes
  redistribute  rebucket sort + scatter + halo rebuild (+ the atom
                exchange and in-cell sort on a mesh)
  atomHalo      ghost position refresh alone (serially the positions of
                the ``refresh_halo`` fill; on a mesh the step's
                ``exchange_positions``: one ``position_fill`` launch in one
                process)
  force         full force evaluation (includes the in-force eamHalo;
                on the list paths the rows landed by ``land_rows``
                without the kick)
  eamHalo       the dfEmbed halo fill alone (EAM only)
  neighborList  Verlet list build (NL methods only)

``report_phases`` sums a step as comd_tpu's table does, velocity twice:
here one ``land`` launch more than a step runs.
"""
from __future__ import annotations

import dataclasses
import time

import torch


def _phase_fns(sim):
    """dict name -> (per-shard SimStates -> per-shard SimStates), the
    states views of one stack a field (sim.clone_stacked); a single
    domain is one shard."""
    from ..ops import binning
    from ..ops.cuda import step
    from ..sim import stack_of

    geom, maps = sim.geom, sim.maps
    sharded = hasattr(sim, "states")
    fns = {}

    def forces(st, passes=False):
        rs, ns = [s.r for s in st], [s.n_atoms for s in st]
        if sim.uses_nl:
            # the list force stays per row; ``_full_force`` lands it
            if sharded:
                return sim.forces_nl(sim.nlists, rs, ns, sim._fill_nl)
            return [sim.force(rs[0], ns[0], nlist=sim.nlist, passes=True)]
        return sim.forces(stack_of(rs), stack_of(ns), sim._fill, sim._fold,
                          passes=passes)

    # the step's landing lands the force of its state (EAM's two passes)
    landed = forces(_clone(_states(sim)), passes=True)
    # the skin trigger's baselines (the step's: r at the last rebucket);
    # -S 0 steps without the trigger
    lasts = (list(torch.stack([s.r for s in _states(sim)]))
             if sim.uses_nl or sim.uses_lazy else None)

    def velocity(st):
        sim._land(st, landed, want_energy=False)
        return st

    # serial lazy and list steps refresh the ghosts in the head's launch
    images = maps.images if lasts is not None and not sharded else None

    def position(st):
        sim._kick_drift(st, lasts, images=images)
        return st

    fns["velocity"] = velocity
    fns["position"] = position

    if sharded:
        def redistribute(st):
            r, p, gid, n, _ovf = sim._redistribute(
                [s.r for s in st], [s.p for s in st], [s.gid for s in st],
                [s.n_atoms for s in st])
            return [dataclasses.replace(s, r=r[i], p=p[i], gid=gid[i],
                                        n_atoms=n[i])
                    for i, s in enumerate(st)]

        def atom_halo(st):
            sim.exchange_positions([s.r for s in st])
            return st
    else:
        def redistribute(st):
            out = []
            for s in st:
                r, p, gid, n, _nm, _ovf = binning.rebucket(
                    geom, maps, s.r, s.p, s.gid, s.n_atoms,
                    wrap_extent=sim.global_extent)
                r, gid, n = binning.fill_halo_serial(geom, maps, r, gid, n)
                out.append(dataclasses.replace(s, r=r, p=p, gid=gid,
                                               n_atoms=n))
            return out

        def atom_halo(st):
            for s in st:
                step.refresh_halo(geom, maps, s.r)
            return st

    fns["redistribute"] = redistribute
    fns["atomHalo"] = atom_halo

    def force(st):
        res = forces(st)
        if isinstance(res, list):
            f = [sim._full_force(f_loc, s.f)
                 for s, (f_loc, _u, _e) in zip(st, res)]
        else:
            f = sim._full_force(res[0], stack_of(s.f for s in st))
        return [dataclasses.replace(s, f=f[i]) for i, s in enumerate(st)]

    fns["force"] = force

    if sim.is_eam:
        def eam_halo(st):
            # the run's fill on any [B, A] field, in place on the clones'
            # f[0]; the fused transport reads f[1]'s local rows as rhobar
            f = stack_of(s.f for s in st)
            if not sharded:
                sim._fill(f[:, 0])
            elif sim.uses_nl:
                sim._fill_nl(list(f[:, 0]))
            else:
                sim._fill(f[:, 0], f[:, 1, :geom.n_local])
            return st

        fns["eamHalo"] = eam_halo

    if sim.uses_nl:
        def nl_build(st):
            sim.build_lists([s.r for s in st], [s.n_atoms for s in st])
            return st

        fns["neighborList"] = nl_build

    return fns


def _states(sim) -> list:
    return sim.states if hasattr(sim, "states") else [sim.state]


def _clone(states) -> list:
    """Clones of the shards' states, views of new stacks as the step's."""
    from ..sim import clone_stacked
    return clone_stacked(states)


def _block_seconds(sim, fn, n: int) -> float:
    """Seconds for ``n`` calls of ``fn`` on fresh clones of the state:
    CUDA events on the card, the wall clock on the CPU."""
    st = _clone(_states(sim))
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            st = fn(st)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        st = fn(st)
    return time.perf_counter() - t0


def profile_phases(sim, short: int = 2, long: int = 8, out=None):
    """Run the -s phase profile; returns {phase: seconds_per_invocation}.

    Each phase runs as blocks of ``short`` and ``long`` calls on clones of
    the state, 5 of each; per-invocation time is the marginal
    difference of the two best blocks.  A hiccup only lengthens a block,
    so each best is the least disturbed; the best of the per-trial
    differences would instead keep the trial whose short block was
    disturbed most, and read a phase whose launches are host-bound (a
    few tens of microseconds) as zero.  The simulation's rebucket and
    list-build counters are restored."""
    counters = (sim.n_rebucket, sim.n_nl_build)
    results = {}
    try:
        for name, fn in _phase_fns(sim).items():
            _block_seconds(sim, fn, short)      # warm
            ts = tl = 1e30
            for _ in range(5):
                ts = min(ts, _block_seconds(sim, fn, short))
                tl = min(tl, _block_seconds(sim, fn, long))
            results[name] = max((tl - ts) / (long - short), 0.0)
            if out is not None:
                print(f"  [profile] {name:<14} {results[name]*1e3:10.3f} ms",
                      file=out, flush=True)
    finally:
        sim.n_rebucket, sim.n_nl_build = counters
    return results


def report_phases(results: dict, n_atoms: int) -> str:
    """Reference-style phase table (% of the per-step sum)."""
    step = (results.get("velocity", 0.0) * 2 + results.get("position", 0.0)
            + results.get("redistribute", 0.0) + results.get("force", 0.0))
    step = step or 1e-30
    lines = [
        "",
        "Phase profile (marginal per-invocation, -s mode)",
        "------------------------------------------------",
        f"{'Phase':<16}{'ms/invoc':>12}{'% step':>9}",
    ]
    for name, t in results.items():
        lines.append(f"{name:<16}{t*1e3:>12.3f}{100.0*t/step:>8.2f}")
    lines.append(f"{'step (sum)':<16}{step*1e3:>12.3f}{100.0:>8.2f}")
    lines.append(
        f"atom rate at this breakdown: {n_atoms/step/1e6:.3f} atoms/us")
    return "\n".join(lines)
