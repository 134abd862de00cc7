"""Phase-attributed profiling (the reference's -s mode + timer hierarchy).

The step enqueues its kernels asynchronously, so the run's own timers
cannot attribute time to its phases.  This module runs each phase of the
step on its own, on clones of the state (the run's state, counters and
timers are untouched), and times it with comd_tpu's marginal-block method:
a block of ``long`` calls minus one of ``short``, best of 3, so fixed
overheads cancel.  On the card the blocks are timed with CUDA events; on
the CPU with the wall clock.  The table is comparable to the reference's
hierarchical timer report (performanceTimers.c:55-68) and to comd_tpu's
-s table: the phase names are comd_tpu's.

Phases (reference enum names):
  velocity      half kick (timestep.c:109-133)
  position      drift (timestep.c:122-133)
  redistribute  rebucket sort + scatter + halo rebuild (+ the atom
                exchange and in-cell sort on a mesh)
  atomHalo      ghost position refresh alone
  force         full force evaluation (includes the in-force eamHalo)
  eamHalo       the dfEmbed halo fill alone (EAM only)
  neighborList  Verlet list build (NL methods only)
"""
from __future__ import annotations

import dataclasses
import time

import torch


def _phase_fns(sim):
    """dict name -> (per-shard SimStates -> per-shard SimStates); a single
    domain is one shard."""
    from ..ops import binning

    cfg, geom, maps = sim.cfg, sim.geom, sim.maps
    sharded = hasattr(sim, "states")
    half_dt = sim._c(0.5 * cfg.dt)
    r_dt = sim._c(cfg.dt * (1.0 / sim.mass))
    fns = {}

    def velocity(st):
        return [dataclasses.replace(s, p=s.p + half_dt * s.f) for s in st]

    def position(st):
        return [dataclasses.replace(s, r=s.r + s.p * r_dt) for s in st]

    fns["velocity"] = velocity
    fns["position"] = position

    if sharded:
        from ..parallel import exchange

        def redistribute(st):
            r, p, gid, n, _ovf = sim._redistribute(
                [s.r for s in st], [s.p for s in st], [s.gid for s in st],
                [s.n_atoms for s in st])
            return [dataclasses.replace(s, r=r[i], p=p[i], gid=gid[i],
                                        n_atoms=n[i])
                    for i, s in enumerate(st)]

        def atom_halo(st):
            exchange.exchange_positions(sim.halo, [s.r for s in st])
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
                binning.refresh_halo_positions(geom, maps, s.r)
            return st

    fns["redistribute"] = redistribute
    fns["atomHalo"] = atom_halo

    def force(st):
        rs, ns = [s.r for s in st], [s.n_atoms for s in st]
        if sharded and sim.uses_nl:
            res = sim.forces_nl(sim.nlists, rs, sim._fill_nl)
        elif sharded:
            res = sim.forces(rs, ns, sim._fill, sim._fold)
        else:
            res = [sim.force(rs[0], ns[0], nlist=sim.nlist)]
        return [dataclasses.replace(s, f=sim._full_force(f_loc, s.f))
                for s, (f_loc, _u, _e) in zip(st, res)]

    fns["force"] = force

    if sim.is_eam:
        def eam_halo(st):
            # the run's fill on any [B, A] field, in place on the clones'
            # f[0]; the fused transport reads f[1]'s local rows as rhobar
            xs = [s.f[0] for s in st]
            if not sharded:
                sim._fill(xs)
            elif sim.uses_nl:
                sim._fill_nl(xs)
            else:
                sim._fill(xs, [s.f[1][:geom.n_local] for s in st])
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


def _clone(s):
    return dataclasses.replace(s, **{
        f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)})


def _block_seconds(sim, fn, n: int) -> float:
    """Seconds for ``n`` calls of ``fn`` on fresh clones of the state:
    CUDA events on the card, the wall clock on the CPU."""
    st = [_clone(s) for s in _states(sim)]
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

    Each phase runs as a block of ``short`` and ``long`` calls on clones of
    the state; per-invocation time is the marginal difference, best of 3.
    The simulation's rebucket and list-build counters are restored."""
    counters = (sim.n_rebucket, sim.n_nl_build)
    results = {}
    try:
        for name, fn in _phase_fns(sim).items():
            _block_seconds(sim, fn, short)      # warm
            best = 1e30
            for _ in range(3):
                ts = _block_seconds(sim, fn, short)
                tl = _block_seconds(sim, fn, long)
                best = min(best, (tl - ts) / (long - short))
            results[name] = max(best, 0.0)
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
