"""Command-line driver, flag-compatible with the reference binary and comd_tpu.

    python -m comd_tpu_torch.cli -e -x 63 -y 63 -z 63      # on the GPU
    python -m comd_tpu_torch.cli -e -x 4 -y 4 -z 4 --device cpu

Every option of comd_tpu.cli is accepted (flag table: src-mpi/mycommand.c:
225-251) plus ``--device``.  The run loop reproduces the reference main():
prolog -> printRate-step blocks with printThings lines -> validation ->
timing report (CoMD.c:86-187, 463-494).  Options outside the ported slice
(YAML, checkpoints, --analyze, -s, multi-process launch and the
configurations listed in sim.check_slice) raise NotImplementedError naming
the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from .config import Config
from .sim import init_simulation, not_ported
from .utils.timers import PerfTimers
from .constants import KB_EV


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="comd-tpu-torch",
        description="CoMD on PyTorch + CUDA: classical molecular dynamics "
                    "(EAM) with link cells on one GPU.")
    a = p.add_argument
    a("-d", "--potDir", default="pots", help="potential directory")
    a("-p", "--potName", default="", help="potential name")
    a("-t", "--potType", default="funcfl",
      help="potential type (funcfl or setfl)")
    a("-e", "--doeam", action="store_true", help="compute eam potentials")
    a("-x", "--nx", type=int, default=20, help="number of unit cells in x")
    a("-y", "--ny", type=int, default=20, help="number of unit cells in y")
    a("-z", "--nz", type=int, default=20, help="number of unit cells in z")
    a("-i", "--xproc", type=int, default=1, help="processors in x direction")
    a("-j", "--yproc", type=int, default=1, help="processors in y direction")
    a("-k", "--zproc", type=int, default=1, help="processors in z direction")
    a("-N", "--nSteps", type=int, default=100, help="number of time steps")
    a("-n", "--printRate", type=int, default=10,
      help="number of steps between output")
    a("-D", "--dt", type=float, default=1.0, help="time step (in fs)")
    a("-l", "--lat", type=float, default=-1.0,
      help="lattice parameter (Angstroms)")
    a("-T", "--temp", type=float, default=600.0,
      help="initial temperature (K)")
    a("-r", "--delta", type=float, default=0.0,
      help="initial delta (Angstroms)")
    a("-H", "--hilbert", action="store_true",
      help="space-filling curve for the traversal of cells")
    a("-S", "--skinDistance", type=float, default=0.1,
      help="skin distance (relative to cutoff)")
    a("-m", "--method", default="thread_atom",
      help="thread_atom,warp_atom,warp_atom_nl,cta_cell,thread_atom_nl,cpu_nl")
    a("-a", "--gpuAsync", type=int, default=-1,
      help="communication hiding optimization (interior/boundary overlap); "
           "-1 = auto: ON for *_nl methods (measured 10.5%% EAM win, "
           "noise-neutral LJ), OFF for cell sweeps (costs 8-15%% "
           "single-chip; pass -a 1 explicitly for multi-chip cell runs)")
    a("-s", "--gpuProfile", action="store_true",
      help="profiling mode: reboxing disabled, single force run")
    a("-I", "--ljInterpolation", action="store_true",
      help="compute Lennard-Jones potential using interpolation")
    a("--ljCutoffFactor", type=float, default=2.5,
      help="LJ cutoff in units of sigma (2.5 = upstream CoMD golden "
           "config; 5 = the reference fork's ljForce.c:114)")
    a("-P", "--spline", action="store_true",
      help="use splines for interpolation")
    a("-L", "--usePairlist", action="store_true",
      help="use pairlists in Lennard-Jones computation")
    # --- comd_tpu extensions (accepted for parity; see config.Config) ---
    a("--maxAtoms", type=int, default=0,
      help="per-cell capacity (reference compile-time MAXATOMS); "
           "0 = auto-size from the t=0 occupancy")
    a("--cellMode", default="auto",
      choices=["auto", "commensurate", "classic"],
      help="cell sizing: classic reference floor(extent/cutoff), "
           "lattice-commensurate (k/2)*lat cells (uniform occupancy, "
           "no capacity slack), or auto (price both, take the cheaper)")
    a("--dtype", default="float32", choices=["float32", "float64"],
      help="dynamics precision (energies always f64-accumulated)")
    a("--boxChunk", type=int, default=0,
      help="cells per force-sweep chunk (0 = auto by sweep impl)")
    a("--sweepImpl", default="auto",
      choices=["auto", "gather", "dense", "dense_w", "dense_wg", "dense_wf",
               "dense_f", "dense_t"],
      help="cell-sweep formulation (auto = measured-best by capacity; "
           "see config.Config.sweep_impl)")
    a("--interpImpl", default="auto",
      choices=["auto", "cheb", "twolevel", "rows"],
      help="EAM table evaluator (auto = cheb for f32, twolevel for f64)")
    a("--commImpl", default="collective",
      choices=["collective", "ki", "ki_fused"],
      help="halo transport: XLA collectives or the Pallas RDMA "
           "kernel-initiated analog (comm_ki)")
    a("--halfShell", action="store_true",
      help="Newton's-3rd-law pair-once sweeps (the reference half-list "
           "kernels; with -m cta_cell, the Pallas dual-delivery kernel)")
    a("--halfFetch", default="slices", choices=["slices", "window"],
      help="half-sweep j delivery: per-offset dynamic slices or one "
           "contiguous per-chunk window (static in-window views)")
    a("--halfMaterialize", action="store_true",
      help="half sweeps: materialize the pair block behind an optimization "
           "barrier before the dual i/j reduction (keeps XLA from "
           "rematerializing the pair chain once per reduce side)")
    a("--haloMsgFactor", type=float, default=0.6,
      help="count-packed atom halo messages: per-face entry capacity as a "
           "fraction of the full two-plane slot count (0 ships full planes; "
           "overflow aborts; see config.Config.halo_msg_factor)")
    a("--energyEveryStep", action="store_true",
      help="compute potential energy on every step instead of only at "
           "printRate boundaries (identical dynamics either way)")
    a("--yaml", default=None, help="YAML report output directory (off if unset)")
    a("--analyze", action="store_true",
      help="print the link-cell occupancy histogram (AnalyzeInput)")
    a("--checkpoint", default=None, metavar="DIR",
      help="write a checkpoint to DIR at the end of the run (and every "
           "--checkpointRate steps if set)")
    a("--checkpointRate", type=int, default=0,
      help="steps between periodic checkpoints (0 = final only)")
    a("--restore", default=None, metavar="DIR",
      help="resume from a checkpoint directory (geometry/potential flags "
           "come from the stored config; -N adds steps on top)")
    a("--device", default="cuda",
      help="torch device: cuda (the kernels) or cpu (their plain PyTorch "
           "versions); no fallback between them")
    # --- multi-host launch (the reference's mpirun surface, parallel.c) ---
    import os as _os
    a("--coordinator", default=_os.environ.get("COMD_COORDINATOR"),
      metavar="HOST:PORT",
      help="jax.distributed coordinator address (process 0's host:port); "
           "enables multi-process execution together with --numProcs")
    a("--numProcs", type=int,
      default=int(_os.environ.get("COMD_NUM_PROCS", "1")),
      help="total number of launched processes (multi-host slice)")
    a("--procId", type=int,
      default=int(_os.environ.get("COMD_PROC_ID", "-1")),
      help="this process's id in 0..numProcs-1")
    return p


def config_from_args(args) -> Config:
    return Config(
        pot_dir=args.potDir, pot_name=args.potName, pot_type=args.potType,
        doeam=args.doeam, nx=args.nx, ny=args.ny, nz=args.nz,
        xproc=args.xproc, yproc=args.yproc, zproc=args.zproc,
        n_steps=args.nSteps, print_rate=args.printRate, dt=args.dt,
        lat=args.lat, temperature=args.temp, initial_delta=args.delta,
        do_hilbert=args.hilbert, relative_skin_distance=args.skinDistance,
        method=args.method, gpu_async=args.gpuAsync,
        gpu_profile=args.gpuProfile, lj_interpolation=args.ljInterpolation,
        spline=args.spline, use_pairlist=args.usePairlist,
        lj_cutoff_factor=args.ljCutoffFactor,
        max_atoms=args.maxAtoms, cell_mode=args.cellMode,
        dtype=args.dtype, box_chunk=args.boxChunk,
        sweep_impl=args.sweepImpl, interp_impl=args.interpImpl,
        comm_impl=args.commImpl,
        half_shell=args.halfShell, half_fetch=args.halfFetch,
        half_materialize=args.halfMaterialize,
        halo_msg_factor=args.haloMsgFactor,
        energy_every_step=args.energyEveryStep,
        device=args.device,
    )


HEADER = (
    "#                                                                   "
    "                      Performance\n"
    "#  Loop   Time(fs)       Total Energy   Potential Energy     "
    "Kinetic Energy  Temperature   (us/atom)     # Atoms")


def print_things(sim, i_step: int, elapsed: float, n_eval: int,
                 out=sys.stdout, timers=None):
    """Per-printRate status line (printThings, CoMD.c:463-494).

    The kinetic-energy / atom-count reductions here are the run's real
    collective-reduction dispatches -- the commReduce timer row
    (performanceTimers.c:55-68, parallel.c:120-185)."""
    if timers is not None:
        timers.start("commReduce")
    e_pot = sim.e_potential
    e_kin = sim.kinetic_energy()
    n_sum = sim.sum_atoms()
    if timers is not None:
        timers.stop("commReduce")
    n = sim.n_global
    e_total = (e_pot + e_kin) / n
    temp = (e_kin / n) / (KB_EV * 1.5)
    t = i_step * sim.cfg.dt
    us_per_atom = 1.0e6 * elapsed / (n_eval * max(n_sum, 1))
    print(f" {i_step:6d} {t:10.2f} {e_total:18.12f} {e_pot / n:18.12f} "
          f"{e_kin / n:18.12f} {temp:12.4f} {us_per_atom:10.4f} {n:12d}",
          file=out, flush=True)


def run(cfg: Config, out=sys.stdout, yaml_dir: str | None = None,
        analyze: bool = False, restore: str | None = None,
        checkpoint: str | None = None, checkpoint_rate: int = 0) -> dict:
    """Full reference-style run. Returns a result summary dict."""
    if restore is not None or checkpoint is not None:
        not_ported("--restore/--checkpoint", "6")
    if yaml_dir is not None:
        not_ported("YAML output (--yaml)", "6")
    if analyze:
        not_ported("--analyze", "6")

    timers = PerfTimers()
    timers.start("total")
    sim = init_simulation(cfg, timers=timers)
    cfg = sim.cfg

    for key, val in sim.pot.describe():
        print(f"  {key:<17}: {val}", file=out)
    print(file=out)

    if cfg.gpu_async > 0:
        # the serial implementation has no exchange to overlap
        print("# WARNING: -a 1 overlaps interior force compute with the "
              "halo collectives and only applies to multi-device runs "
              "(-i/-j/-k); this serial run has no exchange to overlap "
              "and ignores -a.", file=out)

    e0 = (sim.e_potential + sim.kinetic_energy()) / sim.n_global
    n0 = sim.sum_atoms()
    print(f"Initial energy : {e0:14.12f}, atom count : {n0}\n", file=out)
    print(HEADER, file=out)

    timers.start("loop")
    i_step = 0
    n_end = cfg.n_steps
    print_things(sim, i_step, 1e-9, 1, out=out, timers=timers)
    while i_step < n_end:
        n_block = min(cfg.print_rate, n_end - i_step)
        timers.start("timestep")
        t0 = time.perf_counter()
        sim.step_block(n_block)
        if sim.device.type == "cuda":
            torch.cuda.synchronize(sim.device)
        dt_wall = time.perf_counter() - t0
        timers.stop("timestep")
        i_step += n_block
        if bool(sim.state.overflow):
            raise RuntimeError(
                f"capacity overflow at step {i_step}: a cell exceeded "
                f"--maxAtoms (max_atoms={cfg.max_atoms}). Raise it and "
                f"rerun.")
        print_things(sim, i_step, dt_wall, n_block, out=out, timers=timers)
    timers.stop("loop")

    # validation (validateResult, CoMD.c:413-440)
    e_final = (sim.e_potential + sim.kinetic_energy()) / sim.n_global
    n_final = sim.sum_atoms()
    print("\n\nSimulation Validation:", file=out)
    print(f"  Initial energy  : {e0:14.12f}", file=out)
    print(f"  Final energy    : {e_final:14.12f}", file=out)
    print(f"  eFinal/eInitial : {e_final / e0:f}", file=out)
    if n_final == n0:
        print(f"  Final atom count : {n_final}, no atoms lost", file=out)
    else:
        print("#############################", file=out)
        print(f"# WARNING: {n0 - n_final:6d} atoms lost #", file=out)
        print("#############################", file=out)

    timers.stop("total")
    print(timers.report(sim.n_global, cfg.n_steps), file=out)
    print(timers.rank_stats(), file=out)

    return {
        "e_initial": e0,
        "e_final": e_final,
        "atoms_lost": n0 - n_final,
        "atom_rate_atoms_per_us": timers.atom_rate(sim.n_global, cfg.n_steps),
        "n_global": sim.n_global,
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.numProcs > 1:
        not_ported("multi-process launch (--numProcs)", "12")
    try:
        run(cfg, out=sys.stdout, yaml_dir=args.yaml, analyze=args.analyze,
            restore=args.restore, checkpoint=args.checkpoint,
            checkpoint_rate=args.checkpointRate)
    except (ValueError, FileNotFoundError) as e:
        print(f"comd-tpu-torch: {e}. Fatal Error.", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
