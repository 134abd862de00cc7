"""Command-line driver, flag-compatible with the reference binary and comd_tpu.

    python -m comd_tpu_torch.cli -e -x 63 -y 63 -z 63      # on the GPU
    python -m comd_tpu_torch.cli -e -x 4 -y 4 -z 4 --device cpu
    python -m comd_tpu_torch.cli -e -i 2 -j 2 -k 2 --commImpl ki_fused
    python -m comd_tpu_torch.cli -e -m thread_atom_nl     # Verlet lists
    python -m comd_tpu_torch.cli -e -i 2 -j 2 -k 2 --numProcs 2 \
        --coordinator 127.0.0.1:29500 --procId P   # P = 0 and 1, 2 processes

Every option of comd_tpu.cli is accepted (flag table: src-mpi/mycommand.c:
225-251) plus ``--device``.  The run loop reproduces the reference main():
prolog -> printRate-step blocks with printThings lines -> validation ->
timing report (CoMD.c:86-187, 463-494), with comd_tpu's run tools:
``--checkpoint/--checkpointRate/--restore`` (utils/checkpoint.py, comd_tpu's
npz format), ``--yaml`` (utils/yaml_output.py), ``--analyze`` (the
cell-occupancy histogram) and ``-s`` (utils/profile.py).  The
multi-process launch (``--numProcs/--coordinator/--procId``, the
reference's mpirun surface) runs every process with the same command line
but its own ``--procId``; each owns a block of the mesh's shards
(parallel/dist.py says which backend carries the exchanges; under
``--commImpl ki|ki_fused`` the halo kernels push into the other processes'
CUDA IPC receive planes, parallel/ki_comm.py) and only process 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from .config import Config
from .parallel import dist
from .parallel.mesh import make_mesh
from .sim import init_simulation
from .utils.timers import PerfTimers
from .constants import KB_EV


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="comd-tpu-torch",
        description="CoMD on PyTorch + CUDA: classical molecular dynamics "
                    "(EAM or Lennard-Jones) with link cells on one GPU, "
                    "optionally decomposed into a mesh of shards "
                    "(-i/-j/-k).")
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
      help="halo transport of a mesh run: plain torch copies, or the "
           "kernel-initiated CUDA pushes (ki: K3; ki_fused: K4 on the x "
           "stage of the dfEmbed exchange, K3 elsewhere)")
    a("--halfShell", action="store_true",
      help="Newton's-3rd-law pair-once sweeps (the reference half-list "
           "kernels): every cell method runs the one half-shell CUDA "
           "kernel")
    a("--halfFetch", default="slices", choices=["slices", "window"],
      help="accepted for parity with comd_tpu (its XLA half-sweep j "
           "delivery); the port has one half kernel and ignores it")
    a("--halfMaterialize", action="store_true",
      help="accepted for parity with comd_tpu (an XLA optimization "
           "barrier in its half sweep); the port has one half kernel and "
           "ignores it")
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
    a("--coordinator", default=os.environ.get("COMD_COORDINATOR"),
      metavar="HOST:PORT",
      help="process 0's host:port, where the processes of a launch meet "
           "(torch.distributed over tcp://); with --numProcs > 1")
    a("--numProcs", type=int,
      default=int(os.environ.get("COMD_NUM_PROCS", "1")),
      help="total number of launched processes; each owns a block of "
           "the mesh's shards")
    a("--procId", type=int,
      default=int(os.environ.get("COMD_PROC_ID", "-1")),
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


def check_overflow(sim, i_step: int) -> None:
    """Abort on the overflow flag (set at init or by a step)."""
    if sim.overflow:
        cfg = sim.cfg
        raise RuntimeError(
            f"capacity overflow at step {i_step}: a cell exceeded "
            f"--maxAtoms (max_atoms={cfg.max_atoms}), a neighbor list row "
            f"exceeded its K (nl_max_neighbors={cfg.nl_max_neighbors}, 0 = "
            f"auto), or a packed halo message exceeded --haloMsgFactor "
            f"(current {cfg.halo_msg_factor}; 0 ships full planes). Raise "
            f"the matching knob and rerun.")


def run(cfg: Config, out=sys.stdout, yaml_dir: str | None = None,
        analyze: bool = False, restore: str | None = None,
        checkpoint: str | None = None, checkpoint_rate: int = 0) -> dict:
    """Full reference-style run (comd_tpu.cli.run). Returns a result summary
    dict."""
    from .utils import checkpoint as ckpt

    timers = PerfTimers()
    timers.start("total")
    step0 = 0
    if restore is not None:
        sim, step0 = ckpt.load(restore, device=cfg.device)
        print(f"Restored checkpoint {restore} at step {step0}", file=out)
        # physics/geometry come from the stored config; the run-control
        # flags (-N steps to add, -n print rate) and the device from THIS
        # command line.  Warn about any other flag that differs from the
        # stored config: it is ignored.
        ignored = []
        for f in dataclasses.fields(cfg):
            if f.name in ("n_steps", "print_rate", "device"):
                continue
            new, old = getattr(cfg, f.name), getattr(sim.cfg, f.name)
            if new != old and new != getattr(Config(), f.name):
                ignored.append(f"{f.name}={new!r} (checkpoint has {old!r})")
        if ignored:
            print("# WARNING: --restore ignores these flags; the stored "
                  "config wins: " + ", ".join(ignored), file=out)
        sim.cfg = dataclasses.replace(sim.cfg, n_steps=cfg.n_steps,
                                      print_rate=cfg.print_rate)
    else:
        sim = init_simulation(cfg, timers=timers)
    cfg = sim.cfg

    serial = cfg.nprocs == 1
    for key, val in sim.pot.describe():
        print(f"  {key:<17}: {val}", file=out)
    print(f"  {'Processors':<17}: {cfg.xproc} x {cfg.yproc} x {cfg.zproc}"
          + ("" if serial else
             f" shards on {sim.device}, --commImpl {cfg.comm_impl}")
          + _launch_text(sim), file=out)
    print(file=out)
    if analyze:
        analyze_input(sim, out=out)
    if serial and cfg.comm_impl != "collective":
        print(f"# WARNING: --commImpl {cfg.comm_impl} selects a halo "
              "TRANSPORT and only applies to multi-device runs (-i/-j/-k); "
              "this serial run has no halo exchange to transport.",
              file=out)
    if cfg.resolved_gpu_async:      # as comd_tpu/cli.py:244-265
        uses_nl = cfg.use_nl or cfg.use_pairlist
        if serial and cfg.gpu_async > 0:
            # the serial implementation has no exchange to overlap
            print("# WARNING: -a 1 overlaps interior force compute with the "
                  "halo collectives and only applies to multi-device runs "
                  "(-i/-j/-k); this serial run has no exchange to overlap "
                  "and ignores -a.", file=out)
        elif not serial and (cfg.method == "cta_cell" or
                             (cfg.half_shell and not uses_nl)):
            print("# WARNING: -a 1 replaces the cta_cell/half-shell sweep "
                  "with the interior/boundary split sweeps (the overlap "
                  "needs the split formulation).", file=out)

    e0 = (sim.e_potential + sim.kinetic_energy()) / sim.n_global
    n0 = sim.sum_atoms()
    print(f"Initial energy : {e0:14.12f}, atom count : {n0}\n", file=out)
    print(HEADER, file=out)

    timers.start("loop")
    i_step = step0
    n_end = step0 + cfg.n_steps
    print_things(sim, i_step, 1e-9, 1, out=out, timers=timers)
    check_overflow(sim, i_step)
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
        check_overflow(sim, i_step)
        print_things(sim, i_step, dt_wall, n_block, out=out, timers=timers)
        # periodic checkpoint on interval CROSSINGS, so rates that are not
        # a multiple of printRate still fire
        if checkpoint is not None and checkpoint_rate > 0 and \
                i_step < n_end and \
                (i_step - step0) // checkpoint_rate > \
                (i_step - n_block - step0) // checkpoint_rate:
            ckpt.save(checkpoint, sim, i_step)
            print(f"# checkpoint written at step {i_step}", file=out)
    timers.stop("loop")
    if checkpoint is not None:
        ckpt.save(checkpoint, sim, i_step)
        print(f"# final checkpoint written to {checkpoint} "
              f"(step {i_step})", file=out)

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

    # stop the run timers BEFORE any -s profiling: the profile's repeated
    # phases must not inflate the reported total
    timers.stop("total")

    if cfg.gpu_profile:
        # -s: single-force profiling mode (CoMD.c:216-218) -- attribute the
        # step phases, each timed on its own on clones of the state
        from .utils.profile import profile_phases, report_phases
        print("\nProfiling mode (-s): phase-attributed timing", file=out)
        phases = profile_phases(sim, out=out)
        print(report_phases(phases, sim.n_global), file=out)
        analyze_input(sim, out=out)
    print(timers.report(sim.n_global, cfg.n_steps), file=out)
    print(timers.rank_stats(), file=out)

    result = {
        "e_initial": e0,
        "e_final": e_final,
        "atoms_lost": n0 - n_final,
        "atom_rate_atoms_per_us": timers.atom_rate(sim.n_global, cfg.n_steps),
        "n_global": sim.n_global,
    }
    if yaml_dir is not None:
        _write_yaml(yaml_dir, cfg, sim, result, out)
    return result


def _launch_text(sim) -> str:
    """The multi-process launch as the prolog and the YAML report name it
    ("" for a single process)."""
    n = dist.process_count()
    if n == 1:
        return ""
    ki = ("; ki: CUDA IPC planes, stream-ordered flags"
          if sim.device.type == "cuda" and sim.cfg.comm_impl != "collective"
          else "")
    return f", {n} processes ({dist.describe(sim.device)}{ki})"


def _write_yaml(yaml_dir, cfg: Config, sim, result, out):
    """YAML run report (yamlOutput.c, CoMD.c:498-552), comd_tpu's sections
    and keys; the command-line parameters include the port's ``device``,
    and a multi-process launch adds "Processes".  Collective: every
    process takes part in the reductions, process 0 writes."""
    from . import __version__
    from .utils.yaml_output import YamlReport

    max_occ = sim.max_occupancy()
    if dist.process_index() != 0:
        return
    rep = YamlReport(variant="comd-tpu-torch", out_dir=yaml_dir).open()
    rep.header(__version__)
    rep.section("Command Line Parameters")
    for k, v in vars(cfg).items():
        rep.kv(k, v)
    rep.section("Simulation data")
    rep.kv("Total atoms", sim.n_global)
    rep.kv("Min global bounds", [0.0, 0.0, 0.0])
    rep.kv("Max global bounds", list(sim.global_extent))
    rep.section("Decomposition data")
    rep.kv("Processors", [cfg.xproc, cfg.yproc, cfg.zproc])
    if dist.process_count() > 1:
        rep.kv("Processes", _launch_text(sim)[2:])
    rep.kv("Local boxes", list(sim.geom.grid))
    rep.kv("Box size", list(sim.geom.box_size))
    rep.kv("Box factor", list(sim.geom.box_size / sim.pot.cutoff))
    rep.kv("Max Link Cell Occupancy",
           f"{max_occ} of {cfg.max_atoms}")
    rep.section("Potential data")
    for k, v in sim.pot.describe():
        rep.kv(k, v)
    rep.section("Validation")
    rep.kv("Initial energy", f"{result['e_initial']:.12f}")
    rep.kv("Final energy", f"{result['e_final']:.12f}")
    rep.kv("Atoms lost", result["atoms_lost"])
    rep.section("Performance")
    rep.kv("Atom rate (atoms/us)",
           f"{result['atom_rate_atoms_per_us']:.4f}")
    rep.close()
    print(f"YAML report written to {rep.path}", file=out)


def analyze_input(sim, out=sys.stdout):
    """Occupancy histogram of link cells (AnalyzeInput,
    src-mpi/gpu_utility.c:785-862)."""
    hist = np.asarray(sim.occupancy_histogram())
    print("# cell-occupancy histogram (atoms-per-cell, num-cells)", file=out)
    for occ, n in enumerate(hist):
        if n:
            print(f"{occ:4d} {n:8d}", file=out)
    occ = np.arange(len(hist))
    n_cells = hist.sum()
    mean = float((occ * hist).sum() / max(n_cells, 1))
    hi = int(occ[hist > 0].max()) if n_cells else 0
    print(f"# mean {mean:.2f}  max {hi}  "
          f"capacity {sim.cfg.max_atoms}", file=out)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    out = sys.stdout
    if args.numProcs > 1:
        # the launch (initParallel, parallel.c:66-118): every process runs
        # the same program; only process 0 prints (printRank,
        # parallel.c:48-52)
        try:
            # the shards split evenly over the processes, before any work
            # (a restore's mesh comes from its checkpoint: init checks it)
            if args.restore is None:
                make_mesh(cfg.xproc, cfg.yproc, cfg.zproc, "cpu",
                          nprocs=args.numProcs)
            dev = dist.init(args.numProcs, args.coordinator, args.procId,
                            cfg.device)
        except ValueError as e:
            print(f"comd-tpu-torch: {e}. Fatal Error.", file=sys.stderr)
            return 1
        cfg = dataclasses.replace(cfg, device=str(dev))
        if dist.process_index() != 0:
            out = open(os.devnull, "w")
    try:
        run(cfg, out=out, yaml_dir=args.yaml, analyze=args.analyze,
            restore=args.restore, checkpoint=args.checkpoint,
            checkpoint_rate=args.checkpointRate)
    except (ValueError, FileNotFoundError) as e:
        print(f"comd-tpu-torch: {e}. Fatal Error.", file=sys.stderr)
        return 1
    finally:
        if out is not sys.stdout:
            out.close()
        dist.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
