"""Run configuration, mirroring the reference CLI surface.

Field-for-field copy of comd_tpu.config.Config (same fields, defaults,
``resolve()`` and ``resolved_*`` properties, so the two CLIs resolve a
command line identically) plus the torch device and torch dtypes.  The
TPU-era knobs (sweep_impl, half_fetch, ...) are kept for flag parity; the
port's treatment of each is documented on the field.
"""
from __future__ import annotations

import dataclasses

import torch

# Kernel-strategy names accepted by -m/--method (src-mpi/defines.h:10-17).
# In the port every cell-sweep name (thread_atom, warp_atom, cta_cell) runs
# the one hand-written CUDA cell-stencil kernel (ops/cuda/stencil.py);
# cta_cell takes the pair functions of comd_tpu's Pallas path (Chebyshev,
# whatever -P says, in f32; sim.Physics._setup_physics), and
# every neighbor-list name (thread_atom_nl, warp_atom_nl, cpu_nl) and -L
# the one Verlet-list path on the list kernels (ops/cuda/nl.py); cpu_nl
# differs from the others only in its -a auto default (0), as in comd_tpu.
# The per-name comments below describe comd_tpu's mapping.
METHODS = (
    "thread_atom",     # default: XLA cell-pair sweep, auto formulation
                       # (window-fetch dense slices at A<=32)
    "thread_atom_nl",  # Verlet neighbor-list variant
    "warp_atom",       # XLA cell-pair sweep pinned to the GATHER formulation
                       # (27-way row gather, j slots on lanes -- the
                       # warp-per-atom-walking-neighbor-rows analog); a real
                       # tuning point: gather wins at A>32 (5-sigma LJ cells)
    "warp_atom_nl",    # alias of thread_atom_nl on TPU
    "cta_cell",        # cell-pair sweep with explicit VMEM staging (Pallas)
    "cpu_nl",          # pure-jnp reference path (the correctness oracle)
)


@dataclasses.dataclass
class Config:
    """All run parameters. Defaults match src-mpi/mycommand.c:194-221."""

    # --- potential selection ---
    pot_dir: str = "pots"
    pot_name: str = ""          # default depends on pot_type, see resolve()
    pot_type: str = "funcfl"    # funcfl | setfl
    doeam: bool = False

    # --- problem size ---
    nx: int = 20
    ny: int = 20
    nz: int = 20

    # --- device decomposition (processors -> mesh axes) ---
    xproc: int = 1
    yproc: int = 1
    zproc: int = 1

    # --- time stepping ---
    n_steps: int = 100
    print_rate: int = 10
    dt: float = 1.0             # fs
    lat: float = -1.0           # <0 -> use potential's lattice constant
    temperature: float = 600.0  # K
    initial_delta: float = 0.0  # Angstroms

    # --- method / optimization knobs ---
    method: str = "thread_atom"
    relative_skin_distance: float = 0.1   # -S (only used by *_nl / pairlist)
    do_hilbert: bool = False              # -H space-filling cell order
    gpu_async: int = -1                   # -a: interior/boundary overlap;
                                          # -1 = auto (on for NL families,
                                          # off for cell sweeps -- see
                                          # resolved_gpu_async)
    gpu_profile: bool = False             # -s: 0 steps, single force eval
    lj_interpolation: bool = False        # -I: table-interpolated LJ
    lj_cutoff_factor: float = 2.5         # LJ cutoff / sigma: 2.5 = upstream
                                          # CoMD golden config; 5.0 = the
                                          # reference fork (ljForce.c:114)
    spline: bool = False                  # -P: cubic-spline tables
    use_pairlist: bool = False            # -L: persistent pair masks

    # --- torch device: the main path runs on "cuda"; "cpu" runs the plain
    # PyTorch versions of every kernel (tests).  No fallback between them.
    device: str = "cuda"

    # --- TPU-native knobs (replace reference compile-time constants) ---
    max_atoms: int = 0          # per-cell capacity (reference compile-time
                                # MAXATOMS=64, Makefile:16); 0 = auto-size
                                # from the measured t=0 peak occupancy
                                # (cells.plan_cells) -- sweep cost scales
                                # with capacity slots, so auto beats any
                                # fixed constant
    cell_mode: str = "auto"     # cell sizing: "classic" (reference
                                # floor(extent/cutoff), linkCells.c:131),
                                # "commensurate" (cell=(k/2)*lat so faces
                                # fall midway between FCC site planes:
                                # uniform, time-stable occupancy -> no
                                # capacity slack), "auto" = price both
                                # against the slot-cost model and take the
                                # cheaper (cells.plan_cells)
    dtype: str = "float32"      # dynamics dtype; energies always f64-accumulated
    energy_dtype: str = "float64"
    box_chunk: int = 0          # port: chunks only the plain PyTorch sweep
                                # (CPU tensors); the CUDA kernel ignores it.
                                # comd_tpu: boxes per force-sweep chunk (memory knob);
                                # 0 = auto (1024 for the dense slice sweep,
                                # whose per-chunk slice setup amortizes with
                                # chunk size and whose A<32 tensors stay in
                                # VMEM at C=1024; 256 otherwise -- larger
                                # chunks measured to spill at A=32)
    interp_impl: str = "auto"   # port: "cheb" -> the Chebyshev evaluator;
                                # "rows"/"twolevel" -> the exact table
                                # evaluator (direct quadratic interpolation).
                                # comd_tpu: EAM table lookup: "rows" (exact gathers),
                                # "twolevel" (gather-free one-hot matmul,
                                # ~40x faster on TPU, <=1 ulp), "cheb"
                                # (Chebyshev-in-r^2 FMA chain, no memory
                                # access at all, ~3e-6/3e-4 rel value/force
                                # vs the reference interpolant), "auto" =
                                # cheb for f32 dynamics, twolevel for f64
                                # (reference-interpolant-exact to <=1 ulp;
                                # "rows" is the bit-exact oracle, ~100x
                                # slower on TPU, request it explicitly)
    comm_impl: str = "collective"  # halo transport: "collective"
                                   # (lax.ppermute; XLA owns scheduling),
                                   # "ki" (Pallas make_async_remote_copy
                                   # for BOTH the dfEmbed and the atom
                                   # exchange -- the kernel-initiated
                                   # comm_ki analog), or "ki_fused" (ki +
                                   # the x-stage dfEmbed push fused into
                                   # the in-kernel embedding-derivative
                                   # evaluation, comm_ki.cuh:187-310)
    sweep_impl: str = "auto"    # port: accepted and ignored -- every
                                # formulation is the one CUDA kernel.
                                # comd_tpu: cell-sweep formulation: "gather" (27-way
                                # row gather, j slots on lanes), "dense"
                                # (same pair-tensor layout, j rows fetched
                                # as static shifted slices of the dense 3D
                                # cell order -- no gather), "dense_w"
                                # (dense with the 27 views cut as STATIC
                                # slices of one contiguous per-chunk window
                                # fetch -- minimum per-chunk traffic),
                                # "dense_wg" (window fetch with the pair
                                # tensor cut into 128-lane j-cell groups,
                                # G = 128//A offsets each -- the lane-pack
                                # probe, VERDICT r3 item 2b),
                                # "dense_wf" (window kept lane-FLAT
                                # [3, L*A] in HBM, reshaped in VMEM --
                                # removes the A->128 lane-padding tax,
                                # 128/A x bytes, from the fetch),
                                # "dense_f" (dense_wf + lane-flat chunk
                                # outputs), or "dense_t" (transposed
                                # stencil: cells on lanes).  The dense
                                # forms avoid the padded-minor-axis gather
                                # traffic that dominates at A<32 (round-3
                                # measurement); "auto" picks by capacity
    half_shell: bool = False    # port: every cell method runs the half-shell
                                # CUDA kernel (K2, ops/cuda/stencil.py).
                                # comd_tpu: cell sweeps evaluate each pair
                                # once (Newton's 3rd law) and deliver the j
                                # side by overlap-added shifted slices + a
                                # halo fold (the reference's half-list
                                # kernels, ljForce.c:146-265).  Measured on
                                # v5e the full sweep WINS despite 1.9x more
                                # pair evaluations (the i- and j-side
                                # reductions each rematerialize the pair
                                # block, and the dense j-delivery adds
                                # traffic; see docs/BENCHMARKS.md), so this
                                # is a parity/correctness path, off by
                                # default.  Ignored by *_nl, cta_cell, -a.
    half_fetch: str = "slices"  # port: accepted and ignored (one half
                                # kernel).  comd_tpu: half-sweep j delivery:
                                # "slices" (one dynamic slice per stencil
                                # offset, 14 per chunk -- the round-2
                                # formulation) or "window" (ONE contiguous
                                # window per chunk, offsets as static
                                # in-window views -- the round-3d window
                                # fetch applied to the half sweep; VERDICT
                                # r3 item 2a re-test)
    half_materialize: bool = False  # port: accepted and ignored.
                                # comd_tpu: half sweep: optimization_barrier
                                # the per-pair products before the dual i/j
                                # reduction, forcing ONE materialization of
                                # the pair block instead of a remat per
                                # reduce side (the suspected round-2
                                # half-shell-null cause).  Measured knob.
    lazy_shell: bool = True     # cell methods: size cells cutoff+skin and
                                # rebucket only on the skin/2 trigger instead
                                # of every step (strictly faster than the
                                # reference's per-step redistribution; set
                                # False or -S 0 for eager parity behavior)
    energy_every_step: bool = False  # True: compute potential energy every
                                # step inside scan blocks (the reference
                                # kernels do); False (default): energy terms
                                # only on the last step of each block --
                                # identical dynamics, energy exact at every
                                # reporting boundary (printRate cadence)
    halo_msg_factor: float = 0.6  # count-packed atom halo messages: per-face
                                # entry capacity as a fraction of the full
                                # two-plane slot count (the reference ships
                                # on-GPU-scanned packed sizes,
                                # gpu_kernels.cu:684-690; static XLA shapes
                                # make it a capped buffer + count).  The
                                # outer local plane is the only one with
                                # real occupancy, so ~0.5 is the worst
                                # legitimate load (exact-pack commensurate
                                # cells) and 0.6 leaves migrant headroom.
                                # 0 ships full-capacity planes (round-3
                                # behavior); overflow aborts either way.
    nl_max_neighbors: int = 0   # 0 = auto-size from density; reference fixed
                                # MAXNEIGHBORLISTSIZE=64 (defines.h:66) only
                                # fits the EAM cutoff, not LJ 2.5*sigma
    nl_rows_factor: float = 1.0  # NL row capacity as fraction of n_local*A
    nl_chunk: int = 2048        # port: accepted and ignored (the list
                                # kernels take every row in one launch; the
                                # plain versions chunk by a memory budget,
                                # ops/neighborlist.PLAIN_BUDGET).  comd_tpu:
                                # NL rows per sweep chunk

    def resolve(self) -> "Config":
        cfg = dataclasses.replace(self)
        if not cfg.pot_name:
            cfg.pot_name = (
                "Cu01.eam.alloy" if cfg.pot_type == "setfl" else "Cu_u6.eam"
            )
        if cfg.method not in METHODS:
            raise ValueError(
                f"invalid method {cfg.method!r}; choose one of {METHODS}")
        if cfg.half_fetch not in ("slices", "window"):
            raise ValueError(
                f"invalid half_fetch {cfg.half_fetch!r}; "
                "choose 'slices' or 'window'")
        if cfg.gpu_profile:
            cfg.n_steps = 0
        return cfg

    @property
    def use_nl(self) -> bool:
        return self.method in ("thread_atom_nl", "warp_atom_nl", "cpu_nl")

    @property
    def resolved_gpu_async(self) -> int:
        """-a with a measured auto default (docs/BENCHMARKS.md round 5).

        Explicit ``-a 0/1`` is honored.  Auto (-1) resolves to 1 on the
        performance NL families -- ``thread_atom_nl``/``warp_atom_nl``
        and the -L pairlist (which runs the same NL stepping machinery,
        parallel/sharded.py uses_nl): the interior/boundary row-split
        partitions the SAME rows (no duplicated work), measured 10.5%
        FASTER on EAM and noise-neutral on LJ on the sharded machinery
        even with no real exchange latency (670 vs 748 ms/step, 32^3
        forced-sharded at 1x1x1) -- safe-by-default at any mesh size.
        ``cpu_nl`` stays 0 under auto so the correctness oracle keeps
        the plain (unsplit) force path as an independent reference.
        Cell-family sweeps resolve to 0: the split duplicates sweep
        dispatch and costs 8-15% single-chip; flip ``-a 1`` on
        explicitly for multi-chip cell runs per the ICI model (the halo
        share it hides at scale).  Scope: the split exists only in the
        sharded stepping machinery; the serial single-process
        implementation (sim.Simulation, nprocs == 1) has no exchange
        and ignores this flag entirely (the CLI warns on an explicit
        serial ``-a 1``).  Reference analog: timestep.c:257-265.
        """
        if self.gpu_async >= 0:
            return self.gpu_async
        return 1 if (self.method in ("thread_atom_nl", "warp_atom_nl")
                     or self.use_pairlist) else 0

    @property
    def resolved_sweep_impl(self) -> str:
        if self.sweep_impl != "auto":
            return self.sweep_impl
        if self.method == "warp_atom":
            # the -m warp_atom tuning point: pin the gather formulation
            # (explicit --sweepImpl overrides)
            return "gather"
        # measured (docs/BENCHMARKS.md rounds 3c-3d): per-chunk j-fetch
        # overhead dominates the sweep outside the pair compute; the
        # window-fetch dense sweep (ONE contiguous dynamic slice per
        # chunk, 27 static in-window views) minimizes it and beats both
        # the gather and the 27-dynamic-slice dense forms at A=16 AND
        # A=32 (EAM 63^3: 30.5 vs 36.5 ms; EAM 64^3: 41.3 vs 44.4; LJ
        # 64^3: 13.3 vs 15.0).  Above 32 the window sweep loses: at the
        # 5-sigma LJ capacity (A=176, k=7 cells) dense_w measured 2.0x
        # worse at C=256 and still 1.66x worse at C=64 (the [C, A, 27A]
        # pair tensor is 30x the A=32 footprint at equal C, so the chunk
        # must shrink until the per-chunk prologue dominates) -- gather
        # is the measured answer for big-A cells (round-5 batch 4,
        # tools/r5_logs/lj28_5sig_*.log).
        return "dense_w" if 0 < self.max_atoms <= 32 else "gather"

    @property
    def resolved_box_chunk(self) -> int:
        if self.box_chunk > 0:
            return self.box_chunk
        if self.resolved_sweep_impl in ("dense", "dense_w", "dense_wg",
                                        "dense_wf", "dense_f"):
            # chunk=1024 amortizes per-chunk overhead at A=16; the A=32
            # pair tensor is 4x larger per chunk and spills above 256
            # (measured: EAM 64^3 dense_w C=512 = 82 ms vs C=256 = 41)
            return 1024 if 0 < self.max_atoms < 32 else 256
        return 256

    @property
    def resolved_interp_impl(self) -> str:
        if self.interp_impl != "auto":
            return self.interp_impl
        return "cheb" if self.dtype == "float32" else "twolevel"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def torch_energy_dtype(self) -> torch.dtype:
        return getattr(torch, self.energy_dtype)

    @property
    def nprocs(self) -> int:
        return self.xproc * self.yproc * self.zproc
