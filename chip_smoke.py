#!/usr/bin/env python3
"""Smoke run of comd_tpu_torch's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each, failing (non-zero exit, no result line) on
the first error:
  1. device   -- a CUDA card is required; prints nvidia-smi's name and
                 power limit, whether torch's CUDAGraph has conditional-node
                 calls (torch 2.11 has none: the step's IF nodes go through
                 csrc/graph_if.cu) and the call that routes an IF body's
                 allocations into a private pool (phase 18 needs it)
  2. build    -- compiles the kernel sources (csrc/stencil.cu, comm.cu,
                 probe.cu, nl.cu, graph_if.cu, step.cu, rebucket.cu,
                 arrivals.cu)
                 with nvcc, one process each, in parallel; prints
                 registers and spill
                 stores (stencil.cu's and nl.cu's pair kernels by variant)
                 and fails if an f32 pair kernel of a main path spills
  3. kernel   -- K1 against its plain PyTorch version on the same CUDA
                 tensors (thermalized 10^3 lattice, T = 600 K), EAM pass 1
                 and pass 3, f32/Chebyshev and f64/table
  4. golden   -- T = 0 Adams Cu cohesive energy at 6^3, f64, through K1:
                 -3.538079224691 eV/atom within 1e-9
  5. main     -- the headline run: 63^3 FCC Cu (1,000,188 atoms), EAM
                 funcfl, f32, auto commensurate cells, lazy-shell stepping,
                 10 x step_block(10); checks atom count, overflow, energy
                 drift, that every step launched both K1 passes, and that
                 the step kernels of csrc/step.cu launched 100 times each
                 (kick_drift_trigger, with the ghost refresh; land), 101
                 (embed_fill: the initial force too) and 1 + the
                 rebuckets (refresh_halo: the rebucket's halo fill and
                 the initial one), csrc/rebucket.cu's bin and place
                 launches once a rebucket, then
                 times each pass against its plain version at that shape
                 and checks that two launches of K1 pass 1 (with and
                 without energy) and pass 3 give the same bits.
  6. half kernel -- K2 against its plain version on the same CUDA tensors
                 (thermalized 10^3): EAM passes 1 (with and without energy)
                 and 3 at f32/Chebyshev and f64/table, and LJ; K1's LJ
                 variant likewise.  Dense unfolded outputs are compared (both
                 use the same half map).  Tolerances: f32 forces atol 1e-4
                 eV/A and scalars 1e-5 of their largest value (another
                 summation order, K2's with atomics in run-to-run order);
                 f64 1e-12 relative.
  7. goldens  -- f64 through the kernels, within 1e-9: Adams 6^3 with
                 --halfShell; LJ 6^3 full and half; 5-sigma LJ 8^3 (A = 256
                 on a 2^3 grid) full and half.
  8. half main -- the headline run with --halfShell (K2 for passes 1 and 3),
                 the same checks; one fold_halo launch a fold (rhobar and
                 the force every force, phi on the energy steps: 213); K2
                 against K1's force at the initial and final states; K2's
                 times beside K1's and the plain versions.
  9. LJ main  -- 63^3 LJ f32 (A = 32, 35^3 cells), full (K1) and
                 --halfShell (K2), 100 steps each, the same checks and times.
 10. comm kernels -- the halo kernels against their plain versions on a
                 thermalized 10^3 EAM state on a 2x2x2 mesh of shards, f32
                 and f64, bitwise: the dfEmbed fill in one launch (halo_fill;
                 ki: K3's plane copies, ki_fused: K4's F' on the x stage),
                 K4 alone (pass2_push, a one-stage fill) against pass 2's F'
                 at the same rows, and the atom stage push (ring_push, K3)
                 of all three stages.
 11. sharded goldens -- f64, T = 0, within 1e-9: Adams 6^3 on 2x2x2 with
                 --commImpl ki_fused, full shell and --halfShell; LJ 12x8x4
                 on 3x2x1 with --commImpl ki (2 cells per shard axis).
 12. sharded main -- the 63^3 headline on a 2x2x2 mesh of shards on the one
                 card, --commImpl ki_fused, ki, then collective: the run_main
                 checks, K1 passes 1 and 3, embed_fill, kick_drift_trigger
                 and land each one launch a force (a step) over the 8
                 shards' stack, under every
                 transport exactly one fill launch a force (init and every
                 step; collective's too: K3's copies), three ring_push
                 launches an atom exchange under ki and ki_fused and three
                 atom_pack under collective, the
                 final r and ePot of the three transports equal bit for bit,
                 the initial ePot within 1e-6 of phase 5's; the halo kernels
                 against their plain versions at that state; one whole fill
                 timed (mean of 20, CUDA events; the host's time a call; the
                 device's, torch.profiler) under ki, ki_fused and, as the
                 torch-ops comparison, collective (exchange.exchange_scalar),
                 and one atom stage push, beside their plain versions and
                 bounds (bytes of the stages / 3.35 TB/s); the ki fill's
                 device time cut to its first one and two stages (what a
                 stage and its grid barrier cost).  Eight shards on
                 one card measure the decomposition's overhead against the
                 serial run, not scaling.
 13. probes   -- the archive probes through their commands
                 (comd_tpu_torch.probes.window P1, P2, P3, P3 --lj;
                 .lookup P4, P5, P6), then window_pair against its plain
                 version (P1, P2, P3 EAM and LJ at the probes' shapes, P3
                 at 72 chunks, 509.6M pairs ~ one K1 pass of phase 5, and
                 P3 on a dense input whose lists drain many times: each
                 element within 1e-5 of the sum of its terms' magnitudes
                 and each output within 1e-5 of its largest value, all
                 finite, two launches the same bits) and row_lookup /
                 lane_lookup bit for bit at scale 1e-12 and 1, also on
                 tables whose columns differ; times (CUDA events, host ms
                 a call, device ms under torch.profiler) beside plain
                 versions and bounds (flops the function needs: r2 on
                 every pair, the pair function on the pairs inside the
                 cutoff), window_pair's launch plan, the 72-chunk time per
                 pair and list lengths beside K1's pass 1; the lookups'
                 library calls (P4: torch.index_select of the rows, P5/P6:
                 torch.gather of the lanes) timed.
 14. nl       -- the Verlet-list kernels (csrc/nl.cu) against their plain
                 versions on thermalized 10^3 states, EAM and LJ,
                 f32/Chebyshev and f64/table: NL1 lists, counts and
                 overflow bit for bit (also with K = 8, which must
                 overflow, and with the -a 1 row split), NL2 EAM passes 1
                 (with and without energy) and 3 and LJ at phase 6's
                 tolerances on the run's list, the K = 8 list (no row
                 padded) and the split list, two launches the same
                 bits; the Adams golden at 6^3 f64 through -m
                 thread_atom_nl; the 63^3 EAM -m thread_atom_nl and LJ -L
                 headlines (run_main's checks, NL2 twice (EAM) or once (LJ)
                 a force, one NL1 launch a build, builds counted), NL1/NL2
                 at that state against their plain versions, times beside
                 the plain versions and bounds (NL2's also counting every
                 entry of a real row, with ps a real list entry and a pair
                 inside the cutoff beside K1's pass 1), ms/step beside
                 phases 5 and 9; the EAM NL headline on a 2x2x2 mesh under
                 ki and collective (-a auto: the row split): initial ePot and
                 final energy within 1e-6 of the serial NL run's (63 is
                 odd: atom planes lie on the shards' cell faces), three
                 ring_push an atom exchange under ki and three atom_pack
                 under collective, one halo_fill a force under both (the
                 list fill is K3's copies), final r and ePot equal bit for
                 bit.  The list paths' row ops (csrc/nl.cu's nl_rows,
                 csrc/step.cu's embed_rows and land_rows) against their
                 plain versions (ops/neighborlist.py) on the same CUDA
                 tensors, bit for bit, at the thermalized 10^3 EAM states
                 (f32, f64) and the 63^3 f32 NL headline: ER with and
                 without energy, serial fill and zero halo rows, rows in
                 one and two segments; LR of one and two passes, with and
                 without the kick, one and two segments; NR with and
                 without the row split; each timed at 63^3 (a launch
                 replayed in a graph of 20 and a call from the host, CUDA
                 events) beside its plain version and byte bound, and
                 torch.cumsum of the clamped counts beside NR as a
                 yardstick for its scan.  At the 10^3 states also NR's
                 tiles and ER's vector and scalar forms on synthetic
                 counts (row_form_cases: 1300 and 100 cells, A = 32, 13,
                 30, 40, the split, short capacities), each twice bit
                 for bit.
                 The headlines count ER one a force a shard, LR one a
                 step a shard (and the initial force's), NR one a build a
                 shard, no embed_fill or land, and print the final r
                 sha256 and ePot.
 15. options  -- -P (the cubic splines in r^2) and -I (the LJ table) on
                 their kernel variants: K1's and K2's spline EAM passes 1
                 (with and without energy) and 3, NL2's on its lists, and
                 K1's LJ table (with and without energy) against their
                 plain versions on thermalized 10^3 states, f32 and f64,
                 at phase 6's tolerances, K1 and NL2 the same bits on two
                 launches; the f64 goldens at 6^3, T = 0, within 1e-9
                 (-e -P -3.538075619377 through K1, K2 and NL2; -I
                 -1.243619465563 through K1; comd_tpu's values); the 63^3
                 -P headline on K1, K2 (--halfShell) and NL2 (-m
                 thread_atom_nl) and the 63^3 -I LJ headline on K1, each
                 through run_main's checks with no launch of another
                 evaluator's kernel, ms/step beside phases 5 and 9, the
                 variants at that state against their plain versions and
                 timed (mean of 20, CUDA events) beside the plain versions
                 and bounds; -P on a 2x2x2 mesh under ki_fused: one
                 halo_fill a force with the ki plan (the fused fill's entry
                 point refuses to run), final energy within 1e-6 of the
                 serial -P run; a checkpoint on the card (63^3 EAM f32, 50
                 steps, save, restore into a fresh simulation, 50 more: r,
                 p and ePot equal an uninterrupted 100-step run bit for
                 bit); -s at 63^3 EAM: every phase positive, the force
                 phase within 2x of K1's passes (phase 5) plus pass 2.
 16. split    -- -a 1 of the cell methods on the 2x2x2 mesh: K1 over the
                 interior and the boundary cells apart (21^3 cells a
                 shard, 19^3 interior).  The 63^3 EAM headline under
                 ki_fused and collective and 63^3 LJ under collective
                 (with its -a 0 run beside it): run_main's checks, the
                 initial ePot within 1e-6 of the serial run's (phases 5,
                 9), exactly two launches of each K1 pass (LJ: of K1) a
                 force over the 8 shards, the final r and ePot of the two EAM
                 transports equal bit for bit, the final ePot within 1e-6
                 of the same transport's -a 0 run (phase 12; LJ: its run
                 here); K1 against its plain version on the interior and
                 on the boundary subsets of one shard at phase 6's
                 tolerances (EAM passes 1, with and without energy, and
                 3; LJ), the two subsets' sum against the full launch, and
                 the subset launches timed (mean of 20, CUDA events)
                 beside the full one; then the -m cta_cell -P repair: the
                 CLI's `-e -m cta_cell -P` printThings rows equal its
                 `-e -m cta_cell` rows (f32, 20^3), on Chebyshev K1 with
                 no spline launch.
 17. multiproc -- the multi-process launch on the one card: processes
                 share it, so the group's backend is gloo with every
                 message staged through pinned host buffers, and under
                 --commImpl ki|ki_fused the fill's and the atoms' planes
                 go through CUDA IPC receive planes (each process's arena,
                 opened by the others) ordered by counters on the stream.
                 The 63^3 headline (this script again with --mp-worker,
                 2x2x2, f32, 10 x step_block(10), the launch counts zeroed
                 just before the steps and read just after) under
                 collective on 2 and 4 processes, ki_fused on 2 and 4, ki
                 on 2: every worker's shards on cuda and K1's passes,
                 kick_drift_trigger and land one launch a step over its
                 shards' stack; under ki|ki_fused
                 one halo_fill_stage launch a fill stage and one ring_push
                 an atom stage on every process, no whole-fill launch, and
                 no fill or atom message through gloo; under collective
                 no halo_fill (the staged fill through the group) and
                 three atom_pack launches a rebucket; process 0's final
                 ePot and the sha256 of the final r gathered in shard
                 order equal phase 12's collective run bit for bit, the
                 initial ePot within 1e-6 of phase 5's, no atom lost, no
                 overflow; ms/step beside phase 12's and this phase's
                 collective, each process's kernels' busy ms/step
                 (torch.profiler), the launches a step against phase 12's
                 one process, the bytes a step through gloo and through
                 the arena (a ghost-refresh step, a rebucket step), the
                 host ms a step in the gloo staging copies and transfer,
                 and the CUDA-event, host and device ms of one
                 cross-process x fill stage and x atom stage beside phase
                 12's one-process fill and stage.  Then short CLI runs at
                 20^3 (-N 20 -n 10), process 0's printThings rows against
                 the single process's (cli_rows) digit for digit: 4
                 processes on 2x2x1; 2 with --halfShell (f64; K2's atomics
                 may move its last printed digit: then held to 1.5e-12
                 eV/atom); 2 with -m thread_atom_nl; 4 on 2x2x1 under ki;
                 2 with -a 1 under ki_fused; 2 with -m thread_atom_nl
                 under ki.  A worker that fails or outlives its time limit
                 fails the phase.  The kernels are built (phase 2) before
                 any worker starts.  (Phase 12 also holds halo_fill_stage,
                 process 0 of 2's fused x stage with local scratch planes,
                 against its plain version and times it.)
 18. graphs   -- the IF nodes' handles, which kick_drift_trigger
                 (csrc/step.cu) sets itself in the step's graph (no
                 set_condition kernel any more): a captured graph of one
                 trigger launch on the 63^3 state and two IF bodies that
                 count their runs, replayed with the trigger clear at a
                 baseline, clear at one slot displaced by exactly
                 (skin/2)^2 and set at its next ulp; the same in one
                 launch over a stack of 8 shards, one shard displaced;
                 the bodies' counts against the plain version's branch (the trigger read on the host); then a
                 graph of a trigger launch on one cell and one IF node
                 timed (CUDA events) beside the plain version and its
                 bound (set_condition's row, 0 launches, folded into
                 kick_drift_trigger).  Then the step's CUDA graphs
                 (comd_tpu_torch/stepgraph.py: one a step, the lazy and
                 list rebucket a conditional node) against the eager loop
                 (``sim.cuda_graphs = False``), in this process one after
                 the other, at 63^3 f32: EAM on K1, LJ on K1, EAM -m
                 thread_atom_nl (its device operations a step at most
                 10), EAM on 2x2x2 ki_fused, EAM -m thread_atom_nl on
                 2x2x2 ki (at most 120) and collective in one process,
                 and
                 -S 0 (a rebucket every step) on EAM K1 and on 2x2x2
                 ki_fused under -a 0 and -a 1.  Each run warms up through
                 its first rebucket (every graph captured), steps 100
                 timed steps (the -S 0 mesh runs 20; launch counts zeroed
                 just before), then 20 with the host syncs in step_block
                 counted (torch.cuda.set_sync_debug_mode) and 20 under
                 torch.profiler: ms/step of both, the device's busy
                 ms/step, operations a step and idle share of the wall
                 clock, launches a step
                 equal and no set_condition, one graph replay a step, the
                 IF nodes a graph (serial lazy and list steps one, the
                 rebucket's: the trigger launch refreshes the ghosts; the
                 mesh two; -S 0 none), serially refresh_halo launched
                 once a rebucket and never else, rebucket_bin and
                 rebucket_place once a rebucket a shard (the eager
                 loop's launches and the graphs' credits), host syncs outside
                 captures exactly one a lazy block (the
                 rebucket counter's read at its end) and none on -S 0,
                 the rebucket counts equal, the graphs' capture and
                 instantiation time, and the final r (sha256) and ePot
                 equal bit for bit.  --halfShell (K2's atomics) at 20^3
                 f64, serially and on 2x2x2 collective (the folds
                 fold_halo's stage launches): the printed energies per atom
                 within one unit of the last of 12 digits, whether the bits
                 agree reported.
 19. step ops -- the step's small ops (csrc/step.cu: kick_drift_trigger,
                 refresh_halo, embed_fill, land) against their plain
                 versions on the same CUDA tensors, bit for bit, at phase
                 5's 63^3 state (f32) and at a thermalized 10^3 state
                 (f64): the trigger against a baseline and with one slot
                 displaced by exactly (skin/2)^2 (clear), pass 2 with and
                 without energy, serial fill and zero halo (16-byte
                 vectors) and at an odd number of slots a row (one slot a
                 thread), the landing of
                 two passes and of one force, the trigger with the serial
                 image map (the ghost refresh in its launch; also in a
                 graph, setting the serial step's one IF handle) and the
                 whole halo fill (r, gid, n_atoms), both also at an odd
                 number of slots a row; then two steps (the second
                 an energy step) from one state through the kernels and
                 through the plain versions, a refresh step and a rebucket
                 step, at both states: r, p, f, triggers, n_local and ePot
                 equal bit for bit (the rebucket in place on its kernels
                 and on its plain version); each kernel timed at 63^3
                 (CUDA events, mean of 20) beside its plain version and
                 its bound (bytes).  Then the redistribution
                 (csrc/rebucket.cu's rebucket_bin and rebucket_place)
                 against rebucket_plain on the same CUDA tensors, bit for
                 bit, and the in-place serial body against its plain
                 version: the 63^3 f32 and 10^3 f64 states displaced by
                 up to 1 A across cell faces and the periodic boundary
                 (ten atoms on its faces or just across), halo landers
                 folded back under a wrap extent past a domain (f32,
                 f64), a shard of the 2x2x2 mesh (10^3 f64, keep_halo,
                 atoms leaving it), a Hilbert-numbered 8^3 grid, A = 13
                 and A = 40, a cell of A < n <= C atoms (exact, the flag
                 set) and one of n > C (the counts, n_migrating and the
                 flag equal; that cell's layout may differ); the serial
                 body (rebucket_into and the halo fill) at 63^3 timed
                 (CUDA events, mean of 20; each kernel's launch under
                 torch.profiler) beside its plain version, the byte
                 bounds and the earlier designs' times, the place launch
                 in the form rebucket.place_form(A) gives (the warp form
                 up to A = 32) and, on the same input, in the block form
                 (the same bits); both launches at a shard of the 63^3
                 2x2x2 mesh (23^3 cells, halo landers kept) against
                 rebucket_plain and timed in both forms.
 20. arrivals -- the atom exchange's unload (csrc/arrivals.cu:
                 arrivals_bin and arrivals_place a stage over every
                 shard, the place launch over the bin launch's list of
                 the cells that got arrivals (one list, one atomic a bin
                 block on its length), its length checked against the
                 plain version's cells;
                 sort_cells over every shard, the warp form at A <= 32)
                 against its plain
                 versions (append_stage_plain, sort_shards_plain) on the
                 same CUDA tensors at every stage, bit for bit in every
                 cell of at most C arrivals: the 63^3 f32 2x2x2 state
                 displaced by up to 0.5 A and rebucketed, under ki (the
                 sender's counts where ring_push left them), collective
                 (a flag an entry) and count-packed collective messages;
                 10^3 f64 on 2x2x2 and on 2x2x1 (an axis of one shard);
                 a crowded cell of A < n <= C arrivals (exact, the flag
                 set) and one of n > C (the counts and the flag equal);
                 one bin and one place launch a stage, one sort.  At the
                 63^3 state under ki each launch timed under
                 torch.profiler (mean of 20; the sort in both forms, the
                 earlier designs' times beside), a stage replayed in a
                 graph, the whole unload (3 ring_push, 3 bin, 3 place, 1
                 sort) with CUDA events (mean of 20) and in a graph,
                 beside the plain versions and the byte bounds; the bin
                 and place launches at the state of a real lazy rebucket
                 of the 63^3 2x2x2 ki_fused run (stepped eagerly until
                 its trigger fires) against the plain version and timed
                 likewise; one eager mesh redistribution's device
                 operations (at most 100).
                 Phase 12 checks 3 bin, 3 place and 1 sort launch an
                 exchange under every transport, phase 18 the graphs'
                 credits of them.
 21. positions -- the mesh's ghost-position refresh between rebuckets
                 (csrc/comm.cu's position_fill: one launch over the three
                 stages composed into one row map, every halo row of
                 every shard) against position_fill_plain and the staged
                 exchange.exchange_positions, bit for bit: the 63^3 f32
                 2x2x2 state displaced by up to 0.5 A (halo rows of
                 noise, all overwritten), 10^3 f64 on 2x2x2 and on 2x2x1
                 (an axis of one shard), each also at A = 13 (one slot a
                 thread); one launch a refresh; at the 63^3 state timed
                 (CUDA events, mean of 20; the device's time under
                 torch.profiler; in a graph of 20, two replays of a
                 captured refresh equal the plain version) beside the
                 torch refresh it replaces (its device operations and
                 time), the library form (one index_select of the stacked
                 positions on the composed index, with and without the
                 shifts' add) and the byte bound.  Phase 12 checks one
                 position_fill launch a step that does not rebucket
                 under every transport, phase 18 the graphs' credits of
                 it, phase 17 one position_fill_stage launch a stage
                 across processes under ki and ki_fused and no position
                 bytes through gloo.
 22. collective -- the collective transport's atom messages (csrc/comm.cu's
                 atom_pack: one launch a stage over every shard and both
                 faces) and the half-shell fold (fold_halo: one launch
                 serially, one a stage on a mesh) against atom_pack_plain
                 and fold_halo_plain, bit for bit: the 63^3 f32 2x2x2
                 state displaced by up to 0.5 A and rebucketed, packed
                 (the plan's caps), full planes and a cap of 64 that
                 overflows, each exchange carried on through its stages;
                 10^3 f64 on 2x2x2 and 2x2x1; the fold of [3, B, A] and
                 [B, A] noise at A = 16 and 13 on those meshes and
                 serially at 20^3 f64 and the 63^3 --halfShell geometry.
                 At 63^3 timed (CUDA events, mean of 20; the device's
                 time under torch.profiler, printed as a share of the
                 bound): one atom_pack stage beside
                 its plain version, the torch packing it replaces and the
                 byte bound (no single PyTorch call packs a message); the
                 serial fold beside its plain version, the clone +
                 index_add_ it replaced (the library form) and the bound;
                 the mesh fold's three launches beside the torch
                 exchange.fold_halo; the collective fill on halo_fill
                 beside the staged torch fill, the bound and the
                 index_select library form.  Phase 12 checks three
                 atom_pack launches an exchange under collective, phase 8
                 one fold_halo a fold, phase 18 the graphs' credits.
 23. stacked -- (run right after phase 12, on its ki_fused state) the
                 mesh's phases as one launch over its stack of 8 shards:
                 K1 passes 1 (with and without energy) and 3 over every
                 cell and over the -a 1 interior and boundary subsets,
                 kick_drift_trigger (one shard past skin/2: the or
                 fires), embed_fill (energy and not, zero halo, K1's
                 strided rhobar) and land (two passes, the count of every
                 shard), each against the 8 launches of S = 1 on the
                 shards' slices bit for bit and against its plain version
                 (the one-shard plain version shard by shard) at phase 6's
                 tolerances (the step kernels bit for bit); K2's three
                 passes in f64 on a 10^3 2x2x2 mesh likewise (bit for bit
                 unless two runs of the S = 1 launches differ themselves:
                 its j-side atomics); each stacked launch timed (CUDA
                 events, mean of 20; in a graph of 20) beside the 8 S = 1
                 launches, the serial launch at 42^3 (phase 5's state) and
                 its plain version, with the bound over the 8 shards; then
                 the device operations and busy ms a step of the lazy
                 2x2x2 ki_fused and collective, -S 0, --halfShell and -a 1
                 graph steps at 63^3.  The kernels line's stacked_* rows.
Then the kernels' JSON line and, last, {"ok": true, "device": {...}}.
Each main path runs with the launch counts set to 0 just before it and
read just after; every one-process lazy and list path (phases 5, 8, 9,
12, 14, 15, 16) steps through the CUDA graphs, whose replays credit the
launches each graph's capture recorded (a rebucket body's once a
rebucket, from the device's rebucket counter read at a block's end).
Imports torch, numpy and comd_tpu_torch only; builds everything from this
checkout (the eight sources with one nvcc each, in parallel).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
POTS = os.path.join(ROOT, "pots")
GOLDEN_EAM_ADAMS = -3.538079224691
GOLDEN_LJ = -1.243619295058
GOLDEN_LJ_5SIGMA = -1.406590686466
# comd_tpu on the CPU, T = 0 at 6^3, f64: -e -P and -I
# (tests/test_torch_spline.py holds them to comd_tpu's values)
GOLDEN_EAM_SPLINE = -3.538075619377
GOLDEN_LJ_INTERP = -1.243619465563
SOURCE = "comd_tpu_torch/csrc/stencil.cu"
COMM_SOURCE = "comd_tpu_torch/csrc/comm.cu"
PROBE_SOURCE = "comd_tpu_torch/csrc/probe.cu"
NL_SOURCE = "comd_tpu_torch/csrc/nl.cu"
PROBE_KEYS = ("window_pair", "row_lookup", "lane_lookup")
REPLACES = {"stencil": "comd_tpu/ops/pallas/stencil.py:48",
            "half": "comd_tpu/ops/pallas/stencil.py:204",
            "halo_fill": "comd_tpu/parallel/pallas_comm.py:39",
            "halo_fill_fused": "comd_tpu/parallel/pallas_comm.py:265, :39",
            "ring_push": "comd_tpu/parallel/pallas_comm.py:39",
            "window_pair": "tools/archive/pallas_probe.py:22, "
                           "tools/archive/pallas_probe2.py:38, "
                           "tools/archive/pallas_probe3.py:62,94",
            "row_lookup": "tools/archive/gather_probe.py:94",
            "lane_lookup": "tools/archive/gather_probe2.py:59,87",
            # no Pallas site: comd_tpu computes these in XLA
            "nl_build": "comd_tpu/ops/neighborlist.py:116 (build, XLA)",
            "nl_sweep": "comd_tpu/ops/neighborlist.py:180 (pair_sweep_nl, "
                        "XLA)",
            # no Pallas site: the list paths' row ops, XLA in comd_tpu
            "nl_rows": "no Pallas site: XLA comd_tpu/ops/neighborlist.py:"
                       "46-57, :74 (build_atom_list, build_atom_list_split)",
            "embed_rows": "no Pallas site: XLA fusion of "
                          "comd_tpu/ops/force_eam.py:420-439 (pass 2 on the "
                          "rows, scatter_rows, the dfEmbed fill)",
            "land_rows": "no Pallas site: XLA comd_tpu/ops/force_eam.py:437 "
                         "and comd_tpu/ops/force_lj.py:172-203 "
                         "(scatter_rows of the force), fused with "
                         "comd_tpu/sim.py:380-383",
            # no Pallas site: comd_tpu's jitted step leaves these to XLA's
            # fusions around the force
            "kick_drift_trigger": "no Pallas site: XLA fusion of "
                                  "comd_tpu/sim.py:367-370, :353-358 and "
                                  "comd_tpu/ops/neighborlist.py:161-168",
            "refresh_halo": "no Pallas site: XLA fusion of "
                            "comd_tpu/ops/binning.py:235-248",
            "embed_fill": "no Pallas site: XLA fusion of "
                          "comd_tpu/ops/force_eam.py:371-380, :603",
            "land": "no Pallas site: XLA fusion of comd_tpu/sim.py:380-383",
            # no Pallas site: comd_tpu's rebucket is one XLA fusion
            "rebucket_bin": "no Pallas site: XLA fusion of "
                            "comd_tpu/ops/binning.py:91-172 (the wrap, "
                            "bin and fold)",
            "rebucket_place": "no Pallas site: XLA fusion of "
                              "comd_tpu/ops/binning.py:91-172 (the sort "
                              "and scatter)",
            # no Pallas site: the shard's XLA program (exchange_atoms)
            "arrivals_bin": "no Pallas site: XLA fusion of "
                            "comd_tpu/ops/binning.py:175-214 "
                            "(append_arrivals: the bin)",
            "arrivals_place": "no Pallas site: XLA fusion of "
                              "comd_tpu/ops/binning.py:175-214 "
                              "(append_arrivals: the rank and scatter)",
            "sort_cells": "no Pallas site: XLA sort of "
                          "comd_tpu/ops/binning.py:217-232 (sort_cells)",
            # no Pallas site: three ppermutes in comd_tpu's XLA step
            "position_fill": "no Pallas site: XLA "
                             "comd_tpu/parallel/exchange.py:242 "
                             "(exchange_positions), called at "
                             "comd_tpu/parallel/sharded.py:403, :467",
            # no Pallas site: the collective transport's packing and the
            # half-shell fold are XLA in comd_tpu
            "atom_pack": "no Pallas site: XLA "
                         "comd_tpu/parallel/exchange.py:186-210 (the "
                         "count-packed atom message of exchange_atoms)",
            "fold_halo": "no Pallas site: XLA scatter-adds "
                         "comd_tpu/ops/sweep.py:615 (fold_halo_serial), "
                         "comd_tpu/parallel/exchange.py:270 (fold_halo)"}
MESH = dict(xproc=2, yproc=2, zproc=2)
HEADLINE_N = 63      # unit cells per axis of the main paths (1,000,188 atoms)
# Phase 14's EAM list runs (serial; 2x2x2 under ki and collective) end on
# these bits, final r sha256 and ePot: the values of the same runs on the
# list paths' torch row ops (commit 94cac40), which NR, ER and LR keep
NL_FINAL_BITS = {
    "nl main": ("99b24fd1ce8c3ebbfa5ae269afac879666445cf016787831e9b30a748"
                "d70b8d1", -3496386.8927383423),
    "ki": ("5f262aa7fd18202f2ea5056059cc25487139f666374f3852deb3209cc21b4"
           "3ed", -3496386.8973174095),
    "collective": ("5f262aa7fd18202f2ea5056059cc25487139f666374f3852deb320"
                   "9cc21b43ed", -3496386.8973174095)}
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def norm_rel(a, b) -> float:
    """max |a - b| / max |b|: dense half-shell sums hold partial sums on
    halo rows, some near zero, so they are held against their largest
    value."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def compare_passes(sim, tag: str, f_atol: float, s_rtol: float,
                   f_rtol: float = 0.0):
    """K1 vs plain version for EAM pass 1 and pass 3 on sim's state.
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


def compare_half(sim, tag: str, f_atol: float, s_rtol: float,
                 f_rtol: float = 0.0):
    """K2 vs plain version for EAM passes 1 (with and without energy) and 3
    on sim's state, dense unfolded outputs.  Returns ({half pass: max abs
    force err}, (r, half map, evaluator, dfEmbed, chunk))."""
    import torch
    from comd_tpu_torch.ops import binning
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.ops.sweep import fold_halo_serial
    r, hm, ev = sim.state.r, sim.maps.half_nbr_map, sim.pair_eval
    chunk = sim.cfg.resolved_box_chunk
    errs = {}
    fp, phip, rhop = st.eam_pass1_half_plain(r, hm, ev, want_energy=True,
                                             box_chunk=chunk)
    fmax = float(fp.abs().max())
    e_f = []
    for energy in (True, False):
        fk, phik, rhok = st.eam_pass1_half(r, hm, ev, want_energy=energy)
        torch.cuda.synchronize()
        e_f.append(float((fk - fp).abs().max()))
        e_s = max(norm_rel(rhok, rhop),
                  norm_rel(phik, phip) if energy else 0.0)
        check(e_f[-1] <= f_atol + f_rtol * fmax and e_s <= s_rtol
              and (phik is None) != energy,
              f"{tag} half pass 1 (energy {energy}): force err "
              f"{e_f[-1]:.3e}, scalar err {e_s:.3e}")
    errs["half_eam_pass1"] = max(e_f)
    rhobar = fold_halo_serial(sim.geom, sim.maps, rhop)
    dfe = torch.zeros(r.shape[1:], dtype=r.dtype, device=r.device)
    dfe[:sim.geom.n_local] = sim.f_eval(rhobar)[1]
    binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
    f3k = st.eam_pass3_half(r, hm, ev, dfe)
    f3p = st.eam_pass3_half_plain(r, hm, ev, dfe, box_chunk=chunk)
    torch.cuda.synchronize()
    errs["half_eam_pass3"] = float((f3k - f3p).abs().max())
    f3max = float(f3p.abs().max())
    check(errs["half_eam_pass3"] <= f_atol + f_rtol * f3max,
          f"{tag} half pass 3 force err {errs['half_eam_pass3']:.3e}")
    say("half", f"{tag}: K2 pass1 |df|max {errs['half_eam_pass1']:.3e} "
        f"(|f|max {fmax:.3e}); pass3 |df|max "
        f"{errs['half_eam_pass3']:.3e} (|f|max {f3max:.3e})")
    return errs, (r, hm, ev, dfe, chunk)


def compare_lj(sim, tag: str, f_atol: float, s_rtol: float,
               f_rtol: float = 0.0, half: bool = True):
    """K1's and (``half``) K2's LJ variants vs their plain versions on sim's
    state, with and without energy (the -I table: K1 only, and K1 gives
    the same bits on two launches).  Returns {kernel: max abs force
    err}."""
    import torch
    from comd_tpu_torch.ops.cuda import stencil as st
    r, ev = sim.state.r, sim.pair_eval
    chunk = sim.cfg.resolved_box_chunk
    errs = {}
    table = ev.kind == "lj_table"
    for key, fn, plain, nbr in (
            ("lj_table" if table else "lj", st.lj_pass, st.lj_pass_plain,
             sim.maps.nbr_map),
            ("half_lj", st.lj_pass_half, st.lj_pass_half_plain,
             sim.maps.half_nbr_map))[:2 if half else 1]:
        fp, ep = plain(r, nbr, ev, box_chunk=chunk)
        fmax = float(fp.abs().max())
        e_f = []
        for energy in (True, False):
            fk, ek = fn(r, nbr, ev, want_energy=energy)
            torch.cuda.synchronize()
            e_f.append(float((fk - fp).abs().max()))
            e_s = norm_rel(ek, ep) if energy else 0.0
            check(e_f[-1] <= f_atol + f_rtol * fmax and e_s <= s_rtol
                  and (ek is None) != energy,
                  f"{tag} {key} (energy {energy}): force err "
                  f"{e_f[-1]:.3e}, energy err {e_s:.3e}")
            if table:
                again = fn(r, nbr, ev, want_energy=energy)
                check(all(a is b or torch.equal(a, b)
                          for a, b in zip((fk, ek), again)),
                      f"{tag} {key} (energy {energy}) differs between two "
                      f"launches")
        errs[key] = max(e_f)
        say("lj", f"{tag}: {key} |df|max {errs[key]:.3e} "
            f"(|f|max {fmax:.3e})")
    return errs


def pair_work(sim, half: bool, chunk: int = 1024):
    """(candidate pairs, pairs inside the cutoff) of one sweep on sim's
    state: candidates are occupied i-slot x occupied j-slot pairs of the
    27 (or, half shell, 14 with the self-cell triangle) neighbor cells."""
    import torch
    r = sim.state.r
    n = sim.state.n_atoms.to(torch.int64)
    nbr = (sim.maps.half_nbr_map if half else sim.maps.nbr_map).to(
        torch.int64)
    n_local, n_nbr = nbr.shape
    A = r.shape[2]
    nl = n[:n_local]
    if half:
        cand = (nl * n[nbr[:, 1:]].sum(1) + nl * (nl - 1) // 2).sum()
    else:
        cand = (nl * n[nbr].sum(1)).sum()
    ok = torch.ones((A, n_nbr * A), dtype=torch.bool, device=r.device)
    if half:
        ok[:, :A] = torch.triu(ok[:, :A], diagonal=1)
    inside = 0
    for c0 in range(0, n_local, chunk):
        nb = nbr[c0:c0 + chunk]
        ri = r[:, c0:c0 + len(nb)]
        rj = r[:, nb].reshape(3, len(nb), n_nbr * A)
        dr = ri[:, :, :, None] - rj[:, :, None, :]
        r2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        inside += int(((r2 <= sim.pair_eval.rcut2) & (r2 > 0) & ok).sum())
    return int(cand), inside


def pair_flops(ev, pair: str, energy: bool) -> tuple:
    """(flops, scalar outputs) of one pair inside the cutoff: the evaluator
    (Chebyshev: 4 for the transform and argument, 2 per output to start the
    recurrence, 2 + 2 per output for each further term, 3 for the
    derivative factor, 1 per derivative output; the -P spline: 6 for the
    interval (sqrt, 2 for the clip, product, difference, floor), then per
    table 2 for tmp = a r2 + b, 4 more for the value, 6 more for the
    derivative 2 ((3 tmp - b) r2 + c); LJ: 1 division, 3 for r6, 5 for
    the coefficient, 4 for the energy; the -I table: 6 for the index
    (sqrt, clamp, difference, product, floor, fraction), 2 for the two
    differences and 5 for the derivative, 2 for -de / r, 8 for the energy's
    value), the pair's coefficient (EAM pass 1: 1, pass 3: 3), 6 for the
    force sum and 1 per scalar sum.  A division or a sqrt counts as
    one."""
    from comd_tpu_torch.ops.cuda import stencil as st

    def cheb(wants, n_der):
        n_terms = st._cheb_params(ev, wants).n_terms
        n_out = len(wants)
        return 4 + 2 * n_out + (n_terms - 2) * (2 + 2 * n_out) + 3 + n_der

    def spline(wants):
        return 6 + sum(2 + (4 if k == "val" else 6) for _n, k in wants)

    evaluate = spline if ev.kind == "spline" else (lambda w: cheb(w, 1))
    if pair == "eam_pass1":
        wants = ([("phi", "val")] if energy else []) + \
            [("phi", "der"), ("rho", "val")]
        ns = len(wants) - 1
        return evaluate(wants) + 1 + 6 + ns, ns
    if pair == "eam_pass3":
        return evaluate([("rho", "der")]) + 3 + 6, 0
    ns = 1 if energy else 0
    if ev.kind == "lj_table":
        return 6 + 2 + 5 + 2 + 6 + (8 + 1 if energy else 0), ns
    return 1 + 3 + 5 + 6 + (4 if energy else 0), ns


def key_parts(key: str) -> tuple:
    """(half, pair) of a launch counter name: ``spline_`` variants and
    ``lj_table`` are the same sweeps with another pair function."""
    if key == "lj_table":
        return False, "lj"
    key = key[len("spline_"):] if key.startswith("spline_") else key
    half = key.startswith("half_")
    return half, key[5:] if half else key


def table_bytes(ev) -> int:
    """Bytes of the evaluator's tables (spline coefficients, -I table)."""
    return sum(t.numel() * t.element_size() for t in (ev.phi, ev.rho)
               if t is not None)


def bound(sim, key: str, energy: bool = False):
    """(bound_ms, bound_by, flops, candidate pairs) of one launch of
    ``key`` on sim's state: the bound is the larger of flops / f32 peak and
    bytes / HBM rate.

    Flops: 8 per candidate pair (3 differences, 3 products, 2 sums for r2)
    plus, per pair inside the cutoff, ``pair_flops`` and, half shell,
    3 + 1 per scalar for the j side.  Bytes: positions, neighbor map and
    dfEmbed read once, the outputs written once."""
    half, pair = key_parts(key)
    ev, r = sim.pair_eval, sim.state.r
    B, A = r.shape[1], r.shape[2]
    n_local = sim.geom.n_local
    esize = r.element_size()
    per, ns = pair_flops(ev, pair, energy)
    if half:
        per += 3 + ns
    cand, inside = pair_work(sim, half)
    flops = 8 * cand + per * inside
    n_nbr = 14 if half else 27
    nbytes = (3 * B * A * esize + n_local * n_nbr * 4
              + (B * A * esize if pair == "eam_pass3" else 0)
              + (3 + ns) * (B if half else n_local) * A * esize
              + table_bytes(ev))
    t_ops, t_bytes = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, cand)


def kernel_row(sim, key: str, launches: dict, err: float, ms: float,
               plain_ms: float) -> dict:
    """The kernels-line entry of launch counter ``key``, timed on sim's
    state (pass 1 and LJ without energy, as 99 of 100 steps run them), and
    its [timing] line: time a candidate pair (occupied i-slot x occupied
    j-slot), the needed-flop rate, and the launch shape (brick, threads,
    shared memory, resident blocks an SM, list capacity)."""
    from comd_tpu_torch.ops.cuda import stencil as st
    half, pair = key_parts(key)
    b_ms, b_by, flops, cand = bound(sim, key)
    nbr = sim.maps.half_nbr_map if half else sim.maps.nbr_map
    shp = st.launch_shape(pair, half, sim.state.r, nbr, sim.pair_eval)
    say("timing", f"{key} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}); {1e9 * ms / cand:.3f} ps a "
        f"candidate pair ({cand:,}), {flops / ms / 1e9:.3f} TFLOP/s "
        f"needed; brick {shp['brick']} x {shp['bricks']}, "
        f"{shp['threads']} threads, {shp['smem_bytes']} B shared, "
        f"{shp['blocks_per_sm']} blocks/SM, list {shp['list_cap']}")
    if half:
        tiles = sim.geom.n_local * 14
        say("timing", f"{key} j-side flushes: {shp['region_boxes']:,} "
            f"staged region boxes against {tiles:,} (cell, column) tiles "
            f"of the tile-flush design, {tiles / shp['region_boxes']:.2f}x "
            f"fewer global atomics at most")
    return {"name": key if half else f"stencil_{key}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES["half" if half
                                                   else "stencil"],
            "launches": launches[key], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def half_vs_full(sim) -> float:
    """max |f_K2 - f_K1| of the EAM force on sim's state (f32: the two
    differ by summation order only)."""
    import torch
    from comd_tpu_torch.ops import binning, force_eam
    s = sim.state
    f_half, _u, _e = sim.force(s.r, s.n_atoms, want_energy=False)
    f_full, _u, _d = force_eam.eam_force(
        sim.maps.nbr_map, s.r[None], sim.pair_eval, sim.f_eval,
        lambda xs, _rhobar: torch.stack([binning.fill_halo_scalar_serial(
            sim.geom, sim.maps, x) for x in xs]),
        n_atoms=s.n_atoms[None], want_energy=False)
    return float((f_half - f_full[0]).abs().max())


def check_comm(sim, tag: str) -> dict:
    """The halo kernels against their plain versions on sim's shards (CUDA
    tensors), bitwise: the whole dfEmbed fill in one launch under ki (plane
    copies) and ki_fused (the x stage from F'(rhobar)), on a field whose
    local rows pass 2 filled and whose halo rows hold -1; K4 alone
    (pass2_push, both x pushes), its local planes equal to pass 2's F' at
    the same rows; the atom stage push of every stage.  Returns ({kernels
    line key: max abs error}, (dfEmbed, rhobar))."""
    import torch
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.parallel import ki_comm
    h, states = sim.halo, sim.states
    nbr, ev, nl = sim.maps.nbr_map, sim.pair_eval, sim.geom.n_local
    rhobar = [st.eam_pass1(s.r, nbr, ev, want_energy=False)[2]
              for s in states]
    dfe = []
    for s, rho in zip(states, rhobar):
        d = torch.full(s.gid.shape, -1.0, dtype=s.r.dtype, device=s.r.device)
        d[:rho.shape[0]] = sim.f_eval(rho)[1]
        dfe.append(d)

    def diff(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    err = {}
    plan = ki_comm.fill_plan(h, dfe[0])
    for key, extra in (("halo_fill", ()),
                       ("halo_fill_fused", (rhobar, sim.f_eval))):
        a = cm.halo_fill(plan, [d.clone() for d in dfe], *extra)
        b = cm.halo_fill_plain(plan, [d.clone() for d in dfe], *extra)
        torch.cuda.synchronize()
        err[key] = diff(a, b)
        check(same(a, b), f"{tag}: {key} differs from its plain version: "
              f"|diff| {err[key]:.3e}")
        check(all(bool((v[nl:] != -1.0).all()) for v in a),
              f"{tag}: {key} left halo rows unwritten")
    (s_m, s_p), (r_m, r_p) = h.force_send[0], h.force_recv[0]
    for to, send, recv in ((h.minus[0], s_m, r_p), (h.plus[0], s_p, r_m)):
        a = [d.clone() for d in dfe]
        b = [d.clone() for d in dfe]
        loc_k = cm.pass2_push(rhobar, a, to, send, recv, sim.f_eval)
        loc_p = cm.pass2_push_plain(rhobar, b, to, send, recv, sim.f_eval)
        ref = [sim.f_eval(rho)[1][send] for rho in rhobar]
        torch.cuda.synchronize()
        e = max(diff(loc_k, ref), diff(a, b))
        err["halo_fill_fused"] = max(err["halo_fill_fused"], e)
        check(same(loc_k, ref) and same(loc_p, ref) and same(a, b),
              f"{tag}: K4 (pass2_push) against pass 2's F': |diff| {e:.3e}")
    fields = [[s.r for s in states], [s.p for s in states],
              [s.gid for s in states], [s.n_atoms for s in states]]
    err["ring_push"] = 0.0
    for axis in range(3):
        aplan = ki_comm.atom_plan(h, axis, fields)
        got = cm.ring_push(aplan, fields)
        want = cm.ring_push_plain(aplan, fields)
        torch.cuda.synchronize()
        err["ring_push"] = max(err["ring_push"], diff(got, want))
        check(same(got, want), f"{tag}: ring_push, stage {axis}: |diff| "
              f"{err['ring_push']:.3e}")
    widths = [f.vec_bytes for f in aplan.fields]
    say("comm", f"{tag}: halo_fill (ki, ki_fused: one launch a fill) "
        f"bitwise; K4 alone (pass2_push) bitwise on both x pushes; "
        f"ring_push bitwise on the 3 atom stages (field moves {widths} "
        f"bytes)")
    return err, (dfe, rhobar)


def stage_row(sim, x, rhobar, table_bytes: int) -> dict:
    """The kernels-line row of halo_fill_stage, one stage of a fill across
    processes, at phase 12's 63^3 state: process 0 of 2's x stage (F' on
    the sender, as ki_fused pushes it: rows for its own shards into their
    fields, for process 1's shards into receive planes, here local scratch
    buffers on the card) against its plain version, bitwise, and timed
    beside it.  Its launches are filled in by phase 17."""
    import types
    import torch
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.parallel import exchange, ki_comm
    from comd_tpu_torch.parallel.mesh import make_mesh
    from comd_tpu_torch.probes import time_ms
    m2 = make_mesh(2, 2, 2, sim.device, nprocs=2, proc=0)
    h2 = exchange.make_halo(m2, sim.geom, sim.maps, sim.plan, sim.dtype)
    dev = x[0].device
    link = types.SimpleNamespace(
        sizes=ki_comm.arena_layout(h2, x[0].shape[1], x[0].dtype)[1],
        arena=None, inbox=lambda *a: None,
        outbox=lambda kind, axis, q, n: torch.zeros(n, dtype=torch.uint8,
                                                    device=dev))
    stg = ki_comm._fill_stage(h2, link, 0, x[0])
    plan = stg.plan
    xs = [x[s].clone() for s in m2.owned]
    rs = [rhobar[s] for s in m2.owned]
    got = cm.halo_fill(plan, [v.clone() for v in xs], rs, sim.f_eval)
    planes = [p.clone() for p in plan.planes]
    want = cm.halo_fill_plain(plan, [v.clone() for v in xs], rs, sim.f_eval)
    torch.cuda.synchronize()
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got + planes, want + plan.planes))
    check(err == 0.0 and len(planes) == 8,
          f"halo_fill_stage: {len(planes)} planes, |diff| {err:.3e} to its "
          f"plain version")
    fn = (lambda: cm.halo_fill(plan, xs, rs, sim.f_eval))
    ms = time_ms(fn, 20)
    plain_ms = time_ms(lambda: cm.halo_fill_plain(plan, xs, rs, sim.f_eval),
                       20)
    host, dev_ms = host_and_device_ms(fn, kernels_per_call=1)
    b_ms, b_by = fill_bound(plan, table_bytes)
    say("timing", f"halo_fill_stage, the fused x stage of process 0 of 2 "
        f"({plan.n_shards} shards, {len(planes)} receive planes of "
        f"{plan.n_rows[0]} rows, local scratch here): bitwise to its plain "
        f"version; {ms:.4f} ms (CUDA events, mean of 20); host {host:.4f} "
        f"ms a call, device {dev_ms:.5f} ms (torch.profiler); plain "
        f"{plain_ms:.4f} ms; bound {b_ms:.6f} ms ({b_by})")
    return {"name": "halo_fill_stage", "route": "cuda",
            "source": COMM_SOURCE, "replaces": REPLACES["halo_fill_fused"],
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def fill_library(plan, x) -> tuple:
    """K3's dfEmbed fill (``ki``) as one PyTorch call: a static row copy,
    so one ``index_select`` of the shards' fields stacked [S * B, A] on
    one composed row index (every row its own source, a halo row the row
    its three stages finally copy into it: the plain fill run on a field
    of row ids) computes the filled field.  The stack is layout and not
    timed.  Returns (ms of the call, CUDA events, mean of 20; max |diff|
    against ``halo_fill`` on the same field)."""
    import torch
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.probes import time_ms
    S, (B, A) = len(x), x[0].shape
    dev = x[0].device
    rows = torch.arange(B, device=dev, dtype=torch.float32)[:, None]
    ids = [(rows + s * B).expand(B, A).contiguous() for s in range(S)]
    cm.halo_fill_plain(plan, ids)
    index = torch.cat([i[:, 0] for i in ids]).long()
    stacked = torch.stack(x).view(S * B, A)
    filled = cm.halo_fill(plan, [t.clone() for t in x])
    err = float((torch.index_select(stacked, 0, index).view(S, B, A)
                 - torch.stack(filled)).abs().max())
    ms = time_ms(lambda: torch.index_select(stacked, 0, index), 20)
    return ms, err


def fill_bound(plan, table_bytes: int = 0) -> tuple:
    """(bound_ms, "bytes") of one fill of ``plan``: every value of the
    three stages read once and written once (the fused x stage reads
    rhobar where the others read the field), the row lists and rings read
    once, the fused stage's table once."""
    esize, A, S = plan.dtype.itemsize, plan.shape[1], plan.n_shards
    nbytes = table_bytes
    for n, dirs in zip(plan.n_rows, plan.stages):
        nbytes += len(dirs) * (2 * S * n * A * esize + 2 * 4 * n + 4 * S)
    return 1e3 * nbytes / PEAK_BYTES, "bytes"


def push_bound(plan) -> tuple:
    """(bound_ms, "bytes") of one atom stage push of ``plan``: every field
    value of the sent rows read once and written once, the row lists and
    rings read once."""
    S, n = plan.n_shards, plan.n_rows
    nbytes = len(plan.dirs) * (4 * n + 4 * S)
    for f in plan.fields:
        nbytes += 2 * len(plan.dirs) * S * n * f.planes * f.row_vecs * \
            f.vec_bytes
    return 1e3 * nbytes / PEAK_BYTES, "bytes"


def host_and_device_ms(fn, reps: int = 20, kernels_per_call: int = None
                       ) -> tuple:
    """(host ms, device ms) of one call of fn: the host's wall clock a call
    over ``reps`` calls (the device runs behind), and the device's kernel
    time a call under torch.profiler (the sum of its kernels' durations).

    torch.profiler at times keeps fewer kernel records than were launched
    (on an H100: 8 of 20), which makes that sum short.  Given
    ``kernels_per_call``, the device time is that many times the mean
    duration of the records kept, profiled again (eight times at most)
    while fewer than the launches come back."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / reps
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "Loading" not in e.key]
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in kernels)
        if kernels_per_call is None:
            return host, us / 1e3 / reps
        n = sum(e.count for e in kernels)
        if n >= kernels_per_call * reps:
            break
    if n == 0:
        raise RuntimeError("torch.profiler kept no kernel record in eight "
                           "runs")
    return host, kernels_per_call * us / n / 1e3


def window_bound(sp, n_cols: int, row_len: int, n_close: int) -> tuple:
    """(bound_ms, bound_by, flops) of one window_pair launch of probe spec
    ``sp`` over ``n_cols`` columns of an rp with ``row_len`` lanes, whose
    data put ``n_close`` candidate pairs inside the cutoff.

    Flops, as ``bound()`` counts K1's (an FMA as 2, a division or
    reciprocal as 1, compares, selects, clip and conversions as 0): 8 per
    candidate pair for r2 (3 differences, 3 products, 2 sums), then per
    pair inside the cutoff what the sums need of it: P1 4 (reciprocal, the
    force product and sum, the r2 sum); LJ 13 (reciprocal, r6 2, the
    coefficient 4, the energy 2, the force product and sum 2, 2 sums);
    Clenshaw 2 for t2, 3 (N - 2) + 4 for a chain of N coefficients, 1 for
    -2 dphi, 2 for the force and 2 sums.  The kernel evaluates every
    candidate pair branch-free; the terms outside the cutoff are zeros the
    function does not need, so they are not counted.  Bytes: rp read once,
    the outputs written once."""
    from comd_tpu_torch.probes import window
    A = window.SLOTS
    if sp.physics == "inv_r2":
        per = 4
    elif sp.physics == "lj":
        per = 13
    else:
        per = 2 + sum(3 * (len(c) - 2) + 4
                      for c in (sp.phi, sp.dphi, sp.rho)) + 1 + 2 + 2
    flops = 8 * window.n_pairs(sp, n_cols) + per * n_close
    nbytes = 4 * (3 * A * row_len + sp.n_out * A * n_cols)
    t_ops, t_bytes = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops)


def lookup_bound(x, tab, flops_per_value: int) -> tuple:
    """(bound_ms, bound_by) of one lookup launch: x read and the output
    written once, the table read once; flops per value from the kernel
    (P4 8: u, 3 adds, 2 products, the scale and the add to x; P5 4)."""
    nbytes = 4 * (2 * x.numel() + tab.numel())
    t_ops = 1e3 * flops_per_value * x.numel() / PEAK_F32_FLOPS
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def run_probes(k1_pass1: tuple) -> dict:
    """Phase 13: the probe commands P1-P6 with the launch counts zeroed
    just before and read just after; then each kernel against its plain
    version at the probes' own shapes and, for window_pair, on a dense
    input whose lists drain many times (every element within 1e-5 of its
    own scale, the sum of its terms' magnitudes, and every output within
    1e-5 of its largest value, all finite, two launches the same bits; the
    lookups bit for bit at scale 1e-12 and 1, on the probes' tables and on
    tables whose columns differ); times (CUDA events, the host's time a
    call, the device's under torch.profiler, a mean over the kernel
    records it keeps) beside plain versions and
    bounds, with window_pair's launch plan; P3's physics at 72 chunks
    beside K1's pass 1 (``k1_pass1``: ms, slot pairs, occupied candidate
    pairs, flops the function needs), with the kernel's list lengths.
    Returns the three kernels-line rows."""
    import numpy as np
    import torch
    from comd_tpu_torch.ops.cuda import probe as pr
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.probes import lookup, time_ms, window
    st.reset_launch_counts()
    for argv in (["1"], ["2"], ["3"], ["3", "--lj"]):
        window.main(argv)
    for probe in ("4", "5", "6"):
        lookup.main([probe])
    launches = {k: st.LAUNCHES[k] for k in PROBE_KEYS}
    for k, n in launches.items():
        check(n > 0, f"probes: {k} launched {n} times by the commands")
    say("probes", f"launches in the probe commands' run: {launches}")

    timed, lists = {}, {}
    dense = np.random.RandomState(5)
    for sp, chunks, span in ((window.P1, None, None),
                             (window.P2, None, None),
                             (window.P3, None, None),
                             (window.P3_LJ, None, None),
                             (window.P3, 72, None), (window.P3_LJ, 72, None),
                             (window.P3, None, 10.0)):
        probe = int(sp.name[1])
        rp = window.make_inputs(probe, chunks)
        if span is not None:     # most pairs inside the cutoff
            rp = dense.uniform(0, span, rp.shape).astype(np.float32)
        rp = torch.from_numpy(rp).cuda()
        got = window.window_pair(rp, sp)
        again = window.window_pair(rp, sp)
        want = window.window_pair_plain(rp, sp)
        scale = window.window_pair_magnitude(rp, sp)
        n_close = window.n_in_cutoff(rp, sp)
        n_cols = got[0].shape[1]
        tag = f"{sp.name} {n_cols // window.CHUNK} chunks" + (
            f" dense (span {span:g})" if span is not None else "")
        check(all(bool(torch.isfinite(t).all()) for t in got + want),
              f"window_pair {tag}: non-finite sums")
        rel = max(norm_rel(a, b) for a, b in zip(got, want))
        elem = window.element_error(got, want, scale)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(rel <= 1e-5 and elem <= 1e-5,
              f"window_pair {tag}: max|a-b|/max|b| {rel:.3e}, max|a-b|/S "
              f"{elem:.3e}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"window_pair {tag}: two launches differ")
        plan = pr.card_window_plan(rp.device.index, sp, rp.shape[1],
                                   rp.shape[2], n_cols)
        if chunks == 72 and sp is window.P3:
            # entries a lane lists over its walk (its column's i-slot,
            # over its offset group); P3 LJ has the same positions
            per = window.in_cutoff_counts(rp, sp).split(plan.group)
            per = torch.stack([c.sum(0) for c in per]).float()
            lists = {"mean": float(per.mean()), "max": int(per.max())}
        del got, again, want, scale
        ms = time_ms(lambda: window.window_pair(rp, sp), 20)
        host, dev = host_and_device_ms(lambda: window.window_pair(rp, sp),
                                       kernels_per_call=1)
        plain_ms = time_ms(lambda: window.window_pair_plain(rp, sp), 2)
        b_ms, b_by, flops = window_bound(sp, n_cols, rp.shape[2], n_close)
        pairs = window.n_pairs(sp, n_cols)
        occ = pr.occupancy(rp.device.index, "window_pair", plan.threads,
                           physics=plan.physics, counts=plan.counts)
        say("timing", f"window_pair {tag} ({pairs:,} pairs, {n_close:,} "
            f"inside the cutoff): kernel {ms:.4f} ms (CUDA events), host "
            f"{host:.4f} ms a call, device {dev:.4f} ms (torch.profiler); "
            f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
            f"{1e9 * dev / pairs:.3f} ps a pair on the device, "
            f"{flops / dev / 1e9:.3f} TFLOP/s needed; max|a-b|/S "
            f"{elem:.2e}, max|a-b|/max|b| {rel:.2e}, two launches the same "
            f"bits; plan: {plan.n_groups} offset groups of {plan.group}, "
            f"{plan.cols_per_block} columns a block, {plan.threads} "
            f"threads, {plan.blocks} blocks, {occ.smem_bytes} B shared, "
            f"{occ.blocks_per_sm} blocks/SM")
        timed[tag] = (err, ms, plain_ms, b_ms, b_by, pairs, flops, host, dev)
        del rp
    k1_ms, k1_slots, k1_cand, k1_flops = k1_pass1
    for name in ("P3", "P3 LJ"):
        _e, ms, _p, _b, _by, pairs, flops, _h, dev = \
            timed[f"{name} 72 chunks"]
        say("probes", f"{name} at 72 chunks: {pairs:,} candidate pairs in "
            f"{ms:.4f} ms = {1e9 * ms / pairs:.3f} ps a pair (device "
            f"{dev:.4f} ms, {1e9 * dev / pairs:.3f} ps), "
            f"{flops / ms / 1e9:.3f} TFLOP/s needed; a lane lists "
            f"{lists['mean']:.2f} pairs over its walk, at most "
            f"{lists['max']}; K1 EAM pass 1 (phase 5): {k1_slots:,} slot "
            f"pairs ({k1_cand:,} occupied) in {k1_ms:.4f} ms = "
            f"{1e9 * k1_ms / k1_slots:.3f} ({1e9 * k1_ms / k1_cand:.3f}) ps "
            f"a pair, {k1_flops / k1_ms / 1e9:.3f} TFLOP/s needed")

    rng = np.random.default_rng(7)
    x4, t4 = (torch.from_numpy(a).cuda() for a in lookup.make_inputs(4))
    x5, t5 = (torch.from_numpy(a).cuda() for a in lookup.make_inputs(5))
    other4 = torch.from_numpy(rng.normal(size=tuple(t4.shape)).astype(
        np.float32)).cuda()
    other5 = torch.from_numpy(rng.normal(size=tuple(t5.shape)).astype(
        np.float32)).cuda()
    for scale in (lookup.SCALE, 1.0):
        for tab in (t4, other4):
            check(torch.equal(lookup.row_lookup(x4, tab, scale),
                              lookup.row_lookup_plain(x4, tab, scale)),
                  f"row_lookup differs from its plain version (scale "
                  f"{scale})")
        for tab in (t5, other5):
            got = lookup.lane_lookup(x5, tab, scale)
            check(torch.equal(got, lookup.lane_lookup_plain(x5, tab, scale))
                  and torch.equal(lookup.onehot_lookup(x5, tab, scale), got),
                  f"lane_lookup differs from its plain version (scale "
                  f"{scale})")
    say("probes", "row_lookup (P4) and lane_lookup (P5 = P6) bit for bit "
        "against their plain versions at scale 1e-12 and 1, on the probes' "
        "tables and on tables whose columns differ")

    e, ms, plain_ms, b_ms, b_by, _pairs, _fl, host, dev = timed[
        "P3 8 chunks"]
    rows = {"window_pair": (e, ms, plain_ms, b_ms, b_by, host, dev)}
    for key, fn, plain, x, tab, per in (
            ("row_lookup", lookup.row_lookup, lookup.row_lookup_plain, x4, t4,
             8),
            ("lane_lookup", lookup.lane_lookup, lookup.lane_lookup_plain, x5,
             t5, 4)):
        ms = time_ms(lambda: fn(x, tab), 20)
        host, dev = host_and_device_ms(lambda: fn(x, tab),
                                       kernels_per_call=1)
        plain_ms = time_ms(lambda: plain(x, tab), 20)
        b_ms, b_by = lookup_bound(x, tab, per)
        say("timing", f"{key} {x.numel():,} lookups: kernel {ms:.4f} ms "
            f"(CUDA events), host {host:.4f} ms a call, device {dev:.4f} ms "
            f"(torch.profiler); plain {plain_ms:.4f} ms; bound {b_ms:.4f} "
            f"ms ({b_by}), device at {b_ms / dev:.1%} of it; "
            f"{x.numel() / dev / 1e6:.2f} G lookups/s, "
            f"{8 * x.numel() / dev / 1e9:.3f} TB/s of x and out on the "
            f"device")
        rows[key] = (0.0, ms, plain_ms, b_ms, b_by, host, dev)
    # the library calls of the lookups' table reads, at the rows the
    # lookups compute (not timed): P4's rows by one torch.index_select,
    # P5/P6's lanes by one torch.gather; window_pair has none
    ii4 = lookup._row_and_frac(x4, t4.shape[0])[0].reshape(-1)
    ii5 = lookup._row_and_frac(x5, t5.shape[0])[0]
    library = {"window_pair": None,
               "row_lookup": time_ms(lambda: torch.index_select(t4, 0, ii4),
                                     20),
               "lane_lookup": time_ms(lambda: torch.gather(t5, 0, ii5), 20)}
    say("timing", f"library calls of the lookups' table reads: row_lookup "
        f"(P4) torch.index_select of {ii4.numel():,} rows "
        f"{library['row_lookup']:.4f} ms, lane_lookup (P5 = P6) "
        f"torch.gather of {ii5.numel():,} lanes {library['lane_lookup']:.4f} "
        f"ms (CUDA events, mean of 20)")
    return {k: {"name": k, "route": "cuda", "source": PROBE_SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library[k], "host_ms": host, "device_ms": dev}
            for k, (e, ms, plain_ms, b_ms, b_by, host, dev) in rows.items()}


def run_main(tag: str, keys, n_blocks: int = 10, block: int = 10,
             on_init=None, **kw):
    """One main path at full width through the user entry points
    (init_simulation, step_block), launch counts zeroed just before and read
    just after.  ``on_init(sim)`` runs on the initial state, its launches
    taken out of the counts.  Checks atom count, overflow,
    |eFinal/eInitial - 1| < 1e-4 and that each kernel in ``keys`` launched at
    least once per step.  Returns (sim, launches in this run)."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import stencil as st
    n = HEADLINE_N
    cfg = Config(nx=n, ny=n, nz=n, temperature=600.0, dtype="float32",
                 max_atoms=0, cell_mode="auto", pot_dir=POTS, device="cuda",
                 **kw)
    st.reset_launch_counts()
    t0 = time.perf_counter()
    sim = init_simulation(cfg)
    t_init = time.perf_counter() - t0
    n = sim.n_global
    e0 = (sim.e_potential + sim.kinetic_energy()) / n
    at_init = dict(st.LAUNCHES)
    if on_init is not None:
        on_init(sim)
        st.LAUNCHES.update(at_init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ends = []
    for _ in range(n_blocks):
        sim.step_block(block)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    t_loop = ends[-1] - t0
    # the first blocks carry one-off costs (the graphs' captures, first
    # allocations): the median block beside the whole run
    per_block = sorted(b - a for a, b in zip([t0] + ends, ends))
    median_ms = 1e3 * per_block[len(per_block) // 2] / block
    launches = dict(st.LAUNCHES)
    n_steps = n_blocks * block
    e1 = (sim.e_potential + sim.kinetic_energy()) / n
    n_atoms = sim.sum_atoms()
    check(n_atoms == n, f"{tag}: atoms lost: {n_atoms} of {n}")
    check(not sim.overflow, f"{tag}: capacity overflow")
    check(abs(e1 / e0 - 1.0) < 1e-4, f"{tag}: eFinal/eInitial {e1 / e0!r}")
    for k in keys:
        check(launches[k] - at_init[k] >= n_steps,
              f"{tag}: {k} launched {launches[k] - at_init[k]} times in "
              f"{n_steps} steps")
    ms_step = 1e3 * t_loop / n_steps
    sim.ms_step = ms_step
    say(tag, f"{HEADLINE_N}^3 n={n} A={sim.cfg.max_atoms} "
        f"grid={sim.geom.grid} "
        f"mode={sim.cfg.cell_mode} skin={sim.skin:.4f} "
        f"rebuckets={sim.n_rebucket} init {t_init:.2f} s; "
        f"{n_steps} steps {ms_step:.3f} ms/step (median block "
        f"{median_ms:.3f}, slowest {1e3 * per_block[-1]:.1f} ms) "
        f"{n * n_steps / t_loop:.4e} atom-steps/s; eInitial {e0:.12f} "
        f"eFinal {e1:.12f} ratio-1 {e1 / e0 - 1.0:.3e}; launches "
        f"{ {k: launches[k] for k in keys} }")
    return sim, launches


def golden(tag: str, value: float, **kw) -> None:
    from comd_tpu_torch import Config, init_simulation
    sim = init_simulation(Config(temperature=0.0, initial_delta=0.0,
                                 dtype="float64", pot_dir=POTS,
                                 device="cuda", **kw))
    e_atom = sim.e_potential / sim.n_global
    check(abs(e_atom - value) < 1e-9, f"golden {tag} {e_atom!r} vs {value}")
    say("golden", f"{tag} A={sim.cfg.max_atoms} grid={sim.geom.grid} f64: "
        f"{e_atom:.12f} eV/atom (|diff| {abs(e_atom - value):.2e})")


def nl_lists_and_rows(sim):
    """The atom rows of a rebuild on a serial NL run's state: (rows
    (a_list, a_valid, row_start), build params)."""
    from comd_tpu_torch.ops import neighborlist as nlmod
    s = sim.state
    params = sim.nl_build_params()
    rows = nlmod.nl_rows_plain(sim.geom, s.n_atoms, s.r.shape[2],
                               params["n_rows"], params["row_split"])
    return rows, params


def nl_calls(sim, lst=None):
    """{name: (kernel call, plain call, pair, energy)} of NL1 and every NL2
    variant on a serial NL run's state (NL2 on ``lst``, default the run's
    current list; EAM pass 3 on the dfEmbed of the plain pass 1)."""
    from comd_tpu_torch.ops import binning
    from comd_tpu_torch.ops import neighborlist as nlmod
    from comd_tpu_torch.ops.cuda import nl as nlk
    s, ev = sim.state, sim.pair_eval
    lst = sim.nlist if lst is None else lst
    (a_list, a_valid, start), p = nl_lists_and_rows(sim)
    args = (s.r, a_list, a_valid, sim.maps.nbr_map, s.n_atoms)
    kw = dict(k=p["k"], rcut2=p["rcut2"])
    calls = {"nl_build": (lambda: nlk.nl_build(*args, row_start=start,
                                               **kw),
                          lambda: nlk.nl_build_plain(*args, **kw), None,
                          False)}
    if not sim.is_eam:
        for e in (True, False):
            calls[f"lj {e}"] = (
                lambda e=e: nlk.lj_pass(lst, s.r, ev, want_energy=e),
                lambda e=e: nlk.lj_pass_plain(lst, s.r, ev, want_energy=e),
                "lj", e)
        return calls
    _f, _phi, rho = nlk.eam_pass1_plain(lst, s.r, ev)
    dfe = nlmod.scatter_rows(lst, sim.f_eval(rho)[1], *s.r.shape[1:])
    binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
    for e in (True, False):
        calls[f"pass1 {e}"] = (
            lambda e=e: nlk.eam_pass1(lst, s.r, ev, want_energy=e),
            lambda e=e: nlk.eam_pass1_plain(lst, s.r, ev, want_energy=e),
            "eam_pass1", e)
    calls["pass3"] = (lambda: (nlk.eam_pass3(lst, s.r, ev, dfe),),
                      lambda: (nlk.eam_pass3_plain(lst, s.r, ev, dfe),),
                      "eam_pass3", False)
    return calls


def compare_nl(sim, tag: str, f_atol: float, s_rtol: float,
               f_rtol: float = 0.0, more_lists: bool = False) -> dict:
    """NL1 (lists, counts, overflow bit for bit; again with K = 8, which
    must overflow, and with the -a 1 row split) and NL2 (forces within
    f_atol + f_rtol max|f|, scalars within s_rtol of their largest value;
    two launches the same bits) against their plain versions on sim's
    state: NL2 on the run's list and, with ``more_lists``, also on the
    K = 8 list (no row has padding: the early stop's edge) and on the
    split list.  Returns {kernel: max abs err} (forces for NL2)."""
    import torch
    from comd_tpu_torch.ops import neighborlist as nlmod
    from comd_tpu_torch.ops.cuda import nl as nlk
    calls = nl_calls(sim)
    kern, plain, _p, _e = calls.pop("nl_build")
    got, want = kern(), plain()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    s = sim.state
    rows, p = nl_lists_and_rows(sim)
    a_valid = rows[1]
    A = s.r.shape[2]
    row_split = nlmod.row_split_for(sim.geom, A)
    rows_split = nlmod.nl_rows_plain(sim.geom, s.n_atoms, A,
                                     row_split[1] + row_split[2], row_split)
    built = {}
    for name, (al, av, start), k in (("K = 8", rows, 8),
                                     ("split", rows_split, p["k"])):
        args = (s.r, al, av, sim.maps.nbr_map, s.n_atoms)
        kw = dict(k=k, rcut2=p["rcut2"])
        built[name] = ([nlk.nl_build(*args, row_start=start, **kw),
                        nlk.nl_build_plain(*args, **kw)], al, av, start)
    same_more = {n: all(torch.equal(g, w) for g, w in zip(*b[0]))
                 for n, b in built.items()}
    small = built["K = 8"][0][0]
    check(same and not bool(got[2]) and all(same_more.values())
          and bool(small[2]) and not bool(built["split"][0][0][2]),
          f"{tag} NL1: lists equal {same} ({same_more}), overflow "
          f"{bool(got[2])} (K = 8: {bool(small[2])}, split: "
          f"{bool(built['split'][0][0][2])})")
    mean = float(got[1][a_valid].float().mean())
    errs = {"nl_build": 0.0, "nl_sweep": 0.0}
    lists = {"": sim.nlist}
    if more_lists:
        for name, ((_k, (nl, count, _o)), al, av, start) in \
                built.items():
            lists[name] = nlmod.NeighborList(a_list=al, a_valid=av, nl=nl,
                                             last_r=s.r, row_start=start)
        k8 = built["K = 8"][0][1][1]
        check(bool((k8[a_valid] > 8).all()), f"{tag}: a K = 8 row has "
              f"padding")
    for list_name, lst in lists.items():
        for name, (kern, plain, _pair, _energy) in nl_calls(sim,
                                                            lst).items():
            if name == "nl_build":
                continue
            got, want = kern(), plain()
            torch.cuda.synchronize()
            e_f = float((got[0] - want[0]).abs().max())
            fmax = float(want[0].abs().max())
            e_s = max([norm_rel(g, w) for g, w in zip(got[1:], want[1:])
                       if w is not None], default=0.0)
            again = kern()
            bits = all(a is b or torch.equal(a, b)
                       for a, b in zip(got, again))
            check(e_f <= f_atol + f_rtol * fmax and e_s <= s_rtol and bits,
                  f"{tag} NL2 {name} {list_name}: force err {e_f:.3e} "
                  f"(|f|max {fmax:.3e}), scalar err {e_s:.3e}, same bits "
                  f"twice {bits}")
            errs["nl_sweep"] = max(errs["nl_sweep"], e_f)
    names = [n for n in calls]
    say("nl", f"{tag}: NL1 lists, counts and overflow equal (also K = 8, "
        f"overflowing, and the row split), {mean:.1f} entries a row (K "
        f"{p['k']}); NL2 {', '.join(names)} on the run's list"
        + (" and the K = 8 and split lists" if more_lists else "")
        + f" |df|max {errs['nl_sweep']:.3e}, two launches the same bits")
    return errs


def nl_bound(sim, name: str, pair, energy: bool) -> dict:
    """The bound of one NL1 or NL2 launch on a serial NL run's state, the
    larger of bytes / HBM rate and flops / f32 peak: {"ms", "by"} and the
    work counted.  NL1: positions, rows, neighbor map and occupancy read
    once, the [R, K] list and the counts written once; 8 flops a candidate
    tested (the occupied slots of each real row's 27 boxes).  NL2:
    positions, rows, the real rows' list entries up to each row's end
    (min(count, K) a row) and dfEmbed read once, [3 + ns, R] written once;
    8 flops a real entry, plus ``pair_flops`` a pair inside the cutoff.
    ``all_k_ms``: NL2's bound counting every entry of a real row as read
    and tested (n_real K), the count of the earlier records, so that their
    shares stay comparable."""
    import torch
    s, lst = sim.state, sim.nlist
    r = s.r
    B, A = r.shape[1], r.shape[2]
    e = r.element_size()
    R, K = lst.nl.shape
    n_real = int(lst.a_valid.sum())

    def ms(flops, nbytes):
        t_ops = 1e3 * flops / PEAK_F32_FLOPS
        t_bytes = 1e3 * nbytes / PEAK_BYTES
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    if name == "nl_build":
        nbr = sim.maps.nbr_map.to(torch.int64)
        occ = s.n_atoms.clamp(max=A).to(torch.int64)
        cand = int((occ[:nbr.shape[0]] * occ[nbr].sum(1)).sum())
        b_ms, b_by = ms(8 * cand, 3 * B * A * e + 5 * R + nbr.numel() * 4
                        + 4 * B + R * K * 4 + 4 * R)
        return {"ms": b_ms, "by": b_by, "candidates": cand}
    per, ns = pair_flops(sim.pair_eval, pair, energy)
    r_flat = r.reshape(3, -1)
    rc2 = sim.pair_eval.rcut2
    inside = entries = 0
    for c0 in range(0, R, 65536):
        rows = lst.a_list[c0:c0 + 65536].to(torch.int64)
        nl = lst.nl[c0:c0 + 65536].to(torch.int64)
        valid = lst.a_valid[c0:c0 + 65536, None]
        d = r_flat[:, rows][:, :, None] - r_flat[:, nl]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inside += int(((r2 <= rc2) & (r2 > 0) & valid).sum())
        entries += int(((nl != rows[:, None]) & valid).sum())
    fixed = (3 * B * A * e + 5 * R
             + (B * A * e if pair == "eam_pass3" else 0) + (3 + ns) * R * e)
    b_ms, b_by = ms(8 * entries + per * inside, fixed + 4 * entries)
    all_k_ms, _by = ms(8 * n_real * K + per * inside,
                       fixed + 4 * n_real * K)
    return {"ms": b_ms, "by": b_by, "all_k_ms": all_k_ms, "entries": entries,
            "inside": inside, "flops": 8 * entries + per * inside}


ROWS_KEYS = ("nl_rows", "embed_rows", "land_rows")


def row_op_cases(sim) -> list:
    """The list paths' row ops on a serial EAM NL run's state and list, as
    (name, key, prep, run, bytes): ``prep()`` makes fresh copies of what
    a call writes, ``run(fn, ops)`` calls ``fn`` (the wrapper or its plain
    version) and returns what it wrote; bytes are what the call needs
    (each input read once, each output written once; rows of the list
    read only where valid).  ER (embed_rows) with and without energy, the
    serial fill and zero halo rows (a mesh's), the rows in one segment
    and in two (cut at the middle cell's first row, as the -a 1 split's
    two sweeps give them), on NL2's pass 1 of the state; LR (land_rows)
    of one pass (LJ) and two (EAM: pass 1 and pass 3 on ER's dfEmbed),
    with the kick and the count and without (f only), two segments too;
    NR (nl_rows) without and with the -a 1 row split (the boundary mask
    on the card)."""
    import torch
    from comd_tpu_torch.ops import neighborlist as nlmod
    from comd_tpu_torch.ops.cuda import nl as nlk
    from comd_tpu_torch.ops.cuda import step
    s, geom, maps, lst = sim.state, sim.geom, sim.maps, sim.nlist
    (B, A), n_loc = s.r.shape[1:], geom.n_local
    es = s.r.element_size()
    R = lst.a_list.shape[0]
    n_real = int(lst.a_valid.sum())
    f1, phi, rho = nlk.eam_pass1(lst, s.r, sim.pair_eval)
    dfe, _u = step.embed_rows(sim.f_eval, lst, s.n_atoms, (rho,), None,
                              n_loc, B, maps.halo_src)
    f3 = nlk.eam_pass3(lst, s.r, sim.pair_eval, dfe)
    cut = int(lst.row_start[n_loc // 2])
    e_dtype = sim.cfg.torch_energy_dtype
    ee = torch.finfo(e_dtype).bits // 8
    tab = sim.f_eval.table.numel() * es
    kick = sim._c(0.5 * sim.cfg.dt)

    def segs(x, two):
        return (x[..., :cut], x[..., cut:]) if two else (x,)

    cases = []
    for energy in (False, True):
        for halo in (maps.halo_src, None):
            for two in (False, True):
                args = (sim.f_eval, lst, s.n_atoms, segs(rho, two),
                        segs(phi, two) if energy else None, n_loc, B, halo,
                        e_dtype)
                nb = es * (n_real + B * A) + 4 * 2 * n_loc + tab + (
                    8 * (B - n_loc) if halo is not None else 0)
                if energy:
                    nb += es * n_real + R + ee * R
                cases.append((
                    f"embed_rows energy={energy} serial={halo is not None} "
                    f"segments={1 + two}", "embed_rows", lambda: (),
                    lambda fn, _o, a=args: fn(*a), nb))

    def land(parts, k):
        def run(fn, o):
            fn(o[0], o[1], lst, s.n_atoms, parts, o[2], n_loc, k)
            return o
        return (lambda: (s.f.clone(), s.p.clone(), s.n_local.clone()), run)

    for passes, k, two in ((2, kick, False), (2, kick, True), (1, kick, False),
                           (2, None, False), (1, None, False)):
        parts = (segs(f1, two), segs(f3, two))[:passes]
        nb = es * (3 * n_real * passes + 3 * B * A) + 4 * 2 * n_loc
        if k is not None:
            nb += es * 2 * 3 * B * A + 4
        cases.append((f"land_rows passes={passes} kick={k is not None} "
                      f"segments={1 + two}", "land_rows", *land(parts, k),
                      nb))
    p = sim.nl_build_params()
    is_b, ri, rb = nlmod.row_split_for(geom, A)
    split = (torch.as_tensor(is_b, device="cuda"), ri, rb)
    for rs in (None, split):
        rows = p["n_rows"] if rs is None else ri + rb
        cases.append((f"nl_rows split={rs is not None}", "nl_rows",
                      lambda: (),
                      lambda fn, _o, rs=rs: fn(geom, s.n_atoms, A,
                                               p["n_rows"], rs),
                      4 * 2 * n_loc + (n_loc if rs is not None else 0)
                      + 5 * rows))
    return cases


def _row_fns(key: str) -> tuple:
    """(wrapper, plain version) of a row op."""
    from comd_tpu_torch.ops import neighborlist as nlmod
    from comd_tpu_torch.ops.cuda import nl as nlk
    from comd_tpu_torch.ops.cuda import step
    mod = nlk if key == "nl_rows" else step
    return getattr(mod, key), getattr(nlmod, key + "_plain")


def check_row_ops(sim, tag: str) -> dict:
    """Phase 14's bitwise check of the row ops at one state: each case of
    ``row_op_cases`` through the kernel (one count) and through its plain
    version on the same CUDA tensors, every output equal bit for bit (and
    U's sum).  Returns {key: max |kernel - plain| (0)}."""
    import torch
    from comd_tpu_torch.ops.cuda import LAUNCHES
    errs = {k: 0.0 for k in ROWS_KEYS}
    names = []
    for name, key, prep, run, _b in row_op_cases(sim):
        kern, plain = _row_fns(key)
        n0 = LAUNCHES[key]
        got = run(kern, prep())
        check(LAUNCHES[key] == n0 + 1, f"{tag} {name}: "
              f"{LAUNCHES[key] - n0} counts, not one")
        want = run(plain, prep())
        for x, y in zip(got, want):
            check((x is None) == (y is None) and (
                x is None or (x.dtype == y.dtype and torch.equal(x, y))),
                  f"{tag} {name}: kernel and plain version differ")
            if x is not None and x.is_floating_point():
                errs[key] = max(errs[key], float((x - y).abs().max()))
                if x.dim() == 1:
                    check(float(x.sum()) == float(y.sum()),
                          f"{tag} {name}: U's sums differ")
        names.append(name)
    say("nl rows", f"{tag}: {', '.join(names)}: kernel and plain version "
        f"equal bit for bit")
    return errs


def row_form_cases(sim) -> list:
    """NR's and ER's launch forms on synthetic states beside the run's:
    1300 local cells (11 of NR's 128-cell tiles, the last partial) and
    100 (fewer than a tile), counts drawn from [-2, A + 5] (numpy seed),
    one cell emptied; NR at A = 32, 13 (16-lane segments) and 40 (a thread
    a slot), with and without the -a 1 split (a random boundary mask:
    boundary cells in every tile), a capacity a quarter of the slots, an
    interior capacity half its rows; ER on NR's plain lists at A = 32 (the
    vector form), 13 (the scalar form) and 30 (f32 scalar, f64 vector by
    a divide), with and without energy, the serial fill from random local
    sources and zero halo rows, rho and phi cut two rows into a cell's
    vector; each as (name, key, run) with ``run(fn)`` the outputs of the
    wrapper or the plain version ``fn``."""
    import types
    import numpy as np
    import torch
    from comd_tpu_torch.ops import neighborlist as nlmod
    f, tdt = sim.f_eval, sim.state.r.dtype
    hi = sim.pot.f.x0 + (sim.pot.f.n - 1) / sim.pot.f.inv_dx

    def pad(k):
        return max(128, -(-k // 128) * 128)

    def state(n_local, A, seed, split, factor=1.0, short=False):
        rng = np.random.default_rng(seed)
        n = rng.integers(-2, A + 6, size=n_local + 7).astype(np.int32)
        n[n_local // 3] = 0
        geom = types.SimpleNamespace(n_local=n_local)
        n_atoms = torch.from_numpy(n).cuda()
        if not split:
            return geom, n_atoms, None, pad(int(n_local * A * factor))
        is_b = rng.random(n_local) < 0.4
        ri = pad(int((~is_b).sum()) * A)
        if short:
            ri = max(1, int(np.clip(n[:n_local], 0, A)[~is_b].sum()) // 2)
        rs = (torch.from_numpy(is_b).cuda(), ri,
              pad(int(is_b.sum()) * A))
        return geom, n_atoms, rs, rs[1] + rs[2]

    cases = []
    for n_local, A, split, factor, short in (
            (1300, 32, False, 1.0, False), (1300, 32, True, 1.0, False),
            (1300, 32, False, 0.25, False), (1300, 32, True, 1.0, True),
            (1300, 13, True, 1.0, False), (100, 32, True, 1.0, False),
            (700, 40, True, 1.0, False), (700, 40, False, 0.25, False)):
        geom, n_atoms, rs, R = state(n_local, A, n_local + A, split, factor,
                                     short)
        cases.append((
            f"nl_rows {n_local} cells A={A} split={split} "
            f"capacity={'half interior' if short else factor}", "nl_rows",
            lambda fn, a=(geom, n_atoms, A, R, rs): fn(*a)))
    rng = np.random.default_rng(29)
    n_local, B = 1300, 1307
    for A in (32, 13, 30):
        for split in (False, True):
            geom, n_atoms, rs, R = state(n_local, A, 7 * A, split)
            a_list, a_valid, row_start = nlmod.nl_rows_plain(
                geom, n_atoms, A, R, rs)
            v = a_valid.cpu().numpy()
            rho = torch.as_tensor(np.where(v, rng.uniform(0, 1.1 * hi, R),
                                           0), dtype=tdt, device="cuda")
            phi = torch.as_tensor(np.where(v, rng.uniform(-1, 0.5, R), 0),
                                  dtype=tdt, device="cuda")
            occ = np.clip(n_atoms[:n_local].cpu().numpy(), 0, A)
            cut = int(row_start[int(np.flatnonzero(occ >= 4)[5])]) + 2
            halo = torch.as_tensor(rng.integers(0, n_local, B - n_local),
                                   dtype=torch.int64, device="cuda")
            lst = nlmod.NeighborList(
                a_list=a_list, a_valid=a_valid,
                nl=torch.zeros((R, 1), dtype=torch.int32, device="cuda"),
                last_r=torch.empty((3, B, A), dtype=tdt, device="cuda"),
                row_start=row_start)
            for energy in (False, True):
                for src in (halo, None):
                    segs = (rho[:cut], rho[cut:]), (phi[:cut], phi[cut:])
                    for two in (False, True):
                        r_s, p_s = segs if two else ((rho,), (phi,))
                        cases.append((
                            f"embed_rows A={A} split={split} energy="
                            f"{energy} serial={src is not None} segments="
                            f"{1 + two}", "embed_rows",
                            lambda fn, a=(f, lst, n_atoms, r_s,
                                          p_s if energy else None, n_local,
                                          B, src, sim.cfg.torch_energy_dtype):
                            fn(*a)))
    return cases


def check_row_forms(sim, tag: str) -> dict:
    """Phase 14's bitwise check of NR's and ER's forms on the synthetic
    states of ``row_form_cases`` (``sim`` gives F's table and the dtype):
    each case through the kernel twice (one count a call, the same bits)
    and through its plain version, every output equal bit for bit.
    Returns {key: max |kernel - plain| (0)}."""
    import torch
    from comd_tpu_torch.ops.cuda import LAUNCHES
    errs = {"nl_rows": 0.0, "embed_rows": 0.0}
    cases = row_form_cases(sim)
    for name, key, run in cases:
        kern, plain = _row_fns(key)
        n0 = LAUNCHES[key]
        got = [tuple(x.clone() if x is not None else None
                     for x in run(kern)) for _ in range(2)]
        check(LAUNCHES[key] == n0 + 2, f"{tag} {name}: "
              f"{LAUNCHES[key] - n0} counts in two calls, not two")
        want = run(plain)
        for out in got:
            for x, y in zip(out, want):
                check((x is None) == (y is None) and (
                    x is None or (x.dtype == y.dtype and torch.equal(x, y))),
                      f"{tag} {name}: kernel and plain version differ")
                if x is not None and x.is_floating_point():
                    errs[key] = max(errs[key], float((x - y).abs().max()))
    say("nl rows", f"{tag}: {len(cases)} synthetic cases of NR's tiles "
        f"(1300 and 100 cells; A = 32, 13, 40; split, short capacities) "
        f"and ER's vector and scalar forms (A = 32, 13, 30): kernel twice "
        f"and plain version equal bit for bit")
    return errs


def time_row_ops(sim, launches: dict, errs: dict) -> dict:
    """Each row-op case at the 63^3 NL state timed beside its byte bound
    (bytes / 3.35 TB/s): the device ms of a call replayed in a graph of
    20 (``graph_ms``, CUDA events; the wrapper's host time does not
    count), a call from the host (CUDA events, mean of 20) and the plain
    version's call (mean of 5).  Returns the kernels line's rows: the
    serial EAM step's calls (ER without energy, serial fill, one segment:
    99 steps of 100; LR of two passes with the kick; NR without the
    split)."""
    import torch
    from comd_tpu_torch.probes import time_ms
    rows = {}
    main = ("embed_rows energy=False serial=True segments=1",
            "land_rows passes=2 kick=True segments=1", "nl_rows split=False")
    for name, key, prep, run, nb in row_op_cases(sim):
        kern, plain = _row_fns(key)
        ops = prep()             # updated in place call after call
        ms = graph_ms(lambda: run(kern, ops))
        call_ms = time_ms(lambda: run(kern, ops), 20)
        plain_ms = time_ms(lambda: run(plain, ops), 5)
        b_ms = 1e3 * nb / PEAK_BYTES
        say("timing", f"{name} at {HEADLINE_N}^3 f32: {ms:.5f} ms a call "
            f"replayed in a graph of 20 (CUDA events), {call_ms:.4f} ms a "
            f"call from the host (mean of 20), plain {plain_ms:.4f} ms; "
            f"bound {b_ms:.5f} ms (bytes: {nb / 1e6:.2f} MB), "
            f"{100 * b_ms / ms:.1f}% of it; {launches[key]} counts in the "
            f"EAM NL main run")
        if name in main:
            rows[key] = {
                "name": key, "route": "cuda",
                "source": NL_SOURCE if key == "nl_rows" else STEP_SOURCE,
                "replaces": REPLACES[key], "launches": launches[key],
                "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None}
    n_clamped = sim.state.n_atoms[:sim.geom.n_local].clamp(
        0, sim.state.r.shape[2]).contiguous()
    cs_ms = graph_ms(lambda: torch.cumsum(n_clamped, 0, dtype=torch.int32))
    say("timing", f"torch.cumsum of the {n_clamped.numel():,} clamped "
        f"int32 counts (NR's scan stage alone, a yardstick): {cs_ms:.5f} ms "
        f"a call replayed in a graph of 20; nl_rows split=False "
        f"{rows['nl_rows']['ms']:.5f} ms scans, writes row_start and fills "
        f"the rows")
    say("timing", "row ops' library_ms none: no single PyTorch call "
        "interpolates F' and places it in the cell layout with the halo "
        "fill (ER), gathers a force by row_start with a kick and a count "
        "(LR), or scans and compacts the rows (NR; nonzero + cumsum are "
        "two calls and no row_start)")
    return rows


def check_final_bits(key: str, digest: str, e_pot: float) -> None:
    """A phase 14 list run ends on ``NL_FINAL_BITS[key]``."""
    want_digest, want_e = NL_FINAL_BITS[key]
    check(digest == want_digest and e_pot == want_e,
          f"{key}: final r sha256 {digest[:16]}.. and ePot {e_pot!r}, not "
          f"{want_digest[:16]}.. and {want_e!r}")
    say("nl bits", f"{key}: final r sha256 and ePot equal the torch row "
        f"ops' (commit 94cac40)")


def run_nl(serial_ms: float, lj_ms: float, k1_pass1: tuple) -> dict:
    """Phase 14: the Verlet-list kernels and paths; NL2's time a real list
    entry and a pair inside the cutoff beside K1's pass 1 (``k1_pass1``:
    ms, slot pairs, occupied candidate pairs, flops).  Returns the kernels
    line's nl_build and nl_sweep rows."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.probes import time_ms
    errs = {"nl_build": 0.0, "nl_sweep": 0.0}
    row_errs = {k: 0.0 for k in ROWS_KEYS}
    # NL1 and NL2 against their plain versions, thermalized 10^3; the row
    # ops against theirs on the EAM states
    for dtype, impl, f_atol, s_rtol, f_rtol in (
            ("float32", "cheb", 1e-4, 1e-5, 0.0),
            ("float64", "rows", 0.0, 1e-12, 1e-12)):
        for doeam in (True, False):
            sim = init_simulation(Config(
                nx=10, ny=10, nz=10, doeam=doeam, method="thread_atom_nl",
                temperature=600.0, dtype=dtype, interp_impl=impl,
                pot_dir=POTS, device="cuda"))
            sim.step_block(10)
            tag = f"10^3 {dtype}/{sim.pair_eval.kind} A={sim.cfg.max_atoms}"
            e = compare_nl(sim, tag, f_atol, s_rtol, f_rtol, more_lists=True)
            errs = {k: max(errs[k], e[k]) for k in errs}
            if doeam:
                e = check_row_ops(sim, tag)
                row_errs = {k: max(row_errs[k], e[k]) for k in row_errs}
                e = check_row_forms(sim, tag)
                row_errs = {k: max(row_errs[k], e.get(k, 0.0))
                            for k in row_errs}
            del sim
    golden("Adams Cu 6^3 T=0 -m thread_atom_nl", GOLDEN_EAM_ADAMS, nx=6,
           ny=6, nz=6, doeam=True, method="thread_atom_nl")

    # the 63^3 headlines: EAM -m thread_atom_nl and LJ -L
    rows, launched, timing, nl_epot, nl_final = {}, {}, {}, [], {}
    for tag, kw, ref_ms, ref in (
            ("nl main", dict(doeam=True, method="thread_atom_nl"), serial_ms,
             "phase 5"),
            ("nl LJ main", dict(use_pairlist=True), lj_ms, "phase 9")):
        sim, launches = run_main(
            tag, ("nl_sweep",),
            on_init=(lambda x: nl_epot.append(x.e_potential))
            if tag == "nl main" else None, **kw)
        steps = 100
        per_step = 2 if sim.is_eam else 1
        check(launches["nl_sweep"] == per_step * (steps + 1)
              and launches["nl_build"] == sim.n_nl_build >= 1,
              f"{tag}: nl_sweep {launches['nl_sweep']}, nl_build "
              f"{launches['nl_build']} for {sim.n_nl_build} builds")
        # the row ops: ER one a force, LR one a step and the initial
        # force's (no kick), NR one a build; no cell-path pass 2 or land
        got = {k: launches[k] for k in ROWS_KEYS + ("embed_fill", "land")}
        want = {"embed_rows": (steps + 1) if sim.is_eam else 0,
                "land_rows": steps + 1, "nl_rows": sim.n_nl_build,
                "embed_fill": 0, "land": 0}
        check(got == want, f"{tag}: row ops launched {got}, not {want}")
        digest = r_digest([sim.state.r.cpu().numpy()])
        say(tag, f"row ops {got} ({sim.n_nl_build} builds, {steps} steps "
            f"and the initial force); final r sha256 {digest[:16]}.., ePot "
            f"{sim.e_potential!r}")
        if tag in NL_FINAL_BITS:
            check_final_bits(tag, digest, sim.e_potential)
        say(tag, f"K {sim.nlist.nl.shape[1]}, rows {sim.nlist.nl.shape[0]:,}"
            f" ({int(sim.nlist.a_valid.sum()):,} atoms); {sim.n_nl_build} "
            f"builds (init and {sim.n_nl_build - 1} rebuilds in {steps} "
            f"steps); nl_sweep {launches['nl_sweep']} launches ("
            f"{per_step} a force); {sim.ms_step:.3f} ms/step against "
            f"{ref_ms:.3f} on the cell path ({ref})")
        e = compare_nl(sim, f"{HEADLINE_N}^3 float32", 1e-4, 1e-5)
        errs = {k: max(errs[k], e[k]) for k in errs}
        if sim.is_eam:
            e = check_row_ops(sim, f"{HEADLINE_N}^3 float32")
            row_errs = {k: max(row_errs[k], e[k]) for k in row_errs}
            rows.update(time_row_ops(sim, launches, row_errs))
        for name, (kern, plain, pair, energy) in nl_calls(sim).items():
            if energy:
                continue         # 99 of 100 steps run without energy
            ms = time_ms(kern, 5 if name == "nl_build" else 20)
            plain_ms = time_ms(plain, 1)
            b = nl_bound(sim, name, pair, energy)
            timing[(tag, name)] = (ms, plain_ms, b["ms"], b["by"])
            if name == "nl_build":
                extra = (f"; {sim.n_nl_build - 1} rebuilds in {steps} steps:"
                         f" {ms * (sim.n_nl_build - 1) / steps:.4f} ms a "
                         f"step")
            else:
                k1_ms, _slots, k1_cand, k1_flops = k1_pass1
                extra = (
                    f"; counting every entry of a real row (n_real K) "
                    f"bound {b['all_k_ms']:.4f} ms, "
                    f"{100 * b['all_k_ms'] / ms:.1f}% "
                    f"of it; {b['entries']:,} real list entries, "
                    f"{b['inside']:,} pairs inside the cutoff: "
                    f"{1e9 * ms / b['entries']:.3f} ps an entry, "
                    f"{1e9 * ms / b['inside']:.3f} ps a pair, "
                    f"{b['flops'] / ms / 1e9:.3f} TFLOP/s needed (K1 EAM "
                    f"pass 1, phase 5: {1e9 * k1_ms / k1_cand:.3f} ps a "
                    f"candidate pair, {k1_flops / k1_ms / 1e9:.3f} TFLOP/s)")
            say("timing", f"{tag} {name}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b['ms']:.4f} ms ({b['by']}), "
                f"{100 * b['ms'] / ms:.1f}% of it{extra}")
        launched[tag] = launches
        nl_final[tag] = (sim.e_potential + sim.kinetic_energy()) / sim.n_global
        del sim

    # the EAM NL headline on a 2x2x2 mesh: ki (ring_push) and collective
    final = {}
    for ci in ("ki", "collective"):
        e0 = []
        sim, launches = run_main(
            f"nl sharded main {ci}", ("nl_sweep",), doeam=True,
            method="thread_atom_nl", comm_impl=ci,
            on_init=lambda x: e0.append(x.e_potential), **MESH)
        rel = abs(e0[0] / nl_epot[0] - 1.0)
        e1 = (sim.e_potential + sim.kinetic_energy()) / sim.n_global
        rel1 = abs(e1 / nl_final["nl main"] - 1.0)
        check(rel < 1e-6 and rel1 < 1e-6, f"nl sharded {ci}: initial ePot "
              f"{e0[0]!r} vs serial {nl_epot[0]!r}, final energy {e1!r} vs "
              f"serial {nl_final['nl main']!r}")
        exchanges = sim.n_rebucket + 1
        n_ring = launches["ring_push"]
        n_pack = launches["atom_pack"]
        n_fill = launches["halo_fill"]
        # the list fill is K3's copies under every transport: one
        # halo_fill a force (the initial one and 100 steps)
        check(n_fill == 101
              and n_ring == (3 * exchanges if ci == "ki" else 0)
              and n_pack == (3 * exchanges if ci == "collective" else 0)
              and launches["nl_build"] == 8 * sim.n_nl_build,
              f"nl sharded {ci}: ring_push {n_ring}, atom_pack {n_pack} "
              f"for {exchanges} exchanges, halo_fill {n_fill}, nl_build "
              f"{launches['nl_build']} for {sim.n_nl_build} builds")
        # ER one a force a shard, LR one a step a shard and the initial
        # force's, NR one a build a shard
        got = {k: launches[k] for k in ROWS_KEYS + ("embed_fill", "land")}
        want = {"embed_rows": 8 * 101, "land_rows": 8 * 101,
                "nl_rows": 8 * sim.n_nl_build, "embed_fill": 0, "land": 0}
        check(got == want, f"nl sharded {ci}: row ops launched {got}, not "
              f"{want}")
        digest = r_digest([s.r.cpu().numpy() for s in sim.states])
        say("nl sharded main", f"{ci}: row ops {got}; final r sha256 "
            f"{digest[:16]}.., ePot {sim.e_potential!r}")
        check_final_bits(ci, digest, sim.e_potential)
        say("nl sharded main", f"{ci}: initial ePot rel. diff to the serial"
            f" NL run {rel:.3e}, final energy {rel1:.3e}; "
            f"{sim.ms_step:.3f} ms/step on 8 shards; ring_push {n_ring}, "
            f"atom_pack {n_pack} ({exchanges} atom exchanges), halo_fill "
            f"{n_fill} (one a force: the list fill is K3's copies under "
            f"every transport), {sim.n_nl_build} builds, row split "
            f"{sim.nl_row_split is not None}")
        final[ci] = ([s.r for s in sim.states], sim.e_potential)
        del sim
    same_r = all(torch.equal(a, b) for a, b in zip(final["ki"][0],
                                                     final["collective"][0]))
    check(same_r and final["ki"][1] == final["collective"][1],
          f"nl sharded: ki and collective differ: r equal {same_r}, ePot "
          f"{final['ki'][1]!r} vs {final['collective'][1]!r}")
    say("nl sharded main", f"final r and ePot of ki and collective equal "
        f"bit for bit (ePot {final['ki'][1]:.6f})")
    del final

    # the kernels line: NL1 a build, NL2 a pass 1 without energy (what 99
    # of 100 steps run), at the EAM headline
    for name, call in (("nl_build", "nl_build"), ("nl_sweep", "pass1 False")):
        ms, plain_ms, b_ms, b_by = timing["nl main", call]
        rows[name] = {
            "name": name, "route": "cuda", "source": NL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launched["nl main"][name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
    return rows


#: the kernels-line rows of phase 15: the -P spline and -I LJ-table
#: variants of K1, K2 and NL2 (launch counter names)
OPTION_KEYS = ("spline_eam_pass1", "spline_eam_pass3",
               "spline_half_eam_pass1", "spline_half_eam_pass3", "lj_table",
               "nl_sweep_spline")


def run_options(serial_ms: float, lj_ms: float, k1: tuple) -> dict:
    """Phase 15: the -P spline and -I LJ-table variants of K1, K2 and NL2
    against their plain versions, the -P and -I goldens, the 63^3 -P (K1,
    K2, NL2) and -I (K1) headlines, -P on a 2x2x2 mesh under ki_fused (the
    ki fill), a checkpoint and restore on the card, and -s at 63^3.
    ``k1``: K1's EAM pass 1 and pass 3 ms from phase 5.  Returns the
    kernels line's rows of OPTION_KEYS."""
    import tempfile
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.parallel import ki_comm
    from comd_tpu_torch.probes import time_ms
    from comd_tpu_torch.utils import checkpoint as ckpt
    from comd_tpu_torch.utils.profile import profile_phases, report_phases
    errs = {k: 0.0 for k in OPTION_KEYS}

    def upd(e, pairs):
        for mine, theirs in pairs:
            errs[mine] = max(errs[mine], e[theirs])

    # the variants against their plain versions, thermalized 10^3
    spline = dict(doeam=True, spline=True)
    for dtype, f_atol, s_rtol, f_rtol in (
            ("float32", 1e-4, 1e-5, 0.0), ("float64", 0.0, 1e-12, 1e-12)):
        for kw in (spline, dict(spline, half_shell=True),
                   dict(spline, method="thread_atom_nl"),
                   dict(lj_interpolation=True)):
            sim = init_simulation(Config(
                nx=10, ny=10, nz=10, temperature=600.0, dtype=dtype,
                pot_dir=POTS, device="cuda", **kw))
            sim.step_block(10)
            tag = (f"10^3 {dtype}/{sim.pair_eval.kind} "
                   f"A={sim.cfg.max_atoms}")
            if sim.uses_nl:
                upd(compare_nl(sim, tag, f_atol, s_rtol, f_rtol,
                               more_lists=True),
                    [("nl_sweep_spline", "nl_sweep")])
            elif sim.cfg.half_shell:
                upd(compare_half(sim, tag, f_atol, s_rtol, f_rtol)[0],
                    [("spline_half_eam_pass1", "half_eam_pass1"),
                     ("spline_half_eam_pass3", "half_eam_pass3")])
            elif not sim.is_eam:
                upd(compare_lj(sim, tag, f_atol, s_rtol, f_rtol, half=False),
                    [("lj_table", "lj_table")])
            else:
                e, (r, nbr, ev, dfe, _c) = compare_passes(
                    sim, tag, f_atol, s_rtol, f_rtol)
                upd(e, [("spline_eam_pass1", "eam_pass1"),
                        ("spline_eam_pass3", "eam_pass3")])
                check_k1_bits(r, nbr, ev, dfe, tag)
            del sim

    # f64 goldens at 6^3, T = 0, through each variant
    for what, kw in (("K1", {}), ("K2 --halfShell", dict(half_shell=True)),
                     ("NL2 -m thread_atom_nl",
                      dict(method="thread_atom_nl"))):
        golden(f"-e -P 6^3 T=0 {what}", GOLDEN_EAM_SPLINE, nx=6, ny=6, nz=6,
               **spline, **kw)
    golden("-I 6^3 T=0 K1", GOLDEN_LJ_INTERP, nx=6, ny=6, nz=6,
           lj_interpolation=True)

    # the 63^3 headlines through the variants, each kernel launched every
    # step and the other evaluators' kernels never
    rows, e_serial = {}, []
    others = {"spline": ("eam_pass1", "eam_pass3", "half_eam_pass1",
                         "half_eam_pass3", "nl_sweep"),
              "lj_table": ("lj", "half_lj", "nl_sweep")}
    for tag, keys, kw, ref_ms, ref in (
            ("P main", ("spline_eam_pass1", "spline_eam_pass3"), spline,
             serial_ms, "phase 5"),
            ("P half main", ("spline_half_eam_pass1",
                             "spline_half_eam_pass3"),
             dict(spline, half_shell=True), serial_ms, "phase 5"),
            ("P nl main", ("nl_sweep_spline",),
             dict(spline, method="thread_atom_nl"), serial_ms, "phase 5"),
            ("I main", ("lj_table",), dict(lj_interpolation=True), lj_ms,
             "phase 9")):
        sim, launches = run_main(tag, keys, **kw)
        kind = sim.pair_eval.kind
        stray = {k: launches[k] for k in others[kind] if launches[k]}
        check(not stray, f"{tag}: other evaluators' kernels ran: {stray}")
        say(tag, f"{sim.ms_step:.3f} ms/step against {ref_ms:.3f} without "
            f"{'-P' if kind == 'spline' else '-I'} ({ref})")
        if tag == "P main":
            e_serial.append((sim.e_potential + sim.kinetic_energy())
                            / sim.n_global)
        r, ev, chunk = sim.state.r, sim.pair_eval, sim.cfg.resolved_box_chunk
        if sim.uses_nl:
            e = compare_nl(sim, f"{HEADLINE_N}^3 float32", 1e-4, 1e-5)
            errs["nl_sweep_spline"] = max(errs["nl_sweep_spline"],
                                          e["nl_sweep"])
            calls = nl_calls(sim)
            for name in ("pass1 False", "pass3"):
                kern, plain, pair, energy = calls[name]
                ms, plain_ms = time_ms(kern, 20), time_ms(plain, 1)
                b = nl_bound(sim, name, pair, energy)
                say("timing", f"{tag} nl_sweep_spline {name}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{b['ms']:.4f} ms ({b['by']}), {100 * b['ms'] / ms:.1f}"
                    f"% of it; {b['flops'] / ms / 1e9:.3f} TFLOP/s needed")
                if name == "pass1 False":
                    rows["nl_sweep_spline"] = {
                        "name": "nl_sweep_spline", "route": "cuda",
                        "source": NL_SOURCE, "replaces": REPLACES["nl_sweep"],
                        "launches": launches["nl_sweep_spline"],
                        "max_abs_err": errs["nl_sweep_spline"], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b["ms"],
                        "bound_by": b["by"], "library_ms": None}
            del sim, r, ev
            continue
        if kind == "lj_table":
            e = compare_lj(sim, f"{HEADLINE_N}^3 float32", 1e-4, 1e-5,
                           half=False)
            nbr = sim.maps.nbr_map
            timed = {"lj_table": (
                lambda: st.lj_pass(r, nbr, ev, want_energy=False),
                lambda: st.lj_pass_plain(r, nbr, ev, want_energy=False,
                                         box_chunk=chunk))}
            mine = {"lj_table": e["lj_table"]}
        elif sim.cfg.half_shell:
            e, (r, hm, ev, dfe, chunk) = compare_half(
                sim, f"{HEADLINE_N}^3 float32/spline", 1e-4, 1e-5)
            timed = {
                "spline_half_eam_pass1": (
                    lambda: st.eam_pass1_half(r, hm, ev, want_energy=False),
                    lambda: st.eam_pass1_half_plain(
                        r, hm, ev, want_energy=False, box_chunk=chunk)),
                "spline_half_eam_pass3": (
                    lambda: st.eam_pass3_half(r, hm, ev, dfe),
                    lambda: st.eam_pass3_half_plain(r, hm, ev, dfe,
                                                    box_chunk=chunk))}
            mine = {"spline_half_eam_pass1": e["half_eam_pass1"],
                    "spline_half_eam_pass3": e["half_eam_pass3"]}
        else:
            e, (r, nbr, ev, dfe, chunk) = compare_passes(
                sim, f"{HEADLINE_N}^3 float32/spline", 1e-4, 1e-5)
            check_k1_bits(r, nbr, ev, dfe, f"{HEADLINE_N}^3 -P")
            timed = {
                "spline_eam_pass1": (
                    lambda: st.eam_pass1(r, nbr, ev, want_energy=False),
                    lambda: st.eam_pass1_plain(r, nbr, ev, want_energy=False,
                                               box_chunk=chunk)),
                "spline_eam_pass3": (
                    lambda: st.eam_pass3(r, nbr, ev, dfe),
                    lambda: st.eam_pass3_plain(r, nbr, ev, dfe,
                                               box_chunk=chunk))}
            mine = {"spline_eam_pass1": e["eam_pass1"],
                    "spline_eam_pass3": e["eam_pass3"]}
        for k, (fn, plain) in timed.items():
            errs[k] = max(errs[k], mine[k])
            rows[k] = kernel_row(sim, k, launches, errs[k],
                                 time_ms(fn, 20), time_ms(plain, 1))
        del sim, r, ev

    # -P on a 2x2x2 mesh under ki_fused: comd_tpu does not fuse F' into
    # the fill under -P, so the fill is ki's (K3's copies); the fused
    # transport's entry point refuses to run here
    fused = ki_comm.exchange_scalar_ki_fused

    def refuse(*_a, **_k):
        raise AssertionError("the fused F' fill ran under -P")

    ki_comm.exchange_scalar_ki_fused = refuse
    try:
        sim, launches = run_main(
            "P sharded main ki_fused", ("spline_eam_pass1",
                                        "spline_eam_pass3", "halo_fill"),
            comm_impl="ki_fused", **spline, **MESH)
    finally:
        ki_comm.exchange_scalar_ki_fused = fused
    e1 = (sim.e_potential + sim.kinetic_energy()) / sim.n_global
    rel = abs(e1 / e_serial[0] - 1.0)
    check(launches["halo_fill"] == 101 and rel < 1e-6,
          f"P sharded: halo_fill {launches['halo_fill']} for 101 forces, "
          f"final energy {e1!r} vs serial {e_serial[0]!r}")
    say("P sharded main", f"halo_fill {launches['halo_fill']} launches (one "
        f"a force, the ki plan: K3's copies, no F' stage); final energy "
        f"rel. diff to the serial -P run {rel:.3e}; {sim.ms_step:.3f} "
        f"ms/step on 8 shards")
    del sim

    # a checkpoint on the card: 50 steps, save, restore into a fresh
    # simulation, 50 more == 100 uninterrupted, bit for bit (K1 gives the
    # same bits on every launch)
    n = HEADLINE_N
    cfg = Config(nx=n, ny=n, nz=n, doeam=True, temperature=600.0,
                 dtype="float32", pot_dir=POTS, device="cuda")
    whole = init_simulation(cfg)
    for _ in range(10):
        whole.step_block(10)
    part = init_simulation(cfg)
    for _ in range(5):
        part.step_block(10)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(d, part, 50)
        t_save = time.perf_counter() - t0
        del part
        t0 = time.perf_counter()
        back, step = ckpt.load(d, device="cuda")
        t_load = time.perf_counter() - t0
    for _ in range(5):
        back.step_block(10)
    torch.cuda.synchronize()
    check(step == 50 and torch.equal(back.state.r, whole.state.r)
          and torch.equal(back.state.p, whole.state.p)
          and back.e_potential == whole.e_potential,
          "checkpoint: the restored run differs from the uninterrupted one")
    say("checkpoint", f"{n}^3 EAM f32: 50 steps, save ({t_save:.2f} s), "
        f"restore ({t_load:.2f} s, init included), 50 steps: r, p and ePot "
        f"equal the uninterrupted 100-step run bit for bit "
        f"({back.n_rebucket} rebuckets after the restore)")
    del back

    # -s at 63^3 EAM on the uninterrupted run's state
    phases = profile_phases(whole, out=sys.stdout)
    print(report_phases(phases, whole.n_global), flush=True)
    s = whole.state
    rho = st.eam_pass1(s.r, whole.maps.nbr_map, whole.pair_eval,
                       want_energy=False)[2]
    pass2_ms = time_ms(lambda: whole.f_eval(rho), 20)
    ref = k1[0] + k1[1] + pass2_ms
    check(all(t > 0 for t in phases.values()) and
          0.5 <= 1e3 * phases["force"] / ref <= 2.0,
          f"-s: phases {phases}; force against K1's passes and pass 2 "
          f"{ref:.4f} ms")
    say("profile", f"-s at {n}^3: every phase positive; force "
        f"{1e3 * phases['force']:.4f} ms against K1 pass 1 + pass 3 (phase "
        f"5) + pass 2 = {k1[0]:.4f} + {k1[1]:.4f} + {pass2_ms:.4f} = "
        f"{ref:.4f} ms")
    del whole
    return rows


def compare_subsets(sim, tag: str) -> None:
    """K1 against its plain version over the -a 1 subsets of shard 0 of
    the mesh ``sim`` at phase 6's f32 tolerances (forces atol 1e-4 eV/A,
    scalars 1e-5 of their largest value): EAM passes 1 (with and without
    energy) and 3, or LJ; the interior and boundary launches' sum against
    the full launch; each launch without energy timed (mean of 20, CUDA
    events) beside the full one, with its bricks and staged region
    boxes."""
    import torch
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.probes import time_ms
    f_atol, s_rtol = 1e-4, 1e-5
    maps, ev = sim.maps, sim.pair_eval
    rs = [s.r for s in sim.states]
    r, nbr = rs[0], maps.nbr_map
    subsets = {"interior": maps.interior, "boundary": maps.boundary}
    # (name, kernel, plain version, arguments, keywords); pass 3's one
    # output made a tuple as the others'
    if sim.is_eam:
        # dfEmbed of the current state, halo rows filled by the mesh's fill
        rho = [st.eam_pass1(x, nbr, ev, want_energy=False)[2] for x in rs]
        dfe = sim._fill([torch.nn.functional.pad(
            sim.f_eval(x)[1], (0, 0, 0, r.shape[1] - sim.geom.n_local))
            for x in rho], rho)[0]
        cases = [("eam_pass1", st.eam_pass1, st.eam_pass1_plain, (r, nbr, ev),
                  dict(want_energy=e)) for e in (True, False)]
        cases.append(("eam_pass3", lambda *a, **k: (st.eam_pass3(*a, **k),),
                      lambda *a, **k: (st.eam_pass3_plain(*a, **k),),
                      (r, nbr, ev, dfe), {}))
    else:
        cases = [("lj", st.lj_pass, st.lj_pass_plain, (r, nbr, ev),
                  dict(want_energy=e)) for e in (True, False)]
    for name, fn, plain, args, kw in cases:
        what = name + ("" if kw.get("want_energy", True) else
                       " (no energy)")
        parts = []
        for sub_name, sub in subsets.items():
            got = fn(*args, boxes=sub, **kw)
            want = plain(*args, boxes=sub, **kw)
            torch.cuda.synchronize()
            err = float((got[0] - want[0]).abs().max())
            e_s = max((norm_rel(a, b) for a, b in zip(got[1:], want[1:])
                       if b is not None), default=0.0)
            check(err <= f_atol and e_s <= s_rtol,
                  f"{tag} {what} over the {sub_name} cells: force err "
                  f"{err:.3e}, scalar err {e_s:.3e}")
            parts.append(got)
            say("split", f"{tag}: K1 {what} over the {sub.n:,} {sub_name} "
                f"cells of shard 0 against its plain version: |df|max "
                f"{err:.3e}, scalars {e_s:.3e} of their largest value")
        full = fn(*args, **kw)
        d = max(float((a + b - c).abs().max()) for a, b, c in
                zip(*parts, full) if c is not None)
        check(d <= f_atol, f"{tag} {what}: interior + boundary against "
              f"the full launch {d:.3e}")
        say("split", f"{tag}: K1 {what} interior + boundary against the "
            f"full launch: max |diff| {d:.3e}")
        if kw.get("want_energy"):
            continue      # timed without energy, as 99 of 100 steps run
        launches = dict(subsets, full=None)
        ms = {k: time_ms(lambda: fn(*args, boxes=b, **kw), 20)
              for k, b in launches.items()}
        shp = {k: st.launch_shape(name, False, r, nbr, ev, boxes=b)
               for k, b in launches.items()}
        say("timing", f"{tag} K1 {name} a shard ({sim.geom.grid} cells, "
            f"{shp['full']['blocks_per_sm']} blocks/SM): "
            + "; ".join(f"{k} {ms[k]:.4f} ms ({shp[k]['bricks']} bricks, "
                        f"{shp[k]['region_boxes']:,} region boxes)"
                        for k in ms)
            + f"; interior + boundary {ms['interior'] + ms['boundary']:.4f}"
            f" ms = {(ms['interior'] + ms['boundary']) / ms['full']:.3f}x "
            f"the full launch (CUDA events, mean of 20)")


def cli_rows(argv) -> tuple:
    """The port CLI's printThings rows (step, time, energies per atom,
    temperature; the timing column dropped) for ``argv``, and its
    simulation's launch counts."""
    import io
    from comd_tpu_torch import cli
    from comd_tpu_torch.ops.cuda import stencil as st
    st.reset_launch_counts()
    buf = io.StringIO()
    cli.run(cli.config_from_args(cli.build_parser().parse_args(argv)),
            out=buf)
    rows = [m.group(1) for m in re.finditer(
        r"^( +\d+ +[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+) ",
        buf.getvalue(), re.M)]
    return rows, dict(st.LAUNCHES)


def run_split(serial_e0: float, lj_e0: float, mesh_epot: dict) -> None:
    """Phase 16: -a 1 of the cell methods on the 2x2x2 mesh, and the
    -m cta_cell -P repair.  ``serial_e0``/``lj_e0``: the initial ePot of
    phases 5 and 9; ``mesh_epot``: phase 12's final ePot by transport."""
    import torch
    steps, shards = 100, 8
    final = {}
    lj_a0 = run_main("split LJ -a 0 collective", ("lj",), gpu_async=0,
                     comm_impl="collective", **MESH)[0].e_potential
    for tag, kw, e_serial, e_a0 in (
            ("split main ki_fused", dict(doeam=True, comm_impl="ki_fused"),
             serial_e0, mesh_epot["ki_fused"]),
            ("split main collective",
             dict(doeam=True, comm_impl="collective"), serial_e0,
             mesh_epot["collective"]),
            ("split LJ main collective", dict(comm_impl="collective"),
             lj_e0, lj_a0)):
        keys = ("eam_pass1", "eam_pass3") if kw.get("doeam") else ("lj",)
        e0 = []
        sim, launches = run_main(
            tag, keys, gpu_async=1,
            on_init=lambda x: e0.append(x.e_potential), **kw, **MESH)
        check(sim.uses_split and sim.maps.interior.n > 0,
              f"{tag}: no interior/boundary split")
        rel0 = abs(e0[0] / e_serial - 1.0)
        rel1 = abs(sim.e_potential / e_a0 - 1.0)
        check(rel0 < 1e-6, f"{tag}: initial ePot {e0[0]!r} vs serial "
              f"{e_serial!r}")
        check(rel1 < 1e-6, f"{tag}: final ePot {sim.e_potential!r} vs -a 0 "
              f"{e_a0!r}")
        want = 2 * (steps + 1)
        for k in keys:
            check(launches[k] == want,
                  f"{tag}: {k} launched {launches[k]} times, not two a "
                  f"force over the {shards} shards' stack ({want} for the "
                  f"initial force and {steps} steps)")
        if kw["comm_impl"] == "ki_fused":
            # the fused fill evaluates F' of the split's summed rhobar
            check(launches["halo_fill"] == steps + 1,
                  f"{tag}: {launches['halo_fill']} fill launches, not one "
                  f"a force")
        say("split", f"{tag}: {sim.maps.interior.n:,} interior and "
            f"{sim.maps.boundary.n:,} boundary cells a shard; "
            f"{ {k: launches[k] for k in keys + ('halo_fill',)} } "
            f"launches (K1: two a force, interior and boundary, each over "
            f"the {shards} shards); initial ePot rel. diff "
            f"to the serial run {rel0:.3e}, final to the -a 0 run "
            f"{rel1:.3e}; {sim.ms_step:.3f} ms/step")
        if kw.get("doeam"):
            final[kw["comm_impl"]] = ([s.r for s in sim.states],
                                      sim.e_potential)
        if tag != "split main collective":
            compare_subsets(sim, tag)
        del sim
    same_r = all(torch.equal(a, b) for a, b in zip(final["ki_fused"][0],
                                                     final["collective"][0]))
    check(same_r and final["ki_fused"][1] == final["collective"][1],
          f"split ki_fused and collective differ: r equal {same_r}, ePot "
          f"{final['ki_fused'][1]!r} vs {final['collective'][1]!r}")
    say("split", "final r and ePot of ki_fused and collective equal bit for "
        "bit")
    del final
    # the repair: -m cta_cell takes the Chebyshev pair functions under -P
    argv = ["-e", "-x", "20", "-y", "20", "-z", "20", "-N", "20", "-n", "10",
            "-m", "cta_cell", "-d", POTS]
    rows, n_cheb = cli_rows(argv)
    rows_p, n_p = cli_rows(argv + ["-P"])
    check(len(rows) == 3 and rows_p == rows,
          f"-m cta_cell -P rows {rows_p} differ from -m cta_cell's {rows}")
    spline = sum(v for k, v in n_p.items() if k.startswith("spline"))
    check(spline == 0 and n_p["eam_pass1"] == n_cheb["eam_pass1"] > 0,
          f"-m cta_cell -P launched {n_p}")
    say("split", f"-e -m cta_cell -P at 20^3 f32 prints -e -m cta_cell's "
        f"rows ({len(rows)}, ePot/atom at step 20 {rows[-1].split()[3]}) "
        f"on Chebyshev K1: {n_p['eam_pass1']} pass-1 launches, no spline "
        f"launch")


def r_digest(arrays) -> str:
    """sha256 of the shards' positions, concatenated in shard order."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def spawn(cmds, timeout: int, tag: str) -> list:
    """Run the commands as processes at once (cwd the checkout); returns
    [(stdout, stderr)] once all have ended.  A process that fails or is
    still running after ``timeout`` seconds fails the phase; every process
    is stopped before this returns."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                check(False, f"{tag}: a process ran past {timeout} s")
            outs.append((out, err))
            if p.returncode != 0:
                print(err[-4000:], file=sys.stderr)
                check(False, f"{tag}: process {len(outs) - 1} exited "
                      f"{p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ki_stage_timing(sim) -> dict:
    """Phase 17's cross-process stages timed on this process, the same
    calls on every process (they wait on each other): the x stage of the
    fill (the one that crosses on 2 processes; F' on the sender under
    ki_fused) as the run makes it -- push, delivery, unpack, release -- and
    the x atom stage's push, delivery and release (no re-binning, which
    one process does alike).  CUDA-event ms (mean of 20) and
    host_and_device_ms's host and device ms a call."""
    import torch
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.parallel import ki_comm
    from comd_tpu_torch.probes import time_ms
    h, states = sim.halo, sim.states
    link = h.ipc["link"]
    fused = sim.cfg.comm_impl == "ki_fused"
    rho = [st.eam_pass1(s.r, sim.maps.nbr_map, sim.pair_eval,
                        want_energy=False)[2] for s in states]
    x = [torch.zeros(s.gid.shape, dtype=s.r.dtype, device=s.r.device)
         for s in states]
    fields = [[getattr(s, k) for s in states]
              for k in ("r", "p", "gid", "n_atoms")]

    def fill_stage():
        stg, v = ki_comm._fill_push(h, link, 0, x, rho if fused else None,
                                    sim.f_eval if fused else None)
        ki_comm._fill_unpack(h, 0, stg, link.deliver(h, "fill", 0, v, stg),
                             x)
        link.release("fill", 0, v, stg)

    def atom_stage():
        stg, v, _got = ki_comm._atoms_push(h, link, 0, fields)
        link.deliver(h, "atoms", 0, v, stg)
        link.release("atoms", 0, v, stg)

    out = {}
    for name, fn in (("fill", fill_stage), ("atoms", atom_stage)):
        ms = time_ms(fn, 20)
        host, dev = host_and_device_ms(fn)
        out[name] = dict(ms=ms, host_ms=host, device_ms=dev)
    torch.cuda.synchronize()
    return out


def mp_worker(n_procs: int, port: int, proc: int, out_path: str,
              comm_impl: str) -> int:
    """One process of phase 17's headline: the 63^3 EAM run on a 2x2x2 mesh
    under --commImpl ``comm_impl``, this process's shards on the card, 10 x
    step_block(10), launch counts zeroed just before the steps and read
    just after; then 10 more steps with the staging copies timed, 10 under
    the profiler, and under ki|ki_fused the cross-process stages timed.
    Writes its numbers as JSON to ``out_path``."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.parallel import dist
    dev = dist.init(n_procs, f"127.0.0.1:{port}", proc, "cuda")
    try:
        n = HEADLINE_N
        sim = init_simulation(Config(
            nx=n, ny=n, nz=n, temperature=600.0, dtype="float32",
            max_atoms=0, cell_mode="auto", pot_dir=POTS, device=str(dev),
            doeam=True, comm_impl=comm_impl, **MESH))
        n_owned = len(sim.states)
        on_card = all(getattr(s, f).is_cuda for s in sim.states
                      for f in ("r", "p", "f", "gid", "n_atoms"))
        e0 = sim.e_potential
        n0 = sim.sum_atoms()
        h = sim.halo
        h.traffic.clear()
        reb0 = sim.n_rebucket
        torch.cuda.synchronize()
        dist.barrier()
        st.reset_launch_counts()
        t0 = time.perf_counter()
        steps = 0
        for _ in range(10):
            sim.step_block(10)
            steps += 10
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        launches = dict(st.LAUNCHES)
        traffic = {k: v for k, v in h.traffic.items()}
        rebuckets = sim.n_rebucket - reb0
        e1 = sim.e_potential
        n1 = sim.sum_atoms()
        overflow = sim.overflow
        r_all = dist.gather_to_root(np.stack([s.r.cpu().numpy()
                                              for s in sim.states]))
        digest = (r_digest(r_all.reshape((-1,) + r_all.shape[2:]))
                  if r_all is not None else None)
        # the staging copies' host time, on 10 more steps (each exchange
        # then waits for the card first, so these steps are slower)
        h.traffic.clear()
        h.traffic["time"] = True
        sim.step_block(10)
        torch.cuda.synchronize()
        stage_ms = 1e3 * h.traffic.get("stage_s", 0.0) / 10
        transfer_ms = 1e3 * h.traffic.get("transfer_s", 0.0) / 10
        # this process's kernels over 10 more steps (torch.profiler, CUDA
        # activity only)
        from torch.profiler import ProfilerActivity, profile
        h.traffic["time"] = False
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.step_block(10)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        busy_us = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "Loading" not in e.key)
        stages = (ki_stage_timing(sim) if comm_impl != "collective"
                  else None)
        res = dict(proc=proc, n_owned=n_owned, on_card=on_card,
                   comm_impl=comm_impl, stages=stages,
                   device=str(dev), backend=dist.describe(dev), e0=e0, e1=e1,
                   n0=n0, n1=n1, overflow=overflow, digest=digest,
                   ms_step=1e3 * t_loop / steps, steps=steps,
                   rebuckets=rebuckets, launches=launches,
                   traffic={"/".join(map(str, k)) if isinstance(k, tuple)
                            else k: v for k, v in traffic.items()},
                   stage_ms=stage_ms, transfer_ms=transfer_ms,
                   busy_ms=busy_us / 1e3 / 10, prof_ms=1e3 * prof_wall / 10)
        with open(out_path, "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy()
    return 0


def run_multiproc(serial_e0: float, coll: dict, one_proc: dict,
                  timing: dict) -> dict:
    """Phase 17: the multi-process launch on the one card (processes share
    it: gloo, messages staged through pinned host buffers; under ki and
    ki_fused the fill and atom planes through CUDA IPC receive planes,
    ordered by counters on the stream).  ``serial_e0``: phase 5's initial
    ePot; ``coll``: phase 12's collective run (final ePot, r digest,
    ms/step); ``one_proc``: phase 12's launches by transport (halo_fill,
    ring_push, atom exchanges, steps); ``timing``: phase 12's fill and
    atom stage (CUDA-event, host and device ms).  Returns the launches of
    halo_fill_stage in the 2-process ki_fused run (both processes)."""
    import tempfile
    stage_launches = 0
    ms_coll = {}
    for n_procs, ci in ((2, "collective"), (4, "collective"),
                        (2, "ki_fused"), (4, "ki_fused"), (2, "ki")):
        with tempfile.TemporaryDirectory() as tmp:
            port = free_port()
            paths = [os.path.join(tmp, f"w{p}.json") for p in range(n_procs)]
            spawn([[sys.executable, os.path.abspath(__file__), "--mp-worker",
                    str(n_procs), str(port), str(p), paths[p], ci]
                   for p in range(n_procs)], 600,
                  f"multiproc main {n_procs} {ci}")
            res = [json.load(open(x)) for x in paths]
        tag = f"multiproc main {n_procs} {ci}"
        ki = ci != "collective"
        steps = res[0]["steps"]
        for w in res:
            where = f"{tag}, process {w['proc']}"
            check(w["on_card"] and w["device"].startswith("cuda"),
                  f"{where}: shards not on the card ({w['device']})")
            check(w["n_owned"] == 8 // n_procs,
                  f"{where}: {w['n_owned']} shards")
            for k in ("eam_pass1", "eam_pass3", "kick_drift_trigger",
                      "land"):
                check(w["launches"][k] == steps,
                      f"{where}: {k} launched {w['launches'][k]} times in "
                      f"{steps} steps on {w['n_owned']} shards, not once "
                      f"a step over their stack")
            check("staged" in w["backend"], f"{where}: backend "
                  f"{w['backend']}")
            refreshes = steps - w["rebuckets"]
            n_pos = (w["launches"]["position_fill"],
                     w["launches"]["position_fill_stage"])
            if ki:
                n_st, n_ring = (w["launches"]["halo_fill_stage"],
                                w["launches"]["ring_push"])
                check(n_st == 3 * steps and n_ring == 3 * w["rebuckets"]
                      and w["launches"]["halo_fill"] == 0,
                      f"{where}: halo_fill_stage {n_st}, ring_push "
                      f"{n_ring}, halo_fill {w['launches']['halo_fill']} "
                      f"for {steps} steps and {w['rebuckets']} rebuckets, "
                      f"not one stage launch a stage")
                check(n_pos == (0, 3 * refreshes),
                      f"{where}: position_fill, position_fill_stage "
                      f"{n_pos} for {refreshes} ghost refreshes, not one "
                      f"stage launch a stage")
                t = w["traffic"]
                check(not t.get("bytes/scalar") and not t.get("bytes/atoms")
                      and not t.get("bytes/positions")
                      and t.get("planes/fill", 0) > 0 and
                      (t.get("planes/atoms", 0) > 0 or not w["rebuckets"])
                      and (t.get("planes/positions", 0) > 0
                           or not refreshes),
                      f"{where}: a ki exchange went through the group, or "
                      f"no plane crossed: {t}")
            else:
                check(n_pos == (0, 0), f"{where}: position launches "
                      f"{n_pos} under collective across processes (the "
                      f"staged exchange through the group)")
                # the fill is the staged exchange through the group; the
                # atom messages one atom_pack launch a stage
                n_pack = w["launches"]["atom_pack"]
                check(w["launches"]["halo_fill"] == 0 and
                      w["launches"]["halo_fill_stage"] == 0 and
                      n_pack == 3 * w["rebuckets"],
                      f"{where}: halo_fill {w['launches']['halo_fill']}, "
                      f"atom_pack {n_pack} for {w['rebuckets']} rebuckets "
                      f"under collective across processes")
        if ci == "ki_fused" and n_procs == 2:
            stage_launches = sum(w["launches"]["halo_fill_stage"]
                                 for w in res)
        w = res[0]
        check(w["n0"] == w["n1"] == HEADLINE_N ** 3 * 4,
              f"{tag}: atoms {w['n0']} -> {w['n1']}")
        check(not w["overflow"], f"{tag}: capacity overflow")
        rel = abs(w["e0"] / serial_e0 - 1.0)
        check(rel < 1e-6, f"{tag}: initial ePot {w['e0']!r} vs serial "
              f"{serial_e0!r}")
        check(w["e1"] == coll["e_pot"] and w["digest"] == coll["digest"],
              f"{tag}: final ePot {w['e1']!r} and r digest {w['digest']} "
              f"differ from phase 12's collective run ({coll['e_pot']!r}, "
              f"{coll['digest']})")
        t = w["traffic"]
        refresh = steps - w["rebuckets"]
        via = "planes" if ki else "bytes"
        fill_b = t.get(f"{via}/{'fill' if ki else 'scalar'}", 0) / steps
        refresh_b = t.get(f"{via}/positions", 0) / max(refresh, 1)
        rebucket_b = t.get(f"{via}/atoms", 0) / max(w["rebuckets"], 1)
        say("multiproc main", f"{n_procs} processes on the one card "
            f"({w['backend']}), {w['n_owned']} shards each, {HEADLINE_N}^3 "
            f"EAM f32 2x2x2 {ci}: final ePot {w['e1']:.6f} and r "
            f"sha256 {w['digest'][:16]}.. equal phase 12's collective run "
            f"bit for bit; initial ePot rel. diff to the serial run "
            f"{rel:.3e}; K1 launches by process (pass 1, pass 3) "
            + ", ".join(f"{x['launches']['eam_pass1']}/"
                        f"{x['launches']['eam_pass3']}" for x in res)
            + f" in {steps} steps")
        if ci == "collective":
            ms_coll[n_procs] = [x["ms_step"] for x in res]
        say("multiproc main", f"{n_procs} processes {ci}: ms/step (host "
            f"clock, {steps} steps) "
            + ", ".join(f"{x['ms_step']:.3f}" for x in res)
            + f" against {coll['ms']:.3f} in one process (phase 12, "
            f"collective)"
            + (f" and {', '.join(f'{v:.3f}' for v in ms_coll[n_procs])} "
               f"on {n_procs} processes under collective (this phase)"
               if ki and n_procs in ms_coll else "")
            + "; under torch.profiler (10 steps) each process's "
            f"kernels busy "
            + ", ".join(f"{x['busy_ms']:.3f}" for x in res)
            + " ms/step of "
            + ", ".join(f"{x['prof_ms']:.3f}" for x in res)
            + f", the card busy {sum(x['busy_ms'] for x in res) / max(x['prof_ms'] for x in res):.1%}")
        say("multiproc main", f"{n_procs} processes {ci}: bytes process 0 "
            f"sent in {steps} steps ({w['rebuckets']} rebuckets, {refresh} "
            f"ghost refreshes): "
            + ", ".join(f"{k} {v:,}" for k, v in sorted(t.items())
                        if k.startswith(("bytes", "planes")))
            + f"; a refresh step {refresh_b + fill_b:,.0f} B, a rebucket "
            f"step {rebucket_b + fill_b:,.0f} B; the fill "
            f"{fill_b:,.0f} B a step "
            + ("through the arena (CUDA IPC), the atoms "
               f"{rebucket_b:,.0f} B a rebucket and the positions "
               f"{refresh_b:,.0f} B a refresh through the arena, "
               f"{t.get('bytes/positions', 0):,} B of positions through "
               f"gloo"
               if ki else "through gloo")
            + "; host ms a step in the gloo exchanges (10 steps, the card "
            "waited for first): "
            + ", ".join(f"{x['stage_ms']:.3f} staging copies + "
                        f"{x['transfer_ms']:.3f} transfer" for x in res))
        if ki:
            o = one_proc[ci]
            say("multiproc main", f"{n_procs} processes {ci}: launches a "
                f"step by process (halo_fill_stage, ring_push, "
                f"position_fill_stage): "
                + ", ".join(f"{x['launches']['halo_fill_stage'] / steps:.2f}"
                            f"/{x['launches']['ring_push'] / steps:.2f}"
                            f"/{x['launches']['position_fill_stage'] / steps:.2f}"
                            for x in res)
                + f" (3 a force, 3 a rebucket, 3 a ghost refresh); one "
                f"process (phase 12): "
                f"halo_fill {o[0] / o[3]:.2f}, ring_push {o[1] / o[3]:.2f} "
                f"a step ({o[0]} and {o[1]} over {o[3]} steps, {o[2]} atom "
                f"exchanges)")
            key = "halo_fill_fused" if ci == "ki_fused" else "halo_fill"
            f1, r1 = timing[key], timing["ring_push"]
            say("timing", f"{n_procs} processes {ci}: one x stage of the "
                f"fill across processes (push, counters, unpack) by "
                f"process: "
                + ", ".join(f"{x['stages']['fill']['ms']:.4f} ms (CUDA "
                            f"events), host {x['stages']['fill']['host_ms']:.4f}"
                            f", device {1e3 * x['stages']['fill']['device_ms']:.2f} us"
                            for x in res)
                + f"; the whole fill in one process (phase 12): "
                f"{f1[0]:.4f} ms, host {f1[1]:.4f}, device "
                f"{1e3 * f1[2]:.2f} us")
            say("timing", f"{n_procs} processes {ci}: one x atom stage "
                f"across processes (push, counters, no re-binning) by "
                f"process: "
                + ", ".join(f"{x['stages']['atoms']['ms']:.4f} ms, host "
                            f"{x['stages']['atoms']['host_ms']:.4f}, device "
                            f"{1e3 * x['stages']['atoms']['device_ms']:.2f} us"
                            for x in res)
                + f"; one stage push in one process (phase 12): "
                f"{r1[0]:.4f} ms, host {r1[1]:.4f}, device "
                f"{1e3 * r1[2]:.2f} us")
    # short CLI runs: process 0's rows against the single process's
    base = ["-x", "20", "-y", "20", "-z", "20", "-N", "20", "-n", "10",
            "-d", POTS]
    for n, extra in ((4, ["-e", "-i", "2", "-j", "2", "-k", "1"]),
                     (2, ["-e", "-i", "2", "-j", "2", "-k", "2",
                          "--halfShell", "--dtype", "float64"]),
                     (2, ["-e", "-i", "2", "-j", "2", "-k", "2", "-m",
                          "thread_atom_nl"]),
                     (4, ["-e", "-i", "2", "-j", "2", "-k", "1",
                          "--commImpl", "ki"]),
                     (2, ["-e", "-i", "2", "-j", "2", "-k", "2", "-a", "1",
                          "--commImpl", "ki_fused"]),
                     (2, ["-e", "-i", "2", "-j", "2", "-k", "2", "-m",
                          "thread_atom_nl", "--commImpl", "ki"])):
        argv = base + extra
        single, _launches = cli_rows(argv)
        port = free_port()
        outs = spawn([[sys.executable, "-m", "comd_tpu_torch.cli", *argv,
                       "--numProcs", str(n), "--coordinator",
                       f"127.0.0.1:{port}", "--procId", str(p)]
                      for p in range(n)], 300, f"multiproc cli {n}")
        rows = [m.group(1) for m in re.finditer(
            r"^( +\d+ +[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+) ",
            outs[0][0], re.M)]
        quiet = all(not out.strip() or all(
            ln.startswith("[Gloo]") for ln in out.splitlines())
            for out, _err in outs[1:])
        check(quiet, "multiproc cli: a process other than 0 printed")
        check(f"Across {n} Ranks" in outs[0][0] and
              "staged through pinned host buffers" in outs[0][0],
              f"multiproc cli {argv}: no rank statistics or staging line")
        check("--commImpl" not in argv or
              "ki: CUDA IPC planes, stream-ordered flags" in outs[0][0],
              f"multiproc cli {argv}: no ki transport line")
        how = "digit for digit"
        if rows != single and "--halfShell" in argv and len(rows) == len(
                single):
            # K2's j side adds with atomics in run-to-run order: hold its
            # rows to one unit in the last printed digit
            worst = max(abs(float(a) - float(b))
                        for ra, rb in zip(rows, single)
                        for a, b in zip(ra.split()[2:5], rb.split()[2:5]))
            check(worst <= 1.5e-12, f"multiproc cli {argv}: rows {rows} vs "
                  f"{single}")
            how = f"to {worst:.1e} eV/atom (K2's atomics)"
        else:
            check(len(rows) == 3 and rows == single,
                  f"multiproc cli {argv}: rows {rows} vs single {single}")
        say("multiproc cli", f"{n} processes, {' '.join(extra)} at "
            f"20^3: process 0 prints the single process's {len(rows)} rows "
            f"{how} (ePot/atom at step 20 {rows[-1].split()[3]}); the "
            f"others print nothing of the run")
    return stage_launches


#: what torch.cuda.set_sync_debug_mode("warn") says of each host sync
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(sim, n_blocks: int, block: int) -> dict:
    """Host syncs of ``n_blocks`` blocks of ``step_block``, counted by
    torch.cuda.set_sync_debug_mode: those inside captures (the first use
    of a graph) and the rest (on the graphs the rebucket counter's read
    at a lazy block's end; the eager loop also reads each trigger)."""
    import warnings
    import torch
    got = []
    inside = {"capture": 0}

    def n_sync():
        return sum(SYNC_WARNING in str(w.message) for w in got)

    graphs = sim._graphs
    if graphs is not None:
        orig = graphs._capture

        def counted(*a, **kw):
            n0 = n_sync()
            try:
                return orig(*a, **kw)
            finally:
                inside["capture"] += n_sync() - n0

        graphs._capture = counted
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = rec
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(n_blocks):
                    sim.step_block(block)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            total = n_sync()
    finally:
        if graphs is not None:
            del graphs._capture
    return dict(total=total, capture=inside["capture"],
                rest=total - inside["capture"], blocks=n_blocks,
                steps=n_blocks * block)


def device_busy_ms(sim, n_blocks: int, block: int) -> tuple:
    """The device's busy ms a step over ``n_blocks`` blocks under
    torch.profiler (CUDA activity: the sum of the kernels', copies' and
    sets' durations; one stream, so they do not overlap), and its device
    operations a step (kernels, copies and sets, as profile_step.py
    counts launches).  The profiler slows the host's launch of a graph of
    thousands of nodes, so the idle share is taken against the unprofiled
    wall clock, as profile_step.py takes it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_blocks):
            sim.step_block(block)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "Loading" not in e.key
           and getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) > 0]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in evs)
    steps = n_blocks * block
    return us / 1e3 / steps, sum(e.count for e in evs) / steps


def graph_vs_eager(tag: str, n: int = HEADLINE_N, dtype: str = "float32",
                   blocks: int = 10, block: int = 10, **kw) -> dict:
    """Phase 18: one headline stepped by the eager loop and by the CUDA
    graphs (``sim.cuda_graphs``), one after the other in this process.
    Each run warms up through its first rebucket (one block on -S 0: every
    graph captured), then steps ``blocks`` blocks timed by the host clock
    with the launch counts zeroed just before, then two blocks with the
    host syncs counted and two under torch.profiler (the device's busy
    ms a step; its idle share of the timed steps' wall clock).  Returns
    {mode: dict(ms, launches, replays, syncs, busy, idle, digest, e_pot,
    e_atom, captures, capture_s, instantiate_s, if_nodes)}: ``if_nodes``
    the IF nodes a captured graph holds (the serial lazy and list steps
    one, the rebucket's; a mesh's two; -S 0 none), and the serial runs'
    refresh_halo launches one a rebucket (the head refreshes the ghosts
    on the other steps; a mesh's exchange launches none)."""
    from comd_tpu_torch import stepgraph
    out = {}
    nodes = []
    if_node = stepgraph.if_node

    def counted_if_node(*a, **k):
        nodes.append(1)
        return if_node(*a, **k)

    stepgraph.if_node = counted_if_node
    try:
        for mode in ("eager", "graphs"):
            out[mode] = _graph_or_eager(tag, mode, n, dtype, blocks, block,
                                        kw)
    finally:
        stepgraph.if_node = if_node
    e, g = out["eager"], out["graphs"]
    g["if_nodes"] = len(nodes) / max(g["captures_all"], 1)
    sy = g["syncs"]
    want = sy["blocks"] if g["lazy"] else 0
    check(sy["rest"] == want and sy["capture"] == 0,
          f"{tag}: {sy['rest']} host syncs in step_block outside captures "
          f"in {sy['blocks']} blocks of the graphs, not {want}: {sy}")
    e_per = {k: v / e["steps"] for k, v in e["launches"].items()}
    g_per = {k: v / g["steps"] for k, v in g["launches"].items()}
    check(e_per == g_per, f"{tag}: launches a step differ: eager {e_per}, "
          f"graphs {g_per}")
    check("set_condition" not in g["launches"],
          f"{tag}: a set_condition launch on the graphs")
    check(e["n_rebucket"] == g["n_rebucket"],
          f"{tag}: rebuckets {e['n_rebucket']} (eager), "
          f"{g['n_rebucket']} (graphs)")
    check(abs(g["replays"] - 1.0) < 1e-12,
          f"{tag}: {g['replays']} graph replays a step, not one")
    want = (2 if g["mesh"] else 1) if g["lazy"] else 0
    check(g["if_nodes"] == want, f"{tag}: {g['if_nodes']} IF nodes a "
          f"graph, not {want}")
    want = 0 if g["mesh"] else g["rebuckets"]
    got = g["launches"].get("refresh_halo", 0)
    check(got == want, f"{tag}: refresh_halo launched {got} times in the "
          f"timed steps, not {want} ({g['rebuckets']} rebuckets)")
    for mode, m in (("eager", e), ("graphs", g)):
        # a lazy mesh step that does not rebucket refreshes the ghosts in
        # one position_fill launch (the graphs' IF body, credited a
        # replay and taken back a rebucket)
        want = m["steps"] - m["rebuckets"] if m["mesh"] and m["lazy"] else 0
        got = m["launches"].get("position_fill", 0)
        check(got == want, f"{tag} {mode}: position_fill launched {got} "
              f"times in the timed steps, not {want} ({m['rebuckets']} "
              f"rebuckets in {m['steps']} steps)")
    for mode, m in (("eager", e), ("graphs", g)):
        # the rebucket body's two launches, credited once a rebucket a
        # shard (a graph's from the device counter, at a block's end)
        want = m["rebuckets"] * m["shards"]
        got = {k: m["launches"].get(k, 0) for k in REBUCKET_KEYS}
        check(got == {k: want for k in REBUCKET_KEYS},
              f"{tag} {mode}: rebucket kernels launched {got} in the timed "
              f"steps, not {want} each ({m['rebuckets']} rebuckets, "
              f"{m['shards']} shard(s))")
        # a mesh's unload: one bin and one place a stage, one sort
        n = m["rebuckets"] if m["mesh"] else 0
        got = {k: m["launches"].get(k, 0) for k in ARRIVALS_KEYS}
        want = {"arrivals_bin": 3 * n, "arrivals_place": 3 * n,
                "sort_cells": n}
        check(got == want, f"{tag} {mode}: the unload's kernels launched "
              f"{got} in the timed steps, not {want}")
    return out


def _graph_or_eager(tag: str, mode: str, n: int, dtype: str, blocks: int,
                    block: int, kw: dict) -> dict:
    """One run of ``graph_vs_eager``: the eager loop or the graphs."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    sim = init_simulation(Config(
        nx=n, ny=n, nz=n, temperature=600.0, dtype=dtype, max_atoms=0,
        cell_mode="auto", pot_dir=POTS, device="cuda", **kw))
    sim.cuda_graphs = mode == "graphs"
    lazy = sim.uses_lazy or sim.uses_nl
    warm = 0
    while warm < 200:
        sim.step_block(block)
        warm += block
        if sim.n_rebucket:
            break
    g = sim._graphs
    check((g is not None) == (mode == "graphs"),
          f"{tag}: the {mode} run's graphs: {g}")
    captures0 = g.captures if g else 0
    replays0 = g.replays if g else 0
    reb0 = sim.n_rebucket
    nb = blocks
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(nb):
        sim.step_block(block)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = nb * block
    launches = {k: v for k, v in LAUNCHES.items() if v}
    res = dict(ms=1e3 * wall / steps, steps=steps, warm=warm, lazy=lazy,
               rebuckets=sim.n_rebucket - reb0, launches=launches,
               replays=(g.replays - replays0) / steps if g else 0.0,
               captures=(g.captures - captures0) if g else 0,
               n_graphs=len(g.graphs) if g else 0,
               capture_s=g.capture_s if g else 0.0,
               instantiate_s=g.instantiate_s if g else 0.0)
    res["syncs"] = count_syncs(sim, 2, block)
    res["busy"], res["device_ops"] = device_busy_ms(sim, 2, block)
    res["idle"] = 1.0 - res["busy"] / res["ms"]
    states = sim.states if hasattr(sim, "states") else [sim.state]
    res["digest"] = r_digest([s.r.cpu().numpy() for s in states])
    res["e_pot"] = sim.e_potential
    res["e_atom"] = ((sim.e_potential / sim.n_global),
                     (sim.e_potential + sim.kinetic_energy())
                     / sim.n_global)
    res["n_rebucket"] = sim.n_rebucket
    res["mesh"] = hasattr(sim, "states")
    res["shards"] = len(states)
    res["captures_all"] = g.captures if g else 0
    check(sim.sum_atoms() == sim.n_global and not sim.overflow,
          f"{tag} {mode}: atoms lost or overflow")
    del sim, g, states
    torch.cuda.empty_cache()
    return res


def say_graph_vs_eager(tag: str, out: dict, bitwise: bool = True) -> None:
    e, g = out["eager"], out["graphs"]
    if bitwise:
        check(e["digest"] == g["digest"] and e["e_pot"] == g["e_pot"],
              f"{tag}: graphs and eager end apart: r sha256 "
              f"{g['digest'][:16]} vs {e['digest'][:16]}, ePot "
              f"{g['e_pot']!r} vs {e['e_pot']!r}")
    per = {k: round(v / e["steps"], 2) for k, v in e["launches"].items()}
    say("graphs", f"{tag}: after {e['warm']} (eager) and {g['warm']} "
        f"(graphs) steps of warm-up, eager {e['steps']} steps "
        f"{e['ms']:.3f} ms/step, graphs {g['steps']} steps {g['ms']:.3f} "
        f"ms/step ({e['ms'] / g['ms']:.2f}x); device busy "
        f"{e['busy']:.3f}, {g['busy']:.3f} ms/step, idle "
        f"{100 * e['idle']:.1f}%, {100 * g['idle']:.1f}% of the wall "
        f"clock (busy under torch.profiler, 2 more blocks); device "
        f"operations a step {e['device_ops']:.2f}, {g['device_ops']:.2f} "
        f"(the same profile); launches a "
        f"step {per} (equal, no set_condition: the trigger sets the IF "
        f"handles); graph replays a step {g['replays']:.2f}; rebuckets "
        f"{e['rebuckets']}, {g['rebuckets']} in the timed steps, "
        f"{e['n_rebucket']} in all (equal); {g['if_nodes']:.0f} IF "
        f"node(s) a graph; refresh_halo "
        f"{g['launches'].get('refresh_halo', 0)}, position_fill "
        f"{g['launches'].get('position_fill', 0)}, rebucket_bin and "
        f"rebucket_place {g['launches'].get('rebucket_bin', 0)} in the "
        f"timed steps (one a rebucket a shard)")
    for mode, m in (("eager", e), ("graphs", g)):
        sy = m["syncs"]
        say("graphs", f"{tag} {mode}: host syncs in step_block in "
            f"{sy['blocks']} blocks of {sy['steps'] // sy['blocks']} "
            f"steps: {sy['rest']} outside captures "
            f"({sy['rest'] / sy['steps']:.2f} a step), {sy['capture']} in "
            f"captures")
    say("graphs", f"{tag}: {g['n_graphs']} graphs (one a want_energy), "
        f"captured in {1e3 * g['capture_s']:.1f} ms and instantiated in "
        f"{1e3 * g['instantiate_s']:.1f} ms in all (the warm-up of both "
        f"branches not counted)")
    if bitwise:
        say("graphs", f"{tag}: final r sha256 {g['digest'][:16]}.. and "
            f"ePot {g['e_pot']:.6f} equal bit for bit")


def displaced(r, n_local: int, skin: float, over: bool = False):
    """(r', baseline): copies of ``r`` [3, B, A] in which local slot (nl //
    2, 0) sits at (a, b, 0) from its baseline (0, 0, 0) with fl(fl(a a) +
    fl(b b)) == (skin/2)^2 in r's dtype (the trigger must stay clear), or
    with ``over`` a raised by ulps until the sum first exceeds it (the
    trigger must fire)."""
    import numpy as np
    dt = r.cpu().numpy().dtype
    thr = dt.type((0.5 * skin) ** 2)
    a = np.sqrt(thr)
    for _ in range(8):
        a = np.nextafter(a, dt.type(0))
        b = np.sqrt(thr - a * a) if a * a < thr else dt.type(0)
        if a * a + b * b == thr:
            break
    check(a * a + b * b == thr, f"no displacement of (skin/2)^2 = {thr}")
    while over and not a * a + b * b > thr:
        a = np.nextafter(a, dt.type(np.inf))
    at, at_last = r.clone(), r.clone()
    at[0, n_local // 2, 0], at[1, n_local // 2, 0] = float(a), float(b)
    at_last[0, n_local // 2, 0], at_last[1, n_local // 2, 0] = 0.0, 0.0
    return at, at_last


def run_trigger_handles(sim) -> dict:
    """Phase 18: kick_drift_trigger sets the step graph's IF handles (csrc/
    step.cu; graph_if.condition makes them in the captured graph).  A
    graph of the trigger's launch on ``sim``'s fields (p and f zero, so r
    stays put) and two IF nodes whose bodies count their runs, replayed
    with r at the baseline (clear), at one slot displaced by exactly
    (skin/2)^2 (clear) and at its next ulp (set); then one launch over a
    stack of eight shards, of which one is displaced (as the mesh's head
    does).  The bodies' counts against the plain version's branch
    (kick_drift_trigger_plain on the same tensors shard by shard, or-ed
    over the shards, read on the host).  Then a graph of a trigger launch on a one-cell
    state and one IF node with a one-kernel body, timed as a replay (CUDA
    events, mean of 200) beside the plain version (the plain trigger, the
    host's read and the body's launch) and the bound (one byte): the
    set_condition row, its work now the trigger's, 0 launches."""
    import torch
    from comd_tpu_torch.ops.cuda import graph_if
    from comd_tpu_torch.ops.cuda import step
    from comd_tpu_torch.probes import time_ms
    from comd_tpu_torch.stepgraph import cuda_capture
    dev = torch.device("cuda")
    s, nl, skin = sim.state, sim.geom.n_local, sim.skin
    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    p0, f0 = torch.zeros_like(s.r), torch.zeros_like(s.r)
    at, base = displaced(s.r, nl, skin)
    over, _b = displaced(s.r, nl, skin, over=True)
    bodies = graph_if.BodyPool(dev)
    err, lines = 0.0, []
    for shards in (1, 8):
        rs = torch.stack([base] * shards)
        ps, fs, bs = (torch.stack([x] * shards) for x in (p0, f0, base))
        moved = shards // 2 + 1 if shards > 1 else 0
        hits = torch.zeros(2, dtype=torch.int32, device=dev)

        def graph_fn():
            cond = graph_if.condition(dev)
            check(len(cond.handles) == 2, "no conditional handles in the "
                  "capture")
            cond.flag = step.kick_drift_trigger(
                ps, rs, fs, bs, nl, kick, drift, skin,
                handles=cond.handles)
            graph_if.if_node(cond, 0, lambda: hits[0].add_(1), bodies)
            graph_if.if_node(cond, 1, lambda: hits[1].add_(1), bodies)

        graph, _c, _i = cuda_capture(graph_fn,
                                     torch.cuda.graph_pool_handle())
        want = torch.zeros(2, dtype=torch.int32)
        seq = ("baseline", "over", "at", "over", "baseline", "at", "over")
        for case in seq:
            rs[moved].copy_({"baseline": base, "at": at, "over": over}[case])
            graph.replay()
            flag = None
            for i in range(shards):
                flag = step.kick_drift_trigger_plain(
                    p0.clone(), rs[i].clone(), f0, base, nl, kick, drift,
                    skin, flag, add=i > 0)
            graph_if.if_node_plain(flag.cpu(), lambda: want[0].add_(1))
            graph_if.if_node_plain(flag.cpu(), lambda: want[1].add_(1),
                                   True)
        e = float((hits.cpu() - want).abs().max())
        check(e == 0 and want.tolist() == [3, 4],
              f"trigger handles, {shards} shard(s): IF bodies ran "
              f"{hits.tolist()} times, the plain version {want.tolist()}")
        err = max(err, e)
        lines.append(f"{shards} shard(s) (shard {moved} displaced) "
                     f"{hits.tolist()}")
        del graph, rs
    # one cell: the set_condition row's time, as its one-node graph was
    r1, p1, f1, l1 = (torch.zeros((3, 1, s.r.shape[2]), dtype=s.r.dtype,
                                  device=dev) for _ in range(4))
    hit = torch.zeros((), dtype=torch.int32, device=dev)

    def one():
        cond = graph_if.condition(dev)
        cond.flag = step.kick_drift_trigger(p1, r1, f1, l1, 1, kick, drift,
                                            skin, handles=cond.handles)
        graph_if.if_node(cond, 0, lambda: hit.sub_(1), bodies)
        graph_if.if_node(cond, 1, lambda: hit.add_(1), bodies)

    graph, cap_s, inst_s = cuda_capture(one, torch.cuda.graph_pool_handle())
    ms = time_ms(graph.replay, 200)

    def plain():
        graph_if.if_node_plain(step.kick_drift_trigger_plain(
            p1, r1, f1, l1, 1, kick, drift, skin), lambda: hit.add_(1),
            True)

    plain_ms = time_ms(plain, 200)
    b_ms = 1e3 * 1 / PEAK_BYTES
    say("graphs", "trigger handles set by kick_drift_trigger: IF bodies "
        "(if set, if clear) ran as the plain version takes them over 7 "
        "replays (baseline, at (skin/2)^2, its next ulp): "
        + "; ".join(lines))
    say("timing", f"set_condition (folded into kick_drift_trigger, 0 "
        f"launches): a graph of a trigger launch on one cell and the two "
        f"IF nodes, each body one kernel, {ms:.4f} ms a replay (CUDA events, "
        f"mean of 200), the plain version (trigger, host read, body) "
        f"{plain_ms:.4f} ms; bound {b_ms:.3e} ms (one byte); captured in "
        f"{1e3 * cap_s:.2f} ms, instantiated in {1e3 * inst_s:.2f} ms")
    return {"name": "set_condition", "route": "cuda", "source": STEP_SOURCE,
            "replaces": "comd_tpu/sim.py:319-320, :373-375 (lax.cond, XLA)",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
            "library_ms": None, "folded_into": "kick_drift_trigger"}


STEP_SOURCE = "comd_tpu_torch/csrc/step.cu"
# the kernels-line rows of phase 23's stacked launches (one over the
# mesh's 8 shards)
STACKED_KEYS = tuple(f"stacked_{k}" for k in (
    "eam_pass1", "eam_pass3", "kick_drift_trigger", "embed_fill", "land"))
STEP_KEYS = ("kick_drift_trigger", "refresh_halo", "embed_fill", "land")
# peak float64 rate outside the tensor cores (H100 SXM data sheet)
PEAK_F64_FLOPS = 34e12


def step_op_cases(sim) -> list:
    """csrc/step.cu's kernels on ``sim``'s state (serial, EAM), as
    (name, kernel, prep, run, bytes, flops): ``prep()`` makes fresh clones
    of the operands a call writes, ``run(fn, ops)`` calls ``fn`` (the
    kernel's wrapper or its plain version) on them and returns what it
    wrote; bytes and flops are what the call needs (each input read once,
    each output written once).  The trigger on the state against a
    baseline 0.01 A away and on states with one slot displaced by exactly
    (skin/2)^2 in the dtype (the others still: it must not fire), for the
    run's skin and for 0.45 A, whose (skin/2)^2 rounds up in f32 (a
    comparison in f64 would fire there), the ghost refresh, pass 2 with
    and without energy (rhobar and phi from K1's pass 1 on the state)
    with the serial fill and with zero halo rows, and with the serial
    fill at an odd number of slots a row (one slot a thread), and the
    landing of K1's two passes and of one force; the trigger with the
    serial image map (the main path's head: the ghost refresh in its
    launch) and the whole halo fill (r, gid, n_atoms), each also at an
    odd number of slots a row (the fields cut to it; one slot a thread
    in the fill)."""
    import torch
    from comd_tpu_torch.ops.cuda import stencil as st
    s, geom, maps = sim.state, sim.geom, sim.maps
    nl, (B, A) = geom.n_local, s.r.shape[1:]
    es = s.r.element_size()
    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    skin = sim.skin
    last = s.r.clone()
    last[:, :nl] += 1e-2

    zero = torch.zeros_like(s.p)
    f1, phi, rho = st.eam_pass1(s.r, maps.nbr_map, sim.pair_eval)
    dfe, _u = sim.f_eval(rho)
    dfe = torch.cat([dfe, torch.zeros((B - nl, A), dtype=dfe.dtype,
                                      device=dfe.device)])
    f3 = st.eam_pass3(s.r, maps.nbr_map, sim.pair_eval, dfe)
    e_dtype = sim.cfg.torch_energy_dtype
    n_halo = B - nl
    slots, local = 3 * B * A, 3 * nl * A

    def kdt(p, r, f, lst, skin=skin, images=None):
        return (lambda: (p.clone(), r.clone()),
                lambda fn, o: o + (fn(o[0], o[1], f, lst, nl, kick, drift,
                                      skin, images=images),))

    def kdt_at(skin):
        at, at_last = displaced(s.r, nl, skin)
        return kdt(zero, at, zero, at_last, skin)

    def land(two):
        return (lambda: (s.f.clone(), s.p.clone(), s.n_local.clone()),
                lambda fn, o: fn(o[0], o[1], f1, f3 if two else None,
                                 s.n_atoms, o[2], nl, kick) or o)

    kdt_bytes = es * (3 * slots + local + 2 * slots) + 1
    kdt_flops = 4 * slots + 8 * nl * A
    # an odd number of slots a row (fields cut to it): the one-slot forms
    odd = A - 1 - A % 2

    def cut(x):
        return x[..., :odd].contiguous()

    def kdt_images(a):
        """bytes, flops of the trigger with images at a slots a row: p, f
        in, p out everywhere; r and the baseline in over the local slots;
        r out everywhere (the halo rows as images); the map in."""
        sl, lo, ha = 3 * B * a, 3 * nl * a, 3 * n_halo * a
        return (es * (4 * sl + 2 * lo) + 4 * (nl + 1 + n_halo)
                + es * 3 * n_halo + 1,
                2 * sl + 2 * lo + 8 * nl * a + ha)

    def fill(a):
        """The whole halo fill at a slots a row: (prep, run, bytes,
        flops)."""
        r, g = (s.r, s.gid) if a == A else (cut(s.r), cut(s.gid))
        return (lambda: (r.clone(), g.clone(), s.n_atoms.clone()),
                lambda fn, o: (fn(geom, maps, *o),) + o[1:],
                es * (2 * 3 * n_halo * a + 3 * n_halo) + 4 * 2 * n_halo * a
                + 4 * 2 * n_halo + 8 * n_halo, 3 * n_halo * a)
    cases = [
        ("kick_drift_trigger", "kick_drift_trigger",
         *kdt(s.p, s.r, s.f, last), kdt_bytes, kdt_flops),
        ("kick_drift_trigger at (skin/2)^2", "kick_drift_trigger",
         *kdt_at(skin), kdt_bytes, kdt_flops),
        ("kick_drift_trigger at (0.45/2)^2", "kick_drift_trigger",
         *kdt_at(0.45), kdt_bytes, kdt_flops),
        ("kick_drift_trigger images", "kick_drift_trigger",
         *kdt(s.p, s.r, s.f, last, images=maps.images), *kdt_images(A)),
        (f"kick_drift_trigger images A={odd}", "kick_drift_trigger",
         *kdt(cut(s.p), cut(s.r), cut(s.f), cut(last),
              images=maps.images), *kdt_images(odd)),
        ("refresh_halo", "refresh_halo", lambda: (s.r.clone(),),
         lambda fn, o: (fn(geom, maps, o[0]),),
         es * (2 * 3 * n_halo * A + 3 * n_halo) + 8 * n_halo,
         3 * n_halo * A),
        ("refresh_halo fill", "refresh_halo", *fill(A)),
        (f"refresh_halo fill A={odd}", "refresh_halo", *fill(odd))]
    tab = (sim.f_eval.n + 4) * es
    rho_1, phi_1 = rho[:, :odd].contiguous(), phi[:, :odd].contiguous()
    for energy in (True, False):
        for src, a in ((maps.halo_src, A), (None, A), (maps.halo_src, odd)):
            n_b = es * (nl * a + B * a) + tab + (8 * n_halo if src is not None
                                                 else 0)
            if energy:
                n_b += es * nl * a + 4 * nl + \
                    torch.finfo(e_dtype).bits // 8 * nl * a
            rh, ph = (rho, phi) if a == A else (rho_1, phi_1)
            cases.append((
                f"embed_fill energy={energy} serial={src is not None}"
                + ("" if a == A else f" A={a}"), "embed_fill", lambda: (),
                lambda fn, _o, e=energy, h=src, rh=rh, ph=ph: fn(
                    sim.f_eval, rh, ph if e else None, s.n_atoms, B, h,
                    e_dtype),
                n_b, 20 * (B * a if src is not None else nl * a)
                + (3 * nl * a if energy else 0)))
    for two in (True, False):
        cases.append((f"land passes={1 + two}", "land", *land(two),
                      es * ((1 + two) * local + 3 * slots) + 4 * nl + 4,
                      (2 + two) * slots))
    return cases


def kdt_in_graph(run, ops, n: int = 1) -> tuple:
    """The trigger as the step graph runs it: ``run(fn, ops)`` (``fn`` the
    wrapper) captured into a CUDA graph after a condition of ``n``
    handles, which the launch sets, and an IF node a handle whose body
    counts its runs; replayed once.  Returns (what ``run`` returned,
    cloned after the replay; the bodies' runs)."""
    import torch
    from comd_tpu_torch.ops.cuda import graph_if
    from comd_tpu_torch.ops.cuda import step
    from comd_tpu_torch.stepgraph import cuda_capture
    bodies = graph_if.BodyPool("cuda")
    hits = torch.zeros(n, dtype=torch.int32, device="cuda")
    out = []

    def captured():
        cond = graph_if.condition("cuda", n)
        check(len(cond.handles) == n, f"{len(cond.handles)} handles, not {n}")

        def fn(*a, **kw):
            return step.kick_drift_trigger(*a, handles=cond.handles, **kw)

        out.append(run(fn, ops))
        cond.flag = out[0][2]
        for k in range(n):
            graph_if.if_node(cond, k, lambda k=k: hits[k].add_(1), bodies)

    graph, _c, _i = cuda_capture(captured, torch.cuda.graph_pool_handle())
    graph.replay()
    torch.cuda.synchronize()
    got = tuple(x.clone() for x in out[0])
    del graph
    return got, hits.cpu().tolist()


def check_step_ops(sim, tag: str) -> dict:
    """Phase 19's bitwise check at one state: each case of
    ``step_op_cases`` through the kernel (one launch) and through its plain
    version on the same CUDA tensors; the trigger at (skin/2)^2 clear; the
    trigger with images also in a graph with the serial step's one IF
    handle set by the launch (``kdt_in_graph``), its body run as the flag
    says.  Returns {case name: max |kernel - plain| over its outputs
    (0)}."""
    import torch
    from comd_tpu_torch.ops.cuda import LAUNCHES
    from comd_tpu_torch.ops.cuda import step
    errs = {}
    for name, key, prep, run, _b, _f in step_op_cases(sim):
        n0 = LAUNCHES[key]
        got = run(getattr(step, key), prep())
        check(LAUNCHES[key] == n0 + 1, f"{tag} {name}: "
              f"{LAUNCHES[key] - n0} launches, not one")
        want = run(getattr(step, key + "_plain"), prep())
        tries = [got]
        if name.startswith("kick_drift_trigger images"):
            in_graph, hits = kdt_in_graph(run, prep())
            check(hits == [int(bool(want[2]))], f"{tag} {name}: the IF "
                  f"body ran {hits} with the trigger {bool(want[2])}")
            tries.append(in_graph)
        err = 0.0
        for res in tries:
            for x, y in zip(res, want):
                check((x is None) == (y is None) and (
                    x is None or (x.dtype == y.dtype and torch.equal(x, y))),
                      f"{tag} {name}: kernel and plain version differ")
                if x is not None and x.is_floating_point():
                    err = max(err, float((x - y).abs().max()))
        if name.startswith("kick_drift_trigger at"):
            check(not bool(got[2]), f"{tag}: the trigger fired {name[19:]}")
        errs[name] = err
    say("step ops", f"{tag}: " + ", ".join(errs) + ": kernel and plain "
        f"version equal bit for bit (the trigger clear at (skin/2)^2 and "
        f"(0.45/2)^2; with images also in a graph, setting the serial "
        f"step's one IF handle)")
    return errs


def full_step_pair(sim, tag: str, force_rebucket: bool) -> None:
    """One serial lazy EAM block of two steps (the second an energy step)
    from one state, through the kernels and through their plain versions
    (the four step wrappers and the in-place rebucket swapped for them;
    the eager loop), the state put
    back between: r, p, f, the triggers, n_local and ePot equal bit for
    bit.  ``force_rebucket``: one occupied baseline slot moved a skin away
    first, so the first step takes the rebucket branch."""
    import torch
    from comd_tpu_torch.ops.cuda import rebucket as rb
    from comd_tpu_torch.ops.cuda import step
    saved = {k: v.clone() for k, v in sim._bufs.items()}
    counters = (sim.n_rebucket, sim._rebuckets_read)
    graphs, sim.cuda_graphs = sim.cuda_graphs, False
    out = {}
    for mode in ("kernels", "plain"):
        for k, v in saved.items():
            sim._bufs[k].copy_(v)
        sim.n_rebucket, sim._rebuckets_read = counters
        if force_rebucket:
            box = int(torch.nonzero(sim.state.n_atoms[:sim.geom.n_local])[0])
            sim.last_r[0, box, 0] += sim.skin
        flags = []
        fns = {k: getattr(step, k + ("_plain" if mode == "plain" else ""))
               for k in STEP_KEYS}
        orig = {k: getattr(step, k) for k in STEP_KEYS}

        def kdt(*a, _fn=fns["kick_drift_trigger"], handles=(), **kw):
            # the eager loop's heads: no IF handles to set
            check(not handles, f"{tag}: IF handles in an eager step")
            flag = _fn(*a, **kw)
            flags.append(bool(flag))
            return flag

        into = rb.rebucket_into
        try:
            for k in STEP_KEYS:
                setattr(step, k, kdt if k == "kick_drift_trigger" else fns[k])
            if mode == "plain":
                rb.rebucket_into = rb.rebucket_into_plain
            sim.step_block(2)
        finally:
            for k, fn in orig.items():
                setattr(step, k, fn)
            rb.rebucket_into = into
        st_ = sim.state
        out[mode] = (st_.r.clone(), st_.p.clone(), st_.f.clone(),
                     int(st_.n_local), sim.e_potential, flags,
                     sim.n_rebucket - counters[0])
    for k, v in saved.items():
        sim._bufs[k].copy_(v)
    sim.n_rebucket, sim._rebuckets_read = counters
    sim.cuda_graphs = graphs
    (rk, pk, fk, nk, ek, tk, bk), (rp, pp, fp, np_, ep, tp, bp) = \
        out["kernels"], out["plain"]
    same = (torch.equal(rk, rp) and torch.equal(pk, pp) and
            torch.equal(fk, fp) and nk == np_ and ek == ep and tk == tp
            and bk == bp)
    check(same, f"{tag}: the step through the kernels and through the "
          f"plain versions differ: triggers {tk} / {tp}, n_local {nk} / "
          f"{np_}, ePot {ek!r} / {ep!r}, rebuckets {bk} / {bp}")
    check(tk[0] or not force_rebucket, f"{tag}: the moved baseline did "
          f"not fire the trigger")
    say("step ops", f"{tag}: two steps from one state (triggers {tk}, "
        f"{bk} rebucket(s), the second an energy step) through the kernels "
        f"and through the plain versions: r, p, f, triggers, n_local {nk} "
        f"and ePot {ek:.6f} equal bit for bit")


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """The device ms of one call of ``fn`` without the host's launch cost:
    ``calls`` calls captured into one CUDA graph, replayed ``reps`` times
    between CUDA events (torch.profiler at times keeps no record of a
    short kernel)."""
    import torch
    from comd_tpu_torch.probes import time_ms
    from comd_tpu_torch.stepgraph import cuda_capture
    fn()
    graph, _c, _i = cuda_capture(lambda: [fn() for _ in range(calls)],
                                 torch.cuda.graph_pool_handle())
    return time_ms(graph.replay, reps) / calls


def graph_ms_handles(run, ops, n: int = 2, calls: int = 20,
                     reps: int = 10) -> float:
    """kick_drift_trigger's device ms a launch as the step graph makes it:
    ``calls`` launches (``run(fn, ops)`` with ``fn`` the wrapper) in one
    CUDA graph, each setting the ``n`` handles of a condition made in that
    graph (1: the serial step's, 2: a mesh's), its IF nodes after them (a
    one-kernel body each), replayed ``reps`` times between CUDA events."""
    import torch
    from comd_tpu_torch.ops.cuda import graph_if
    from comd_tpu_torch.ops.cuda import step
    from comd_tpu_torch.probes import time_ms
    from comd_tpu_torch.stepgraph import cuda_capture
    bodies = graph_if.BodyPool("cuda")
    hit = torch.zeros((), dtype=torch.int32, device="cuda")

    def captured():
        cond = graph_if.condition("cuda", n)

        def fn(*a, **kw):
            return step.kick_drift_trigger(*a, handles=cond.handles, **kw)

        for _ in range(calls):
            cond.flag = run(fn, ops)[2]
        for k in range(n):
            graph_if.if_node(cond, k, lambda: hit.add_(1), bodies)

    run(step.kick_drift_trigger, ops)
    graph, _c, _i = cuda_capture(captured, torch.cuda.graph_pool_handle())
    return time_ms(graph.replay, reps) / calls


def _bitwise(got, want) -> bool:
    """Every tensor of ``got`` equals ``want``'s bit for bit (None beside
    None)."""
    import torch
    if isinstance(got, torch.Tensor) or got is None:
        got, want = (got,), (want,)
    return all((a is None) == (b is None) and
               (a is None or (a.dtype == b.dtype and torch.equal(a, b)))
               for a, b in zip(got, want))


def _per_shard(outs):
    """Per-shard results [(out, ...), ...] stacked like a stacked call's."""
    import torch
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(None if outs[0][k] is None
                 else torch.stack([o[k] for o in outs])
                 for k in range(len(outs[0])))


def stacked_k2_f64(device: str = "cuda") -> list:
    """K2's three passes over the stack of a 10^3 f64 2x2x2 mesh (table
    evaluator) against the eight S = 1 launches on the shards' slices bit
    for bit, and against the plain versions at phase 6's f64 tolerance
    (1e-12 of the largest value: the dense outputs hold partial sums near
    zero on halo rows, ``norm_rel``).  K2 adds its j side with atomics, in
    an order that may change from launch to launch: where two runs of the
    S = 1 launches themselves differ in their bits, the stacked launch is
    held to them within 1e-12 of the largest value instead, and the line
    says so.  Returns the lines to print."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops import force_lj
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.potentials.lj import init_lj_pot
    from comd_tpu_torch.sim import stack_of
    sim = init_simulation(Config(
        nx=10, ny=10, nz=10, doeam=True, temperature=600.0, dtype="float64",
        interp_impl="rows", pot_dir=POTS, device=device, **MESH))
    r = stack_of(s.r for s in sim.states)
    nbr, ev = sim.maps.half_nbr_map, sim.pair_eval
    dfe = (0.01 * r[:, 0]).contiguous()
    lj_ev = force_lj.make_lj_evaluator(init_lj_pot(2.5), torch.float64)
    lines = []
    for name, stacked, one, plain in (
            ("K2 EAM pass 1", lambda x: st.eam_pass1_half(x, nbr, ev),
             None, lambda x: st.eam_pass1_half_plain(x, nbr, ev)),
            ("K2 EAM pass 3",
             lambda x, d=dfe: st.eam_pass3_half(x, nbr, ev, d),
             lambda i: st.eam_pass3_half(r[i], nbr, ev, dfe[i]),
             lambda i: st.eam_pass3_half_plain(r[i], nbr, ev, dfe[i])),
            ("K2 LJ", lambda x: st.lj_pass_half(x, nbr, lj_ev), None,
             lambda x: st.lj_pass_half_plain(x, nbr, lj_ev))):
        got = stacked(r)
        if one is None:
            shards = _per_shard([stacked(r[i]) for i in range(len(r))])
            ref = _per_shard([plain(r[i]) for i in range(len(r))])
        else:
            shards = _per_shard([one(i) for i in range(len(r))])
            ref = _per_shard([plain(i) for i in range(len(r))])
        if one is None:
            again = _per_shard([stacked(r[i]) for i in range(len(r))])
        else:
            again = _per_shard([one(i) for i in range(len(r))])
        if r.is_cuda:
            torch.cuda.synchronize()
        got_t = (got,) if isinstance(got, torch.Tensor) else got
        ref_t = (ref,) if isinstance(ref, torch.Tensor) else ref
        sh_t = (shards,) if isinstance(shards, torch.Tensor) else shards
        same = _bitwise(got, shards)
        steady = _bitwise(shards, again)
        d_sh = max(norm_rel(a, b) for a, b in zip(got_t, sh_t)
                   if a is not None)
        check(same or (not steady and d_sh <= 1e-12),
              f"stacked {name} f64: the stacked launch differs from the 8 "
              f"S = 1 launches (rel {d_sh:.3e}; two runs of them equal bit "
              f"for bit: {steady})")
        err = max(norm_rel(a, b) for a, b in zip(got_t, ref_t)
                  if a is not None)
        check(err <= 1e-12, f"stacked {name} f64: rel err {err:.3e} to "
              f"the plain version")
        lines.append(f"{name} f64 (10^3 2x2x2): one launch over the 8 "
                     f"shards against the 8 S = 1 launches: "
                     + ("bit for bit" if same else
                        f"rel {d_sh:.2e} (two runs of the S = 1 launches "
                        f"differ in their bits too: the j side's atomics)")
                     + f"; plain rel err {err:.2e}")
    del sim
    return lines


def run_stacked(sharded, headline, launches_12: dict) -> dict:
    """Phase 23: the one-card mesh's phases as one launch over its stack.
    On phase 12's ki_fused 63^3 f32 2x2x2 state (``sharded``): K1 passes 1
    (with and without energy) and 3 over every cell and over the -a 1
    interior and boundary subsets, the head (kick_drift_trigger, one
    shard displaced past skin/2 so that the or fires), pass 2 (embed_fill,
    with and without energy, the mesh's zero halo rows, on K1's strided
    rhobar) and the landing (two passes, the count of every shard): each
    stacked launch against the 8 launches of S = 1 on the shards' slices
    bit for bit, and against its plain version (the one-shard plain
    version shard by shard) at phase 6's tolerances (K1; the step kernels
    bit for bit).  K2 in f64 on a 10^3 2x2x2 mesh likewise
    (``stacked_k2_f64``).  Timed (CUDA events, mean of 20; the device's
    time in a graph of 20 launches) beside the 8 S = 1 launches and the
    serial launch at 42^3 (phase 5's ``headline`` state, the same cells
    and atoms).  Then the launches (device operations) a step and the
    device's busy ms a step of the lazy 2x2x2 ki_fused and collective,
    -S 0, --halfShell and -a 1 graph steps at 63^3.  ``launches_12``:
    phase 12's counts under ki_fused (the rows' launches)."""
    import types
    import torch
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.ops.cuda import step
    from comd_tpu_torch.probes import time_ms
    from comd_tpu_torch.sim import stack_of
    sim, maps, ev = sharded, sharded.maps, sharded.pair_eval
    S, nl = len(sim.states), sim.geom.n_local

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    r, p, f, n_atoms = (stack_of(getattr(x, k) for x in sim.states)
                        for k in ("r", "p", "f", "n_atoms"))
    B, A = r.shape[2], r.shape[3]
    nbr = maps.nbr_map
    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    e_dtype = sim.cfg.torch_energy_dtype
    chunk = sim.cfg.resolved_box_chunk
    f1, phi, rho = st.eam_pass1(r, nbr, ev)
    dfe, _u = step.embed_fill(sim.f_eval, rho, None, n_atoms, B)
    f3 = st.eam_pass3(r, nbr, ev, dfe)
    last = r.clone()
    last[:, :, :nl] += 1e-2
    last[S - 1, 0, nl // 2, 0] += 2.0 * sim.skin    # the or fires
    hs = headline.state
    h_last = hs.r.clone()
    h_last[:, :headline.geom.n_local] += 1e-2
    dev = r.device
    n_out = torch.zeros((), dtype=torch.int32, device=dev)

    def kdt_prep():
        return p.clone(), r.clone()

    def k1(pass_, boxes=None, energy=False):
        if pass_ == 1:
            return (lambda x: st.eam_pass1(x, nbr, ev, want_energy=energy,
                                           boxes=boxes),
                    lambda i: st.eam_pass1(r[i], nbr, ev,
                                           want_energy=energy, boxes=boxes),
                    lambda i: st.eam_pass1_plain(r[i], nbr, ev,
                                                 want_energy=energy,
                                                 box_chunk=chunk,
                                                 boxes=boxes))
        return (lambda x: st.eam_pass3(x, nbr, ev, dfe, boxes=boxes),
                lambda i: st.eam_pass3(r[i], nbr, ev, dfe[i], boxes=boxes),
                lambda i: st.eam_pass3_plain(r[i], nbr, ev, dfe[i],
                                             box_chunk=chunk, boxes=boxes))
    lines, errs = [], {}
    for name, (stacked, one, plain) in (
            ("K1 pass 1", k1(1)), ("K1 pass 1 energy", k1(1, energy=True)),
            ("K1 pass 3", k1(3)),
            ("K1 pass 1 interior", k1(1, maps.interior)),
            ("K1 pass 1 boundary", k1(1, maps.boundary)),
            ("K1 pass 3 interior", k1(3, maps.interior)),
            ("K1 pass 3 boundary", k1(3, maps.boundary))):
        got = stacked(r)
        shards = _per_shard([one(i) for i in range(S)])
        ref = _per_shard([plain(i) for i in range(S)])
        sync()
        check(_bitwise(got, shards), f"stacked {name}: the stacked launch "
              f"differs from the {S} S = 1 launches")
        got_t = (got,) if isinstance(got, torch.Tensor) else got
        ref_t = (ref,) if isinstance(ref, torch.Tensor) else ref
        e_f = float((got_t[0] - ref_t[0]).abs().max())
        e_s = max([max_rel(a, b) for a, b in zip(got_t[1:], ref_t[1:])
                   if a is not None] or [0.0])
        check(e_f <= 1e-4 and e_s <= 1e-5, f"stacked {name}: force err "
              f"{e_f:.3e}, scalar rel err {e_s:.3e} to the plain version")
        errs[name] = e_f
        lines.append(f"{name}: one launch over the {S} shards equals the "
                     f"{S} S = 1 launches bit for bit; plain |df| "
                     f"{e_f:.2e}, scalars rel {e_s:.2e}")

    # the step kernels: bit for bit with the S = 1 launches and the plain
    def kdt_run(fn_stack, per_shard):
        pa, ra = kdt_prep()
        if per_shard:
            flags = [fn_stack(pa[i], ra[i], f[i], last[i], nl, kick, drift,
                              sim.skin) for i in range(S)]
            flag = torch.stack(flags).any()
        else:
            flag = fn_stack(pa, ra, f, last, nl, kick, drift, sim.skin)
        return pa, ra, flag.reshape(())

    def plain_kdt(pa, ra, fa, la, *a):
        flag = None
        for i in range(S):
            flag = step.kick_drift_trigger_plain(pa[i], ra[i], fa[i], la[i],
                                                 *a, flag, i > 0)
        return flag

    got = kdt_run(step.kick_drift_trigger, False)
    check(_bitwise(got, kdt_run(step.kick_drift_trigger, True)) and
          bool(got[2]), "stacked kick_drift_trigger differs from the S = 1 "
          "launches (or did not fire)")
    check(_bitwise(got, kdt_run(plain_kdt, False)),
          "stacked kick_drift_trigger differs from its plain version")
    lines.append(f"kick_drift_trigger: one launch over the {S} shards "
                 f"(one displaced: the or fires) equals the {S} S = 1 "
                 f"launches and the plain version bit for bit")
    for energy in (False, True):
        ph = phi if energy else None
        got = step.embed_fill(sim.f_eval, rho, ph, n_atoms, B, None, e_dtype)
        shards = _per_shard([step.embed_fill(
            sim.f_eval, rho[i], None if ph is None else ph[i], n_atoms[i],
            B, None, e_dtype) for i in range(S)])
        ref = _per_shard([step.embed_fill_plain(
            sim.f_eval, rho[i], None if ph is None else ph[i], n_atoms[i],
            B, None, e_dtype) for i in range(S)])
        check(_bitwise(got, shards) and _bitwise(got, ref),
              f"stacked embed_fill energy={energy}: differs from the S = 1 "
              f"launches or the plain version")
    lines.append(f"embed_fill (energy and not, zero halo, K1's strided "
                 f"rhobar): one launch equals the {S} S = 1 launches and "
                 f"the plain version bit for bit")

    def land_run(mode):
        fa, pa = f.clone(), p.clone()
        na = torch.zeros((), dtype=torch.int32, device=dev)
        if mode == "stacked":
            step.land(fa, pa, f1, f3, n_atoms, na, nl, kick)
            return fa, pa, na
        total = 0
        for i in range(S):
            (step.land if mode == "one" else step.land_plain)(
                fa[i], pa[i], f1[i], f3[i], n_atoms[i], na, nl, kick)
            total += int(na)
        return fa, pa, torch.tensor(total, dtype=torch.int32, device=dev)

    got = land_run("stacked")
    check(_bitwise(got, land_run("one")) and _bitwise(got, land_run("plain"))
          and int(got[2]) == sim.n_global,
          f"stacked land differs from the S = 1 launches or the plain "
          f"version (n_local {int(got[2])})")
    lines.append(f"land (two passes): one launch equals the {S} S = 1 "
                 f"launches and the plain version bit for bit, n_local "
                 f"{int(got[2]):,} summed over the shards")
    lines += stacked_k2_f64(str(dev))
    for line in lines:
        say("stacked", line)

    # timing: the stacked launch, the S launches of S = 1, the serial one
    h_f1, _hphi, h_rho = st.eam_pass1(hs.r, headline.maps.nbr_map,
                                      headline.pair_eval)
    h_dfe, _hu = step.embed_fill(headline.f_eval, h_rho, None, hs.n_atoms,
                                 hs.r.shape[1])
    h_f3 = st.eam_pass3(hs.r, headline.maps.nbr_map, headline.pair_eval,
                        h_dfe)
    hnl, hev, hnbr = headline.geom.n_local, headline.pair_eval, \
        headline.maps.nbr_map
    pa, ra = kdt_prep()
    hp, hr = hs.p.clone(), hs.r.clone()
    fa = f.clone()
    hfa = hs.f.clone()

    def each(fn):
        return lambda: [fn(i) for i in range(S)]

    timed = {
        "eam_pass1": (
            lambda: st.eam_pass1(r, nbr, ev, want_energy=False),
            each(lambda i: st.eam_pass1(r[i], nbr, ev, want_energy=False)),
            lambda: st.eam_pass1(hs.r, hnbr, hev, want_energy=False),
            lambda: [st.eam_pass1_plain(r[i], nbr, ev, want_energy=False,
                                        box_chunk=chunk) for i in range(S)]),
        "eam_pass3": (
            lambda: st.eam_pass3(r, nbr, ev, dfe),
            each(lambda i: st.eam_pass3(r[i], nbr, ev, dfe[i])),
            lambda: st.eam_pass3(hs.r, hnbr, hev, h_dfe),
            lambda: [st.eam_pass3_plain(r[i], nbr, ev, dfe[i],
                                        box_chunk=chunk) for i in range(S)]),
        "kick_drift_trigger": (
            lambda: step.kick_drift_trigger(pa, ra, f, last, nl, kick,
                                            drift, sim.skin),
            each(lambda i: step.kick_drift_trigger(
                pa[i], ra[i], f[i], last[i], nl, kick, drift, sim.skin)),
            lambda: step.kick_drift_trigger(hp, hr, hs.f, h_last, hnl, kick,
                                            drift, headline.skin),
            lambda: plain_kdt(pa, ra, f, last, nl, kick, drift, sim.skin)),
        "embed_fill": (
            lambda: step.embed_fill(sim.f_eval, rho, None, n_atoms, B),
            each(lambda i: step.embed_fill(sim.f_eval, rho[i], None,
                                           n_atoms[i], B)),
            lambda: step.embed_fill(headline.f_eval, h_rho, None,
                                    hs.n_atoms, hs.r.shape[1]),
            lambda: [step.embed_fill_plain(sim.f_eval, rho[i], None,
                                           n_atoms[i], B)
                     for i in range(S)]),
        "land": (
            lambda: step.land(fa, pa, f1, f3, n_atoms, n_out, nl, kick),
            each(lambda i: step.land(fa[i], pa[i], f1[i], f3[i],
                                     n_atoms[i], n_out, nl, kick)),
            lambda: step.land(hfa, hp, h_f1, h_f3, hs.n_atoms, n_out, hnl,
                              kick),
            lambda: [step.land_plain(fa[i], pa[i], f1[i], f3[i],
                                     n_atoms[i], n_out, nl, kick, add=i > 0)
                     for i in range(S)])}
    es = r.element_size()
    slots, local = 3 * B * A, 3 * nl * A
    step_bytes = {     # a shard's, as phase 19's (each read and write once)
        "kick_drift_trigger": es * (3 * slots + local + 2 * slots) + 1,
        "embed_fill": es * (nl * A + B * A) + (sim.f_eval.n + 4) * es,
        "land": es * (2 * local + 3 * slots) + 4 * nl + 4}
    rows = {}
    for key, (stacked, ones, serial, plain) in timed.items():
        ms = time_ms(stacked, 20)
        g_ms = graph_ms(stacked)
        ones_ms, ones_g = time_ms(ones, 20), graph_ms(ones)
        ser_ms, ser_g = time_ms(serial, 20), graph_ms(serial)
        plain_ms = time_ms(plain, 2)
        if key.startswith("eam_pass"):
            b_ms = sum(bound(types.SimpleNamespace(
                state=x, pair_eval=ev, geom=sim.geom, maps=maps), key)[0]
                for x in sim.states)
            b_by = "operations"
        else:
            b_ms = 1e3 * S * step_bytes[key] / PEAK_BYTES
            b_by = "bytes"
        say("timing", f"stacked {key} over {S} shards (63^3 2x2x2 f32): "
            f"{ms:.4f} ms a call (CUDA events, mean of 20), {g_ms:.4f} ms "
            f"in a graph of 20; {S} launches of S = 1 {ones_ms:.4f} "
            f"({ones_g:.4f} in a graph); the serial launch at 42^3 "
            f"{ser_ms:.4f} ({ser_g:.4f}); plain version {plain_ms:.4f}; "
            f"bound {b_ms:.4f} ms ({b_by}, the {S} shards' sum)")
        err = errs.get("K1 pass 1" if key == "eam_pass1" else
                       "K1 pass 3", 0.0) if key.startswith("eam") else 0.0
        rows[f"stacked_{key}"] = {
            "name": f"stacked_{key}", "route": "cuda",
            "source": SOURCE if key.startswith("eam") else STEP_SOURCE,
            "replaces": (REPLACES["stencil"] + " (every shard of the mesh "
                         "in one launch: comd_tpu's shard_map)"
                         if key.startswith("eam") else REPLACES[key]),
            "launches": launches_12[key], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "ms_graph": g_ms, "ms_shard_launches": ones_g,
            "ms_serial_42": ser_g}
    del pa, ra, fa, hp, hr, hfa
    torch.cuda.empty_cache()

    # the launches a step of the mesh's graph steps
    for tag, kw in (("ki_fused", dict(comm_impl="ki_fused")),
                    ("collective", dict(comm_impl="collective")),
                    ("-S 0 collective", dict(comm_impl="collective",
                                             lazy_shell=False)),
                    ("--halfShell collective", dict(comm_impl="collective",
                                                    half_shell=True)),
                    ("-a 1 ki_fused", dict(comm_impl="ki_fused",
                                           gpu_async=1))):
        busy, ops, ms = mesh_graph_ops(**kw)
        say("stacked", f"2x2x2 {tag} graph step at 63^3: {ops:.2f} device "
            f"operations a step, device busy {busy:.4f} ms a step, "
            f"{ms:.4f} ms/step (20 steps after the first rebucket)")
    return rows


def mesh_graph_ops(**kw) -> tuple:
    """(busy ms a step, device operations a step, ms/step) of the 63^3
    EAM 2x2x2 graph step with ``kw``: warmed through its first rebucket,
    then 20 steps timed by the host clock and 20 under torch.profiler."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    n = HEADLINE_N
    sim = init_simulation(Config(
        nx=n, ny=n, nz=n, temperature=600.0, dtype="float32", max_atoms=0,
        cell_mode="auto", pot_dir=POTS, device="cuda", doeam=True, **MESH,
        **kw))
    for _ in range(20):
        sim.step_block(10)
        if sim.n_rebucket:
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step_block(20)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 20
    busy, ops = device_busy_ms(sim, 2, 10)
    check(sim.sum_atoms() == sim.n_global and not sim.overflow,
          f"mesh graph step {kw}: atoms lost or overflow")
    del sim
    torch.cuda.empty_cache()
    return busy, ops, ms


def run_step_ops(headline, launches: dict) -> dict:
    """Phase 19: csrc/step.cu's four kernels against their plain versions,
    bit for bit, at the 63^3 headline state (f32) and at a thermalized
    10^3 state (f64); a full step through the kernels against the plain
    versions at both, a refresh step and a rebucket step; the kernels
    timed at the headline state (``graph_ms``, and a call from the host,
    CUDA events) beside their plain versions and byte bounds.  ``headline``: phase
    5's simulation; ``launches``: phase 5's counts.  Returns the
    kernels-line rows."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import step
    from comd_tpu_torch.probes import time_ms
    small = init_simulation(Config(
        nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
        dtype="float64", interp_impl="rows", pot_dir=POTS, device="cuda"))
    small.step_block(10)
    errs = {}
    for sim, tag in ((headline, f"{HEADLINE_N}^3 float32"),
                     (small, "10^3 float64")):
        errs.update(check_step_ops(sim, tag))
        for force in (False, True):
            full_step_pair(sim, f"{tag} {'rebucket' if force else 'refresh'}"
                           f" step", force)
    del small
    rows = {}
    peak = PEAK_F32_FLOPS
    for name, key, prep, run, n_bytes, flops in step_op_cases(headline):
        if name.startswith("kick_drift_trigger at"):
            continue
        ops = prep()           # updated in place call after call

        def kernel():
            return run(getattr(step, key), ops)

        def plain():
            return run(getattr(step, key + "_plain"), ops)

        calls_ms, plain_ms = time_ms(kernel, 20), time_ms(plain, 20)
        ms = graph_ms(kernel)
        extra = ""
        if key == "kick_drift_trigger":
            # the step's launch sets the IF handles: its time with them
            # (the serial step's one with images, a mesh's two without)
            n = 1 if "images" in name else 2
            no_handles, ms = ms, graph_ms_handles(run, ops, n)
            extra = (f" with the {n} IF handle(s) set ({n} IF node(s) "
                     f"after the 20; {no_handles:.5f} ms without handles)")
        elif key == "embed_fill":
            a = int(name.split("A=")[1]) if "A=" in name else \
                headline.state.r.shape[2]
            e_elem = (torch.finfo(headline.cfg.torch_energy_dtype).bits // 8
                      if "energy=True" in name else None)
            w = step.embed_width(a, headline.state.r.element_size(), [],
                                 e_elem)
            form = f"{w}-slot 16-byte vectors" if w > 1 else "one slot"
            extra = f" ({form} a thread, A={a})"
        b_ms = 1e3 * max(n_bytes / PEAK_BYTES, flops / peak)
        by = "bytes" if n_bytes / PEAK_BYTES >= flops / peak else \
            "operations"
        say("timing", f"{name} at {HEADLINE_N}^3 f32: {ms:.5f} ms a launch "
            f"replayed in a graph of 20{extra} (CUDA events; the bound at "
            f"{b_ms / ms:.0%} of it), {calls_ms:.4f} ms a call from the host "
            f"(CUDA events, mean of 20: the wrapper's host time when above "
            f"the kernel's); plain {plain_ms:.4f} ms a call; bound "
            f"{b_ms:.5f} ms ({by}: {n_bytes / 1e6:.2f} MB, "
            f"{flops / 1e6:.2f} Mflop); {launches[key]} launches in phase "
            f"5's run")
        # the kernels line: the main path's calls (no energy: 99 of 100
        # steps; the head with images, the halo fill)
        if name in ("kick_drift_trigger images", "refresh_halo fill",
                    "embed_fill energy=False serial=True",
                    "land passes=2"):
            rows[key] = {
                "name": key, "route": "cuda", "source": STEP_SOURCE,
                "replaces": REPLACES[key], "launches": launches[key],
                "max_abs_err": max(v for k, v in errs.items()
                                   if k.startswith(key)),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": by, "library_ms": None}
    say("timing", "no single PyTorch call computes one of the four (a "
        "kick, a drift, a max and the ghost images; a gather plus a shift "
        "and two copies; an interpolation with a fill and a mask; a sum, a "
        "copy and a kick): library_ms none")
    return rows


REBUCKET_SOURCE = "comd_tpu_torch/csrc/rebucket.cu"
REBUCKET_KEYS = ("rebucket_bin", "rebucket_place")
# the place launch's kernel by form (rebucket.place_form)
RB_PLACE_NAME = {"warp": "rebucket_place_warp_kernel",
                 "block": "rebucket_place_kernel"}
# the kernels' ms a launch before their redesigns, in the serial body at
# 63^3 f32 (this script on an NVIDIA H100 80GB HBM3 at 700 W): the place
# launch in the block form (a thread a slot, 16 cells a block)
REBUCKET_EARLIER_MS = {"rebucket_bin": 0.02906, "rebucket_place": 0.08973}
RB_CUT = 4.0          # the synthetic grids' least cell edge


def rb_displaced(s, n_local: int, extent, seed: int, scale: float) -> list:
    """Clones of state ``s``'s r, p, gid, n_atoms with every valid local
    atom displaced by uniform(-scale, scale) per axis (numpy, seeded) and,
    given the periodic ``extent``, ten of them put on its faces and just
    across: 0, L, -1e-7, the float below L, the float above L, 2L, -L,
    -0, L + L, 1e-30."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    r = s.r.clone()
    A = r.shape[2]
    valid = torch.arange(A, device=r.device)[None, :] < \
        s.n_atoms[:n_local, None]
    d = torch.as_tensor(rng.uniform(-scale, scale, (3, n_local, A)),
                        dtype=r.dtype, device=r.device)
    r[:, :n_local] += torch.where(valid[None], d, torch.zeros_like(d))
    if extent is not None:
        dt = np.float32 if r.dtype == torch.float32 else np.float64
        cells, slots = (t.cpu().numpy() for t in torch.nonzero(
            valid, as_tuple=True))
        for k, i in enumerate(rng.choice(len(cells), 10, replace=False)):
            L = dt(float(extent[k % 3]))
            v = (dt(0), L, dt(-1e-7), np.nextafter(L, dt(0)),
                 np.nextafter(L, dt(2 * L)), dt(2) * L, -L, dt(-0.0),
                 L + L, dt(1e-30))[k]
            r[k % 3, int(cells[i]), int(slots[i])] = float(v)
    return [r, s.p.clone(), s.gid.clone(), s.n_atoms.clone()]


def rb_synthetic(lo, hi, A: int, dtype: str, seed: int,
                 use_hilbert: bool = False, spread: float = 0.75,
                 crowd: int = 0) -> tuple:
    """A domain [lo, hi) (cells of edge >= RB_CUT) and its cells of
    capacity ``A`` on the card: up to A/2 atoms a local cell (gids unique
    and shuffled), each within ``spread`` cell edges of its cell's centre
    per axis, junk in the other slots; ``crowd`` atoms of other cells
    moved into local cell 5.  Returns (geom, maps, [r, p, gid,
    n_atoms])."""
    import numpy as np
    import torch
    from comd_tpu_torch.cells import make_geometry
    from comd_tpu_torch.ops import binning
    rng = np.random.default_rng(seed)
    geom = make_geometry(lo, hi, RB_CUT, use_hilbert=use_hilbert)
    B, nl = geom.n_total, geom.n_local
    counts = rng.integers(0, A // 2 + 1, size=nl)
    r = rng.uniform(-50.0, 50.0, size=(3, B, A))
    p = rng.standard_normal((3, B, A))
    gid = rng.integers(0, 2 ** 30, size=(B, A))
    n_atoms = rng.integers(0, A + 1, size=B)
    n_atoms[:nl] = counts
    ids = rng.permutation(4 * int(counts.sum()))
    centre = np.asarray(lo)[:, None] + (geom.tuple_of_box[:nl].T + 0.5) * \
        geom.box_size[:, None]
    occ = []
    for c in range(nl):
        for k in range(counts[c]):
            gid[c, k] = ids[len(occ)]
            r[:, c, k] = centre[:, c] + rng.uniform(
                -spread, spread, size=3) * geom.box_size
            occ.append((c, k))
    if crowd:
        occ = [o for o in occ if o[0] != 5]
        for i in rng.choice(len(occ), size=crowd, replace=False):
            r[:, occ[i][0], occ[i][1]] = centre[:, 5] + rng.uniform(
                -0.4, 0.4, size=3) * geom.box_size
    dt = getattr(torch, dtype)
    maps = binning.geom_maps(geom, dt, "cuda")
    return geom, maps, [torch.as_tensor(r, dtype=dt, device="cuda"),
                        torch.as_tensor(p, dtype=dt, device="cuda"),
                        torch.as_tensor(gid, dtype=torch.int32,
                                        device="cuda"),
                        torch.as_tensor(n_atoms, dtype=torch.int32,
                                        device="cuda")]


def rb_cases(headline) -> list:
    """Phase 19's rebucket cases: (name, geom, maps, fields, wrap extent,
    keep_halo).  The 63^3 f32 headline and a thermalized 10^3 f64 state
    displaced by up to 1 A (the lattice's outer planes lie 0.90 A inside
    the box) across cell faces and the periodic boundary (some atoms on
    its faces), a wrap extent past a synthetic domain (halo landers folded
    back under the wrap), a shard of the 2x2x2 mesh (10^3 f64, keep_halo,
    atoms across its faces), a Hilbert grid, an odd A and A = 40, a cell
    of A < n <= C atoms and one of n > C."""
    import numpy as np
    from comd_tpu_torch import Config, init_simulation
    cases = []
    s = headline.state
    cases.append((f"{HEADLINE_N}^3 float32", headline.geom, headline.maps,
                  rb_displaced(s, headline.geom.n_local,
                               headline.global_extent, 31, 1.0),
                  headline._extent, False))
    small = init_simulation(Config(
        nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
        dtype="float64", interp_impl="rows", pot_dir=POTS, device="cuda"))
    small.step_block(10)
    cases.append(("10^3 float64", small.geom, small.maps,
                  rb_displaced(small.state, small.geom.n_local,
                               small.global_extent, 32, 1.0),
                  small._extent, False))
    mesh = init_simulation(Config(
        nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
        dtype="float64", interp_impl="rows", pot_dir=POTS, device="cuda",
        **MESH))
    mesh.step_block(10)
    cases.append(("2x2x2 shard float64 keep_halo", mesh.geom, mesh.maps,
                  rb_displaced(mesh.states[0], mesh.geom.n_local, None, 33,
                               1.2), None, True))
    for dtype in ("float32", "float64"):
        g, m, f = rb_synthetic(np.zeros(3), np.full(3, 5 * RB_CUT), 16,
                               dtype, 34, spread=0.9)
        cases.append((f"fold {dtype}", g, m, f, np.full(3, 5.5 * RB_CUT),
                       False))
    g, m, f = rb_synthetic(np.zeros(3), np.full(3, 8.3 * RB_CUT), 16,
                           "float32", 35, use_hilbert=True)
    check(g.use_hilbert, "the Hilbert case's grid is not Hilbert-numbered")
    cases.append(("Hilbert 8^3 float32", g, m, f, np.full(3, 8.3 * RB_CUT),
                  False))
    ext = np.array([3.1, 4.3, 3.6]) * RB_CUT
    for A, dtype in ((13, "float32"), (40, "float64")):
        g, m, f = rb_synthetic(np.zeros(3), ext, A, dtype, 36 + A)
        cases.append((f"A={A} {dtype}", g, m, f, ext, False))
    for name, n in (("overflow A < n <= C", 17), ("overflow n > C", 48)):
        # every atom within its own cell: the crowded cell holds its own
        # (up to A/2) and the n moved there
        g, m, f = rb_synthetic(np.zeros(3), ext, 16, "float32", 37,
                               spread=0.4, crowd=n)
        cases.append((f"{name} float32", g, m, f, ext, False))
    return cases


def rb_check(name, geom, maps, f, ext, keep) -> float:
    """One case: both kernels (one launch each) against rebucket_plain on
    the same CUDA tensors, bit for bit in every cell of at most C atoms;
    the counts, n_migrating and the flag in every case; and, serially,
    the in-place body (rebucket_into: the baseline's local rows, the flag
    or-ed) against its plain version.  Returns (max |kernel - plain| over
    the floats of the cells held (0), n_migrating, the flag, the cells
    past C)."""
    import torch
    from comd_tpu_torch.ops.cuda import LAUNCHES
    from comd_tpu_torch.ops.cuda import rebucket as rb
    n0 = [LAUNCHES[k] for k in REBUCKET_KEYS]
    got = rb.rebucket(geom, maps, *f, wrap_extent=ext, keep_halo=keep)
    check([LAUNCHES[k] for k in REBUCKET_KEYS] == [n + 1 for n in n0],
          f"rebucket {name}: not one launch of each kernel")
    want = rb.rebucket_plain(geom, maps, *f, wrap_extent=ext,
                             keep_halo=keep)
    ok = want[3] <= rb.stage_capacity(f[0].shape[2])
    for a, b in zip(got[3:], want[3:]):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"rebucket {name}: counts, n_migrating or the flag differ")
    err = 0.0
    for a, b in zip(got[:3], want[:3]):
        a, b = a[..., ok, :], b[..., ok, :]
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"rebucket {name}: kernels and plain version differ")
        if a.is_floating_point():
            err = max(err, float((a - b).abs().max()))
    if ext is not None and not keep:
        outs = []
        for fn in (rb.rebucket_into, rb.rebucket_into_plain):
            t = [x.clone() for x in f]
            last = torch.full_like(t[0], 7.0)
            ovf = torch.zeros((), dtype=torch.bool, device="cuda")
            fn(geom, maps, *t, ovf, wrap_extent=ext, last_r=last)
            outs.append([t[0][..., ok, :], t[1][..., ok, :],
                         t[2][..., ok, :], t[3], last[..., ok, :], ovf])
        check(all(torch.equal(a, b) for a, b in zip(*outs)),
              f"rebucket {name}: the in-place body differs from its plain "
              f"version")
    return err, int(want[4]), bool(want[5]), int((~ok).sum())


def kernel_us(fn, names, reps: int = 20) -> dict:
    """{name: mean device us of one launch} of the kernels whose names hold
    ``names`` over ``reps`` calls of ``fn`` under torch.profiler (the mean
    of the records it keeps; profiled again, eight times at most, while a
    name has none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    out = {}
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            for n in names:
                if n in e.key and e.count and n not in out:
                    us = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                    out[n] = us / e.count
        if set(out) == set(names):
            break
    check(set(out) == set(names), f"torch.profiler kept no record of "
          f"{set(names) - set(out)}")
    return out


def run_rebucket(headline, launches: dict) -> dict:
    """Phase 19's redistribution: csrc/rebucket.cu's bin and place launches
    against rebucket_plain in every case of ``rb_cases``; then, at the
    63^3 headline state, the serial body (rebucket_into and the halo
    fill) timed (CUDA events, mean of 20; a launch of each kernel under
    torch.profiler) beside its plain version and the byte bounds.
    ``launches``: phase 5's counts.  Returns the kernels-line rows."""
    import torch
    from comd_tpu_torch.ops.cuda import rebucket as rb
    from comd_tpu_torch.ops.cuda import step
    from comd_tpu_torch.probes import time_ms
    err = 0.0
    for name, geom, maps, f, ext, keep in rb_cases(headline):
        e, n_mig, ovf, big = rb_check(name, geom, maps, f, ext, keep)
        err = max(err, e)
        if keep:
            check(n_mig > 0, f"rebucket {name}: no atom left the shard")
        if name.startswith("overflow"):
            check(ovf and (big > 0) == name.endswith("> C float32"),
                  f"rebucket {name}: flag {ovf}, {big} cells past C")
        say("rebucket", f"{name}: kernels and plain version equal bit for "
            f"bit" + (f" outside the {big} cell(s) past C (counts, "
                      f"n_migrating and the flag equal)" if big else "")
            + f"; n_migrating {n_mig}, overflow {ovf}"
            + (", the in-place body too" if ext is not None and not keep
               else ""))
    # the serial body at the headline state, as the lazy step runs it
    sim = headline
    s, geom, maps, ext = sim.state, sim.geom, sim.maps, sim._extent
    f = [s.r.clone(), s.p.clone(), s.gid.clone(), s.n_atoms.clone()]
    last = s.r.clone()
    ovf = torch.zeros((), dtype=torch.bool, device="cuda")

    def body():
        rb.rebucket_into(geom, maps, *f, ovf, wrap_extent=ext, last_r=last)
        step.refresh_halo(geom, maps, f[0], f[2], f[3])

    def body_plain():
        rb.rebucket_into_plain(geom, maps, *f, ovf, wrap_extent=ext,
                               last_r=last)
        step.refresh_halo_plain(geom, maps, f[0], f[2], f[3])

    B, A = f[0].shape[1:]
    form = rb.place_form(A)
    body_ms, plain_body_ms = time_ms(body, 20), time_ms(body_plain, 20)
    body_graph = graph_ms(body)
    plain_ms = time_ms(lambda: rb.rebucket_plain(
        geom, maps, *f, wrap_extent=ext), 20)
    us = kernel_us(body, ("rebucket_bin_kernel", RB_PLACE_NAME[form],
                          "refresh_halo_kernel"))
    nl = geom.n_local
    n_valid = int(f[3][:nl].clamp(max=A).sum())
    n_bytes = rb_bytes(f[0], n_valid, nl, nl, True)
    body_bytes = n_bytes["rebucket_bin"] + n_bytes["rebucket_place"] - \
        2 * (atom_bytes(f[0]) * n_valid + 4 * nl)
    # the other form on the same input (the block form takes any A), for
    # the comparison only: its launches are not the main path's
    other = rb_other_form(geom, maps, f, ext, False, form)
    rows = {}
    for key, name in zip(REBUCKET_KEYS, ("rebucket_bin_kernel",
                                         RB_PLACE_NAME[form])):
        b_ms = 1e3 * n_bytes[key] / PEAK_BYTES
        ms = us[name] / 1e3
        say("timing", f"{key} at {HEADLINE_N}^3 f32 (the serial body"
            + (f", the {form} form at A = {A}" if key == "rebucket_place"
               else "") + f"): {ms:.5f} ms a launch (torch.profiler, mean "
            f"of 20; the bound at {b_ms / ms:.0%} of it; before "
            f"{REBUCKET_EARLIER_MS[key]:.5f} ms on an H100 at 700 W); bound "
            f"{b_ms:.5f} ms (bytes: {n_bytes[key] / 1e6:.2f} MB); plain "
            f"version (rebucket_plain, both kernels' function) "
            f"{plain_ms:.4f} ms; {launches[key]} launches in phase 5's run")
        rows[key] = {
            "name": key, "route": "cuda", "source": REBUCKET_SOURCE,
            "replaces": REPLACES[key], "launches": launches[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None}
    rows["rebucket_place"]["form"] = form
    if other is not None:
        b_ms = rows["rebucket_place"]["bound_ms"]
        say("timing", f"rebucket_place in the {other} form on the same "
            f"input: {rb_form_ms(other, body):.5f} ms a launch (torch."
            f"profiler, mean of 20; the bound {b_ms:.5f}), the {form} form "
            f"{rows['rebucket_place']['ms']:.5f}; the same bits")
    b_ms = 1e3 * body_bytes / PEAK_BYTES
    say("timing", f"the serial redistribution at {HEADLINE_N}^3 f32 "
        f"(rebucket_into + refresh_halo: {n_valid} atoms, B={B}, A={A}): "
        f"{body_ms:.4f} ms a call (CUDA events, mean of 20), "
        f"{body_graph:.5f} ms replayed in a graph of 20; bin "
        f"{us['rebucket_bin_kernel']:.2f} + place "
        f"{us[RB_PLACE_NAME[form]]:.2f} + halo fill "
        f"{us['refresh_halo_kernel']:.2f} us (torch.profiler); plain "
        f"{plain_body_ms:.4f} ms; bound {b_ms:.5f} ms (bytes: "
        f"{body_bytes / 1e6:.2f} MB, the body at {b_ms / body_graph:.0%})")
    rb_shard_timing()
    say("timing", "no single PyTorch call bins, orders and scatters atoms "
        "into cells: library_ms none")
    return rows


def atom_bytes(r) -> int:
    """r, p and gid of an atom."""
    return 6 * r.element_size() + 4


def rb_bytes(r, n_valid: int, nl: int, max_box: int, baseline: bool) -> dict:
    """The least bytes of each rebucket kernel: the bin reads the valid
    local slots and the counts and writes a record an atom and the
    counters; the place reads the records and the counters and writes
    every slot of the B cells, the baseline's local rows and the
    counts."""
    B, A = r.shape[1:]
    atom = atom_bytes(r)
    return {"rebucket_bin": 2 * (atom * n_valid + 4 * nl),
            "rebucket_place": atom * n_valid + 4 * max_box + atom * B * A
            + (3 * r.element_size() * nl * A if baseline else 0) + 4 * B}


def rb_other_form(geom, maps, f, ext, keep: bool, form: str):
    """The place launch's other form (the block form, which takes any A)
    on ``f``: the same bits as the chosen form, or None where the chosen
    form is the block form."""
    import torch
    from comd_tpu_torch.ops.cuda import rebucket as rb
    if form != "warp":
        return None
    got = rb.rebucket(geom, maps, *f, wrap_extent=ext, keep_halo=keep)
    chosen = rb.place_form
    rb.place_form = lambda _a: "block"
    try:
        want = rb.rebucket(geom, maps, *f, wrap_extent=ext,
                           keep_halo=keep)
    finally:
        rb.place_form = chosen
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "rebucket_place: the block form differs from the warp form")
    return "block"


def rb_form_ms(form: str, fn) -> float:
    """ms a launch of the place launch in ``form`` over calls of ``fn``
    (torch.profiler, mean of 20)."""
    from comd_tpu_torch.ops.cuda import rebucket as rb
    chosen = rb.place_form
    rb.place_form = lambda _a: form
    try:
        return kernel_us(fn, (RB_PLACE_NAME[form],))[RB_PLACE_NAME[form]] \
            / 1e3
    finally:
        rb.place_form = chosen


def rb_shard_timing() -> None:
    """rebucket_bin and rebucket_place at a shard of the 63^3 2x2x2 mesh
    (23^3 cells, halo landers kept) displaced by up to 0.5 A: bit for bit
    with rebucket_plain, both place forms timed (torch.profiler, mean of
    20) beside the byte bounds."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import rebucket as rb
    n = HEADLINE_N
    mesh = init_simulation(Config(
        nx=n, ny=n, nz=n, doeam=True, temperature=600.0, dtype="float32",
        max_atoms=0, cell_mode="auto", pot_dir=POTS, device="cuda",
        **MESH))
    geom, maps = mesh.geom, mesh.maps
    f = rb_displaced(mesh.states[0], geom.n_local, None, 38, 0.5)
    name = f"{n}^3 2x2x2 shard float32 keep_halo"
    rb_check(name, geom, maps, f, None, True)
    B, A = f[0].shape[1:]
    form = rb.place_form(A)
    other = rb_other_form(geom, maps, f, None, True, form)

    def launch():
        rb.rebucket(geom, maps, *f, keep_halo=True)

    us = kernel_us(launch, ("rebucket_bin_kernel", RB_PLACE_NAME[form]))
    nl = geom.n_local
    n_valid = int(f[3][:nl].clamp(max=A).sum())
    n_bytes = rb_bytes(f[0], n_valid, nl, geom.n_total, False)
    b_bin, b_place = (1e3 * n_bytes[k] / PEAK_BYTES for k in REBUCKET_KEYS)
    say("timing", f"rebucket at a {name} ({n_valid} atoms, B={B}, A={A}): "
        f"bin {us['rebucket_bin_kernel'] / 1e3:.5f} ms (bound {b_bin:.5f}), "
        f"place in the {form} form {us[RB_PLACE_NAME[form]] / 1e3:.5f} ms"
        + (f", in the {other} form {rb_form_ms(other, launch):.5f} ms"
           if other else "") + f" (bound {b_place:.5f}, bytes: "
        f"{n_bytes['rebucket_place'] / 1e6:.2f} MB) a launch (torch."
        f"profiler, mean of 20); the kernels equal rebucket_plain bit for "
        f"bit")
    del mesh, f
    torch.cuda.empty_cache()


ARRIVALS_SOURCE = "comd_tpu_torch/csrc/arrivals.cu"
ARRIVALS_KEYS = ("arrivals_bin", "arrivals_place", "sort_cells")
# each kernel's ms a launch before its latest redesign, at phase 20's 63^3
# f32 2x2x2 ki state (this script on an NVIDIA H100 80GB HBM3 at 700 W):
# the bin loading a slot after its mask, the list in per-warp segments
# that the place launch read in groups, the sort in the block form
ARRIVALS_EARLIER_MS = {"arrivals_bin": 0.00722, "arrivals_place": 0.00960,
                       "sort_cells": 0.05972}


def av_fields(sim, seed: int, scale: float) -> list:
    """Every shard of the mesh ``sim`` with its valid local atoms displaced
    by uniform(-scale, scale) per axis (numpy, seeded) and rebucketed with
    the halo landers kept (csrc/rebucket.cu): (r, p, gid, n_atoms)
    lists, the exchange's input."""
    import numpy as np
    import torch
    from comd_tpu_torch.ops import binning
    rng = np.random.default_rng(seed)
    nl = sim.geom.n_local
    reb = []
    for s in sim.states:
        A = s.r.shape[2]
        r = s.r.clone()
        valid = torch.arange(A, device="cuda")[None, :] < \
            s.n_atoms[:nl, None]
        d = torch.as_tensor(rng.uniform(-scale, scale, (3, nl, A)),
                            dtype=r.dtype, device="cuda")
        r[:, :nl] += torch.where(valid[None], d, torch.zeros_like(d))
        reb.append(binning.rebucket(sim.geom, sim.maps, r, s.p, s.gid,
                                    s.n_atoms, keep_halo=True)[:4])
    return [list(f) for f in zip(*reb)]


def av_stage_stats(before, after, arrivals, A: int) -> dict:
    """What one stage's unload had to do, from its plain result: the valid
    arrivals, the cells that got some, the slots stored (below A) and the
    cells past C."""
    import torch
    from comd_tpu_torch.ops.cuda import arrivals as av
    C = av.stage_capacity(A)
    n_valid = cells = stored = past = 0
    for s, dirs in enumerate(arrivals):
        for a in dirs:
            n_valid += int(av._flat(a, A)[3].sum())
        n0, n1 = before[3][s], after[3][s]
        k = n1 - n0
        cells += int((k > 0).sum())
        past += int((k > C).sum())
        stored += int(torch.minimum((A - n0).clamp(min=0), k).sum())
    return dict(valid=n_valid, cells=cells, stored=stored, past=past)


def av_chain(name, h, fields, transport: str) -> dict:
    """Phase 20: the three stages of the atom exchange from ``fields``
    under ``transport`` ("ki": the sender's counts where ring_push left
    them; "collective": a flag an entry, full planes or count-packed as
    the halo's plan says), each stage's unload on csrc/arrivals.cu's bin
    and place launches against append_stage_plain on the same CUDA
    tensors, bit for bit in every cell of at most C arrivals (past C the
    counts and the flag), one launch of each a stage; then the sort of
    every shard (one launch) against sort_shards_plain.  Returns the
    stages ((state before, arrivals, shifts), stats), the exchanged
    fields before the sort and the largest |kernel - plain| (0)."""
    import torch
    from comd_tpu_torch.ops.cuda import LAUNCHES
    from comd_tpu_torch.ops.cuda import arrivals as av
    from comd_tpu_torch.parallel import exchange, ki_comm
    A = fields[0][0].shape[2]
    f = [[t.clone() for t in x] for x in fields]
    ovf = torch.zeros((), dtype=torch.bool, device="cuda")
    stages, err = [], 0.0
    for axis in range(3):
        arr = (ki_comm.push_arrivals(h, axis, f) if transport == "ki"
               else exchange.atom_arrivals(h, axis, *f, ovf))
        before = [[t.clone() for t in x] for x in f]
        plain = [[t.clone() for t in x] for x in f]
        ovf_p = ovf.clone()
        shifts = (-h.ext[axis], h.ext[axis])
        n0 = [LAUNCHES[k] for k in ARRIVALS_KEYS[:2]]
        av.append_stage(h.geom, h.maps, *f, arr, ovf, axis, shifts)
        check([LAUNCHES[k] for k in ARRIVALS_KEYS[:2]] == [n + 1 for n in n0],
              f"arrivals {name}: not one bin and one place launch a stage")
        n_list = av.list_length(f[0][0].device)
        av.append_stage_plain(h.geom, h.maps, *plain, arr, ovf_p, axis,
                              shifts)
        stats = av_stage_stats(before, plain, arr, A)
        stats["list"] = n_list
        check(n_list == stats["cells"],
              f"arrivals {name} stage {axis}: the place launch's list holds "
              f"{n_list} cells, the plain version gave {stats['cells']} "
              f"cells arrivals")
        C = av.stage_capacity(A)
        check(torch.equal(ovf, ovf_p) and all(
            torch.equal(a, b) for a, b in zip(f[3], plain[3])),
            f"arrivals {name} stage {axis}: counts or the flag differ")
        for s in range(len(f[0])):
            ok = plain[3][s] - before[3][s] <= C
            for a, b in zip((x[s] for x in f[:3]), (x[s] for x in plain[:3])):
                a, b = a[..., ok, :], b[..., ok, :]
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"arrivals {name} stage {axis} shard {s}: kernels and "
                      f"plain version differ")
                if a.is_floating_point():
                    err = max(err, float((a - b).abs().max()))
        stages.append(((before, arr, axis, shifts), stats))
        f = plain              # past C the two may differ: go on from one
    exchanged = [[t.clone() for t in x] for x in f]
    want = [[t.clone() for t in x] for x in f[:3]]
    av.sort_shards_plain(*want)
    n0 = LAUNCHES["sort_cells"]
    av.sort_shards(*f[:3])
    check(LAUNCHES["sort_cells"] == n0 + 1,
          f"arrivals {name}: not one sort launch")
    check(all(torch.equal(a, b) for x, y in zip(f[:3], want)
              for a, b in zip(x, y)),
          f"arrivals {name}: the sort differs from sort_shards_plain")
    moved = sum(st[1]["valid"] for st in stages)
    check(moved > 0, f"arrivals {name}: no arrival")
    say("arrivals", f"{name}: the three stages' bin and place launches and "
        f"the sort equal the plain versions bit for bit; "
        + ", ".join(f"stage {i}: {st[1]['valid']} arrivals into "
                    f"{st[1]['cells']} cells (the list's length "
                    f"{st[1]['list']}), {st[1]['stored']} stored"
                    for i, st in enumerate(stages))
        + f"; overflow {bool(ovf)}")
    return dict(stages=stages, exchanged=exchanged, err=err)


def av_crowd(dtype: str, n: int) -> int:
    """Phase 20's crowded cell: one shard's arrivals (a flag an entry),
    ``n`` of them binned into one local cell, against the plain version:
    within C every slot equal, the flag set; past C the counts, the flag
    and every other cell's slots.  Returns the cells past C."""
    import numpy as np
    import torch
    from comd_tpu_torch.ops.cuda import arrivals as av
    geom, maps, f = rb_synthetic(np.array([4.0, 4.0, 8.0]) * RB_CUT,
                                 np.array([8.0, 8.0, 12.0]) * RB_CUT, 16,
                                 dtype, 51, spread=0.4)
    A = 16
    rng = np.random.default_rng(52)
    M = 8 * A
    cell = geom.local_min + geom.box_size * (np.array([1, 2, 1]) + 0.5)
    r = np.ascontiguousarray(rng.uniform(
        geom.local_min - geom.box_size, geom.local_max + geom.box_size,
        (M, 3)).T)
    r[:, :n] = cell[:, None] + rng.uniform(-0.4, 0.4, (3, n)) * \
        geom.box_size[:, None]
    dt = f[0].dtype
    valid = rng.uniform(size=M) < 0.9
    valid[:n] = True
    src = (torch.as_tensor(r, dtype=dt, device="cuda"),
           torch.as_tensor(rng.standard_normal((3, M)), dtype=dt,
                           device="cuda"),
           torch.as_tensor(rng.permutation(2 ** 20)[:M] + 2 ** 30,
                           dtype=torch.int32, device="cuda"),
           torch.as_tensor(valid, device="cuda"))
    got, want = [[t.clone()] for t in f], [[t.clone()] for t in f]
    ovf = [torch.zeros((), dtype=torch.bool, device="cuda") for _ in "ab"]
    av.append_stage(geom, maps, *got, [[src]], ovf[0])
    n_list = av.list_length(got[0][0].device)
    av.append_stage_plain(geom, maps, *want, [[src]], ovf[1])
    check(bool(ovf[0]) and torch.equal(*ovf) and
          torch.equal(got[3][0], want[3][0]),
          f"arrivals crowd {n} {dtype}: the counts or the flag differ")
    check(n_list == int((want[3][0] > f[3]).sum()),
          f"arrivals crowd {n} {dtype}: the place launch's list holds "
          f"{n_list} cells")
    ok = want[3][0] - f[3] <= av.stage_capacity(A)
    for a, b in zip(got[:3], want[:3]):
        check(torch.equal(a[0][..., ok, :], b[0][..., ok, :]),
              f"arrivals crowd {n} {dtype}: kernels and plain version "
              f"differ")
    return int((~ok).sum())


def av_time(h, stages, fields) -> dict:
    """Each stage's bin and place launches from its own state, the state
    restored before each call (its copies timed apart), the stage's
    arrivals copied once: a stage replayed in a graph (the host's launch
    cost out) less the restore's replay, the plain version a stage, each
    kernel's device us a launch (torch.profiler, mean of 20 calls of the
    three stages) and the byte bounds from the stages' stats.  Returns
    them with the working fields and their restore."""
    import torch
    from comd_tpu_torch.ops.cuda import arrivals as av
    from comd_tpu_torch.probes import time_ms
    work = [[t.clone() for t in x] for x in fields]
    ovf = torch.zeros((), dtype=torch.bool, device="cuda")
    arrs = [[[tuple(t.clone() for t in a) for a in dirs]
             for dirs in x[0][1]] for x in stages]

    def restore(i):
        for w, b in zip(work, stages[i][0][0]):
            for x, y in zip(w, b):
                x.copy_(y)

    def stage(i, fn=av.append_stage):
        restore(i)
        _b, _arr, axis, shifts = stages[i][0]
        fn(h.geom, h.maps, *work, arrs[i], ovf, axis, shifts)

    restore_ms = [time_ms(lambda: restore(i), 20) for i in range(3)]
    k_ms = [graph_ms(lambda: stage(i)) - graph_ms(lambda: restore(i))
            for i in range(3)]
    p_ms = [time_ms(lambda: stage(i, av.append_stage_plain), 3)
            - restore_ms[i] for i in range(3)]
    us = kernel_us(lambda: [stage(i) for i in range(3)],
                   ("arrivals_bin_kernel", "arrivals_place_kernel"))
    S, B = len(fields[0]), fields[0][0].shape[1]
    atom = atom_bytes(fields[0][0])
    st = [x[1] for x in stages]
    n_src = [sum(a[3].numel() for dirs in x[0][1] for a in dirs)
             for x in stages]
    return dict(
        work=work, restore=restore, restore_ms=restore_ms, k_ms=k_ms,
        p_ms=p_ms, us=us,
        # the masks and each valid arrival's fields in, a record out and
        # in; the cells' counters, their counts and the stored slots
        bytes_bin=[4 * m + v["valid"] * (2 * atom + 4)
                   for m, v in zip(n_src, st)],
        bytes_place=[4 * S * B + 12 * v["cells"] + v["valid"] * (atom + 4)
                     + v["stored"] * atom for v in st])


def av_real_rebucket(sim, launches: dict) -> None:
    """The unload's bin and place launches at the state of a real lazy
    rebucket of the 63^3 2x2x2 ki_fused mesh ``sim`` (stepped eagerly
    until its trigger fires; the rebucketed shards that its exchange
    takes): the three stages against their plain versions bit for bit,
    then timed as ``av_time`` times them, beside the byte bounds."""
    import torch
    taken = []
    exchange_atoms = sim._exchange_atoms

    def spy(r, p, gid, n_atoms, out=None):
        if not taken:
            taken.append([[t.clone() for t in x]
                          for x in (r, p, gid, n_atoms)])
        return exchange_atoms(r, p, gid, n_atoms, out)

    sim._exchange_atoms = spy
    try:
        for _ in range(20):
            if taken:
                break
            sim.step_block(5)
    finally:
        del sim._exchange_atoms
    check(bool(taken), "the 2x2x2 ki_fused mesh did not rebucket in 100 "
          "steps")
    n = HEADLINE_N
    main = av_chain(f"{n}^3 float32 2x2x2 ki, a lazy rebucket of the "
                    f"ki_fused run", sim.halo, taken[0], "ki")
    tm = av_time(sim.halo, main["stages"], taken[0])
    st = [x[1] for x in main["stages"]]
    for key, nb in (("arrivals_bin", tm["bytes_bin"]),
                    ("arrivals_place", tm["bytes_place"])):
        ms = tm["us"][key + "_kernel"] / 1e3
        b_ms = 1e3 * sum(nb) / 3 / PEAK_BYTES
        say("timing", f"{key} at a lazy rebucket of the {n}^3 f32 2x2x2 "
            f"ki_fused run (" + ", ".join(
                f"{v['valid']} arrivals into {v['cells']} cells" for v in st)
            + f"): {ms:.5f} ms a launch (torch.profiler, mean of 20 over "
            f"the three stages; the bound at {b_ms / ms:.0%} of it); bound "
            f"{b_ms:.5f} ms (bytes: {sum(nb) / 3 / 1e6:.3f} MB); "
            f"{launches[key]} launches in phase 12's ki_fused run")
    say("timing", f"a stage's bin and place at that rebucket: " + ", ".join(
        f"{x:.4f}" for x in tm["k_ms"]) + " ms (replayed in a graph); plain "
        + ", ".join(f"{x:.3f}" for x in tm["p_ms"]) + " ms")
    del taken, main, tm
    torch.cuda.empty_cache()


def run_arrivals(launches: dict) -> dict:
    """Phase 20: the atom exchange's unload (csrc/arrivals.cu) against its
    plain versions in every case, then timed at the 63^3 2x2x2 f32 state
    under ki (each launch under torch.profiler, mean of 20; the whole
    unload with CUDA events, mean of 20, and replayed in a graph) beside
    the plain versions and the byte bounds, and one eager mesh
    redistribution's device operations.  ``launches``: phase 12's
    ki_fused run (the main path's).  Returns the kernels-line rows."""
    import numpy as np
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import arrivals as av
    from comd_tpu_torch.parallel import exchange, ki_comm
    from comd_tpu_torch.probes import time_ms
    n = HEADLINE_N
    sim = init_simulation(Config(
        nx=n, ny=n, nz=n, doeam=True, temperature=600.0, dtype="float32",
        max_atoms=0, cell_mode="auto", pot_dir=POTS, device="cuda",
        comm_impl="ki_fused", **MESH))
    sim.cuda_graphs = False
    sim.step_block(10)
    h = sim.halo
    fields = av_fields(sim, 61, 0.5)
    A = fields[0][0].shape[2]
    packed = exchange.make_halo(
        h.mesh, h.geom, h.maps, exchange.make_plan(
            h.geom, msg_factor=0.6, max_atoms=A), sim.dtype)
    err = 0.0
    main = None
    for tag, halo, transport in (("ki", h, "ki"),
                                 ("collective", h, "collective"),
                                 ("collective packed", packed,
                                  "collective")):
        out = av_chain(f"{n}^3 float32 2x2x2 {tag}", halo, fields,
                       transport)
        err = max(err, out["err"])
        if tag == "ki":
            main = out
    for tag, mesh in (("2x2x2", MESH),
                      ("2x2x1 (an axis of one shard)",
                       dict(xproc=2, yproc=2, zproc=1))):
        small = init_simulation(Config(
            nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
            dtype="float64", interp_impl="rows", pot_dir=POTS,
            device="cuda", comm_impl="ki", **mesh))
        small.cuda_graphs = False
        small.step_block(10)
        f64 = av_fields(small, 62, 1.2)
        for transport in ("ki", "collective"):
            av_chain(f"10^3 float64 {tag} {transport}", small.halo, f64,
                     transport)
        del small, f64
    for dtype in ("float32", "float64"):
        for k, what in ((19, "A < n <= C"), (48, "n > C")):
            past = av_crowd(dtype, k)
            check((past > 0) == (k > av.stage_capacity(16)),
                  f"arrivals crowd {k}: {past} cells past C")
            say("arrivals", f"crowded cell {what} ({k} arrivals, A = 16, "
                f"C = {av.stage_capacity(16)}) {dtype}: kernels and plain "
                f"version equal" + (f" outside the {past} cell past C (the "
                                    f"counts and the flag equal)" if past
                                    else " bit for bit") + ", flag set")

    # timing at the 63^3 state under ki
    tm = av_time(h, main["stages"], fields)
    work, restore, restore_ms = tm["work"], tm["restore"], tm["restore_ms"]
    us, k_ms, p_ms = tm["us"], tm["k_ms"], tm["p_ms"]
    ex = main["exchanged"]
    out = [[torch.empty_like(t) for t in x] for x in ex[:3]]
    form = av.sort_form(A)
    sort_name = {"warp": "sort_cells_warp_kernel",
                 "block": "sort_cells_kernel"}
    sort_k = time_ms(lambda: av.sort_shards(*ex[:3], out), 20)
    sort_p = time_ms(lambda: av.sort_shards_plain(*ex[:3], out), 3)
    us.update(kernel_us(lambda: av.sort_shards(*ex[:3], out),
                        (sort_name[form],)))
    # the other form on the same input (the block form takes any A), for
    # the comparison only: its launches are not the main path's
    other = "block" if form == "warp" else None
    if other is not None:
        chosen = av.sort_form
        av.sort_form = lambda _a: other
        try:
            want = [[torch.empty_like(t) for t in x] for x in out]
            av.sort_shards(*ex[:3], want)
            check(all(torch.equal(a, b) for x, y in zip(out, want)
                      for a, b in zip(x, y)),
                  f"arrivals: the {other} sort differs from the {form} sort")
            us.update(kernel_us(lambda: av.sort_shards(*ex[:3], want),
                                (sort_name[other],)))
        finally:
            av.sort_form = chosen

    def unload():
        restore(0)
        ki_comm.exchange_atoms_ki(h, *work)
        av.sort_shards(*work[:3], out)

    def unload_plain():
        restore(0)
        o = torch.zeros((), dtype=torch.bool, device="cuda")
        for axis in range(3):
            av.append_stage_plain(h.geom, h.maps, *work,
                                  ki_comm.push_arrivals(h, axis, work), o,
                                  axis, (-h.ext[axis], h.ext[axis]))
        av.sort_shards_plain(*work[:3], out)

    whole = time_ms(unload, 20) - restore_ms[0]
    whole_graph = graph_ms(unload) - graph_ms(lambda: restore(0))
    whole_plain = time_ms(unload_plain, 3) - restore_ms[0]
    S, B = len(ex[0]), ex[0][0].shape[1]
    bytes_bin, bytes_place = tm["bytes_bin"], tm["bytes_place"]
    bytes_sort = 2 * atom_bytes(ex[0][0]) * S * B * A
    rows = {}
    for key, name, nb, ms, plain in (
            ("arrivals_bin", "arrivals_bin_kernel", sum(bytes_bin) / 3,
             us["arrivals_bin_kernel"] / 1e3, sum(p_ms) / 3),
            ("arrivals_place", "arrivals_place_kernel",
             sum(bytes_place) / 3, us["arrivals_place_kernel"] / 1e3,
             sum(p_ms) / 3),
            ("sort_cells", sort_name[form], bytes_sort,
             us[sort_name[form]] / 1e3, sort_p)):
        b_ms = 1e3 * nb / PEAK_BYTES
        how = {"arrivals_bin": "a thread an arrival slot, its fields "
                               "loaded beside the mask, a block's first "
                               "stagers listing their cells behind one "
                               "atomic",
               "arrivals_place": f"a grid of "
                                 f"{av.place_blocks(ex[0][0].device, 4, A)} "
                                 f"blocks striding over the list, a warp a "
                                 f"listed cell",
               "sort_cells": f"the {form} form at A = {A}"}[key]
        say("timing", f"{key} at {n}^3 f32 2x2x2 (ki, a mean over the "
            f"three stages for bin and place; {how}): {ms:.5f} ms a launch "
            f"(torch.profiler, mean of 20; the bound at {b_ms / ms:.0%} of "
            f"it; the earlier design {ARRIVALS_EARLIER_MS[key]:.5f} ms on "
            f"an H100 at 700 W); bound {b_ms:.5f} ms (bytes: {nb / 1e6:.3f} "
            f"MB); plain version {plain:.4f} ms ("
            + ("append_stage_plain a stage, both kernels' function"
               if key != "sort_cells" else "sort_shards_plain")
            + f"); {launches[key]} launches in phase 12's ki_fused run")
        rows[key] = {
            "name": key, "route": "cuda", "source": ARRIVALS_SOURCE,
            "replaces": REPLACES[key], "launches": launches[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None}
    rows["sort_cells"]["form"] = form
    if other is not None:
        o_ms = us[sort_name[other]] / 1e3
        b_ms = rows["sort_cells"]["bound_ms"]
        say("timing", f"sort_cells in the {other} form on the same input: "
            f"{o_ms:.5f} ms a launch (torch.profiler, mean of 20; the bound "
            f"at {b_ms / o_ms:.0%} of it), the {form} form "
            f"{rows['sort_cells']['ms']:.5f}")
    b_whole = 1e3 * (sum(bytes_bin) + sum(bytes_place) + bytes_sort) / \
        PEAK_BYTES
    say("timing", f"the unload at {n}^3 f32 2x2x2 (ki: 3 ring_push, 3 "
        f"arrivals_bin, 3 arrivals_place, 1 sort_cells; the restore's "
        f"copies taken out): {whole:.4f} ms a call (CUDA events, mean of "
        f"20; the host's launches), {whole_graph:.4f} ms replayed in a "
        f"graph of 20; a stage's bin and place " + ", ".join(
            f"{x:.4f}" for x in k_ms)
        + f" ms (replayed in a graph); the sort {sort_k:.4f} ms (CUDA "
        f"events, mean of 20); plain (append_stage_plain, "
        f"sort_shards_plain) {whole_plain:.3f} ms; bound of the unload's "
        f"bins, places and sort {b_whole:.5f} ms (bytes)")
    say("timing", "no single PyTorch call bins and appends atoms to cells, "
        "nor sorts three fields by one key: library_ms none")
    av_real_rebucket(sim, launches)

    # one eager mesh redistribution (the lazy step's IF body), op by op:
    # the profiler may drop records, so the most of five profiles
    runs = device_ops(sim._rebucket_step)
    n_ops, dev_ms = max(runs)
    check(n_ops <= 100, f"an eager mesh redistribution made {n_ops} device "
          f"operations")
    say("arrivals", f"one eager redistribution of the {n}^3 2x2x2 ki_fused "
        f"mesh (sim._rebucket_step): {n_ops} device operations, "
        f"{dev_ms:.4f} ms of device time (torch.profiler, the profile with "
        f"the most records of five: " + ", ".join(str(r[0]) for r in runs)
        + ")")
    del sim, fields, main, work, ex, out
    torch.cuda.empty_cache()
    return rows


def bits(t):
    """A float tensor's bits as integers (-0.0 is not +0.0)."""
    import torch
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def pos_case(h, r, tag: str) -> float:
    """position_fill over ``h``'s composed map against its plain version
    and the staged exchange.exchange_positions on positions ``r`` (CUDA
    tensors, one a shard), bit for bit: one launch, every halo row
    written, no local row touched.  Returns the max |diff| (0)."""
    import torch
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.parallel import exchange, ki_comm
    nl = h.geom.n_local
    plan = ki_comm.position_plan(h, r[0])
    before = st.LAUNCHES["position_fill"]
    got = cm.position_fill(plan, [x.clone() for x in r])
    n_launch = st.LAUNCHES["position_fill"] - before
    plain = cm.position_fill_plain(plan, [x.clone() for x in r])
    staged = exchange.exchange_positions(h, [x.clone() for x in r])
    torch.cuda.synchronize()
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got + got, plain + staged))
    same = all(torch.equal(bits(a), bits(b))
               for a, b in zip(got + got, plain + staged))
    written = all(torch.equal(bits(a[:, :nl]), bits(b[:, :nl])) and
                  bool((a[:, nl:] != b[:, nl:]).all())
                  for a, b in zip(got, r))
    check(same and written and n_launch == 1,
          f"positions {tag}: the kernel against position_fill_plain and "
          f"exchange_positions: equal {same}, every halo row written and "
          f"no local row touched {written}, {n_launch} launches; |diff| "
          f"{err:.3e}")
    say("positions", f"{tag}: position_fill ({plan.n_rows:,} halo rows of "
        f"{len(r)} shards, {plan.vec}-byte moves, {plan.grid_x} blocks) in "
        f"one launch equals position_fill_plain and the staged "
        f"exchange_positions bit for bit; every halo row written, no local "
        f"row touched")
    return err


def pos_inputs(sim, seed: int, scale: float, A: int = None) -> list:
    """Every shard's positions for phase 21: the local rows displaced by
    up to ``scale`` A (uniform), the halo rows noise that the refresh
    must overwrite; at another A than the state's, noise throughout; the
    first slot of every local row -0.0."""
    import torch
    nl = sim.geom.n_local
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for s in sim.states:
        shape = (3, s.r.shape[1], A or s.r.shape[2])
        u = 2 * torch.rand(shape, dtype=sim.dtype, device="cuda",
                           generator=gen) - 1
        x = 50 * u
        if A is None:
            x[:, :nl] = s.r[:, :nl] + scale * u[:, :nl]
        x[:, :nl, 0] = -0.0     # a copy with no shift keeps the sign of 0
        out.append(x)
    return out


def device_ops(fn, tries: int = 5) -> list:
    """[(device operations, device ms)] of one call of ``fn`` under
    torch.profiler, ``tries`` times (it may drop records: take the
    profile with the most)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    runs = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "Loading" not in e.key]
        runs.append((sum(e.count for e in ops), sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
            for e in ops) / 1e3))
    return runs


def run_positions(launches: dict) -> dict:
    """Phase 21: the mesh's ghost-position refresh (csrc/comm.cu's
    position_fill over the composed row map) against position_fill_plain
    and the staged exchange.exchange_positions, bit for bit: the 63^3 f32
    2x2x2 state displaced by up to 0.5 A, 10^3 f64 on 2x2x2 and on 2x2x1
    (an axis of one shard), and an odd A (one slot a thread); at the 63^3
    state timed (CUDA events, mean of 20; the device's time under
    torch.profiler; replayed in a CUDA graph) beside the torch refresh it
    replaces (its device operations and time), the library form (one
    index_select of the stacked positions on the composed index, with and
    without the shift's add) and the byte bound.  ``launches``: phase 12's
    ki_fused run (the main path's).  Returns the kernels-line row."""
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.parallel import exchange, ki_comm
    from comd_tpu_torch.probes import time_ms
    from comd_tpu_torch.stepgraph import cuda_capture
    n = HEADLINE_N
    sim = init_simulation(Config(
        nx=n, ny=n, nz=n, doeam=True, temperature=600.0, dtype="float32",
        max_atoms=0, cell_mode="auto", pot_dir=POTS, device="cuda",
        comm_impl="ki_fused", **MESH))
    h = sim.halo
    r = pos_inputs(sim, 71, 0.5)
    err = pos_case(h, r, f"{n}^3 float32 2x2x2 displaced by up to 0.5 A")
    for tag, mesh in (("2x2x2", MESH),
                      ("2x2x1 (an axis of one shard)",
                       dict(xproc=2, yproc=2, zproc=1))):
        small = init_simulation(Config(
            nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
            dtype="float64", interp_impl="rows", pot_dir=POTS,
            device="cuda", **mesh))
        for A in (None, 13):
            what = "" if A is None else ", A = 13 (one slot a thread)"
            err = max(err, pos_case(small.halo, pos_inputs(small, 72, 0.5, A),
                                    f"10^3 float64 {tag}{what}"))
        del small

    # timing at the 63^3 state
    plan = ki_comm.position_plan(h, r[0])
    work = [x.clone() for x in r]
    fn = (lambda: cm.position_fill(plan, work))
    ms = time_ms(fn, 20)
    host, dev = host_and_device_ms(fn, kernels_per_call=1)
    g_ms = graph_ms(fn)
    want = cm.position_fill_plain(plan, [x.clone() for x in r])
    graph = cuda_capture(fn, torch.cuda.graph_pool_handle())[0]
    for _ in range(2):
        for w, x in zip(work, r):
            w.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(work, want)),
              "positions: a replay of the refresh's graph differs from the "
              "plain version")
    plain_ms = time_ms(lambda: cm.position_fill_plain(plan, work), 20)
    staged = (lambda: exchange.exchange_positions(h, work))
    staged_ms = time_ms(staged, 20)
    staged_host, _d = host_and_device_ms(staged)
    staged_ops, staged_dev = max(device_ops(staged))
    # the library form: the positions stacked [3, S * B, A] (layout, not
    # timed), one index_select on the composed row index (every row its
    # own source, a halo row the local row the stages copy into it), then
    # the shifts (-0.0 where none) added
    S, (_three, B, A) = len(work), tuple(work[0].shape)
    stacked = torch.stack(work, 1).reshape(3, S * B, A)
    m = plan.map.long()
    dst = m[:, 0] * B + m[:, 1]
    index = torch.arange(S * B, device="cuda")
    index[dst] = plan.src_index * B + plan.src_row_index
    shift = torch.full((3, S * B, 1), -0.0, dtype=sim.dtype, device="cuda")
    shift[:, dst, 0] = plan.shift.t()
    lib = torch.index_select(stacked, 1, index).add_(shift)
    cm.position_fill(plan, work)
    check(torch.equal(bits(lib),
                      bits(torch.stack(work, 1).reshape(3, S * B, A))),
          "positions: index_select on the composed index plus the shifts "
          "differs from position_fill")
    lib_copy_ms = time_ms(lambda: torch.index_select(stacked, 1, index), 20)
    lib_ms = time_ms(lambda: torch.index_select(stacked, 1, index)
                     .add_(shift), 20)
    esize = work[0].element_size()
    nbytes = plan.n_rows * (2 * 3 * A * esize + 16)
    b_ms = 1e3 * nbytes / PEAK_BYTES
    say("timing", f"position_fill, one ghost refresh of the {n}^3 f32 "
        f"2x2x2 state ({plan.n_rows:,} halo rows, {plan.vec}-byte moves on "
        f"{1 << plan.lg} lanes a row, {plan.grid_x} blocks): {ms:.5f} ms "
        f"(CUDA events, mean of 20); host {host:.4f} ms a call, device "
        f"{dev:.5f} ms (torch.profiler); {g_ms:.5f} ms a launch replayed in "
        f"a graph of 20 (two replays of a captured refresh equal the plain "
        f"version); plain version {plain_ms:.4f} ms; bound {b_ms:.5f} ms "
        f"(bytes: {nbytes / 1e6:.3f} MB, the rows read and written once "
        f"and the map; the bound at {b_ms / dev:.0%} of the device time)")
    say("timing", f"the torch refresh it replaces (exchange.exchange_"
        f"positions, staged): {staged_ms:.4f} ms (CUDA events, mean of "
        f"20); host {staged_host:.4f} ms a call; {staged_ops} device "
        f"operations, {staged_dev:.5f} ms of device time (torch.profiler, "
        f"the profile with the most records of five)")
    say("timing", f"the library form: one torch.index_select of the "
        f"stacked [3, {S} x {B}, {A}] positions on the composed row index "
        f"{lib_copy_ms:.5f} ms, with the shifts' add (a second call; the "
        f"same bits as position_fill) {lib_ms:.5f} ms (CUDA events, mean "
        f"of 20)")
    key = "position_fill"
    check(launches[key] > 0, f"positions: no position_fill launch in phase "
          f"12's ki_fused run")
    row = {"name": key, "route": "cuda", "source": COMM_SOURCE,
           "replaces": REPLACES[key], "launches": launches[key],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": "bytes", "library_ms": lib_ms,
           "device_ms": dev, "graph_ms": g_ms, "torch_refresh_ms": staged_ms,
           "torch_refresh_ops": staged_ops}
    del sim, r, work, stacked, lib, graph
    torch.cuda.empty_cache()
    return {key: row}


def pack_case(sim, caps: tuple, fields: list, tag: str) -> float:
    """Phase 22: atom_pack against atom_pack_plain at each stage of one
    atom exchange of ``sim``'s mesh from ``fields`` (r, p, gid, n_atoms
    lists, CUDA tensors) with the per-axis capacities ``caps`` (0: full
    planes), bit for bit in every buffer and the overflow flag, one launch
    a stage; the exchange then goes on through the collective stage
    (exchange.atom_arrivals and the unload), so the later stages pack
    forwarded ghosts.  Returns the max |diff| of r and p (0)."""
    import dataclasses
    import torch
    from comd_tpu_torch.ops import binning
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.parallel import exchange
    r, p, gid, n_atoms = (list(f) for f in fields)
    h = exchange.make_halo(sim.mesh, sim.geom, sim.maps,
                           dataclasses.replace(sim.plan, atom_cap=caps),
                           r[0].dtype)
    S = len(r)
    ovf = torch.zeros((), dtype=torch.bool, device="cuda")
    err, counts, flags = 0.0, [], []
    for axis in range(3):
        kp, pp = (cm.AtomPackPlan(h.atom_send[axis], caps[axis], S,
                                  r[0].shape, r[0].dtype, "cuda")
                  for _ in range(2))
        fk = torch.zeros((), dtype=torch.bool, device="cuda")
        fp = torch.zeros((), dtype=torch.bool, device="cuda")
        before = st.LAUNCHES["atom_pack"]
        cm.atom_pack(kp, r, p, gid, n_atoms, fk)
        n_launch = st.LAUNCHES["atom_pack"] - before
        cm.atom_pack_plain(pp, r, p, gid, n_atoms, fp)
        torch.cuda.synchronize()
        same = torch.equal(bits(kp.rp), bits(pp.rp)) and \
            torch.equal(kp.gid, pp.gid) and \
            torch.equal(kp.valid, pp.valid) and bool(fk) == bool(fp)
        err = max(err, float((kp.rp.double() - pp.rp.double()).abs().max()))
        check(same and n_launch == 1,
              f"atom_pack {tag} stage {axis}: the kernel against "
              f"atom_pack_plain: equal {same}, flags {bool(fk)} "
              f"{bool(fp)}, {n_launch} launches")
        counts.append(int(pp.valid.sum()))
        flags.append(bool(fp))
        arrivals = exchange.atom_arrivals(h, axis, r, p, gid, n_atoms, ovf)
        binning.append_stage(h.geom, h.maps, r, p, gid, n_atoms, arrivals,
                             ovf, axis, (-h.ext[axis], h.ext[axis]))
    say("collective", f"{tag}: atom_pack of {S} shards x 2 faces a stage, "
        f"caps {caps} ({kp.grid_x} blocks a message): the three stages' "
        f"buffers and overflow flags equal atom_pack_plain's bit for bit, "
        f"one launch a stage; valid entries {counts}, overflow {flags}")
    return err


def fold_case(h, x: list, tag: str, maps=None) -> float:
    """Phase 22: the half-shell fold of the fields ``x`` (CUDA tensors,
    one a shard) against its plain version bit for bit: on a mesh
    (``h``) ki_comm.fold_halo_ki (one fold_halo launch a stage) against
    fold_halo_plain stage by stage over the same plans; serially (``h``
    None, ``maps`` the geometry's) fold_halo_serial (one launch) against
    fold_halo_plain; both in place.  Returns the max |diff| (0)."""
    import torch
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.ops.sweep import fold_plan_serial
    from comd_tpu_torch.parallel import ki_comm
    got = [v.clone() for v in x]
    want = [v.clone() for v in x]
    before = st.LAUNCHES["fold_halo"]
    if h is None:
        plans = [fold_plan_serial(maps, got[0])]
        cm.fold_halo(plans[0], got)
    else:
        plans = [ki_comm.fold_plan(h, axis, got[0]) for axis in (2, 1, 0)]
        ki_comm.fold_halo_ki(h, got)
    n_launch = st.LAUNCHES["fold_halo"] - before
    for plan in plans:
        cm.fold_halo_plain(plan, want)
    torch.cuda.synchronize()
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
    check(same and n_launch == len(plans),
          f"fold {tag}: the kernel against fold_halo_plain: equal {same}, "
          f"{n_launch} launches for {len(plans)} plans")
    say("fold", f"{tag}: fold_halo in {n_launch} launch(es) ("
        + ", ".join(f"{pl.n_entries:,} rows of {pl.n_adds:,} adds, "
                    f"{pl.vec}-byte moves" for pl in plans)
        + ") equals fold_halo_plain bit for bit")
    return err


def fold_bytes(plan, x) -> int:
    """Bytes one fold launch must move: each destination row of every
    plane read and written, each source row read, the entries and
    sources."""
    row = x.shape[-1] * x.element_size() * (x.shape[0] if x.dim() == 3
                                             else 1)
    return (2 * plan.n_entries + plan.n_adds) * row + \
        16 * plan.n_entries + 8 * plan.n_adds


def run_collective(launches_coll: dict, launches_half: dict) -> dict:
    """Phase 22: the collective transport's atom messages (csrc/comm.cu's
    atom_pack: one launch a stage over every shard and both faces) and the
    half-shell fold (fold_halo: one launch serially, one a stage on a
    mesh) against their plain versions, bit for bit: the 63^3 f32 2x2x2
    state displaced by up to 0.5 A and rebucketed, packed (the plan's
    caps), full planes and a cap of 64 that overflows; 10^3 f64 on 2x2x2
    and 2x2x1 (an axis of one shard); the fold of [3, B, A] and [B, A]
    fields at A = 16 and 13 on those meshes and serially at 20^3 f64 and
    at the 63^3 --halfShell geometry.  At 63^3 timed (CUDA events, mean
    of 20; the device's time under torch.profiler): one atom_pack stage
    beside its plain version, the torch packing it replaces
    (exchange._atom_message a shard and face) and the byte bound; the
    serial fold beside its plain version, the clone + index_add_ it
    replaced (the library form) and the bound; the mesh fold's three
    stage launches beside the torch exchange.fold_halo; and the
    collective dfEmbed fill now on halo_fill beside the staged torch fill
    (exchange.exchange_scalar), the bound and the library form.
    ``launches_coll``: phase 12's collective run (atom_pack's main path);
    ``launches_half``: phase 8's --halfShell run (the serial fold's).
    Returns the kernels-line rows."""
    import dataclasses
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.sweep import fold_halo_serial, fold_plan_serial
    from comd_tpu_torch.parallel import exchange, ki_comm
    from comd_tpu_torch.probes import time_ms
    n = HEADLINE_N
    sim = init_simulation(Config(
        nx=n, ny=n, nz=n, doeam=True, temperature=600.0, dtype="float32",
        max_atoms=0, cell_mode="auto", pot_dir=POTS, device="cuda",
        comm_impl="collective", **MESH))
    caps = sim.plan.atom_cap
    fields = av_fields(sim, 81, 0.5)
    pack_err = 0.0
    for what, c in (("packed", caps), ("full planes", (0, 0, 0)),
                    ("overflow", (64, 64, 64))):
        pack_err = max(pack_err, pack_case(
            sim, c, [[t.clone() for t in f] for f in fields],
            f"{n}^3 float32 2x2x2 displaced by up to 0.5 A, {what}"))
    h = sim.halo
    B, A = sim.geom.n_total, sim.cfg.max_atoms
    gen = torch.Generator(device="cuda").manual_seed(82)
    S = len(sim.states)

    def noise(shape, dtype, k=S):
        return [torch.rand(shape, dtype=dtype, device="cuda",
                           generator=gen) - 0.5 for _ in range(k)]

    fold_err = 0.0
    for shape in ((3, B, A), (B, A)):
        fold_err = max(fold_err, fold_case(
            h, noise(shape, torch.float32), f"{n}^3 float32 2x2x2 "
            f"{list(shape)}"))
    for tag, mesh in (("2x2x2", MESH),
                      ("2x2x1 (an axis of one shard)",
                       dict(xproc=2, yproc=2, zproc=1))):
        small = init_simulation(Config(
            nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
            dtype="float64", interp_impl="rows", pot_dir=POTS,
            device="cuda", comm_impl="collective", **mesh))
        sf = av_fields(small, 83, 0.5)
        sc = small.plan.atom_cap
        for what, c in (("packed", sc), ("full planes", (0, 0, 0)),
                        ("overflow", (64, 64, 64))):
            pack_err = max(pack_err, pack_case(
                small, c, [[t.clone() for t in f] for f in sf],
                f"10^3 float64 {tag}, {what}"))
        Bs, As = small.geom.n_total, small.cfg.max_atoms
        for a in (As, 13):
            for shape in ((3, Bs, a), (Bs, a)):
                fold_err = max(fold_err, fold_case(
                    small.halo, noise(shape, torch.float64,
                                      len(small.states)),
                    f"10^3 float64 {tag} {list(shape)}"))
        del small, sf
    serial = init_simulation(Config(
        nx=20, ny=20, nz=20, doeam=True, temperature=600.0,
        dtype="float64", interp_impl="rows", half_shell=True, pot_dir=POTS,
        device="cuda"))
    Bs, As = serial.geom.n_total, serial.cfg.max_atoms
    for a in (As, 13):
        for shape in ((3, Bs, a), (Bs, a)):
            fold_err = max(fold_err, fold_case(
                None, noise(shape, torch.float64, 1),
                f"serial 20^3 float64 {list(shape)}", serial.maps))
    del serial
    half = init_simulation(Config(
        nx=n, ny=n, nz=n, doeam=True, temperature=600.0, dtype="float32",
        max_atoms=0, cell_mode="auto", half_shell=True, pot_dir=POTS,
        device="cuda"))
    Bh, Ah = half.geom.n_total, half.cfg.max_atoms
    fold_err = max(fold_err, fold_case(
        None, noise((3, Bh, Ah), torch.float32, 1),
        f"serial {n}^3 float32 --halfShell [3, {Bh}, {Ah}]", half.maps))

    rows = {}
    # atom_pack: one stage at the 63^3 packed state (mean of the three)
    r, p, gid, n_atoms = fields
    plans = [exchange.pack_plan(h, axis, r[0]) for axis in range(3)]
    flag = torch.zeros((), dtype=torch.bool, device="cuda")

    def packs(fn):
        for pl in plans:
            fn(pl, r, p, gid, n_atoms, flag)

    ms = time_ms(lambda: packs(cm.atom_pack), 20) / 3
    host, dev = (t / 3 for t in host_and_device_ms(
        lambda: packs(cm.atom_pack), kernels_per_call=3))
    g_ms = graph_ms(lambda: packs(cm.atom_pack)) / 3
    plain_ms = time_ms(lambda: packs(cm.atom_pack_plain), 20) / 3

    def torch_pack():
        for axis in range(3):
            for s in range(S):
                for d in (0, 1):
                    exchange._atom_message(h, axis, d, r[s], p[s], gid[s],
                                           n_atoms[s])

    torch_ms = time_ms(torch_pack, 20) / 3
    torch_ops, torch_dev = max(device_ops(torch_pack))
    packs(cm.atom_pack)
    torch.cuda.synchronize()
    esize = r[0].element_size()
    nbytes = 0
    for pl in plans:
        real = int(pl.valid.sum())
        nbytes += 2 * S * 2 * 4 * pl.n_cells      # ids and counts
        nbytes += real * (6 * esize + 4) if pl.cap else \
            2 * S * pl.n_out * (6 * esize + 4)
        nbytes += 2 * S * pl.n_out * (6 * esize + 4 + 1)
    b_ms = 1e3 * nbytes / 3 / PEAK_BYTES
    say("timing", f"atom_pack, one stage's messages of the {n}^3 f32 2x2x2 "
        f"displaced state ({S} shards x 2 faces, caps {caps}, "
        f"{plans[0].n_cells} cells a face, {plans[0].grid_x} blocks of "
        f"{cm.PACK_CELLS} cells a message; mean of the 3 stages): "
        f"{ms:.5f} ms (CUDA events, mean of 20); host {host:.4f} ms a "
        f"call, device {dev:.5f} ms (torch.profiler), "
        f"{100 * b_ms / dev:.0f}% of the bound; {g_ms:.5f} ms a launch "
        f"replayed in a graph; "
        f"plain version {plain_ms:.4f} ms; the torch packing it replaces "
        f"(exchange._atom_message a shard and face) {torch_ms:.4f} ms, "
        f"{torch_ops / 3:.0f} device operations and {torch_dev / 3:.5f} ms "
        f"of device time a stage; bound {b_ms:.5f} ms (bytes: "
        f"{nbytes / 3 / 1e6:.3f} MB a stage, the real entries read once, "
        f"every output entry written once, the cells' ids and counts); no "
        f"single PyTorch call packs a message (a compaction of four "
        f"fields of three shapes by a running count)")
    key = "atom_pack"
    check(launches_coll[key] > 0, "collective: no atom_pack launch in phase "
          "12's collective run")
    rows[key] = {"name": key, "route": "cuda", "source": COMM_SOURCE,
                 "replaces": REPLACES[key], "launches": launches_coll[key],
                 "max_abs_err": pack_err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None,
                 "device_ms": dev, "graph_ms": g_ms, "torch_ms": torch_ms,
                 "torch_ops": torch_ops / 3}

    # the serial fold at the 63^3 --halfShell geometry, [3, B, A] f32
    x0 = noise((3, Bh, Ah), torch.float32, 1)[0]
    work = x0.clone()
    fplan = fold_plan_serial(half.maps, work)
    fn = (lambda: cm.fold_halo(fplan, [work]))
    ms = time_ms(fn, 20)
    host, dev = host_and_device_ms(fn, kernels_per_call=1)
    g_ms = graph_ms(fn)
    plain_ms = time_ms(lambda: cm.fold_halo_plain(fplan, [work]), 20)
    nl = half.geom.n_local
    src = half.maps.halo_src

    def index_add():
        return work[:, :nl].clone().index_add_(1, src, work[:, nl:])

    lib_ms = time_ms(index_add, 20)
    work.copy_(x0)
    lib = index_add()
    got = fold_halo_serial(half.geom, half.maps, work)
    torch.cuda.synchronize()
    lib_diff = float((lib.double() - got.double()).abs().max())
    nbytes = fold_bytes(fplan, work)
    b_ms = 1e3 * nbytes / PEAK_BYTES
    say("timing", f"fold_halo, the serial fold of the {n}^3 f32 --halfShell "
        f"force [3, {Bh}, {Ah}] ({fplan.n_entries:,} local rows of "
        f"{fplan.n_adds:,} halo images, {fplan.vec}-byte moves, records of "
        f"{fplan.record_vecs} 16-byte words): {ms:.5f} ms (CUDA events, mean "
        f"of 20); host {host:.4f} ms a call, device {dev:.5f} ms "
        f"(torch.profiler), {100 * b_ms / dev:.0f}% of the bound; "
        f"{g_ms:.5f} ms a launch replayed in a graph; plain version "
        f"{plain_ms:.4f} ms; the library form it "
        f"replaced (clone + index_add_, f32 atomics in run-to-run order; "
        f"{lib_diff:.3e} from the kernel) {lib_ms:.5f} ms; bound {b_ms:.5f} "
        f"ms (bytes: {nbytes / 1e6:.3f} MB)")
    key = "fold_halo"
    check(launches_half[key] > 0, "fold: no fold_halo launch in phase 8's "
          "--halfShell run")
    rows[key] = {"name": key, "route": "cuda", "source": COMM_SOURCE,
                 "replaces": REPLACES[key], "launches": launches_half[key],
                 "max_abs_err": fold_err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": "bytes", "library_ms": lib_ms,
                 "device_ms": dev, "graph_ms": g_ms}
    del half, x0, work, lib, got

    # the mesh fold at 63^3 2x2x2 ([3, B, A] f32): three stage launches
    xs = noise((3, B, A), torch.float32)
    fn = (lambda: ki_comm.fold_halo_ki(h, xs))
    ms = time_ms(fn, 20)
    host, dev = host_and_device_ms(fn, kernels_per_call=3)
    torch_ms = time_ms(lambda: exchange.fold_halo(h, xs), 20)
    torch_ops, torch_dev = max(device_ops(lambda: exchange.fold_halo(h, xs)))
    nbytes = sum(fold_bytes(ki_comm.fold_plan(h, axis, xs[0]), xs[0])
                 for axis in range(3))
    b_ms = 1e3 * nbytes / PEAK_BYTES
    say("timing", f"fold_halo, the mesh fold of the {n}^3 f32 2x2x2 force "
        f"[3, {B}, {A}] a shard (three stage launches): {ms:.5f} ms (CUDA "
        f"events, mean of 20); host {host:.4f} ms a call, device {dev:.5f} "
        f"ms (torch.profiler), {100 * b_ms / dev:.0f}% of the bound; the "
        f"torch exchange.fold_halo it replaces {torch_ms:.4f} ms, "
        f"{torch_ops} device operations, {torch_dev:.5f} ms of device time; "
        f"bound {b_ms:.5f} ms (bytes)")

    # collective's dfEmbed fill, now one halo_fill launch
    x = noise((B, A), torch.float32)
    fplan = ki_comm.fill_plan(h, x[0])
    fn = (lambda: ki_comm.exchange_scalar_ki(h, x))
    ms = time_ms(fn, 20)
    host, dev = host_and_device_ms(fn, kernels_per_call=1)
    torch_ms = time_ms(lambda: exchange.exchange_scalar(h, x), 20)
    torch_ops, torch_dev = max(device_ops(
        lambda: exchange.exchange_scalar(h, x)))
    lib_ms, lib_err = fill_library(fplan, x)
    check(lib_err == 0, f"collective fill: index_select on the composed "
          f"index is {lib_err:.3e} from halo_fill")
    say("timing", f"collective fill on halo_fill (one launch, K3's copies; "
        f"{launches_coll['halo_fill']} launches in phase 12's collective "
        f"run): {ms:.5f} ms (CUDA events, mean of 20); host {host:.4f} ms a "
        f"call, device {dev:.5f} ms (torch.profiler); the staged torch fill "
        f"it replaces (exchange.exchange_scalar) {torch_ms:.4f} ms, "
        f"{torch_ops} device operations, {torch_dev:.5f} ms of device time; "
        f"bound {fill_bound(fplan)[0]:.6f} ms (bytes); library form (one "
        f"index_select on the composed index) {lib_ms:.5f} ms")
    del sim, h, fields, xs, x
    torch.cuda.empty_cache()
    return rows


def check_k1_bits(r, nbr, ev, dfe, tag: str) -> None:
    """K1 pass 1 (with and without energy) and pass 3: two launches give
    the same bits."""
    import torch
    from comd_tpu_torch.ops.cuda import stencil as st
    for energy in (True, False):
        a = st.eam_pass1(r, nbr, ev, want_energy=energy)
        b = st.eam_pass1(r, nbr, ev, want_energy=energy)
        check(all(x is y or torch.equal(x, y) for x, y in zip(a, b)),
              f"{tag}: K1 pass 1 (energy {energy}) differs between two "
              f"launches")
    check(torch.equal(st.eam_pass3(r, nbr, ev, dfe),
                      st.eam_pass3(r, nbr, ev, dfe)),
          f"{tag}: K1 pass 3 differs between two launches")
    say("kernel", f"{tag} {ev.kind}: two launches of K1 pass 1 (with and "
        f"without energy) and pass 3 give the same bits")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import arrivals as av
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.cuda import graph_if
    from comd_tpu_torch.ops.cuda import nl as nlk
    from comd_tpu_torch.ops.cuda import probe as pr
    from comd_tpu_torch.ops.cuda import rebucket as rb
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.ops.cuda import step
    from comd_tpu_torch.probes import time_ms

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("device", f"{kind}, {count} visible, torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    # conditional graph nodes: torch's own calls, where this build has
    # them; the step's IF nodes go through csrc/graph_if.cu either way,
    # with the body's allocations routed into the capture's pool
    has = {n: hasattr(torch.cuda.CUDAGraph, n) for n in (
        "get_currently_capturing_graph", "begin_capture_to_if_node",
        "end_capture_to_conditional_node")}
    route = hasattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool")
    say("device", f"torch's conditional-node calls: {has}; IF nodes through "
        f"csrc/graph_if.cu, body allocations routed into a private pool "
        f"(torch._C._cuda_beginAllocateCurrentStreamToPool: {route})")
    check(route, "no call routes a stream's allocations into a pool")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda m: m.build(), (st, cm, pr, nlk, graph_if,
                                            step, rb, av)))
    t_build = time.perf_counter() - t0
    for mod, stem in ((st, "stencil"), (cm, "comm"), (pr, "probe"),
                      (nlk, "nl"), (graph_if, "graph_if"), (step, "step"),
                      (rb, "rebucket"), (av, "arrivals")):
        log = os.path.join(st.BUILD_DIR, f"{stem}_ptxas.log")
        entries = []       # (mangled name, registers, spill store bytes)
        if os.path.exists(log):
            for block in open(log).read().split(
                    "Compiling entry function '")[1:]:
                regs = re.search(r"Used (\d+) registers", block)
                spill = re.search(r"(\d+) bytes spill stores", block)
                entries.append((block.split("'")[0],
                                int(regs.group(1)) if regs else 0,
                                int(spill.group(1)) if spill else 0))
        regs = [e[1] for e in entries]
        say("build", f"{stem}.cu: nvcc sm_90a in {mod.BUILD_SECONDS:.1f} s; "
            f"{len(entries)} kernels, registers {min(regs, default=0)}.."
            f"{max(regs, default=0)}, max spill stores "
            f"{max((e[2] for e in entries), default=0)} bytes")
        if stem in ("stencil", "nl"):
            # stencil_kernel<T, PAIR, EVAL, ...> / nl_sweep_kernel<...>:
            # the f32 variants on the main paths (EAM Chebyshev and -P
            # spline, LJ analytic and the -I table) must not spill; the
            # f32 EAM quadratic table runs on no main path
            spill = {}
            kern = "stencil_kernel" if stem == "stencil" else \
                "nl_sweep_kernel"
            for name, nreg, nspill in entries:
                m = re.search(kern + r"I([fd])Li(\d)ELi(\d)E", name)
                if m:
                    tag = ("f32" if m.group(1) == "f" else "f64") + (
                        " lj" if m.group(2) == "2" else " eam") + {
                        "0": "", "1": " table", "2": " spline"}[m.group(3)]
                    spill[tag] = max(spill.get(tag, 0), nspill)
            say("build", f"{stem}.cu spill stores by variant (bytes, max): "
                + ", ".join(f"{k} {v}" for k, v in sorted(spill.items())))
            bad = {k: v for k, v in spill.items()
                   if k.startswith("f32") and k != "f32 eam table" and v}
            check(not bad, f"f32 {stem} kernels spill: {bad}")
    say("build", f"eight sources in {t_build:.1f} s")

    # 3. K1 vs plain version on a thermalized 10^3 lattice
    for dtype, impl, f_atol, s_rtol, f_rtol in (
            ("float32", "cheb", 1e-4, 1e-5, 0.0),
            ("float64", "rows", 0.0, 1e-12, 1e-12)):
        sim = init_simulation(Config(
            nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
            dtype=dtype, interp_impl=impl, pot_dir=POTS, device="cuda"))
        sim.step_block(10)      # thermalize: atoms off their sites
        compare_passes(sim, f"10^3 {dtype}/{sim.pair_eval.kind} "
                       f"A={sim.cfg.max_atoms}", f_atol, s_rtol, f_rtol)

    # 4. golden on the card (f64, exact table evaluator through K1)
    golden("Adams Cu 6^3 T=0", GOLDEN_EAM_ADAMS, nx=6, ny=6, nz=6,
           doeam=True)

    # 5. main path at full width: the 63^3 headline run
    serial_epot = []
    sim, launches = run_main(
        "main", ("eam_pass1", "eam_pass3") + tuple(
            k for k in STEP_KEYS if k != "refresh_halo"),
        doeam=True, on_init=lambda x: serial_epot.append(x.e_potential))
    launches_main = launches
    # one launch of kick_drift_trigger (with the ghost refresh), embed_fill
    # and land a step, embed_fill once more for the initial force;
    # refresh_halo (the whole halo fill) once a rebucket and once for the
    # initial fill
    n_steps = 100
    want = {k: 1 + sim.n_rebucket if k == "refresh_halo" else
            n_steps + (k == "embed_fill") for k in STEP_KEYS}
    got = {k: launches[k] for k in STEP_KEYS}
    check(got == want, f"main: step kernels launched {got}, not {want}")
    k1 = {k: launches[k] for k in ("eam_pass1", "eam_pass3")}
    check(all(v == n_steps + 1 for v in k1.values()),
          f"main: K1 launched {k1}, not once a pass a force "
          f"({n_steps + 1})")
    say("main", f"step kernels: {got} launches in {n_steps} steps "
        f"({sim.n_rebucket} rebuckets: refresh_halo fills the halo at "
        f"each and at init, the trigger's launch refreshes it on the "
        f"others; embed_fill also at the initial force)")
    got = {k: launches[k] for k in REBUCKET_KEYS}
    check(got == {k: sim.n_rebucket for k in REBUCKET_KEYS},
          f"main: rebucket kernels launched {got}, not once each for "
          f"each of the {sim.n_rebucket} rebuckets")
    say("main", f"rebucket kernels: {got} launches, one bin and one place "
        f"a rebucket ({sim.n_rebucket})")
    serial_ms = sim.ms_step
    rows = {}
    # K1 vs plain at the main path's shape (not counted: read above)
    errs, (r, nbr, ev, dfe, chunk) = compare_passes(
        sim, f"{HEADLINE_N}^3 float32/cheb", 1e-4, 1e-5)
    k1_ms = {
        "eam_pass1": (
            time_ms(lambda: st.eam_pass1(r, nbr, ev, want_energy=False), 20),
            time_ms(lambda: st.eam_pass1_plain(
                r, nbr, ev, want_energy=False, box_chunk=chunk), 2)),
        "eam_pass3": (
            time_ms(lambda: st.eam_pass3(r, nbr, ev, dfe), 20),
            time_ms(lambda: st.eam_pass3_plain(r, nbr, ev, dfe,
                                               box_chunk=chunk), 2)),
    }
    for k, (ms, plain) in k1_ms.items():
        rows[k] = kernel_row(sim, k, launches, errs[k], ms, plain)
    # K1 pass 1 beside the window probe (phase 13): its time, slot pairs,
    # occupied candidate pairs and flops (its bound is operations)
    check(rows["eam_pass1"]["bound_by"] == "operations",
          "K1 pass 1 bound by bytes")
    _b, _by, k1_flops, k1_cand = bound(sim, "eam_pass1")
    k1_pass1 = (k1_ms["eam_pass1"][0],
                sim.geom.n_local * 27 * sim.cfg.max_atoms ** 2, k1_cand,
                k1_flops)
    # K1 sums each i's pairs in one fixed order: two launches, same bits
    check_k1_bits(r, nbr, ev, dfe, f"{HEADLINE_N}^3")
    headline = sim          # phase 19 runs the step kernels on its state
    del sim, r, nbr, ev, dfe

    # 6. K2 (EAM, LJ) and K1's LJ variant vs plain versions at 10^3
    for dtype, impl, f_atol, s_rtol, f_rtol in (
            ("float32", "cheb", 1e-4, 1e-5, 0.0),
            ("float64", "rows", 0.0, 1e-12, 1e-12)):
        for doeam in (True, False):
            sim = init_simulation(Config(
                nx=10, ny=10, nz=10, doeam=doeam, half_shell=True,
                temperature=600.0, dtype=dtype, interp_impl=impl,
                pot_dir=POTS, device="cuda"))
            sim.step_block(10)
            tag = (f"10^3 {dtype}/{sim.pair_eval.kind} "
                   f"A={sim.cfg.max_atoms}")
            if doeam:
                compare_half(sim, tag, f_atol, s_rtol, f_rtol)
            else:
                compare_lj(sim, tag, f_atol, s_rtol, f_rtol)

    # 7. goldens through the kernels (f64)
    golden("Adams Cu 6^3 T=0 --halfShell", GOLDEN_EAM_ADAMS, nx=6, ny=6,
           nz=6, doeam=True, half_shell=True)
    for half in (False, True):
        hs = " --halfShell" if half else ""
        golden(f"LJ 6^3 T=0{hs}", GOLDEN_LJ, nx=6, ny=6, nz=6,
               half_shell=half)
        golden(f"LJ 5sigma 8^3 T=0{hs}", GOLDEN_LJ_5SIGMA, nx=8, ny=8, nz=8,
               lj_cutoff_factor=5.0, half_shell=half)

    # 8. the headline run with --halfShell (K2)
    # K2's force against K1's at the initial and final states, bound 1e-4
    # eV/A (f32, the two differ by summation order only)
    d_init = []
    sim, launches = run_main("half main", ("half_eam_pass1",
                                           "half_eam_pass3", "fold_halo"),
                             on_init=lambda x: d_init.append(half_vs_full(x)),
                             doeam=True, half_shell=True)
    launches_half = launches
    # the serial fold: one fold_halo launch a fold, rhobar and the force
    # every force, phi also on the 10 energy steps and the initial force
    want = 2 * 101 + 11
    check(launches["fold_halo"] == want, f"half main: fold_halo launched "
          f"{launches['fold_halo']} times, not {want}")
    say("half main", f"fold_halo launched {launches['fold_halo']} times: "
        f"one a fold (rhobar and the force every force, phi on the 11 "
        f"energy forces)")
    d_final = half_vs_full(sim)
    check(max(d_init[0], d_final) <= 1e-4, f"half vs full force: initial "
          f"{d_init[0]:.3e}, final {d_final:.3e}")
    errs, (r, hm, ev, dfe, chunk) = compare_half(
        sim, f"{HEADLINE_N}^3 float32/cheb", 1e-4, 1e-5)
    nbr = sim.maps.nbr_map
    times = {
        "half_eam_pass1": (
            time_ms(lambda: st.eam_pass1_half(r, hm, ev, want_energy=False),
                    20),
            time_ms(lambda: st.eam_pass1_half_plain(
                r, hm, ev, want_energy=False, box_chunk=chunk), 2)),
        "half_eam_pass3": (
            time_ms(lambda: st.eam_pass3_half(r, hm, ev, dfe), 20),
            time_ms(lambda: st.eam_pass3_half_plain(r, hm, ev, dfe,
                                                    box_chunk=chunk), 2)),
    }
    k1_here = (time_ms(lambda: st.eam_pass1(r, nbr, ev, want_energy=False),
                       20),
               time_ms(lambda: st.eam_pass3(r, nbr, ev, dfe), 20))
    for k, (ms, plain) in times.items():
        rows[k] = kernel_row(sim, k, launches, errs[k], ms, plain)
    say("timing", f"K1 at the same state: pass1 {k1_here[0]:.4f} ms, "
        f"pass3 {k1_here[1]:.4f} ms; |f_half - f_full|max final "
        f"{d_final:.3e} (initial {d_init[0]:.3e})")
    del sim, r, hm, nbr, ev, dfe

    # 9. LJ at 63^3: full shell (K1) and --halfShell (K2)
    lj_e0 = []
    for half, key in ((False, "lj"), (True, "half_lj")):
        sim, launches = run_main(
            "LJ half main" if half else "LJ main", (key,), half_shell=half,
            on_init=None if half else lambda x: lj_e0.append(x.e_potential))
        if not half:
            lj_ms = sim.ms_step
        errs = compare_lj(sim, f"{HEADLINE_N}^3 float32", 1e-4, 1e-5)
        r, ev, chunk = sim.state.r, sim.pair_eval, sim.cfg.resolved_box_chunk
        fn, plain = ((st.lj_pass_half, st.lj_pass_half_plain) if half
                     else (st.lj_pass, st.lj_pass_plain))
        nbr = sim.maps.half_nbr_map if half else sim.maps.nbr_map
        ms = time_ms(lambda: fn(r, nbr, ev, want_energy=False), 20)
        plain_ms = time_ms(lambda: plain(r, nbr, ev, want_energy=False,
                                         box_chunk=chunk), 2)
        rows[key] = kernel_row(sim, key, launches, errs[key], ms, plain_ms)
        del sim, r, ev, nbr

    # 10. K3 and K4 against their plain versions, thermalized 10^3 EAM
    for dtype in ("float32", "float64"):
        sim = init_simulation(Config(
            nx=10, ny=10, nz=10, doeam=True, temperature=600.0,
            dtype=dtype, pot_dir=POTS, device="cuda", comm_impl="ki_fused",
            **MESH))
        sim.step_block(10)
        check_comm(sim, f"10^3 {dtype} 2x2x2 A={sim.cfg.max_atoms} "
                        f"grid={sim.geom.grid}")
        del sim

    # 11. sharded goldens (f64, T = 0)
    for half in (False, True):
        golden(f"Adams Cu 6^3 T=0 2x2x2 ki_fused"
               f"{' --halfShell' if half else ''}", GOLDEN_EAM_ADAMS,
               nx=6, ny=6, nz=6, doeam=True, half_shell=half,
               comm_impl="ki_fused", **MESH)
    golden("LJ 12x8x4 T=0 3x2x1 ki", GOLDEN_LJ, nx=12, ny=8, nz=4, xproc=3,
           yproc=2, zproc=1, comm_impl="ki")

    # 12. the headline on a 2x2x2 mesh of shards: ki_fused, ki, collective
    final, launches, one_proc = {}, {}, {}
    steps = 100                          # run_main's 10 x step_block(10)
    for ci in ("ki_fused", "ki", "collective"):
        keys = ("eam_pass1", "eam_pass3", "halo_fill")
        e0 = []
        sim, launches[ci] = run_main(
            f"sharded main {ci}", keys, doeam=True, comm_impl=ci,
            on_init=lambda x: e0.append(x.e_potential), **MESH)
        rel = abs(e0[0] / serial_epot[0] - 1.0)
        check(rel < 1e-6, f"sharded {ci}: initial ePot {e0[0]!r} vs serial "
              f"{serial_epot[0]!r}")
        say("sharded main", f"{ci}: initial ePot rel. diff to the serial "
            f"run {rel:.3e}; {sim.ms_step:.3f} ms/step on 8 shards against "
            f"{serial_ms:.3f} serial (phase 5)")
        # every transport fills dfEmbed with one halo_fill a force (the
        # initial one and every step); an atom exchange is three ring_push
        # launches under ki and ki_fused, three atom_pack under collective
        n_fill = launches[ci]["halo_fill"]
        exchanges = sim.n_rebucket + 1   # the rebuckets and the first
        stage_key = "atom_pack" if ci == "collective" else "ring_push"
        other = "ring_push" if ci == "collective" else "atom_pack"
        n_stage = launches[ci][stage_key]
        check(n_fill == steps + 1,
              f"sharded {ci}: {n_fill} fill launches for the initial "
              f"force and {steps} steps, not one a force")
        # the cell path's phases: one launch over the 8 shards' stack
        want = {"eam_pass1": steps + 1, "eam_pass3": steps + 1,
                "embed_fill": steps + 1, "kick_drift_trigger": steps,
                "land": steps}
        got = {k: launches[ci][k] for k in want}
        check(got == want, f"sharded {ci}: the stacked phases launched "
              f"{got}, not {want} (one launch over every shard a phase)")
        say("sharded main", f"{ci}: {got}: one launch a phase over the "
            f"8 shards' stack")
        check(n_stage == 3 * exchanges and launches[ci][other] == 0 and
              launches[ci]["fold_halo"] == 0,
              f"sharded {ci}: {n_stage} {stage_key} launches for "
              f"{exchanges} atom exchanges, not three each ({other} "
              f"{launches[ci][other]}, fold_halo "
              f"{launches[ci]['fold_halo']})")
        say("sharded main", f"{ci}: halo_fill launched {n_fill} times "
            f"(one a force: the initial one and every step), {stage_key} "
            f"{n_stage} times ({exchanges} atom exchanges, three stages "
            f"each), {other} 0")
        exchanges = sim.n_rebucket + 1
        got = {k: launches[ci][k] for k in ARRIVALS_KEYS}
        want = {"arrivals_bin": 3 * exchanges,
                "arrivals_place": 3 * exchanges, "sort_cells": exchanges}
        check(got == want, f"sharded {ci}: the unload's kernels launched "
              f"{got}, not {want} ({exchanges} atom exchanges)")
        say("sharded main", f"{ci}: the unload's kernels launched {got}: "
            f"one bin and one place launch a stage over the 8 shards and "
            f"one sort an exchange ({exchanges} atom exchanges)")
        n_pos = launches[ci]["position_fill"]
        refreshes = steps - sim.n_rebucket
        check(n_pos == refreshes and
              launches[ci]["position_fill_stage"] == 0,
              f"sharded {ci}: position_fill launched {n_pos} times in "
              f"{steps} steps with {sim.n_rebucket} rebuckets, not one a "
              f"ghost refresh ({refreshes})")
        say("sharded main", f"{ci}: position_fill launched {n_pos} times: "
            f"one a step that does not rebucket ({refreshes} ghost "
            f"refreshes in {steps} steps)")
        if ci != "collective":
            one_proc[ci] = (launches[ci]["halo_fill"],
                            launches[ci]["ring_push"], sim.n_rebucket + 1,
                            steps)
        final[ci] = ([s.r for s in sim.states], sim.e_potential)
        if ci == "collective":
            coll = dict(e_pot=sim.e_potential, ms=sim.ms_step,
                        digest=r_digest([s.r.cpu().numpy()
                                         for s in sim.states]))
        if ci == "ki_fused":
            sharded = sim
        else:
            del sim
    for ci in ("ki", "collective"):
        same_r = all(torch.equal(a, b) for a, b in zip(final["ki_fused"][0],
                                                         final[ci][0]))
        check(same_r and final["ki_fused"][1] == final[ci][1],
              f"ki_fused and {ci} differ: r equal {same_r}, ePot "
              f"{final['ki_fused'][1]!r} vs {final[ci][1]!r}")
    say("sharded main", f"final r and ePot of ki_fused, ki and collective "
        f"equal bit for bit (ePot {final['ki_fused'][1]:.6f})")
    mesh_epot = {ci: e for ci, (_r, e) in final.items()}
    del final
    errs, (dfe, rhobar) = check_comm(sharded, f"{HEADLINE_N}^3 float32 2x2x2")
    from comd_tpu_torch.parallel import exchange, ki_comm
    h, f_eval = sharded.halo, sharded.f_eval
    x = [d.clone() for d in dfe]
    plan = ki_comm.fill_plan(h, x[0])
    fields = [[getattr(s, k) for s in sharded.states]
              for k in ("r", "p", "gid", "n_atoms")]
    aplans = [ki_comm.atom_plan(h, axis, fields) for axis in range(3)]

    def stages(push):
        for ap in aplans:
            push(ap, fields)

    table_bytes = f_eval.table.numel() * f_eval.table.element_size()
    timed = {     # key: (kernel, plain version, (bound ms, by), calls)
        "halo_fill": (lambda: cm.halo_fill(plan, x),
                      lambda: cm.halo_fill_plain(plan, x),
                      fill_bound(plan), 1),
        "halo_fill_fused": (
            lambda: cm.halo_fill(plan, x, rhobar, f_eval),
            lambda: cm.halo_fill_plain(plan, x, rhobar, f_eval),
            fill_bound(plan, table_bytes), 1),
        "ring_push": (lambda: stages(cm.ring_push),
                      lambda: stages(cm.ring_push_plain),
                      (sum(push_bound(ap)[0] for ap in aplans) / 3,
                       "bytes"), 3),
    }
    launched = {"halo_fill": launches["ki"]["halo_fill"],
                "halo_fill_fused": launches["ki_fused"]["halo_fill"],
                "ring_push": launches["ki_fused"]["ring_push"]}
    what = {"halo_fill": "one fill (ki)",
            "halo_fill_fused": "one fill (ki_fused)",
            "ring_push": "one atom stage push (mean of the 3 stages)"}
    timing = {}
    for k, (fn, plain, (b_ms, b_by), calls) in timed.items():
        ms = time_ms(fn, 20) / calls
        plain_ms = time_ms(plain, 20) / calls
        host, dev = (t / calls for t in host_and_device_ms(fn))
        timing[k] = (ms, host, dev)
        say("timing", f"{k}, {what[k]}: {ms:.4f} ms (CUDA events, mean of "
            f"20); host {host:.4f} ms a call, device {dev:.5f} ms "
            f"(torch.profiler); plain {plain_ms:.4f} ms; bound {b_ms:.6f} ms "
            f"({b_by}); {launched[k]} launches in the main path's run (init "
            f"and {steps} steps)")
        rows[k] = {"name": k, "route": "cuda", "source": COMM_SOURCE,
                   "replaces": REPLACES[k], "launches": launched[k],
                   "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    # K3's fill is a static row copy: one index_select on a composed
    # index computes it (the library call); the fused fill (K4's F') and
    # the atom message (four fields, three shapes) have no single call
    lib_ms, lib_err = fill_library(plan, x)
    check(lib_err == 0, f"index_select on the composed index is "
          f"{lib_err:.3e} from halo_fill")
    rows["halo_fill"]["library_ms"] = lib_ms
    say("timing", f"halo_fill (ki) as one torch.index_select of the "
        f"stacked [{len(x)} x {x[0].shape[0]}, {x[0].shape[1]}] field on "
        f"the composed row index: {lib_ms:.4f} ms (CUDA events, mean of "
        f"20), the same bits; halo_fill {timing['halo_fill'][0]:.4f} ms")
    # what the fill's device time is made of: the same launch cut to its
    # first one and two stages (one stage has no grid barrier)
    cut = [cm.FillPlan(plan.stages[:k], plan.shape, plan.dtype, plan.device)
           for k in (1, 2)] + [plan]
    dev_by_stages = [host_and_device_ms(lambda: cm.halo_fill(p, x))[1]
                     for p in cut]
    say("timing", "halo_fill (ki) cut to its first 1, 2, 3 stages: device "
        + ", ".join(f"{1e3 * d:.2f}" for d in dev_by_stages) + " us "
        f"(torch.profiler); a further stage and its grid barrier "
        f"{1e3 * (dev_by_stages[2] - dev_by_stages[0]) / 2:.2f} us")
    # the collective transport's fill, torch ops: a comparison for the
    # kernel's, not a library call (no single PyTorch call does a fill)
    ms = time_ms(lambda: exchange.exchange_scalar(h, x), 20)
    host, dev = host_and_device_ms(lambda: exchange.exchange_scalar(h, x))
    say("timing", f"collective fill (exchange.exchange_scalar, torch ops; "
        f"the comparison for halo_fill): {ms:.4f} ms (CUDA events, mean of "
        f"20); host {host:.4f} ms a call, device {dev:.5f} ms "
        f"(torch.profiler); bound {fill_bound(plan)[0]:.6f} ms (bytes)")
    rows["halo_fill_stage"] = stage_row(sharded, x, rhobar, table_bytes)
    del x, dfe, rhobar, fields
    # 23. the mesh's phases as one launch over its stack (on this state)
    rows.update(run_stacked(sharded, headline, launches["ki_fused"]))
    del sharded

    # 13. the archive probes P1-P6 on their kernels
    rows.update(run_probes(k1_pass1))

    # 14. the Verlet-list kernels NL1/NL2 and the NL paths
    rows.update(run_nl(serial_ms, lj_ms, k1_pass1))

    # 15. -P, -I and the run tools
    rows.update(run_options(serial_ms, lj_ms, (k1_ms["eam_pass1"][0],
                                               k1_ms["eam_pass3"][0])))

    # 16. -a 1 of the cell methods on the mesh, and -m cta_cell -P
    run_split(serial_epot[0], lj_e0[0], mesh_epot)

    # 17. the multi-process launch on the one card
    rows["halo_fill_stage"]["launches"] = run_multiproc(
        serial_epot[0], coll, one_proc, timing)

    # 18. the CUDA graphs of the step against the eager loop: lazy and
    # list steps (the rebucket a conditional node) and -S 0 (the eager
    # mesh run cut to 20 steps)
    rows["set_condition"] = run_trigger_handles(headline)
    for tag, kw, blocks in (
            ("EAM K1", dict(doeam=True), 10),
            ("LJ K1", dict(doeam=False), 10),
            ("EAM -m thread_atom_nl", dict(doeam=True,
                                           method="thread_atom_nl"), 10),
            ("EAM 2x2x2 ki_fused", dict(doeam=True, comm_impl="ki_fused",
                                        **MESH), 10),
            ("EAM -m thread_atom_nl 2x2x2 ki", dict(
                doeam=True, method="thread_atom_nl", comm_impl="ki",
                **MESH), 10),
            ("EAM 2x2x2 collective", dict(doeam=True,
                                          comm_impl="collective", **MESH),
             10),
            ("-S 0 EAM K1", dict(doeam=True, lazy_shell=False), 10),
            ("-S 0 EAM 2x2x2 ki_fused -a 0", dict(
                doeam=True, lazy_shell=False, comm_impl="ki_fused",
                gpu_async=0, **MESH), 2),
            ("-S 0 EAM 2x2x2 ki_fused -a 1", dict(
                doeam=True, lazy_shell=False, comm_impl="ki_fused",
                gpu_async=1, **MESH), 2)):
        out = graph_vs_eager(tag, blocks=blocks, **kw)
        say_graph_vs_eager(tag, out)
        if "thread_atom_nl" in tag:
            # the list step's device operations a step, the row ops on
            # their launches (serially <= 10, on the mesh <= 120)
            cap = 120 if "2x2x2" in tag else 10
            ops = out["graphs"]["device_ops"]
            check(ops <= cap, f"{tag}: {ops:.2f} device operations a "
                  f"graph step, more than {cap}")
            say("graphs", f"{tag}: {ops:.2f} device operations a step "
                f"through the graphs (at most {cap})")
    # --halfShell: K2's f32 sums use atomics, so in f64 the printed
    # energies (12 digits) may differ by one unit in the last digit
    half = graph_vs_eager("EAM --halfShell f64 20^3", n=20,
                          dtype="float64", blocks=2, doeam=True,
                          half_shell=True)
    say_graph_vs_eager("EAM --halfShell f64 20^3", half, bitwise=False)
    gap = max(abs(float(f"{a:.12f}") - float(f"{b:.12f}"))
              for a, b in zip(half["eager"]["e_atom"],
                              half["graphs"]["e_atom"]))
    check(gap <= 1.5e-12, f"--halfShell graphs and eager print energies "
          f"{gap:.3e} eV/atom apart")
    say("graphs", f"EAM --halfShell f64 20^3: potential and total energy "
        f"per atom {half['graphs']['e_atom'][0]:.12f}, "
        f"{half['graphs']['e_atom'][1]:.12f}; printed digits "
        f"{gap:.1e} eV/atom from the eager loop's")
    # --halfShell on the 2x2x2 mesh: the folds are fold_halo's stage
    # launches (deterministic); K2's atomics still order its f64 sums
    # run by run, so the bits are reported and the printed digits held
    tag = "EAM --halfShell f64 20^3 2x2x2 collective"
    half = graph_vs_eager(tag, n=20, dtype="float64", blocks=2, doeam=True,
                          half_shell=True, comm_impl="collective", **MESH)
    say_graph_vs_eager(tag, half, bitwise=False)
    gap = max(abs(float(f"{a:.12f}") - float(f"{b:.12f}"))
              for a, b in zip(half["eager"]["e_atom"],
                              half["graphs"]["e_atom"]))
    folds = {m: half[m]["launches"].get("fold_halo", 0) / half[m]["steps"]
             for m in ("eager", "graphs")}
    check(gap <= 1.5e-12 and folds["eager"] >= 6,
          f"{tag}: printed energies {gap:.3e} eV/atom apart, fold_halo "
          f"launches a step {folds}")
    same = (half["eager"]["digest"] == half["graphs"]["digest"] and
            half["eager"]["e_pot"] == half["graphs"]["e_pot"])
    say("graphs", f"{tag}: printed digits {gap:.1e} eV/atom from the eager "
        f"loop's; final r and ePot bit for bit equal: {same}; fold_halo "
        f"launches a step {folds} (three stages a fold)")

    # 19. the step's small ops (csrc/step.cu) against their plain versions
    rows.update(run_step_ops(headline, launches_main))
    rows.update(run_rebucket(headline, launches_main))
    del headline

    # 20. the atom exchange's unload (csrc/arrivals.cu)
    rows.update(run_arrivals(launches["ki_fused"]))

    # 21. the mesh's ghost-position refresh (csrc/comm.cu position_fill)
    rows.update(run_positions(launches["ki_fused"]))

    # 22. the collective atom messages and the half-shell fold
    # (csrc/comm.cu atom_pack, fold_halo)
    rows.update(run_collective(launches["collective"], launches_half))

    kernels = [rows[k] for k in ("eam_pass1", "eam_pass3", "lj",
                                 "half_eam_pass1", "half_eam_pass3",
                                 "half_lj", "halo_fill", "halo_fill_fused",
                                 "ring_push", "halo_fill_stage")
               + PROBE_KEYS + ("nl_build", "nl_sweep") + ROWS_KEYS
               + OPTION_KEYS
               + ("set_condition",) + STEP_KEYS + REBUCKET_KEYS
               + ARRIVALS_KEYS + ("position_fill", "atom_pack",
                                  "fold_halo") + STACKED_KEYS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(int(sys.argv[2]), int(sys.argv[3]),
                           int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit(main())
