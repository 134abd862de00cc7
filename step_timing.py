#!/usr/bin/env python3
"""Time the step's small kernels (csrc/step.cu), the serial and the mesh's
rebucket body (csrc/rebucket.cu, csrc/arrivals.cu), the mesh's ghost
refresh, the half-shell fold and the collective atom messages
(csrc/comm.cu) and the step graph's branch of one or more source trees
on one GPU, in turns.

    python3 step_timing.py [--cases REGEX] [TREE ...]

Each TREE is a checkout of this repository (default: this one).  One
worker process a tree builds that tree's kernels and, on the 63^3 EAM
headline state (f32, rhobar and phi from K1's pass 1), times in CUDA
graphs (CUDA events around replays; ms a launch):

  embed_fill         pass 2 without energy, the serial halo fill (the
                     main path's call, 99 steps of 100)
  embed_fill energy  with U, serial fill;  embed_fill zero halo: no fill
  embed_fill A=15    one slot fewer a row (A = 16: the one-slot form)
  kick_drift_trigger the trigger's launch, no handles, no images
  head               the serial step's head with its ghost refresh: the
                     trigger with the image map (one launch), or on a
                     tree without it the trigger and refresh_halo
  mesh head          the 2x2x2 mesh's head on eight shard-sized copies
                     (21^3 local cells of 23^3): on a tree with the
                     stacked step kernels (step.MAX_SHARDS) one trigger
                     launch over their stack, else eight launches and the
                     or of their flags (torch.stack and any, or each
                     launch after the first or-ing into the flag)
  mesh embed_fill, mesh land
                     pass 2 (no energy, zero halo) and the landing (two
                     passes) of those eight shards: one launch over the
                     stack, or eight
  refresh_halo       the ghost refresh of the positions alone
  halo fill          binning.fill_halo_serial: r, gid and n_atoms (one
                     launch, or refresh_halo and two index copies)
  rebucket body      the serial step's rebucket branch (sim.
                     _rebucket_step: the redistribution in place, the
                     halo fill, the baseline, the counter; on a tree
                     without csrc/rebucket.cu the torch ops, the copies
                     and the baseline's copy)
  rebucket_bin, rebucket_place
                     each kernel's device ms a launch in that body
                     (torch.profiler over 20 bodies, mean a launch); on a
                     tree with rebucket.place_form also "rebucket body
                     block form" and "rebucket_place block form": the
                     place launch in its block form on the same state
  mesh rebucket body the 2x2x2 ki_fused mesh's (eight shard rebuckets,
                     the atom exchange's three ring_push stages and
                     their unloads, the sort, the copies into the step's
                     buffers; on a tree without csrc/arrivals.cu the
                     unload and the sort as torch ops), 2 calls a graph
  unload (graph)     the 2x2x2 ki mesh's atom exchange alone (3
                     ring_push, 3 arrivals_bin, 3 arrivals_place, the
                     sort into other tensors) on a displaced state (every
                     shard's local atoms moved by up to 0.5 A, numpy seed
                     61, rebucketed with the halo landers kept: ~100k
                     arrivals a stage), the state's restore taken out
  unload arrivals_bin, unload arrivals_place, unload sort_cells
                     each kernel's device ms a launch in that unload
                     (torch.profiler over 20 unloads, mean a launch)
  mesh refresh body  the 2x2x2 ki_fused mesh's ghost refresh, the lazy
                     step's other IF body (sim._refresh: one
                     position_fill launch, or on a tree without it the
                     staged torch exchange), 5 calls a graph
  mesh refresh position_fill
                     that launch's device ms (torch.profiler over 20
                     refreshes, mean a launch), on a tree that has it
  fold serial        the half-shell fold's one launch at the 63^3
                     --halfShell geometry, [3, B, A] f32 noise (device
                     ms, torch.profiler over 20 folds, mean a launch)
  fold mesh          the 2x2x2 mesh's fold (ki_comm.fold_halo_ki), its
                     three stage launches together (3 x the mean a
                     launch over 20 folds)
  atom_pack stage    collective's atom messages of one stage (one launch,
                     every shard and both faces) at the displaced 63^3
                     f32 2x2x2 collective state (numpy seed 81, up to
                     0.5 A, rebucketed with the halo landers kept): the
                     mean a launch over the three stages' plans
  nl_rows            NR, a build's rows at the 63^3 EAM -m thread_atom_nl
                     state (f32), no split; nl_rows split: the -a 1 split;
                     nl_rows first launch, second launch: each launch's
                     device ms (torch.profiler over 20 builds, mean a
                     launch)
  embed_rows         ER at that state (rho and phi from NL2's pass 1), the
                     main path's call: no energy, the serial fill;
                     embed_rows energy: with U; embed_rows zero halo: the
                     mesh's; on a tree with rows_width also its scalar
                     form (one slot a thread, with and without energy)
  branch             one replay of a graph of the serial step's head and
                     its IF nodes (the rebucket's body one small kernel):
                     the trigger with the images and one IF node, or on a
                     tree without them the trigger, the rebucket's node
                     and the refresh's (refresh_halo its body)

and, where the tree has them (ops/cuda/step.py's EMBED_BLOCKS_PER_SM
and embed_width), embed_fill's launch forms, with and without energy,
the median of 3 rounds taken in turn: one vector a thread, and grids of
2, 4 and 8 blocks an SM with a grid-stride loop; one slot a thread and
4 (U's f64 in two 16-byte stores); likewise, where the tree has
HALO_BLOCKS_PER_SM and halo_width, the halo fill's: a block to every
64 rows (one vector a thread), grids of 1, 2, 4 and 8 blocks an SM,
and one slot a thread.  The
workers run in the order given and then in reverse (give the parent and
this tree: parent, change, change, parent).  ``--cases REGEX`` times
only the cases whose names it matches (the launch forms' names start
with "embed_fill " and "halo fill "), and starts the mesh only for a
mesh, unload or fold case (e.g. "fold|atom_pack": the two folds and the
atom messages).  Prints the card's name and power limit, one JSON
line a worker, then one JSON line of each tree's means.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CALLS, REPS = 20, 20


def graph_ms(torch, fn, calls: int = CALLS, reps: int = REPS) -> float:
    """ms a call of ``fn``: ``calls`` calls captured into one CUDA graph,
    replayed ``reps`` times between CUDA events."""
    from comd_tpu_torch.probes import time_ms
    from comd_tpu_torch.stepgraph import cuda_capture
    fn()
    graph = cuda_capture(lambda: [fn() for _ in range(calls)],
                         torch.cuda.graph_pool_handle())[0]
    return time_ms(graph.replay, reps) / calls


def has_images(step) -> bool:
    """The tree's trigger writes the serial ghost images."""
    return "images" in inspect.signature(step.kick_drift_trigger).parameters


def branch_ms(torch, sim, p, r, f, last, reps: int = 200) -> float:
    """ms a replay of a graph of the serial step's head and IF nodes (the
    rebucket's body one small kernel), built with this tree's graph_if
    API: the trigger with the images and one node, or the trigger, the
    rebucket's node and the refresh's (refresh_halo its body)."""
    from comd_tpu_torch.ops.cuda import graph_if
    from comd_tpu_torch.ops.cuda import step
    from comd_tpu_torch.probes import time_ms
    from comd_tpu_torch.stepgraph import cuda_capture
    geom, maps, nl, skin = sim.geom, sim.maps, sim.geom.n_local, sim.skin
    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    hits = torch.zeros(1, dtype=torch.int32, device="cuda")
    bodies = graph_if.BodyPool("cuda")
    handles = hasattr(graph_if, "condition")
    fused = has_images(step)

    def rebucket():
        hits.add_(1)

    def refresh():
        step.refresh_halo(geom, maps, r)

    def fn():
        if fused:
            cond = graph_if.condition("cuda", 1)
            cond.flag = step.kick_drift_trigger(
                p, r, f, last, nl, kick, drift, skin,
                handles=cond.handles, images=maps.images)
            graph_if.if_node(cond, 0, rebucket, bodies)
        elif handles:
            cond = graph_if.condition("cuda")
            cond.flag = step.kick_drift_trigger(
                p, r, f, last, nl, kick, drift, skin,
                handles=cond.handles)
            for k, body in enumerate((rebucket, refresh)):
                graph_if.if_node(cond, k, body, bodies)
        else:
            flag = step.kick_drift_trigger(p, r, f, last, nl, kick, drift,
                                           skin)
            for k, body in enumerate((rebucket, refresh)):
                graph_if.if_node(flag, body, bool(k), bodies)

    step.kick_drift_trigger(p, r, f, last, nl, kick, drift, skin)
    refresh()
    graph = cuda_capture(fn, torch.cuda.graph_pool_handle())[0]
    return time_ms(graph.replay, reps)


def displaced(torch, mesh, seed: int, scale: float = 0.5) -> list:
    """The mesh's shards with every local atom moved by up to ``scale`` A
    (numpy, seeded) and rebucketed with the halo landers kept: (r, p,
    gid, n_atoms) lists, the state an atom exchange starts from."""
    import numpy as np
    from comd_tpu_torch.ops import binning
    rng = np.random.default_rng(seed)
    nl = mesh.geom.n_local
    start = []
    for s in mesh.states:
        A = s.r.shape[2]
        r = s.r.clone()
        valid = torch.arange(A, device="cuda")[None, :] < \
            s.n_atoms[:nl, None]
        d = torch.as_tensor(rng.uniform(-scale, scale, (3, nl, A)),
                            dtype=r.dtype, device="cuda")
        r[:, :nl] += torch.where(valid[None], d, torch.zeros_like(d))
        start.append(binning.rebucket(mesh.geom, mesh.maps, r, s.p, s.gid,
                                      s.n_atoms, keep_halo=True)[:4])
    return [list(f) for f in zip(*start)]


def unload_times(torch, mesh, seed: int = 61, scale: float = 0.5,
                 reps: int = 20) -> dict:
    """The mesh's atom-exchange unload on a displaced state: the unload
    replayed in a graph (its restore taken out) and each of its kernels'
    device ms a launch (torch.profiler; profiled again, eight times at
    most, while a kernel has no record)."""
    from comd_tpu_torch.ops.cuda import arrivals as av
    from comd_tpu_torch.parallel import ki_comm
    start = displaced(torch, mesh, seed, scale)
    work = [[t.clone() for t in x] for x in start]
    out = [[torch.empty_like(t) for t in x] for x in start[:3]]

    def restore():
        for w, b in zip(work, start):
            for x, y in zip(w, b):
                x.copy_(y)

    def unload():
        restore()
        ki_comm.exchange_atoms_ki(mesh.halo, *work)
        av.sort_shards(*work[:3], out)

    res = {"unload (graph)": graph_ms(torch, unload)
           - graph_ms(torch, restore)}
    res.update(kernel_ms(torch, unload, {
        "arrivals_bin_kernel": "unload arrivals_bin",
        "arrivals_place_kernel": "unload arrivals_place",
        "sort_cells": "unload sort_cells"}, reps))
    return res


def pack_times(torch) -> dict:
    """The collective transport's atom_pack at the displaced 63^3 f32
    2x2x2 state (numpy seed 81, up to 0.5 A): device ms a launch, the
    mean of the three stages' plans (torch.profiler)."""
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.parallel import exchange
    sim = init_simulation(Config(
        nx=63, ny=63, nz=63, doeam=True, temperature=600.0,
        dtype="float32", max_atoms=0, cell_mode="auto",
        pot_dir=os.path.join(ROOT, "pots"), device="cuda",
        comm_impl="collective", xproc=2, yproc=2, zproc=2))
    r, p, gid, n_atoms = displaced(torch, sim, 81)
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    plans = [exchange.pack_plan(sim.halo, axis, r[0]) for axis in range(3)]

    def packs():
        for pl in plans:
            cm.atom_pack(pl, r, p, gid, n_atoms, flag)
    return kernel_ms(torch, packs, {"atom_pack_kernel": "atom_pack stage"})


def fold_times(torch, mesh, want) -> dict:
    """The half-shell fold's device ms (torch.profiler) on [3, B, A] f32
    noise: serially one launch at the 63^3 --halfShell geometry; on the
    2x2x2 ``mesh`` a fold's three stage launches (z, y, x) together."""
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops.cuda import comm as cm
    from comd_tpu_torch.ops.sweep import fold_plan_serial
    from comd_tpu_torch.parallel import ki_comm
    gen = torch.Generator(device="cuda").manual_seed(82)
    out = {}
    if want("fold serial"):
        half = init_simulation(Config(
            nx=63, ny=63, nz=63, doeam=True, temperature=600.0,
            dtype="float32", max_atoms=0, cell_mode="auto",
            half_shell=True, pot_dir=os.path.join(ROOT, "pots"),
            device="cuda"))
        x = torch.rand((3, half.geom.n_total, half.cfg.max_atoms),
                       device="cuda", generator=gen) - 0.5
        plan = fold_plan_serial(half.maps, x)
        out.update(kernel_ms(torch, lambda: cm.fold_halo(plan, [x]),
                             {"fold_halo_kernel": "fold serial"}))
        del half, x, plan
    if want("fold mesh"):
        shape = (3, mesh.geom.n_total, mesh.cfg.max_atoms)
        xs = [torch.rand(shape, device="cuda", generator=gen) - 0.5
              for _ in mesh.states]
        got = kernel_ms(torch, lambda: ki_comm.fold_halo_ki(mesh.halo, xs),
                        {"fold_halo_kernel": "fold mesh"})
        out["fold mesh"] = 3 * got["fold mesh"]
    return out


def kernel_ms(torch, fn, kernels: dict, reps: int = 20) -> dict:
    """{kernels[name]: device ms a launch} of the kernels whose names hold
    each key of ``kernels``, over ``reps`` calls of ``fn`` under
    torch.profiler (profiled again, eight times at most, while a kernel
    has no record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    res = {}
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not e.count:
                continue
            for name, key in kernels.items():
                if name in e.key and key not in res:
                    res[key] = getattr(e, "self_device_time_total", getattr(
                        e, "self_cuda_time_total", 0.0)) / e.count / 1e3
        if all(k in res for k in kernels.values()):
            return res
    raise RuntimeError(f"torch.profiler kept no record of "
                       f"{[k for k in kernels.values() if k not in res]}")


def embed_forms(torch, step, embed, rounds: int = 3) -> dict:
    """embed_fill's launch forms, with and without energy, each timed
    once a round over ``rounds`` rounds in turn (the median): the grid
    (one vector a thread, or 2, 4, 8 blocks an SM) at the wrapper's
    width, and at the wrapper's grids one slot a thread or 4 (U in f64
    then in two 16-byte stores)."""
    width, grid = step.embed_width, step.EMBED_BLOCKS_PER_SM
    forms = {("one vector a thread" if n is None else f"{n} blocks/SM"):
             ({False: n, True: n}, width) for n in (None, 2, 4, 8)}
    forms["one slot a thread"] = (grid, lambda *a: 1)
    forms["4 slots a thread"] = (grid, lambda A, elem, *a: 16 // elem)
    times = {}
    try:
        for _ in range(rounds):
            for form, (n, w) in forms.items():
                step.EMBED_BLOCKS_PER_SM, step.embed_width = n, w
                for energy in (False, True):
                    times.setdefault(
                        "embed_fill" + (" energy " if energy else " ")
                        + form, []).append(graph_ms(torch,
                                                    embed(energy=energy)))
    finally:
        step.EMBED_BLOCKS_PER_SM, step.embed_width = grid, width
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def halo_forms(torch, step, fill, rounds: int = 3) -> dict:
    """The halo fill's launch forms, each timed once a round over
    ``rounds`` rounds in turn (the median): the grid (a block to every
    256 / (A / width) rows, or 1, 2, 4, 8 blocks an SM) at the wrapper's
    width, and one slot a thread at its grid."""
    width, grid = step.halo_width, step.HALO_BLOCKS_PER_SM
    forms = {("a block to every 256 threads' rows" if n is None
              else f"{n} blocks/SM"): (n, width) for n in (None, 1, 2, 4, 8)}
    forms["one slot a thread"] = (grid, lambda *a: 1)
    times = {}
    try:
        for _ in range(rounds):
            for form, (n, w) in forms.items():
                step.HALO_BLOCKS_PER_SM, step.halo_width = n, w
                times.setdefault("halo fill " + form, []).append(
                    graph_ms(torch, fill))
    finally:
        step.HALO_BLOCKS_PER_SM, step.halo_width = grid, width
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def row_times(torch, want) -> dict:
    """The list paths' NR and ER at the 63^3 EAM -m thread_atom_nl state
    (f32; rho and phi from NL2's pass 1 on the run's list), in CUDA
    graphs: ``nl_rows`` (a build's rows, no split; ``nl_rows split``
    with the -a 1 row split), ``embed_rows`` (the main path's call: no
    energy, the serial fill), ``embed_rows energy``, ``embed_rows zero
    halo``; each NR launch's device ms (torch.profiler over 20 builds);
    and, on a tree with ``rows_width``, ER's scalar form, one slot a
    thread (the median of 3 rounds, in turn with the wrapper's form)."""
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops import neighborlist as nlmod
    from comd_tpu_torch.ops.cuda import nl as nlk
    from comd_tpu_torch.ops.cuda import step
    sim = init_simulation(Config(
        nx=63, ny=63, nz=63, doeam=True, temperature=600.0,
        dtype="float32", max_atoms=0, cell_mode="auto",
        method="thread_atom_nl", pot_dir=os.path.join(ROOT, "pots"),
        device="cuda"))
    s, lst, nl = sim.state, sim.nlist, sim.geom.n_local
    B, A = s.r.shape[1:]
    R = lst.a_list.shape[0]
    _f1, phi, rho = nlk.eam_pass1(lst, s.r, sim.pair_eval)
    is_b, ri, rb = nlmod.row_split_for(sim.geom, A)
    split = (torch.as_tensor(is_b, device="cuda"), ri, rb)

    def rows(rs=None):
        return lambda: nlk.nl_rows(sim.geom, s.n_atoms, A, R, rs)

    def embed(energy=False, src=sim.maps.halo_src):
        return lambda: step.embed_rows(
            sim.f_eval, lst, s.n_atoms, (rho,), (phi,) if energy else None,
            nl, B, src, sim.cfg.torch_energy_dtype)

    cases = {"nl_rows": rows(), "nl_rows split": rows(split),
             "embed_rows": embed(), "embed_rows energy": embed(True),
             "embed_rows zero halo": embed(src=None)}
    out = {name: graph_ms(torch, fn) for name, fn in cases.items()
           if want(name)}
    if want("nl_rows "):
        out.update(kernel_ms(torch, rows(), {
            "nl_rows_scan_kernel": "nl_rows first launch",
            "nl_rows_tile_kernel": "nl_rows first launch",
            "nl_rows_fill_kernel": "nl_rows second launch"}))
    if want("embed_rows ") and hasattr(step, "rows_width"):
        width = step.rows_width
        forms = {"one vector a thread": width,
                 "one slot a thread": lambda *a: 1}
        times = {}
        try:
            for _ in range(3):
                for form, w in forms.items():
                    step.rows_width = w
                    for energy in (False, True):
                        times.setdefault(
                            "embed_rows" + (" energy " if energy else " ")
                            + form, []).append(
                                graph_ms(torch, embed(energy)))
        finally:
            step.rows_width = width
        out.update({k: sorted(v)[len(v) // 2] for k, v in times.items()})
    return out


def rebucket_kernels(torch, sim) -> dict:
    """The serial rebucket body's kernels, device ms a launch, and on a
    tree with ``place_form`` the body and the place launch again in the
    block form."""
    from comd_tpu_torch.ops.cuda import rebucket as rb
    if not hasattr(rb, "place_form"):
        return kernel_ms(torch, sim._rebucket_step, {
            "rebucket_bin_kernel": "rebucket_bin",
            "rebucket_place_kernel": "rebucket_place"})
    res = kernel_ms(torch, sim._rebucket_step, {
        "rebucket_bin_kernel": "rebucket_bin",
        "rebucket_place_": "rebucket_place"})
    chosen = rb.place_form
    rb.place_form = lambda _a: "block"
    try:
        res["rebucket body block form"] = graph_ms(torch, sim._rebucket_step)
        res.update(kernel_ms(torch, sim._rebucket_step, {
            "rebucket_place_kernel": "rebucket_place block form"}))
    finally:
        rb.place_form = chosen
    return res


def worker(tree: str, cases_re: str) -> dict:
    """{case: ms} of ``tree``'s kernels at the headline state, the cases
    whose names match ``cases_re``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops import binning
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.ops.cuda import step
    sim = init_simulation(Config(
        nx=63, ny=63, nz=63, doeam=True, temperature=600.0,
        dtype="float32", max_atoms=0, cell_mode="auto",
        pot_dir=os.path.join(ROOT, "pots"), device="cuda"))
    s, maps, nl = sim.state, sim.maps, sim.geom.n_local
    B, A = s.r.shape[1:]
    _f1, phi, rho = st.eam_pass1(s.r, maps.nbr_map, sim.pair_eval)
    e_dtype = sim.cfg.torch_energy_dtype
    rho_1, phi_1 = rho[:, :A - 1].contiguous(), phi[:, :A - 1].contiguous()

    def embed(energy=False, src=maps.halo_src, rh=rho, ph=phi):
        return lambda: step.embed_fill(sim.f_eval, rh, ph if energy else
                                       None, s.n_atoms, B, src, e_dtype)

    kick, drift = sim._c(0.5 * sim.cfg.dt), sim._c(sim.cfg.dt / sim.mass)
    p, r = s.p.clone(), s.r.clone()
    gid, n_atoms = s.gid.clone(), s.n_atoms.clone()
    last = s.r.clone()
    last[:, :nl] += 1e-2

    def head():
        if has_images(step):
            return step.kick_drift_trigger(p, r, s.f, last, nl, kick, drift,
                                           sim.skin, images=maps.images)
        flag = step.kick_drift_trigger(p, r, s.f, last, nl, kick, drift,
                                       sim.skin)
        step.refresh_halo(sim.geom, maps, r)
        return flag

    def fill():
        binning.fill_halo_serial(sim.geom, maps, r, gid, n_atoms)

    cases = {
        "embed_fill": embed(),
        "embed_fill energy": embed(energy=True),
        "embed_fill zero halo": embed(src=None),
        f"embed_fill A={A - 1}": embed(rh=rho_1, ph=phi_1),
        "kick_drift_trigger": lambda: step.kick_drift_trigger(
            p, r, s.f, last, nl, kick, drift, sim.skin),
        "head": head,
        "refresh_halo": lambda: step.refresh_halo(sim.geom, maps, r),
        "halo fill": fill,
    }
    # eight shards of the 2x2x2 mesh: 23^3 cells, the first 21^3 local
    b_s, nl_s = 23 ** 3, 21 ** 3
    shards = [tuple(x[:, :b_s].clone() for x in (s.p, s.r, s.f, last))
              for _ in range(8)]
    add = "add" in inspect.signature(step.kick_drift_trigger).parameters
    stacked = hasattr(step, "MAX_SHARDS")
    stacks = [torch.stack([sh[k] for sh in shards]) for k in range(4)]
    rho_s = [rho[:nl_s].clone() for _ in shards]
    n_s = [s.n_atoms[:b_s].clone() for _ in shards]
    f1_s = [s.f[:, :nl_s].clone() for _ in shards]
    n_out = torch.zeros((), dtype=torch.int32, device="cuda")

    stack_in = [torch.stack(x) for x in (f1_s, n_s, rho_s)]

    def mesh_embed():
        if stacked:
            return step.embed_fill(sim.f_eval, stack_in[2], None,
                                   stack_in[1], b_s, None, e_dtype)
        return [step.embed_fill(sim.f_eval, x, None, n, b_s, None, e_dtype)
                for x, n in zip(rho_s, n_s)]

    def mesh_land():
        if stacked:
            step.land(stacks[2], stacks[0], stack_in[0], stack_in[0],
                      stack_in[1], n_out, nl_s, kick)
            return
        for i, ((ps, _rs, fs, _ls), f1, n) in enumerate(
                zip(shards, f1_s, n_s)):
            step.land(fs, ps, f1, f1, n, n_out, nl_s, kick, add=i > 0)

    def mesh_head():
        if stacked:
            return step.kick_drift_trigger(*stacks, nl_s, kick, drift,
                                           sim.skin)
        flag, flags = None, []
        for ps, rs, fs, ls in shards:
            if add:
                flag = step.kick_drift_trigger(
                    ps, rs, fs, ls, nl_s, kick, drift, sim.skin, flag,
                    add=flag is not None)
            else:
                flags.append(step.kick_drift_trigger(
                    ps, rs, fs, ls, nl_s, kick, drift, sim.skin))
        return flag if add else torch.stack(flags).any()

    cases["mesh head"] = mesh_head
    cases["mesh embed_fill"] = mesh_embed
    cases["mesh land"] = mesh_land
    # the serial redistribution as the lazy step's IF body runs it, on the
    # step's buffers (a canonical state rebucketed again: the same work)
    sim._bind()
    cases["rebucket body"] = sim._rebucket_step
    want = re.compile(cases_re).search
    out = {name: graph_ms(torch, fn) for name, fn in cases.items()
           if want(name)}
    if want("rebucket_"):
        out.update(rebucket_kernels(torch, sim))
    if want("mesh rebucket body") or want("unload ") or \
            want("mesh refresh") or want("fold serial") or \
            want("fold mesh"):
        # the 2x2x2 mesh's (ki_fused in one process): eight rebuckets,
        # the atom exchange and the sort; a graph of 2 calls (a tree
        # whose exchange is torch ops makes thousands of nodes a call)
        mesh = init_simulation(Config(
            nx=63, ny=63, nz=63, doeam=True, temperature=600.0,
            dtype="float32", max_atoms=0, cell_mode="auto",
            pot_dir=os.path.join(ROOT, "pots"), device="cuda",
            comm_impl="ki_fused", xproc=2, yproc=2, zproc=2))
        mesh._bind()
        if want("mesh rebucket body"):
            out["mesh rebucket body"] = graph_ms(
                torch, mesh._rebucket_step, calls=2, reps=5)
        if want("unload "):
            out.update(unload_times(torch, mesh))
        if want("mesh refresh body"):
            out["mesh refresh body"] = graph_ms(torch, mesh._refresh,
                                                calls=5, reps=10)
        from comd_tpu_torch.ops.cuda import comm
        if want("mesh refresh position_fill") and \
                hasattr(comm, "position_fill"):
            out.update(kernel_ms(torch, mesh._refresh, {
                "position_fill_kernel": "mesh refresh position_fill"}))
        out.update(fold_times(torch, mesh, want))
        del mesh
    if want("atom_pack stage"):
        out.update(pack_times(torch))
    if want("nl_rows") or want("embed_rows"):
        out.update(row_times(torch, want))
    if want("branch"):
        out["branch"] = branch_ms(torch, sim, p, r, s.f, last)
    if hasattr(step, "EMBED_BLOCKS_PER_SM") and want("embed_fill "):
        out.update(embed_forms(torch, step, embed))
    if hasattr(step, "HALO_BLOCKS_PER_SM") and want("halo fill "):
        out.update(halo_forms(torch, step, fill))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=[ROOT])
    ap.add_argument("--cases", default="",
                    help="time only the cases whose names match this "
                         "regular expression (default: every case)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.cases)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("step_timing: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = {}
    for tree in args.trees + args.trees[::-1]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", tree, "--cases", args.cases],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"worker {tree} failed:\n{res.stderr[-4000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "ms": got}), flush=True)
        runs.setdefault(tree, []).append(got)
    print(json.dumps({"means": {
        tree: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        for tree, rs in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
