#!/usr/bin/env python3
"""Where the time of the pair kernels goes, on one GPU: the cell-stencil
kernels K1 and K2, or (``--nl``) the list kernels NL1 and NL2.

    python3 stencil_breakdown.py
    python3 stencil_breakdown.py --nl [TREE ...]

Builds comd_tpu_torch/csrc/stencil.cu and copies of it with one part of
the kernel cut out or changed (text edits of the source, each checked to
apply exactly once; nvcc runs for all of them in parallel), then times K1
and K2 at the 63^3 headline states of chip_smoke.py phases 5 and 9 (EAM
passes 1 and 3 without energy, and LJ), every build in turn and then again
in reverse order, 20 launches each.  Only ``full`` computes the right
values; the others exist to be timed:

  full           the kernels as the port builds them
  stage          no walk: staging, used-slot counts and output writes
  walk           the r2 walk and the lists, never drained
  nopair         the drain without the pair function (fc = r2)
  jside_plain    K2's j side with plain, unsynchronized adds
  jside_private  K2's j-side compare-and-swap on a slot of the thread's own
                 (the bank of the real one; no slot shared between threads)
  k2_drain32     K2 with K1's list rule: 64 entries, tiles of up to 32, so a
                 warp drains once a list passes 32 entries (at A = 32)

So walk - stage is the r2 walk, nopair - walk the drain's list and record
reads, full - nopair the pair function, full - jside_plain what K2's j-side
atomicity costs, of which full - jside_private is the sharing of slots.

With ``--nl``, one worker process a TREE (a checkout of this repository,
default this one; give the parent and this tree to compare them: each is
timed in order and then in reverse) builds that tree's csrc/nl.cu and
copies of it, and times NL1 (a build) and NL2 (EAM pass 1 with and
without energy, pass 3; LJ with and without energy) at the 63^3 states of
chip_smoke.py phase 14 (EAM -m thread_atom_nl, LJ -L; the same seed, so
every tree sees the same state; EAM pass 1 also on the rows of the real
atoms alone and on the rows past them): CUDA events over 20 launches (NL1 5),
each build in turn and again in reverse, and the device time a call under
torch.profiler for ``full``.  The copies (NL_EDITS; a source of commit
3c67fe1, one warp a row and no queue, takes NL_PARENT_EDITS; a variant
whose edits do not apply once to a tree's source is left out there):

  full      the kernels as the tree builds them
  walk      NL2 without the pair evaluations: list reads, gathers, r2
            tests and (this design) the queue appends and drain
            bookkeeping, each queued pair read and its x added, nothing
            evaluated
  nopair    NL2's drain with fc = r2 in place of the pair function
  stage     NL1 without the walk: staging, the rows' padding and counts,
            and the invalid rows' padding
  nopad     NL1 without the invalid rows' padding

Prints the card's name and power limit, then one JSON line per build (or
per worker).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE_N = 63

_CAS = "atomic_add4(acc, v);"
EDITS = {
    "full": [],
    "stage": [("const bool busy = __any_sync(kAll, active);",
               "const bool busy = false;")],
    "walk": [("for (int m = 0; m < cnt; ++m) {",
              "for (int m = 0; m < 0; ++m) {")],
    "nopair": [("""const T fc = pair_eval<T, PAIR, EVAL, ENERGY>(
                  cp, tp, lj, sp, r2, di, PAIR == kEam3 ? v.w : T(0), sc);""",
                """const T fc = r2;
#pragma unroll
              for (int q = 0; q < NS; ++q) sc[q] = r2;""")],
    "jside_plain": [(_CAS, "{ float4* a4 = reinterpret_cast<float4*>(acc); "
                           "float4 o = *a4; o.x += v.x; o.y += v.y; "
                           "o.z += v.z; o.w += v.w; *a4 = o; }")],
    "jside_private": [(_CAS, "atomic_add4(reinterpret_cast<float*>(sacc) + "
                             "((t * 8 + (idx & 7)) % nslot) * NACC, v);")],
    "k2_drain32": [("const int jt_max = HALF ? 16 : 32;",
                    "const int jt_max = 32;"),
                   ("s.cap = HALF ? (2 * A + 16 < 120 ? 2 * A + 16 : 120) "
                    ": 64;", "s.cap = 64;")],
}


NL_EDITS = {
    "full": [],
    "walk": [("    if (sub < n) {\n      const Rec<T> v = queue[grp]",
              "    if (sub < n) acc[0] += queue[grp][(h + sub) & "
              "(kQueue - 1)].x;\n    if (false) {\n"
              "      const Rec<T> v = queue[grp]")],
    "nopair": [("pair_eval<T, PAIR, EVAL, ENERGY>(cp, tp, lj, sp, r2, v.w,\n"
                + " " * 52 + "T(0), sc);", "r2 + T(0) * v.w;\n"
                "        for (int q = 0; q < NS; ++q) sc[q] = r2;")],
    "stage": [("for (int base = 0; base < nc; base += 32) {",
               "for (int base = 0; base < 0; base += 32) {")],
    "nopad": [("    pad_rows((blockIdx.x - n_local) * kPadRows, a_list, "
               "a_valid, n_rows, K,\n             nl, count, spad);\n", "")],
}
NL_PARENT_EDITS = {
    "full": [],
    "walk": [("const T fc = pair_eval<T, PAIR, EVAL, ENERGY>(cp, tp, lj, "
              "r2, di, dj,\n" + " " * 54 + "sc);",
              """const T fc = r2 + T(0) * dj;
#pragma unroll
        for (int q = 0; q < NS; ++q) sc[q] = r2;""")],
}


def variant_sources(source: str, out_dir: str, edits=None) -> dict:
    """Write one copy of ``source`` per entry of ``edits`` (default
    EDITS) into out_dir."""
    text = open(source).read()
    stem = os.path.splitext(os.path.basename(source))[0]
    paths = {}
    os.makedirs(out_dir, exist_ok=True)
    for header in re.findall(r'^#include "([^"]+)"', text, re.M):
        shutil.copy(os.path.join(os.path.dirname(source), header), out_dir)
    for name, changes in (EDITS if edits is None else edits).items():
        body = text
        for old, new in changes:
            if body.count(old) != 1:
                raise RuntimeError(f"variant {name}: the edit of "
                                   f"{old[:40]!r} does not apply once")
            body = body.replace(old, new)
        paths[name] = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(paths[name], "w") as fh:
            fh.write(body)
    return paths


def nl_worker(tree: str) -> dict:
    """Times of ``tree``'s NL1/NL2 builds (NL_EDITS, or NL_PARENT_EDITS
    for a source they do not fit) at the phase-14 states:
    {"events_ms": {variant: {call: [ms, ...]}}, "device_ms": {call: ms}}."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops import binning
    from comd_tpu_torch.ops import neighborlist as nlmod
    from comd_tpu_torch.ops.cuda import nl as nlk
    from comd_tpu_torch.ops.cuda.nvcc import build_library
    from comd_tpu_torch.probes import time_ms
    import chip_smoke              # the tree's, for host_and_device_ms
    out_dir = os.path.join(os.path.dirname(nlk.SOURCE), os.pardir, "_build",
                           "nl_variants")
    text = open(nlk.SOURCE).read()
    # each variant's edits for this source (NL_EDITS, else the parent's);
    # a variant neither fits is not built
    edits = {}
    for name in NL_EDITS:
        for table in (NL_EDITS, NL_PARENT_EDITS):
            if name in table and all(text.count(old) == 1
                                     for old, _new in table[name]):
                edits[name] = table[name]
                break
    paths = variant_sources(nlk.SOURCE, out_dir, edits)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(lambda p: build_library(p, "nl"),
                      paths.values()))
    source, libs = nlk.SOURCE, {}
    for name, path in paths.items():      # bind each (built above)
        nlk._lib, nlk.SOURCE = None, path
        libs[name] = nlk.build()
    # the runs build their lists with the kernels as the tree builds them
    nlk.SOURCE, nlk._lib = source, libs["full"]
    times = {name: {} for name in paths}
    device = {}
    for doeam in (True, False):
        sim = init_simulation(Config(
            nx=HEADLINE_N, ny=HEADLINE_N, nz=HEADLINE_N, doeam=doeam,
            temperature=600.0, dtype="float32", max_atoms=0,
            cell_mode="auto", pot_dir=os.path.join(ROOT, "pots"),
            device="cuda", **({"method": "thread_atom_nl"} if doeam
                              else {"use_pairlist": True})))
        sim.step_block(10)
        s, lst, ev = sim.state, sim.nlist, sim.pair_eval
        p = sim.nl_build_params()
        # the build's rows and, where NL1 reads it, their row_start
        # (nl_rows_plain; atom_rows on older trees, whose NL1 derives it)
        if hasattr(nlmod, "nl_rows_plain"):
            a_list, a_valid, start = nlmod.nl_rows_plain(
                sim.geom, s.n_atoms, s.r.shape[2], p["n_rows"],
                p["row_split"])
            kw = dict(row_start=start)
        else:
            a_list, a_valid = nlmod.atom_rows(sim.geom, s.n_atoms,
                                              s.r.shape[2], p["n_rows"],
                                              p["row_split"])
            kw = {}
        tag = "eam" if doeam else "lj"
        fns = {f"{tag} nl_build": (lambda: nlk.nl_build(
            s.r, a_list, a_valid, sim.maps.nbr_map, s.n_atoms, k=p["k"],
            rcut2=p["rcut2"], **kw), 5)}
        if doeam:
            rho = nlk.eam_pass1(lst, s.r, ev)[2]
            dfe = nlmod.scatter_rows(lst, sim.f_eval(rho)[1],
                                     *s.r.shape[1:])
            binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
            for e in (False, True):
                fns[f"pass1 {e}"] = (lambda e=e: nlk.eam_pass1(
                    lst, s.r, ev, want_energy=e), 20)
            fns["pass3"] = (lambda: nlk.eam_pass3(lst, s.r, ev, dfe), 20)
            # pass 1 on the real atoms' rows alone, and on the rest
            n_real = int(lst.a_valid.sum())
            for part, (a, b) in (("real rows", (0, n_real)), (
                    "rows past the atoms", (n_real, lst.nl.shape[0]))):
                fns[f"pass1 False {part}"] = (
                    lambda sl=nlmod.slice_rows(lst, a, b): nlk.eam_pass1(
                        sl, s.r, ev, want_energy=False), 20)
        else:
            for e in (False, True):
                fns[f"lj {e}"] = (lambda e=e: nlk.lj_pass(
                    lst, s.r, ev, want_energy=e), 20)
        for name in list(paths) + list(paths)[::-1]:
            nlk._lib = libs[name]
            for key, (fn, reps) in fns.items():
                times[name].setdefault(key, []).append(time_ms(fn, reps))
        nlk._lib = libs["full"]
        for key, (fn, _reps) in fns.items():
            device[key] = chip_smoke.host_and_device_ms(fn)[1]
        del sim, s, lst, fns
        torch.cuda.empty_cache()
    return {"events_ms": times, "device_ms": device}


def nl_main(trees) -> int:
    """The --nl mode: a worker a tree, in order and then in reverse."""
    runs = {}
    for tree in trees + trees[::-1]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--nl-worker", tree], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"worker {tree} failed:\n{res.stderr[-4000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, **got}), flush=True)
        runs.setdefault(tree, []).append(got)
    means = {}
    for tree, rs in runs.items():
        ev = {}
        for r in rs:
            for name, calls in r["events_ms"].items():
                for call, v in calls.items():
                    ev.setdefault(name, {}).setdefault(call, []).extend(v)
        means[tree] = {
            "events_ms": {n: {c: sum(v) / len(v) for c, v in calls.items()}
                          for n, calls in ev.items()},
            "device_ms": {c: sum(r["device_ms"][c] for r in rs) / len(rs)
                          for c in rs[0]["device_ms"]}}
    print(json.dumps({"means": means}), flush=True)
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nl", nargs="*", metavar="TREE",
                    help="the list kernels of these trees (default: this)")
    ap.add_argument("--nl-worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.nl_worker:
        print(json.dumps(nl_worker(args.nl_worker)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("stencil_breakdown: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.nl is not None:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
            flush=True)
        return nl_main(args.nl or [ROOT])
    from comd_tpu_torch import Config, init_simulation
    from comd_tpu_torch.ops import binning
    from comd_tpu_torch.ops.cuda import stencil as st
    from comd_tpu_torch.ops.cuda.nvcc import build_library
    from comd_tpu_torch.probes import time_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    paths = variant_sources(st.SOURCE, os.path.join(st.BUILD_DIR, "variants"))
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(lambda p: build_library(p, "stencil"),
                      paths.values()))
    source, libs = st.SOURCE, {}
    for name, path in paths.items():      # bind each (built above)
        st._lib, st.SOURCE = None, path
        libs[name] = st.build()
    st.SOURCE, st._lib = source, libs["full"]   # the runs' own forces

    times = {name: {} for name in paths}
    for doeam in (True, False):
        sim = init_simulation(Config(
            nx=HEADLINE_N, ny=HEADLINE_N, nz=HEADLINE_N, doeam=doeam,
            temperature=600.0, dtype="float32", pot_dir=os.path.join(
                ROOT, "pots"), device="cuda"))
        sim.step_block(10)
        r, ev = sim.state.r, sim.pair_eval
        nbr, hm = sim.maps.nbr_map, sim.maps.half_nbr_map
        if doeam:
            rho = st.eam_pass1(r, nbr, ev, want_energy=False)[2]
            dfe = torch.zeros(r.shape[1:], dtype=r.dtype, device=r.device)
            dfe[:sim.geom.n_local] = sim.f_eval(rho)[1]
            binning.fill_halo_scalar_serial(sim.geom, sim.maps, dfe)
            fns = {"eam_pass1": lambda: st.eam_pass1(r, nbr, ev,
                                                     want_energy=False),
                   "eam_pass3": lambda: st.eam_pass3(r, nbr, ev, dfe),
                   "half_eam_pass1": lambda: st.eam_pass1_half(
                       r, hm, ev, want_energy=False),
                   "half_eam_pass3": lambda: st.eam_pass3_half(r, hm, ev,
                                                               dfe)}
        else:
            fns = {"lj": lambda: st.lj_pass(r, nbr, ev, want_energy=False),
                   "half_lj": lambda: st.lj_pass_half(r, hm, ev,
                                                      want_energy=False)}
        for name in list(paths) + list(paths)[::-1]:
            st._lib = libs[name]
            for key, fn in fns.items():
                times[name].setdefault(key, []).append(time_ms(fn, 20))
        del sim, r, nbr, hm, fns
        torch.cuda.empty_cache()
    st._lib = libs["full"]
    print(smi)
    for name, t in times.items():
        print(json.dumps({"variant": name, "ms": t,
                          "mean_ms": {k: sum(v) / len(v)
                                      for k, v in t.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
