#!/usr/bin/env python3
"""Where the time of the cell-stencil kernels K1 and K2 goes, on one GPU.

    python3 stencil_breakdown.py

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
Prints the card's name and power limit, then one JSON line per build.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
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
                  cp, tp, lj, r2, di, PAIR == kEam3 ? v.w : T(0), sc);""",
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


def variant_sources(source: str, out_dir: str) -> dict:
    """Write one copy of ``source`` per entry of EDITS into out_dir."""
    text = open(source).read()
    paths = {}
    os.makedirs(out_dir, exist_ok=True)
    for name, edits in EDITS.items():
        body = text
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"variant {name}: the edit of "
                                   f"{old[:40]!r} does not apply once")
            body = body.replace(old, new)
        paths[name] = os.path.join(out_dir, f"stencil_{name}.cu")
        with open(paths[name], "w") as fh:
            fh.write(body)
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("stencil_breakdown: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
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
        list(pool.map(lambda p: build_library(p, "breakdown"),
                      paths.values()))
    source, libs = st.SOURCE, {}
    for name, path in paths.items():      # bind each (built above)
        st._lib, st.SOURCE = None, path
        libs[name] = st.build()
    st.SOURCE = source

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
