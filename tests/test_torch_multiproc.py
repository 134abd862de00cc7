"""The multi-process launch (--numProcs/--coordinator/--procId) on the CPU.

Each process of a launch owns a contiguous block of the mesh's shards,
generates and steps only those, and moves the messages for shards of
other processes over torch.distributed (gloo here).  The checks:

  - shard ownership for 1, 2, 4 and 8 processes on a 2x2x2 mesh, and the
    ValueError for a mesh that does not split evenly;
  - every stage's routes agree between the processes: what process a sends
    process b, in order, is what b expects from a;
  - the backend rule, with the device count passed in;
  - 4 processes on 2x2x1 (one shard each: x and y neighbors in other
    processes, z the shard itself) print, on process 0, the single-process
    mesh's printThings rows digit for digit (timing column dropped), and
    the other processes print nothing of the run.

The launch helpers here (``launch``, ``rows``, ``check_launch``) serve
tests/test_torch_multiproc_*.py too: every process is a subprocess with
its own timeout (killed on expiry), OMP_NUM_THREADS=1 and --device cpu,
and the single-process reference runs beside the workers.
"""
import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from comd_tpu_torch import cli as tcli
from comd_tpu_torch.cells import make_geometry
from comd_tpu_torch.ops.binning import geom_maps
from comd_tpu_torch.parallel import dist, exchange
from comd_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
           PYTHONPATH=ROOT)
# f64 EAM at 6^3 with 0.8 A displacements: atoms change shard in the run
EAM6 = ["-e", "-x", "6", "-y", "6", "-z", "6", "-r", "0.8", "-N", "10",
        "-n", "5", "--dtype", "float64"]
MESH222 = ["-i", "2", "-j", "2", "-k", "2"]
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, args: list, single=(), multi=(), timeout: int = TIMEOUT,
           device: str = "cpu"):
    """Run ``python -m comd_tpu_torch.cli args --device device`` once as a
    single process (with ``single`` added) and once as ``n`` processes
    (with ``multi`` added), all at the same time.  Returns (the single
    run's stdout, [(rc, stdout, stderr)] of the processes in --procId
    order).  A process that does not end within ``timeout`` seconds is
    killed, with all the others, and fails the test."""
    base = [sys.executable, "-m", "comd_tpu_torch.cli", *args,
            "--device", device]
    port = _free_port()
    cmds = [base + list(single)] + [
        base + list(multi) + ["--numProcs", str(n), "--coordinator",
                              f"127.0.0.1:{port}", "--procId", str(p)]
        for p in range(n)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT,
                              env=ENV) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rc, single, err = outs[0]
    assert rc == 0, err[-3000:]
    return single, outs[1:]


def rows(text: str) -> list:
    """The printThings rows as printed: step, time, total, potential and
    kinetic energy per atom, temperature (the timing column dropped)."""
    return [m.group(1) for m in re.finditer(
        r"^( +\d+ +[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+) ",
        text, re.M)]


def check_launch(n: int, args: list, n_rows: int, single=(), multi=(),
                 skip: int = 0):
    """Launch ``args`` on ``n`` processes and hold process 0's rows against
    the single process's (from its row ``skip`` on), digit for digit; the
    other processes print nothing but gloo's own lines.  Returns process
    0's stdout."""
    single_out, outs = launch(n, args, single, multi)
    for rc, _out, err in outs:
        assert rc == 0, err[-3000:]
    out0 = outs[0][1]
    assert len(rows(single_out)) == n_rows
    assert rows(out0) == rows(single_out)[skip:]
    assert f"Timing Statistics Across {n} Ranks" in out0
    assert f", {n} processes (gloo)" in out0
    assert "Across 1 Ranks" in single_out
    for _rc, out, _err in outs[1:]:
        assert all(line.startswith("[Gloo]") for line in out.splitlines()), \
            out[:2000]
    return out0


# --------------------------------------------------------------------------
# in-process: ownership, routes, the backend rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_ownership(n):
    """Process p owns shards [p*8/n, (p+1)*8/n) in np.ndindex order."""
    per = 8 // n
    seen = []
    for p in range(n):
        m = make_mesh(2, 2, 2, "cpu", nprocs=n, proc=p)
        assert list(m.owned) == list(range(p * per, (p + 1) * per))
        assert [m.slot(s) for s in m.owned] == list(range(per))
        seen += list(m.owned)
        assert all(m.owner(s) == s // per for s in range(8))
    assert seen == list(range(8))


@pytest.mark.parametrize("grid,n", [((2, 2, 2), 3), ((3, 2, 1), 4),
                                    ((1, 1, 1), 2)])
def test_uneven_split_raises(grid, n):
    size = grid[0] * grid[1] * grid[2]
    with pytest.raises(ValueError, match=rf"the {size} shards .* over {n} "
                                         r"processes"):
        make_mesh(*grid, "cpu", nprocs=n)


@pytest.mark.parametrize("grid,n", [((2, 2, 2), 2), ((2, 2, 2), 4),
                                    ((2, 2, 1), 4), ((3, 2, 1), 3),
                                    ((2, 2, 2), 8)])
def test_routes_agree_between_processes(grid, n):
    """For every stage and every pair of processes (a, b), the messages a
    sends b, as (receiver, direction) in order, are those b receives from
    a; every (receiver, direction) is delivered exactly once, locally or
    from its sender's process."""
    geom = make_geometry([0.0] * 3, [12.0] * 3, 5.0)
    maps = geom_maps(geom, torch.float64, "cpu")
    plan = exchange.make_plan(geom)
    halos = [exchange.make_halo(make_mesh(*grid, "cpu", nprocs=n, proc=p),
                                geom, maps, plan, torch.float64)
             for p in range(n)]
    for axis in range(3):
        routes = [exchange._route(h, axis) for h in halos]
        for a in range(n):
            own = halos[a].mesh.owned
            delivered = [(own[i], k) for i, k, _j in routes[a][0]]
            for b in range(n):
                sent = routes[a][1].get(b, [])
                got = routes[b][2].get(a, [])
                assert len(sent) == len(got)
                src_of = (halos[a].plus[axis], halos[a].minus[axis])
                for (j, k), (i, k2) in zip(sent, got):
                    assert k == k2
                    dst = halos[b].mesh.owned[i]
                    assert src_of[k][dst] == halos[a].mesh.owned[j]
                delivered += [(own[i], k) for i, k in routes[a][2].get(b, [])]
            assert sorted(delivered) == [(s, k) for s in own for k in (0, 1)]


@pytest.mark.parametrize("device,n,count,want", [
    ("cpu", 2, 0, ("gloo", False)),
    ("cpu", 4, 8, ("gloo", False)),
    ("cuda", 2, 2, ("nccl", False)),
    ("cuda", 2, 8, ("nccl", False)),
    ("cuda", 2, 1, ("gloo", True)),
    ("cuda", 4, 2, ("gloo", True)),
])
def test_backend_rule(device, n, count, want):
    assert dist.backend_for(device, n, count) == want


def test_single_process_describes_itself():
    assert dist.process_index() == 0 and dist.process_count() == 1
    assert dist.allgather(torch.arange(3)).tolist() == [[0, 1, 2]]


def test_missing_coordinator_fails():
    argv = ["-e", "-x", "4", "-y", "4", "-z", "4", "-i", "2", "-N", "1",
            "--device", "cpu", "--numProcs", "2", "--procId", "0"]
    assert tcli.main(argv) == 1


# --------------------------------------------------------------------------
# a launch: 4 processes, one shard each
# --------------------------------------------------------------------------

def test_four_processes_2x2x1():
    """x and y neighbors in other processes, z the shard itself."""
    out = check_launch(4, EAM6 + ["-i", "2", "-j", "2", "-k", "1"], 3)
    assert "Processors       : 2 x 2 x 1 shards on cpu" in out
    assert "no atoms lost" in out
