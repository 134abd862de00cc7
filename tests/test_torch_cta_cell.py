"""-m cta_cell takes comd_tpu's pair functions.

comd_tpu runs -m cta_cell on its Pallas stencil, whose pair functions are
the Chebyshev fit whatever -P or --interpImpl say, in f32 only, and not
under -I or, on a mesh, -a 1 (comd_tpu/sim.py:121,
parallel/sharded.py:133-134).  The port builds the same evaluator there:
  - which evaluator each case gets (f64 cta_cell keeps the resolved one:
    comd_tpu refuses that run, the port runs it);
  - the port's `-e -m cta_cell -P` printThings rows (f32, 6^3) equal its
    `-e -m cta_cell` rows bit for bit;
  - comd_tpu's `-e -m cta_cell -P` (its Pallas kernel in interpret mode,
    step 0 only: the rows it prints at -N 0) within 1e-6 relative, below
    the 9.2e-5 a spline evaluator would put between them and above the
    ~3e-7 f32 gap between the packages.
"""
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from comd_tpu_torch import Config, init_simulation
from comd_tpu_torch import cli as tcli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POTS = os.path.join(REPO, "pots")
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
ARGS = ["-e", "-x", "6", "-y", "6", "-z", "6", "-m", "cta_cell"]


@pytest.mark.parametrize("dtype,method,extra,kind", [
    ("float32", "cta_cell", dict(spline=True), "cheb"),
    ("float32", "cta_cell", dict(interp_impl="rows"), "cheb"),
    ("float32", "thread_atom", dict(spline=True), "spline"),
    ("float64", "cta_cell", dict(spline=True), "spline"),
    ("float64", "cta_cell", dict(), "table"),
    ("float32", "cta_cell", dict(spline=True, gpu_async=0, xproc=2, yproc=2,
                                 zproc=2), "cheb"),
    ("float32", "cta_cell", dict(spline=True, gpu_async=1, xproc=2, yproc=2,
                                 zproc=2), "spline")])
def test_cta_cell_evaluator(dtype, method, extra, kind):
    sim = init_simulation(Config(nx=8, ny=8, nz=8, doeam=True, dtype=dtype,
                                 method=method, pot_dir=POTS, device="cpu",
                                 **extra))
    assert sim.pair_eval.kind == kind


def _rows(text):
    """printThings rows without the timing column: step, time, total,
    potential and kinetic energy per atom, temperature."""
    return [m.group(1) for m in re.finditer(
        r"^( +\d+ +[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+) ",
        text, re.M)]


def _port(*extra):
    buf = io.StringIO()
    tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(
        ARGS + list(extra) + ["--device", "cpu"])), out=buf)
    return buf.getvalue()


def test_cta_cell_spline_rows_equal_cta_cell_rows():
    steps = ["-N", "4", "-n", "2"]
    rows = _rows(_port(*steps, "-P"))
    assert len(rows) == 3                  # steps 0, 2, 4
    assert rows == _rows(_port(*steps))


def test_cta_cell_spline_matches_comd_tpu():
    steps = ["-N", "0", "-n", "1", "-P"]
    out = subprocess.run([sys.executable, "-m", "comd_tpu.cli", *ARGS,
                          *steps], capture_output=True, text=True, cwd=REPO,
                         env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = [[float(x) for x in row.split()] for row in _rows(out.stdout)]
    got = [[float(x) for x in row.split()] for row in _rows(_port(*steps))]
    assert len(got) == len(want) == 1
    assert got[0][:2] == want[0][:2]
    # total, potential and kinetic energy per atom, temperature
    assert got[0][2:] == pytest.approx(want[0][2:], rel=1e-6)
    assert abs(want[0][3] - (-3.537996683684)) < 1e-12
