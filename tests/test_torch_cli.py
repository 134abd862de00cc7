"""The port's CLI against comd_tpu's, and the options outside the slice.

``python -m comd_tpu_torch.cli`` must print the same "Initial energy",
per-step energies and validation numbers as ``python -m comd_tpu.cli`` for
the same command line (within 1e-9 at f64), with no atoms lost.  Every
option outside the ported slice raises NotImplementedError naming the
ROADMAP.md item that ports it, instead of running something else.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

from comd_tpu_torch import cli as tcli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
ARGS = ["-e", "-x", "4", "-y", "4", "-z", "4", "-N", "10", "-n", "5",
        "--dtype", "float64"]


def _run(module, *extra):
    out = subprocess.run([sys.executable, "-m", module, *ARGS, *extra],
                         capture_output=True, text=True, cwd=REPO, env=ENV,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _numbers(text):
    init = float(re.search(r"Initial energy : *(-?[\d.]+), atom count : "
                           r"(\d+)", text).group(1))
    rows = [[float(x) for x in m.group(1, 2, 3, 4)] for m in re.finditer(
        r"^ +\d+ +[\d.]+ +(-?[\d.]+) +(-?[\d.]+) +(-?[\d.]+) +(-?[\d.]+)",
        text, re.M)]
    val = {k: float(re.search(rf"{k} *: *(-?[\d.]+)", text).group(1))
           for k in ("Initial energy ", "Final energy ", "eFinal/eInitial")}
    atoms = int(re.search(r"Final atom count : (\d+), no atoms lost",
                          text).group(1))
    return init, rows, val, atoms


def test_cli_matches_comd_tpu():
    ref = _numbers(_run("comd_tpu.cli"))
    got = _numbers(_run("comd_tpu_torch.cli", "--device", "cpu"))
    assert got[0] == pytest.approx(ref[0], abs=1e-9)
    assert len(got[1]) == len(ref[1]) == 3          # steps 0, 5, 10
    for row_t, row_j in zip(got[1], ref[1]):
        # total, potential, kinetic energy per atom and temperature
        assert row_t[:3] == pytest.approx(row_j[:3], abs=1e-9)
        assert row_t[3] == pytest.approx(row_j[3], abs=1e-4)
    for k in ref[2]:
        assert got[2][k] == pytest.approx(ref[2][k], abs=1e-9)
    assert got[3] == ref[3] == 256


@pytest.mark.parametrize("method", ["thread_atom", "warp_atom", "cta_cell"])
def test_cell_methods_run_the_stencil(method, capsys):
    """Every cell-sweep method name runs the one stencil path."""
    res = tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(
        ARGS + ["-N", "2", "-n", "2", "-m", method, "--device", "cpu"])))
    assert res["atoms_lost"] == 0
    assert res["e_initial"] == pytest.approx(-3.460523233086, abs=1e-9)


@pytest.mark.parametrize("extra,item", [
    (["-x", "4"], "7"),                     # no -e: Lennard-Jones
    (["-e", "-I"], "7"),
    (["-e", "-P"], "8"),
    (["-e", "--halfShell"], "9"),
    (["-e", "-m", "thread_atom_nl"], "11"),
    (["-e", "-m", "warp_atom_nl"], "11"),
    (["-e", "-m", "cpu_nl"], "11"),
    (["-e", "-L"], "11"),
    (["-e", "-i", "2"], "12"),
    (["-e", "--numProcs", "2"], "12"),
    (["-e", "--commImpl", "ki"], "13"),
    (["-e", "--commImpl", "ki_fused"], "13"),
    (["-e", "--restore", "ckpt"], "6"),
    (["-e", "--checkpoint", "ckpt"], "6"),
    (["-e", "-s"], "6"),
    (["-e", "--analyze"], "6"),
    (["-e", "--yaml", "out"], "6"),
])
def test_out_of_slice_options_raise(extra, item):
    argv = ["-x", "4", "-y", "4", "-z", "4", "-N", "1", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=rf"item {item}\)"):
        tcli.main(argv + extra)
