"""-P and -I through the port's CLI against comd_tpu's, to the printed digits.

Each case runs the same command line through ``comd_tpu.cli`` and
``comd_tpu_torch.cli`` (``--device cpu``: the kernels' plain versions),
f64, and compares the printThings rows as printed (step, time, total,
potential and kinetic energy per atom, temperature; the timing column
dropped):
  - -e -P on K1, on K2 (--halfShell) and on the lists (-m thread_atom_nl);
  - -I, and -I --halfShell, which comd_tpu runs full shell from the table;
  - -I -m thread_atom_nl, which comd_tpu runs with analytic LJ;
  - -e -P on a 2x2x2 mesh under --commImpl ki_fused (the ki fill: comd_tpu
    does not fuse F' under -P) against comd_tpu's collective run (its
    ki_fused needs a TPU).
These replace the NotImplementedError cases of -I and -P in
tests/test_torch_cli.py::test_out_of_slice_options_raise.
"""
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from comd_tpu import cli as jcli
from comd_tpu_torch import cli as tcli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
BASE = ["-x", "6", "-y", "6", "-z", "6", "-N", "4", "-n", "2", "--dtype",
        "float64", "-d", os.path.join(REPO, "pots")]


def _rows(text):
    return [m.group(1) for m in re.finditer(
        r"^( +\d+ +[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+) ",
        text, re.M)]


def _port(argv):
    buf = io.StringIO()
    res = tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(
        argv + ["--device", "cpu"])), out=buf)
    assert res["atoms_lost"] == 0
    return buf.getvalue()


def _comd_tpu(argv):
    buf = io.StringIO()
    jcli.run(jcli.config_from_args(jcli.build_parser().parse_args(argv)),
             out=buf)
    return buf.getvalue()


@pytest.mark.parametrize("extra", [
    ["-e", "-P"], ["-e", "-P", "--halfShell"],
    ["-e", "-P", "-m", "thread_atom_nl"],
    ["-I"], ["-I", "--halfShell"], ["-I", "-m", "thread_atom_nl"]],
    ids=["P", "P-half", "P-nl", "I", "I-half", "I-nl"])
def test_cli_rows_match_comd_tpu(extra):
    want = _rows(_comd_tpu(BASE + extra))
    got = _rows(_port(BASE + extra))
    assert len(want) == 3                       # steps 0, 2, 4
    assert got == want


def test_cli_spline_mesh_ki_fused_matches_comd_tpu():
    argv = ["-e", "-P", "-x", "8", "-y", "8", "-z", "8", "-i", "2", "-j",
            "2", "-k", "2", "-N", "4", "-n", "2", "--dtype", "float64"]
    ref = subprocess.run([sys.executable, "-m", "comd_tpu.cli", *argv,
                          "--commImpl", "collective"], capture_output=True,
                         text=True, cwd=REPO, env=ENV, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    out = _port(argv + ["--commImpl", "ki_fused"])
    assert "shards on cpu, --commImpl ki_fused" in out
    assert len(_rows(ref.stdout)) == 3
    assert _rows(out) == _rows(ref.stdout)
