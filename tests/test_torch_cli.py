"""The port's CLI against comd_tpu's.

``python -m comd_tpu_torch.cli`` must print the same "Initial energy",
per-step energies and validation numbers as ``python -m comd_tpu.cli`` for
the same command line (within 1e-9 at f64), with no atoms lost: EAM, LJ,
and both with ``--halfShell``; a 2x2x2 mesh under ``--commImpl ki_fused``
prints comd_tpu's rows to the printed digits.  ``--halfFetch``/
``--halfMaterialize`` are accepted and change nothing; ``--commImpl`` on a
serial run warns, and an undersized ``--haloMsgFactor`` aborts.  The
neighbor-list methods (-m thread_atom_nl, warp_atom_nl, cpu_nl, and -L)
run, serial and on a 2x2x2 mesh, from comd_tpu's initial energy, and
``-e -m thread_atom_nl`` prints comd_tpu's printThings rows, as does ``-a
1`` (the interior/boundary split) on a 2x2x2 mesh.  (The multi-process
launch, ki transports included: tests/test_torch_multiproc*.py; -P, -I and
the run tools: tests/test_torch_cli_options.py,
tests/test_torch_runtools.py.)
"""
import io
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


def _run(module, *extra, args=ARGS):
    out = subprocess.run([sys.executable, "-m", module, *args, *extra],
                         capture_output=True, text=True, cwd=REPO, env=ENV,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _rows(text):
    """The printThings rows as printed: step, time, total, potential and
    kinetic energy per atom, temperature (the timing column dropped)."""
    return [m.group(1) for m in re.finditer(
        r"^( +\d+ +[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+) ",
        text, re.M)]


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


@pytest.mark.parametrize("extra", [[], ["--halfShell"], ["-e", "--halfShell"]])
def test_cli_lj_and_half_shell_match_comd_tpu(extra):
    """LJ (no -e) full and half, and EAM --halfShell: the same printThings
    table as comd_tpu's CLI on the same flags, energies within 1e-9."""
    args = [a for a in ARGS if a != "-e"] + extra
    ref = _numbers(_run("comd_tpu.cli", args=args))
    out = _run("comd_tpu_torch.cli", "--device", "cpu", args=args)
    assert ("Lennard-Jones" in out) == ("-e" not in extra)
    got = _numbers(out)
    assert got[0] == pytest.approx(ref[0], abs=1e-9)
    assert len(got[1]) == len(ref[1]) == 3
    for row_t, row_j in zip(got[1], ref[1]):
        assert row_t[:3] == pytest.approx(row_j[:3], abs=1e-9)
        assert row_t[3] == pytest.approx(row_j[3], abs=1e-4)
    for k in ref[2]:
        assert got[2][k] == pytest.approx(ref[2][k], abs=1e-9)
    assert got[3] == ref[3] == 256


def test_half_fetch_changes_nothing():
    """--halfFetch window and --halfMaterialize are accepted for parity and
    ignored: the printed numbers are those of the plain --halfShell run."""
    outs = []
    for extra in ([], ["--halfFetch", "window", "--halfMaterialize"]):
        buf = io.StringIO()
        tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(
            ARGS + ["-N", "4", "-n", "2", "--halfShell", "--device", "cpu"]
            + extra)), out=buf)
        outs.append(_numbers(buf.getvalue()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("method", ["thread_atom", "warp_atom", "cta_cell"])
def test_cell_methods_run_the_stencil(method, capsys):
    """Every cell-sweep method name runs the one stencil path."""
    res = tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(
        ARGS + ["-N", "2", "-n", "2", "-m", method, "--device", "cpu"])))
    assert res["atoms_lost"] == 0
    assert res["e_initial"] == pytest.approx(-3.460523233086, abs=1e-9)


@pytest.mark.parametrize("extra,box,e_initial", [
    (["-e", "-m", "thread_atom_nl"], 4, -3.460523233086),
    (["-e", "-m", "warp_atom_nl"], 4, -3.460523233086),
    (["-e", "-m", "cpu_nl"], 4, -3.460523233086),
    (["-e", "-L"], 4, -3.460523233086),
    # 4^3 on 2x2x2 leaves one NL cell a shard, which both packages refuse
    (["-e", "-i", "2", "-j", "2", "-k", "2", "-m", "thread_atom_nl"], 8,
     -3.460523233086),
    (["-i", "2", "-j", "2", "-k", "2", "-L"], 8, -1.166063303478),
])
def test_nl_methods_run(extra, box, e_initial):
    """Every neighbor-list method name and -L runs (f64, on the CPU), from
    the initial energy comd_tpu's CLI prints for the same flags, with no
    atom lost.  cpu_nl runs the same path as the others."""
    n = str(box)
    res = tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(
        ["-x", n, "-y", n, "-z", n, "-N", "2", "-n", "2", "--dtype",
         "float64", "--device", "cpu"] + extra)), out=io.StringIO())
    assert res["atoms_lost"] == 0
    assert res["e_initial"] == pytest.approx(e_initial, abs=1e-9)


def test_cli_nl_matches_comd_tpu():
    """-e -m thread_atom_nl prints comd_tpu's printThings rows (energies
    within 1e-9) and validation numbers."""
    args = ARGS + ["-m", "thread_atom_nl"]
    ref = _numbers(_run("comd_tpu.cli", args=args))
    got = _numbers(_run("comd_tpu_torch.cli", "--device", "cpu", args=args))
    assert got[0] == pytest.approx(ref[0], abs=1e-9)
    assert len(got[1]) == len(ref[1]) == 3
    for row_t, row_j in zip(got[1], ref[1]):
        assert row_t[:3] == pytest.approx(row_j[:3], abs=1e-9)
        assert row_t[3] == pytest.approx(row_j[3], abs=1e-4)
    for k in ref[2]:
        assert got[2][k] == pytest.approx(ref[2][k], abs=1e-9)
    assert got[3] == ref[3] == 256


def test_cli_undersized_nl_k_aborts():
    """A neighbor-list K too small raises the overflow flag at the build
    and the run aborts before its first step."""
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(
        ARGS + ["-N", "1", "-m", "thread_atom_nl", "--device", "cpu"]))
    cfg.nl_max_neighbors = 8
    with pytest.raises(RuntimeError, match="step 0: .*neighbor list row"):
        tcli.run(cfg, out=io.StringIO())


MESH_ARGS = ["-e", "-x", "8", "-y", "8", "-z", "8", "-i", "2", "-j", "2",
             "-k", "2", "-N", "4", "-n", "2", "--dtype", "float64"]


def test_cli_mesh_ki_fused_matches_comd_tpu():
    """A 2x2x2 mesh at 8^3 under --commImpl ki_fused prints comd_tpu's
    printThings rows to the printed digits.  comd_tpu's own ki_fused runs
    only on a TPU (its interpret mode moves remote copies on 1-D meshes
    only), so its collective run of the same flags is the reference; the
    two transports are bitwise equal in both packages."""
    ref = _run("comd_tpu.cli", "--commImpl", "collective", args=MESH_ARGS)
    out = _run("comd_tpu_torch.cli", "--commImpl", "ki_fused", "--device",
               "cpu", args=MESH_ARGS)
    assert "Processors       : 2 x 2 x 2 shards on cpu, --commImpl " \
        "ki_fused" in out
    assert len(_rows(out)) == len(_rows(ref)) == 3     # steps 0, 2, 4
    assert _rows(out) == _rows(ref)
    got, want = _numbers(out), _numbers(ref)
    assert got[0] == want[0] and got[3] == want[3] == 2048


def test_cli_mesh_split_matches_comd_tpu():
    """-a 1 of a cell method on a 2x2x2 mesh at 8^3 (2^3 cells a shard,
    none of them interior: every cell sweeps as boundary) prints comd_tpu's
    printThings rows to the printed digits, and the warning that the split
    replaces the other sweeps."""
    args = MESH_ARGS + ["-a", "1"]
    ref = _run("comd_tpu.cli", args=args)
    out = _run("comd_tpu_torch.cli", "--device", "cpu", args=args)
    assert len(_rows(out)) == len(_rows(ref)) == 3     # steps 0, 2, 4
    assert _rows(out) == _rows(ref)
    got, want = _numbers(out), _numbers(ref)
    assert got[0] == want[0] and got[3] == want[3] == 2048
    with_half = _run("comd_tpu_torch.cli", "--device", "cpu", "--halfShell",
                     args=args)
    assert "-a 1 replaces the cta_cell/half-shell sweep" in with_half
    assert _rows(with_half) == _rows(ref)


def test_cli_serial_comm_impl_warns():
    buf = io.StringIO()
    res = tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(
        ARGS + ["-N", "1", "-n", "1", "--commImpl", "ki", "--device",
                "cpu"])), out=buf)
    assert "# WARNING: --commImpl ki selects a halo TRANSPORT" in \
        buf.getvalue()
    assert res["atoms_lost"] == 0


def test_cli_packed_message_overflow_aborts():
    """An undersized --haloMsgFactor raises the overflow flag, and the run
    aborts naming the knob."""
    argv = MESH_ARGS + ["-N", "1", "-n", "1", "--haloMsgFactor", "1e-6",
                        "--device", "cpu"]
    with pytest.raises(RuntimeError, match="haloMsgFactor"):
        tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(argv)),
                 out=io.StringIO())
