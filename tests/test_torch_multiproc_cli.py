"""Two processes on a 2x2x2 mesh against the single-process mesh.

Each process owns four shards, so every x neighbor is in the other process
(both directions in its one buffer) and the y and z neighbors are in the
same one.  f64 EAM at 6^3 with 0.8 A displacements (atoms change shard
within the run): process 0 prints the single-process mesh's printThings
rows digit for digit (timing column dropped), the other process prints
nothing of the run, and the timing report is "Across 2 Ranks".  The lazy
full-shell main family, ``--halfShell`` (the fold crosses processes) and
``-S 0`` (a rebucket and atom exchange every step); ``--analyze`` and
``--yaml`` against the single run's.  The launch helpers are
tests/test_torch_multiproc.py's.
"""
import re

import pytest
import torch

from test_torch_multiproc import EAM6, MESH222, check_launch, launch

torch.set_num_threads(1)


@pytest.mark.parametrize("extra", [[], ["--halfShell"], ["-S", "0"]],
                         ids=["lazy", "half", "eager"])
def test_two_processes_print_single_rows(extra):
    out = check_launch(2, EAM6 + MESH222 + extra, 3)
    assert "no atoms lost" in out


def test_two_processes_yaml_and_analyze(tmp_path):
    """--analyze prints the single process's histogram (each process bins
    its shards, the counts are summed); --yaml is written once, by process
    0, with the single run's values and a "Processes" line."""
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()
    args = EAM6 + MESH222 + ["--analyze", "-N", "4", "-n", "2"]
    single, outs = launch(2, args, single=["--yaml", str(tmp_path / "one")],
                          multi=["--yaml", str(tmp_path / "two")])
    for rc, _out, err in outs:
        assert rc == 0, err[-3000:]

    def hist(text):
        return re.findall(r"^ *\d+ +\d+$|^# mean .*$", text, re.M)

    assert hist(outs[0][1]) == hist(single) and len(hist(single)) > 2
    one, = (tmp_path / "one").iterdir()
    two, = (tmp_path / "two").iterdir()

    def kv(path):
        keep = ("Max Link Cell Occupancy", "Initial energy", "Final energy",
                "Atoms lost", "Processors", "Local boxes", "Total atoms")
        return {k.strip(): v.strip() for k, _s, v in
                (ln.partition(":") for ln in path.read_text().splitlines())
                if k.strip() in keep}

    assert kv(two) == kv(one) and len(kv(one)) == 7
    assert "Processes: 2 processes (gloo)" in two.read_text()
    assert "Processes:" not in one.read_text()
