"""Two processes on a 2x2x2 mesh, the split families, against the
single-process mesh: ``-e -m thread_atom_nl`` (Verlet lists, with -a
auto's interior/boundary row split; at 8^3, since a 6^3 box leaves a
shard fewer than the two classic cells an axis the lists need) and ``-e -a
1`` (K1 over the interior and boundary cells apart; the migration count is
an allgather).  f64 with 0.8 A displacements; process 0 prints the
single-process rows digit for digit (tests/test_torch_multiproc.py's
helpers).
"""
import pytest
import torch

from test_torch_multiproc import EAM6, MESH222, check_launch

torch.set_num_threads(1)

EAM8 = [a if a != "6" else "8" for a in EAM6]


@pytest.mark.parametrize("args", [EAM8 + ["-m", "thread_atom_nl"],
                                  EAM6 + ["-a", "1"]], ids=["nl", "split"])
def test_two_processes_split_families(args):
    out = check_launch(2, args + MESH222, 3)
    assert "no atoms lost" in out
