"""The launch plan of the list paths' row kernel ER (``embed_rows``), on
the CPU, and the property of NR's rows that ER's form relies on.

The kernels themselves run only on the card (tests/test_torch_kernel_cuda.py
-m cuda holds NR and ER to their plain versions bit for bit; NR's plan,
its tiles and a cell's warp segment, is csrc/nl.cu's own); here:
  - ER's plan: the vector width (16 bytes of slots where A allows, else
    one slot) and the slot and row blocks;
  - the slots of ``nl_rows_plain``'s lists own their valid rows exactly
    once, so that ER's owner-written U and zeroed invalid rows cover U
    once.
"""
import re
import types

import numpy as np
import pytest
import torch

from comd_tpu_torch.ops import neighborlist as nlmod
from comd_tpu_torch.ops.cuda import step as step_ops
from comd_tpu_torch.ops.cuda.nvcc import CSRC

torch.set_num_threads(1)


def _pad(n: int) -> int:
    return max(128, -(-n // 128) * 128)


def _state(n_local: int, A: int, seed: int, split: bool, factor: float):
    """Synthetic counts of ``n_local`` cells (a few halo cells after them)
    drawn from [-2, A + 5] with a numpy seed, one cell emptied; with
    ``split`` a random boundary mask and row_split_for's capacities.
    Returns (geom, n_atoms [B] int32, row_split | None, n_rows)."""
    rng = np.random.default_rng(seed)
    B = n_local + 7
    n = rng.integers(-2, A + 6, size=B).astype(np.int32)
    n[n_local // 3] = 0
    geom = types.SimpleNamespace(n_local=n_local)
    if not split:
        n_rows = _pad(int(n_local * A * factor))
        return geom, torch.from_numpy(n), None, n_rows
    is_b = rng.random(n_local) < 0.4
    ri = _pad(int((~is_b).sum()) * A)
    rb = _pad(int(is_b.sum()) * A)
    return geom, torch.from_numpy(n), (is_b, ri, rb), ri + rb


def test_er_rows_a_thread_matches_the_source():
    """ROWS_A_THREAD is csrc/step.cu's kRowsAThread."""
    with open(f"{CSRC}/step.cu") as fh:
        src = fh.read()
    assert int(re.search(r"constexpr int kRowsAThread = (\d+);",
                         src).group(1)) == step_ops.ROWS_A_THREAD


@pytest.mark.parametrize("A,elem,width", [(32, 4, 4), (32, 8, 2), (16, 4, 4),
                                          (30, 4, 1), (30, 8, 2), (13, 4, 1),
                                          (13, 8, 1), (40, 4, 4), (1, 8, 1)])
def test_er_vector_width(A, elem, width):
    """ER's width: 16 bytes of slots when A is a multiple of them, else one
    slot (the scalar form); the energy dtype does not enter."""
    assert step_ops.rows_width(A, elem) == width
    for energy in (False, True):
        assert step_ops.embed_rows_plan(A, elem, 10 * A, 100,
                                        energy)[0] == width


@pytest.mark.parametrize("energy", [False, True])
def test_er_blocks(energy):
    """ER's grid: a block to every 256 vectors of dfEmbed and, on energy
    steps only, to every 256 groups of ROWS_A_THREAD rows, one block at
    least."""
    B, A, R = 43 ** 3, 32, 2205568
    w, slots, rows = step_ops.embed_rows_plan(A, 4, B * A, R, energy)
    tiny = step_ops.embed_rows_plan(A, 4, 0, 0, energy)
    vec_blocks = -(-B * A // w // 256)
    row_blocks = -(-(-(-R // step_ops.ROWS_A_THREAD)) // 256)
    assert (slots, rows) == (vec_blocks, row_blocks if energy else 0)
    assert tiny[1] == 1 and tiny[2] == (1 if energy else 0)


@pytest.mark.parametrize("n_local,A,split,factor", [
    (1300, 32, False, 1.0), (1300, 32, True, 1.0), (1300, 32, False, 0.25),
    (700, 13, True, 1.0), (100, 40, False, 1.0)])
def test_er_slots_own_the_valid_rows(n_local, A, split, factor):
    """On NR's lists the local slots that have a row (s < min(n, A), row
    below R) reach every valid row exactly once and no invalid row: ER's
    U, written by the owning slot and zeroed on the invalid rows, is
    written once a row."""
    geom, n_atoms, row_split, n_rows = _state(n_local, A, 11 + n_local,
                                              split, factor)
    _a, a_valid, row_start = nlmod.nl_rows_plain(geom, n_atoms, A, n_rows,
                                                 row_split)
    row, has = nlmod.slot_rows(row_start, n_atoms, n_local, A, n_rows)
    owned = np.bincount(row[has].numpy(), minlength=n_rows)
    np.testing.assert_array_equal(owned, a_valid.numpy().astype(np.int64))
