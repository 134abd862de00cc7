"""Checkpoints of a multi-process launch.

  - A 2-process ``--checkpoint`` on a 2x2x2 mesh (f64 EAM at 6^3 with 0.8
    A displacements, 6 steps) writes the npz a single process of the same
    mesh writes, array for array and bit for bit, with the same meta.json.
  - Its r, gid and n_atoms agree with comd_tpu's single-process 2x2x2 mesh
    (8 virtual CPU devices, in this process) after the same steps: the
    cell layout bit for bit, the positions within 1e-8 (the tolerance of
    tests/test_torch_sharded.py).
  - A 2-process ``--restore`` of the single process's checkpoint continues
    bit for bit: its rows are those of the single process's uninterrupted
    run.

The launch helpers are tests/test_torch_multiproc.py's.
"""
import json
import os

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, init_simulation as j_init

from test_torch_multiproc import EAM6, MESH222, check_launch, launch

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
STEPS = [a for a in EAM6 if a not in ("-N", "10", "-n", "5")]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    single, outs = launch(2, STEPS + MESH222 + ["-N", "6", "-n", "3"],
                          single=["--checkpoint", str(d / "single")],
                          multi=["--checkpoint", str(d / "multi")])
    for rc, _out, err in outs:
        assert rc == 0, err[-3000:]
    assert "final checkpoint written" in single
    assert "final checkpoint written" in outs[0][1]
    return d


def _load(path):
    with np.load(os.path.join(path, "state.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as fh:
        return arrays, json.load(fh)


def test_two_process_checkpoint_equals_single(ckpts):
    multi, meta_m = _load(ckpts / "multi")
    single, meta_s = _load(ckpts / "single")
    assert list(multi) == list(single)
    assert "last_r" in multi and multi["r"].shape[:3] == (2, 2, 2)
    for k in single:
        assert multi[k].dtype == single[k].dtype, k
        assert multi[k].tobytes() == single[k].tobytes(), k
    assert meta_m == meta_s and meta_m["step"] == 6


def test_two_process_checkpoint_matches_comd_tpu_mesh(ckpts):
    multi, _meta = _load(ckpts / "multi")
    jsim = j_init(JConfig(nx=6, ny=6, nz=6, doeam=True, temperature=600.0,
                          initial_delta=0.8, dtype="float64", pot_dir=POTS,
                          xproc=2, yproc=2, zproc=2))
    jsim.step_block(3)
    jsim.step_block(3)
    for k in ("gid", "n_atoms"):
        np.testing.assert_array_equal(multi[k], np.asarray(
            getattr(jsim.state, k)))
    valid = multi["gid"] != 2**31 - 1
    r_j = np.asarray(jsim.state.r)
    dr = np.moveaxis(multi["r"], 3, -1)[valid] - np.moveaxis(r_j, 3, -1)[
        valid]
    assert valid.sum() > 864 and np.abs(dr).max() < 1e-8


def test_two_process_restore_continues(ckpts):
    """Steps 6-10 from the single process's step-6 checkpoint, on 2
    processes, print the rows of the single process's run from step 0."""
    out = check_launch(2, STEPS + MESH222 + ["-n", "2"], 6,
                       single=["-N", "10"],
                       multi=["-N", "4", "--restore",
                              str(ckpts / "single")], skip=3)
    assert "Restored checkpoint" in out and "WARNING" not in out
