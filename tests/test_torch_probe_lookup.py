"""The table-lookup probes P4-P6 of the port (comd_tpu_torch.probes.lookup)
against the archive's Pallas kernels (tools/archive/gather_probe.py
pallas_take, gather_probe2.py pgather) in interpret mode.

Each archive module is loaded by path and run through its own main() with
its ``pl`` replaced by a namespace whose pallas_call is interpret-mode,
``marginal`` by a recorder and ``N`` made small; nothing in tools/ changes.
At the probes' scale 1e-12 the f32 output is (almost everywhere) x itself,
so the lookup term is checked at scale 1 against numpy take /
take_along_axis, also on tables whose columns differ.  Every check is bit
for bit: the port rounds op by op as numpy does.
"""
import functools
import inspect
import types

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from comd_tpu_torch.ops.cuda import probe as cuda_probe
from comd_tpu_torch.probes import lookup
from probe_archive import bit_equal, load

torch.set_num_threads(1)

N4 = 4 * 8192          # P4: whole blocks of 8192
N5 = 2 * 512 * 128     # P5: whole blocks of [512, 128]


def _run_archive(monkeypatch, name, n):
    """{variant: (fn, x)} as the archive's main() hands them to marginal."""
    mod = load(name)
    fake_pl = types.SimpleNamespace(**vars(pl))
    fake_pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(mod, "pl", fake_pl)
    got = {}
    monkeypatch.setattr(mod, "marginal",
                        lambda label, fn, x: got.setdefault(label, (fn, x)))
    monkeypatch.setattr(mod, "N", n)
    mod.main()
    return got


def _split(x, n_rows):
    fl = np.floor(x)
    return np.clip(fl, 0, n_rows - 1).astype(np.int64), x - fl


def _row_oracle(x, tab, scale):
    ii, u = _split(x, tab.shape[0])
    r = tab[ii]
    s = r[..., 2] + r[..., 3]
    s = r[..., 1] + u * s
    s = r[..., 0] + u * s
    return x + np.float32(scale) * s


def _lane_oracle(x, tab, scale):
    ii, u = _split(x, tab.shape[0])
    return x + np.float32(scale) * (np.take_along_axis(tab, ii, axis=0) * u)


def _distinct(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture
def p4(monkeypatch):
    fn, x = _run_archive(monkeypatch, "gather_probe", N4)["pallas"]
    return fn, x, inspect.getclosurevars(fn).nonlocals["tab_rows"]


@pytest.fixture
def p5(monkeypatch):
    fn, x = _run_archive(monkeypatch, "gather_probe2", N5)["pgather"]
    return fn, x, inspect.getclosurevars(fn).nonlocals["tab"]


def test_p4_inputs_and_output_match_archive(p4):
    fn, x, tab = p4
    xs, ts = lookup.make_inputs(4, N4)
    assert bit_equal(xs, x) and bit_equal(ts, tab) and ts.shape == (512, 4)
    want = np.asarray(fn(x))
    got = lookup.row_lookup(torch.from_numpy(xs), torch.from_numpy(ts))
    assert bit_equal(got.numpy(), want)


def test_p5_inputs_and_output_match_archive(p5):
    fn, x, tab = p5
    xs, ts = lookup.make_inputs(5, N5)
    assert bit_equal(xs, x) and bit_equal(ts, tab)
    assert xs.shape == (N5 // 128, 128) and ts.shape == (512, 128)
    want = np.asarray(fn(x))
    got = lookup.lane_lookup(torch.from_numpy(xs), torch.from_numpy(ts))
    assert bit_equal(got.numpy(), want)


def test_p6_equals_p5(p5):
    """P6 means P5's function; the port runs P5's kernel for it."""
    fn, x, tab = p5
    xs, ts = lookup.make_inputs(6, N5)
    got = lookup.onehot_lookup(torch.from_numpy(xs), torch.from_numpy(ts))
    assert bit_equal(got.numpy(), np.asarray(fn(x)))


@pytest.mark.parametrize("scale", [lookup.SCALE, 1.0])
@pytest.mark.parametrize("table", ["probe", "distinct"])
def test_row_lookup_term_against_numpy(scale, table):
    x, tab = lookup.make_inputs(4, N4)
    if table == "distinct":
        tab = _distinct(tab.shape)
    got = lookup.row_lookup(torch.from_numpy(x), torch.from_numpy(tab), scale)
    assert bit_equal(got.numpy(), _row_oracle(x, tab, scale))


@pytest.mark.parametrize("scale", [lookup.SCALE, 1.0])
@pytest.mark.parametrize("table", ["probe", "distinct"])
def test_lane_lookup_term_against_numpy(scale, table):
    x, tab = lookup.make_inputs(5, N5)
    if table == "distinct":
        tab = _distinct(tab.shape)
    got = lookup.lane_lookup(torch.from_numpy(x), torch.from_numpy(tab),
                             scale)
    want = _lane_oracle(x, tab, scale)
    assert bit_equal(got.numpy(), want)
    if table == "distinct" and scale == 1.0:   # column 0 would not do
        assert not bit_equal(want, _lane_oracle(x, np.repeat(
            tab[:, :1], tab.shape[1], axis=1), scale))


def test_onehot_select_sum_is_the_lane_lookup():
    """The one-hot select-sum P6 means (sum over table rows k of
    (floor(x) == k) * tab[k, l]) equals the lane lookup at scale 1."""
    x, _ = lookup.make_inputs(6, 64 * 128)
    tab = _distinct((512, 128))
    ii, u = _split(x, 512)
    hot = ii[:, :, None] == np.arange(512)[None, None, :]
    acc = np.where(hot, tab.T[None, :, :], np.float32(0)).sum(
        axis=2, dtype=np.float32)
    want = x + np.float32(1) * (acc * u)
    got = lookup.onehot_lookup(torch.from_numpy(x), torch.from_numpy(tab), 1.0)
    assert bit_equal(got.numpy(), want)


def test_floor_is_clamped_to_the_table():
    x = np.array([-3.5, 0.0, 0.25, 510.75, 511.5, 600.25], np.float32)
    tab = _distinct((512, 4))
    got = lookup.row_lookup(torch.from_numpy(x), torch.from_numpy(tab), 1.0)
    assert bit_equal(got.numpy(), _row_oracle(x, tab, 1.0))
    lanes = _distinct((512, 6), seed=8)
    got = lookup.lane_lookup(torch.from_numpy(x[None, :]),
                             torch.from_numpy(lanes), 1.0)
    assert bit_equal(got.numpy(), _lane_oracle(x[None, :], lanes, 1.0))


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback inside the CUDA wrappers: CPU tensors are refused."""
    x, tab = (torch.from_numpy(a) for a in lookup.make_inputs(5, 1024))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.lane_lookup(x, tab, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.row_lookup(x.reshape(-1), tab[:, :4].contiguous(), 1.0)


@pytest.mark.parametrize("probe,label", [(4, "pallas"), (5, "pgather"),
                                         (6, "ponehot")])
def test_command_on_cpu(capsys, probe, label):
    assert lookup.main([str(probe), "--n", "8192", "--reps", "1",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(label) and "M lookups" in out
    if probe != 4:
        with pytest.raises(SystemExit):
            lookup.main([str(probe), "--n", "100", "--device", "cpu"])
