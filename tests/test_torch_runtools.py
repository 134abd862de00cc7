"""The run tools in the port against comd_tpu: checkpoints, --yaml,
--analyze and -s.

Checkpoints (utils/checkpoint.py, comd_tpu's npz format):
  - the port's own round trip continues the lazy cell path bit for bit
    (f32, serial) and on a 2x2x2 mesh (f64): r, p, f and ePot after
    save, restore and more steps equal an uninterrupted run's;
  - a checkpoint written by comd_tpu, restored by the port, prints the
    rows comd_tpu's own restore prints; one written by the port is read by
    comd_tpu's ``load`` (meta.json without the port's ``device``) and
    prints the port's rows there;
  - a -m thread_atom_nl restore rebuilds the Verlet list on the restored
    positions (the same list as a fresh build) and continues within 1e-9;
  - a --checkpointRate that is not a multiple of -n fires on interval
    crossings, at the steps comd_tpu fires.
Reports: --yaml writes comd_tpu's sections and keys (plus the port's
``device``); --analyze prints comd_tpu's histogram lines; -s prints
report_phases' table (the same function as comd_tpu's) with comd_tpu's
phase names for EAM, LJ and NL.
These replace the NotImplementedError cases of the run tools in
tests/test_torch_cli.py::test_out_of_slice_options_raise.
"""
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from comd_tpu import Config as JConfig, cli as jcli
from comd_tpu import init_simulation as j_init
from comd_tpu.utils import checkpoint as jckpt
from comd_tpu.utils import profile as jprofile

from comd_tpu_torch import Config, cli as tcli, init_simulation
from comd_tpu_torch.ops import neighborlist as nlmod
from comd_tpu_torch.utils import checkpoint as tckpt
from comd_tpu_torch.utils import profile as tprofile

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POTS = os.path.join(REPO, "pots")
BASE = ["-e", "-x", "6", "-y", "6", "-z", "6", "--dtype", "float64", "-d",
        POTS]


def _rows(text):
    return [m.group(1) for m in re.finditer(
        r"^( +\d+ +[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+ +-?[\d.]+) ",
        text, re.M)]


def _port(argv, **kw):
    buf = io.StringIO()
    tcli.run(tcli.config_from_args(tcli.build_parser().parse_args(
        argv + ["--device", "cpu"])), out=buf, **kw)
    return buf.getvalue()


def _comd_tpu(argv, **kw):
    buf = io.StringIO()
    jcli.run(jcli.config_from_args(jcli.build_parser().parse_args(argv)),
             out=buf, **kw)
    return buf.getvalue()


def _states(sim):
    return sim.states if hasattr(sim, "states") else [sim.state]


def _assert_same_state(a, b):
    for sa, sb in zip(_states(a), _states(b)):
        for k in ("r", "p", "f", "gid", "n_atoms"):
            assert torch.equal(getattr(sa, k), getattr(sb, k)), k
    assert a.e_potential == b.e_potential


@pytest.mark.parametrize("kw,block", [
    (dict(nx=6, ny=6, nz=6, dtype="float32"), 10),
    (dict(nx=8, ny=8, nz=8, dtype="float64", xproc=2, yproc=2, zproc=2), 2)],
    ids=["serial-f32", "mesh-f64"])
def test_port_round_trip_continues_bit_for_bit(tmp_path, kw, block):
    """Save after two blocks, restore into a fresh simulation, one more
    block: the state of three uninterrupted blocks (serial: a rebucket
    before the save, so the restored rebucket baseline matters)."""
    cfg = Config(doeam=True, temperature=1200.0, pot_dir=POTS, device="cpu",
                 **kw)
    whole = init_simulation(cfg)
    part = init_simulation(cfg)
    for _ in range(3):
        whole.step_block(block)
    part.step_block(block)
    part.step_block(block)
    if block == 10:
        assert part.n_rebucket >= 1
    tckpt.save(str(tmp_path), part, 2 * block)
    meta = json.load(open(tmp_path / "meta.json"))
    assert "device" not in meta["config"] and meta["format"] == "npz"
    assert meta["has_last_r"]
    back, step = tckpt.load(str(tmp_path), device="cpu")
    assert step == 2 * block
    back.step_block(block)
    _assert_same_state(back, whole)


def test_port_refuses_orbax_checkpoint(tmp_path):
    cfg = Config(doeam=True, nx=4, ny=4, nz=4, pot_dir=POTS, device="cpu")
    tckpt.save(str(tmp_path), init_simulation(cfg), 0)
    meta = json.load(open(tmp_path / "meta.json"))
    meta["format"] = "orbax"
    json.dump(meta, open(tmp_path / "meta.json", "w"))
    with pytest.raises(ValueError, match="reads npz only"):
        tckpt.load(str(tmp_path), device="cpu")


def test_comd_tpu_checkpoint_restores_in_port(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    # comd_tpu writes npz where orbax is missing, as on the card's machine
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    _comd_tpu(BASE + ["-N", "4", "-n", "2"], checkpoint=ck)
    assert json.load(open(os.path.join(ck, "meta.json")))["format"] == "npz"
    argv = BASE + ["-N", "4", "-n", "2"]
    want = _rows(_comd_tpu(argv, restore=ck))
    out = _port(argv, restore=ck)
    assert "Restored checkpoint" in out
    assert len(want) == 3 and _rows(out) == want     # steps 4, 6, 8


def test_port_checkpoint_loads_in_comd_tpu(tmp_path):
    ck = str(tmp_path / "ck")
    _port(BASE + ["-N", "4", "-n", "2"], checkpoint=ck)
    jsim, step = jckpt.load(ck)
    tsim, _s = tckpt.load(ck, device="cpu")
    assert step == 4
    np.testing.assert_array_equal(np.asarray(jsim.state.r),
                                  tsim.state.r.numpy())
    argv = BASE + ["-N", "4", "-n", "2"]
    assert _rows(_comd_tpu(argv, restore=ck)) == _rows(_port(argv,
                                                             restore=ck))


def test_nl_restore_rebuilds_the_list(tmp_path):
    cfg = Config(doeam=True, nx=6, ny=6, nz=6, dtype="float64",
                 method="thread_atom_nl", pot_dir=POTS, device="cpu")
    whole = init_simulation(cfg)
    whole.step_block(4)
    tckpt.save(str(tmp_path), whole, 4)
    back, _step = tckpt.load(str(tmp_path), device="cpu")
    s = back.state
    assert torch.equal(back.nlist.last_r, s.r)
    p = back.nl_build_params()
    fresh, _ovf = nlmod.build(back.geom, back.maps.nbr_map, s.r, s.n_atoms,
                              k=p["k"], rcut2=p["rcut2"], n_rows=p["n_rows"],
                              row_split=p["row_split"])
    assert torch.equal(back.nlist.nl, fresh.nl)
    assert torch.equal(back.nlist.a_list, fresh.a_list)
    whole.step_block(4)
    back.step_block(4)
    assert back.e_potential == pytest.approx(whole.e_potential, rel=1e-9)


def test_checkpoint_rate_fires_on_crossings(tmp_path):
    argv = BASE + ["-N", "10", "-n", "4"]
    pat = r"^# (?:final )?checkpoint written.*$"
    got = re.findall(pat, _port(argv, checkpoint=str(tmp_path / "t"),
                                checkpoint_rate=3), re.M)
    want = re.findall(pat, _comd_tpu(argv, checkpoint=str(tmp_path / "j"),
                                     checkpoint_rate=3), re.M)
    assert [g.replace(str(tmp_path / "t"), "X") for g in got] == \
        [w.replace(str(tmp_path / "j"), "X") for w in want]
    assert got[:2] == ["# checkpoint written at step 4",
                       "# checkpoint written at step 8"]


def _yaml_keys(path):
    sections, cur = {}, None
    for line in open(path):
        if line.startswith("#"):
            continue
        if not line.startswith(" "):
            cur = line.split(":")[0]
            sections[cur] = []
        else:
            sections[cur].append(line.strip().split(":")[0])
    return sections


def test_yaml_has_comd_tpu_sections_and_keys(tmp_path):
    argv = BASE + ["-N", "2", "-n", "2"]
    for pkg, run in (("t", _port), ("j", _comd_tpu)):
        os.makedirs(tmp_path / pkg)
        run(argv, yaml_dir=str(tmp_path / pkg))
    (t,), (j,) = (os.listdir(tmp_path / p) for p in ("t", "j"))
    got, want = (_yaml_keys(tmp_path / p / f) for p, f in (("t", t),
                                                           ("j", j)))
    assert list(got) == list(want)
    for sec in want:
        extra = ["device"] if sec == "Command Line Parameters" else []
        assert got[sec] == want[sec][:len(got[sec]) - len(extra)] + extra \
            or sorted(got[sec]) == sorted(want[sec] + extra), sec


def test_analyze_prints_comd_tpu_histogram():
    argv = BASE + ["-N", "0", "-x", "7", "-y", "6", "-z", "5"]

    def hist(text):
        return [ln for ln in text.splitlines()
                if re.match(r"^ *\d+ +\d+$", ln) or ln.startswith("# mean")
                or ln.startswith("# cell-occupancy")]
    want = hist(_comd_tpu(argv, analyze=True))
    assert len(want) >= 3
    assert hist(_port(argv, analyze=True)) == want


@pytest.mark.parametrize("extra", [[], ["-m", "thread_atom_nl"], ["-L"]],
                         ids=["eam", "eam-nl", "lj-pairlist"])
def test_s_prints_comd_tpu_phases(extra):
    argv = BASE[(1 if extra == ["-L"] else 0):] + ["-s"] + extra
    out = _port(argv)
    names = re.findall(r"^  \[profile\] (\S+) +[\d.]+ ms$", out, re.M)
    jsim = j_init(jcli.config_from_args(jcli.build_parser().parse_args(
        argv)))
    assert names == list(jprofile._phase_fns(jsim))
    table = out.split("Phase profile (marginal per-invocation, -s mode)")[1]
    rows = re.findall(r"^(\S+) +(-?[\d.]+) +(-?[\d.]+)$", table, re.M)
    assert [r[0] for r in rows] == names
    assert all(float(r[1]) >= 0 for r in rows)
    assert "step (sum)" in table and "atom rate at this breakdown" in table
    assert "# cell-occupancy histogram" in out.split("-s mode")[1]
    assert [r.split()[0] for r in _rows(out)] == ["0"]     # -s: 0 steps
    results = {n: 1e-3 * (k + 1) for k, n in enumerate(names)}
    assert tprofile.report_phases(results, 864) == \
        jprofile.report_phases(results, 864)
