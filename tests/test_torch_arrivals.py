"""The atom exchange's unload (ops/cuda/arrivals.py) against comd_tpu, bit
for bit, on the CPU (the plain versions: csrc/arrivals.cu's kernels are
held to them on the card in test_torch_kernel_cuda.py and chip_smoke.py).

Both packages get the same numpy-made, seeded inputs, f32 and f64:

  - one shard's append (``binning.append_arrivals``) of arrivals that
    hold local migrants, halo ghosts, coordinates on the domain's faces
    and invalid entries, and of a crowd binned into one cell past A (the
    overflow flag and the counts);
  - one stage's two directions in one ``binning.append_stage``, each
    shifted along the stage's axis, with the sender's cell counts or a
    flag an entry as the mask, against two appends in a row of comd_tpu's
    on the shifted positions;
  - ``sort_cells`` of rows with many tied EMPTY_GIDs (their junk positions
    keep their slot order), and ``sort_shards`` in place and into other
    tensors;
  - the stage entry over the shard lists of a 2x2x2 and a 1x1x2 mesh: the
    arrivals of every stage as the collective transport (flags) and the
    ki transport (counts) deliver them, each shard against comd_tpu's
    appends of its two directions, then the sort;
  - the operand checks, and the ctypes layouts of csrc/arrivals.cu's
    argument structs.
"""
import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comd_tpu import cells as jcells
from comd_tpu.ops import binning as jbin

from comd_tpu_torch import Config, cells as tcells, init_simulation
from comd_tpu_torch.ops import binning as tbin
from comd_tpu_torch.ops.cuda import arrivals as av
from comd_tpu_torch.parallel import exchange as tex, ki_comm

torch.set_num_threads(1)

POTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pots")
CUT = 4.0            # the synthetic grids' cell edge
EMPTY_GID = np.int32(2 ** 31 - 1)
DTYPES = [np.float32, np.float64]


def _geoms(lo, n: int = 4):
    """comd_tpu's and the port's geometry of [lo, lo + n CUT)^3."""
    lo = np.asarray(lo, np.float64)
    hi = lo + n * CUT
    jg = jcells.make_geometry(lo, hi, CUT)
    tg = tcells.make_geometry(lo, hi, CUT)
    assert jg.grid == tg.grid == (n, n, n)
    return jg, tg


def _cells(tg, A: int, dtype, rng, fill: float = 0.5) -> dict:
    """Cells of capacity ``A``: up to ``fill * A`` atoms in every cell,
    local and halo (gids unique below 2^20), the empty slots EMPTY_GID,
    1e10 and 0 as after a rebucket."""
    B = tg.n_total
    counts = rng.integers(0, int(fill * A) + 1, size=B).astype(np.int32)
    slot = np.arange(A)[None, :] < counts[:, None]
    r = np.where(slot[None], rng.uniform(-9.0, 30.0, (3, B, A)), 1e10)
    p = np.where(slot[None], rng.standard_normal((3, B, A)), 0.0)
    gid = np.full((B, A), EMPTY_GID, np.int32)
    gid[slot] = rng.permutation(2 ** 20)[:int(slot.sum())]
    return dict(r=r.astype(dtype), p=p.astype(dtype), gid=gid,
                n_atoms=counts)


def _positions(tg, kinds, dtype, rng) -> np.ndarray:
    """[3, M] coordinates: "m" a local migrant inside the domain, "g" a
    halo ghost in the shell of cells around it, "f" a value on a face of
    the domain or one ulp from it, "x" junk (an invalid entry)."""
    lo, hi, box = tg.local_min, tg.local_max, tg.box_size
    out = np.empty((3, len(kinds)))
    for i, k in enumerate(kinds):
        if k == "m":
            out[:, i] = rng.uniform(lo, hi)
        elif k == "g":
            x = rng.uniform(lo - box, hi + box)
            a = rng.integers(3)
            x[a] = rng.uniform(lo[a] - box[a], lo[a]) if rng.integers(2) \
                else rng.uniform(hi[a], hi[a] + box[a])
            out[:, i] = x
        elif k == "f":
            x = rng.uniform(lo, hi)
            a = rng.integers(3)
            v = dtype(rng.choice([lo[a], hi[a]]))
            x[a] = rng.choice([v, np.nextafter(v, dtype(-np.inf)),
                               np.nextafter(v, dtype(np.inf))])
            out[:, i] = x
        else:
            out[:, i] = rng.uniform(-1e3, 1e3, 3)
    return out.astype(dtype)


def _arrival(tg, kinds, dtype, rng, gids) -> tuple:
    """Flat numpy arrivals (r [3, M], p [3, M], gid [M], valid [M])."""
    r = _positions(tg, kinds, dtype, rng)
    p = rng.standard_normal(r.shape).astype(dtype)
    valid = np.array([k != "x" for k in kinds])
    gid = np.where(valid, gids[:len(kinds)],
                   rng.integers(0, 2 ** 31 - 1, len(kinds))).astype(np.int32)
    return r, p, gid, valid


def _mixed(n: int, rng) -> list:
    return list(rng.choice(["m", "g", "f", "x"], size=n, p=[0.35, 0.35,
                                                           0.1, 0.2]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _comd_append(jg, f: dict, arr) -> list:
    out = jbin.append_arrivals(
        jg, *(jnp.asarray(f[k]) for k in ("r", "p", "gid", "n_atoms")),
        *(jnp.asarray(a) for a in arr))
    return [np.asarray(x) for x in out]


def _numpy_fields(out) -> dict:
    return dict(zip(("r", "p", "gid", "n_atoms"),
                    (np.asarray(x) for x in out)))


def _assert_equal(got, want, names=("r", "p", "gid", "n_atoms",
                                    "overflow")):
    for name, a, b in zip(names, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["mixed", "crowded"])
def test_append_matches_comd_tpu(dtype, case):
    """One shard's append: migrants, ghosts, faces and invalid entries;
    or a crowd of 2A + 3 arrivals binned into one local cell (slots past
    A dropped, the flag set, the counts of every arrival)."""
    rng = np.random.default_rng(11 if case == "mixed" else 12)
    # no face at 0: XLA on the CPU flushes the f32 subnormals beside it to
    # zero, so comd_tpu would bin them as 0
    jg, tg = _geoms([8.0, 4.0, 12.0])
    A = 16
    f = _cells(tg, A, dtype, rng)
    gids = rng.permutation(2 ** 20)[:400] + 2 ** 20
    if case == "mixed":
        arr = _arrival(tg, _mixed(300, rng), dtype, rng, gids)
    else:
        arr = _arrival(tg, ["m"] * 60, dtype, rng, gids)
        c = tg.box_size * (np.array([1, 2, 1]) + 0.5) + tg.local_min
        arr[0][:, :2 * A + 3] = (c[:, None] + rng.uniform(
            -0.4, 0.4, (3, 2 * A + 3)) * tg.box_size[:, None]).astype(dtype)
    maps = tbin.geom_maps(tg, torch.from_numpy(f["r"]).dtype, "cpu")
    got = tbin.append_arrivals(tg, maps, *(_t(f[k]) for k in (
        "r", "p", "gid", "n_atoms")), *(_t(a) for a in arr))
    want = _comd_append(jg, f, arr)
    _assert_equal(got, want)
    assert bool(want[4]) == (case == "crowded")
    assert int((want[3] - f["n_atoms"]).sum()) == int(arr[3].sum())


def _sender_frame(arr, axis: int, shift: float, dtype):
    """The arrival as its sender holds it: the receiver-frame positions
    less the shift (the shift then added back as the exchange adds it,
    in r's dtype, may round differently: the reference shifts the same
    way)."""
    r = arr[0].copy()
    r[axis] = (r[axis] - dtype(shift)).astype(dtype)
    return (r,) + tuple(arr[1:])


def _shifted(arr, axis: int, shift: float, dtype):
    r = arr[0].copy()
    r[axis] = (r[axis] + dtype(shift)).astype(dtype)
    return (r,) + tuple(arr[1:])


def _as_counts(arr, n: int, A: int, rng):
    """The arrival as n sender cells of A slots (r, p [3, n, A], gid
    [n, A], counts [n]): slot i valid while i % A < counts[i // A]."""
    r, p, gid, _v = arr
    counts = rng.integers(0, A + 1, size=n).astype(np.int32)
    counts[0] = A + 5            # a sender's count past A: every slot valid
    valid = (np.arange(A)[None, :] < counts[:, None]).reshape(-1)
    return ((r.reshape(3, n, A), p.reshape(3, n, A), gid.reshape(n, A),
             counts), valid)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("mask", ["flags", "counts"])
def test_stage_two_directions(dtype, mask):
    """Both directions of a y stage in one ``append_stage``: direction 0
    shifted by -ext, direction 1 by +ext, the same as comd_tpu's two
    appends in a row on the shifted positions (direction 1's ranks after
    every direction-0 arrival of a cell); the given arrivals stay as they
    were."""
    rng = np.random.default_rng(21)
    jg, tg = _geoms([8.0, 16.0, 8.0])
    A, n, axis = 16, 12, 1
    ext = float(dtype(4 * CUT))
    f = _cells(tg, A, dtype, rng)
    gids = rng.permutation(2 ** 20) + 2 ** 20
    srcs, flat = [], []
    for d, shift in enumerate((-ext, ext)):
        arr = _arrival(tg, _mixed(n * A, rng), dtype, rng,
                       gids[d * n * A:])
        arr = _sender_frame(arr, axis, shift, dtype)
        if mask == "counts":
            src, valid = _as_counts(arr, n, A, rng)
        else:
            src, valid = arr, arr[3]
        srcs.append(tuple(_t(x) for x in src))
        flat.append(_shifted(arr[:3] + (valid,), axis, shift, dtype))
    want, ovf = f, False
    for arr in flat:
        out = _comd_append(jg, want, arr)
        ovf = ovf | out[4]
        want = _numpy_fields(out[:4])
    fields = [[_t(f[k])] for k in ("r", "p", "gid", "n_atoms")]
    before = [[x.clone() for x in s] for s in srcs]
    overflow = torch.zeros((), dtype=torch.bool)
    maps = tbin.geom_maps(tg, fields[0][0].dtype, "cpu")
    tbin.append_stage(tg, maps, *fields, [srcs], overflow, axis,
                      (-ext, ext))
    _assert_equal([x[0] for x in fields] + [overflow],
                  [want[k] for k in ("r", "p", "gid", "n_atoms")] + [ovf])
    for s, b in zip(srcs, before):
        assert all(torch.equal(x, y) for x, y in zip(s, b))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_sort_cells_ties(dtype):
    """Rows with many EMPTY_GIDs, each empty slot holding its own junk
    position: the stable sort keeps their slot order (comd_tpu's argsort
    is stable too); ``sort_shards`` in place and into other tensors."""
    rng = np.random.default_rng(31)
    B, A = 30, 13
    gid = rng.integers(0, 2 ** 30, (B, A)).astype(np.int32)
    gid[rng.uniform(size=(B, A)) < 0.5] = EMPTY_GID
    gid[3] = EMPTY_GID
    r = rng.uniform(-5, 5, (3, B, A)).astype(dtype)
    p = rng.standard_normal((3, B, A)).astype(dtype)
    want = [np.asarray(x) for x in jbin.sort_cells(
        jnp.asarray(r), jnp.asarray(p), jnp.asarray(gid))]
    _assert_equal(tbin.sort_cells(_t(r), _t(p), _t(gid)), want,
                  ("r", "p", "gid"))
    shards = [[_t(r), _t(p), _t(gid)] for _ in range(3)]
    out = [[torch.empty_like(x) for _ in range(3)] for x in shards[0]]
    tbin.sort_shards(*[[s[k] for s in shards] for k in range(3)], out)
    for s in range(3):
        _assert_equal([o[s] for o in out], want, ("r", "p", "gid"))
        _assert_equal(shards[s], (r, p, gid), ("r", "p", "gid"))
    tbin.sort_shards(*[[s[k] for s in shards] for k in range(3)])
    for s in shards:
        _assert_equal(s, want, ("r", "p", "gid"))


# the meshes of the stage entry: (box in unit cells, mesh, max_atoms)
MESHES = {"2x2x2": ((8, 8, 8), (2, 2, 2), 48),
          "1x1x2": ((6, 6, 6), (1, 1, 2), 32)}


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_state(request):
    """The port's sharded EAM init (f64), its atoms displaced by up to
    1.2 A and rebucketed with the halo landers kept, and comd_tpu's
    geometry of a shard."""
    box, grid, A = MESHES[request.param]
    sim = init_simulation(Config(
        nx=box[0], ny=box[1], nz=box[2], doeam=True, temperature=600.0,
        dtype="float64", max_atoms=A, pot_dir=POTS, device="cpu",
        xproc=grid[0], yproc=grid[1], zproc=grid[2]))
    tg = sim.geom
    jg = jcells.make_geometry(tg.local_min, tg.local_max, 1.0,
                              cell_size=tg.box_size)
    assert jg.grid == tg.grid
    rng = np.random.default_rng(41)
    nl = tg.n_local
    reb = []
    for s in sim.states:
        r = s.r.clone()
        valid = torch.arange(A)[None, :] < s.n_atoms[:nl, None]
        d = torch.from_numpy(rng.uniform(-1.2, 1.2, (3, nl, A)))
        r[:, :nl] += torch.where(valid[None], d, torch.zeros_like(d))
        reb.append(tbin.rebucket(tg, sim.maps, r, s.p, s.gid, s.n_atoms,
                                 keep_halo=True)[:4])
    return sim, jg, [list(f) for f in zip(*reb)]


@pytest.mark.parametrize("transport", ["collective", "ki"])
def test_stage_over_mesh(mesh_state, transport):
    """Every stage's arrivals as the transport delivers them (collective:
    a flag an entry; ki: the sender's cell counts) appended to every shard
    in one ``append_stage``, each shard equal to comd_tpu's appends of its
    two directions on the shifted positions; then ``sort_shards`` equal
    to comd_tpu's ``sort_cells`` of each shard."""
    sim, jg, reb = mesh_state
    h = sim.halo
    fields = [[t.clone() for t in f] for f in reb]
    overflow = torch.zeros((), dtype=torch.bool)
    moved = 0
    for axis in range(3):
        if transport == "collective":
            arrivals = tex.atom_arrivals(h, axis, *fields, overflow)
        else:
            arrivals = ki_comm.push_arrivals(h, axis, fields)
        ext = h.ext[axis]
        want = []
        for s in range(len(fields[0])):
            f = {k: fields[i][s].numpy().copy() for i, k in enumerate(
                ("r", "p", "gid", "n_atoms"))}
            for d, shift in enumerate((-ext, ext)):
                ar, ap, ag, mask = av._flat(arrivals[s][d],
                                            f["r"].shape[-1])
                arr = _shifted((ar.numpy(), ap.numpy(), ag.numpy(),
                                mask.numpy()), axis, shift, np.float64)
                moved += int(arr[3].sum())
                out = _comd_append(jg, f, arr)
                assert not bool(out[4])
                f = _numpy_fields(out[:4])
            want.append(f)
        tbin.append_stage(h.geom, h.maps, *fields, arrivals, overflow, axis,
                          (-ext, ext))
        for s, w in enumerate(want):
            _assert_equal([fields[i][s] for i in range(4)],
                          [w[k] for k in ("r", "p", "gid", "n_atoms")],
                          ("r", "p", "gid", "n_atoms"))
    assert moved > 0 and not bool(overflow)
    want = [[np.asarray(x) for x in jbin.sort_cells(
        *(jnp.asarray(t.numpy()) for t in (fields[0][s], fields[1][s],
                                           fields[2][s])))]
        for s in range(len(fields[0]))]
    tbin.sort_shards(*fields[:3])
    for s, w in enumerate(want):
        _assert_equal([fields[i][s] for i in range(3)], w, ("r", "p", "gid"))


def test_operand_checks():
    """The wrappers refuse what the kernels do not take, before the
    dispatch (on the CPU as on the card)."""
    rng = np.random.default_rng(51)
    _jg, tg = _geoms([0.0, 0.0, 0.0], n=3)
    f = _cells(tg, 8, np.float32, rng)
    r, p, gid, n = (_t(f[k]) for k in ("r", "p", "gid", "n_atoms"))
    maps = tbin.geom_maps(tg, torch.float32, "cpu")
    arr = tuple(_t(a) for a in _arrival(tg, _mixed(40, rng), np.float32,
                                        rng, np.arange(40) + 2 ** 20))
    ovf = torch.zeros((), dtype=torch.bool)

    def stage(fields=(r, p, gid, n), src=arr, overflow=ovf, axis=0):
        tbin.append_stage(tg, maps, *[[x.clone()] for x in fields],
                          [[src, src]], overflow, axis, (-1.0, 1.0))

    stage()
    bad_fields = [(r.double(), p, gid, n), (r[:2], p, gid, n),
                  (r, p[:, :-1], gid, n), (r, p, gid.long(), n),
                  (r, p, gid, n[:-1]), (r, p, gid, n.long()),
                  (r.transpose(1, 2).contiguous().transpose(1, 2), p, gid,
                   n),
                  (r[:, :tg.n_local], p[:, :tg.n_local], gid[:tg.n_local],
                   n[:tg.n_local])]
    for fields in bad_fields:
        with pytest.raises(ValueError):
            stage(fields=fields)
    ar, ap, ag, valid = arr
    bad_srcs = [(ar.double(), ap, ag, valid), (ar[:2], ap, ag, valid),
                (ar, ap[:, :-1], ag, valid), (ar, ap, ag.long(), valid),
                (ar, ap, ag, valid[:-1]), (ar, ap, ag, valid.int()),
                (ar.t().contiguous().t(), ap, ag, valid)]
    for src in bad_srcs:
        with pytest.raises(ValueError):
            stage(src=src)
    for kw in (dict(overflow=torch.zeros(1, dtype=torch.bool)),
               dict(overflow=torch.zeros((), dtype=torch.int32)),
               dict(axis=3)):
        with pytest.raises(ValueError):
            stage(**kw)
    with pytest.raises(ValueError):          # three directions
        tbin.append_stage(tg, maps, [r], [p], [gid], [n], [[arr] * 3], ovf)
    with pytest.raises(ValueError):          # counts of too few cells
        tbin.append_stage(tg, maps, [r], [p], [gid], [n],
                          [[(ar, ap, ag, torch.zeros(4, dtype=torch.int32))]],
                          ovf)
    wide = torch.zeros((3, tg.n_total, av.MAX_A + 1))
    with pytest.raises(ValueError):
        tbin.sort_cells(wide, wide, torch.zeros(wide.shape[1:],
                                                dtype=torch.int32))
    for out in ([[r]], [[r], [p], [gid.long()]], [[r], [p[:, 1:]], [gid]]):
        with pytest.raises(ValueError):
            tbin.sort_shards([r], [p], [gid], out)
    with pytest.raises(ValueError):
        tbin.sort_shards([r, r], [p], [gid])


def test_capacity_and_args_layout():
    """The staging capacity C (>= 2A, >= 32), the place blocks' warps, the
    sort blocks' shared memory (up to A = 3072 within 48 KB), and
    csrc/arrivals.cu's ArrivalsArgs and SortArgs as ctypes lays them out:
    64 sources of four pointers, 4 x 32 shard pointers, 7 pointers (the
    list, its length and ticket, the length read among them), 11
    doubles, 14 ints (3,272 bytes, under the 4 KB of kernel parameters);
    6 x 64 pointers and 4 ints."""
    assert [av.stage_capacity(a) for a in (1, 16, 40)] == [32, 32, 80]
    assert [av.place_warps(a) for a in (16, 40, 384, 385, 3072)] == \
        [8, 8, 8, 7, 1]
    assert av.sort_smem(16) == 4096 and av.sort_smem(13) == 19 * 13 * 16
    assert av.sort_smem(256) == 4096
    assert av.sort_smem(av.MAX_A) <= av.SMEM_LIMIT < av.sort_smem(
        av.MAX_A + 1)
    assert 8 * av.stage_capacity(av.MAX_A) <= av.SMEM_LIMIT < \
        8 * av.stage_capacity(av.MAX_A + 1)
    assert ctypes.sizeof(av._Source) == 32
    assert av._Args.r.offset == 2048
    assert av._Args.overflow.offset == 2048 + 4 * 256
    assert av._Args.list.offset == 3072 + 24
    assert av._Args.listed.offset == 3072 + 40
    assert av._Args.local_min.offset == 3072 + 56
    assert av._Args.grid.offset == 3128 + 11 * 8
    assert av._Args.place_blocks.offset == 3216 + 12 + 10 * 4 == 3268
    assert ctypes.sizeof(av._Args) == 3272 < 4096
    assert av._SortArgs.n_shards.offset == 6 * 64 * 8
    assert av._SortArgs.form.offset == 6 * 64 * 8 + 12
    assert ctypes.sizeof(av._SortArgs) == 6 * 64 * 8 + 16


def _cu_structs() -> tuple:
    """csrc/arrivals.cu's argument structs as (name, kind, dims) member
    lists, and its constants (kMaxShards, ...)."""
    import re
    with open(av.SOURCE) as fh:
        text = fh.read()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = ([0-9]+)", text)}
    consts["kSmemLimit"] = 48 * 1024
    assert re.search(r"constexpr int kSmemLimit = 48 \* 1024;", text)
    structs = {}
    for name, body in re.findall(r"\nstruct (\w+) \{\n(.*?)\n\};", text,
                                 re.S):
        members = []
        for line in body.splitlines():
            line = line.split("//")[0].strip()
            if not line:
                continue
            m = re.fullmatch(
                r"(?:const )?(\w+(?: \w+)?)(\*?) (\w+)((?:\[\w+\])*);", line)
            assert m, line
            base, ptr, member, dims = m.groups()
            dims = [consts[d] if d in consts else int(d)
                    for d in re.findall(r"\[(\w+)\]", dims)]
            members.append((member, "pointer" if ptr else base, dims))
        structs[name] = members
    return structs, consts


def _ctypes_members(struct) -> list:
    """A ctypes Structure's fields as (name, kind, dims)."""
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_double: "double", av._Source: "ArrivalSource"}
    out = []
    for name, t in struct._fields_:
        dims = []
        while hasattr(t, "_length_"):
            dims.append(t._length_)
            t = t._type_
        out.append((name, kinds[t], dims))
    return out


def test_args_mirror_the_source():
    """ops/cuda/arrivals.py's ctypes structs hold csrc/arrivals.cu's
    ArrivalSource, ArrivalsArgs and SortArgs member for member, in order
    and kind (a pointer, an int, a double, a source; the array extents),
    and its constants equal the kernel's, so the mirror cannot drift."""
    structs, consts = _cu_structs()
    assert (consts["kMaxShards"], consts["kSortShards"],
            consts["kSmemLimit"]) == (av.MAX_SHARDS, av.SORT_SHARDS,
                                      av.SMEM_LIMIT)
    assert set(structs) == {"ArrivalSource", "ArrivalsArgs", "SortArgs"}
    for name, mirror in (("ArrivalSource", av._Source),
                         ("ArrivalsArgs", av._Args),
                         ("SortArgs", av._SortArgs)):
        assert structs[name] == _ctypes_members(mirror), name


@pytest.mark.parametrize("A", [1, 16, 32, 33, av.MAX_A])
def test_sort_form_by_A(A):
    """The wrapper's sort form: the warp form (a cell a warp segment, one
    slot a lane, no shared memory) up to A = 32, the block form above,
    whose shared memory fits every A up to MAX_A."""
    assert av.sort_form(A) == ("warp" if A <= 32 else "block")
    if av.sort_form(A) == "block":
        assert av.sort_smem(A) <= av.SMEM_LIMIT
