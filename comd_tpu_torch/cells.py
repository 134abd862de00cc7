"""Link-cell geometry: grid sizing, halo ordering, neighbor & halo maps.

Re-derives the reference link-cell structure (src-mpi/linkCells.c:65-182) as
*static host-side index maps* consumed by the step functions.  The
reference mutates cells with per-atom moves and special-cased 3D<->1D index
code; here everything becomes fixed-shape gathers driven by integer
arrays built once at init:

  - ``nbr_map[nLocalBoxes, 27]``   27-neighbor cell ids (self included, as in
                                   getNeighborBoxes, linkCells.c:202-214)
  - ``halo_src[nHaloBoxes]``       which interior cell each halo cell mirrors
  - ``halo_shift[nHaloBoxes, 3]``  PBC coordinate shift for that mirror
  - ``local_box_of_tuple``         row-major (or Hilbert) cell numbering

Cell numbering, including the x/y/z-plane halo ordering, matches
getBoxFromTuple / getTuple (linkCells.c:299-346, 497-568) exactly so that
box-indexed diagnostics line up with the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def compute_hilbert_code(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """3D Hilbert curve code, vectorized (reference: linkCells.c:28-63)."""
    x = np.asarray(x, dtype=np.int64).copy()
    y = np.asarray(y, dtype=np.int64).copy()
    z = np.asarray(z, dtype=np.int64).copy()
    nbits = 10
    transform = np.array([0, 1, 7, 6, 3, 2, 4, 5], dtype=np.int64)
    s = np.zeros_like(x)
    for i in range(nbits - 1, -1, -1):
        xi = (x >> i) & 1
        yi = (y >> i) & 1
        zi = (z >> i) & 1
        index = (xi << 2) + (yi << 1) + zi
        s = (s << 3) + transform[index]
        # state transforms (swap/complement), applied per-element
        nx, ny, nz_ = x.copy(), y.copy(), z.copy()
        m = index == 0
        nx[m], ny[m], nz_[m] = x[m], z[m], y[m]
        m = index == 1
        nx[m], ny[m], nz_[m] = y[m], x[m], z[m]
        m = index == 2
        nx[m], ny[m], nz_[m] = x[m], ~z[m], ~y[m]
        m = index == 3
        nx[m], ny[m], nz_[m] = ~y[m], ~x[m], z[m]
        m = (index == 4) | (index == 6)
        nx[m], ny[m], nz_[m] = ~x[m], y[m], ~z[m]
        m = index == 5
        nx[m], ny[m], nz_[m] = y[m], x[m], z[m]
        m = index == 7
        nx[m], ny[m], nz_[m] = ~y[m], ~x[m], z[m]
        x, y, z = nx, ny, nz_
    return s


def _is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


@dataclasses.dataclass(frozen=True)
class CellGeometry:
    """Static link-cell geometry for one domain (rank/shard)."""

    grid: tuple[int, int, int]          # local cells per axis
    box_size: np.ndarray                # [3] f64
    inv_box_size: np.ndarray            # [3] f64
    local_min: np.ndarray               # [3] f64
    local_max: np.ndarray               # [3] f64
    n_local: int
    n_halo: int
    n_total: int
    use_hilbert: bool
    # static maps
    local_box_of_tuple: np.ndarray      # [gx, gy, gz] -> local box id
    tuple_of_box: np.ndarray            # [n_total, 3] grid coords (-1..g)
    nbr_map: np.ndarray                 # [n_local, 27] int32
    halo_src: np.ndarray                # [n_halo] int32 (serial mirror source)
    halo_shift: np.ndarray              # [n_halo, 3] f64 (serial PBC shift)

    def box_from_tuple(self, ix, iy, iz):
        """Vectorized getBoxFromTuple (linkCells.c:299-346)."""
        gx, gy, gz = self.grid
        ix = np.asarray(ix, dtype=np.int64)
        iy = np.asarray(iy, dtype=np.int64)
        iz = np.asarray(iz, dtype=np.int64)
        n_local = self.n_local

        zp = n_local + 2 * gz * gy + 2 * gz * (gx + 2) + \
            (gx + 2) * (gy + 2) + (gx + 2) * (iy + 1) + (ix + 1)
        zm = n_local + 2 * gz * gy + 2 * gz * (gx + 2) + \
            (gx + 2) * (iy + 1) + (ix + 1)
        yp = n_local + 2 * gz * gy + gz * (gx + 2) + (gx + 2) * iz + (ix + 1)
        ym = n_local + 2 * gz * gy + iz * (gx + 2) + (ix + 1)
        xp = n_local + gy * gz + iz * gy + iy
        xm = n_local + iz * gy + iy
        # local lookup needs in-range indices; clamp for the masked-out lanes
        lx = np.clip(ix, 0, gx - 1)
        ly = np.clip(iy, 0, gy - 1)
        lz = np.clip(iz, 0, gz - 1)
        local = self.local_box_of_tuple[lx, ly, lz]
        # priority order matches the reference if/else chain: z, then y, then x
        return np.select(
            [iz == gz, iz == -1, iy == gy, iy == -1, ix == gx, ix == -1],
            [zp, zm, yp, ym, xp, xm],
            default=local,
        ).astype(np.int32)


def make_geometry(local_min, local_max, cutoff: float,
                  use_hilbert: bool = False,
                  cell_size=None) -> CellGeometry:
    """Build geometry for a local domain (initLinkCells, linkCells.c:122-182).

    ``cutoff`` here is the minimum legal cell size (pair cutoff + skin); the
    default sizing truncates like the reference (grid = floor(extent/cutoff)).
    ``cell_size`` (scalar or [3]) overrides the sizing with an explicit cell
    edge that must tile the extent exactly -- used by the lattice-commensurate
    plan (plan_cells), where cell = (k/2)*lat aligns cell faces midway between
    FCC site planes so occupancy is uniform and capacity carries no slack.
    """
    local_min = np.asarray(local_min, dtype=np.float64)
    local_max = np.asarray(local_max, dtype=np.float64)
    extent = local_max - local_min
    if cell_size is not None:
        cs = np.broadcast_to(np.asarray(cell_size, np.float64), (3,))
        grid = tuple(int(round(extent[i] / cs[i])) for i in range(3))
        for i in range(3):
            if abs(grid[i] * cs[i] - extent[i]) > 1e-8 * extent[i]:
                raise ValueError(
                    f"cell_size {cs} does not tile extent {extent} "
                    f"(axis {i}: {grid[i]} cells)")
        if cs.min() < cutoff * (1.0 - 1e-12):
            raise ValueError(
                f"cell_size {cs} below minimum legal cell {cutoff} "
                f"(pair cutoff + skin)")
    else:
        grid = tuple(int(extent[i] / cutoff) for i in range(3))  # trunc, as in C
    if min(grid) < 2:
        raise ValueError(
            f"local domain too small: grid {grid} needs >=2 cells per axis "
            f"(extent {extent}, cutoff {cutoff})")
    box_size = extent / np.array(grid, dtype=np.float64)
    gx, gy, gz = grid
    n_local = gx * gy * gz
    n_halo = 2 * ((gx + 2) * (gy + gz + 2) + gy * gz)
    n_total = n_local + n_halo

    if use_hilbert and not (_is_pow2(gx) and _is_pow2(gy) and _is_pow2(gz)):
        use_hilbert = False

    # local cell numbering (row-major x-fastest, or Hilbert)
    X, Y, Z = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz),
                          indexing="ij")
    if use_hilbert:
        box_id = compute_hilbert_code(X, Y, Z)
    else:
        box_id = X + Y * gx + Z * gx * gy
    local_box_of_tuple = box_id.astype(np.int32)

    geom = CellGeometry(
        grid=grid,
        box_size=box_size,
        inv_box_size=1.0 / box_size,
        local_min=local_min,
        local_max=local_max,
        n_local=n_local,
        n_halo=n_halo,
        n_total=n_total,
        use_hilbert=use_hilbert,
        local_box_of_tuple=local_box_of_tuple,
        tuple_of_box=np.zeros((n_total, 3), np.int32),  # filled below
        nbr_map=np.zeros((n_local, 27), np.int32),
        halo_src=np.zeros((n_halo,), np.int32),
        halo_shift=np.zeros((n_halo, 3), np.float64),
    )

    # tuple_of_box: invert numbering for local boxes; enumerate halo tuples
    tuples = np.zeros((n_total, 3), dtype=np.int32)
    flat_local = local_box_of_tuple.reshape(-1)
    coords = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
    tuples[flat_local] = coords
    # halo tuples: all tuples in [-1..g] shell, mapped through box_from_tuple
    hx, hy, hz = np.meshgrid(np.arange(-1, gx + 1), np.arange(-1, gy + 1),
                             np.arange(-1, gz + 1), indexing="ij")
    hx, hy, hz = hx.reshape(-1), hy.reshape(-1), hz.reshape(-1)
    is_halo = (hx == -1) | (hx == gx) | (hy == -1) | (hy == gy) | \
        (hz == -1) | (hz == gz)
    hx, hy, hz = hx[is_halo], hy[is_halo], hz[is_halo]
    halo_ids = geom.box_from_tuple(hx, hy, hz)
    assert halo_ids.min() >= n_local and halo_ids.max() < n_total
    assert len(np.unique(halo_ids)) == n_halo == len(halo_ids)
    tuples[halo_ids] = np.stack([hx, hy, hz], axis=1)
    object.__setattr__(geom, "tuple_of_box", tuples)

    # 27-neighbor map for local cells (self at position 13, as in the
    # reference loop order i,j,k over -1..1; linkCells.c:202-214)
    t = tuples[:n_local]
    offs = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                indexing="ij"), axis=-1).reshape(27, 3)
    nbr = geom.box_from_tuple(
        t[:, None, 0] + offs[None, :, 0],
        t[:, None, 1] + offs[None, :, 1],
        t[:, None, 2] + offs[None, :, 2],
    )
    object.__setattr__(geom, "nbr_map", nbr.astype(np.int32))

    # serial halo mirror: halo cell <- wrapped local cell, with PBC shift.
    # (Multi-device halo exchange reuses the same tuples; see parallel/.)
    src_t = np.stack([hx % gx, hy % gy, hz % gz], axis=1)
    src_ids = geom.box_from_tuple(src_t[:, 0], src_t[:, 1], src_t[:, 2])
    shift = np.zeros((len(hx), 3), dtype=np.float64)
    ext = extent  # serial: local extent == global extent
    for a, h in enumerate((hx, hy, hz)):
        shift[:, a] = np.where(h == -1, -ext[a], np.where(h == grid[a], ext[a], 0.0))
    halo_src = np.zeros((n_halo,), np.int32)
    halo_shift = np.zeros((n_halo, 3), np.float64)
    halo_src[halo_ids - n_local] = src_ids
    halo_shift[halo_ids - n_local] = shift
    object.__setattr__(geom, "halo_src", halo_src)
    object.__setattr__(geom, "halo_shift", halo_shift)
    return geom


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """Resolved cell sizing for one run (see plan_cells)."""
    cell_size: np.ndarray      # [3] f64 local cell edge per axis
    skin: float                # rebucket/NL trigger skin (cell slack)
    max_atoms: int             # resolved per-cell capacity
    mode: str                  # "commensurate" | "classic"
    t0_max_occ: int            # measured t=0 peak occupancy
    mean_occ: float            # mean atoms per cell
    boundary_margin: float     # min site distance to a cell face at t=0 (A)


def _occupancy_stats(r: np.ndarray, cell: np.ndarray, extent: np.ndarray):
    """t=0 occupancy max and min site-to-face margin for an atom set binned
    on a grid of the given cell size.  ``r`` may be any subset of the global
    atoms (multi-host planning bins only the local shards' atoms and reduces
    the results across processes)."""
    if len(r) == 0:
        return 0, np.inf
    cell = np.asarray(cell, np.float64)
    grid = np.maximum(np.round(extent / cell).astype(np.int64), 1)
    idx = np.clip(np.floor(r / cell).astype(np.int64), 0, grid - 1)
    flat = idx[:, 0] + grid[0] * (idx[:, 1] + grid[1] * idx[:, 2])
    counts = np.bincount(flat, minlength=int(np.prod(grid)))
    frac = r / cell - np.floor(r / cell)
    margin = float((np.minimum(frac, 1.0 - frac) * cell).min())
    return int(counts.max()), margin


def _round8(v: int) -> int:
    return max(8, -(-v // 8) * 8)


def _slot_cost(a_cap: int, mean_occ: float) -> float:
    """Relative sweep cost per atom for capacity A: the pair tensor is
    [C, A, 27A]; A rides sublanes (padded to 8) and 27A rides lanes (padded
    to 128), and every slot pair costs the same VPU work whether occupied or
    not (measured ~95% of roofline per slot pair, docs/BENCHMARKS.md).

    A<32 configs run the static shifted-slice sweep (config.resolved_sweep
    _impl) which at chunk=1024 pays only ~1.25x per slot pair vs the A=32
    gather sweep (round-3 measurement: 39.3 vs 49.0 Gslot-pairs/s; the
    earlier ~1.9x "A<32 anomaly" was per-chunk slice/gather overhead,
    amortized by larger chunks).  With that penalty the model ranks the
    three measured 1M-atom EAM configs correctly (k=3 dense 758 < k=4
    exact-pack 896 < classic 2048 model units, against measured step costs
    36.5 < 42.3 < 107 ns/atom)."""
    sub = _round8(a_cap) * (1.25 if a_cap < 32 else 1.0)
    lanes = -(-27 * a_cap // 128) * 128
    return sub * lanes / max(mean_occ, 1e-9)


def plan_cells(*, cutoff: float, lat: float, n_cells, proc_grid,
               r_global: np.ndarray, skin_req: float, lazy: bool,
               mode: str = "auto", max_atoms: int = 0,
               trigger_from_cell: bool = True,
               n_atoms_total: int = None,
               stat_reduce=None,
               margin_slots: int = 0) -> CellPlan:
    """Choose cell size + per-cell capacity for a run (comd_tpu addition,
    copied unchanged -- including the TPU-measured _slot_cost model -- so
    both packages plan the same capacity and compare slot for slot).

    The reference fixes MAXATOMS=64 at compile time (Makefile:16) and sizes
    cells by truncation (linkCells.c:131); on TPU the sweep cost is
    proportional to *capacity slots*, not atoms, so slack is the dominant
    waste (mean occupancy ~14 of 32 on the classic EAM grid).  Two candidate
    sizings are priced against the measured slot-cost model and the cheaper
    one wins:

      - classic: grid = floor(extent / (cutoff + skin_req)), the reference
        sizing.  t=0 FCC/grid commensuration spikes force capacity ~2.3x the
        mean occupancy.
      - commensurate: cell = (k/2)*lat for the smallest legal k.  FCC site
        planes sit at (0.25 + 0.5*m)*lat, so every cell face falls exactly
        midway between site planes (0.25*lat = 0.90 A margin for Cu):
        occupancy is uniform (exactly 32 at k=4; 13-14 at k=3), capacity
        carries no slack, and thermal motion (~0.15 A rms at 600 K) cannot
        reach a face, so occupancy is also stable in time.

    Capacity ``max_atoms``: 0 = auto, resolved to round8(t=0 max occupancy).
    Commensurate grids are occupancy-stable by the margin argument; classic
    grids rely on the measured fact that t=0 commensuration spikes *relax*
    under dynamics (equilibrated peak 27 < 32, docs/BENCHMARKS.md).  The
    in-program overflow flag aborts loudly if a run ever exceeds capacity
    (cli.py), so mis-sizing cannot corrupt a trajectory.

    Args:
      n_cells: (nx, ny, nz) global unit cells; proc_grid: (px, py, pz).
      r_global: [n, 3] generated global positions (post -r displacement).
      skin_req: requested absolute skin (cutoff * -S), shapes the classic
        sizing and the minimum commensurate slack when ``lazy``.
      mode: "auto" (price both), "commensurate" (require), "classic".
      trigger_from_cell: return skin = min(cell) - cutoff (max legal rebucket
        trigger, lazy cell methods); False keeps skin_req (NL paths, where a
        larger skin would inflate the Verlet K).
      n_atoms_total: global atom count when ``r_global`` is a local subset
        (multi-host init bins only the shards this process owns).
      stat_reduce: callable ((t0_max, margin)) -> (t0_max, margin) combining
        the local occupancy stats across processes (max, min); None = the
        atom set is already global.
    """
    extent = np.array([n * lat for n in n_cells], np.float64)
    local_ext = extent / np.asarray(proc_grid, np.float64)

    candidates = []
    if mode in ("auto", "classic"):
        g = np.floor(local_ext / (cutoff + skin_req)).astype(int)
        if g.min() >= 2:
            candidates.append(("classic", local_ext / g))
        elif mode == "classic":
            raise ValueError(
                f"local domain too small: classic grid {tuple(g)} needs >=2 "
                f"cells per axis (extent {local_ext}, "
                f"cell {cutoff + skin_req})")
    if mode in ("auto", "commensurate"):
        # minimum slack so lazy rebuilds stay amortized; eager runs only
        # need cell > cutoff
        min_cell = cutoff + (0.4 * skin_req if lazy else 0.0)
        k_lo = int(np.ceil(2 * min_cell / lat - 1e-12))
        feas = []                   # per-axis feasible k lists
        for n, p in zip(n_cells, proc_grid):
            if (2 * n) % p != 0:
                feas = None
                break
            m = 2 * n // p          # local extent in half-lattice units
            ks = [k for k in range(k_lo, m // 2 + 1)
                  if m % k == 0 and k * lat / 2 > cutoff * (1 + 1e-9)]
            if not ks:
                feas = None
                break
            feas.append(ks)
        if feas is not None:
            # isotropic candidates (same k every axis): several feasible k
            # are priced -- the cost model decides (e.g. the k=4 exact-pack
            # cell of 2 whole unit cells beats smaller-k cells on v5e)
            common = sorted(set(feas[0]).intersection(*map(set, feas[1:])))
            cands_k = [[k] * 3 for k in common[:3]]
            smallest = [ks[0] for ks in feas]   # per-axis smallest (aniso)
            if smallest not in cands_k:
                cands_k.append(smallest)
            for kk in cands_k:
                candidates.append(
                    ("commensurate",
                     np.asarray([k * lat / 2 for k in kk])))
        elif mode == "commensurate":
            raise ValueError(
                "no lattice-commensurate cell size: need (2*n)%p == 0 and a "
                f"divisor k of 2n/p with k*lat/2 > cutoff (n={n_cells}, "
                f"p={proc_grid}, lat={lat}, cutoff={cutoff})")
    if not candidates:
        raise ValueError("no feasible cell sizing (domain too small)")

    n_total = n_atoms_total if n_atoms_total is not None else len(r_global)
    best = None
    scored = []
    for cand_mode, cell in candidates:
        t0_max, margin = _occupancy_stats(r_global, cell, extent)
        if stat_reduce is not None:
            t0_max, margin = stat_reduce((t0_max, margin))
        grid = np.maximum(np.round(extent / cell).astype(np.int64), 1)
        mean_occ = float(n_total / np.prod(grid))
        scored.append((cand_mode, cell, t0_max, margin, mean_occ))
    if max_atoms > 0:
        # an explicit capacity rules out sizings it cannot hold
        legal = [s for s in scored if s[2] <= max_atoms]
        if not legal:
            tmin = min(s[2] for s in scored)
            raise ValueError(
                f"cell capacity max_atoms={max_atoms} is below the minimum "
                f"t=0 occupancy {tmin} of every feasible cell sizing; "
                f"increase --maxAtoms (or 0 for auto)")
        scored = legal
    for cand_mode, cell, t0_max, margin, mean_occ in scored:
        a_cap = (max_atoms if max_atoms > 0
                 else _round8(t0_max + margin_slots))
        cost = _slot_cost(a_cap, mean_occ)
        plan = CellPlan(
            cell_size=np.asarray(cell, np.float64),
            skin=(float(np.min(cell)) - cutoff if trigger_from_cell
                  else skin_req),
            max_atoms=a_cap, mode=cand_mode, t0_max_occ=t0_max,
            mean_occ=mean_occ, boundary_margin=margin)
        # strict < : commensurate (listed second under "auto") also wins
        # ties, since its occupancy is stable in time
        if best is None or cost < best[0] or (
                cost == best[0] and cand_mode == "commensurate"):
            best = (cost, plan)
    return best[1]


def boundary_lists(geom: CellGeometry, ring: int = 1):
    """(interior_ids, boundary_ids): local cells split by distance to the
    halo shell (SetBoundaryCells analog, src-mpi/gpu_utility.c:73-163).

    ``ring=1`` marks cells whose 27-neighborhood touches halo cells -- the
    set whose force evaluation depends on ghost data.  Interior cells can be
    computed while exchanges are in flight (the -a capability).
    """
    t = geom.tuple_of_box[:geom.n_local]
    g = geom.grid
    is_boundary = np.zeros(geom.n_local, dtype=bool)
    for a in range(3):
        is_boundary |= (t[:, a] < ring) | (t[:, a] >= g[a] - ring)
    boundary = np.flatnonzero(is_boundary).astype(np.int32)
    interior = np.flatnonzero(~is_boundary).astype(np.int32)
    return interior, boundary


def box_from_coord(geom: CellGeometry, r: np.ndarray) -> np.ndarray:
    """Vectorized getBoxFromCoord with ownership tie-breaking
    (linkCells.c:448-480).  ``r`` is [..., 3]; returns box ids."""
    rel = (r - geom.local_min) * geom.inv_box_size
    idx = np.floor(rel).astype(np.int64)
    out = []
    for a in range(3):
        g = geom.grid[a]
        ia = idx[..., a]
        inside = r[..., a] < geom.local_max[a]
        ia = np.where(inside & (ia == g), g - 1, ia)
        ia = np.where(~inside, g, ia)
        out.append(np.clip(ia, -1, g))
    return geom.box_from_tuple(out[0], out[1], out[2])
