"""Simulation assembly and the velocity-Verlet step (serial, EAM).

Port of comd_tpu.sim's serial half on PyTorch:
  - SimFlat / SimGpu state          -> one SimState dataclass of tensors
  - initSimulation                  -> init_simulation (CoMD.c:200-327)
  - timestep velocity-Verlet loop   -> Simulation.step_block, an eager
    Python loop of kernel launches on the state's device (timestep.c:48-100)
  - redistributeAtoms + sortAtomsGpu -> ops.binning.rebucket
  - atom halo exchange              -> serial periodic halo fill
  - kineticEnergy / sumAtoms        -> reductions (timestep.c:109-133)

The main path is the lazy-shell cell step: atoms are rebucketed only when
one of them moved skin/2 since the last rebucket (``needs_rebuild``); other
steps refresh the ghost positions.  The trigger is read on the host (one
device sync per step) where comd_tpu branched on the device with lax.cond.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import cells, lattice
from .config import Config
from .constants import KB_EV
from .ops import binning, force_eam
from .ops.neighborlist import needs_rebuild
from .potentials.eam import EamPotential, init_eam_pot


@dataclasses.dataclass
class SimState:
    """Dense cell state on one device. B = nTotalBoxes, A = capacity."""
    r: torch.Tensor          # [3, B, A] positions (halo cells hold images)
    p: torch.Tensor          # [3, B, A] momenta
    f: torch.Tensor          # [3, B, A] forces (halo region zero)
    gid: torch.Tensor        # [B, A] int32, EMPTY_GID in unused slots
    n_atoms: torch.Tensor    # [B] int32
    e_potential: torch.Tensor  # 0-dim energy_dtype
    n_local: torch.Tensor    # 0-dim int32: locally-owned atom count
    overflow: torch.Tensor   # 0-dim bool: any capacity overflow so far


@dataclasses.dataclass
class LazySimState:
    """SimState + rebucket-time position snapshot (lazy-shell stepping)."""
    sim: SimState
    last_r: torch.Tensor     # [3, B, A]


def not_ported(what: str, item: str):
    """Options outside the ported slice raise, naming the ROADMAP.md
    Queue 1 item that ports them, instead of running something else."""
    raise NotImplementedError(
        f"{what} is not ported to comd_tpu_torch yet (ROADMAP.md Queue 1 "
        f"item {item}); run it with comd_tpu")


def check_slice(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration outside the port."""
    if not cfg.doeam:
        not_ported("Lennard-Jones (a run without -e)", "7")
    if cfg.lj_interpolation:
        not_ported("-I table-interpolated LJ", "7")
    if cfg.spline:
        not_ported("-P spline tables", "8")
    if cfg.half_shell:
        not_ported("--halfShell", "9")
    if cfg.use_nl or cfg.use_pairlist:
        not_ported(f"the neighbor-list methods (-m {cfg.method}, -L)", "11")
    if cfg.nprocs > 1:
        not_ported("multi-device runs (-i/-j/-k > 1)", "12")
    if cfg.comm_impl != "collective":
        not_ported(f"--commImpl {cfg.comm_impl}", "13")
    if cfg.gpu_profile:
        not_ported("-s profiling mode", "6")


@dataclasses.dataclass
class Simulation:
    """Host-side handle: static params + device state + step functions."""
    cfg: Config
    pot: EamPotential
    geom: cells.CellGeometry
    global_extent: np.ndarray        # [3]
    n_global: int
    state: SimState
    lattice_const: float
    skin_eff: Optional[float] = None   # resolved trigger skin (plan_cells)

    def __post_init__(self):
        cfg = self.cfg
        self.device = torch.device(cfg.device)
        self.dtype = cfg.torch_dtype
        self.maps = binning.geom_maps(self.geom, self.dtype, self.device)
        self.pair_eval = force_eam.make_pair_evaluator(
            self.pot, self.dtype, self.device, cfg.resolved_interp_impl)
        self.f_eval = force_eam.make_f_eval(self.pot, self.dtype,
                                            self.device)
        self.last_r = None
        self.n_rebucket = 0          # lazy/eager rebuckets so far
        slot = torch.arange(cfg.max_atoms, device=self.device)
        self._slot = slot[None, :]

    @property
    def mass(self) -> float:
        return self.pot.mass

    @property
    def uses_lazy(self) -> bool:
        """Cell methods with a skin shell: rebucket on the skin/2 trigger."""
        return self.cfg.lazy_shell and self.cfg.relative_skin_distance > 0

    @property
    def skin(self) -> float:
        if not self.uses_lazy:
            return 0.0
        if self.skin_eff is not None:
            return self.skin_eff
        return self.pot.cutoff * self.cfg.relative_skin_distance

    def _c(self, x: float) -> float:
        """A step constant rounded to the dynamics dtype."""
        return float(np.asarray(x, dtype=np.dtype(self.cfg.dtype)))

    # ---------------- force + energy ----------------

    def force(self, r, n_atoms, want_energy: bool = True):
        """The EAM force (comd_tpu's ``_force_fn``): returns (f_loc
        [3, n_local, A], U [n_local, A] | None, ePot | None);
        ``want_energy=False`` skips the energy terms."""
        geom = self.geom
        f_loc, u_raw, _dfe = force_eam.eam_force(
            geom, self.maps.nbr_map, r, self.pair_eval, self.f_eval,
            lambda x: binning.fill_halo_scalar_serial(geom, self.maps, x),
            e_dtype=self.cfg.torch_energy_dtype, want_energy=want_energy,
            box_chunk=self.cfg.resolved_box_chunk)
        if u_raw is None:
            return f_loc, None, None
        valid = self._slot < n_atoms[:geom.n_local, None]
        u, e_pot = force_eam.finalize_eam_energy(
            u_raw, valid, self.cfg.torch_energy_dtype)
        return f_loc, u, e_pot

    def _full_force(self, f_loc, like):
        f = torch.zeros_like(like)
        f[:, :self.geom.n_local] = f_loc.to(like.dtype)
        return f

    def _finish(self, s: SimState, r, p, gid, n_atoms, ovf,
                want_energy: bool) -> SimState:
        """Force, second half kick and bookkeeping shared by both steps."""
        f_loc, _u, e_pot = self.force(r, n_atoms, want_energy)
        if e_pot is None:
            e_pot = s.e_potential
        f = self._full_force(f_loc, s.f)
        p = p + self._c(0.5 * self.cfg.dt) * f
        n_local = n_atoms[:self.geom.n_local].sum(dtype=torch.int32)
        return SimState(r=r, p=p, f=f, gid=gid, n_atoms=n_atoms,
                        e_potential=e_pot, n_local=n_local,
                        overflow=s.overflow | ovf)

    def _drift(self, s: SimState):
        p = s.p + self._c(0.5 * self.cfg.dt) * s.f
        r = s.r + p * self._c(self.cfg.dt * (1.0 / self.mass))
        return r, p

    def _rebucket(self, r, p, gid, n_atoms):
        r_l, p_l, gid2, n2, _nm, ovf = binning.rebucket(
            self.geom, self.maps, r, p, gid, n_atoms,
            wrap_extent=self.global_extent)
        r2, gid2, n2 = binning.fill_halo_serial(self.geom, self.maps, r_l,
                                                gid2, n2)
        self.n_rebucket += 1
        return r2, p_l, gid2, n2, ovf

    def step_eager(self, s: SimState, want_energy: bool = True) -> SimState:
        """One step with a rebucket every step (comd_tpu's ``_make_step``;
        ``-S 0`` or ``lazy_shell=False``: the reference's per-step
        redistribution)."""
        r, p = self._drift(s)
        r, p, gid, n_atoms, ovf = self._rebucket(r, p, s.gid, s.n_atoms)
        return self._finish(s, r, p, gid, n_atoms, ovf, want_energy)

    def step_lazy(self, c: LazySimState,
                  want_energy: bool = True) -> LazySimState:
        """Cell-sweep step with the skin/2 rebucket trigger (comd_tpu's
        ``_make_step_lazy``, the main path): the dense
        redistribution (sort + scatter + halo rebuild) runs only when some
        atom moved skin/2 since the last rebucket; other steps refresh the
        ghost positions (in place on the drifted positions)."""
        s = c.sim
        r, p = self._drift(s)
        if bool(needs_rebuild(c.last_r, r, self.geom.n_local, self.skin)):
            r, p, gid, n_atoms, ovf = self._rebucket(r, p, s.gid, s.n_atoms)
            last_r = r
        else:
            binning.refresh_halo_positions(self.geom, self.maps, r)
            gid, n_atoms, last_r = s.gid, s.n_atoms, c.last_r
            ovf = torch.zeros((), dtype=torch.bool, device=self.device)
        return LazySimState(
            sim=self._finish(s, r, p, gid, n_atoms, ovf, want_energy),
            last_r=last_r)

    # ---------------- stepping ----------------

    def step_block(self, n_steps: int) -> None:
        """Run n_steps of velocity-Verlet.

        Forces are identical every step; the energy terms are computed only
        on the LAST step of the block -- the block boundary IS the
        reporting boundary (CoMD.c:146-162) -- unless
        ``cfg.energy_every_step``.
        """
        for k in range(n_steps):
            want = (k == n_steps - 1 or n_steps == 1
                    or self.cfg.energy_every_step)
            if self.uses_lazy:
                if self.last_r is None:
                    self.last_r = self.state.r
                out = self.step_lazy(LazySimState(self.state, self.last_r),
                                     want)
                self.state, self.last_r = out.sim, out.last_r
            else:
                self.state = self.step_eager(self.state, want)

    def compute_force(self) -> None:
        """Force-only evaluation (used at init; CoMD.c:314)."""
        s = self.state
        f_loc, _u, e_pot = self.force(s.r, s.n_atoms)
        self.state = dataclasses.replace(
            s, f=self._full_force(f_loc, s.f), e_potential=e_pot)

    def kinetic_energy(self) -> float:
        """eKinetic = sum p^2/2m over local atoms (timestep.c:109-133)."""
        p = self.state.p[:, :self.geom.n_local]
        e = 0.5 * (p.to(self.cfg.torch_energy_dtype) ** 2).sum() / self.mass
        return float(e)

    @property
    def e_potential(self) -> float:
        return float(self.state.e_potential)

    def sum_atoms(self) -> int:
        return int(self.state.n_atoms[:self.geom.n_local].sum())

    def temperature(self) -> float:
        return self.kinetic_energy() / self.n_global / KB_EV / 1.5

    def max_occupancy(self) -> int:
        return int(self.state.n_atoms[:self.geom.n_local].max())


def _tscope(timers, name: str):
    """Timer scope when ``timers`` is given, else a no-op."""
    return timers.scope(name) if timers is not None else \
        contextlib.nullcontext()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_simulation(cfg: Config, timers=None) -> Simulation:
    """Build the initial state (initSimulation, CoMD.c:200-327) on
    ``cfg.device``.  Serial EAM only: other configurations raise
    NotImplementedError (``check_slice``)."""
    cfg = cfg.resolve()
    check_slice(cfg)
    pot = init_eam_pot(cfg.pot_dir, cfg.pot_name, cfg.pot_type)

    lat = cfg.lat if cfg.lat > 0 else pot.lat
    global_extent = np.array([cfg.nx, cfg.ny, cfg.nz], np.float64) * lat

    # --- host-side scene generation (numpy, reference-exact) ---
    r, gid = lattice.create_fcc_lattice(
        cfg.nx, cfg.ny, cfg.nz, lat, np.zeros(3), global_extent)
    n_global = 4 * cfg.nx * cfg.ny * cfg.nz
    if r.shape[0] != n_global:
        raise RuntimeError(f"lattice has {r.shape[0]} atoms, "
                           f"expected {n_global}")
    p = lattice.set_temperature(gid, pot.mass, cfg.temperature, n_global)
    r = lattice.random_displacements(r, gid, cfg.initial_delta)

    cfg, geom, plan = plan_geometry(
        cfg, pot, lat, r, (cfg.nx, cfg.ny, cfg.nz), (1, 1, 1),
        np.zeros(3), global_extent)

    state = bin_atoms_host(geom, cfg, r, p, gid)
    sim = Simulation(cfg=cfg, pot=pot, geom=geom,
                     global_extent=global_extent, n_global=n_global,
                     state=state, lattice_const=lat, skin_eff=plan.skin)

    # fill halo + first force (CoMD.c:303-318)
    with _tscope(timers, "redistribute"), _tscope(timers, "atomHalo"):
        s = sim.state
        binning.fill_halo_serial(geom, sim.maps, s.r, s.gid, s.n_atoms)
        _sync(sim.device)
    with _tscope(timers, "force"):
        sim.compute_force()
        _sync(sim.device)
    return sim


def plan_geometry(cfg: Config, pot, lat: float, r_global: np.ndarray,
                  n_cells, proc_grid, local_min, local_max):
    """Resolve cell sizing + capacity (cells.plan_cells) and build the local
    CellGeometry.  Returns (cfg', geom, plan) with cfg' carrying the
    *resolved* max_atoms and cell_mode.  Cell-sweep methods use the full
    cell slack min(cell) - cutoff as the rebucket trigger."""
    lazy = cfg.lazy_shell and cfg.relative_skin_distance > 0
    skin_req = pot.cutoff * cfg.relative_skin_distance if lazy else 0.0

    # auto-capacity margin near/above melting or under large -r jitter
    # (comd_tpu.sim.plan_geometry)
    margin = 8 if (cfg.temperature > 1200.0
                   or cfg.initial_delta > 0.3) else 0
    plan = cells.plan_cells(
        cutoff=pot.cutoff, lat=lat, n_cells=n_cells, proc_grid=proc_grid,
        r_global=r_global, skin_req=skin_req, lazy=lazy,
        mode=cfg.cell_mode, max_atoms=cfg.max_atoms, trigger_from_cell=True,
        margin_slots=margin)
    cfg = dataclasses.replace(cfg, max_atoms=plan.max_atoms,
                              cell_mode=plan.mode)
    geom = cells.make_geometry(
        np.asarray(local_min, np.float64), np.asarray(local_max, np.float64),
        pot.cutoff + (plan.skin if lazy else 0.0),
        use_hilbert=cfg.do_hilbert, cell_size=plan.cell_size)
    return cfg, geom, plan


def bin_atoms_host_np(geom: cells.CellGeometry, cfg: Config,
                      r: np.ndarray, p: np.ndarray,
                      gid: np.ndarray) -> dict:
    """Host binning of generated atoms into the dense cell layout.

    Returns a dict of NUMPY arrays (comd_tpu.sim.bin_atoms_host_np)."""
    A = cfg.max_atoms
    B = geom.n_total
    dtype = np.dtype(cfg.dtype)

    box = cells.box_from_coord(geom, r)
    if box.max() >= geom.n_local:
        raise ValueError("generated atom outside the local domain")
    order = np.lexsort((gid, box))
    box_s = box[order]
    counts = np.bincount(box_s, minlength=B).astype(np.int32)
    if counts.max() > A:
        raise ValueError(
            f"cell occupancy {counts.max()} exceeds capacity {A}; "
            f"increase Config.max_atoms")
    starts = np.zeros(B, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    rank = np.arange(len(box_s)) - starts[box_s]
    dest = box_s.astype(np.int64) * A + rank

    r_arr = np.full((3, B * A), binning.EMPTY_POS, dtype=dtype)
    p_arr = np.zeros((3, B * A), dtype=dtype)
    gid_arr = np.full((B * A,), binning.EMPTY_GID, dtype=np.int32)
    for a in range(3):
        r_arr[a, dest] = r[order, a]
        p_arr[a, dest] = p[order, a]
    gid_arr[dest] = gid[order]

    return dict(
        r=r_arr.reshape(3, B, A),
        p=p_arr.reshape(3, B, A),
        f=np.zeros((3, B, A), dtype=dtype),
        gid=gid_arr.reshape(B, A),
        n_atoms=counts,
    )


def bin_atoms_host(geom: cells.CellGeometry, cfg: Config,
                   r: np.ndarray, p: np.ndarray, gid: np.ndarray) -> SimState:
    """Host binning of generated atoms into a SimState on ``cfg.device``."""
    from .interop import state_from_numpy
    d = bin_atoms_host_np(geom, cfg, r, p, gid)
    d.update(e_potential=np.zeros((), np.dtype(cfg.energy_dtype)),
             n_local=np.asarray(len(gid), np.int32),
             overflow=np.zeros((), np.bool_))
    return state_from_numpy(d, cfg.device)
