"""Spatial domain decomposition over a mesh of shards (-i/-j/-k).

Port of comd_tpu.parallel.sharded.  The reference's MPI rank grid
(initDecomposition, src-mpi/decomposition.c) is a ``Mesh`` of shards; each
shard owns one brick of the box in its own local frame and holds its own
``SimState``.  All shards share one CellGeometry, GeomMaps and
ExchangePlan, as comd_tpu's shards run one program.  comd_tpu holds every
mesh array with a leading [Px, Py, Pz] shard index and runs each step as
one ``shard_map`` program; here each process holds its shards (all of
them in a single process; a contiguous block of them a process in a
multi-process launch, parallel/dist.py) on its one device, every
per-shard field as one [S, ...] stack of them (the step's buffers; each
shard's ``SimState`` views of the stacks, sim.stack_of), and each phase
of the cell paths -- the head (kick, drift, trigger), K1/K2's passes,
pass 2 and the landing -- is one launch over the stack, with the mesh's
exchanges between the phases (a head, the rebucket or the ghost refresh
as the trigger says, the rest, as in sim.py); in one process on the card
each step is one CUDA graph over every shard, the rebucket a conditional
node of it (stepgraph.py):

  - ``ppermute`` along an axis -> a ring shift over the shards' tensors,
    through ``torch.distributed`` where the neighbor is in another process
    (parallel/exchange.py), or the halo kernels of parallel/ki_comm.py
    under ``--commImpl ki|ki_fused`` (one launch a dfEmbed fill, three an
    atom exchange; across processes one launch a stage, pushing into the
    receive planes of the other processes' arenas over CUDA IPC, ordered by
    counters on the stream); the ghost-position refresh between rebuckets
    is one ``position_fill`` launch in one process under every transport
    (ki_comm.exchange_positions_ki), across processes one a stage under
    ki and ki_fused; so is the dfEmbed fill of ``collective`` and of the
    list paths in one process (``halo_fill``, K3's copies); collective's
    atom messages are one ``atom_pack`` launch a stage; the half-shell
    fold is one ``fold_halo`` launch a stage under every transport;
  - ``psum`` -> a sum over shards.  The lazy and neighbor-list triggers
    stay on the device in the graphs and are read on the host once a step
    by the eager loop (an allgather across processes); -a 1's migration
    flag on a -S 0 step is selected on the device (an allgather
    across processes).  ePot,
    n_local and the overflow flag stay on the device as this process's sums; the values the host reads
    (``e_potential``, ``kinetic_energy``, ``sum_atoms``, ``overflow``, ...)
    gather the per-shard partials of every process and reduce them in
    shard order, so a multi-process run prints the single process's digits.

The neighbor-list methods (-m *_nl, -L) keep one Verlet list a shard,
rebuilt after each atom exchange; their dfEmbed fill is comd_tpu's
``exchange_scalar`` under every --commImpl (the list rows carry no cell
layout for the fused transport), here K3's copies (``halo_fill``) in one
process, while the atom exchange follows --commImpl.  Under -a 1 (auto
for thread_atom_nl, warp_atom_nl and -L) the lists are built with the
interior/boundary row split and the interior rows sweep the pre-exchange
positions; the cell methods under -a 1 sweep their interior and boundary
cells apart on K1, the interior cells on the pre-exchange positions
(Physics.forces).  All of it runs on one CUDA stream: the split keeps
comd_tpu's data flow, and nothing overlaps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import cells, lattice
from ..config import Config
from ..constants import KB_EV
from ..ops import binning
from ..ops import neighborlist as nlmod
from ..sim import (Physics, SimState, _sync, _tscope, bin_atoms_host_np,
                   init_potential, plan_geometry, restack, stack_of)
from . import dist, exchange, ki_comm
from .mesh import Mesh, gen_shard_atoms, make_mesh


@dataclasses.dataclass
class ShardedSimulation(Physics):
    """The Simulation interface over a mesh of shards."""
    cfg: Config
    pot: object
    geom: cells.CellGeometry          # per-shard geometry (local frame)
    plan: exchange.ExchangePlan
    mesh: Mesh
    global_extent: np.ndarray
    n_global: int
    states: list                      # one SimState per owned shard
    lattice_const: float
    skin_eff: Optional[float] = None  # resolved trigger skin (plan_cells)

    def __post_init__(self):
        self._setup_physics()
        self.halo = exchange.make_halo(self.mesh, self.geom, self.maps,
                                       self.plan, self.dtype)
        self.last_r = None            # per shard, at the last rebucket
        self.nlists = None            # per shard (the *_nl methods)
        if self.uses_nl and self.cfg.resolved_gpu_async:
            # the boundary mask on the device: a rebuild reads it without a
            # copy from the host (the rebucket is a CUDA graph)
            is_b, ri, rb = nlmod.row_split_for(self.geom, self.cfg.max_atoms)
            self.nl_row_split = (torch.as_tensor(is_b, device=self.device),
                                 ri, rb)
        if self.cfg.comm_impl not in ("collective", "ki", "ki_fused"):
            raise ValueError(f"invalid comm_impl {self.cfg.comm_impl!r}")
        # per-shard ePot of this process's shards at the last energy step;
        # None after a restore, whose states hold the mesh's ePot
        self._e_parts = None

    @property
    def n_processes(self) -> int:
        return self.mesh.nprocs

    # ---------------- reductions over the processes ----------------

    def _gather(self, parts: torch.Tensor) -> torch.Tensor:
        """[n_owned, ...] values of this process's shards -> [n_shards,
        ...] of every shard in shard order (an allgather across
        processes)."""
        if self.mesh.nprocs == 1:
            return parts
        return dist.allgather(parts).reshape((-1,) + tuple(parts.shape[1:]))

    def _any(self, flag: torch.Tensor) -> bool:
        """A 0-dim bool of this process's shards, or-ed over the processes
        and read on the host."""
        if self.mesh.nprocs == 1:
            return bool(flag)
        return bool(dist.allgather(flag).any())

    # ---------------- the transports ----------------

    def _fill(self, x, rhobar):
        """dfEmbed halo fill over the mesh, per --commImpl, in place on
        the shards' [B, A] fields ``x`` (the stack [S, B, A] or a list);
        ``rhobar`` the shards' [n_local, A] densities.  Returns the
        filled fields like ``x`` (``sim.restack``).
        Under -P comd_tpu does not fuse F' into the fill
        (sharded.py:118-127), so ki_fused then runs the ki fill, K3's
        copies alone.  collective in one process runs the same copies (one
        ``halo_fill`` launch: the staged exchange's bits, pure copies);
        across processes the staged exchange.exchange_scalar over the
        process group."""
        ci = self.cfg.comm_impl
        if ci == "ki_fused" and not self.cfg.spline:
            return restack(x, ki_comm.exchange_scalar_ki_fused(
                self.halo, list(x), list(rhobar), self.f_eval))
        return self._fill_nl(x)

    def _fold(self, x):
        """The half-shell fold over the mesh, in place on the stack of
        dense fields ``x`` [S, .., B, A] (the caller's fresh sweep
        outputs): one ``fold_halo`` launch a stage under every --commImpl
        (ki_comm.fold_halo_ki).  Returns the local rows [S, .., n_local,
        A]."""
        return restack(x, ki_comm.fold_halo_ki(self.halo, list(x)))

    def _fill_nl(self, x):
        """The dfEmbed fill of K3's copies, the neighbor-list paths'
        under every --commImpl.  comd_tpu's list fill is its collective
        exchange_scalar (comd_tpu/parallel/sharded.py:350), staged
        slot-aligned cell-block copies; ``halo_fill`` makes the same
        copies in the same stage order, so the bits are the same: in one
        process one launch (ki_comm.exchange_scalar_ki), across processes
        one a stage through the receive planes under ki and ki_fused, and
        the staged exchange.exchange_scalar over the process group under
        collective."""
        if self.mesh.nprocs > 1 and self.cfg.comm_impl == "collective":
            return restack(x, exchange.exchange_scalar(self.halo, list(x)))
        return restack(x, ki_comm.exchange_scalar_ki(self.halo, list(x)))

    def _exchange_atoms(self, r, p, gid, n_atoms, out=None):
        """Atom exchange per --commImpl, in place on the lists' tensors,
        then the canonical in-cell sort of every shard (one launch on the
        card), in place or into ``out``'s (r, p, gid) lists.  Returns
        lists (r, p, gid, n_atoms) and the overflow flag."""
        xatoms = (exchange.exchange_atoms
                  if self.cfg.comm_impl == "collective"
                  else ki_comm.exchange_atoms_ki)
        r, p, gid, n_atoms, ovf = xatoms(self.halo, r, p, gid, n_atoms)
        binning.sort_shards(r, p, gid, out)
        if out is not None:
            r, p, gid = out
        return r, p, gid, n_atoms, ovf

    # ---------------- stepping ----------------

    def _redistribute(self, r, p, gid, n_atoms, pre: bool = False,
                      out=None):
        """Rebucket every shard (halo landers kept), exchange, sort (into
        ``out``'s (r, p, gid) lists when given).  With ``pre`` (the -S 0
        step under -a 1) it also returns the positions the interior sweeps
        read: the rebucketed ones, which equal the exchanged ones on every
        local cell unless some atom left its shard, and then the exchanged
        ones, selected on the device (comd_tpu's sharded.py:258-265:
        ``jnp.where(any_mig, r, r_pre)``; across processes the migration
        flag is or-ed by an allgather)."""
        reb = [binning.rebucket(self.geom, self.maps, *t, keep_halo=True)
               for t in zip(r, p, gid, n_atoms)]
        ovf = torch.stack([o[5] for o in reb]).any()
        # the exchange overwrites the rebucketed fields
        r_reb = torch.stack([o[0] for o in reb]) if pre else None
        r, p, gid, n_atoms, ovf2 = self._exchange_atoms(
            *[[o[k] for o in reb] for k in range(4)], out=out)
        res = (r, p, gid, n_atoms, ovf | ovf2)
        if not pre:
            return res
        migrated = (torch.stack([o[4] for o in reb]) > 0).any()
        if self.mesh.nprocs > 1:
            migrated = dist.allgather(migrated).any()
        return res + (torch.where(migrated, stack_of(r), r_reb),)

    def _head(self, cond) -> None:
        """The head of a lazy or list step over the mesh, in place, one
        launch over the stacks: every shard's half kick and drift, and the
        skin trigger of this process's shards (``cond.flag``, a 0-dim bool
        or-ed over them by the launch; ``cond.handles`` set from the
        or)."""
        last = ([lst.last_r for lst in self.nlists] if self.uses_nl
                else self.last_r)
        cond.flag = self._kick_drift(self.states, last, cond.handles)

    def exchange_positions(self, r: list) -> None:
        """The slot-aligned ghost-position refresh of every shard's
        positions ``r``, in place: in one process one ``position_fill``
        launch under every --commImpl (comd_tpu runs one exchange_positions
        under each); across processes one stage launch a stage through the
        receive planes under ki and ki_fused, and the staged
        exchange.exchange_positions (gloo) under collective."""
        if self.mesh.nprocs > 1 and self.cfg.comm_impl == "collective":
            exchange.exchange_positions(self.halo, r)
        else:
            ki_comm.exchange_positions_ki(self.halo, r)

    def _refresh(self) -> None:
        """The slot-aligned ghost-position refresh of a step that does not
        rebucket; under -a 1 (the cell split or the NL row split) the
        interior sweeps read the positions before it (comd_tpu's
        sharded.py:459-466), copied into their stack first (one copy)."""
        r = [s.r for s in self.states]
        if self._reads_r_pre:
            self._r_pre().copy_(stack_of(r))
        self.exchange_positions(r)

    def _rest(self, want_energy: bool) -> None:
        """The rest of a step over the mesh, in place: the force (over the
        lists on the NL paths; under -a 1 the interior sweeps on the
        buffers ``_refresh`` or ``_rebucket_step`` filled), the second half
        kick and the mesh reductions: on the cell paths each phase one
        launch over the shards' stacks."""
        st = self.states
        r = [s.r for s in st]
        if self.uses_nl:
            r_pre = list(self._r_pre()) if self._reads_r_pre else r
            res = self.forces_nl(self.nlists, r, [s.n_atoms for s in st],
                                 self._fill_nl, want_energy, r_pre)
        else:
            rs = stack_of(r)
            res = self.forces(rs, stack_of(s.n_atoms for s in st),
                              self._fill, self._fold, want_energy,
                              self._r_pre() if self._reads_r_pre else rs,
                              passes=True)
        parts = self._land(st, res, want_energy)
        if parts is not None and self.mesh.nprocs > 1:
            self._e_parts = parts

    def _rebucket_step(self, pre: bool = False) -> None:
        """Rebucket every shard, exchange atoms and sort into the step's
        buffers (``_redistribute``; the sort writes r, p and gid there, the
        counts are copied), then the new baseline or, on the list
        paths, every shard's rebuild into its list's buffers; one more on
        the device rebucket counter.  Under -a 1 the interior sweeps read
        the exchanged positions or, with ``pre`` (-S 0), the device's
        select between them and the rebucketed ones.  No host read in one
        process: it is a conditional body of the step's graph."""
        st = self.states
        r, p, gid, n_atoms, ovf, *sel = self._redistribute(
            [s.r for s in st], [s.p for s in st], [s.gid for s in st],
            [s.n_atoms for s in st], pre=pre,
            out=([s.r for s in st], [s.p for s in st], [s.gid for s in st]))
        # the counts into their stack, the baselines and -a 1's positions
        # from the positions' stack: one operation a field
        torch.stack(n_atoms, out=stack_of(s.n_atoms for s in st))
        rs = stack_of(r)
        if self._reads_r_pre:
            self._r_pre().copy_(sel[0] if sel else rs)
        overflow = st[0].overflow
        overflow.logical_or_(ovf)
        if self.uses_nl:
            overflow.logical_or_(self.build_lists(
                [s.r for s in st], [s.n_atoms for s in st],
                into=self.nlists)[1])
        elif self.uses_lazy:
            stack_of(self.last_r).copy_(rs)
        self._bufs["rebuckets"].add_(1)

    def build_neighbor_list(self) -> None:
        """Build every shard's list on the current states (init)."""
        st = self.states
        self.nlists, ovf = self.build_lists([s.r for s in st],
                                            [s.n_atoms for s in st])
        self.n_nl_build += 1
        overflow = st[0].overflow | ovf
        self.states = [dataclasses.replace(s, overflow=overflow)
                       for s in st]

    def _shards(self) -> list:
        return self.states

    def _bind(self) -> None:
        """Every shard's state, baseline and list in the step's buffers
        (``_bind_shards``)."""
        self._assign(*self._bind_shards(self.states, self.last_r,
                                        self.nlists))

    def _assign(self, states, last_r, nlists) -> None:
        self.states, self.last_r, self.nlists = states, last_r, nlists

    def compute_force(self) -> None:
        """Force-only evaluation of every shard (used at init; the shards'
        states views of one stack a field)."""
        st = self.states
        if self.uses_nl:
            res = self.forces_nl(self.nlists, [s.r for s in st],
                                 [s.n_atoms for s in st], self._fill_nl)
            self._e_parts = torch.stack([e for _f, _u, e in res])
            f = [self._full_force(f_loc, s.f)
                 for s, (f_loc, _u, _e) in zip(st, res)]
        else:
            f_loc, _u, self._e_parts = self.forces(
                stack_of(s.r for s in st), stack_of(s.n_atoms for s in st),
                self._fill, self._fold)
            f = self._full_force(f_loc, stack_of(s.f for s in st))
        e_pot = self._e_parts.sum()
        self.states = [dataclasses.replace(s, f=f[i], e_potential=e_pot)
                       for i, s in enumerate(st)]

    def initial_exchange(self) -> None:
        """The first ghost fill: the atom exchange on the freshly binned
        shards (comd_tpu's ``_initial_exchange_fn``); an undersized packed
        message capacity can already raise the overflow flag here."""
        st = self.states
        r, p, gid, n_atoms, ovf = self._exchange_atoms(
            [s.r for s in st], [s.p for s in st], [s.gid for s in st],
            [s.n_atoms for s in st])
        overflow = st[0].overflow | ovf
        self.states = [dataclasses.replace(
            s, r=r[i], p=p[i], gid=gid[i], n_atoms=n_atoms[i],
            overflow=overflow) for i, s in enumerate(st)]

    # ---------------- reductions over the mesh ----------------

    def kinetic_energy(self) -> float:
        nl = self.geom.n_local
        e_dtype = self.cfg.torch_energy_dtype
        total = self._gather(torch.stack([
            (s.p[:, :nl].to(e_dtype) ** 2).sum() for s in self.states])).sum()
        return float(0.5 * (1.0 / self.mass) * total)

    @property
    def e_potential(self) -> float:
        return float(self.mesh_scalars()["e_potential"])

    @property
    def overflow(self) -> bool:
        return self._any(self.states[0].overflow)

    def _counts(self) -> torch.Tensor:
        """Every shard's local atom count, in shard order."""
        nl = self.geom.n_local
        return self._gather(torch.stack([s.n_atoms[:nl].sum(dtype=torch.int32)
                                         for s in self.states]))

    def sum_atoms(self) -> int:
        return int(self._counts().sum())

    def mesh_scalars(self) -> dict:
        """The mesh's replicated scalars (e_potential, n_local, overflow) as
        0-dim tensors: in a single process the states' own; across
        processes the sums over every shard, in shard order."""
        s0 = self.states[0]
        if self.mesh.nprocs == 1:
            return dict(e_potential=s0.e_potential, n_local=s0.n_local,
                        overflow=s0.overflow)
        e = (s0.e_potential if self._e_parts is None
             else self._gather(self._e_parts).sum())
        return dict(e_potential=e,
                    n_local=self._counts().sum(dtype=torch.int32),
                    overflow=self._gather(s0.overflow.reshape(1)).any())

    def temperature(self) -> float:
        return self.kinetic_energy() / self.n_global / KB_EV / 1.5

    def max_occupancy(self) -> int:
        nl = self.geom.n_local
        return int(self._gather(torch.stack([s.n_atoms[:nl].max()
                                             for s in self.states])).max())

    def occupancy_histogram(self) -> np.ndarray:
        """[capacity+1] global cell-occupancy histogram (--analyze)."""
        nl = self.geom.n_local
        counts = torch.cat([s.n_atoms[:nl] for s in self.states])
        hist = np.bincount(counts.cpu().numpy(),
                           minlength=self.cfg.max_atoms + 1)
        return dist.allgather(hist).sum(axis=0)


def init_sharded_simulation(cfg: Config, timers=None) -> ShardedSimulation:
    """Sharded initSimulation: decompose, generate each owned shard's atoms,
    bin them in the shard's local frame, exchange ghosts, first force.

    Every process generates and bins only the shards it owns
    (initAtoms.c:81-124, comd_tpu's ``_owned_coords`` and
    ``_gen_shard_atoms``), so host memory stays O(local atoms); the cell
    plan's occupancy statistics are agreed by an allgather of (max, min)
    over the processes (comd_tpu's sharded.py:721-727).  The momenta come
    from the global (vcm, scale) of the gid-seeded streams, so the state
    equals the single-domain one atom for atom."""
    cfg = cfg.resolve()
    pot = init_potential(cfg)

    lat = cfg.lat if cfg.lat > 0 else pot.lat
    global_extent = np.array([cfg.nx, cfg.ny, cfg.nz], np.float64) * lat
    pgrid = np.array([cfg.xproc, cfg.yproc, cfg.zproc])
    local_extent = global_extent / pgrid
    n_global = 4 * cfg.nx * cfg.ny * cfg.nz
    mesh = make_mesh(cfg.xproc, cfg.yproc, cfg.zproc, cfg.device,
                     nprocs=dist.process_count(), proc=dist.process_index())
    my_coords = [mesh.coords[s] for s in mesh.owned]

    # positions first: the cell plan needs the t=0 occupancy
    shard_atoms = {c: gen_shard_atoms(cfg, lat, global_extent, local_extent,
                                      c) for c in my_coords}
    r_local = np.concatenate([a[0] for a in shard_atoms.values()])

    stat_reduce = None
    if mesh.nprocs > 1:
        def stat_reduce(stats):
            allv = dist.allgather(np.asarray(stats, np.float64))
            return int(allv[:, 0].max()), float(allv[:, 1].min())

    # per-shard geometry in the shard-local frame [0, local_extent)
    cfg, geom, cplan = plan_geometry(
        cfg, pot, lat, r_local, (cfg.nx, cfg.ny, cfg.nz),
        (cfg.xproc, cfg.yproc, cfg.zproc), np.zeros(3), local_extent,
        n_atoms_total=n_global, stat_reduce=stat_reduce)
    plan = exchange.make_plan(geom, msg_factor=cfg.halo_msg_factor,
                              max_atoms=cfg.max_atoms)

    # momenta: global (vcm, scale), applied to each shard's atoms (bitwise
    # equal to the single-domain setTemperature)
    vcm, scale = lattice.temperature_params(pot.mass, cfg.temperature,
                                            n_global)
    dev = torch.device(cfg.device)
    e_pot = torch.zeros((), dtype=cfg.torch_energy_dtype, device=dev)
    n_local = torch.tensor(n_global, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    binned = []
    for c in my_coords:
        r_s, gid_s = shard_atoms[c]
        p_s = lattice.apply_temperature(gid_s, pot.mass, cfg.temperature,
                                        vcm, scale)
        binned.append(bin_atoms_host_np(
            geom, cfg, r_s - np.asarray(c) * local_extent, p_s, gid_s))
    # the owned shards' fields as one stack each, the states its views
    stacks = {k: torch.as_tensor(np.stack([d[k] for d in binned]),
                                 device=dev) for k in binned[0]}
    states = [SimState(**{k: v[i] for k, v in stacks.items()},
                       e_potential=e_pot, n_local=n_local,
                       overflow=overflow) for i in range(len(binned))]

    sim = ShardedSimulation(
        cfg=cfg, pot=pot, geom=geom, plan=plan, mesh=mesh,
        global_extent=global_extent, n_global=n_global, states=states,
        lattice_const=lat, skin_eff=cplan.skin)
    with _tscope(timers, "redistribute"), _tscope(timers, "atomHalo"):
        sim.initial_exchange()
        _sync(sim.device)
    if sim.uses_nl:
        with _tscope(timers, "neighborList"):
            sim.build_neighbor_list()
            _sync(sim.device)
    with _tscope(timers, "force"):
        sim.compute_force()
        _sync(sim.device)
    return sim
