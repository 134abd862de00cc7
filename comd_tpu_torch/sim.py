"""Simulation assembly and the velocity-Verlet step (EAM and LJ).

Port of comd_tpu.sim's serial half on PyTorch (with -i/-j/-k > 1,
``init_simulation`` hands over to parallel/sharded.py):
  - SimFlat / SimGpu state          -> one SimState dataclass of tensors
  - initSimulation                  -> init_simulation (CoMD.c:200-327)
  - timestep velocity-Verlet loop   -> Simulation.step_block: on the card
    CUDA graphs of the step replayed (stepgraph.py, comd_tpu's jitted
    scan), else the same step as an eager loop (timestep.c:48-100)
  - redistributeAtoms + sortAtomsGpu -> ops.binning.rebucket
  - atom halo exchange              -> serial periodic halo fill
  - kineticEnergy / sumAtoms        -> reductions (timestep.c:109-133)

The main path is the lazy-shell cell step: atoms are rebucketed only when
one of them moved skin/2 since the last rebucket (the skin trigger);
other steps refresh the ghost positions.  The neighbor-list methods (-m
*_nl, -L) step the same way on Verlet lists, rebuilt (NL1) after each such
rebucket and swept by NL2.  A step is a head (kick, drift, trigger, and
serially the ghost refresh in the same launch), the rebucket where the
trigger says (comd_tpu's lax.cond; on the card a conditional node of the
step's graph; a mesh's ghost refresh is the other branch), and the rest
(force, kick), all in place on buffers the step owns; ``-S 0`` rebuckets
every step.  The ops around the force (kick, drift, trigger, ghost
refresh, pass 2, the landing; on the list paths pass 2 and the landing
from the list's rows) are the hand-written kernels of ops/cuda/step.py.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import cells, lattice, stepgraph
from .config import Config
from .constants import KB_EV
from .ops import binning, force_eam, force_lj
from .ops import neighborlist as nlmod
from .ops.cuda import nl as nl_kernels
from .ops.cuda import step as step_ops
from .ops.sweep import fold_halo_serial
from .potentials.eam import EamPotential, init_eam_pot
from .potentials.lj import LjPotential, init_lj_pot


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


#: the per-shard and the shared (mesh-wide) fields of a SimState, and the
#: list's, as the step's buffers hold them: a per-shard field one [S, ...]
#: stack (comd_tpu's leading shard index), each shard's SimState a view
_SHARD_FIELDS = ("r", "p", "f", "gid", "n_atoms")
_SCALAR_FIELDS = ("e_potential", "n_local", "overflow")
_LIST_FIELDS = ("a_list", "a_valid", "nl", "last_r", "row_start")


def stack_of(ts) -> torch.Tensor:
    """The one tensor [S, ...] of which the per-shard tensors ``ts`` are
    the shards: views of one storage, alike, at one stride apart in order
    (the step's buffers' views; one tensor is a stack of one).  Raises
    ValueError for tensors that are not one stack: the cell paths' kernels
    take a mesh's shards as one tensor, never one by one."""
    ts = list(ts)
    t0 = ts[0]
    if len(ts) == 1:
        return t0[None]
    es = t0.element_size()
    step, rem = divmod(ts[1].data_ptr() - t0.data_ptr(), es)
    span = 1 + sum((n - 1) * st for n, st in zip(t0.shape, t0.stride()))
    base = t0.untyped_storage().data_ptr()
    ok = rem == 0 and step >= span and all(
        t.shape == t0.shape and t.stride() == t0.stride() and
        t.dtype == t0.dtype and t.device == t0.device and
        t.untyped_storage().data_ptr() == base and
        t.data_ptr() - t0.data_ptr() == i * step * es
        for i, t in enumerate(ts))
    if not ok:
        raise ValueError(f"the {len(ts)} shards' {tuple(t0.shape)} tensors "
                         f"are not one stack")
    return t0.as_strided((len(ts),) + tuple(t0.shape),
                         (step,) + tuple(t0.stride()), t0.storage_offset())


def restack(x, ts):
    """The result of an exchange on the shards of ``x`` (a stack, or a
    list of per-shard tensors) that returns per-shard tensors ``ts``: a
    list for a list; for a stack, the one stack ``ts`` are views of (an
    exchange in place), else their values stacked anew."""
    if not isinstance(x, torch.Tensor):
        return ts
    try:
        return stack_of(ts)
    except ValueError:
        return torch.stack(list(ts))


def clone_stacked(states) -> list:
    """Clones of the shards' SimStates, views of new [S, ...] stacks a
    per-shard field as the step's buffers hold them; the shared scalars
    cloned once."""
    t = {f: torch.stack([getattr(s, f) for s in states])
         for f in _SHARD_FIELDS}
    sc = {f: getattr(states[0], f).clone() for f in _SCALAR_FIELDS}
    return [SimState(**{f: t[f][i] for f in _SHARD_FIELDS}, **sc)
            for i in range(len(states))]


class Physics:
    """What a single-domain and a sharded simulation share: the device,
    dtype and cell maps, the pair and embedding evaluators, the stepping
    constants, and the force over a list of shards (a single domain is a
    mesh of one).  Subclasses are dataclasses with ``cfg``, ``pot``,
    ``geom`` and ``skin_eff`` and call ``_setup_physics`` first."""

    def _setup_physics(self) -> None:
        cfg = self.cfg
        self.device = torch.device(cfg.device)
        self.dtype = cfg.torch_dtype
        self.maps = binning.geom_maps(self.geom, self.dtype, self.device)
        self.is_eam = isinstance(self.pot, EamPotential)
        if self.is_eam:
            # comd_tpu's -m cta_cell runs its Pallas stencil, whose pair
            # functions are the Chebyshev fit whatever -P or --interpImpl
            # say (comd_tpu/sim.py:121, parallel/sharded.py:133-134), in
            # f32 only; the port runs f64 cta_cell with the resolved one
            pallas = (cfg.method == "cta_cell" and not cfg.lj_interpolation
                      and not self.uses_split
                      and self.dtype == torch.float32)
            self.pair_eval = force_eam.make_pair_evaluator(
                self.pot, self.dtype, self.device,
                "cheb" if pallas else cfg.resolved_interp_impl,
                spline=cfg.spline and not pallas)
            self.f_eval = force_eam.make_f_eval(self.pot, self.dtype,
                                                self.device)
        elif cfg.lj_interpolation and not (self.uses_nl or self.uses_split):
            # -I on the cell paths; comd_tpu's list paths and its -a 1
            # split ignore it
            self.pair_eval = force_lj.make_lj_table_evaluator(
                self.pot, self.dtype, self.device)
        else:
            self.pair_eval = force_lj.make_lj_evaluator(self.pot, self.dtype)
        self.n_rebucket = 0          # lazy/eager rebuckets so far
        self.n_nl_build = 0          # neighbor-list builds so far
        # the device rebucket counter's value when the host last read it
        self._rebuckets_read = 0
        self.nl_row_split = None     # row_split_for under -a 1 on a mesh
        # on the card the steps replay CUDA graphs (stepgraph.py); False
        # runs the same step as an eager loop
        self.cuda_graphs = True
        self._bufs = {}              # the step's buffers (stepgraph.keep)
        self._graphs = None          # stepgraph.GraphSteps, at first use

    @property
    def mass(self) -> float:
        return self.pot.mass

    @property
    def n_processes(self) -> int:
        """The processes stepping this simulation's shards together."""
        return 1

    @property
    def uses_nl(self) -> bool:
        """*_nl methods and the LJ pairlist (-L) run on Verlet lists."""
        return self.cfg.use_nl or self.cfg.use_pairlist

    @property
    def uses_split(self) -> bool:
        """-a 1 of a cell method on a mesh: K1 sweeps the interior and the
        boundary cells apart, in place of --halfShell and cta_cell's sweep
        (comd_tpu/parallel/sharded.py:132-137)."""
        return (self.cfg.nprocs > 1 and bool(self.cfg.resolved_gpu_async)
                and not self.uses_nl)

    @property
    def uses_lazy(self) -> bool:
        """Cell methods with a skin shell: rebucket on the skin/2 trigger."""
        return (not self.uses_nl and self.cfg.lazy_shell
                and self.cfg.relative_skin_distance > 0)

    @property
    def skin(self) -> float:
        if not (self.uses_nl or self.uses_lazy):
            return 0.0
        if self.skin_eff is not None:
            return self.skin_eff
        return self.pot.cutoff * self.cfg.relative_skin_distance

    def _c(self, x: float) -> float:
        """A step constant rounded to the dynamics dtype."""
        return float(np.asarray(x, dtype=np.dtype(self.cfg.dtype)))

    def _kick_drift(self, states, lasts=None, handles=(), images=None):
        """Half kick and drift of every shard, in place, and with the lazy
        baselines ``lasts`` ([3, B, A] a shard, views of one stack) the
        skin trigger or-ed over the shards, a 0-dim bool: one
        ops/cuda/step.kick_drift_trigger launch over the shards' stacks,
        which sets ``handles``, the step graph's IF nodes', from the or;
        with ``images`` (a single domain's ``maps.images``) the ghost
        refresh in the same launch.  Returns the flag, or None without
        ``lasts``."""
        kick = self._c(0.5 * self.cfg.dt)
        drift = self._c(self.cfg.dt * (1.0 / self.mass))
        p, r, f = (stack_of(getattr(s, k) for s in states)
                   for k in ("p", "r", "f"))
        return step_ops.kick_drift_trigger(
            p, r, f, None if lasts is None else stack_of(lasts),
            self.geom.n_local, kick, drift, self.skin, handles=handles,
            images=images)

    def _full_force(self, f_loc, like):
        """The force field of a force ``f_loc`` (``like``'s shape: a
        shard's [3, B, A] or a stack [S, 3, B, A]): a list force per row
        (``neighborlist.RowForce``, one shard's) landed by one
        ``land_rows`` launch without the kick, else [.., 3, n_local, A] in
        the local cells; halo rows zero."""
        if isinstance(f_loc, nlmod.RowForce):
            f = torch.empty_like(like)
            step_ops.land_rows(f, None, f_loc.nlist, f_loc.n_atoms,
                               f_loc.parts, None, self.geom.n_local)
            return f
        f = torch.zeros_like(like)
        f[..., :self.geom.n_local, :] = f_loc.to(like.dtype)
        return f

    def _land(self, states, res, want_energy: bool):
        """The end of a step, in place: the shards' force, the second half
        kick and the local atom count, and, with the energy terms, ePot.
        ``res`` as ``forces(passes=True)`` returns it (the stacks' force
        or EAM's two passes, U, each shard's ePot): one ``land`` launch
        over the shards' stacks; or as ``forces_nl`` returns it (a list
        force per row a shard): one ``land_rows`` launch a shard
        (ops/cuda/step.py).  Returns the shards' ePot stacked, or None."""
        kick = self._c(0.5 * self.cfg.dt)
        s0 = states[0]
        if isinstance(res, list):
            for i, (s, (f_loc, _u, _e)) in enumerate(zip(states, res)):
                step_ops.land_rows(s.f, s.p, f_loc.nlist, f_loc.n_atoms,
                                   f_loc.parts, s0.n_local,
                                   self.geom.n_local, kick, add=i > 0)
            parts = (torch.stack([e for _f, _u, e in res]) if want_energy
                     else None)
        else:
            f_loc, _u, parts = res
            f1, f3 = f_loc if isinstance(f_loc, tuple) else (f_loc, None)
            f, p, n = (stack_of(getattr(s, k) for s in states)
                       for k in ("f", "p", "n_atoms"))
            step_ops.land(f, p, f1, f3, n, s0.n_local, self.geom.n_local,
                          kick)
        if not want_energy:
            return None
        s0.e_potential.copy_(parts.sum())
        return parts

    # ---------------- the step's buffers and loop ----------------

    def _wants(self, n_steps: int) -> list:
        """Which steps of a block compute the energy terms: the last one
        -- the block boundary IS the reporting boundary (CoMD.c:146-162)
        -- or every one under ``cfg.energy_every_step``."""
        return [k == n_steps - 1 or self.cfg.energy_every_step
                for k in range(n_steps)]

    @property
    def _reads_r_pre(self) -> bool:
        """-a 1 on a mesh (the cell split or the NL row split): the interior
        sweeps read positions of their own, kept in a buffer a shard."""
        return self.uses_split or self.nl_row_split is not None

    def _bind_shards(self, states, last_r, nlists):
        """Every shard's state, lazy baseline (``last_r``; None before the
        first step: the positions) and list in the step's buffers, one
        [S, ...] stack a field (stepgraph.keep: copied in where another
        tensor took a shard's place; new buffers drop the graphs), beside
        the device rebucket counter and, under -a 1 on a mesh, the stack of
        the interior sweeps' positions.  Returns (states, last_r, nlists)
        over the buffers, each shard's fields views of the stacks; the
        shards share one ePot, n_local and overflow."""
        t = {f: [getattr(s, f) for s in states] for f in _SHARD_FIELDS}
        if self.uses_lazy:
            t["last_r"] = [s.r for s in states] if last_r is None \
                else list(last_r)
        if self.uses_nl:
            for f in _LIST_FIELDS:
                t["nl_" + f] = [getattr(lst, f) for lst in nlists]
        if self._reads_r_pre:
            b = self._bufs.get("r_pre")
            r0 = states[0].r
            same = b is not None and (b.shape, b.dtype, b.device) == (
                (len(states),) + tuple(r0.shape), r0.dtype, r0.device)
            t["r_pre"] = b if same else [s.r for s in states]
        for f in _SCALAR_FIELDS:
            t[f] = getattr(states[0], f)
        t["rebuckets"] = self._bufs.get("rebuckets")
        if t["rebuckets"] is None:
            t["rebuckets"] = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        if stepgraph.keep(self._bufs, t):
            self._graphs = None
        self._n_bound = len(states)
        return self._views()

    def _views(self):
        """(states, last_r, nlists) over the step's buffers: shard i's
        fields the stacks' views [i]."""
        b = self._bufs
        n = range(self._n_bound)
        states = [SimState(**{f: b[f][i] for f in _SHARD_FIELDS},
                           **{f: b[f] for f in _SCALAR_FIELDS}) for i in n]
        last_r = [b["last_r"][i] for i in n] if self.uses_lazy else None
        nlists = ([nlmod.NeighborList(**{f: b["nl_" + f][i]
                                         for f in _LIST_FIELDS})
                   for i in n] if self.uses_nl else None)
        return states, last_r, nlists

    def _r_pre(self) -> torch.Tensor:
        """The stack [S, 3, B, A] of the positions -a 1's interior sweeps
        read."""
        return self._bufs["r_pre"]

    @contextlib.contextmanager
    def _scratch(self):
        """The step on throwaway clones of its buffers (a capture's warm-up
        of both branches: the real state does not move): each stack cloned
        whole and the shards' views taken anew on the clones, so the
        warm-up runs on stacks as the step does."""
        saved = self._bufs
        self._bufs = {k: v.clone() for k, v in saved.items()}
        self._assign(*self._views())
        try:
            yield
        finally:
            self._bufs = saved
            self._assign(*self._views())

    def _steps(self):
        """What runs a block's steps: the simulation's ``GraphSteps`` (made
        on the card at first use) unless ``cuda_graphs`` is False or the
        mesh spans processes, else the eager loop."""
        if not self.cuda_graphs or self.n_processes > 1:
            return stepgraph.EagerSteps(self._any)
        if self._graphs is None:
            if self.device.type != "cuda":
                return stepgraph.EagerSteps(self._any)
            self._graphs = stepgraph.GraphSteps(self.device,
                                                scratch=self._scratch)
        return self._graphs

    def _lazy_step(self, want_energy: bool, branch) -> None:
        """A lazy or list step (comd_tpu's ``_make_step_lazy`` and
        ``_make_step_nl``; on a mesh ``_shard_step_lazy`` and
        ``_shard_step_nl``): the head, then the redistribution when some
        atom moved skin/2 since the last rebucket or build, else the ghost
        refresh where it is not the head's (``_refresh``; ``branch``:
        comd_tpu's lax.cond, on the condition the head's trigger writes
        and, in a captured graph, sets), then the rest."""
        cond = branch.condition(1 if self._refresh is None else 2)
        self._head(cond)
        branch(cond, self._rebucket_step, self._refresh)
        self._rest(want_energy)

    def _full_step(self, want_energy: bool, _branch=None) -> None:
        """A ``-S 0`` step (comd_tpu's ``_make_step`` and ``_shard_step``):
        drift, the redistribution (under -a 1 on a mesh with the interior
        sweeps' positions selected on the device) and the rest."""
        self._kick_drift(self._shards())
        self._rebucket_step(pre=self.uses_split)
        self._rest(want_energy)

    def step_block(self, n_steps: int) -> None:
        """Run n_steps of velocity-Verlet, the energy terms on the block's
        last step only unless ``cfg.energy_every_step`` (``_wants``).

        Lazy and list steps rebucket where the trigger is set
        (``_lazy_step``), ``-S 0`` (``lazy_shell=False``) every step
        (``_full_step``); on the card in one process each step is one
        CUDA graph replayed with no host read between (stepgraph.py),
        else the eager loop, which reads the trigger on the host (``_any``:
        or-ed over the processes).  The state, the lazy baseline and the
        list are updated in place.  The host reads the device rebucket
        counter once, at the block's end (lazy and list steps)."""
        wants = self._wants(n_steps)
        self._bind()
        if not wants:
            return
        steps = self._steps()
        lazy = self.uses_nl or self.uses_lazy
        step = self._lazy_step if lazy else self._full_step
        for want in wants:
            # one graph a want_energy; step(want, branch) is one step
            steps.run(("step", want), lambda branch, w=want: step(w, branch))
        if lazy:
            count = int(self._bufs["rebuckets"])
            n = count - self._rebuckets_read
        else:
            n = len(wants)
            count = self._rebuckets_read + n
        self._rebuckets_read = count
        steps.settle(n)
        self.n_rebucket += n
        if self.uses_nl:
            self.n_nl_build += n

    @property
    def _halo_src(self):
        """The periodic sources of a single domain's halo cells, from which
        pass 2 fills dfEmbed's halo rows itself (``force_eam.eam_force``);
        None on a mesh, whose transports fill them."""
        return None

    def forces(self, rs, n_atoms, fill, fold, want_energy: bool = True,
               r_pre=None, passes: bool = False):
        """The force of every shard (comd_tpu's ``_force_fn``): EAM or LJ,
        on the full-shell K1 or, with ``--halfShell`` (whatever the cell
        method), the half-shell K2; -I (table LJ) always on K1, as
        comd_tpu ignores ``--halfShell`` under -I.  Under -a 1 on a mesh
        (``uses_split``) K1 sweeps the interior cells on ``r_pre`` (the
        pre-exchange positions) and the boundary cells on ``rs``, whatever
        --halfShell or -I say (analytic LJ).  ``rs`` [S, 3, B, A],
        ``n_atoms`` [S, B] and ``r_pre`` are the shards' stacks (a list of
        shards raises), each pass one launch over them; ``fill`` (dfEmbed
        halo fill) and ``fold`` (half-shell halo fold) run over all shards
        of a stack.  Returns (f_loc [S, 3, n_local, A], U [S, n_local, A] |
        None, ePot a shard [S] | None: each shard's sum of its U), with
        ``passes`` EAM's f_loc as its two passes (f1, f3) on K1;
        ``want_energy=False`` skips the energy terms."""
        maps, cfg = self.maps, self.cfg
        kw = dict(e_dtype=cfg.torch_energy_dtype, want_energy=want_energy,
                  box_chunk=cfg.resolved_box_chunk)
        half = cfg.half_shell
        split = self.uses_split
        if split:
            kw.update(r_pre=r_pre)
        if not self.is_eam:
            if split:
                return force_lj.lj_force_split(
                    maps.nbr_map, self.pot, rs, self.pair_eval,
                    maps.interior, maps.boundary, **kw)
            if cfg.lj_interpolation:
                return force_lj.lj_force_interp(maps.nbr_map, rs,
                                                self.pair_eval, **kw)
            if half:
                return force_lj.lj_force_half(maps.half_nbr_map, self.pot,
                                              rs, self.pair_eval, fold, **kw)
            return force_lj.lj_force(maps.nbr_map, self.pot, rs,
                                     self.pair_eval, **kw)
        # EAM: pass 2 gives every slot F(rhobar = 0) != 0; n_atoms masks
        # the empty slots' U
        kw.update(n_atoms=n_atoms)
        if split:
            out = force_eam.eam_force_split(
                maps.nbr_map, rs, self.pair_eval, self.f_eval, fill,
                maps.interior, maps.boundary, passes=passes, **kw)
        elif half:
            out = force_eam.eam_force_half(
                maps.half_nbr_map, rs, self.pair_eval, self.f_eval, fill,
                fold, halo_src=self._halo_src, **kw)
        else:
            out = force_eam.eam_force(maps.nbr_map, rs, self.pair_eval,
                                      self.f_eval, fill,
                                      halo_src=self._halo_src,
                                      passes=passes, **kw)
        f_loc, u, _dfe = out
        return f_loc, u, None if u is None else force_lj.shard_sums(u)

    # ---------------- neighbor lists ----------------

    def nl_build_params(self) -> dict:
        """The list build's parameters (comd_tpu's ``_nl_build_params``):
        K (``nl_max_neighbors``, or 1.4x the mean neighbor count inside
        rcut + skin rounded up to a multiple of 32), (rcut + skin)^2, the
        row capacity and, under -a 1 on a mesh, the row split."""
        cfg = self.cfg
        rcut_nl = self.pot.cutoff + self.skin
        if cfg.nl_max_neighbors > 0:
            k = cfg.nl_max_neighbors
        else:
            density = self.n_global / float(np.prod(self.global_extent))
            mean_nbrs = density * 4.0 / 3.0 * np.pi * rcut_nl ** 3
            k = int(-(-1.4 * mean_nbrs // 32) * 32)
        return dict(k=k, rcut2=rcut_nl ** 2,
                    n_rows=nlmod.n_rows_for(self.geom, cfg.max_atoms,
                                            cfg.nl_rows_factor),
                    row_split=self.nl_row_split)

    def build_lists(self, rs, n_atoms, into=None):
        """Build every shard's list (NL1): (lists, overflow); with ``into``
        (a list a shard) into those lists' tensors, in place."""
        params = self.nl_build_params()
        built = [nl_kernels.build_list(self.geom, self.maps.nbr_map, r, n,
                                       into=lst, **params)
                 for r, n, lst in zip(rs, n_atoms, into or [None] * len(rs))]
        return ([b[0] for b in built],
                torch.stack([b[1] for b in built]).any())

    def forces_nl(self, nlists, rs, n_atoms, fill, want_energy: bool = True,
                  r_pre=None):
        """The force of every shard over its Verlet list (comd_tpu's
        ``_force_fn_nl``): EAM or LJ on NL2, with the row split under -a 1
        on a mesh (``r_pre``: the pre-exchange positions its interior rows
        read); pass 2 and, for the landing, the force stay on the rows.
        ``n_atoms``: the counts by cell the lists were built from; ``fill``
        is the dfEmbed halo fill over all shards (a single domain's pass 2
        fills its halo rows itself, ``_halo_src``).  Returns per shard
        (RowForce, None, ePot | None)."""
        kw = dict(n_atoms=n_atoms, e_dtype=self.cfg.torch_energy_dtype,
                  want_energy=want_energy)
        split = self.nl_row_split
        if self.is_eam:
            if split is not None:
                out = force_eam.eam_force_nl_split(
                    nlists, rs, self.pair_eval, self.f_eval, fill, split[1],
                    r_pre=r_pre, **kw)
            else:
                out = force_eam.eam_force_nl(nlists, rs, self.pair_eval,
                                             self.f_eval, fill,
                                             halo_src=self._halo_src, **kw)
            return [(f, None, e) for f, e, _dfe in out]
        if split is not None:
            out = force_lj.lj_force_nl_split(
                nlists, self.pot, rs, self.pair_eval, split[1], r_pre=r_pre,
                **kw)
        else:
            out = force_lj.lj_force_nl(nlists, self.pot, rs, self.pair_eval,
                                       **kw)
        return [(f, None, e) for f, _u, e in out]


@dataclasses.dataclass
class Simulation(Physics):
    """Host-side handle: static params + device state + step functions."""
    cfg: Config
    pot: EamPotential | LjPotential
    geom: cells.CellGeometry
    global_extent: np.ndarray        # [3]
    n_global: int
    state: SimState
    lattice_const: float
    skin_eff: Optional[float] = None   # resolved trigger skin (plan_cells)

    def __post_init__(self):
        self._setup_physics()
        self.last_r = None
        self.nlist = None
        # the periodic box on the device: the rebucket's wrap reads it
        # without a copy from the host
        self._extent = torch.as_tensor(self.global_extent, dtype=self.dtype,
                                       device=self.device)

    # ---------------- force + energy ----------------

    def _fill(self, xs, _rhobar=None):
        """The serial periodic dfEmbed halo fill of each [B, A] field of
        ``xs`` (a stack or a list), for callers without the maps' sources
        (the step's pass 2, on the cells or the list's rows, fills the halo
        rows itself, ``_halo_src``); like ``xs`` (``restack``)."""
        return restack(xs, [binning.fill_halo_scalar_serial(
            self.geom, self.maps, x) for x in xs])

    def _fold(self, x):
        """The serial half-shell fold of the stack ``x`` [S, .., B, A],
        in place (one ``fold_halo`` launch a shard: serially one); returns
        its local rows [S, .., n_local, A]."""
        return restack(x, [fold_halo_serial(self.geom, self.maps, v)
                           for v in x])

    @property
    def _halo_src(self):
        return self.maps.halo_src

    def force(self, r, n_atoms, want_energy: bool = True, nlist=None,
              passes: bool = False):
        """The force of the single domain: (f_loc [3, n_local, A],
        U [n_local, A] | None, ePot | None), with the serial periodic halo
        fill and fold; over ``nlist`` when given (U is then None; with
        ``passes`` f_loc is the force per row, ``neighborlist.RowForce``,
        for the landing); ``passes`` as in ``forces``."""
        if nlist is not None:
            res = self.forces_nl([nlist], [r], [n_atoms], self._fill,
                                 want_energy)[0]
            if passes:
                return res
            return ((self._full_force(res[0], r)[:, :self.geom.n_local],)
                    + res[1:])
        f_loc, u, parts = self.forces(r[None], n_atoms[None], self._fill,
                                      self._fold, want_energy,
                                      passes=passes)
        f_loc = (tuple(x[0] for x in f_loc) if isinstance(f_loc, tuple)
                 else f_loc[0])
        return (f_loc,) + tuple(None if x is None else x[0]
                                for x in (u, parts))

    def _head(self, cond) -> None:
        """The head of a lazy or list step, in place: half kick, drift, the
        ghost refresh (the halo rows' positions from their drifted
        sources: the cell layout and the list are those of the last
        rebucket, which overwrites the halo when it runs) and the skin
        trigger (``cond.flag``, a 0-dim bool: some atom moved skin/2 since
        the last rebucket or build; ``cond.handles`` set from it), one
        launch."""
        last = self.nlist.last_r if self.uses_nl else self.last_r
        cond.flag = self._kick_drift([self.state], [last], cond.handles,
                                     images=self.maps.images)

    #: no false body: the head refreshes the ghosts
    _refresh = None

    def _rest(self, want_energy: bool) -> None:
        """The rest of a step, in place: the force (over the list on the NL
        paths), the second half kick and bookkeeping."""
        s = self.state
        if self.uses_nl:
            res = [self.force(s.r, s.n_atoms, want_energy, self.nlist,
                              passes=True)]
        else:
            res = self.forces(s.r[None], s.n_atoms[None], self._fill,
                              self._fold, want_energy, passes=True)
        self._land([s], res, want_energy)

    def _rebucket_step(self, pre: bool = False) -> None:
        """The dense redistribution in place in the step's buffers (on the
        card csrc/rebucket.cu's bin and place launches, which also write
        the new baseline's local rows and or the overflow flag), the halo
        rebuild (``refresh_halo``), on the list paths the rebuild (NL1)
        into the list's buffers (comd_tpu's ``_make_step_lazy`` and
        ``_make_step_nl`` branches); one more on the device rebucket
        counter.  No host read (and no allocation but the list
        rebuild's): it is a conditional body of the step's graph.  ``pre``
        (the mesh's -a 1) has no serial use."""
        s = self.state
        binning.rebucket_into(
            self.geom, self.maps, s.r, s.p, s.gid, s.n_atoms, s.overflow,
            wrap_extent=self._extent,
            last_r=self.last_r if self.uses_lazy and not self.uses_nl
            else None)
        binning.fill_halo_serial(self.geom, self.maps, s.r, s.gid, s.n_atoms)
        if self.uses_nl:
            s.overflow.logical_or_(self.build_lists([s.r], [s.n_atoms],
                                                    into=[self.nlist])[1])
        self._bufs["rebuckets"].add_(1)

    def build_neighbor_list(self) -> None:
        """Build the list on the current state (init); an undersized K
        raises the overflow flag already here."""
        s = self.state
        (self.nlist,), ovf = self.build_lists([s.r], [s.n_atoms])
        self.n_nl_build += 1
        self.state = dataclasses.replace(s, overflow=s.overflow | ovf)

    def _shards(self) -> list:
        return [self.state]

    def _any(self, flag: torch.Tensor) -> bool:
        """The trigger, read on the host."""
        return bool(flag)

    def _bind(self) -> None:
        """The state, baseline and list in the step's buffers
        (``_bind_shards``)."""
        self._assign(*self._bind_shards(
            [self.state], None if self.last_r is None else [self.last_r],
            None if self.nlist is None else [self.nlist]))

    def _assign(self, states, last_r, nlists) -> None:
        (self.state,) = states
        self.last_r = last_r[0] if last_r else None
        self.nlist = nlists[0] if nlists else None

    def compute_force(self) -> None:
        """Force-only evaluation (used at init; CoMD.c:314); on the list
        paths the rows landed by ``land_rows`` without the kick."""
        s = self.state
        f_loc, _u, e_pot = self.force(s.r, s.n_atoms, nlist=self.nlist,
                                      passes=self.nlist is not None)
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

    @property
    def overflow(self) -> bool:
        """Any capacity overflow so far."""
        return bool(self.state.overflow)

    def sum_atoms(self) -> int:
        return int(self.state.n_atoms[:self.geom.n_local].sum())

    def temperature(self) -> float:
        return self.kinetic_energy() / self.n_global / KB_EV / 1.5

    def max_occupancy(self) -> int:
        return int(self.state.n_atoms[:self.geom.n_local].max())

    def occupancy_histogram(self) -> np.ndarray:
        """[capacity+1] local cell-occupancy histogram (--analyze)."""
        counts = self.state.n_atoms[:self.geom.n_local].cpu().numpy()
        return np.bincount(counts, minlength=self.cfg.max_atoms + 1)


def _tscope(timers, name: str):
    """Timer scope when ``timers`` is given, else a no-op."""
    return timers.scope(name) if timers is not None else \
        contextlib.nullcontext()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_potential(cfg: Config):
    if cfg.doeam:
        return init_eam_pot(cfg.pot_dir, cfg.pot_name, cfg.pot_type)
    return init_lj_pot(cfg.lj_cutoff_factor)


def init_simulation(cfg: Config, timers=None):
    """Build the initial state (initSimulation, CoMD.c:200-327) on
    ``cfg.device``: a Simulation, or with -i/-j/-k > 1 a ShardedSimulation
    over a mesh of shards (parallel/sharded.py), EAM or LJ."""
    cfg = cfg.resolve()
    if cfg.nprocs > 1:
        from .parallel.sharded import init_sharded_simulation
        return init_sharded_simulation(cfg, timers=timers)
    pot = init_potential(cfg)

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

    # fill halo + (NL build) + first force (CoMD.c:303-318)
    with _tscope(timers, "redistribute"), _tscope(timers, "atomHalo"):
        s = sim.state
        binning.fill_halo_serial(geom, sim.maps, s.r, s.gid, s.n_atoms)
        _sync(sim.device)
    if sim.uses_nl:
        with _tscope(timers, "neighborList"):
            sim.build_neighbor_list()
            _sync(sim.device)
    with _tscope(timers, "force"):
        sim.compute_force()
        _sync(sim.device)
    return sim


def plan_geometry(cfg: Config, pot, lat: float, r_global: np.ndarray,
                  n_cells, proc_grid, local_min, local_max,
                  n_atoms_total=None, stat_reduce=None):
    """Resolve cell sizing + capacity (cells.plan_cells) and build the local
    CellGeometry.  Returns (cfg', geom, plan) with cfg' carrying the
    *resolved* max_atoms and cell_mode.  ``r_global`` may be this process's
    atoms only: ``n_atoms_total`` then counts every atom and
    ``stat_reduce`` combines the occupancy statistics across processes
    (cells.plan_cells).

    NL / pairlist methods keep the classic sizing and the requested -S skin
    (a larger trigger skin would inflate the Verlet K); cell-sweep methods
    use the full cell slack min(cell) - cutoff as the rebucket trigger."""
    uses_nl = cfg.use_nl or cfg.use_pairlist
    lazy = (not uses_nl and cfg.lazy_shell
            and cfg.relative_skin_distance > 0)
    use_skin = uses_nl or lazy
    skin_req = pot.cutoff * cfg.relative_skin_distance if use_skin else 0.0

    # auto-capacity margin near/above melting or under large -r jitter
    # (comd_tpu.sim.plan_geometry)
    margin = 8 if (cfg.temperature > 1200.0
                   or cfg.initial_delta > 0.3) else 0
    plan = cells.plan_cells(
        cutoff=pot.cutoff, lat=lat, n_cells=n_cells, proc_grid=proc_grid,
        r_global=r_global, skin_req=skin_req, lazy=lazy,
        mode="classic" if uses_nl else cfg.cell_mode,
        max_atoms=cfg.max_atoms, trigger_from_cell=not uses_nl,
        n_atoms_total=n_atoms_total, stat_reduce=stat_reduce,
        margin_slots=margin)
    cfg = dataclasses.replace(cfg, max_atoms=plan.max_atoms,
                              cell_mode=plan.mode)
    geom = cells.make_geometry(
        np.asarray(local_min, np.float64), np.asarray(local_max, np.float64),
        pot.cutoff + (plan.skin if use_skin else 0.0),
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

    # bin the coordinates as the state stores them: an atom on a cell face
    # can fall on the other side once rounded to f32, and the device bins
    # a ghost copy of it from the rounded value; binning both from one
    # value keeps a ghost cell's slots those of its source cell (the
    # slot-aligned ghost refresh, and a neighbor list, rely on it)
    box = cells.box_from_coord(geom, r.astype(dtype).astype(np.float64))
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
