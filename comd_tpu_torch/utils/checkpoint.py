"""Checkpoint / resume (--checkpoint, --checkpointRate, --restore).

The reference has no checkpointing ("code to read/write atomic positions has
been removed", CoMD.c:1147-1152); comd_tpu adds it, and the port writes and
reads comd_tpu's npz format, so either package restores the other's
checkpoint:

  DIR/meta.json   {"step", "config" (comd_tpu's Config fields), "n_global",
                   "has_last_r", "format": "npz"}
  DIR/state.npz   r, p, f, gid, n_atoms, e_potential, n_local, overflow
                  and, on the lazy cell path, last_r (the rebucket
                  baseline); on a mesh every array field stacked
                  [Px, Py, Pz, ...] as comd_tpu's sharded state

The port's Config has one field comd_tpu's lacks, ``device``: meta.json
leaves it out (comd_tpu's load does ``Config(**meta["config"])``) and a
restore takes the device from its caller.  comd_tpu writes orbax when
orbax is installed, and always for its multi-process runs
(comd_tpu/utils/checkpoint.py:53-78); the port has no orbax and refuses
such a checkpoint loudly.

A multi-process launch saves collectively: process 0 gathers every
process's shards and writes the same npz a single process of the same mesh
writes, then every process waits at a barrier.  A restore reads the npz on
every process, and each takes its own shards, so a checkpoint moves freely
between single-process and N-process runs of the same mesh (and to
comd_tpu's single-process mesh).

A restore continues the trajectory bit for bit on the cell paths (the
state layout is canonical and the step deterministic); the list paths
rebuild their Verlet lists from the restored positions.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..parallel import dist

_FIELDS = ("r", "p", "f", "gid", "n_atoms", "e_potential", "n_local",
           "overflow")


def _grid(sim):
    return (sim.cfg.xproc, sim.cfg.yproc, sim.cfg.zproc)


def _state_dict(sim):
    """The state as numpy arrays in comd_tpu's layout; None on a process
    other than 0 of a multi-process launch (a collective call)."""
    from ..interop import SCALARS
    if not hasattr(sim, "states"):
        d = {f: getattr(sim.state, f).cpu().numpy() for f in _FIELDS}
        if sim.last_r is not None:
            d["last_r"] = sim.last_r.cpu().numpy()
        return d
    scalars = {k: v.cpu().numpy() for k, v in sim.mesh_scalars().items()}
    local = {k: [getattr(s, k) for s in sim.states]
             for k in _FIELDS if k not in SCALARS}
    if sim.last_r is not None:
        local["last_r"] = sim.last_r
    d = {}
    for k, v in local.items():        # this process's shards, then all
        allv = dist.gather_to_root(np.stack([x.cpu().numpy() for x in v]))
        if allv is not None:
            d[k] = allv.reshape(_grid(sim) + allv.shape[2:])
    if dist.process_index() != 0:
        return None
    last_r = d.pop("last_r", None)
    d.update(scalars)
    if last_r is not None:
        d["last_r"] = last_r
    return d


def save(path: str, sim, step: int) -> str:
    """Save a Simulation/ShardedSimulation state at ``step``; collective
    across the processes of a launch, process 0 writing.  Returns the
    path."""
    arrays = _state_dict(sim)
    if arrays is not None:
        os.makedirs(path, exist_ok=True)
        config = dataclasses.asdict(sim.cfg)
        config.pop("device")
        meta = {
            "step": step,
            "config": config,
            "n_global": sim.n_global,
            "has_last_r": "last_r" in arrays,
            "format": "npz",
        }
        np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(meta, fh, indent=1)
    dist.barrier()
    return path


def load(path: str, device: str = "cuda"):
    """Returns (Simulation or ShardedSimulation on ``device``, step)
    resumed from a checkpoint directory written by either package; in a
    multi-process launch each process takes its own shards."""
    from ..config import Config
    from ..interop import shards_from_numpy, state_from_numpy
    from ..sim import init_simulation

    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta["format"] != "npz":
        raise ValueError(
            f"checkpoint {path} is in {meta['format']!r} format; "
            f"comd_tpu_torch reads npz only (write it with comd_tpu "
            f"without orbax installed)")
    cfg = Config(**meta["config"], device=device)
    # rebuild the static structures (geometry, potential, plans) from the
    # config, then overwrite the dynamical state
    sim = init_simulation(cfg)
    with np.load(os.path.join(path, "state.npz")) as z:
        data = {k: z[k] for k in z.files}
    last_r = data.pop("last_r", None)
    if hasattr(sim, "states"):
        owned = sim.mesh.owned
        sim.states = [shards_from_numpy(data, sim.device)[s] for s in owned]
        sim._e_parts = None         # the states hold the mesh's ePot
        if last_r is not None:
            flat = last_r.reshape((-1,) + last_r.shape[3:])
            sim.last_r = [torch.as_tensor(np.array(flat[s]),
                                          device=sim.device) for s in owned]
    else:
        sim.state = state_from_numpy(data, sim.device)
        if last_r is not None:
            sim.last_r = torch.as_tensor(last_r, device=sim.device)
    if last_r is None and sim.uses_lazy:
        # a checkpoint without the baseline: the restored positions may be
        # up to skin/2 from the rebucket layout already, so seeding last_r
        # from them would permit a full skin of drift.  The sentinel (far)
        # coordinates force a rebucket on the first step, as comd_tpu.
        if hasattr(sim, "states"):
            sim.last_r = [torch.full_like(s.r, 1.0e10) for s in sim.states]
        else:
            sim.last_r = torch.full_like(sim.state.r, 1.0e10)
    if sim.uses_nl:
        sim.build_neighbor_list()
    return sim, meta["step"]
