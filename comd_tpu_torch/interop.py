"""Carry a comd_tpu state and potential into the port.

``state_from_numpy`` turns a comd_tpu ``SimState`` passed as
``{field: np.asarray(getattr(state, field))}`` into the port's SimState, so
both packages can step from the identical state.  ``shards_from_numpy``
and ``shards_to_numpy`` carry comd_tpu's sharded state -- array fields with
a leading [Px, Py, Pz] mesh index, replicated scalars -- into the port's
per-shard SimStates (shard order x-major, as parallel.mesh.Mesh), views of
one [S, ...] stack a field as the step holds them, and back, each field by
one reshape.
``nlist_from_numpy`` and ``nlist_to_numpy`` carry a comd_tpu
``NeighborList`` (its fields as numpy arrays) into the port and back; the
port's ``row_start``, which comd_tpu's list has not, is derived from its
rows.
``lj_potential_from_fields`` builds the port's LjPotential from a comd_tpu
LjPotential's fields (``dataclasses.asdict``), so a test can show both
packages hold the same LJ parameters.  An EAM potential needs no
conversion: both packages read the same ``pots/`` file and fit the same
Chebyshev coefficients.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.neighborlist import NeighborList, cell_row_starts
from .potentials.lj import LjPotential
from .sim import SimState, stack_of

FIELDS = ("r", "p", "f", "gid", "n_atoms", "e_potential", "n_local",
          "overflow")


def state_from_numpy(arrays: dict, device) -> SimState:
    """SimState on ``device`` from numpy arrays keyed by SimState field;
    dtypes are kept as given (positions/momenta/forces in the dynamics
    dtype, gid and n_atoms int32, e_potential in the energy dtype)."""
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_numpy: missing fields {missing}")
    return SimState(**{
        k: torch.as_tensor(np.array(arrays[k], copy=True), device=device)
        for k in FIELDS})


def lj_potential_from_fields(fields: dict) -> LjPotential:
    """The port's LjPotential from a comd_tpu LjPotential's fields, given as
    plain numbers and strings keyed by field name."""
    names = [f.name for f in dataclasses.fields(LjPotential)]
    if sorted(fields) != sorted(names):
        raise KeyError(f"lj_potential_from_fields: expected fields {names}, "
                       f"got {sorted(fields)}")
    return LjPotential(**fields)


SCALARS = ("e_potential", "n_local", "overflow")


def shards_from_numpy(arrays: dict, device) -> list:
    """Per-shard SimStates on ``device`` from comd_tpu's sharded state as
    numpy arrays: each array field [Px, Py, Pz, ...] becomes one [S, ...]
    stack by a reshape (shards in np.ndindex order), each shard's state
    its views; the replicated scalars are shared by all shards."""
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"shards_from_numpy: missing fields {missing}")
    grid = np.asarray(arrays["n_atoms"]).shape[:3]
    n = int(np.prod(grid))
    scalars = {k: torch.as_tensor(np.array(arrays[k], copy=True).reshape(()),
                                  device=device) for k in SCALARS}
    stacks = {k: torch.as_tensor(np.array(
        np.asarray(arrays[k]).reshape((n,) + np.shape(arrays[k])[3:]),
        copy=True), device=device) for k in FIELDS if k not in SCALARS}
    return [SimState(**{k: v[i] for k, v in stacks.items()}, **scalars)
            for i in range(n)]


def shards_to_numpy(states: list, grid) -> dict:
    """comd_tpu's sharded layout from per-shard SimStates, views of one
    stack a field (``sim.stack_of``): each stack [S, ...] reshaped to
    [Px, Py, Pz, ...], the scalars from the first shard."""
    out = {k: stack_of(getattr(s, k) for s in states).cpu().numpy()
           .reshape(tuple(grid) + tuple(getattr(states[0], k).shape))
           for k in FIELDS if k not in SCALARS}
    out.update({k: getattr(states[0], k).cpu().numpy() for k in SCALARS})
    return out


NL_FIELDS = ("a_list", "a_valid", "nl", "last_r")


def nlist_from_numpy(arrays: dict, device, n_local: int) -> NeighborList:
    """The port's NeighborList on ``device`` from a comd_tpu NeighborList's
    fields as numpy arrays (a_list and nl int32, a_valid bool, last_r in
    the dynamics dtype), its ``row_start`` over the ``n_local`` local
    cells from the rows (``neighborlist.cell_row_starts``)."""
    missing = [k for k in NL_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"nlist_from_numpy: missing fields {missing}")
    t = {k: torch.as_tensor(np.array(arrays[k], copy=True), device=device)
         for k in NL_FIELDS}
    t["row_start"] = cell_row_starts(t["a_list"], t["a_valid"], n_local,
                                     t["last_r"].shape[2])
    return NeighborList(**t)


def nlist_to_numpy(nlist: NeighborList) -> dict:
    """A NeighborList's fields as numpy arrays, keyed as comd_tpu's."""
    return {k: getattr(nlist, k).cpu().numpy() for k in NL_FIELDS}
