"""Carry a comd_tpu state into the port.

``state_from_numpy`` turns a comd_tpu ``SimState`` passed as
``{field: np.asarray(getattr(state, field))}`` into the port's SimState, so
both packages can step from the identical state.  The potential needs no
conversion: both read the same ``pots/`` file and fit the same Chebyshev
coefficients.
"""
from __future__ import annotations

import numpy as np
import torch

from .sim import SimState

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
