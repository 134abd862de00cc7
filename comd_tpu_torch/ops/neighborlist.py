"""The lazy-shell rebucket trigger (from comd_tpu.ops.neighborlist).

Only ``needs_rebuild`` is ported: the cell-sweep lazy step uses it to decide
when the skin is used up.  The Verlet-list build and sweep (the *_nl
methods) are not ported yet.
"""
from __future__ import annotations

import torch


def needs_rebuild(last_r: torch.Tensor, r: torch.Tensor, n_local: int,
                  skin: float) -> torch.Tensor:
    """Any local atom displaced more than skin/2 since the last rebucket
    (neighborList.c:212-247).  Returns a 0-dim bool tensor on r's device."""
    d = r[:, :n_local] - last_r[:, :n_local]
    disp2 = d[0] ** 2 + d[1] ** 2 + d[2] ** 2
    return disp2.max() > (0.5 * skin) ** 2
