"""The hand-written CUDA kernels (csrc/) and their wrappers.

``LAUNCHES`` counts kernel launches per wrapper, bumped right after each
successful launch and nowhere else; a run zeroes it with
``reset_launch_counts`` to show which kernels its path went through.

The cell paths' wrappers (K1/K2, kick_drift_trigger, embed_fill, land)
take one shard's field or a mesh's stack of them, [S, ...] with the shard
first (``as_stack``), and sweep every shard in one launch; a list of
per-shard tensors is not a stack and raises.
"""
import torch
LAUNCHES = {"eam_pass1": 0, "eam_pass3": 0, "lj": 0,
            "half_eam_pass1": 0, "half_eam_pass3": 0, "half_lj": 0,
            "halo_fill": 0, "ring_push": 0, "nl_build": 0, "nl_sweep": 0,
            # the list paths' row ops: the build's rows (nl.py), pass 2 on
            # the rows and the landing of a list force (step.py)
            "nl_rows": 0, "embed_rows": 0, "land_rows": 0,
            # one stage of a dfEmbed fill across processes
            "halo_fill_stage": 0,
            # the mesh's ghost-position refresh: whole, or a stage across
            # processes
            "position_fill": 0, "position_fill_stage": 0,
            # the collective transport's atom messages (one a stage) and
            # the half-shell fold (serial, or one a stage on a mesh)
            "atom_pack": 0, "fold_halo": 0,
            "window_pair": 0, "row_lookup": 0, "lane_lookup": 0,
            # the -P spline and -I LJ-table variants of K1, K2 and NL2
            "spline_eam_pass1": 0, "spline_eam_pass3": 0,
            "spline_half_eam_pass1": 0, "spline_half_eam_pass3": 0,
            "lj_table": 0, "nl_sweep_spline": 0,
            # the step's small ops around the force (step.py)
            "kick_drift_trigger": 0, "refresh_halo": 0, "embed_fill": 0,
            "land": 0,
            # the redistribution (rebucket.py)
            "rebucket_bin": 0, "rebucket_place": 0,
            # the atom exchange's unload (arrivals.py)
            "arrivals_bin": 0, "arrivals_place": 0, "sort_cells": 0}


def as_stack(what: str, t, dims: int):
    """(one, stack): ``t`` as a stack of shards [S, ...], and whether it
    was one shard's field of ``dims`` dimensions (a stack of one)."""
    if not isinstance(t, torch.Tensor) or t.dim() not in (dims, dims + 1):
        raise ValueError(f"{what}: expected one shard's {dims}-d field or a "
                         f"stack of shards [S, ...], got "
                         + (f"{tuple(t.shape)}" if isinstance(t, torch.Tensor)
                            else f"a {type(t).__name__}"))
    if t.dim() == dims:
        return True, t[None]
    if t.shape[0] < 1:
        raise ValueError(f"{what}: an empty stack")
    return False, t


def require_stack(what: str, t, dims: int):
    """``t`` if it is a mesh's stack of shards, one tensor of ``dims``
    dimensions with the shard first; else a ValueError (a list of
    per-shard tensors is not one stack)."""
    if not isinstance(t, torch.Tensor) or t.dim() != dims:
        got = (f"shape {tuple(t.shape)}" if isinstance(t, torch.Tensor)
               else f"a {type(t).__name__}")
        raise ValueError(f"{what} must be the shards' stack, one "
                         f"{dims}-d tensor [S, ...], got {got}")
    return t


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
