"""The hand-written CUDA kernels (csrc/) and their wrappers.

``LAUNCHES`` counts kernel launches per wrapper, bumped right after each
successful launch and nowhere else; a run zeroes it with
``reset_launch_counts`` to show which kernels its path went through.
"""
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


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
