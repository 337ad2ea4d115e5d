"""The comparison that decides `correct`: what a session of the SLAM
engine produced, read from either side, and the numbers that hold the
program's session against the reference's.

`snapshot` reads the public state of a SlamSystem (the program's or the
reference's: they share the attribute names) into numpy arrays:
the frontend LM's keyframe poses, the pose graph's poses, the backend's
closures (loop closures, chain edges, pins; each with its refined
measurement) and every submap's two occupancy grids. `compare` gives
one number per check; `judge` holds them against the cell's limits
(cells/<cell>.json).
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the numbers compared, in the order they are printed; `closures` is
# exact (limit 0)
CHECKS = ("closures", "lm_pose_gap", "pg_pose_gap", "refine_gap",
          "grid_cells")
# the gap read where one side has a pose the other lacks (m or rad):
# wrong by any measure
MISSING_POSE = 1.0


def snapshot(system) -> dict:
    """The session's outputs as host arrays."""
    fe, be = system.frontend, system.backend
    kf = (fe.estimates() if fe.keyframes else np.zeros((0, 3)))
    out = {"frames": int(system.frame_idx),
           "kf": np.asarray(kf, np.float64),
           "pg": np.zeros((0, 3)), "closures": {}, "grids": []}
    if be is None:
        return out
    if be.pose_count > 0:
        out["pg"] = np.asarray(be.pose_estimates(), np.float64)
    for c in be.closures:
        key = (c.kind, int(c.i), int(c.j), bool(c.active))
        # a pair measured twice keeps both, in order
        while key in out["closures"]:
            key = key + ("again",)
        out["closures"][key] = np.asarray(c.meas, np.float64)
    out["grids"] = [
        (sm.probs.detach().cpu().numpy(), sm.high_res.detach().cpu().numpy())
        for sm in be.submaps
    ]
    return out


def _pose_gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |dx|, |dy| (m) or |dtheta| (rad, wrapped) over the poses
    both have; MISSING_POSE at least where their numbers differ."""
    n = min(len(a), len(b))
    gap = 0.0 if len(a) == len(b) else MISSING_POSE
    if n == 0:
        return gap
    d = a[:n] - b[:n]
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return max(gap, float(np.abs(d).max()))


def compare(prog: dict, ref: dict) -> dict:
    """One number per check, 0 where the two sides agree exactly:

    closures     closures (kind, poses, active) on one side only
    lm_pose_gap  the frontend LM's keyframe poses (m / rad)
    pg_pose_gap  the pose-graph solve's poses (m / rad)
    refine_gap   the refined measurement of each closure both have
                 (m / rad)
    grid_cells   the share of occupancy-grid cells that differ (both
                 resolutions; every cell of a submap on one side only)
    """
    pk, rk = set(prog["closures"]), set(ref["closures"])
    refine = 0.0
    for k in pk & rk:
        d = prog["closures"][k] - ref["closures"][k]
        d[2] = (d[2] + np.pi) % (2 * np.pi) - np.pi
        refine = max(refine, float(np.abs(d).max()))
    cells = differ = 0
    n = min(len(prog["grids"]), len(ref["grids"]))
    for extra in prog["grids"][n:] + ref["grids"][n:]:
        differ += sum(g.size for g in extra)
        cells += sum(g.size for g in extra)
    for gp, gr in zip(prog["grids"], ref["grids"]):
        for a, b in zip(gp, gr):
            if a.shape != b.shape:
                differ += max(a.size, b.size)
                cells += max(a.size, b.size)
                continue
            differ += int(np.count_nonzero(a != b))
            cells += a.size
    return {
        "closures": float(len(pk ^ rk)),
        "lm_pose_gap": _pose_gap(prog["kf"], ref["kf"]),
        "pg_pose_gap": _pose_gap(prog["pg"], ref["pg"]),
        "refine_gap": refine,
        "grid_cells": differ / cells if cells else 0.0,
    }


def worst(readings: list) -> dict:
    """The largest reading of each check over several comparisons."""
    return {k: max(r[k] for r in readings) for k in CHECKS}


def load_cell_file(cell: str) -> dict:
    """cells/<cell>.json: the cell's limits and its traced slice."""
    with open(os.path.join(HERE, "cells", cell + ".json")) as f:
        return json.load(f)


def judge(numbers: dict, limits: dict) -> bool:
    """True when every number is at or under its limit."""
    return all(numbers[k] <= limits[k] for k in CHECKS)
