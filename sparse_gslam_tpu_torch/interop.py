"""State handed between the JAX package and the port as numpy arrays.

There are no model weights here: the state that crosses is the
landmark graph, the pose graph and the occupancy grid. The JAX side
converts its arrays with `np.asarray`; these functions build the port's
tensors from them. The frontend uses `lm_graph_from_numpy` for its own
per-keyframe graph, the backend `pose_graph_from_numpy` for every
pose-graph solve.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.grid import SubmapGrid
from .ops.solvers import LMGraphData, PoseGraphData

_FLOAT_FIELDS = ("poses", "odom_meas", "odom_info", "lms", "obs_meas",
                 "obs_info")
_INDEX_FIELDS = ("obs_pose", "obs_lm")
_BOOL_FIELDS = ("pose_valid", "pose_fixed", "odom_valid", "lm_valid",
                "obs_valid")


def _packed(fields, names, dtype, device):
    """One host-to-device copy for a group of arrays, split on device."""
    arrs = [np.asarray(fields[k]) for k in names]
    flat = np.concatenate([a.ravel() for a in arrs]).astype(dtype)
    buf = torch.from_numpy(flat).to(device)
    out, o = {}, 0
    for k, a in zip(names, arrs):
        out[k] = buf[o : o + a.size].view(a.shape)
        o += a.size
    return out


def lm_graph_from_numpy(fields: dict, device) -> LMGraphData:
    """Build the port's LMGraphData from the fields of a JAX LMGraphData
    (or the frontend's host arrays), given as numpy arrays by name.
    Floats become float64, indices int64, masks bool, all on `device`
    in three host-to-device copies."""
    t = {
        **_packed(fields, _FLOAT_FIELDS, np.float64, device),
        **_packed(fields, _INDEX_FIELDS, np.int64, device),
        **_packed(fields, _BOOL_FIELDS, np.bool_, device),
    }
    return LMGraphData(**{k: t[k] for k in LMGraphData._fields})


_PG_FLOAT_FIELDS = ("poses", "chain_meas", "chain_info", "clo_meas",
                    "clo_info")
_PG_INDEX_FIELDS = ("clo_i", "clo_j")
_PG_BOOL_FIELDS = ("valid", "fixed", "chain_valid", "clo_valid")


def pose_graph_from_numpy(fields: dict, device) -> PoseGraphData:
    """Build the port's PoseGraphData from the fields of a JAX
    PoseGraphData (or the backend's host arrays), given as numpy arrays
    by name: float64, int64 indices and bool masks on `device`, in three
    host-to-device copies."""
    t = {
        **_packed(fields, _PG_FLOAT_FIELDS, np.float64, device),
        **_packed(fields, _PG_INDEX_FIELDS, np.int64, device),
        **_packed(fields, _PG_BOOL_FIELDS, np.bool_, device),
    }
    return PoseGraphData(**{k: t[k] for k in PoseGraphData._fields})


def grid_from_numpy(probs, origin, resolution, device) -> SubmapGrid:
    """Build a SubmapGrid (float32 probs and origin) on `device`."""
    return SubmapGrid(
        torch.tensor(np.asarray(probs, np.float32), device=device),
        torch.tensor(np.asarray(origin, np.float32), device=device),
        float(resolution),
    )
