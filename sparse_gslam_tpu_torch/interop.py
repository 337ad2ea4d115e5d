"""State handed between the JAX package and the port as numpy arrays.

There are no model weights here: the state that crosses is the
landmark graph, the pose graph and the occupancy grid, and the
accelerator branch's matcher inputs. The JAX side converts its arrays
with `np.asarray`; these functions build the port's tensors from them.
The frontend uses `lm_graph_from_numpy` for its own per-keyframe graph,
the backend `pose_graph_from_numpy` for every pose-graph solve and
`joint_graph_from_numpy` for the final joint solve; `grids_from_numpy`,
`spectra_from_numpy` and `pin_batch_from_numpy` carry the inputs of
fused_match / match_candidates_fused and pin_eval_batch (ops/
matching.py), so that the JAX package and the port see the same data.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.grid import SubmapGrid
from .ops.solvers import JointGraphData, LMGraphData, PoseGraphData

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


_JOINT_FLOAT_FIELDS = _FLOAT_FIELDS + ("clo_meas", "clo_info")
_JOINT_INDEX_FIELDS = _INDEX_FIELDS + ("clo_i", "clo_j")
_JOINT_BOOL_FIELDS = _BOOL_FIELDS + ("clo_valid",)


def joint_graph_from_numpy(fields: dict, device) -> JointGraphData:
    """Build the port's JointGraphData from the fields of a JAX
    JointGraphData (or the backend's host arrays), given as numpy
    arrays by name: float64, int64 indices and bool masks on `device`,
    in three host-to-device copies."""
    t = {
        **_packed(fields, _JOINT_FLOAT_FIELDS, np.float64, device),
        **_packed(fields, _JOINT_INDEX_FIELDS, np.int64, device),
        **_packed(fields, _JOINT_BOOL_FIELDS, np.bool_, device),
    }
    return JointGraphData(**{k: t[k] for k in JointGraphData._fields})


def grid_from_numpy(probs, origin, resolution, device) -> SubmapGrid:
    """Build a SubmapGrid (float32 probs and origin) on `device`."""
    return SubmapGrid(
        torch.tensor(np.asarray(probs, np.float32), device=device),
        torch.tensor(np.asarray(origin, np.float32), device=device),
        float(resolution),
    )


def grids_from_numpy(grids, device) -> list:
    """A list of float32 (G, G) tensors on `device` from a stack or list
    of grids (score, pooled or high-res grids; origins likewise as
    (2,) rows), in one host-to-device copy."""
    arr = np.array(grids, np.float32)
    return list(torch.from_numpy(arr).to(device))


def spectra_from_numpy(spectra, device) -> torch.Tensor:
    """Grid spectra (grid_spectrum's (..., F, F//2+1) half spectra) as
    one complex64 tensor on `device`."""
    arr = np.array(spectra, np.complex64)
    return torch.from_numpy(arr).to(device)


_PIN_FLOAT_FIELDS = ("orgs", "seeds", "pts", "ths")


def pin_batch_from_numpy(fields: dict, device) -> dict:
    """pin_eval_batch's per-pin inputs by name (ids, orgs, seeds, pts,
    val, ths, live, as the JAX package's _kf_edges_device builds them):
    float32 poses, points and angles, int64 submap ids and bool masks
    on `device`, in three host-to-device copies."""
    return {
        **_packed(fields, _PIN_FLOAT_FIELDS, np.float32, device),
        **_packed(fields, ("ids",), np.int64, device),
        **_packed(fields, ("val", "live"), np.bool_, device),
    }
