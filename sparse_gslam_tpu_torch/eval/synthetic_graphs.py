"""Synthetic pose-graph generators for the solver tests and the GPU
smoke run. Port of sparse_gslam_tpu/eval/synthetic_graphs.py.

Produces mit-killian-scale chains with loop closures: a long noisy
trajectory (the reference's largest sequence has ~2k keyframes) with
closures between revisited segments.
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop import pose_graph_from_numpy
from ..utils import se2


def make_chain_graph(
    n_poses: int,
    n_closures: int,
    drift: float = 0.02,
    seed: int = 0,
    dtype=np.float64,
    pad_to: int | None = None,
):
    """Returns (fields, gt): the graph as numpy arrays by PoseGraphData
    field name (to_pose_graph builds the tensors) and the ground truth
    (n_poses, 3). A loopy ground truth (figure-eight-ish),
    dead-reckoned initial estimates, odometry chain edges, and closures
    between poses that are far apart in time but close in ground-truth
    space. The same seed gives the JAX package's graph."""
    rng = np.random.default_rng(seed)
    n = n_poses
    gt = np.zeros((n, 3))
    for i in range(1, n):
        turn = 0.06 * np.sin(i * 2 * np.pi / 256.0) + 0.01
        gt[i] = se2.compose(gt[i - 1], np.array([0.5, 0.0, turn]))

    N = pad_to or n
    poses = np.zeros((N, 3), dtype)
    valid = np.zeros(N, bool)
    fixed = np.zeros(N, bool)
    chain_meas = np.zeros((N, 3), dtype)
    chain_info = np.tile(np.eye(3, dtype=dtype), (N, 1, 1))
    chain_valid = np.zeros(N, bool)
    valid[:n] = True
    fixed[0] = True
    poses[0] = gt[0]
    for i in range(1, n):
        d = se2.relative(gt[i - 1], gt[i]) + rng.normal(0, drift, 3)
        chain_meas[i] = d
        chain_info[i] = np.diag([120.0, 120.0, 400.0])
        chain_valid[i] = True
        poses[i] = se2.compose(poses[i - 1], d)

    # closures: pairs (i, j) with j - i large and gt-distance small
    cand = []
    for i in range(0, n - 200, 17):
        dist = np.linalg.norm(gt[i + 150 :, :2] - gt[i, :2], axis=1)
        j_rel = np.argmin(dist)
        if dist[j_rel] < 3.0:
            cand.append((i, i + 150 + int(j_rel)))
    rng.shuffle(cand)
    cand = cand[:n_closures]
    C = max(len(cand), 1)
    Cpad = 1
    while Cpad < C:
        Cpad *= 2
    clo_i = np.zeros(Cpad, np.int32)
    clo_j = np.zeros(Cpad, np.int32)
    clo_meas = np.zeros((Cpad, 3), dtype)
    clo_info = np.tile(np.eye(3, dtype=dtype), (Cpad, 1, 1))
    clo_valid = np.zeros(Cpad, bool)
    for k, (a, b) in enumerate(cand):
        clo_i[k] = a
        clo_j[k] = b
        clo_meas[k] = se2.relative(gt[a], gt[b]) + rng.normal(0, 0.01, 3)
        clo_info[k] = np.diag([400.0, 400.0, 900.0])
        clo_valid[k] = True
    fields = dict(
        poses=poses, valid=valid, fixed=fixed, chain_meas=chain_meas,
        chain_info=chain_info, chain_valid=chain_valid, clo_i=clo_i,
        clo_j=clo_j, clo_meas=clo_meas, clo_info=clo_info,
        clo_valid=clo_valid,
    )
    return fields, gt


def to_pose_graph(fields: dict, device="cuda", dtype=None):
    """The port's PoseGraphData on `device`: int64 indices, bool masks,
    floats in float64 or in `dtype`."""
    g = pose_graph_from_numpy(fields, device)
    if dtype is None:
        return g
    return g._replace(**{k: v.to(dtype) for k, v in g._asdict().items()
                         if v.is_floating_point()})


def graph_to_arrays(g) -> dict:
    """Dump a PoseGraphData (tensors on any device, or arrays) to plain
    numpy (for the native baseline)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in g._asdict().items()}
