"""Relation-based trajectory error metric (Burgard/Kuemmerle et al.,
"On Measuring the Accuracy of SLAM Algorithms", AR 2009).

Reimplements the external `metricEvaluator` used by the reference
(datasets/eval.sh:1-5, cloned by datasets/download.sh:40-43): given a
`.result` trajectory (FLASER lines) and a `.relations` ground-truth
file (stamp1 stamp2 dx dy dz droll dpitch dyaw), compute for each
relation the discrepancy between the trajectory's relative motion and
the ground-truth relative motion. Translational error = ||xy part||,
rotational error = |yaw part| (the 2D specialization of the weight
vectors {1,1,1,0,0,0} / {0,0,0,1,1,1} in eval.sh:2-3). Reports
mean +- stddev like line 2 of the evaluator's error logs
(cf. gen_acc_table.py:1-12). Port of sparse_gslam_tpu/eval/relations.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import se2


def load_result(path: str):
    """Parse FLASER .result lines -> (times (N,), poses (N,3))."""
    times, poses = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "FLASER":
                continue
            n = int(parts[1])
            odom = parts[2 + n + 3 : 2 + n + 6]
            poses.append([float(v) for v in odom])
            times.append(float(parts[2 + n + 6]))
    return np.asarray(times), np.asarray(poses)


def load_relations(path: str):
    """Parse .relations: stamp1 stamp2 dx dy dz droll dpitch dyaw."""
    rel = np.loadtxt(path, ndmin=2)
    t1, t2 = rel[:, 0], rel[:, 1]
    gt = np.stack([rel[:, 2], rel[:, 3], rel[:, 7]], axis=1)  # x, y, yaw
    return t1, t2, gt


def save_relations(path: str, t1, t2, gt_se2):
    with open(path, "w") as f:
        for a, b, g in zip(t1, t2, gt_se2):
            f.write(
                f"{a:.6f} {b:.6f} {g[0]:.9f} {g[1]:.9f} 0 0 0 {g[2]:.9f}\n"
            )


@dataclasses.dataclass
class ATEResult:
    trans_mean: float
    trans_std: float
    rot_mean: float
    rot_std: float
    n_relations: int
    trans_errors: np.ndarray
    rot_errors: np.ndarray

    def __str__(self):
        return (
            f"ATE trans {self.trans_mean:.4f} +- {self.trans_std:.4f} m, "
            f"rot {np.degrees(self.rot_mean):.3f} +- "
            f"{np.degrees(self.rot_std):.3f} deg "
            f"({self.n_relations} relations)"
        )


def _interp_pose(times, poses, t):
    """Pose at timestamp t: nearest-neighbor lookup (the evaluator
    matches scan timestamps; our .result carries one line per scan so
    exact matches are the common case)."""
    i = np.searchsorted(times, t)
    i = np.clip(i, 0, len(times) - 1)
    j = np.clip(i - 1, 0, len(times) - 1)
    pick = np.abs(times[i] - t) <= np.abs(times[j] - t)
    return poses[np.where(pick, i, j)]


def evaluate(times, poses, t1, t2, gt) -> ATEResult:
    order = np.argsort(times, kind="stable")
    times, poses = times[order], poses[order]
    p1 = _interp_pose(times, poses, t1)
    p2 = _interp_pose(times, poses, t2)
    rel = se2.relative(p1, p2)
    err = se2.compose(se2.inverse(gt), rel)
    trans = np.linalg.norm(err[:, :2], axis=1)
    rot = np.abs(se2.wrap_angle(err[:, 2]))
    return ATEResult(
        float(trans.mean()),
        float(trans.std()),
        float(rot.mean()),
        float(rot.std()),
        len(t1),
        trans,
        rot,
    )


def evaluate_files(result_path: str, relations_path: str) -> ATEResult:
    times, poses = load_result(result_path)
    t1, t2, gt = load_relations(relations_path)
    return evaluate(times, poses, t1, t2, gt)


def evaluate_per_separation(result_path: str, relations_path: str):
    """Mean translational error grouped by relation time separation
    (the sim worlds ship relations at 1/5/15/40 s; eval/simulate.py
    make_relations). Localizes WHERE drift lives: short separations
    measure intra-keyframe dead reckoning + adjacent-chain noise,
    long ones accumulated drift between absolute anchors. Returns
    {separation_s: (mean_trans_err, n)} sorted by separation."""
    times, poses = load_result(result_path)
    t1, t2, gt = load_relations(relations_path)
    res = evaluate(times, poses, t1, t2, gt)
    seps = np.round(t2 - t1).astype(int)
    out = {}
    for sep in np.unique(seps):
        m = seps == sep
        out[int(sep)] = (float(res.trans_errors[m].mean()), int(m.sum()))
    return out
