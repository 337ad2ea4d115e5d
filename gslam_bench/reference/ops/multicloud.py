"""Multiscan ("multicloud") sliding-window accumulation with per-point
covariance from odometry dead-reckoning + polar range noise.

Re-implements the reference's core sparse-sensing trick (paper Fig. 5):
MulticloudConverter (src/sparse_gslam/src/multicloud2.cpp:10-96,
include/multicloud2.h:13-33) and OdomErrorPropagator
(include/odom_error_propagator.h:6-51), vectorized over the window.

State is a plain dataclass of numpy arrays; the per-window covariance
math is fully vectorized (one pass over the W/S scans in the window).
Port of sparse_gslam_tpu/ops/multicloud.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import se2
from ..utils.config import SlamConfig


def odom_step_jacobians(dpose, theta):
    """Jacobian blocks of SE2 composition pose' = pose * dpose
    (odom_error_propagator.h:6-15 updateJacobian).

    dpose: (...,3) step, theta: (...) heading of `pose` before the step.
    Returns (Jp (...,3,3), Ju (...,3,3)): derivative w.r.t. the
    accumulated pose and w.r.t. the step.
    """
    xp = se2._xp(dpose, theta)
    ct, st = xp.cos(theta), xp.sin(theta)
    dx, dy = dpose[..., 0], dpose[..., 1]
    o = xp.zeros_like(ct)
    i = xp.ones_like(ct)
    Jp = xp.stack(
        [
            xp.stack([i, o, dy * ct - dx * st], axis=-1),
            xp.stack([o, i, -dx * ct - dy * st], axis=-1),
            xp.stack([o, o, i], axis=-1),
        ],
        axis=-2,
    )
    Ju = xp.stack(
        [
            xp.stack([ct, st, o], axis=-1),
            xp.stack([-st, ct, o], axis=-1),
            xp.stack([o, o, i], axis=-1),
        ],
        axis=-2,
    )
    return Jp, Ju


def step_control_var(dpose, var, model: str = "reference"):
    """Per-step control-noise variance (diagonal, body frame of the
    step delta).

    model="reference": diag(|dx^2| var_x, |dy dx| var_y, |dth dx|
    var_w) -- scaled by the step's forward motion, exactly as the
    reference (odom_error_propagator.h:40-42). Degenerate for straight
    driving: lateral/heading noise vanishes with dy/dth even though
    real encoders drift there too.

    model="additive": sigma_x = std_x (|dx|+eps), sigma_y = std_y
    (|dx|+eps), sigma_th = std_w (|dth|+|dx|+eps) -- lateral and
    heading noise scale with distance traveled (the standard
    wheel-odometry model; also exactly the noise the simulator
    injects, eval/simulate.py:201-215), so calibrated stds stay
    meaningful on straight stretches."""
    if model == "additive":
        eps = 0.01
        s = np.array(
            [
                abs(dpose[0]) + eps,
                abs(dpose[0]) + eps,
                abs(dpose[2]) + abs(dpose[0]) + eps,
            ]
        )
        return s * s * var
    return (
        np.abs(
            np.array(
                [
                    dpose[0] * dpose[0],
                    dpose[1] * dpose[0],
                    dpose[2] * dpose[0],
                ]
            )
        )
        * var
    )


class OdomErrorPropagator:
    """Dead-reckoning covariance propagation (odom_error_propagator.h).

    Control noise per step: see step_control_var (model selects the
    reference's forward-scaled form or the additive wheel-odometry
    form)."""

    def __init__(self, std_x: float, std_y: float, std_w: float,
                 model: str = "reference"):
        self.var = np.array([std_x**2, std_y**2, std_w**2])
        self.model = model
        self.reset()

    def reset(self):
        self.pose = np.zeros(3)
        self.cov = np.eye(3) * 1e-6

    def step(self, dpose):
        dpose = np.asarray(dpose, dtype=np.float64)
        Jp, Ju = odom_step_jacobians(dpose, self.pose[2])
        covu = step_control_var(dpose, self.var, self.model)
        # note: the reference's J(1,3)=-st / J(1,4)=ct row order means its
        # "Ju" block is R(theta)^T-like; replicate exactly:
        JuT = Ju  # Ju above already matches updateJacobian's (3:6) block
        self.cov = Jp @ self.cov @ Jp.T + JuT @ np.diag(covu) @ JuT.T
        self.pose = se2.compose(self.pose, dpose)


def propagate_chain(deltas, var, model: str = "reference"):
    """Pose+cov propagation over a chain of deltas.

    deltas: (K,3). Returns pose (3,), cov (3,3) after composing all
    steps starting from identity -- equivalent to repeated
    OdomErrorPropagator.step.
    """
    prop = OdomErrorPropagator(1.0, 1.0, 1.0, model)
    prop.var = var
    for d in deltas:
        prop.step(d)
    return prop.pose, prop.cov


def propagate_suffixes(deltas, var, model: str = "reference"):
    """All-suffix propagation: for each i, the pose+cov of composing
    deltas[i:], each starting from identity.

    Equivalent to running OdomErrorPropagator over every suffix
    (multicloud2.cpp:55-60 does this with an O(scans * steps) loop);
    here one vectorized sweep over steps updates all suffixes at once.

    deltas: (K,3). Returns poses (K+1,3), covs (K+1,3,3) where entry i
    corresponds to the suffix starting at i (entry K = identity).
    """
    K = len(deltas)
    poses = np.zeros((K + 1, 3))
    covs = np.tile(np.eye(3) * 1e-6, (K + 1, 1, 1))
    for j in range(K):
        active = np.arange(K + 1) <= j
        d = deltas[j]
        Jp, Ju = odom_step_jacobians(d, poses[:, 2])
        covu = step_control_var(d, var, model)
        new_cov = Jp @ covs @ np.swapaxes(Jp, -1, -2) + Ju @ np.diag(
            covu
        ) @ np.swapaxes(Ju, -1, -2)
        new_pose = se2.compose(poses, np.broadcast_to(d, poses.shape))
        covs = np.where(active[:, None, None], new_cov, covs)
        poses = np.where(active[:, None], new_pose, poses)
    return poses, covs


def inverse_pose_cov(pose, cov):
    """Covariance of the inverse pose via the Jacobian of SE2 inversion
    (multicloud2.cpp:62-67 Juk)."""
    ct, st = np.cos(pose[2]), np.sin(pose[2])
    Juk = np.array(
        [
            [-ct, st, pose[1] * ct + pose[0] * st],
            [-st, -ct, pose[1] * st - pose[0] * ct],
            [0.0, 0.0, -1.0],
        ]
    )
    return se2.inverse(pose), Juk @ cov @ Juk.T


def point_transform_jacobian(inv_pose):
    """2x5 Jacobian used to push (pose cov, beam cov) into point cov
    (multicloud2.cpp:68, via updateJacobian on the inverse pose).

    Note the reference evaluates updateJacobian at (dx, dy, theta) of
    the *inverse pose* (not at the transformed point) -- an
    approximation we replicate for parity.
    """
    dx, dy, th = inv_pose
    ct, st = np.cos(th), np.sin(th)
    J = np.zeros((2, 5))
    J[0, 0] = J[1, 1] = 1.0
    J[0, 2] = dy * ct - dx * st
    J[1, 2] = -dx * ct - dy * st
    J[0, 3], J[0, 4] = ct, st
    J[1, 3], J[1, 4] = -st, ct
    return J


@dataclasses.dataclass
class MulticloudResult:
    points: np.ndarray  # (M, 2) finite points in current base_link frame
    covs: np.ndarray  # (M, 2, 2) per-point covariance


class MulticloudConverter:
    """Sliding multiscan window (multicloud2.cpp:35-96).

    update() is called once per frame with the subsampled scan ranges
    (already clamped to range_max by the driver, log_runner.cpp:135) and
    the cumulative raw-odometry pose of the frame. Returns a
    MulticloudResult once the window is full, else None.
    """

    def __init__(self, config: SlamConfig):
        self.scan_size = config.scan_size
        self.window = config.multicloud_size
        self.var_r = config.std_r**2
        self.var_odom = np.array(
            [config.std_x**2, config.std_y**2, config.std_w**2]
        )
        self.noise_model = getattr(config, "noise_model", "reference")
        self.range_max = config.range_max
        angles = config.angle_min + config.angle_increment * np.arange(
            config.scan_size
        )
        self.table = np.stack([np.cos(angles), np.sin(angles)], axis=1)
        self._cloud_odom = np.zeros((0, 2))  # window points in odom frame

    def set_table(self, cos_sin: np.ndarray):
        """Override the beam direction table (driver subsampling recomputes
        it per frame, log_runner.cpp:134-141)."""
        self.table = cos_sin

    def update(self, ranges, deltas, zero_pose):
        """ranges: (S,) subsampled ranges; deltas: list/array of all
        per-frame odometry deltas so far (Delta.dpose only); zero_pose:
        cumulative raw odom pose (log_runner.cpp:113 zero_pose)."""
        ranges = np.asarray(ranges, dtype=np.float64)
        r = np.where(ranges >= self.range_max, np.inf, ranges)
        # inf * cos(angle) can produce nan for angle ~ +-pi/2; the
        # reference gets inf/nan likewise and filters non-finite later
        with np.errstate(invalid="ignore"):
            pts_bl = self.table * r[:, None]
            pts_odom = se2.apply(zero_pose, pts_bl)
        self._cloud_odom = np.concatenate([self._cloud_odom, pts_odom])

        if len(self._cloud_odom) < self.window:
            return None
        self._cloud_odom = self._cloud_odom[-self.window :]
        with np.errstate(invalid="ignore"):
            bl = se2.apply(se2.inverse(zero_pose), self._cloud_odom)

        deltas = np.asarray(deltas, dtype=np.float64).reshape(-1, 3)
        n_scans = self.window // self.scan_size
        delta_offset = n_scans - 1
        tail = deltas[len(deltas) - delta_offset :]
        suffix_poses, suffix_covs = propagate_suffixes(
            tail, self.var_odom, self.noise_model
        )
        pts_out, cov_out = [], []
        for i in range(n_scans):
            # scan i's chain = the last (delta_offset - i) deltas
            pose, cov = suffix_poses[i], suffix_covs[i]
            inv_pose, inv_cov = inverse_pose_cov(pose, cov)
            J = point_transform_jacobian(inv_pose)
            Jp = J[:, :3]
            Jb = J[:, 3:5]
            pose_part = Jp @ inv_cov @ Jp.T
            base = self.scan_size * i
            chunk = bl[base : base + self.scan_size]
            finite = np.isfinite(chunk).all(axis=1)
            cs = self.table[finite]
            covp = (
                np.einsum("ni,nj->nij", cs, cs) * self.var_r
            )  # var_r * [cc, cs; cs, ss] (multicloud2.cpp:78-81)
            covs = pose_part[None] + np.einsum(
                "ij,njk,lk->nil", Jb, covp, Jb
            )
            pts_out.append(chunk[finite])
            cov_out.append(covs)
        return MulticloudResult(
            np.concatenate(pts_out), np.concatenate(cov_out)
        )
