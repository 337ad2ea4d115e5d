"""SE(2) rigid transforms as plain (..., 3) arrays [x, y, theta].

Replaces g2o::SE2 (used throughout the reference, e.g.
src/sparse_gslam/src/drone.cpp:52, src/log_runner.cpp:57) with a
functional, batch-first representation that works identically on numpy
arrays and torch tensors, so the same code path serves the host driver
loop and the device solver. Port of sparse_gslam_tpu/utils/se2.py.

Conventions: pose p = [x, y, theta] maps a point q in the body frame to
the world frame via R(theta) @ q + [x, y]. Composition a * b applies b
first in a's frame (matches g2o::SE2 operator*).
"""
from __future__ import annotations

import numpy as np
import torch


def _xp(*arrays):
    """Pick numpy or torch based on the argument types (torch accepts
    the numpy spellings used here: `axis=`, `arctan2`, `.sum(-1)`)."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return torch
    return np


def wrap_angle(theta):
    """Normalize angle(s) to (-pi, pi]. g2o::normalize_theta equivalent."""
    xp = _xp(theta)
    return theta - 2.0 * np.pi * xp.floor((theta + np.pi) / (2.0 * np.pi))


def compose(a, b):
    """SE2 composition a*b for (...,3) arrays (g2o::SE2 operator*)."""
    xp = _xp(a, b)
    ca, sa = xp.cos(a[..., 2]), xp.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = wrap_angle(a[..., 2] + b[..., 2])
    return xp.stack([x, y, t], axis=-1)


def inverse(a):
    """SE2 inverse for (...,3) arrays."""
    xp = _xp(a)
    ca, sa = xp.cos(a[..., 2]), xp.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return xp.stack([x, y, -a[..., 2]], axis=-1)


def relative(a, b):
    """a^-1 * b: the motion from frame a to frame b."""
    return compose(inverse(a), b)


def apply(a, pts):
    """Transform points (...,2) by pose(s) a (...,3)."""
    xp = _xp(a, pts)
    ca, sa = xp.cos(a[..., 2]), xp.sin(a[..., 2])
    x = a[..., 0] + ca * pts[..., 0] - sa * pts[..., 1]
    y = a[..., 1] + sa * pts[..., 0] + ca * pts[..., 1]
    return xp.stack([x, y], axis=-1)


def rotation_matrix(theta):
    """(...,2,2) rotation matrices for angle(s)."""
    xp = _xp(theta)
    c, s = xp.cos(theta), xp.sin(theta)
    return xp.stack(
        [xp.stack([c, -s], axis=-1), xp.stack([s, c], axis=-1)], axis=-2
    )


def identity(shape=(), xp=np):
    return xp.zeros(tuple(shape) + (3,))
