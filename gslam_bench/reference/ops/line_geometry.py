"""Polar-line geometry shared by the extractor and the landmark graph.

Functional equivalents of the reference's header-template utilities
(src/ls_extractor/include/ls_extractor/utils.h:23-102). All functions
are array-polymorphic (numpy arrays or torch tensors) and batch over
leading dims, so the same code serves the host frontend and the device
solver. Port of sparse_gslam_tpu/ops/line_geometry.py.

A line is parameterized as (rho, theta): the set of points p with
p . [cos theta, sin theta] = rho, normalized so rho >= 0.
"""
from __future__ import annotations

import numpy as np

from ..utils.se2 import _xp, wrap_angle


def check_rhotheta(rhotheta):
    """Normalize rho >= 0 (utils.h:23-30 checkRhoTheta).

    The reference adds pi to theta and wraps once past +pi; starting from
    theta in (-pi, pi] this equals standard angle wrapping.
    """
    xp = _xp(rhotheta)
    rho, theta = rhotheta[..., 0], rhotheta[..., 1]
    neg = rho < 0
    rho = xp.where(neg, -rho, rho)
    theta = xp.where(neg, wrap_angle(theta + np.pi), theta)
    return xp.stack([rho, theta], axis=-1)


def transform_line(rhotheta, trans, angle):
    """Apply SE2 (trans, angle) to line(s) (utils.h:32-45).

    Returns the line expressed in the frame that the transform maps TO
    (i.e. the same convention as the reference: used with pose^-1 to map
    a world line into the body frame, edge_se2_rhotheta.cpp:9-16).
    """
    xp = _xp(rhotheta, trans)
    theta = wrap_angle(rhotheta[..., 1] + angle)
    normal = xp.stack([xp.cos(theta), xp.sin(theta)], axis=-1)
    rho = rhotheta[..., 0] + (trans * normal).sum(-1)
    return check_rhotheta(xp.stack([rho, theta], axis=-1))


def topolar(start, end):
    """(rho, theta) of the line through two points (utils.h:47-54)."""
    xp = _xp(start, end)
    d = start - end
    theta = xp.arctan2(-d[..., 0], d[..., 1])
    rho = start[..., 0] * xp.cos(theta) + start[..., 1] * xp.sin(theta)
    return check_rhotheta(xp.stack([rho, theta], axis=-1))


def calc_start_dir(rhotheta):
    """Foot point + unit direction of a line (utils.h:56-61)."""
    xp = _xp(rhotheta)
    c, s = xp.cos(rhotheta[..., 1]), xp.sin(rhotheta[..., 1])
    start = rhotheta[..., 0:1] * xp.stack([c, s], axis=-1)
    direction = xp.stack([-s, c], axis=-1)
    return start, direction


def calc_endpoints_t(rhotheta, p1, p2):
    """Sorted parameters (t0, t1) of two points projected on a line
    (utils.h:82-102 calc_endpoints)."""
    xp = _xp(rhotheta, p1)
    start, direction = calc_start_dir(rhotheta)
    t0 = ((p1 - start) * direction).sum(-1)
    t1 = ((p2 - start) * direction).sum(-1)
    return xp.minimum(t0, t1), xp.maximum(t0, t1)


def ll_distance(rhotheta, p1, p2):
    """Line-to-segment error + sorted projections (utils.h:63-80).

    error = sum of perpendicular distances of the segment endpoints
    (p1, p2) to the line; used by data association (drone.cpp:227).
    Returns (error, tmin, tmax).
    """
    xp = _xp(rhotheta, p1)
    start, direction = calc_start_dir(rhotheta)
    d1 = p1 - start
    d2 = p2 - start
    t1 = (d1 * direction).sum(-1)
    t2 = (d2 * direction).sum(-1)
    r1 = d1 - t1[..., None] * direction
    r2 = d2 - t2[..., None] * direction
    err = xp.sqrt((r1 * r1).sum(-1)) + xp.sqrt((r2 * r2).sum(-1))
    return err, xp.minimum(t1, t2), xp.maximum(t1, t2)


def point_line_distance(rhotheta_pts, rhotheta_line):
    """|rho_p cos(theta_p - theta_l) - rho_l| for points in polar form
    (defs.h:36-38 _LineSegment::distToPoint)."""
    xp = _xp(rhotheta_pts, rhotheta_line)
    return xp.abs(
        rhotheta_pts[..., 0]
        * xp.cos(rhotheta_pts[..., 1] - rhotheta_line[..., 1])
        - rhotheta_line[..., 0]
    )
