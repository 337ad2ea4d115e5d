"""Multi-origin 2D range store.

Numpy re-implementation of the reference's sensor::RangeData2D
(include/cartographer_bindings/range_data_2d.h:12-29,
src/cartographer_bindings/range_data_2d.cc:8-57): a flat point array
with per-scan metadata separating hits (< range_max) from max-range
misses, so grid insertion can ray-trace misses without marking hits.
Port of sparse_gslam_tpu/models/range_data.py.
"""
from __future__ import annotations

import numpy as np

from ..utils import se2


class RangeData2D:
    def __init__(self):
        self.points = np.zeros((0, 2))
        # per scan: (return_end, end) indices into points + origin (2,)
        self.meta = []  # list of (return_end, end, origin)

    def insert_scan(self, ranges, table, range_max, pose=None):
        """Append one scan (range_data_2d.cc:8-27). pose transforms the
        scan into this store's frame (None = identity); hits first, then
        max-range points clamped at range_max."""
        ranges = np.asarray(ranges, dtype=np.float64)
        finite = np.isfinite(ranges)
        hit = finite & (ranges < range_max)
        miss = finite & (ranges >= range_max)
        pts_hit = table[hit] * ranges[hit][:, None]
        pts_miss = table[miss] * range_max
        if pose is not None:
            pts_hit = se2.apply(pose, pts_hit)
            pts_miss = se2.apply(pose, pts_miss)
            origin = np.asarray(pose[:2], dtype=np.float64).copy()
        else:
            origin = np.zeros(2)
        base = len(self.points)
        self.points = np.concatenate([self.points, pts_hit, pts_miss])
        self.meta.append(
            (base + len(pts_hit), base + len(pts_hit) + len(pts_miss), origin)
        )

    def transform_into(self, pose, out: "RangeData2D"):
        """Append a transformed copy into `out` (range_data_2d.cc:29-41).

        Note the reference translates each scan origin but does not
        rotate it (meta.origin += trans); replicated bug-for-bug since
        ray origins feed grid insertion.
        """
        base = len(out.points)
        out.points = np.concatenate(
            [out.points, se2.apply(pose, self.points)]
        )
        for re_, e_, o in self.meta:
            out.meta.append((re_ + base, e_ + base, o + pose[:2]))

    def returns(self) -> np.ndarray:
        """Hit points only (range_data_2d.cc:43-52)."""
        out = []
        i = 0
        for re_, e_, _ in self.meta:
            out.append(self.points[i:re_])
            i = e_
        if not out:
            return np.zeros((0, 2))
        return np.concatenate(out)


def construct_multicloud(poses_data, estimates, start, mid, end,
                         returns_only=False):
    """Accumulate keyframe range stores [start, end) re-centered on
    keyframe `mid` (pose_with_observation.cpp:14-38).

    poses_data: list of RangeData2D per keyframe; estimates: (N,3).
    Returns RangeData2D, or (M,2) points if returns_only.
    """
    mid_inv = se2.inverse(estimates[mid])
    if returns_only:
        pts = []
        for i in range(start, end):
            rel = se2.compose(mid_inv, estimates[i])
            r = poses_data[i].returns()
            if len(r):
                pts.append(se2.apply(rel, r))
        if not pts:
            return np.zeros((0, 2))
        return np.concatenate(pts)
    out = RangeData2D()
    for i in range(start, end):
        rel = se2.compose(mid_inv, estimates[i])
        poses_data[i].transform_into(rel, out)
    return out
