"""The frame record and the Python CARMEN parser: a frozen copy of the
Python path of sparse_gslam_tpu_torch/io/providers.py
(CarmenLogDataProvider(path, use_native=False))."""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class Frame(NamedTuple):
    time: float
    pose: np.ndarray  # (3,) [x, y, theta] raw odometry
    ranges: np.ndarray  # (R,) full-resolution ranges


def carmen_frames(path: str) -> Iterator[Frame]:
    """FLASER num_readings r_1..r_n x y theta odom_x odom_y odom_theta
    time host logger_time -- odometry pose is fields n+4..n+6; frames
    sorted by timestamp (a stable sort)."""
    data = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "FLASER":
                continue
            n = int(parts[1])
            ranges = np.array(parts[2 : 2 + n], dtype=np.float64)
            odom = np.array(parts[2 + n + 3 : 2 + n + 6], dtype=np.float64)
            data.append((float(parts[2 + n + 6]), odom, ranges))
    data.sort(key=lambda d: d[0])
    for t, pose, ranges in data:
        yield Frame(t, pose, ranges)
