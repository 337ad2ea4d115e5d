"""Dataset ingestion: uniform pull streams of (time, SE2 odom, ranges).

Re-implements the reference's DataProvider hierarchy
(src/sparse_gslam/src/data_provider.cpp:1-334, include/data_provider.h).
Port of sparse_gslam_tpu/io/providers.py; so far only the CARMEN
format, through the Python parser. The other formats (fr079, stanford,
oregon, usc, drone_bag) are listed in ROADMAP.md, queue 1.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class Frame(NamedTuple):
    time: float
    pose: np.ndarray  # (3,) [x, y, theta] raw odometry
    ranges: np.ndarray  # (R,) full-resolution ranges


class DataProvider:
    def frames(self) -> Iterator[Frame]:
        raise NotImplementedError


class CarmenLogDataProvider(DataProvider):
    """CARMEN FLASER parser (data_provider.cpp:14-58).

    FLASER num_readings r_1..r_n x y theta odom_x odom_y odom_theta
    time host logger_time -- odometry pose is fields n+4..n+6; frames
    are sorted by timestamp before replay.
    """

    def __init__(self, path: str):
        data = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0] != "FLASER":
                    continue
                n = int(parts[1])
                ranges = np.array(parts[2 : 2 + n], dtype=np.float64)
                odom = np.array(
                    parts[2 + n + 3 : 2 + n + 6], dtype=np.float64
                )
                time = float(parts[2 + n + 6])
                data.append((time, odom, ranges))
        data.sort(key=lambda d: d[0])
        self._data = data

    def frames(self) -> Iterator[Frame]:
        for t, p, r in self._data:
            yield Frame(t, p, r)


_NOT_PORTED = ("stanford", "fr079", "usc", "drone_bag", "oregon")


def create_data_provider(name: str, path: str) -> DataProvider:
    """Factory (data_provider.cpp:319-334)."""
    if name == "carmen":
        return CarmenLogDataProvider(path)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"data provider {name!r} is not ported yet "
            "(ROADMAP.md, queue 1: providers left out of the first slice)"
        )
    raise ValueError(f"unknown data provider {name!r}")
