"""Dataset ingestion: uniform pull streams of (time, SE2 odom, ranges).

Re-implements the reference's DataProvider hierarchy
(src/sparse_gslam/src/data_provider.cpp:1-334, include/data_provider.h).
Port of sparse_gslam_tpu/io/providers.py for the six supported log
formats:

  carmen    CARMEN/Radish FLASER lines, globally sorted by time
  fr079     ODOM+FLASER with velocity-integrated odometry
  stanford  stanford-gates "position"/"laser" pairs
  oregon    intel-oregon variant of the stanford format
  usc       USC SAL format
  drone_bag rosbag v2 with two Crazyflie RawData telemetry streams

CARMEN logs go through the C++ parser (io/native.py
parse_carmen_native) by default, as in the JAX package; use_native=False
selects the Python parser, which gives the same frames.
"""
from __future__ import annotations

import math
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
    are sorted by timestamp before replay (a stable sort). use_native
    (the default) parses with the C++ loader, csrc/carmen_parser.cpp,
    and raises if it cannot be built or fails; use_native=False parses
    in Python.
    """

    def __init__(self, path: str, use_native: bool = True):
        self._native = None
        if use_native:
            from .native import parse_carmen_native

            try:
                self._native = parse_carmen_native(path)
            except (OSError, RuntimeError) as e:
                raise RuntimeError(
                    f"the C++ CARMEN parser failed on {path} ({e}); "
                    "CarmenLogDataProvider(path, use_native=False) parses "
                    "in Python") from e
            return
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
        if self._native is not None:
            times, poses, ranges, offsets = self._native
            for i in range(len(times)):
                yield Frame(
                    float(times[i]), poses[i],
                    ranges[offsets[i] : offsets[i + 1]],
                )
            return
        for t, p, r in self._data:
            yield Frame(t, p, r)


class FR079DataProvider(DataProvider):
    """ODOM+FLASER velocity integration (data_provider.cpp:60-116)."""

    def __init__(self, path: str):
        self.path = path

    def frames(self) -> Iterator[Frame]:
        last_pose = np.zeros(3)
        last_tv = last_rv = 0.0
        last_time = None
        with open(self.path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "ODOM":
                    tv, rv = float(parts[4]), float(parts[5])
                    time = float(parts[7])
                    if last_time is not None:
                        dL = (time - last_time) * last_tv
                        # the reference scales rv by 1000 on ODOM lines
                        # (data_provider.cpp:84) -- replicate
                        th = last_pose[2] + (time - last_time) * last_rv * 1000
                        last_pose = np.array(
                            [
                                last_pose[0] + math.cos(th) * dL,
                                last_pose[1] + math.sin(th) * dL,
                                th,
                            ]
                        )
                    last_tv, last_rv, last_time = tv, rv, time
                elif parts[0] == "FLASER" and last_time is not None:
                    n = int(parts[1])
                    ranges = np.array(parts[2 : 2 + n], dtype=np.float64)
                    time = float(parts[2 + n + 6])
                    dL = (time - last_time) * last_tv
                    th = last_pose[2] + (time - last_time) * last_rv
                    pose = np.array(
                        [
                            last_pose[0] + math.cos(th) * dL,
                            last_pose[1] + math.sin(th) * dL,
                            th,
                        ]
                    )
                    yield Frame(time, pose, ranges)


class StanfordLogDataProvider(DataProvider):
    """stanford-gates format (data_provider.cpp:118-165).

    Lines: "<junk> <junk> <junk> position <junk> <junk> x y theta ..."
    and ".. laser <junk> time <4 junk> 181x (range junk)".
    """

    n_beams = 181
    laser_extra_cols = 1  # values interleaved after each range
    laser_start = 10  # stanford skips 4 extra tokens after the time

    def __init__(self, path: str):
        self.path = path

    def frames(self) -> Iterator[Frame]:
        last_pose = None
        with open(self.path) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                if len(parts) < 4:
                    continue
                kind = parts[3]
                if kind == "position":
                    last_pose = np.array(parts[6:9], dtype=np.float64)
                elif kind == "laser" and last_pose is not None:
                    time = float(parts[5])
                    stride = 1 + self.laser_extra_cols
                    vals = parts[
                        self.laser_start : self.laser_start
                        + self.n_beams * stride
                    ]
                    ranges = np.array(vals[::stride], dtype=np.float64)
                    pose, last_pose = last_pose, None
                    yield Frame(time, pose, ranges)


class IntelOregonLogDataProvider(StanfordLogDataProvider):
    """intel-oregon variant: 2 extra columns per beam, no 4-token skip
    after the timestamp (data_provider.cpp:167-211)."""

    laser_extra_cols = 2
    laser_start = 6


class USCDataProvider(DataProvider):
    """USC SAL format (data_provider.cpp:213-248)."""

    def __init__(self, path: str):
        self.path = path

    def frames(self) -> Iterator[Frame]:
        last_pose = np.zeros(3)
        with open(self.path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "position":
                    last_pose = np.array(parts[3:6], dtype=np.float64)
                elif parts[0] == "laser":
                    time = float(parts[2])
                    vals = parts[3 : 3 + 181 * 3]
                    ranges = np.array(vals[::3], dtype=np.float64)
                    yield Frame(time, last_pose.copy(), ranges)


class ROSBagDataProvider(DataProvider):
    """Crazyflie telemetry rosbag (data_provider.cpp:266-317).

    Approximate-time-syncs /crazyflie2/state_xyzv (x, y, ...) with
    /crazyflie2/state_ranger_qxyzw (4 ranges + quaternion) and yields
    4-beam frames, using a pure-python rosbag v2 reader (io.rosbag).
    """

    def __init__(self, path: str):
        from .rosbag import read_rawdata_bag

        self._data = read_rawdata_bag(path)

    def frames(self) -> Iterator[Frame]:
        for t, pose, ranges in self._data:
            yield Frame(t, pose, ranges)


def create_data_provider(name: str, path: str) -> DataProvider:
    """Factory (data_provider.cpp:319-334)."""
    providers = {
        "carmen": CarmenLogDataProvider,
        "stanford": StanfordLogDataProvider,
        "fr079": FR079DataProvider,
        "usc": USCDataProvider,
        "drone_bag": ROSBagDataProvider,
        "oregon": IntelOregonLogDataProvider,
    }
    if name not in providers:
        raise ValueError(f"unknown data provider {name!r}")
    return providers[name](path)
