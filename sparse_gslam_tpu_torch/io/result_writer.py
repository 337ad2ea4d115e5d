"""Trajectory output in the reference's FLASER `.result` format plus the
frontend/backend/dataset timing streams.

Byte-compatible with src/log_runner.cpp:19-34 (write_result_line /
write_result_odom) and :99-107 (.ftime/.btime/.dtime files) so the
reference's eval.sh + metricEvaluator flow and calc_time.py-style
tooling work unchanged on our output. Port of
sparse_gslam_tpu/io/result_writer.py.
"""
from __future__ import annotations

import numpy as np

from ..utils import se2


def write_result_line(f, estimate, time: float):
    x, y, t = float(estimate[0]), float(estimate[1]), float(estimate[2])
    # std::ofstream << std::fixed defaults to 6 decimal places
    f.write(
        f"FLASER 0 {x:.6f} {y:.6f} {t:.6f} {x:.6f} {y:.6f} {t:.6f} "
        f"{time:.6f} myhost {time:.6f}\n"
    )


def write_result_odom(f, base_est, odom_times, odom_dposes):
    """Expand one keyframe into per-scan lines (log_runner.cpp:26-34).

    odom_dposes[0] is the keyframe's raw odom pose (unused beyond its
    timestamp); subsequent entries are relative poses since the keyframe.
    """
    write_result_line(f, base_est, odom_times[0])
    for t, dp in zip(odom_times[1:], odom_dposes[1:]):
        write_result_line(f, se2.compose(base_est, dp), t)


def write_trajectory(path, keyframe_estimates, keyframe_odom,
                     last_opt_pose_index, lm_estimates):
    """Full .result write (log_runner.cpp:258-268).

    keyframe_estimates: (N,3) pose-graph estimates (valid up to
    last_opt_pose_index); keyframe_odom: list of (times, dposes) per
    keyframe; lm_estimates: (N,3) landmark-graph estimates used to
    dead-reckon the tail past the last optimized pose.
    """
    n = len(keyframe_odom)
    with open(path, "w") as f:
        for i in range(min(last_opt_pose_index, n)):
            times, dposes = keyframe_odom[i]
            write_result_odom(f, keyframe_estimates[i], times, dposes)
        if last_opt_pose_index < n:
            base = np.array(
                keyframe_estimates[max(last_opt_pose_index - 1, 0)]
            )
            for i in range(last_opt_pose_index, n):
                delta = se2.relative(
                    lm_estimates[max(i - 1, 0)], lm_estimates[i]
                )
                base = se2.compose(base, delta)
                times, dposes = keyframe_odom[i]
                write_result_odom(f, base, times, dposes)


class TimingWriter:
    """Streams .ftime/.btime/.dtime files (log_runner.cpp:99-107), plus
    the .fflag/.bflag sidecars of the JAX package, which mark ticks that
    contained a compile (one 0/1 line per .ftime/.btime line). The port
    has no compile phase, so its flags are always 0."""

    def __init__(self, prefix: str):
        self.f = open(prefix + ".ftime", "w")
        self.b = open(prefix + ".btime", "w")
        self.d = open(prefix + ".dtime", "w")
        self.ff = open(prefix + ".fflag", "w")
        self.bf = open(prefix + ".bflag", "w")

    def frontend(self, seconds: float):
        self.f.write(f"{seconds:.9f}\n")
        self.ff.write("0\n")

    def backend(self, seconds: float):
        self.b.write(f"{seconds:.9f}\n")
        self.bf.write("0\n")

    def dataset(self, time: float):
        self.d.write(f"{time:.6f}\n")

    def close(self):
        for fh in (self.f, self.b, self.d, self.ff, self.bf):
            fh.flush()
            fh.close()
