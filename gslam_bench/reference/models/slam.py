"""Full SLAM system orchestration: the log_runner per-frame loop
(src/log_runner.cpp:109-174 callback) + Drone-level wiring.

Per frame: accumulate odometry delta -> beam-subsample the full scan
(log_runner.cpp:130-143) -> multicloud window update -> line extraction
-> frontend tick; every match_interval frames the backend precompute +
match runs (models/backend.py). Timing of the frontend and backend calls
streams to .ftime/.btime like the reference (log_runner.cpp:146-158).
Frozen copy of sparse_gslam_tpu_torch/models/slam.py without its
realtime mode and result writer.
"""
from __future__ import annotations

import threading
import time as _time

import numpy as np
import torch

from ..io.providers import Frame
from ..ops.lines import extract_lines_any
from ..ops.multicloud import MulticloudConverter
from ..utils import se2
from ..utils.config import ExtractorConfig, SlamConfig
from .frontend import Frontend


class SlamSystem:
    def __init__(self, config: SlamConfig, ls_params: ExtractorConfig,
                 enable_backend: bool = True, device="cuda"):
        self.config = config
        self.ls_params = ls_params
        self.device = torch.device(device)
        self.mc = MulticloudConverter(config)
        self.frontend = Frontend(config, device=self.device)
        self.backend = None
        if enable_backend:
            from .backend import SubmapLoopCloser

            self.backend = SubmapLoopCloser(config, self.frontend,
                                            device=self.device)
        self.deltas: list[np.ndarray] = []
        self.zero_pose = np.zeros(3)
        self.last_pose = None
        self.last_time = None
        self.frame_idx = 0
        self.timing = None  # optional TimingWriter
        self.frontend_times: list[float] = []
        self.backend_times: list[float] = []
        # graph lock for the simulated-realtime mode: the reference
        # protects its two graphs with shared mutexes
        # (include/graphs.h:21,32); functional state needs only mutual
        # exclusion between the frontend tick and the backend snapshot
        self.lock = threading.Lock()
        # what the last run_realtime measured (RealtimeStats)
        self.realtime = None

    # ------------------------------------------------------------------
    def _subsample(self, full_range: np.ndarray):
        """Beam subsampling full -> scan_size (log_runner.cpp:128-143).

        Returns (ranges (S,), table (S,2) cos/sin)."""
        cfg = self.config
        S = cfg.scan_size
        full_size = len(full_range)
        if S == full_size:
            angles = cfg.angle_min + (
                (cfg.angle_max - cfg.angle_min) / (full_size - 1)
            ) * np.arange(full_size)
            return (
                np.asarray(full_range, dtype=np.float64),
                np.stack([np.cos(angles), np.sin(angles)], 1),
            )
        increment = full_size // (S - 1)
        full_increment = (cfg.angle_max - cfg.angle_min) / (full_size - 1)
        idx = np.arange(S - 1) * increment
        ranges = np.minimum(full_range[idx], cfg.range_max)
        angles = cfg.angle_min + full_increment * idx
        ranges = np.append(ranges, full_range[-1])
        angles = np.append(angles, cfg.angle_max)
        return ranges, np.stack([np.cos(angles), np.sin(angles)], 1)

    # ------------------------------------------------------------------
    def process_frame(self, frame: Frame) -> None:
        """One driver callback (log_runner.cpp:109-174)."""
        cfg = self.config
        cur_pose = np.asarray(frame.pose, dtype=np.float64)
        if self.last_pose is not None:
            delta = se2.relative(self.last_pose, cur_pose)
            self.zero_pose = se2.compose(self.zero_pose, delta)
            self.deltas.append(delta)
        self.last_pose = cur_pose
        self.last_time = frame.time

        ranges, table = self._subsample(np.asarray(frame.ranges))
        self.mc.set_table(table)
        mc_out = self.mc.update(ranges, self.deltas, self.zero_pose)
        if mc_out is not None:
            t0 = _time.perf_counter()
            segments = extract_lines_any(
                mc_out.points, mc_out.covs, self.ls_params
            )
            self.frontend.tick(
                segments, frame.time, self.zero_pose, ranges, table=table
            )
            ft = _time.perf_counter() - t0
            self.frontend_times.append(ft)
            if self.timing:
                self.timing.frontend(ft)

            if self.backend and self.frame_idx % cfg.match_interval == 0:
                t0 = _time.perf_counter()
                self.backend.precompute()
                self.backend.match()
                bt = _time.perf_counter() - t0
                self.backend_times.append(bt)
                if self.timing:
                    self.timing.backend(bt)
        if self.timing:
            self.timing.dataset(frame.time)
        self.frame_idx += 1

    # ------------------------------------------------------------------
    def final_cleanup(self):
        """Final re-match at min_score=0.5 + chi2 closure pruning + final
        pose-graph optimization (log_runner.cpp:176-206), then
        final_refine_rounds of backend.refine_map, then with final_joint
        the joint landmark + pose solve (backend.joint_solve); a no-op
        without a backend."""
        if self.backend is None:
            return
        self.backend.loop_closure_min_score = 0.5
        self.backend.precompute()
        self.backend.match()
        # pull the chain to the last keyframe so tail-of-run local
        # refinement edges participate in the final optimization
        self.backend.extend_chain()
        if self.config.final_rematch:
            # global re-match sweep: anchor density is the dominant
            # remaining ATE term (see backend.rematch_all)
            self.backend.rematch_all()
        self.backend.prune_false_closures()
        self.backend.optimize(
            iterations=self.config.final_opt_iterations,
            gnc_scale=self.config.final_gnc_scale,
        )
        if self.config.final_refine_rounds > 0:
            # rebuild grids at the optimized poses and re-measure every
            # closure: match-time stitching distortion is the dominant
            # closure error term (backend.refine_map)
            self.backend.refine_map(
                rounds=self.config.final_refine_rounds,
                iterations=self.config.final_opt_iterations,
                gnc_scale=self.config.final_gnc_scale,
            )
            self.backend.prune_false_closures()
            self.backend.optimize(
                iterations=self.config.final_opt_iterations,
                gnc_scale=self.config.final_gnc_scale,
            )
        if self.config.final_joint:
            # joint landmark + pose bundle adjustment over all original
            # measurements; re-run the chi2 prune against the joint
            # solution and re-solve if any closure fell
            if self.backend.joint_solve():
                if self.backend.prune_false_closures():
                    self.backend.joint_solve()
