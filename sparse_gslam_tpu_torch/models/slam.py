"""Full SLAM system orchestration: the log_runner per-frame loop
(src/log_runner.cpp:109-174 callback) + Drone-level wiring.

Per frame: accumulate odometry delta -> beam-subsample the full scan
(log_runner.cpp:130-143) -> multicloud window update -> line extraction
-> frontend tick; every match_interval frames the backend precompute +
match runs (models/backend.py). Timing of the frontend and backend calls
streams to .ftime/.btime like the reference (log_runner.cpp:146-158).
Port of sparse_gslam_tpu/models/slam.py, with its simulated-realtime
mode (run_realtime: the frontend paced by the frame timestamps, the
backend on a thread of its own; on the card each thread launches on a
CUDA stream of its own).
"""
from __future__ import annotations

import contextlib
import threading
import time as _time

import numpy as np
import torch

from ..io.providers import Frame
from ..ops.lines import extract_lines_any
from ..ops.multicloud import MulticloudConverter
from ..utils import se2
from ..utils.config import ExtractorConfig, SlamConfig
from ..utils.trace import Recorder
from .frontend import Frontend


class SlamSystem:
    def __init__(self, config: SlamConfig, ls_params: ExtractorConfig,
                 enable_backend: bool = True, device="cuda",
                 accel_branch: bool = False):
        """accel_branch: the backend takes the JAX package's accelerator
        branch (models/backend.py) on `device`, whatever it is."""
        self.config = config
        self.ls_params = ls_params
        self.device = torch.device(device)
        # spans and counters of this system (utils/trace.py); the caller
        # sets rec.enabled to record spans
        self.rec = Recorder()
        self.mc = MulticloudConverter(config)
        self.frontend = Frontend(config, device=self.device, rec=self.rec)
        self.backend = None
        if enable_backend:
            from .backend import SubmapLoopCloser

            self.backend = SubmapLoopCloser(config, self.frontend,
                                            device=self.device,
                                            accel_branch=accel_branch,
                                            rec=self.rec)
        self.deltas: list[np.ndarray] = []
        self.zero_pose = np.zeros(3)
        self.last_pose = None
        self.last_time = None
        self.frame_idx = 0
        self.timing = None  # optional TimingWriter
        # seconds of each slam.frontend.tick and slam.backend.tick span
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
        """One log_runner frame callback (log_runner.cpp:109-174): the
        span slam.frame."""
        rec = self.rec
        rec.frame = self.frame_idx
        with rec.span("slam.frame"):
            self._process_frame(frame)
        self.frame_idx += 1

    def _process_frame(self, frame: Frame) -> None:
        cfg = self.config
        rec = self.rec
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
            # the tick's time takes in the extraction, as the
            # reference's frontend time does
            with rec.timed("slam.frontend.tick") as t:
                with rec.span("slam.extract"):
                    segments = extract_lines_any(
                        mc_out.points, mc_out.covs, self.ls_params
                    )
                self.frontend.tick(
                    segments, frame.time, self.zero_pose, ranges,
                    table=table,
                )
            self.frontend_times.append(t.seconds)
            if self.timing:
                self.timing.frontend(t.seconds)

            if self.backend and self.frame_idx % cfg.match_interval == 0:
                with rec.timed("slam.backend.tick") as t:
                    self.backend.precompute()
                    self.backend.match()
                self.backend_times.append(t.seconds)
                if self.timing:
                    self.timing.backend(t.seconds)
        if self.timing:
            self.timing.dataset(frame.time)

    # ------------------------------------------------------------------
    def run_realtime(self, frames, rate: float = 1.0):
        """Simulated-realtime replay (log_runner.cpp:214-239): the
        frontend paces itself by dataset timestamps / rate while a
        free-running backend thread computes loop closures every 10 ms,
        then final_cleanup.

        The backend thread calls precompute() under self.lock, then
        match(lock=self.lock), which holds the lock only for its snapshot
        and apply phases. On a CUDA device the backend thread launches
        on a stream of its own, so that the frontend's once-per-iteration
        host reads do not wait for its insertions, refinements and
        solves; what it hands the frontend under the lock is numpy.
        final_cleanup runs on that stream as well (the submap grids were
        made there), after the frontend's stream, and the caller's
        stream waits for it. An exception in the backend thread ends the
        frame loop and is raised here. What the run measured is left in
        self.realtime (RealtimeStats)."""
        backend = self.backend
        stream = side_stream(self.device)
        caller = (torch.cuda.current_stream(self.device)
                  if stream is not None else None)
        stats = RealtimeStats(rate=rate)
        self.realtime = stats
        running = True
        failure = []

        def lc_loop():
            try:
                with stream_scope(stream):
                    while running:
                        if backend is not None:
                            # precompute snapshots under the lock; match()
                            # takes the lock only for its snapshot and
                            # apply phases
                            with self.rec.timed("slam.backend.tick") as tk:
                                with self.lock:
                                    backend.precompute()
                                backend.match(lock=self.lock)
                            stats.backend_ticks.append(tk.seconds)
                        _time.sleep(0.01)
            except Exception as e:  # raised again by the frame loop
                failure.append(e)

        t = threading.Thread(target=lc_loop, name="slam-backend",
                             daemon=True)
        if stream is not None:
            stream.wait_stream(caller)  # e.g. grids rebuilt by a resume
        t.start()
        prev_time = None
        t_start = first_time = None
        try:
            for frame in frames:
                if failure:
                    break
                t0 = _time.perf_counter()
                if t_start is None:
                    t_start, first_time = t0, frame.time
                stats.note_frame(t0 - t_start, (frame.time - first_time)
                                 / rate, None if prev_time is None
                                 else (frame.time - prev_time) / rate)
                with self.lock:
                    # frontend only: the backend runs on its own thread
                    self.backend = None
                    try:
                        self.process_frame(frame)
                    finally:
                        self.backend = backend
                if prev_time is not None:
                    sleep = (frame.time - prev_time) / rate - (
                        _time.perf_counter() - t0
                    )
                    if sleep > 0:
                        _time.sleep(sleep)
                prev_time = frame.time
        finally:
            running = False
            t.join()
        if failure:
            raise failure[0]
        with stream_scope(stream):
            if stream is not None:
                stream.wait_stream(caller)
            self.final_cleanup()
        if stream is not None:
            caller.wait_stream(stream)

    # ------------------------------------------------------------------
    def final_cleanup(self):
        """Final re-match at min_score=0.5 + chi2 closure pruning + final
        pose-graph optimization (log_runner.cpp:176-206), then
        final_refine_rounds of backend.refine_map, then with final_joint
        the joint landmark + pose solve (backend.joint_solve); a no-op
        without a backend."""
        if self.backend is None:
            return
        with self.rec.span("slam.cleanup"):
            self._final_cleanup()

    def _final_cleanup(self):
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

    # ------------------------------------------------------------------
    def write_result(self, path: str):
        from ..io.result_writer import write_trajectory

        lm_est = self.frontend.estimates()
        odom = [
            (k.odom_times, k.odom_dposes) for k in self.frontend.keyframes
        ]
        if self.backend is not None and self.backend.pose_count > 0:
            pg = self.backend.pose_estimates()
            last_opt = self.backend.last_opt_pose_index
            # pad pose-graph estimates to keyframe count for the API
            est = np.concatenate([pg, lm_est[len(pg) :]])
        else:
            est, last_opt = lm_est, len(lm_est)
        write_trajectory(path, est, odom, last_opt, lm_est)


def steady_stats(times):
    """(mean, max, n) over frontend or backend ticks. The port has no
    compile phase, so every tick counts as steady state."""
    if not times:
        return 0.0, 0.0, 0
    a = np.asarray(times)
    return float(a.mean()), float(a.max()), len(times)


def side_stream(device):
    """A CUDA stream of `device` for a thread of its own, or None on the
    CPU. Both kernels are built first, so that no thread waits inside a
    paced loop for a first nvcc build."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    from ..ops import grid_cuda, refine_cuda

    grid_cuda.load()
    refine_cuda.load()
    return torch.cuda.Stream(device)


def stream_scope(stream):
    """torch.cuda.stream(stream) for the calling thread, or nothing for
    None (the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


class RealtimeStats:
    """What one run_realtime measured: per frame the lag of its start
    behind its paced time (its timestamp less the first one's, over
    rate, from the first frame's start) and whether it was late (the lag
    above one period, the gap to the previous timestamp over rate); the
    seconds of each completed backend tick (precompute + match)."""

    def __init__(self, rate: float):
        self.rate = rate
        self.lags: list[float] = []
        self.late = 0
        self.backend_ticks: list[float] = []

    def note_frame(self, started: float, due: float, period):
        lag = started - due
        self.lags.append(lag)
        if period is not None and lag > period:
            self.late += 1

    @property
    def frames(self) -> int:
        return len(self.lags)
