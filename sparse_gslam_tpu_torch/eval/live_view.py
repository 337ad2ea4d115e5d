"""Live visualization surface: the Visualizer background thread.

The reference renders 3 occupancy-grid maps + ~12 marker topics at
`visualize_rate` Hz on a background thread while the run progresses
(src/visualizer.cpp:425-441 thread loop, :287-423 snapshot+render).
This is the ROS-free equivalent: a thread that, at `rate` Hz,
snapshots the SLAM state under the system lock (the reference's
copy-then-unlock shared_mutex discipline, visualizer.cpp:301,338),
releases the lock, and renders

- ``<prefix>_live_lm.png``  -- landmark-graph-frame map: re-ray-traced
  occupancy grid + trajectory + landmark segments (the reference's
  ``lm_map`` topic + landmark LINE_LIST markers),
- ``<prefix>_live_pg.png``  -- pose-graph-frame map with accepted loop
  closures drawn pose-to-pose (the ``pose_map`` + closure markers),
- ``<prefix>_live_status.json`` -- counters + current pose (the
  corrected-pose topic, drone.cpp:101-108).

All writes are atomic (tmp + os.replace) so an external watcher (image
viewer, browser auto-refresh) never reads a torn file.

Port of sparse_gslam_tpu/eval/live_view.py with the same snapshot. The
maps are inserted on the system's device (the CUDA kernel on the card,
on a stream of the render thread's own) and written by eval/maps.py's
PNG writer. A render error never ends the run; the thread counts them
in `errors`.
"""
from __future__ import annotations

import json
import os
import threading
import time as _time

import numpy as np
import torch


class LiveVisualizer:
    def __init__(self, system, prefix: str, rate: float = 1.0):
        self.system = system
        self.prefix = prefix
        self.rate = max(rate, 1e-3)
        self._thread = None
        self._running = False
        self.renders = 0  # completed render passes (observability)
        self.errors = 0  # render passes that raised

    # -- lifecycle (visualizer.cpp:425-441) ---------------------------
    def start(self):
        from ..models.slam import side_stream

        self._running = True
        self._stream = side_stream(self.system.device)
        if self._stream is not None:
            self._stream.wait_stream(
                torch.cuda.current_stream(self.system.device))
        self._thread = threading.Thread(target=self._loop,
                                        name="slam-live-view", daemon=True)
        self._thread.start()

    def stop(self, final: bool = True):
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if final:
            self.render_once()  # final frame after the run completes

    def _loop(self):
        from ..models.slam import stream_scope

        period = 1.0 / self.rate
        with stream_scope(self._stream):
            while self._running:
                t0 = _time.perf_counter()
                try:
                    self.render_once()
                except Exception as e:  # never kill the run from the vis
                    self.errors += 1
                    print(f"live_view render error: {e!r}", flush=True)
                dt = _time.perf_counter() - t0
                # paced like the reference: sleep the REMAINDER of the
                # period, in small slices so stop() stays responsive
                remaining = max(period - dt, 0.05)
                while remaining > 0 and self._running:
                    s = min(remaining, 0.1)
                    _time.sleep(s)
                    remaining -= s

    # -- one render pass ----------------------------------------------
    def _snapshot(self):
        """Copy state under the lock, then render lock-free (the
        invariant 'other threads never touch the latest pose'
        (drone.cpp:192-194) means the open keyframe is skipped)."""
        sys_ = self.system
        with sys_.lock:
            fe = sys_.frontend
            n = max(len(fe.keyframes) - 1, 0)
            kfs = list(fe.keyframes[:n])
            lm_est = (
                np.stack([k.estimate for k in kfs])
                if kfs else np.zeros((0, 3))
            )
            landmarks = [
                (lm.start.copy(), lm.end.copy()) for lm in fe.landmarks
            ]
            pg_est = None
            closures = []
            if sys_.backend is not None and sys_.backend.pose_count > 0:
                pg = sys_.backend.pose_estimates()
                pg_est = np.asarray(pg[: len(kfs)])
                closures = [
                    (c.i, c.j)
                    for c in sys_.backend.closures
                    if c.active and not c.suppressed
                    and c.kind == "loop"
                ]
            frame_idx = sys_.frame_idx
            n_lm = len(fe.landmarks)
        return kfs, lm_est, landmarks, pg_est, closures, frame_idx, n_lm

    def render_once(self):
        from .maps import render_map

        (kfs, lm_est, landmarks, pg_est, closures, frame_idx,
         n_lm) = self._snapshot()
        status = {
            "frame": frame_idx,
            "keyframes": len(kfs),
            "landmarks": n_lm,
            "closures": len(closures),
            "renders": self.renders + 1,
            "time": _time.time(),
            "pose": (
                [float(v) for v in lm_est[-1]] if len(lm_est) else None
            ),
        }
        self._atomic_json(f"{self.prefix}_live_status.json", status)
        if len(kfs) == 0:
            self.renders += 1
            return
        device = self.system.device
        probs, origin, res = render_map(kfs, lm_est, device=device)
        self._save_png(
            f"{self.prefix}_live_lm.png", probs, origin, res, lm_est,
            segments=landmarks,
        )
        if pg_est is not None and len(pg_est):
            probs, origin, res = render_map(kfs, pg_est, device=device)
            lines = [
                (pg_est[i][:2], pg_est[j][:2])
                for i, j in closures
                if i < len(pg_est) and j < len(pg_est)
            ]
            self._save_png(
                f"{self.prefix}_live_pg.png", probs, origin, res,
                pg_est, segments=lines, seg_color=(0, 255, 0),
            )
        self.renders += 1

    # -- atomic writers ------------------------------------------------
    def _atomic_json(self, path, obj):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    def _save_png(self, path, probs, origin, res, est, segments=None,
                  seg_color=(31, 119, 180)):
        from .maps import save_map_png

        tmp = path + ".tmp.png"
        save_map_png(tmp, probs, est, origin, res, segments=segments,
                     seg_color=seg_color)
        os.replace(tmp, path)
