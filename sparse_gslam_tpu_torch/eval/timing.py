"""Timing-file analysis: the calc_time.py equivalent (reference:
datasets/calc_time.py:13-49) computing the paper Table II metrics from
.ftime/.btime/.dtime streams.

The JAX package's runner also writes .fflag/.bflag sidecars (one 0/1
line per timing line) marking ticks that contained an XLA compile; when
present, analyze() also reports steady-state (compile-free) mean/max
and the total time spent in compile-containing ticks. The port has no
compile phase: its runner (io/result_writer.TimingWriter) writes no
sidecars, which reads as all zero, so on a port run the steady columns
equal the raw ones, as they do for the reference. Port of
sparse_gslam_tpu/eval/timing.py; reads the files of either package.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class TimingStats:
    mean_data_interval: float
    max_frontend: float
    mean_frontend: float
    max_backend: float
    mean_backend: float
    mean_total_per_frame: float
    # steady-state (ticks with no XLA compile); fall back to the raw
    # numbers when no .fflag/.bflag sidecars exist
    steady_mean_frontend: float = 0.0
    steady_max_frontend: float = 0.0
    steady_mean_backend: float = 0.0
    steady_max_backend: float = 0.0
    steady_mean_total_per_frame: float = 0.0
    compile_tick_total: float = 0.0  # sum of compile-containing ticks
    n_compile_ticks: int = 0

    def __str__(self):
        s = (
            f"interval {self.mean_data_interval:.3f}s | frontend mean "
            f"{self.mean_frontend * 1e3:.2f}ms max "
            f"{self.max_frontend * 1e3:.1f}ms | backend mean "
            f"{self.mean_backend * 1e3:.2f}ms max "
            f"{self.max_backend * 1e3:.1f}ms | total/frame "
            f"{self.mean_total_per_frame * 1e3:.2f}ms"
        )
        if self.n_compile_ticks:
            s += (
                f" | steady frontend {self.steady_mean_frontend * 1e3:.2f}"
                f"/{self.steady_max_frontend * 1e3:.1f}ms backend "
                f"{self.steady_mean_backend * 1e3:.2f}"
                f"/{self.steady_max_backend * 1e3:.1f}ms | compile "
                f"{self.compile_tick_total:.1f}s in "
                f"{self.n_compile_ticks} ticks"
            )
        return s


def _load_flags(path: str, n: int):
    """0/1 compile flags aligned to a timing stream; all-False if the
    sidecar is absent or mismatched (old files)."""
    if not os.path.exists(path):
        return np.zeros(n, bool)
    flags = np.loadtxt(path, ndmin=1).astype(bool)
    if len(flags) != n:
        return np.zeros(n, bool)
    return flags


def analyze(prefix: str) -> TimingStats:
    """prefix: path without extension (like <dir>/<dataset>)."""
    ftime = np.loadtxt(prefix + ".ftime", ndmin=1)
    try:
        btime = np.loadtxt(prefix + ".btime", ndmin=1)
    except Exception:
        btime = np.zeros(1)
    dtime = np.loadtxt(prefix + ".dtime", ndmin=1)
    if len(btime) == 0:
        btime = np.zeros(1)
    fflag = _load_flags(prefix + ".fflag", len(ftime))
    bflag = _load_flags(prefix + ".bflag", len(btime))
    n_frames = max(len(dtime), 1)
    total = ftime.sum() + btime.sum()

    fsteady = ftime[~fflag] if len(ftime) else ftime
    bsteady = btime[~bflag]
    if len(fsteady) == 0:
        fsteady = ftime
    if len(bsteady) == 0:
        bsteady = btime
    n_compile = int(fflag.sum() + bflag.sum())
    compile_total = float(ftime[fflag].sum() + btime[bflag].sum())
    # steady per-frame total: scale each stream's steady mean by its
    # event count (compile ticks replaced by a steady-cost tick)
    steady_total = (
        float(fsteady.mean()) * len(ftime) + float(bsteady.mean()) * len(btime)
        if len(ftime)
        else 0.0
    )
    return TimingStats(
        mean_data_interval=float(np.diff(dtime).mean())
        if len(dtime) > 1
        else 0.0,
        max_frontend=float(ftime.max()) if len(ftime) else 0.0,
        mean_frontend=float(ftime.mean()) if len(ftime) else 0.0,
        max_backend=float(btime.max()),
        mean_backend=float(btime.mean()),
        mean_total_per_frame=float(total / n_frames),
        steady_mean_frontend=float(fsteady.mean()) if len(fsteady) else 0.0,
        steady_max_frontend=float(fsteady.max()) if len(fsteady) else 0.0,
        steady_mean_backend=float(bsteady.mean()),
        steady_max_backend=float(bsteady.max()),
        steady_mean_total_per_frame=float(steady_total / n_frames),
        compile_tick_total=compile_total,
        n_compile_ticks=n_compile,
    )
