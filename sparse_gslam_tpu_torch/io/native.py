"""The native C++ layer through ctypes: the float64 pose-graph
Gauss-Newton solver (the oracle of the port's pose-graph solvers and
their CPU baseline), the reference-style branch-and-bound correlative
matcher and its thread-pool fan-out (the CPU baseline beside the FFT
matchers, and their independent oracle), and the CARMEN log parser
(io/providers.py CarmenLogDataProvider's default ingestion).

The dependency-free sources csrc/posegraph_solver.cpp,
csrc/correlative_matcher.cpp and csrc/carmen_parser.cpp are compiled
with g++ at first use into sparse_gslam_tpu_torch/_build/ (gitignored),
each cached by a hash of its source and flags. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ..ops.grid_cuda import build_library

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
SOURCE = os.path.join(_CSRC, "posegraph_solver.cpp")
MATCHER_SOURCE = os.path.join(_CSRC, "correlative_matcher.cpp")
CARMEN_SOURCE = os.path.join(_CSRC, "carmen_parser.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

def build(source: str = SOURCE, stem: str = "posegraph") -> str:
    """Compile a library if its cached build is missing; its path."""
    return build_library(source, GXX_FLAGS, stem, compiler="g++")["path"]


@functools.lru_cache(maxsize=None)
def _posegraph_lib():
    lib = ctypes.CDLL(build())
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.posegraph_gn_optimize.argtypes = [
        i32, vp, vp, vp, vp, vp, i32, vp, vp, vp, vp, vp,
        ctypes.c_double, i32,
    ]
    lib.posegraph_gn_optimize.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _matcher_lib():
    lib = ctypes.CDLL(build(MATCHER_SOURCE, "matcher"))
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.correlative_match.argtypes = [
        vp, i32, f64, f64, f64, vp, i32, f64, f64, i32, i32, i32, f64, vp]
    lib.correlative_match.restype = i32
    lib.correlative_match_many.argtypes = [
        vp, i32, i32, vp, f64, vp, i32, vp, f64, i32, i32, i32, f64, i32,
        vp]
    lib.correlative_match_many.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _carmen_lib():
    lib = ctypes.CDLL(build(CARMEN_SOURCE, "carmen"))
    vp = ctypes.c_void_p
    lib.carmen_parse.argtypes = [ctypes.c_char_p]
    lib.carmen_parse.restype = vp
    lib.carmen_num_frames.argtypes = [vp]
    lib.carmen_num_frames.restype = ctypes.c_longlong
    lib.carmen_num_ranges.argtypes = [vp]
    lib.carmen_num_ranges.restype = ctypes.c_longlong
    lib.carmen_copy.argtypes = [vp] * 5
    lib.carmen_copy.restype = None
    lib.carmen_free.argtypes = [vp]
    lib.carmen_free.restype = None
    return lib


def _host(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def posegraph_gn_native(g, phi: float, iterations: int) -> np.ndarray:
    """Run the C++ GN solver on a PoseGraphData (torch tensors on any
    device, or numpy arrays); returns float64 poses (N, 3).

    Same semantics as ops.solvers.optimize_pose_graph."""
    fn = _posegraph_lib().posegraph_gn_optimize

    poses = _host(g.poses, np.float64).copy()
    n = len(poses)
    cm = _host(g.chain_meas, np.float64)
    ci = _host(g.chain_info, np.float64)
    cv = _host(g.chain_valid, np.uint8)
    fx = _host(_host(g.fixed, bool) | ~_host(g.valid, bool), np.uint8)
    cloi = _host(g.clo_i, np.int32)
    cloj = _host(g.clo_j, np.int32)
    clom = _host(g.clo_meas, np.float64)
    cloinf = _host(g.clo_info, np.float64)
    clov = _host(g.clo_valid, np.uint8)
    if not (cm.shape == (n, 3) and ci.shape == (n, 3, 3) and cv.shape == (n,)
            and fx.shape == (n,) and clom.shape == (len(cloi), 3)
            and cloinf.shape == (len(cloi), 3, 3)
            and cloj.shape == clov.shape == (len(cloi),)):
        raise ValueError("pose graph arrays disagree in shape")
    if len(cloi) and not (0 <= min(cloi.min(), cloj.min())
                          and max(cloi.max(), cloj.max()) < n):
        raise ValueError("closure endpoint out of range")

    p = _ptr
    rc = fn(
        ctypes.c_int(n), p(poses), p(cm), p(ci), p(cv), p(fx),
        ctypes.c_int(len(cloi)), p(cloi), p(cloj), p(clom), p(cloinf),
        p(clov), ctypes.c_double(phi), ctypes.c_int(iterations),
    )
    if rc != 0:
        raise RuntimeError(f"native solver failed rc={rc}")
    return poses


def correlative_match_native(
    probs, origin, resolution: float, points, init_theta: float,
    angular_step: float, n_angular: int, n_linear: int, depth: int,
    min_score: float,
):
    """Reference-style branch-and-bound matcher on one submap
    (csrc/correlative_matcher.cpp): the (size, size) probability grid
    `probs` (0 = unknown) with its cell (0, 0) corner at `origin`, the
    query `points` (N, 2), 2 n_angular + 1 rotations about init_theta,
    offsets of +-n_linear cells, a pyramid of `depth` levels. Inputs are
    numpy arrays or torch tensors on any device (copied to the host).
    Returns (score, pose (3,) float64 in the grid frame) of the best
    match above min_score, or None."""
    lib = _matcher_lib()
    probs = _host(probs, np.float32)
    if probs.ndim != 2 or probs.shape[0] != probs.shape[1]:
        raise ValueError(f"probs must be a square grid, got {probs.shape}")
    origin = _host(origin, np.float64)
    pts = _host(points, np.float64).reshape(-1, 2)
    out = np.zeros(4, np.float64)
    rc = lib.correlative_match(
        _ptr(probs), probs.shape[0], float(origin[0]), float(origin[1]),
        float(resolution), _ptr(pts), len(pts), float(init_theta),
        float(angular_step), int(n_angular), int(n_linear), int(depth),
        float(min_score), _ptr(out),
    )
    if rc == 0:
        return None
    return float(out[0]), out[1:4].copy()


def correlative_match_many_native(
    grids, origins, resolution: float, points, init_thetas,
    angular_step: float, n_angular: int, n_linear: int, depth: int,
    min_score: float, n_threads: int = 8,
):
    """correlative_match_native over C candidate submaps (grids (C, size,
    size), origins (C, 2), init_thetas (C,)) fanned over `n_threads`
    threads (the reference's ctpl loop_closing_threads pattern,
    submap_loop_closer.cpp:158-171), reduced to the best score (the
    first candidate among equals). Returns (best_idx, score, pose (3,))
    or None."""
    lib = _matcher_lib()
    grids = _host(grids, np.float32)
    if grids.ndim != 3 or grids.shape[1] != grids.shape[2]:
        raise ValueError(f"grids must be (C, size, size), got "
                         f"{grids.shape}")
    C = grids.shape[0]
    origins = _host(origins, np.float64).reshape(-1, 2)
    th0 = _host(init_thetas, np.float64).reshape(-1)
    if len(origins) != C or len(th0) != C:
        raise ValueError("grids, origins and init_thetas disagree in "
                         "number")
    pts = _host(points, np.float64).reshape(-1, 2)
    out = np.zeros(4, np.float64)
    best = lib.correlative_match_many(
        _ptr(grids), C, grids.shape[1], _ptr(origins), float(resolution),
        _ptr(pts), len(pts), _ptr(th0), float(angular_step),
        int(n_angular), int(n_linear), int(depth), float(min_score),
        int(n_threads), _ptr(out),
    )
    if best < 0:
        return None
    return int(best), float(out[0]), out[1:4].copy()


def parse_carmen_native(path: str):
    """Parse a CARMEN log's FLASER lines with the C++ loader
    (csrc/carmen_parser.cpp); returns (times (N,), poses (N, 3) odometry,
    ranges_flat, offsets (N+1,)): frame i's ranges are
    ranges_flat[offsets[i]:offsets[i + 1]]. Frames are stably sorted by
    time, as providers.CarmenLogDataProvider's Python parser sorts them.
    Raises OSError when the file cannot be read."""
    lib = _carmen_lib()
    h = lib.carmen_parse(os.fsencode(path))
    if not h:
        raise OSError(f"cannot parse {path}")
    try:
        n = lib.carmen_num_frames(h)
        m = lib.carmen_num_ranges(h)
        ranges = np.empty(m, np.float64)
        offsets = np.empty(n + 1, np.int64)
        poses = np.empty((n, 3), np.float64)
        times = np.empty(n, np.float64)
        lib.carmen_copy(h, _ptr(ranges), _ptr(offsets), _ptr(poses),
                        _ptr(times))
    finally:
        lib.carmen_free(h)
    return times, poses, ranges, offsets
