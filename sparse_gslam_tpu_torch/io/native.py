"""The float64 C++ pose-graph Gauss-Newton solver through ctypes: the
oracle for the port's pose-graph solvers and their CPU baseline.

csrc/posegraph_solver.cpp (dependency-free) is compiled with g++ at
first use into sparse_gslam_tpu_torch/_build/ (gitignored), cached by a
hash of its source and flags.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..ops.grid_cuda import build_library

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "posegraph_solver.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lib = None


def build() -> str:
    """Compile the library if its cached build is missing; its path."""
    return build_library(SOURCE, GXX_FLAGS, "posegraph",
                         compiler="g++")["path"]


def _host(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype)


def posegraph_gn_native(g, phi: float, iterations: int) -> np.ndarray:
    """Run the C++ GN solver on a PoseGraphData (torch tensors on any
    device, or numpy arrays); returns float64 poses (N, 3).

    Same semantics as ops.solvers.optimize_pose_graph."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        _lib.posegraph_gn_optimize.argtypes = [
            i32, vp, vp, vp, vp, vp, i32, vp, vp, vp, vp, vp,
            ctypes.c_double, i32,
        ]
        _lib.posegraph_gn_optimize.restype = i32
    fn = _lib.posegraph_gn_optimize

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

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = fn(
        ctypes.c_int(n), p(poses), p(cm), p(ci), p(cv), p(fx),
        ctypes.c_int(len(cloi)), p(cloi), p(cloj), p(clom), p(cloinf),
        p(clov), ctypes.c_double(phi), ctypes.c_int(iterations),
    )
    if rc != 0:
        raise RuntimeError(f"native solver failed rc={rc}")
    return poses
