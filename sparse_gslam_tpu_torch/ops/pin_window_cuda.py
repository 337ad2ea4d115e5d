"""CUDA pin window correlation: the (rotation x offset) score volume of
one query against one submap's score grid (ops/matching.py
correlate_window, for the host pins of models/backend.py).

The kernel (csrc/pin_window.cu, one block per rotation and run of
outputs, one thread per (dx, dy); its loop in csrc/pin_window.cuh) is
compiled with nvcc for sm_90a at first use into
sparse_gslam_tpu_torch/_build/ (ops/grid_cuda.build_library), with
--fmad=false as the refinement is, and loaded with ctypes. It adds each
output's N gathered grid values in point order in float64 and divides by
N, as numpy's mean does in correlate_window_host, so the volume is that
function's bit for bit. `pin_window_cuda.launches` counts its launches
(grid_cuda.count_launch). The same loop runs on the host through
csrc/pin_window_host.cpp (g++, `host_library`) for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from . import grid_cuda

SOURCE = os.path.join(os.path.dirname(grid_cuda.SOURCE), "pin_window.cu")
HOST_SOURCE = os.path.join(os.path.dirname(SOURCE), "pin_window_host.cpp")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")


def build() -> dict:
    """Compile the kernel's library unless cached."""
    return grid_cuda.build_library(SOURCE, NVCC_FLAGS, "pin_window")


def build_host() -> dict:
    """Compile the host build of the kernel's loop unless cached."""
    return grid_cuda.build_library(HOST_SOURCE, GXX_FLAGS,
                                   "pin_window_host", compiler="g++")


_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library():
    fn = ctypes.CDLL(build()["path"]).pin_window_launch
    fn.argtypes = _ARGS + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def host_library():
    """pin_window_host: pin_window_launch's arguments on host memory."""
    fn = ctypes.CDLL(build_host()["path"]).pin_window_host
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def load() -> None:
    """Build (unless cached) and load the kernel's library, so that no
    caller waits for the first build at its first launch."""
    _library()


def _sizes(cells, n_linear: int):
    _, R, N = cells.shape
    return R, N, 2 * int(n_linear) + 1


def pin_window_host(grid: np.ndarray, cells: np.ndarray, n_linear: int,
                    pmin: float) -> np.ndarray:
    """The kernel's arithmetic on the host: grid (S, S) float32, cells
    (2, R, N) int32 as pin_window_cuda's. Returns (R, W, W) float64."""
    grid = np.ascontiguousarray(grid, np.float32)
    cells = np.ascontiguousarray(cells, np.int32)
    R, N, W = _sizes(cells, n_linear)
    out = np.empty((R, W, W), np.float64)
    rc = host_library()(grid.ctypes.data, grid.shape[0], cells.ctypes.data,
                        R, N, W, pmin, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"pin_window_host does not take S={grid.shape[0]}, "
                         f"R={R}, N={N}, W={W}")
    return out


def pin_window_cuda(grid, cells, n_linear: int, pmin: float):
    """One launch on the current stream. grid (S, S) float32 and cells
    (2, R, N) int32 (the query's cells under each rotation, x then y,
    clipped to [-n_linear - 1, S + n_linear]) are CUDA tensors of one
    device. Returns the (R, W, W) float64 volume, W = 2 n_linear + 1, on
    that device: entry (r, i, j) is the mean over the N points of the grid
    at (cx + i - n_linear, cy + j - n_linear), pmin outside it."""
    dev = grid.device
    if dev.type != "cuda":
        raise ValueError(f"pin_window_cuda needs CUDA tensors, got {dev}")
    R, N, W = _sizes(cells, n_linear)
    S = grid.shape[0]
    grid_cuda._check("grid", grid, torch.float32, (S, S), dev)
    grid_cuda._check("cells", cells, torch.int32, (2, R, N), dev)
    out = torch.empty((R, W, W), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library()(grid.data_ptr(), S, cells.data_ptr(), R, N, W,
                        pmin, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pin_window kernel launch failed: CUDA error "
                           f"{rc}")
    grid_cuda.count_launch(pin_window_cuda)
    return out


grid_cuda.reset_launches(pin_window_cuda)
