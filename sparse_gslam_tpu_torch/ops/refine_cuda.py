"""CUDA scan refinement: one launch per refine_pose / refine_pose_cov /
refine_pose_cov_two_stage call (ops/matching.py).

The kernel (csrc/refine_pose.cu, one block of 512 threads per
refinement whatever the padded point count, its arithmetic and block
program in csrc/refine_pose_exact.cuh) is compiled with nvcc for sm_90a
at first use into sparse_gslam_tpu_torch/_build/
(ops/grid_cuda.build_library), with --fmad=false so that the only fused
multiply-adds are the header's explicit ones, and loaded with ctypes.
It replaces no Pallas kernel: the JAX package runs this refinement as
one XLA program per call, and the kernel rounds as that program does on
the CPU (ops/refine_exact.py is its plain version). `refine_cuda.launches`
counts its launches (grid_cuda.count_launch: under a lock, and by thread).
The kernel ends a stage at the first GN step that every later step
would repeat; the plain version runs them all, with the same bits.
The same block program runs on the host through csrc/refine_pose_host.cpp
(g++, `host_library`), for the CPU tests and the card's checks.

`refine_pins_cuda` is the kernel's batched mode for the device pin
batches (matching.pin_eval_batch): one launch per batch, one block per
pin against its own grid of a stack, in the arithmetic of the JAX
program that refines them under jax.vmap (refine_exact.refine(...,
vmapped=True) is its plain version). `refine_pins_cuda.launches` counts
its launches.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import grid_cuda
from .refine_exact import MAX_POINTS, rsqrtss_table

SOURCE = os.path.join(os.path.dirname(grid_cuda.SOURCE), "refine_pose.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_SOURCE = os.path.join(os.path.dirname(SOURCE), "refine_pose_host.cpp")
GXX_FLAGS = ("-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
             "-pthread")
# padded query points a launch takes: the counts the callers pad to
# (256 * 2^k), as the header's takes_points
POINTS = (256, 512, 1024, 2048, 4096, MAX_POINTS)


def build() -> dict:
    """Compile the refinement kernel's library unless cached."""
    return grid_cuda.build_library(SOURCE, NVCC_FLAGS, "refine_pose")


def build_host() -> dict:
    """Compile the host build of the block program unless cached."""
    return grid_cuda.build_library(HOST_SOURCE, GXX_FLAGS,
                                   "refine_pose_host", compiler="g++")


@functools.lru_cache(maxsize=None)
def host_library():
    """The host build through ctypes: refine_pose_host (refine_pose_launch's
    arguments on host memory), the header's LAPACK transcriptions, its
    sinf/cosf and their comparison with the C library's."""
    lib = ctypes.CDLL(build_host()["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.refine_pose_host.argtypes = [p, i, p, f, p, i, p, f, i, p, p, p, p,
                                     i, i, i, i, p, p, p, p]
    lib.refine_pose_host.restype = ctypes.c_int
    lib.refine_pins_host.argtypes = [p, i, p, p, f, p, p, p, p, i, i, i,
                                     p, p, p, p]
    lib.refine_pins_host.restype = ctypes.c_int
    for name in ("rpx_sgetrf3", "rpx_strsm3", "rpx_ssyevd3"):
        getattr(lib, name).restype = None
    lib.rpx_libm_mismatches.argtypes = [ctypes.c_uint32] * 3 + [p, p]
    lib.rpx_libm_mismatches.restype = ctypes.c_longlong
    return lib


def load() -> None:
    """Build (unless cached) and load the kernel's library."""
    _library()


@functools.lru_cache(maxsize=None)
def _cdll():
    lib = ctypes.CDLL(build()["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.refine_pose_launch.argtypes = [p, i, p, f, p, i, p, f, i, p, p, p,
                                       p, i, i, i, i, p, p, p, p, p]
    lib.refine_pose_launch.restype = ctypes.c_int
    lib.refine_pins_launch.argtypes = [p, i, p, p, f, p, p, p, p, i, i, i,
                                       p, p, p, p, p]
    lib.refine_pins_launch.restype = ctypes.c_int
    return lib


def _library():
    return _cdll().refine_pose_launch


@functools.lru_cache(maxsize=None)
def _y0(device) -> torch.Tensor:
    """The rsqrtss table on `device`, kept for every later launch: the
    copy is waited for here, since launches on other streams (the
    realtime mode's threads) read it."""
    y0 = torch.from_numpy(rsqrtss_table()).to(device)
    torch.cuda.current_stream(device).synchronize()
    return y0


def refine_cuda(stages, points, point_valid, init_pose,
                iterations: int = 10, want_cov: bool = True):
    """Refine B problems in one launch of B blocks.
    `stages` is one or two (grid (G, G) f32, origin (2,) f32, resolution
    float) triples of CUDA tensors (the second stage starts from the
    first one's pose); points (B, N, 2) f32, point_valid (B, N) bool,
    init_pose (B, 3) f32, N in POINTS. Returns pose (B, 3), cov
    (B, 3, 3), the first stage's probs (B, N) (the last two unwritten
    without want_cov) and steps (B, 2) int32, the GN steps each stage
    ran before it stopped (0 for a stage not run)."""
    dev = points.device
    if len(stages) not in (1, 2):
        raise ValueError("one or two stages")
    B, N, _ = points.shape
    if N not in POINTS:
        raise ValueError(f"N={N} padded points: the kernel takes {POINTS}")
    if dev.type != "cuda":
        raise ValueError(f"refine_cuda needs CUDA tensors, got {dev}")
    f32 = torch.float32
    grid_cuda._check("points", points, f32, (B, N, 2), dev)
    grid_cuda._check("point_valid", point_valid, torch.bool, (B, N), dev)
    grid_cuda._check("init_pose", init_pose, f32, (B, 3), dev)
    for grid, origin, _ in stages:
        grid_cuda._check("grid", grid, f32, (grid.shape[0],) * 2, dev)
        grid_cuda._check("origin", origin, f32, (2,), dev)
    pose = torch.empty((B, 3), dtype=f32, device=dev)
    cov = torch.empty((B, 3, 3), dtype=f32, device=dev)
    probs = torch.empty((B, N), dtype=f32, device=dev)
    steps = torch.empty((B, 2), dtype=torch.int32, device=dev)
    (g0, o0, r0), (g1, o1, r1) = stages[0], stages[-1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library()(
            g0.data_ptr(), g0.shape[0], o0.data_ptr(), ctypes.c_float(r0),
            g1.data_ptr(), g1.shape[0], o1.data_ptr(), ctypes.c_float(r1),
            len(stages), points.data_ptr(),
            point_valid.view(torch.uint8).data_ptr(), init_pose.data_ptr(),
            _y0(dev).data_ptr(), B, N, iterations, int(want_cov),
            pose.data_ptr(), cov.data_ptr(), probs.data_ptr(),
            steps.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"refine_pose kernel launch failed: CUDA error "
                           f"{rc}")
    grid_cuda.count_launch(refine_cuda)
    return pose, cov, probs, steps


def refine_pins_cuda(grids, origins, ids, resolution, points, point_valid,
                     init_pose, iterations: int = 10):
    """Refine B pins in one launch of B blocks, block b against grid
    ids[b] of the stack, with the Censi covariance, as the JAX package's
    pin_eval_batch refines its batch under jax.vmap. grids (M, G, G) f32,
    origins (M, 2) f32, ids (B,) int32, points (B, N, 2) f32,
    point_valid (B, N) bool, init_pose (B, 3) f32, all CUDA tensors, N
    in POINTS. Returns pose (B, 3), cov (B, 3, 3), probs (B, N) and
    steps (B, 2) int32 (the GN steps the stage ran, then 0)."""
    dev = points.device
    B, N, _ = points.shape
    if N not in POINTS:
        raise ValueError(f"N={N} padded points: the kernel takes {POINTS}")
    if dev.type != "cuda":
        raise ValueError(f"refine_pins_cuda needs CUDA tensors, got {dev}")
    f32 = torch.float32
    M, G = grids.shape[0], grids.shape[1]
    grid_cuda._check("grids", grids, f32, (M, G, G), dev)
    grid_cuda._check("origins", origins, f32, (M, 2), dev)
    grid_cuda._check("ids", ids, torch.int32, (B,), dev)
    grid_cuda._check("points", points, f32, (B, N, 2), dev)
    grid_cuda._check("point_valid", point_valid, torch.bool, (B, N), dev)
    grid_cuda._check("init_pose", init_pose, f32, (B, 3), dev)
    pose = torch.empty((B, 3), dtype=f32, device=dev)
    cov = torch.empty((B, 3, 3), dtype=f32, device=dev)
    probs = torch.empty((B, N), dtype=f32, device=dev)
    steps = torch.empty((B, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _cdll().refine_pins_launch(
            grids.data_ptr(), G, origins.data_ptr(), ids.data_ptr(),
            ctypes.c_float(resolution), points.data_ptr(),
            point_valid.view(torch.uint8).data_ptr(), init_pose.data_ptr(),
            _y0(dev).data_ptr(), B, N, iterations, pose.data_ptr(),
            cov.data_ptr(), probs.data_ptr(), steps.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"refine_pins kernel launch failed: CUDA error "
                           f"{rc}")
    grid_cuda.count_launch(refine_pins_cuda)
    return pose, cov, probs, steps


grid_cuda.reset_launches(refine_cuda, refine_pins_cuda)
