"""CUDA occupancy-grid ray insertion: the counterpart of the TPU kernel
sparse_gslam_tpu/ops/grid_pallas.py:insert_rays_pallas.

The kernel (csrc/insert_rays.cu, one block per T x T tile of the grid,
with the arithmetic it shares with a host build in
csrc/insert_rays_tile.cuh) is compiled with nvcc for sm_90a at first
use into a shared library with a plain C interface, cached under
sparse_gslam_tpu_torch/_build/ by a hash of its source, the headers it
includes and the flags, and loaded with ctypes. `insert_rays_cuda`
checks its inputs, launches the kernel once on the current stream into
a new output and counts its launches in `insert_rays_cuda.launches`
(and by thread name in `insert_rays_cuda.launches_by_thread`; count_launch
adds under a lock, since the realtime mode launches from several
threads). Its plain version is ops/grid.py:insert_rays_plain.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "insert_rays.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# tile edges the kernel is built for
TILES = (16, 32, 64)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def source_files(path: str = SOURCE) -> list:
    """`path` and every file it includes with #include "...", found
    beside the including file, recursively."""
    files, todo = [], [os.path.abspath(path)]
    while todo:
        f = todo.pop()
        if f in files:
            continue
        files.append(f)
        with open(f) as fh:
            for name in re.findall(r'^\s*#\s*include\s*"([^"]+)"',
                                   fh.read(), re.M):
                todo.append(os.path.join(os.path.dirname(f), name))
    return files


def build_library(source: str, flags, stem: str, compiler: str = None
                  ) -> dict:
    """Compile `source` with `compiler` (nvcc unless named) and `flags`
    into a shared library in BUILD_DIR unless a build of the same
    source, included headers, compiler and flags is there already.

    Returns {"path", "seconds" (0.0 when cached), "ptxas" (the
    compiler's output, with nvcc's -Xptxas -v the register/shared-memory
    report; "" when cached)}."""
    h = hashlib.sha256(" ".join((compiler or "nvcc", *flags)).encode())
    for f in source_files(source):
        with open(f, "rb") as fh:
            h.update(fh.read())
    path = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "ptxas": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cc = compiler or _nvcc()
    t0 = time.perf_counter()
    proc = subprocess.run([cc, *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cc)} failed ({proc.returncode}) on "
            f"{source}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: concurrent builders race harmlessly
    return {"path": path, "seconds": seconds,
            "ptxas": (proc.stdout + proc.stderr).strip()}


def build() -> dict:
    """Compile the insertion kernel's library if its cached build is
    missing (build_library)."""
    return build_library(SOURCE, NVCC_FLAGS, "insert_rays")


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches` and to the calling thread's entry of
    `wrapper.launches_by_thread`, under a lock: kernel wrappers are
    called from several threads at once."""
    name = threading.current_thread().name
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.launches_by_thread[name] = (
            wrapper.launches_by_thread.get(name, 0) + 1)


def reset_launches(*wrappers) -> None:
    """Set the wrappers' launch counts to 0."""
    with _COUNT_LOCK:
        for w in wrappers:
            w.launches = 0
            w.launches_by_thread = {}


def load() -> None:
    """Build (unless cached) and load the kernel's library, so that no
    caller waits for the first build at its first launch."""
    _library()


@functools.lru_cache(maxsize=None)
def _library():
    info = build()
    lib = ctypes.CDLL(info["path"])
    fn = lib.insert_rays_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def pick_tile(size: int, n_sm: int) -> int:
    """The largest tile whose launch gives each of the card's n_sm SMs
    two blocks (as many as fit on one), else the smallest: a larger tile
    screens fewer beams per cell, but too few blocks leave SMs idle."""
    for tile in sorted(TILES, reverse=True):
        if ((size + tile - 1) // tile) ** 2 >= 2 * n_sm:
            return tile
    return min(TILES)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def insert_rays_cuda(
    probs, origin, scan_origins, scan_points, scan_kind, hit_miss_p,
    resolution: float, n_steps: int, size: int, tile: int | None = None,
):
    """Launch the CUDA insertion kernel; same arguments and result as
    ops/grid.py:insert_rays. Inputs are CUDA tensors: probs (size,size)
    f32, origin (2,) f32, scan_origins (S,2) f32, scan_points (S,B,2)
    f32, scan_kind (S,B) int8, hit_miss_p (2,) f32. `tile` (one of
    TILES, by default pick_tile's for this card) is the edge of the
    square of cells one block updates: the launch has
    ceil(size / tile)^2 blocks. Returns a new grid; `probs` is not
    modified."""
    dev = probs.device
    if dev.type != "cuda":
        raise ValueError(f"insert_rays_cuda needs CUDA tensors, got {dev}")
    S, B = scan_kind.shape
    f32 = torch.float32
    _check("probs", probs, f32, (size, size), dev)
    _check("origin", origin, f32, (2,), dev)
    _check("scan_origins", scan_origins, f32, (S, 2), dev)
    _check("scan_points", scan_points, f32, (S, B, 2), dev)
    _check("scan_kind", scan_kind, torch.int8, (S, B), dev)
    _check("hit_miss_p", hit_miss_p, f32, (2,), dev)
    if n_steps < 1 or size < 1:
        raise ValueError("n_steps and size must be positive")
    if tile is None:
        tile = pick_tile(size, _sm_count(dev.index))
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    fn = _library()
    out = torch.empty_like(probs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            out.data_ptr(), probs.data_ptr(), origin.data_ptr(),
            scan_origins.data_ptr(), scan_points.data_ptr(),
            scan_kind.data_ptr(), hit_miss_p.data_ptr(),
            ctypes.c_float(resolution), S, B, n_steps, size, tile, stream,
        )
    if rc != 0:
        raise RuntimeError(f"insert_rays kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(insert_rays_cuda)
    return out


reset_launches(insert_rays_cuda)
