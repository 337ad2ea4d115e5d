"""Correlative scan-to-map matching + covariance + local refinement.

Port of the CPU branch of sparse_gslam_tpu/ops/matching.py: the
replacement for the reference's FastCorrelativeScanMatcher2D
branch-and-bound search (src/cartographer_bindings/
fast_correlative_scan_matcher_2d.cc:41-688) and CeresScanMatcher2D
refinement (ceres_scan_matcher_2d.h:38-58).

Every (rotation, x-offset, y-offset) candidate is scored exactly: per
rotation the query becomes a cell-count histogram and score(offset) =
<histogram, grid shifted by offset> / N is a cross-correlation, computed
for all offsets at once with FFTs (`correlate_rotations`). Exact
per-rotation upper bounds from the pooled pyramid level prune rotations
first (`rotation_upper_bounds`); `match_candidates_pruned` drives both
per candidate submap from the host, and `window_cov` re-scores the
window around the winner for the score-moment covariance. Refinement is
Gauss-Newton on a bicubic-interpolated grid (`refine_pose*`): one launch
of the CUDA kernel (ops/refine_cuda.py) for grids on the card, its plain
version (ops/refine_exact.py, on the host) for grids on the CPU; both
round as the JAX package's compiled CPU program does. `match_submap`
(one candidate, the reference's matchOne), `match_submaps_batched` and
`match_candidates_pruned_batched` (one host read per chunk of
candidates) drive the same correlator; `score_pose` scores one pose and
`pin_bounds_batch` bounds a batch of pins on the device. The pin
helpers (`pin_bound_host`, `correlate_window_host`, `score_volume_cov`)
are numpy on the host, as in the JAX package; `correlate_window` scores
a pin's window with the CUDA kernel of ops/pin_window_cuda.py where the
score grid is on the card, bit-equal to `correlate_window_host`. The
last section ports the JAX package's accelerator branch (`fused_match`,
`match_candidates_fused`, `pin_eval_batch`), which
models/backend.py runs with accel_branch, and the JAX package's
throughput measurement of the fused matcher
(`match_candidates_fused_throughput`).

Device work runs on the device of the input tensors, in float32 as in
the JAX package. Bit parity of the cell indices with the JAX package's
CPU run: XLA's CPU backend takes cos/sin from glibc's cosf/sinf and
contracts c*x - s*y and s*x + c*y into fused multiply-adds
(fma(c, x, -(s*y)), fma(s, x, c*y)) and the rotation window
theta + k*step into fma(k, step, theta); the division by the (traced)
resolution is a true division. `rotation_tables` and `_rotate` copy
that on every device (the rotation tables come from the host), so a
query point lands in the same cell as in the JAX package. window_cov's
moments, whose cancellation would magnify any other order of summation,
copy XLA's CPU order and rounding as well, and so does the refinement.
What is not bit-equal: FFTs (pocketfft/MKL on the CPU, cuFFT on the
card, XLA's own on the JAX side: ~1e-7 relative) and the other float32
sums (see the tests for the tolerances).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import refine_exact
from .grid import PMIN, _fma_f32

# Score plateaus narrower than the per-point sampling noise carry no
# information: mean scores over n~100-500 points have binomial noise
# sqrt(p(1-p)/n) ~ 0.02-0.04, so candidates within this band of the
# max are statistically tied and the centered tie-break (odometry
# prior) decides.
SCORE_NOISE_BAND = 0.02

# ---------------------------------------------------------------------------
# search geometry (SearchParameters, correlative_scan_matcher_2d.cc:27-54)
# ---------------------------------------------------------------------------


class SearchSpec(NamedTuple):
    n_angular: int  # rotations each side of initial angle
    angular_step: float
    n_linear: int  # linear window in cells (each side)
    resolution: float


def search_spec(
    linear_window: float,
    angular_window: float,
    max_scan_range: float,
    resolution: float,
    angular_bucket: int = 16,
) -> SearchSpec:
    """Angular step from scan extent (correlative_scan_matcher_2d.cc:34-47),
    rotations padded up to a bucket multiple."""
    max_scan_range = max(max_scan_range, 3.0 * resolution)
    step = (1.0 - 1e-3) * math.acos(
        1.0 - resolution**2 / (2.0 * max_scan_range**2)
    )
    n_ang = int(math.ceil(angular_window / step))
    n_ang = int(math.ceil(n_ang / angular_bucket) * angular_bucket)
    n_lin = int(math.ceil(linear_window / resolution))
    return SearchSpec(n_ang, step, n_lin, resolution)


class MatchResult(NamedTuple):
    score: torch.Tensor  # ()
    pose: torch.Tensor  # (3,) [x, y, theta] in submap frame
    cov: torch.Tensor  # (3, 3)


# ---------------------------------------------------------------------------
# float32 rotation, as the JAX package's CPU run rounds it
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
    return lib


def cos_sin_f32(thetas):
    """float32 cos and sin of a float32 numpy array, from the C
    library's cosf/sinf (what XLA's CPU backend calls)."""
    lib = _libm()
    t = np.asarray(thetas, np.float32).ravel()
    c = np.fromiter((lib.cosf(float(v)) for v in t), np.float32, len(t))
    s = np.fromiter((lib.sinf(float(v)) for v in t), np.float32, len(t))
    shape = np.shape(thetas)
    return c.reshape(shape), s.reshape(shape)


def rotation_tables(thetas, device):
    """(cos, sin) float32 tensors on `device` for float32 `thetas`
    (a tensor on any device, or numpy), computed on the host."""
    if isinstance(thetas, torch.Tensor):
        thetas = thetas.detach().cpu().numpy()
    c, s = cos_sin_f32(thetas)
    return (torch.from_numpy(c).to(device), torch.from_numpy(s).to(device))


def _rotate(points, c, s):
    """Rotate (N,2) float32 points by every (c[k], s[k]): (R,N) px, py,
    contracted as XLA's CPU backend does (module docstring)."""
    x = points[None, :, 0]
    y = points[None, :, 1]
    c = c[:, None]
    s = s[:, None]
    shape = (c.shape[0], points.shape[0])
    px = _fma_f32(c.expand(shape), x.expand(shape), -(s * y))
    py = _fma_f32(s.expand(shape), x.expand(shape), c * y)
    return px, py


def _f32(v, device):
    """A 0-dim float32 tensor: dividing by it is a true division on
    every device (a CUDA tensor divided by a Python scalar is multiplied
    by its reciprocal)."""
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _cells(px, py, ox, oy, resolution):
    res = _f32(resolution, px.device)
    cx = torch.floor((px - ox) / res).to(torch.int64)
    cy = torch.floor((py - oy) / res).to(torch.int64)
    return cx, cy


def _n_valid(point_valid):
    return torch.clamp(point_valid.sum(), min=1)


def _pmin_fill(count, n_valid):
    """count * PMIN for int64 counts, rounded to float32 once (the JAX
    package multiplies its default-int counts by a weakly typed float,
    which is float64 under x64)."""
    return ((n_valid - count).double() * PMIN).float()


# ---------------------------------------------------------------------------
# exhaustive correlation match
# ---------------------------------------------------------------------------


def rotation_upper_bounds(
    pooled_grid,  # (size, size) level-h pooled score grid (width 2^h+1)
    grid_origin,
    points,
    point_valid,
    thetas,  # (R,) candidate rotations
    resolution: float,
    n_linear: int,
    size: int,
    stride: int,  # 2^h
):
    """Per-rotation EXACT upper bound on the best achievable score:
    max over the stride-lattice of mean pooled-grid lookups -- the
    branch-and-bound root level (fast_correlative_scan_matcher_2d.cc
    ComputeLowestResolutionCandidates). Returns (R,) float32."""
    return rotation_upper_bounds_batch(
        pooled_grid[None], grid_origin[None], thetas[None], points,
        point_valid, resolution, n_linear, size, stride,
    )[0]


def rotation_upper_bounds_batch(
    pooled_grids,  # (C, size, size)
    origins,  # (C, 2)
    thetas,  # (C, R)
    points,
    point_valid,
    resolution: float,
    n_linear: int,
    size: int,
    stride: int,
):
    """rotation_upper_bounds for C candidate submaps at once: (C, R)."""
    dev = pooled_grids.device
    C, R = thetas.shape
    N = points.shape[0]
    c, s = rotation_tables(thetas.reshape(-1), dev)
    px, py = _rotate(points, c, s)  # (C*R, N)
    px = px.reshape(C, R, N)
    py = py.reshape(C, R, N)
    cx, cy = _cells(px, py, origins[:, 0, None, None],
                    origins[:, 1, None, None], resolution)
    offs = torch.arange(-n_linear, n_linear + 1, stride, device=dev)
    n_valid = _n_valid(point_valid)
    valid = point_valid[None, None, None, :]
    flat = pooled_grids.reshape(C, -1)
    best = torch.full((C, R), -torch.inf, dtype=pooled_grids.dtype,
                      device=dev)
    gy = cy[:, :, None, :] + offs[None, None, :, None]  # (C, R, O, N)
    iny = (gy >= 0) & (gy < size)
    gyc = gy.clamp(0, size - 1)
    for ox in offs.tolist():
        gx = (cx + ox)[:, :, None, :]
        inb = valid & (gx >= 0) & (gx < size) & iny
        idx = gx.clamp(0, size - 1) * size + gyc
        vals = torch.gather(flat, 1, idx.reshape(C, -1)).reshape(idx.shape)
        vals = torch.where(inb, vals, PMIN)
        sc = torch.where(valid, vals, 0.0).sum(-1) / n_valid
        best = torch.maximum(best, sc.amax(-1))
    return best


def correlate_rotations(
    score_grid,
    grid_origin,
    points,
    point_valid,
    thetas,  # (R,) explicit rotation set
    resolution: float,
    n_linear: int,
    size: int,
    fft_size: int,
):
    """Exhaustive translation scores for an explicit rotation set.
    Returns (R, 2*n_linear+1, 2*n_linear+1) float32."""
    dev = score_grid.device
    R = thetas.shape[0]
    Fs = fft_size
    c, s = rotation_tables(thetas, dev)
    px, py = _rotate(points, c, s)
    cx, cy = _cells(px, py, grid_origin[0], grid_origin[1], resolution)
    inb = (
        point_valid[None, :]
        & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    )
    # per-rotation histogram images, zero-padded to fft_size; points
    # outside the grid are dropped (the JAX scatter's mode="drop")
    hist = torch.zeros((R, Fs * Fs), dtype=torch.float32, device=dev)
    rows = torch.arange(R, device=dev)[:, None].expand(inb.shape)
    hist.index_put_(
        (rows[inb], (cx * Fs + cy)[inb]),
        torch.ones((), dtype=torch.float32, device=dev).expand(
            int(inb.sum())),
        accumulate=True,
    )
    grid_pad = torch.zeros((Fs, Fs), dtype=torch.float32, device=dev)
    grid_pad[:size, :size] = score_grid
    # correlation via FFT: corr[o] = sum_c hist[c] * grid[c + o]
    Fh = torch.fft.rfft2(hist.reshape(R, Fs, Fs))
    Fg = torch.fft.rfft2(grid_pad)
    corr = torch.fft.irfft2(torch.conj(Fh) * Fg[None], s=(Fs, Fs))
    # window [-n_linear, n_linear] (negative offsets wrap)
    W = 2 * n_linear + 1
    corr = torch.roll(corr, (n_linear, n_linear), dims=(1, 2))[:, :W, :W]
    n_valid = _n_valid(point_valid)
    # points outside the grid score PMIN (uniform per-rotation fill)
    corr = corr + _pmin_fill(inb.sum(1), n_valid)[:, None, None]
    return corr / n_valid


def correlate_all(
    score_grid,  # (size, size) dilated score grid (PMIN where unknown)
    grid_origin,  # (2,)
    points,  # (N, 2) query points in submap frame
    point_valid,  # (N,) bool
    init_theta,  # () initial rotation estimate, float32
    angular_step,  # (), float32
    resolution: float,
    n_angular: int,
    n_linear: int,
    size: int,
    fft_size: int,
):
    """Score every (rotation, ox, oy) candidate: the exhaustive FFT
    correlator over the 2 n_angular + 1 rotations init_theta + k step
    (one FMA each, as XLA forms them). Returns scores (R, 2 n_linear + 1,
    2 n_linear + 1), the mean over valid points of the grid value at the
    point's cell shifted by (ox, oy) cells, and the thetas (R,)."""
    dev = score_grid.device
    f32 = torch.float32
    R = 2 * n_angular + 1
    ks = (torch.arange(R, device=dev) - n_angular).to(f32)
    thetas = _fma_f32(ks, torch.as_tensor(angular_step, dtype=f32,
                                          device=dev).expand(R),
                      torch.as_tensor(init_theta, dtype=f32,
                                      device=dev).expand(R))
    scores = correlate_rotations(score_grid, grid_origin, points,
                                 point_valid, thetas, resolution, n_linear,
                                 size, fft_size)
    return scores, thetas


def best_candidate_with_cov(scores, thetas, init_theta, angular_step,
                            resolution: float, n_linear: int):
    """The centred argmax of a (R, W, W) score volume (among candidates
    within SCORE_NOISE_BAND of the max, the one nearest the search
    centre; the first in flat order among equals) and the score-moment
    covariance over the +-5 cell / +-5 rotation window around it
    (indices clamped to the volume, fast_correlative_scan_matcher_2d.cc:
    522-560), in float32 on the scores' device. Returns (best score,
    pose (3,) [ox res, oy res, theta], cov (3, 3)). The moments are torch
    sums, not the JAX program's order (match_candidates_sharded takes
    the covariance from window_cov)."""
    dev = scores.device
    f32 = torch.float32
    R, W = scores.shape[0], scores.shape[1]
    m = scores.max()
    d = torch.arange(W, device=dev) - n_linear
    r2 = (d[:, None] ** 2 + d[None, :] ** 2).to(f32)
    masked = torch.where(scores >= m - SCORE_NOISE_BAND, -r2[None],
                         torch.tensor(-np.inf, dtype=f32, device=dev))
    flat = int(torch.argmax(masked.reshape(-1)))
    k, rem = divmod(flat, W * W)
    ox, oy = rem // W - n_linear, rem % W - n_linear
    best = scores.reshape(-1)[flat]
    res = np.float32(resolution)
    pose = torch.stack([
        torch.tensor(np.float32(ox) * res, device=dev),
        torch.tensor(np.float32(oy) * res, device=dev), thetas[k]])
    w = 5
    di = torch.arange(-w, w + 1, device=dev)
    ki = torch.clamp(k + di, 0, R - 1)
    xi = torch.clamp(ox + n_linear + di, 0, W - 1)
    yi = torch.clamp(oy + n_linear + di, 0, W - 1)
    sub = scores[ki[:, None, None], xi[None, :, None], yi[None, None, :]]
    px = (xi - n_linear).to(f32) * res
    py = (yi - n_linear).to(f32) * res
    pt = thetas[ki] - torch.as_tensor(init_theta, dtype=f32, device=dev)
    n = len(di)
    X = torch.stack([px[None, :, None].expand(n, n, n),
                     py[None, None, :].expand(n, n, n),
                     pt[:, None, None].expand(n, n, n)], -1).reshape(-1, 3)
    sflat = sub.reshape(-1)
    inv_s = 1.0 / sflat.sum()
    u = (X * sflat[:, None]).sum(0)
    K = torch.einsum("ni,nj,n->ij", X, X, sflat)
    cov = inv_s * K - inv_s * inv_s * torch.outer(u, u)
    return best, pose, cov


def _seq_sum_last(x):
    """Sum over the last dim in index order, in x's dtype."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _tree_sum_last(x, w: int = 32):
    """Sum over the last dim as XLA's CPU backend reduces it: windows
    of `w` elements (zero-padded evenly at both ends) summed in order,
    repeated until at most `w` partial sums are left, which are summed
    in order."""
    while x.shape[-1] > w:
        n = x.shape[-1]
        m = -(-n // w) * w
        lo = (m - n) // 2
        x = F.pad(x, (lo, m - n - lo))
        x = _seq_sum_last(x.reshape(*x.shape[:-1], m // w, w))
    return _seq_sum_last(x)


def _seq_sum_np(x, axis=-1):
    """float32 sum along `axis` in index order, from 0."""
    return np.add.accumulate(x, axis=axis, dtype=np.float32).take(
        -1, axis=axis)


def _tree_sum_np(x, w: int = 32):
    """_tree_sum_last for a float32 numpy array, along axis 0."""
    while x.shape[0] > w:
        n = x.shape[0]
        m = -(-n // w) * w
        lo = (m - n) // 2
        x = np.pad(x, [(lo, m - n - lo)] + [(0, 0)] * (x.ndim - 1))
        x = _seq_sum_np(x.reshape((m // w, w) + x.shape[1:]), axis=1)
    return _seq_sum_np(x, axis=0)


def _fma_np(a, b, c):
    """Elementwise float32 fma of numpy arrays (via _fma_f32)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float32)
                                    for v in (a, b, c)))
    return _fma_f32(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()),
                    torch.from_numpy(c.copy())).numpy()


def _weight_sum_np(w):
    """Sum of the (11, 63, 63) window weights in XLA's CPU order: four
    11 x 32 x 32 blocks (zero-padded to 64 x 64), each summed over
    (r, x, y < 31) in index order and then over (r, x) at y = 31, and
    the four block sums added pairwise."""
    R, X, Y = w.shape
    wp = np.zeros((R, -(-X // 32) * 32, -(-Y // 32) * 32), np.float32)
    wp[:, :X, :Y] = w
    parts = []
    for bx in range(wp.shape[1] // 32):
        for by in range(wp.shape[2] // 32):
            blk = wp[:, 32 * bx:32 * bx + 32, 32 * by:32 * by + 32]
            parts.append(_seq_sum_np(np.concatenate(
                [blk[:, :, :31].ravel(), blk[:, :, 31].ravel()])))
    while len(parts) > 1:
        parts = [np.float32(parts[k] + parts[k + 1])
                 for k in range(0, len(parts), 2)]
    return parts[0]


def _fma_dot_np(a, b):
    """a^T b for (n, i), (n, j) float32 arrays, one fused multiply-add
    per term in index order (XLA's CPU dot loop). The float64 product
    of two float32 values is exact and the sum is rounded to float32
    once (twice only in ~2^-29 of the cases)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    acc = np.zeros((a.shape[1], b.shape[1]))
    for k in range(a.shape[0]):
        acc = (np.outer(a[k], b[k]) + acc).astype(np.float32).astype(
            np.float64)
    return acc.astype(np.float32)


def _window_moments(scores, thetas, best_pose, init_theta, angular_step,
                    resolution: float, w_lin: int, dx=None, dy=None):
    """Band-weighted second moments of a (R, W, W) float32 score window
    (numpy), in XLA's CPU order and rounding: (3, 3) float32. The
    window's cells lie dx, dy cells (float32; -w_lin..w_lin when None)
    from best_pose."""
    f32 = np.float32
    smax = scores.max()
    smin = scores.min()
    delta = np.maximum(f32(0.05), f32(0.15) * (smax - smin))
    weights = np.maximum(scores - (smax - delta), f32(0)) + f32(1e-9)
    dl = np.arange(-w_lin, w_lin + 1).astype(f32)
    xs = _fma_np(dl if dx is None else dx, f32(resolution), best_pose[0])
    ys = _fma_np(dl if dy is None else dy, f32(resolution), best_pose[1])
    ts = thetas - f32(init_theta)
    X = np.stack(
        np.broadcast_arrays(
            xs[None, :, None], ys[None, None, :], ts[:, None, None]
        ),
        axis=-1,
    ).reshape(-1, 3)
    Xw = X * weights.reshape(-1)[:, None]
    inv_s = f32(1) / _weight_sum_np(weights)
    u = _tree_sum_np(Xw)
    K = _fma_dot_np(X, Xw)
    cov = _fma_np(inv_s, K, -((inv_s * inv_s) * np.outer(u, u)))
    step = f32(angular_step)
    floor = np.array([(2.5 * resolution) ** 2, (2.5 * resolution) ** 2,
                      (f32(2.5) * step) ** 2], f32)
    return cov + np.diag(floor)


def window_cov(
    score_grid,  # (size, size) level-0 (2x2 dilated) score grid
    grid_origin,
    points,
    point_valid,
    best_pose,  # (3,) float32 [x, y, theta] best candidate
    init_theta,
    angular_step,
    theta_lo,
    theta_hi,
    resolution: float,
    size: int,
    w_lin: int = 31,
    w_rot: int = 5,
):
    """Score-moment covariance by direct re-scoring of the +-w_lin cell
    x +-w_rot rotation window around the best candidate
    (fast_correlative_scan_matcher_2d.cc:536-560, widened; moments
    weighted by the mass within a noise band below the window maximum,
    plus the reference estimator's calibration floor). See the JAX
    package's window_cov for the calibration rationale. Returns (3,3)
    float32 on the device of `score_grid`.

    The window's scores are computed on the device. The moments
    K/s - u u^T/s^2 are taken about the coordinate origin and cancel
    heavily when the window lies metres from it, so they depend on the
    order of every sum (a 1-ulp change in s moves the covariance by up
    to ~1e-4 relative). They are therefore taken on the host, in the
    order and rounding of the JAX package's CPU run (_window_moments):
    the per-point sums and u in XLA's windowed order (_tree_sum_*), the
    weight sum in its block order, K by one FMA per term, and
    fma(1/s, K, -(1/s^2) u u^T). The result is the same on every
    device and agrees with the JAX package bit for bit but for the
    last bit of the rotation entry in ~1/4 of the cases."""
    dev = score_grid.device
    f32 = torch.float32
    best_pose = torch.as_tensor(best_pose, dtype=f32, device=dev)
    step = torch.as_tensor(angular_step, dtype=f32, device=dev)
    dr = torch.arange(-w_rot, w_rot + 1, device=dev).to(f32)
    dl = torch.arange(-w_lin, w_lin + 1, device=dev)
    R = dr.shape[0]
    # the rotation window, contracted as XLA does, clamped to the
    # search range
    thetas = _fma_f32(dr, step.expand(R), best_pose[2].expand(R))
    thetas = torch.clamp(
        thetas, torch.as_tensor(theta_lo, dtype=f32, device=dev),
        torch.as_tensor(theta_hi, dtype=f32, device=dev),
    )
    c, s = rotation_tables(thetas, dev)
    px, py = _rotate(points, c, s)
    res = _f32(resolution, dev)
    cx = torch.floor((px + best_pose[0] - grid_origin[0]) / res).long()
    cy = torch.floor((py + best_pose[1] - grid_origin[1]) / res).long()
    n_valid = _n_valid(point_valid)
    flat = score_grid.reshape(-1)
    valid = point_valid[None, None, :]
    gy = cy[:, None, :] + dl[None, :, None]  # (R, W, N) as (r, oy, n)
    iny = (gy >= 0) & (gy < size)
    gyc = gy.clamp(0, size - 1)
    scores = []
    for r in range(R):  # one rotation at a time bounds the gather
        gx = cx[r][None, None, :] + dl[:, None, None]  # (W, 1, N)
        inb = valid & (gx >= 0) & (gx < size) & iny[r][None]
        vals = flat[gx.clamp(0, size - 1) * size + gyc[r][None]]
        vals = torch.where(inb, vals, PMIN)
        vals = torch.where(valid, vals, 0.0)
        scores.append(_tree_sum_last(vals) / n_valid)
    scores = torch.stack(scores)  # (R, X, Y)
    host = torch.cat([scores.reshape(-1), thetas, best_pose]).cpu().numpy()
    n = scores.numel()
    cov = _window_moments(
        host[:n].reshape(scores.shape), host[n:n + R], host[n + R:],
        init_theta, angular_step, resolution, w_lin,
    )
    return torch.from_numpy(cov).to(dev)


def _argmax_center_tiebreak(scores, n_linear, tol=None):
    """(k, i, j) of the max of a (R, W, W) numpy score volume; among
    near-ties -- exact plateaus created by the 2x2-dilated score grid,
    and corridor ridges flat to within the sampling noise -- the
    candidate nearest the translation-window center, i.e. the
    pose-estimate seed. Among equal-radius in-band cells the first in
    flat-array order wins (deliberately score-agnostic)."""
    if tol is None:
        tol = SCORE_NOISE_BAND
    m = scores.max()
    W = scores.shape[1]
    d = np.arange(W) - n_linear
    r2 = d[:, None] ** 2 + d[None, :] ** 2
    masked = np.where(scores >= m - tol, -r2[None], -np.inf)
    return np.unravel_index(np.argmax(masked), scores.shape)


def _on(x, device):
    """x (a tensor on any device, or array-like) as a float32 tensor on
    `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _query(points, device):
    """The query padded to the bucket 256 * 2^k >= N: (points (n, 2)
    float32, valid (n,) bool) on `device`."""
    N = len(points)
    n_bucket = 256
    while n_bucket < N:
        n_bucket *= 2
    pts = np.zeros((n_bucket, 2), np.float32)
    pts[:N] = points
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(np.arange(n_bucket) < N).to(device))


def _rotation_bounds(pooled_grids, origins, init_thetas, pts, valid,
                     spec: SearchSpec, size: int, stride: int):
    """The pruned matchers' phase 1: every candidate's rotation set
    init_theta + k step (float32, (C, R)) and its per-rotation upper
    bounds (C, R), in chunks of up to 16 candidates (one host read per
    chunk)."""
    R_full = 2 * spec.n_angular + 1
    C = len(pooled_grids)
    ks = np.arange(R_full) - spec.n_angular
    all_thetas = np.stack(
        [
            (float(t0) + ks * spec.angular_step).astype(np.float32)
            for t0 in init_thetas
        ]
    )
    ubs = np.zeros((C, R_full), np.float32)
    for c0 in range(0, C, 16):
        idxs = list(range(c0, min(c0 + 16, C)))
        ubs[idxs] = rotation_upper_bounds_batch(
            torch.stack([pooled_grids[k] for k in idxs]),
            torch.stack([origins[k] for k in idxs]),
            torch.from_numpy(all_thetas[idxs]),
            pts, valid, float(spec.resolution), int(spec.n_linear),
            int(size), int(stride),
        ).cpu().numpy()
    return all_thetas, ubs


def _pruned_result(best, score_grids, origins, init_thetas, pts, valid,
                   spec: SearchSpec, size: int):
    """The pruned matchers' phase 3: (best_idx or None, score, pose,
    cov) from the best (score, cand_idx, theta, ox, oy), the covariance
    by window_cov around it."""
    if best is None:
        return None, 0.0, None, None
    sc, ci, th, ox, oy = best
    pose = np.array([ox, oy, th])
    th0 = float(init_thetas[ci])
    f32 = np.float32
    cov = window_cov(
        score_grids[ci], origins[ci], pts, valid,
        torch.from_numpy(pose.astype(f32)), f32(th0),
        f32(spec.angular_step),
        f32(th0 - spec.n_angular * spec.angular_step),
        f32(th0 + spec.n_angular * spec.angular_step),
        float(spec.resolution), int(size),
    ).cpu().numpy().astype(np.float64)
    return ci, sc, pose, cov


def match_candidates_pruned(
    score_grids,  # list of level-0 (2x2 dilated) score grids
    pooled_grids,  # list of level-h pooled grids (same shapes)
    origins,  # list of (2,) float32 tensors
    init_thetas,
    points,  # (N, 2) numpy query returns
    spec: SearchSpec,
    min_score: float,
    stride: int,
    fft_margin_bucket: int = 64,
):
    """Candidate-submap matching with exact rotation pruning.

    Phase 1 (cheap): per-candidate, per-rotation upper bounds from the
    pooled grid kill every rotation that cannot reach min_score --
    branch-and-bound's root-level pruning. Phase 2: the exhaustive FFT
    correlator runs only over surviving rotations (bucketed), candidate
    by candidate in order of their best bound, with the running best
    as the floor. Phase 3: the winning candidate's covariance comes from
    direct window re-scoring (window_cov). Returns
    (best_idx or None, score, pose (3,), cov (3,3)), host values.
    """
    dev = score_grids[0].device
    size = score_grids[0].shape[0]
    pts, valid = _query(points, dev)
    fft_size = size + fft_margin_bucket
    all_thetas, ubs = _rotation_bounds(pooled_grids, origins, init_thetas,
                                       pts, valid, spec, size, stride)

    # order candidates by best bound so the running-best floor prunes
    # later candidates harder
    order = np.argsort(ubs.max(axis=1))[::-1]
    best = None  # (score, cand_idx, theta, ox, oy)
    for ci in order:
        ci = int(ci)
        thetas_full = all_thetas[ci]
        floor = max(min_score, best[0] if best else -1.0)
        sel = np.nonzero(ubs[ci] > floor)[0]
        if len(sel) == 0:
            continue
        Rb = 8
        while Rb < len(sel):
            Rb *= 2
        sel_pad = np.concatenate(
            [sel, np.full(Rb - len(sel), sel[0], np.int64)]
        )
        scores = correlate_rotations(
            score_grids[ci], origins[ci], pts, valid,
            torch.from_numpy(thetas_full[sel_pad]),
            float(spec.resolution), int(spec.n_linear), int(size),
            int(fft_size),
        ).cpu().numpy()
        k, i, j = _argmax_center_tiebreak(scores, spec.n_linear)
        sc = float(scores[k, i, j])
        if sc > floor:
            best = (
                sc, ci, float(thetas_full[sel_pad[k]]),
                (int(i) - spec.n_linear) * spec.resolution,
                (int(j) - spec.n_linear) * spec.resolution,
            )
    return _pruned_result(best, score_grids, origins, init_thetas, pts,
                          valid, spec, size)


def match_candidates_sharded(
    score_grids,  # list of level-0 (2x2 dilated) score grids
    origins,  # list of (2,) float32 tensors
    init_thetas,
    points,  # (N, 2) numpy query returns
    spec: SearchSpec,
    mesh,  # parallel/multihost.BlockMesh
    min_score: float,
    fft_margin_bucket: int = 64,
):
    """The candidate search fanned out over a mesh (the JAX package's
    shard_map matcher, the multi-device counterpart of the reference's
    ctpl pool, submap_loop_closer.cpp:158-171). The candidates, padded
    to a multiple of mesh.size with the first one, split into contiguous
    shards; each shard scores its own on its device with the exhaustive
    FFT correlator (correlate_all), takes the centred argmax
    (best_candidate_with_cov) and the window covariance (window_cov).
    The tiny (score, pose, cov) results are gathered in shard order,
    which is the candidates' order, and the first maximum wins; the
    grids stay on their shard's device. Same contract as
    match_candidates_pruned: (best_idx or None, score, pose (3,),
    cov (3, 3)), host values; below min_score (None, score, None, None).
    """
    C = len(score_grids)
    n = mesh.size
    Cp = -(-C // n) * n
    Cl = Cp // n
    size = score_grids[0].shape[0]
    N = len(points)
    n_bucket = 256
    while n_bucket < N:
        n_bucket *= 2
    pts_np = np.zeros((n_bucket, 2), np.float32)
    pts_np[:N] = points
    valid_np = np.arange(n_bucket) < N
    fft_size = size + fft_margin_bucket
    f32 = np.float32
    step = f32(spec.angular_step)
    span = f32(spec.n_angular * spec.angular_step)
    th_all = [f32(t) for t in init_thetas] + [f32(0.0)] * (Cp - C)
    s_parts, p_parts, c_parts = [], [], []
    for q, dev in enumerate(mesh.devices):
        pts = torch.from_numpy(pts_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        scs, poses, covs = [], [], []
        for ci in range((mesh.first + q) * Cl, (mesh.first + q + 1) * Cl):
            live = ci < C
            grid = score_grids[ci if live else 0].to(dev)
            origin = origins[ci if live else 0].to(dev, torch.float32)
            th0 = th_all[ci]
            scores, thetas = correlate_all(
                grid, origin, pts, valid, th0, step,
                float(spec.resolution), int(spec.n_angular),
                int(spec.n_linear), int(size), int(fft_size))
            sc, pose, _ = best_candidate_with_cov(
                scores, thetas, th0, step, float(spec.resolution),
                int(spec.n_linear))
            cov = window_cov(grid, origin, pts, valid, pose, th0, step,
                             f32(th0 - span), f32(th0 + span),
                             float(spec.resolution), int(size))
            scs.append(sc if live else torch.full((), -np.inf,
                                                  dtype=torch.float32,
                                                  device=dev))
            poses.append(pose)
            covs.append(cov.to(dev))
        s_parts.append(torch.stack(scs))
        p_parts.append(torch.stack(poses))
        c_parts.append(torch.stack(covs))
    s_all = mesh.gather(s_parts).cpu().numpy()
    p_all = mesh.gather(p_parts).cpu().numpy()
    c_all = mesh.gather(c_parts).cpu().numpy()
    k = int(np.argmax(s_all))
    sc = float(s_all[k])
    if sc < min_score:
        return None, sc, None, None
    return k, sc, p_all[k].astype(np.float64), c_all[k].astype(np.float64)


# ---------------------------------------------------------------------------
# single-submap and batched candidate matching
# ---------------------------------------------------------------------------


def match_submap(
    score_grid,  # dilated (2x2 max) score grid, (size, size) tensor
    grid_origin,
    resolution,
    points,  # (N,2) numpy query points (returns only)
    init_theta: float,
    spec: SearchSpec,
    fft_margin_bucket: int = 64,
):
    """One candidate-submap match = reference matchOne
    (submap_loop_closer.cpp:108-115): the exhaustive FFT correlator
    (correlate_all) and the centred argmax with its score-moment
    covariance (best_candidate_with_cov) on the device of `score_grid`.
    Returns (score, pose, cov) as numpy; gating against min_score
    happens in the caller."""
    dev = score_grid.device
    size = score_grid.shape[0]
    pts, valid = _query(points, dev)
    f32 = np.float32
    scores, thetas = correlate_all(
        score_grid, _on(grid_origin, dev), pts, valid, f32(init_theta),
        f32(spec.angular_step), float(spec.resolution),
        int(spec.n_angular), int(spec.n_linear), int(size),
        int(size + fft_margin_bucket),
    )
    score, pose, cov = best_candidate_with_cov(
        scores, thetas, f32(init_theta), f32(spec.angular_step),
        float(spec.resolution), int(spec.n_linear),
    )
    return float(score), pose.cpu().numpy(), cov.cpu().numpy()


def correlate_batch(
    score_grids,  # (C, size, size)
    origins,  # (C, 2)
    init_thetas,  # (C,)
    points,  # (N, 2) shared query
    point_valid,  # (N,)
    angular_step,
    resolution: float,
    n_angular: int,
    n_linear: int,
    size: int,
    fft_size: int,
):
    """Score + argmax + covariance for C candidate submaps at once, each
    as match_submap scores one (correlate_all, best_candidate_with_cov),
    with no host read. Returns (scores (C,), poses (C,3), covs (C,3,3))
    float32 tensors on the device of `score_grids`."""
    outs = []
    for i in range(score_grids.shape[0]):
        scores, thetas = correlate_all(
            score_grids[i], origins[i], points, point_valid,
            init_thetas[i], angular_step, resolution, n_angular, n_linear,
            size, fft_size,
        )
        outs.append(best_candidate_with_cov(
            scores, thetas, init_thetas[i], angular_step, resolution,
            n_linear))
    return tuple(torch.stack([o[k] for o in outs]) for k in range(3))


def match_submaps_batched(
    score_grids,  # list of (size,size) tensors (same shape and device)
    origins,
    init_thetas,
    points,  # (N,2) numpy
    spec: SearchSpec,
    chunk: int = 8,
    fft_margin_bucket: int = 64,
):
    """Batched matchOne over candidate submaps with memory-bounded
    chunking: chunks of up to `chunk` candidates, each padded to a power
    of two by repeating its first candidate (the padding's results are
    dropped), one correlate_batch and one host read per chunk. Returns a
    list of (score, pose, cov) numpy triples, one per candidate."""
    dev = score_grids[0].device
    size = score_grids[0].shape[0]
    pts, valid = _query(points, dev)
    fft_size = size + fft_margin_bucket
    out = []
    for c0 in range(0, len(score_grids), chunk):
        gs = list(score_grids[c0:c0 + chunk])
        csize = 1
        while csize < len(gs):
            csize *= 2
        pad = csize - len(gs)
        grids = torch.stack(gs + [gs[0]] * pad)
        origs = torch.stack([_on(o, dev) for o in
                             list(origins[c0:c0 + chunk])
                             + [origins[c0]] * pad])
        th0 = torch.tensor(
            np.asarray(list(init_thetas[c0:c0 + chunk])
                       + [init_thetas[c0]] * pad, np.float32), device=dev)
        s, p, cv = correlate_batch(
            grids, origs, th0, pts, valid, np.float32(spec.angular_step),
            float(spec.resolution), int(spec.n_angular),
            int(spec.n_linear), int(size), int(fft_size),
        )
        host = torch.cat([s[:, None], p, cv.reshape(csize, 9)], 1).cpu()
        host = host.numpy()
        for k in range(len(gs)):
            out.append((float(host[k, 0]), host[k, 1:4].copy(),
                        host[k, 4:].reshape(3, 3).copy()))
    return out


def correlate_rotations_batch(
    score_grids,  # (B, size, size)
    origins,  # (B, 2)
    points,
    point_valid,
    thetas,  # (B, R) per-candidate rotation sets
    resolution,
    n_linear: int,
    size: int,
    fft_size: int,
):
    """correlate_rotations over a candidate batch (shared query): the
    (B R) histograms by one scatter-add with the batch folded into the
    row index, one batched FFT of the histograms and one of the grids.
    Returns (B, R, 2*n_linear+1, 2*n_linear+1) float32."""
    dev = score_grids.device
    B, R = thetas.shape
    N = points.shape[0]
    Fs = fft_size
    c, s = rotation_tables(thetas.reshape(-1), dev)
    px, py = _rotate(points, c, s)  # (B*R, N)
    cx, cy = _cells(px.reshape(B, R, N), py.reshape(B, R, N),
                    origins[:, 0, None, None], origins[:, 1, None, None],
                    resolution)
    inb = (
        point_valid[None, None, :]
        & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    )
    hist = torch.zeros((B * R, Fs * Fs), dtype=torch.float32, device=dev)
    rows = torch.arange(B * R, device=dev).reshape(B, R, 1).expand(inb.shape)
    hist.index_put_(
        (rows[inb], (cx * Fs + cy)[inb]),
        torch.ones((), dtype=torch.float32, device=dev).expand(
            int(inb.sum())),
        accumulate=True,
    )
    grid_pad = torch.zeros((B, Fs, Fs), dtype=torch.float32, device=dev)
    grid_pad[:, :size, :size] = score_grids
    Fh = torch.fft.rfft2(hist.reshape(B, R, Fs, Fs))
    Fg = torch.fft.rfft2(grid_pad)
    corr = torch.fft.irfft2(torch.conj(Fh) * Fg[:, None], s=(Fs, Fs))
    W = 2 * n_linear + 1
    corr = torch.roll(corr, (n_linear, n_linear), dims=(2, 3))[
        :, :, :W, :W]
    n_valid = _n_valid(point_valid)
    corr = corr + _pmin_fill(inb.sum(2), n_valid)[:, :, None, None]
    return corr / n_valid


def match_candidates_pruned_batched(
    score_grids,
    pooled_grids,
    origins,
    init_thetas,
    points,
    spec: SearchSpec,
    min_score: float,
    stride: int,
    fft_margin_bucket: int = 64,
    chunk: int = 8,
):
    """match_candidates_pruned with the FFT phase batched: the same
    exact rotation pruning from pooled-grid upper bounds, but the
    surviving candidates' rotations are scored in chunks (1, 2, 4, ...
    up to `chunk` candidates, in order of their best bound) with ONE
    host read per chunk instead of one per candidate; the running best
    tightens the floor between chunks. The best match is the sequential
    path's for any fixed min_score: every rotation above min_score on
    the winning candidate is still scored. Returns (best_idx or None,
    score, pose (3,), cov (3,3)), host values."""
    dev = score_grids[0].device
    size = score_grids[0].shape[0]
    pts, valid = _query(points, dev)
    fft_size = size + fft_margin_bucket
    C = len(score_grids)
    origins = [_on(o, dev) for o in origins]
    all_thetas, ubs = _rotation_bounds(pooled_grids, origins, init_thetas,
                                       pts, valid, spec, size, stride)

    # phase 2: candidates in descending-bound order, up to `chunk` a
    # device round-trip (the first, highest-bound candidate alone
    # usually sets a floor that prunes the rest)
    order = np.argsort(ubs.max(axis=1))[::-1]
    best = None  # (score, cand_idx, theta, ox, oy)
    pos = 0
    cur_chunk = 1
    while pos < C:
        floor = max(min_score, best[0] if best else -1.0)
        if ubs[int(order[pos])].max() <= floor:
            break  # bound-ordered: nothing below can beat the floor
        batch = []
        while pos < C and len(batch) < cur_chunk:
            ci = int(order[pos])
            if ubs[ci].max() <= floor:
                break
            sel = np.nonzero(ubs[ci] > floor)[0]
            pos += 1
            if len(sel):
                batch.append((ci, sel))
        cur_chunk = min(2 * cur_chunk, chunk)
        if not batch:
            continue
        Rb = 8
        while Rb < max(len(sel) for _, sel in batch):
            Rb *= 2
        # at most ~128 rotation planes per correlate_rotations_batch
        eff = max(1, min(len(batch), 128 // Rb))
        parts, ths = [], []
        for b0 in range(0, len(batch), eff):
            sub = batch[b0:b0 + eff]
            csize = 1
            while csize < len(sub):
                csize *= 2
            sub_pad = sub + [sub[0]] * (csize - len(sub))
            th = np.stack([
                all_thetas[ci][np.concatenate(
                    [sel, np.full(Rb - len(sel), sel[0], np.int64)])]
                for ci, sel in sub_pad
            ])
            parts.append(correlate_rotations_batch(
                torch.stack([score_grids[ci] for ci, _ in sub_pad]),
                torch.stack([origins[ci] for ci, _ in sub_pad]),
                pts, valid, torch.from_numpy(th),
                float(spec.resolution), int(spec.n_linear), int(size),
                int(fft_size),
            )[:len(sub)])
            ths.append(th[:len(sub)])
        scores = torch.cat(parts).cpu().numpy()  # the chunk's host read
        th = np.concatenate(ths)
        for b, (ci, sel) in enumerate(batch):
            k, i, j = _argmax_center_tiebreak(scores[b], spec.n_linear)
            sc = float(scores[b, k, i, j])
            if sc > max(min_score, best[0] if best else -1.0):
                best = (
                    sc, ci, float(th[b, k]),
                    (int(i) - spec.n_linear) * spec.resolution,
                    (int(j) - spec.n_linear) * spec.resolution,
                )
    return _pruned_result(best, score_grids, origins, init_thetas, pts,
                          valid, spec, size)


def score_pose(
    score_grid,  # (size, size) level-0 score grid
    grid_origin,
    points,
    point_valid,
    pose,  # (3,)
    resolution: float,
    size: int,
):
    """Mean grid score of the query at one pose -- the same candidate
    score the correlative matcher maximizes, evaluated pointwise (used
    to accept/reject local refinement edges). float32 on the device of
    `score_grid`, rotated and rounded to cells as the JAX package's CPU
    program does (cosf/sinf, the contracted rotation, a true division
    by the resolution), the sum in XLA's CPU order. Returns a 0-dim
    tensor."""
    dev = score_grid.device
    pose = _on(pose, dev)
    points = _on(points, dev)
    grid_origin = _on(grid_origin, dev)
    point_valid = torch.as_tensor(point_valid, device=dev)
    c, s = rotation_tables(pose[2:3], dev)
    px, py = _rotate(points, c, s)
    cx, cy = _cells(px[0] + pose[0], py[0] + pose[1], grid_origin[0],
                    grid_origin[1], resolution)
    inb = point_valid & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    vals = torch.where(
        inb,
        score_grid[cx.clamp(0, size - 1), cy.clamp(0, size - 1)],
        PMIN,
    )
    n = _n_valid(point_valid)
    return _tree_sum_last(torch.where(point_valid, vals, 0.0)) / n


def _bicubic_kernel(t):
    """Catmull-Rom cubic weights for fractional offset t (4 taps)."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return torch.stack([w0, w1, w2, w3], -1)


def interp_grid(grid, origin, resolution, pts):
    """Bicubic interpolation of grid at world pts (N,2); out-of-grid
    clamps to border (Ceres BiCubicInterpolator semantics). Plain torch
    on the device of `grid`; the refinement (refine_pose*) computes the
    same interpolation in the JAX program's rounding (refine_exact)."""
    size = grid.shape[0]
    u = (pts[:, 0] - origin[0]) / resolution - 0.5
    v = (pts[:, 1] - origin[1]) / resolution - 0.5
    iu = torch.floor(u)
    iv = torch.floor(v)
    wu = _bicubic_kernel(u - iu)  # (N,4)
    wv = _bicubic_kernel(v - iv)
    taps = torch.arange(-1, 3, device=grid.device)
    tu = torch.clamp(iu.long()[:, None] + taps[None], 0, size - 1)
    tv = torch.clamp(iv.long()[:, None] + taps[None], 0, size - 1)
    vals = grid[tu[:, :, None], tv[:, None, :]]  # (N,4,4)
    return torch.einsum("na,nab,nb->n", wu, vals, wv)


# ---------------------------------------------------------------------------
# local refinement (Ceres scan matcher replacement)
# ---------------------------------------------------------------------------


def _cos_sin(theta):
    c, s = cos_sin_f32(np.array([theta], np.float32))
    return c[0], s[0]


def _host(x, dtype=np.float32):
    return x.detach().cpu().numpy().astype(dtype) if isinstance(
        x, torch.Tensor) else np.asarray(x, dtype)


def refine_plain(stages, points, point_valid, init_pose,
                 iterations: int = 10, want_cov: bool = True):
    """The refinement's plain version (refine_exact.refine on the host)
    for tensors on any device, back on the grid's device. `stages` is
    one or two (grid, origin, resolution) triples, as refine_pose (one,
    want_cov=False), refine_pose_cov (one) and refine_pose_cov_two_stage
    (two) pass them."""
    dev = stages[0][0].device
    pose, cov, probs = refine_exact.refine(
        [(_host(g), _host(o), np.float32(r)) for g, o, r in stages],
        _host(points), _host(point_valid, bool), _host(init_pose),
        iterations=iterations, want_cov=want_cov, cos_sin=_cos_sin)
    pose = torch.from_numpy(pose).to(dev)
    if not want_cov:
        return pose
    return (pose, torch.from_numpy(cov).to(dev),
            torch.from_numpy(probs).to(dev))


def _refine(stages, points, point_valid, init_pose, iterations, want_cov):
    """The CUDA kernel for grids on the card (one launch), the plain
    version for grids on the CPU."""
    if stages[0][0].device.type == "cuda":
        from .refine_cuda import refine_cuda

        pose, cov, probs, _ = refine_cuda(
            stages, points[None].contiguous(),
            point_valid[None].contiguous(), init_pose[None].contiguous(),
            iterations=iterations, want_cov=want_cov)
        return (pose[0], cov[0], probs[0]) if want_cov else pose[0]
    return refine_plain(stages, points, point_valid, init_pose,
                        iterations, want_cov)


def refine_pose(
    grid,  # (size, size) high-res probability grid (0 = unknown)
    origin,
    resolution,
    points,  # (N, 2) query returns in submap frame
    point_valid,  # (N,)
    init_pose,  # (3,) from the correlative match
    iterations: int = 10,
):
    """Gauss-Newton refinement of the match pose against the grid --
    the CeresScanMatcher2D replacement (options hard-coded like
    submap_loop_closer.cpp:30-39: occupied-space weight 20/sqrt(n),
    translation weight 10, rotation weight 1; the target
    translation/rotation is the correlative estimate). A step is kept
    only if the cost does not increase. float32, rounding as the JAX
    package's CPU program (ops/refine_exact.py)."""
    return _refine([(grid, origin, resolution)], points, point_valid,
                   init_pose, iterations, want_cov=False)


def refine_pose_cov(
    grid,  # (size, size) probability grid (0 = unknown)
    origin,
    resolution,
    points,  # (N, 2) query returns in submap frame
    point_valid,  # (N,)
    init_pose,  # (3,)
    iterations: int = 10,
):
    """refine_pose + a Censi-style covariance of the refined pose
    (cov = sigma^2 (J^T J)^+ of the occupied-space residuals alone, an
    eigen pseudo-inverse so unconstrained directions get a huge finite
    variance) and the per-point occupancy probabilities at the refined
    pose (for overlap gating). Returns (pose, cov, probs)."""
    return _refine([(grid, origin, resolution)], points, point_valid,
                   init_pose, iterations, want_cov=True)


def refine_pose_cov_two_stage(
    coarse_grid,  # (S, S) dilated score grid (wide convergence basin)
    coarse_origin,
    coarse_res,
    fine_grid,  # (S2, S2) raw/high-res probability grid (unbiased)
    fine_origin,
    fine_res,
    points,
    point_valid,
    init_pose,
    iterations: int = 10,
):
    """Two-stage GN: coarse basin on the dilated grid, then polish and
    Censi covariance on the raw/high-res grid, in one call (one launch
    on the card). Returns (refined_pose, censi_cov, coarse_probs): the
    overlap gate reads the COARSE-stage per-point occupancy."""
    return _refine([(coarse_grid, coarse_origin, coarse_res),
                    (fine_grid, fine_origin, fine_res)],
                   points, point_valid, init_pose, iterations,
                   want_cov=True)


def refine_pins_plain(grids, origins, ids, resolution, points, point_valid,
                      init_pose, iterations: int = 10):
    """The batched refinement's plain version (refine_exact.refine with
    vmapped=True, pin by pin on the host) for tensors on any device,
    back on the points' device: pin b refined against grids[ids[b]]
    with its Censi covariance, as the JAX package's pin_eval_batch
    refines its batch under jax.vmap. Returns pose (B, 3), cov
    (B, 3, 3), probs (B, N)."""
    dev = points.device
    ids_np = _host(ids, np.int64)
    pts, val = _host(points), _host(point_valid, bool)
    init = _host(init_pose)
    out = [refine_exact.refine(
        [(_host(grids[int(i)]), _host(origins[int(i)]),
          np.float32(resolution))], pts[b], val[b], init[b],
        iterations=iterations, want_cov=True, cos_sin=_cos_sin,
        vmapped=True) for b, i in enumerate(ids_np)]
    return tuple(torch.from_numpy(np.stack(x)).to(dev) for x in zip(*out))


def refine_pins(grids, origins, ids, resolution, points, point_valid,
                init_pose, iterations: int = 10):
    """A batch of pins refined at once (pin_eval_batch): the kernel's
    batched mode for tensors on the card (one launch), the plain version
    for tensors on the CPU. grids (M, G, G), origins (M, 2), ids (B,),
    points (B, N, 2), point_valid (B, N), init_pose (B, 3). Returns pose
    (B, 3), cov (B, 3, 3), probs (B, N)."""
    if points.device.type == "cuda":
        from .refine_cuda import refine_pins_cuda

        pose, cov, probs, _ = refine_pins_cuda(
            grids.contiguous(), origins.contiguous(),
            ids.to(torch.int32).contiguous(), resolution,
            points.contiguous(), point_valid.contiguous(),
            init_pose.contiguous(), iterations)
        return pose, cov, probs
    return refine_pins_plain(grids, origins, ids, resolution, points,
                             point_valid, init_pose, iterations)


# ---------------------------------------------------------------------------
# small-window exhaustive matching (per-keyframe pins), numpy on the host
# ---------------------------------------------------------------------------


def pin_bound_host(
    pooled_np,  # (S, S) numpy level-(depth-1) forward-max pooled grid
    origin,  # (2,)
    resolution: float,
    points,  # (N, 2) numpy
    thetas,  # (R,) numpy
    n_linear: int,
    stride: int = None,
):
    """Exact upper bound on the best correlate_window_host score over
    the +-n_linear offset window: one pooled lookup per (rotation,
    point) at c - n_linear, or, when stride < 2*n_linear + 1, the max
    over the 2x2 {c, c+1} lookups (coverage of stride+2 cells, exact for
    stride >= 2*n_linear; the caller checks that). Lookups are clipped
    into the grid and floored at PMIN; both only raise the bound."""
    S = pooled_np.shape[0]
    c, s = np.cos(thetas), np.sin(thetas)
    px = c[:, None] * points[None, :, 0] - s[:, None] * points[None, :, 1]
    py = s[:, None] * points[None, :, 0] + c[:, None] * points[None, :, 1]
    cx = np.floor((px - origin[0]) / resolution).astype(np.int64) - n_linear
    cy = np.floor((py - origin[1]) / resolution).astype(np.int64) - n_linear
    cx = np.clip(cx, 0, S - 1)
    cy = np.clip(cy, 0, S - 1)
    vals = pooled_np[cx, cy]
    if stride is not None and stride < 2 * n_linear + 1:
        cx1 = np.minimum(cx + 1, S - 1)
        cy1 = np.minimum(cy + 1, S - 1)
        vals = np.maximum(vals, pooled_np[cx1, cy])
        vals = np.maximum(vals, pooled_np[cx, cy1])
        vals = np.maximum(vals, pooled_np[cx1, cy1])
    vals = np.maximum(vals, PMIN)
    return float(vals.mean(axis=1).max())


def pin_bounds_batch(
    pooled_stack,  # (M, S, S) stacked level-(depth-1) pooled grids
    sm_ids,  # (Kp,) per-pin submap index into the stack
    origins,  # (Kp, 2) grid origin minus the pin seed xy
    points,  # (Kp, N, 2)
    point_valid,  # (Kp, N) bool
    thetas,  # (Kp, R)
    resolution,
    n_linear: int,
    extra: bool,
):
    """Device-batched pin_bound_host: exact upper bounds for a batch of
    per-keyframe pin candidates in one call on the device of
    `pooled_stack`, float32, with no host read. `extra` = the 2x2
    coverage lookups for stride == 2*n_linear (see pin_bound_host).
    Cells round as the JAX program's (cosf/sinf, the contracted
    rotation, a true division by the resolution) and the per-pin sums
    go in XLA's CPU order. Returns (Kp,) bounds."""
    dev = pooled_stack.device
    Kp, R = thetas.shape
    N = points.shape[1]
    S = pooled_stack.shape[1]
    c, s = rotation_tables(thetas.reshape(-1), dev)
    c = c.reshape(Kp, R, 1).expand(Kp, R, N)
    s = s.reshape(Kp, R, 1).expand(Kp, R, N)
    x = points[:, None, :, 0].expand(Kp, R, N)
    y = points[:, None, :, 1].expand(Kp, R, N)
    px = _fma_f32(c, x, -(s * y))
    py = _fma_f32(s, x, c * y)
    cx, cy = _cells(px, py, origins[:, 0, None, None],
                    origins[:, 1, None, None], resolution)
    cx = torch.clamp(cx - n_linear, 0, S - 1)
    cy = torch.clamp(cy - n_linear, 0, S - 1)
    ids = sm_ids.long()[:, None, None]

    def look(dx, dy):
        gx = torch.clamp(cx + dx, max=S - 1)
        gy = torch.clamp(cy + dy, max=S - 1)
        return pooled_stack[ids, gx, gy]

    vals = look(0, 0)
    if extra:
        vals = torch.maximum(vals, look(1, 0))
        vals = torch.maximum(vals, look(0, 1))
        vals = torch.maximum(vals, look(1, 1))
    vals = torch.clamp(vals, min=PMIN)
    vals = torch.where(point_valid[:, None, :], vals, 0.0)
    n = torch.clamp(point_valid.sum(-1), min=1).to(vals.dtype)
    return (_tree_sum_last(vals) / n[:, None]).amax(-1)


def _window_cells(origin, resolution: float, points, thetas):
    """(R, N) int64 cells of the points under each rotation, in numpy's
    float64 (correlate_window_host's and correlate_window's)."""
    c, s = np.cos(thetas), np.sin(thetas)
    px = c[:, None] * points[None, :, 0] - s[:, None] * points[None, :, 1]
    py = s[:, None] * points[None, :, 0] + c[:, None] * points[None, :, 1]
    cx = np.floor((px - origin[0]) / resolution).astype(np.int64)
    cy = np.floor((py - origin[1]) / resolution).astype(np.int64)
    return cx, cy


def _packed_cells(origin, resolution: float, points, thetas, n_linear: int,
                  size: int):
    """_window_cells as the kernel takes them: (2, R, N) int32, clipped
    to [-n_linear - 1, size + n_linear], beyond which every offset of the
    window leaves the grid alike (so no shifted cell overflows)."""
    cells = np.stack(_window_cells(origin, resolution, points, thetas))
    return np.clip(cells, -n_linear - 1, size + n_linear).astype(np.int32)


def correlate_window(score_grid, origin, resolution: float, points, thetas,
                     n_linear: int, rec):
    """correlate_window_host's (R, W, W) float64 volume, on the device
    that holds `score_grid` (an (S, S) float32 tensor, or numpy). On a
    CUDA grid the cells are computed on the host as there, uploaded, and
    the kernel (ops/pin_window_cuda.py) adds each output's gathered
    values in numpy's order, so the volume is bit-equal; it comes back
    with one host read. Anything else runs correlate_window_host. Counts
    pin_window.device or pin_window.host in the recorder `rec`."""
    if isinstance(score_grid, torch.Tensor) and score_grid.is_cuda:
        from . import pin_window_cuda

        rec.count("pin_window.device")
        cells = _packed_cells(origin, resolution, points, thetas, n_linear,
                              score_grid.shape[0])
        return pin_window_cuda.pin_window_cuda(
            score_grid, torch.from_numpy(cells).to(score_grid.device),
            n_linear, PMIN).cpu().numpy()
    rec.count("pin_window.host")
    return correlate_window_host(np.asarray(score_grid, np.float64), origin,
                                 resolution, points, thetas, n_linear)


def correlate_window_host(
    score_grid,  # (S, S) numpy level-0 (dilated) score grid
    origin,  # (2,)
    resolution: float,
    points,  # (N, 2) numpy
    thetas,  # (R,) numpy
    n_linear: int,
):
    """Exhaustive (rotation x offset) scores for a SMALL window by
    direct numpy gathers on the host (per-keyframe pin windows: far
    below FFT break-even). Same score function as correlate_rotations
    (mean of grid values, PMIN out-of-grid). Returns (R, W, W)."""
    S = score_grid.shape[0]
    cx, cy = _window_cells(origin, resolution, points, thetas)
    d = np.arange(-n_linear, n_linear + 1)
    gx = cx[:, :, None] + d[None, None, :]  # (R, N, W)
    gy = cy[:, :, None] + d[None, None, :]
    inx = (gx >= 0) & (gx < S)
    iny = (gy >= 0) & (gy < S)
    vx = np.clip(gx, 0, S - 1)
    vy = np.clip(gy, 0, S - 1)
    vals = score_grid[vx[:, :, :, None], vy[:, :, None, :]]
    vals = np.where(
        inx[:, :, :, None] & iny[:, :, None, :], vals, PMIN
    )
    return vals.mean(axis=1)  # (R, W, W)


def score_volume_cov(
    scores,  # (R, W, W) numpy score volume (full search window)
    thetas,  # (R,)
    init_theta: float,
    resolution: float,
    n_linear: int,
):
    """Band-weighted second-moment covariance over a full small score
    volume -- window_cov's estimator applied to an already-computed
    volume. Moments are about the weighted mean."""
    smax = scores.max()
    smin = scores.min()
    delta = max(0.05, 0.15 * (smax - smin))
    w = np.clip(scores - (smax - delta), 0.0, None) + 1e-9
    d = (np.arange(scores.shape[1]) - n_linear) * resolution
    X = np.stack(
        np.broadcast_arrays(
            d[None, :, None],
            d[None, None, :],
            (thetas - init_theta)[:, None, None],
        ),
        axis=-1,
    ).reshape(-1, 3)
    sflat = w.reshape(-1)
    ssum = sflat.sum()
    u = (X * sflat[:, None]).sum(0) / ssum
    K = np.einsum("ni,nj,n->ij", X, X, sflat) / ssum
    cov = K - np.outer(u, u)
    step = thetas[1] - thetas[0] if len(thetas) > 1 else 0.01
    return cov + np.diag(
        [
            (2.5 * resolution) ** 2,
            (2.5 * resolution) ** 2,
            (2.5 * step) ** 2,
        ]
    )


# ---------------------------------------------------------------------------
# the accelerator branch: the fused one-call matcher and the pin batches
# ---------------------------------------------------------------------------
# Port of the JAX package's fused_match / match_candidates_fused /
# pin_eval_batch and their helpers, which it runs when
# jax.default_backend() != "cpu" (models/backend.py, accel_branch). They
# are XLA programs there, torch ops here, on the device of the inputs:
# histograms by index_put_ (the JAX one-hot bf16 einsum is a TPU
# workaround; integer counts in float32 are equal either way), FFTs by
# torch.fft, einsums by float32 matmuls (TF32 off, ops/solvers.py).
# Cell indices round as XLA's CPU program rounds them (_plane_cells),
# and every trigonometric factor is read from a table of the C
# library's cosf/sinf (_phase_tables): the phases are (integer mod F)
# times 2 pi / F, so F values cover every one. What is not bit-equal:
# the FFTs and the matmuls' sums (~1e-7 relative).

FUSED_CALLS = 0  # fused_match calls made by match_candidates_fused


def _plane_cells(points, thetas, origins, resolution, tables=None):
    """Rotate points by per-plane thetas and quantize to grid cells:
    thetas (K,), origins (K, 2), points (N, 2) -> cx, cy (K, N) int64.
    XLA's program takes cos/sin from the C library, contracts the
    rotation into FMAs (_rotate) and multiplies by the float32
    reciprocal of the static resolution. `tables` is (cos, sin) of
    `thetas` when the caller has them (rotation_tables)."""
    dev = points.device
    c, s = tables if tables is not None else rotation_tables(thetas, dev)
    px, py = _rotate(points, c, s)
    inv = torch.tensor(np.float32(1.0) / np.float32(resolution),
                       device=dev)
    cx = torch.floor((px - origins[:, 0, None]) * inv).to(torch.int64)
    cy = torch.floor((py - origins[:, 1, None]) * inv).to(torch.int64)
    return cx, cy


def _hist_onehot_masked(cx, cy, valid, size: int, out_size: int):
    """Cell-count histograms of K planes with a per-plane point mask
    valid (K, N): hist (K, out_size, out_size) float32 (cells in
    [0, size), zero beyond) and n_in (K,), the points counted. The
    counts are integers, so the scatter-add gives the JAX one-hot
    einsum's values in any order of addition."""
    K, N = cx.shape
    inb = valid & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)
    rows = torch.arange(K, device=cx.device)[:, None]
    idx = (rows * out_size + cx.clamp(0, size - 1)) * out_size + cy.clamp(
        0, size - 1)
    hist = torch.zeros(K * out_size * out_size, dtype=torch.float32,
                       device=cx.device)
    # points outside the grid add 0.0 to a cell of their own plane
    hist.index_put_((idx.reshape(-1),), inb.reshape(-1).to(torch.float32),
                    accumulate=True)
    return hist.reshape(K, out_size, out_size), inb.sum(1)


def _hist_onehot(cx, cy, point_valid, size: int, out_size: int):
    """_hist_onehot_masked with one point mask (N,) for every plane."""
    return _hist_onehot_masked(cx, cy, point_valid[None].expand(cx.shape),
                               size, out_size)


def _mean_scores(corr, n_in, n_valid):
    """The out-of-grid PMIN correction and the mean: (corr + (n_valid -
    n_in) PMIN) / n_valid, float32 as in the JAX program (n_valid is a
    float32 count there)."""
    fill = (n_valid - n_in.to(torch.float32)) * torch.tensor(
        PMIN, dtype=torch.float32, device=corr.device)
    return (corr + fill[..., None, None]) / n_valid[..., None, None]


def grid_spectrum(score_grids, fft_size: int, size: int):
    """Half-width (C, F, F//2+1) complex64 spectrum of the score grids
    zero-padded to (F, F); computed once per submap and reused by every
    query matched against it."""
    C = score_grids.shape[0]
    gpad = torch.zeros((C, fft_size, fft_size), dtype=torch.float32,
                       device=score_grids.device)
    gpad[:, :size, :size] = score_grids
    return torch.fft.rfft2(gpad)


def _corr_planes(hist, Fg, n_in, n_valid, n_linear: int, fft_size: int):
    """Exact (K, W, W) mean scores of K planes by FFT, given their
    grids' half spectra Fg (K, F, F//2+1) (the SLAM_MATCH_EXACT=fft
    stage)."""
    Fh = torch.fft.rfft2(hist)
    corr = torch.fft.irfft2(torch.conj(Fh) * Fg, s=(fft_size, fft_size))
    W = 2 * n_linear + 1
    corr = torch.roll(corr, (n_linear, n_linear), dims=(1, 2))[:, :W, :W]
    return _mean_scores(corr, n_in, n_valid)


@functools.lru_cache(maxsize=None)
def _phase_tables_np(fft_size: int):
    """cos and sin of j * float32(2 pi / F) for j < F, each product
    rounded to float32 and its cos/sin taken by the C library (what
    the JAX program computes for every phase (integer mod F) * w)."""
    w = np.float32(2.0 * math.pi / fft_size)
    return cos_sin_f32(np.arange(fft_size).astype(np.float32) * w)


def _phase_tables(fft_size: int, device):
    c, s = _phase_tables_np(fft_size)
    return (torch.from_numpy(c).to(device), torch.from_numpy(s).to(device))


def _shared(device, *tensors):
    """Tensors kept for every later call: on the card the building
    stream is waited for here, since calls on other streams (the
    realtime mode's threads) read them."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return tensors if len(tensors) > 1 else tensors[0]


@functools.lru_cache(maxsize=8)
def _nudft_rows(size: int, fft_size: int, device):
    """(size, F) complex64 e^{+i (c u mod F) w} for every cell c < size
    and frequency u < F: row c holds the forward NUDFT factors of a
    point in cell c (built once per grid size and device)."""
    tc, ts = _phase_tables(fft_size, device)
    c = torch.arange(size, device=device)
    u = torch.arange(fft_size, device=device)
    ph = torch.remainder(c[:, None] * u[None, :], fft_size)
    return _shared(device, torch.complex(tc[ph], ts[ph]))


@functools.lru_cache(maxsize=8)
def _window_factors(n_linear: int, fft_size: int, device):
    """The inverse DFT's factors on the (2L+1)^2 window: (W, F)
    e^{+i (u dx mod F) w} and (F//2+1, W) c_v e^{+i (v dy mod F) w},
    c_v = 2 for the columns 1 <= v <= F - F//2 - 1 that a half spectrum
    also stands for by hermitian symmetry, 1 for the others."""
    tc, ts = _phase_tables(fft_size, device)
    F2 = fft_size // 2 + 1
    d = torch.arange(-n_linear, n_linear + 1, device=device)
    u = torch.arange(fft_size, device=device)
    pu = torch.remainder(d[:, None] * u[None, :], fft_size)
    pv = torch.remainder(u[:F2, None] * d[None, :], fft_size)
    c = torch.ones(F2, dtype=torch.float32, device=device)
    c[1:fft_size - F2 + 1] = 2.0
    return _shared(device, torch.complex(tc[pu], ts[pu]),
                   (c[:, None] * tc[pv], c[:, None] * ts[pv]))


def _partial_idft(S, n_linear: int, fft_size: int):
    """Inverse 2-D DFT of half spectra S (K, F, F//2+1) complex64, only
    on the (2L+1)^2 search window: matmuls instead of a full inverse
    FFT. The missing half, S_full[u, F-v'] = conj(S[(F-u)%F, v']),
    adds the conjugate of the same sums over the columns v' = 1..F-F2,
    so corr[dx, dy] = Re sum_v c_v U[dx, v] e^{+i phi_v dy} / F^2 with
    U[dx, v] = sum_u e^{+i phi_u dx} S[u, v] (_window_factors' c_v).
    Returns (K, W, W) float32 indexed [k, dx, dy]."""
    eu, (evr, evi) = _window_factors(n_linear, fft_size, S.device)
    U = torch.matmul(eu, S)  # (K, W, F2)
    out = _bmm(U.real, evr) - _bmm(U.imag, evi)
    return out / torch.tensor(float(fft_size * fft_size),
                              dtype=torch.float32, device=S.device)


def _bmm(a, b):
    """float32 batched matmul; TF32 is off (ops/solvers.py)."""
    return torch.matmul(a, b)


# forward NUDFT factors are (planes, points, F) complex64: built for
# this many elements at most per pass over the planes
_NUDFT_CHUNK = 1 << 25


def _corr_planes_nudft(Fg, cx, cy, point_valid, n_valid, n_linear: int,
                       size: int, fft_size: int):
    """Exact (K, W, W) mean scores of K planes from their grids' cached
    half spectra Fg (K, F, F//2+1) without an FFT of the query: the
    query's conjugate spectrum is a nonuniform DFT of its points (one
    complex matmul over the N points), the inverse only on the search
    window (_partial_idft). Same values as _corr_planes to float32
    rounding."""
    F = fft_size
    F2 = F // 2 + 1
    K, N = cx.shape
    inb = (point_valid[None, :]
           & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size))
    n_in = inb.sum(1)
    # clamped before the phase products (masked points would otherwise
    # feed large integers into them)
    cxs = cx.clamp(0, size - 1)
    cys = cy.clamp(0, size - 1)
    rows = _nudft_rows(size, F, cx.device)
    m = inb.to(torch.float32)[..., None]
    step = max(1, _NUDFT_CHUNK // max(1, N * F))
    parts = []
    for k0 in range(0, K, step):
        sl = slice(k0, k0 + step)
        # conj(Fh)[k,u,v] = sum_n e^{+i phi_u cx_n} e^{+i phi_v cy_n}
        # over the points in the grid (the 0/1 mask on the y factors)
        ax = rows[cxs[sl]].transpose(1, 2)  # (k, F, N)
        ay = rows[cys[sl], :F2] * m[sl]  # (k, N, F2)
        parts.append(torch.matmul(ax, ay) * Fg[sl])
    corr = _partial_idft(torch.cat(parts), n_linear, F)
    return _mean_scores(corr, n_in, n_valid)


def _corr_planes_hist(Fg, cx, cy, valid, n_valid, n_linear: int,
                      size: int, fft_size: int, per: int = 1):
    """Exact (K, W, W) mean scores for many planes and a small window:
    histogram, forward FFT, and the inverse on the window only
    (_partial_idft); valid (K, N) and n_valid (K,) per plane. Fg holds
    one spectrum for every `per` consecutive planes (K / per, F, F2)."""
    F2 = fft_size // 2 + 1
    hist, n_in = _hist_onehot_masked(cx, cy, valid, size, fft_size)
    Fh = torch.conj(torch.fft.rfft2(hist))
    S = (Fh.view(-1, per, fft_size, F2) * Fg[:, None]).view(
        -1, fft_size, F2)
    return _mean_scores(_partial_idft(S, n_linear, fft_size), n_in,
                        n_valid)


def _centre_argmax(scores, n_linear: int):
    """Flat index (per leading row) of the max of (..., W, W) score
    volumes flattened from the second dim on, with the centred
    tie-break inside SCORE_NOISE_BAND: among in-band cells the one
    nearest the window centre, the first in flat order among equals.
    scores (B, R, W, W) -> (B,)."""
    B = scores.shape[0]
    W = 2 * n_linear + 1
    d = torch.arange(W, device=scores.device) - n_linear
    r2 = (d[:, None] ** 2 + d[None, :] ** 2).to(torch.float32)
    flat = scores.reshape(B, -1)
    m = flat.amax(1, keepdim=True)
    band = torch.tensor(SCORE_NOISE_BAND, dtype=torch.float32,
                        device=scores.device)
    neg = (-r2).reshape(1, 1, W * W).expand(B, flat.shape[1] // (W * W),
                                             W * W).reshape(B, -1)
    masked = torch.where(flat >= m - band, neg, -torch.inf)
    return torch.argmax(masked, dim=1)


def _fused_window_cov(score_grids, origins, thetas, points, point_valid,
                      init_thetas, angular_step, resolution: float,
                      n_linear: int, size: int, fft_size: int,
                      best_cand: int, best_theta, oi: int, oj: int,
                      w_lin: int, w_rot: int, spectra=None, Fg_all=None):
    """fused_match's stage E: the score-moment covariance (3, 3) over
    2*w_rot+1 rotations around the winning plane's angle best_theta (a
    0-dim float32 tensor; clamped to candidate best_cand's range) x
    +-w_lin cells around its offset (oi, oj), scored by the same exact
    stage."""
    dev = points.device
    f32 = torch.float32
    R = thetas.shape[1]
    W = 2 * n_linear + 1
    n_valid = torch.clamp(point_valid.sum(), min=1).to(f32)
    if spectra is None and Fg_all is None:
        Fg_all = grid_spectrum(score_grids, fft_size, size)
    th0 = init_thetas[best_cand]
    dr = torch.arange(-w_rot, w_rot + 1, device=dev).to(f32)
    nr = dr.shape[0]
    step = torch.as_tensor(angular_step, dtype=f32, device=dev)
    cth = torch.minimum(
        torch.maximum(_fma_f32(dr, step.expand(nr), best_theta.expand(nr)),
                      thetas[best_cand, 0]),
        thetas[best_cand, R - 1],
    )
    corg = origins[best_cand].expand(nr, 2)
    wcx, wcy = _plane_cells(points, cth, corg, resolution)
    if spectra is not None:
        wcorr = _corr_planes_nudft(
            spectra[best_cand].expand((nr,) + spectra.shape[1:]), wcx, wcy,
            point_valid, n_valid, n_linear, size, fft_size)
    else:
        whist, wn_in = _hist_onehot(wcx, wcy, point_valid, size, fft_size)
        wcorr = _corr_planes(
            whist, Fg_all[best_cand].expand((nr,) + Fg_all.shape[1:]),
            wn_in, n_valid, n_linear, fft_size)
    dl = np.arange(-w_lin, w_lin + 1)
    xi = np.clip(oi + n_linear + dl, 0, W - 1)
    yi = np.clip(oj + n_linear + dl, 0, W - 1)
    scores_w = wcorr[:, torch.from_numpy(xi).to(dev)][
        :, :, torch.from_numpy(yi).to(dev)]  # (2 w_rot + 1, L2, L2)
    # the moments on the host in XLA's CPU order (_window_moments, as
    # window_cov's): they cancel, and any other order moves them ~1e-4
    host = torch.cat([scores_w.reshape(-1), cth,
                      th0.reshape(1)]).cpu().numpy()
    n = scores_w.numel()
    res32 = np.float32(resolution)
    cov = _window_moments(
        host[:n].reshape(scores_w.shape), host[n:n + nr],
        np.array([np.float32(oi) * res32, np.float32(oj) * res32]),
        host[n + nr], np.float32(angular_step), resolution, w_lin,
        dx=(xi - n_linear - oi).astype(np.float32),
        dy=(yi - n_linear - oj).astype(np.float32))
    return torch.from_numpy(cov).to(dev)


def _top_k(x, K: int):
    """The K largest values of a 1-D tensor and their indices, equal
    values in ascending index order (lax.top_k's order; torch.topk
    promises none, and the coarse bounds tie often)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:K], idx[:K]


def fused_match(
    score_grids,  # (C, S, S) dilated level-0 score grids
    pooled_grids,  # (C, S, S) level-(depth-1) pooled grids
    origins,  # (C, 2)
    thetas,  # (C, R) per-candidate rotation sets
    live,  # (C,) bool: padding candidates are False
    points,  # (N, 2)
    point_valid,  # (N,)
    init_thetas,  # (C,) search-centre rotations (for the cov window)
    angular_step,
    min_score,
    resolution: float,
    n_linear: int,
    size: int,
    fft_size: int,
    stride: int,
    K: int,
    w_lin: int = 31,
    w_rot: int = 5,
    plane_live=None,  # (C, R) bool: planes still in play (paging)
    spectra=None,  # (C, F, F//2+1) cached grid spectra -> NUDFT stage
    want_cov: bool = True,
):
    """One-call exhaustive-equivalent candidate-set match, the JAX
    package's fused_match in five stages: A, coarse upper bounds of all
    C*R (candidate, rotation) planes from the pooled grids; B, the top
    K planes by bound (ties to the lower index, as lax.top_k); C, their
    exact scores (the NUDFT stage on cached spectra, the FFT stage
    without); D, the argmax with the centred tie-break; E, the
    score-moment covariance over 2*w_rot+1 rotations x +-w_lin cells
    around the winner. Returns (best_score, pose (3,), cov (3, 3),
    best_cand, kth_bound, top_idx (K,), bounds (C, R)) as tensors;
    every plane outside top_idx has a bound <= kth_bound. min_score is
    taken for the JAX signature; the caller compares against it. With
    want_cov False, cov is None: the caller that keeps one winner of
    many calls computes it once (_fused_window_cov, the same stage E on
    the same inputs)."""
    dev = score_grids.device
    f32 = torch.float32
    C, R = thetas.shape
    n_valid = torch.clamp(point_valid.sum(), min=1).to(f32)
    pmin = torch.tensor(PMIN, dtype=f32, device=dev)

    # ---- stage A: coarse upper bounds for all C*R planes ----
    P = size // stride
    ko_lo = -((n_linear + stride - 1) // stride)
    ko_hi = (n_linear + stride - 1) // stride
    PAD, PADH = -ko_lo, ko_hi
    m_idx = torch.arange(P, device=dev) * stride
    m2_idx = torch.clamp(m_idx + stride - 1, max=size - 1)
    pc = torch.maximum(
        torch.maximum(pooled_grids[:, m_idx][:, :, m_idx],
                      pooled_grids[:, m2_idx][:, :, m_idx]),
        torch.maximum(pooled_grids[:, m_idx][:, :, m2_idx],
                      pooled_grids[:, m2_idx][:, :, m2_idx]),
    )
    P2 = P + PAD + PADH
    pc = F.pad(pc, (PAD, PADH, PAD, PADH), value=PMIN)
    th_flat = thetas.reshape(-1)
    tabs = rotation_tables(th_flat, dev)
    org_flat = torch.repeat_interleave(origins, R, dim=0)
    ccx, ccy = _plane_cells(points, th_flat, org_flat, resolution, tabs)
    bcx = torch.div(ccx, stride, rounding_mode="floor") + PAD
    bcy = torch.div(ccy, stride, rounding_mode="floor") + PAD
    chist, cn_in = _hist_onehot(bcx, bcy, point_valid, P2, P2)
    # every block shift of the PMIN-padded coarse grid (static slices:
    # a roll would wrap values into the borders)
    pc_sh = F.pad(pc, (PAD, PADH, PAD, PADH), value=PMIN)
    shifts = torch.stack(
        [pc_sh[:, PAD + dx:PAD + dx + P2,
               PAD + dy:PAD + dy + P2].reshape(C, -1)
         for dx in range(ko_lo, ko_hi + 1)
         for dy in range(ko_lo, ko_hi + 1)],
        dim=-1,
    )  # (C, P2*P2, KO*KO)
    b = _bmm(chist.reshape(C, R, -1), shifts)
    bounds = b.amax(-1)
    bounds = (bounds + (n_valid - cn_in.reshape(C, R).to(f32)) * pmin
              ) / n_valid
    bounds = torch.where(live[:, None], bounds, -torch.inf)
    if plane_live is not None:
        bounds = torch.where(plane_live, bounds, -torch.inf)

    # ---- stage B: top-K planes by bound ----
    top_vals, top_idx = _top_k(bounds.reshape(-1), K)
    cand_k = torch.div(top_idx, R, rounding_mode="floor")
    org_k = origins[cand_k]
    tabs_k = (tabs[0][top_idx], tabs[1][top_idx])

    # ---- stage C: exact correlation for the K planes ----
    kcx, kcy = _plane_cells(points, th_flat[top_idx], org_k, resolution,
                            tabs_k)
    if spectra is not None:
        corr = _corr_planes_nudft(spectra[cand_k], kcx, kcy, point_valid,
                                  n_valid, n_linear, size, fft_size)
        Fg_all = None
    else:
        Fg_all = grid_spectrum(score_grids, fft_size, size)
        hist, n_in = _hist_onehot(kcx, kcy, point_valid, size, fft_size)
        corr = _corr_planes(hist, Fg_all[cand_k], n_in, n_valid, n_linear,
                            fft_size)
    # planes whose bound says they cannot win (padding: -inf bounds)
    corr = torch.where((top_vals > -torch.inf)[:, None, None], corr,
                       -torch.inf)

    # ---- stage D: argmax with the centred tie-break ----
    W = 2 * n_linear + 1
    flat_idx = int(_centre_argmax(corr[None], n_linear)[0])
    kk, rem = divmod(flat_idx, W * W)
    oi = rem // W - n_linear
    oj = rem % W - n_linear
    best_score = corr.reshape(-1)[flat_idx]
    best_plane = int(top_idx[kk])
    best_cand = best_plane // R
    best_theta = th_flat[best_plane]
    res32 = np.float32(resolution)
    pose = torch.stack([
        torch.tensor(np.float32(oi) * res32, device=dev),
        torch.tensor(np.float32(oj) * res32, device=dev),
        best_theta,
    ])
    kth = top_vals[K - 1]

    # ---- stage E: the covariance window through the same stage C ----
    cov = None
    if want_cov:
        cov = _fused_window_cov(
            score_grids, origins, thetas, points, point_valid,
            init_thetas, angular_step, resolution, n_linear, size,
            fft_size, best_cand, best_theta, oi, oj, w_lin, w_rot,
            spectra, Fg_all)
    return best_score, pose, cov, best_cand, kth, top_idx, bounds


def match_candidates_fused(
    score_grids,
    pooled_grids,
    origins,
    init_thetas,
    points,
    spec: SearchSpec,
    min_score: float,
    stride: int,
    fft_margin_bucket: int = 64,
    K: int = 64,
    c_bucket: int = 16,
    spectra_list=None,  # per-candidate cached grid_spectrum outputs
):
    """Host wrapper over fused_match with the contract of
    match_candidates_pruned: (best_idx or None, score, pose, cov).

    Candidates go through fused_match in chunks of c_bucket (padded
    with copies of the chunk's first, marked not live), the running
    best carried across chunks as the floor; the query is padded to a
    power of two from 256 points. Within a chunk, while the K-th bound
    beats the floor the next K planes are scored (plane_live masks the
    scored ones), and when that paging split the noise band the band's
    planes are scored again in one call. The exact stage is the NUDFT
    on cached spectra (`spectra_list`, else built per chunk);
    SLAM_MATCH_EXACT=fft selects the FFT stage. FUSED_CALLS counts the
    fused_match calls."""
    dev = score_grids[0].device
    size = score_grids[0].shape[0]
    C = len(score_grids)
    N = len(points)
    n_bucket = 256
    while n_bucket < N:
        n_bucket *= 2
    pts = np.zeros((n_bucket, 2), np.float32)
    pts[:N] = points
    pts_d = torch.from_numpy(pts).to(dev)
    valid_d = torch.from_numpy(np.arange(n_bucket) < N).to(dev)
    R_full = 2 * spec.n_angular + 1
    ks = np.arange(R_full) - spec.n_angular
    fft_size = size + fft_margin_bucket
    Cp = max(1, c_bucket)
    k_eff = min(K, Cp * R_full)

    best = (None, -np.inf, None, None)  # (cand, score, pose, cov)
    for lo in range(0, C, Cp):
        chunk = list(range(lo, min(lo + Cp, C)))
        nc = len(chunk)
        pad = [chunk[0]] * (Cp - nc)
        thetas = np.stack(
            [(float(init_thetas[i]) + ks * spec.angular_step).astype(
                np.float32) for i in chunk]
            + [np.zeros(R_full, np.float32)] * (Cp - nc))
        grids = torch.stack([score_grids[i] for i in chunk + pad])
        pooled = torch.stack([pooled_grids[i] for i in chunk + pad])
        origs = torch.stack([origins[i].to(torch.float32)
                             for i in chunk + pad])
        live = torch.from_numpy(np.arange(Cp) < nc).to(dev)
        th0 = torch.from_numpy(np.asarray(
            [init_thetas[i] for i in chunk] + [0.0] * (Cp - nc),
            np.float32)).to(dev)
        thetas_d = torch.from_numpy(thetas).to(dev)
        if os.environ.get("SLAM_MATCH_EXACT", "nudft") == "fft":
            spec_stack = None
        elif spectra_list is not None:
            spec_stack = torch.stack([spectra_list[i] for i in chunk + pad])
        else:
            spec_stack = grid_spectrum(grids, int(fft_size), int(size))

        def call(mask):
            # the covariance of the chunk's winner alone is computed,
            # after the chunk (cov_of): the same stage E, once
            global FUSED_CALLS
            FUSED_CALLS += 1
            score, pose, _, cand, kth, scored, bounds = fused_match(
                grids, pooled, origs, thetas_d, live, pts_d, valid_d, th0,
                np.float32(spec.angular_step), np.float32(min_score),
                float(spec.resolution), int(spec.n_linear), int(size),
                int(fft_size), int(stride), int(k_eff),
                plane_live=torch.from_numpy(mask).to(dev),
                spectra=spec_stack, want_cov=False,
            )
            host = torch.cat([score.reshape(1), pose,
                              kth.reshape(1)]).cpu().numpy()
            return (float(host[0]), host[1:4], cand, float(host[4]),
                    scored, bounds)

        def cov_of(winner):
            pose = winner[1]
            res = np.float32(spec.resolution)
            return _fused_window_cov(
                grids, origs, thetas_d, pts_d, valid_d, th0,
                np.float32(spec.angular_step), float(spec.resolution),
                int(spec.n_linear), int(size), int(fft_size), winner[2],
                torch.tensor(pose[2], device=dev),
                int(np.rint(pose[0] / res)), int(np.rint(pose[1] / res)),
                31, 5, spectra=spec_stack,
            ).cpu().numpy().astype(np.float64)

        plane_live = np.ones((Cp, R_full), bool)
        winners = []  # per pass (score, pose, cand)
        bounds_np = None
        while True:
            # the running best across chunks and passes is the floor: a
            # plane bounded below it cannot change the outcome
            score, pose, cand, kth, scored, bounds = call(plane_live)
            if bounds_np is None:
                bounds_np = bounds.cpu().numpy()
            winners.append((score, pose, cand))
            m_chunk = max(w[0] for w in winners)
            if kth <= max(min_score, best[1], m_chunk):
                break
            pl = plane_live.reshape(-1)
            pl[scored.cpu().numpy()] = False
            if not pl.any():
                break
            plane_live = pl.reshape(Cp, R_full)
        m_chunk = max(w[0] for w in winners)
        if len(winners) > 1 and m_chunk >= min_score:
            # paging split the noise band across passes: score every
            # plane whose bound reaches the band in one call (the
            # single-call tie-break); beyond K of them, the host rule
            # over the passes' winners (max score, centred in the band)
            band = bounds_np >= m_chunk - SCORE_NOISE_BAND
            if band.sum() <= k_eff:
                chunk_best = call(band)[:3]
            else:
                eligible = [w for w in winners
                            if w[0] >= m_chunk - SCORE_NOISE_BAND]
                chunk_best = min(
                    eligible,
                    key=lambda w: float(np.sum(w[1][:2].astype(
                        np.float64) ** 2)))
        else:
            chunk_best = winners[0]
        if chunk_best[0] > best[1]:
            cov = cov_of(chunk_best) if chunk_best[0] >= min_score else None
            best = (chunk[0] + chunk_best[2], chunk_best[0],
                    chunk_best[1].astype(np.float64), cov)
    if best[0] is None or best[1] < min_score:
        return None, best[1], None, None
    return best


def match_candidates_fused_throughput(
    score_grids,
    pooled_grids,
    origins,
    init_thetas,
    points,
    spec: SearchSpec,
    min_score: float,
    stride: int,
    fft_margin_bucket: int = 64,
    K: int = 64,
    depth: int = 8,
    reps: int = 5,
    spectra_list=None,
):
    """Sustained throughput of the fused matcher, as the JAX package
    measures it: one reference call, then `reps` rounds of `depth`
    fused_match calls enqueued back to back with one synchronise each.
    Returns each round's wall milliseconds per match, and asserts every
    call's score within 1e-4 of the reference's. One chunk of
    candidates (all of them in one call), the query padded to a power
    of two from 256 points. fused_match reads its window moments on the
    host (stage E), so calls in flight overlap little on the card."""
    dev = score_grids[0].device
    size = score_grids[0].shape[0]
    C = len(score_grids)
    N = len(points)
    n_bucket = 256
    while n_bucket < N:
        n_bucket *= 2
    pts = np.zeros((n_bucket, 2), np.float32)
    pts[:N] = _host(points)
    pts_d = torch.from_numpy(pts).to(dev)
    valid_d = torch.from_numpy(np.arange(n_bucket) < N).to(dev)
    R_full = 2 * spec.n_angular + 1
    ks = np.arange(R_full) - spec.n_angular
    fft_size = size + fft_margin_bucket
    k_eff = min(K, C * R_full)
    thetas = torch.from_numpy(np.stack(
        [(float(t) + ks * spec.angular_step).astype(np.float32)
         for t in init_thetas])).to(dev)
    grids = torch.stack(list(score_grids))
    pooled = torch.stack(list(pooled_grids))
    origs = torch.stack([torch.as_tensor(o, dtype=torch.float32, device=dev)
                         for o in origins])
    live = torch.ones(C, dtype=torch.bool, device=dev)
    th0 = torch.from_numpy(np.asarray(init_thetas, np.float32)).to(dev)
    if os.environ.get("SLAM_MATCH_EXACT", "nudft") == "fft":
        spec_stack = None
    elif spectra_list is not None:
        spec_stack = torch.stack(list(spectra_list))
    else:
        spec_stack = grid_spectrum(grids, int(fft_size), int(size))

    def call():
        return fused_match(
            grids, pooled, origs, thetas, live, pts_d, valid_d, th0,
            np.float32(spec.angular_step), np.float32(min_score),
            float(spec.resolution), int(spec.n_linear), int(size),
            int(fft_size), int(stride), int(k_eff), spectra=spec_stack)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ref_score = float(call()[0])
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [call() for _ in range(depth)]
        sync()
        times.append((time.perf_counter() - t0) / depth * 1e3)
        for o in outs:
            assert abs(float(o[0]) - ref_score) < 1e-4
    return times


def _volume_cov(scores, thetas, init_theta, resolution: float,
                n_linear: int):
    """score_volume_cov as the JAX program's _volume_cov_jnp computes
    it, in float32 (its offsets are weakly typed there and join the
    float32 angles): the band weights, their moments about the window
    centre and the calibration floor. scores (R, W, W) float32 ->
    (3, 3) float32."""
    dev = scores.device
    f32 = torch.float32
    smax = scores.max()
    smin = scores.min()
    delta = torch.maximum(torch.tensor(0.05, dtype=f32, device=dev),
                          0.15 * (smax - smin))
    w = torch.clamp(scores - (smax - delta), min=0.0) + 1e-9
    R, W = scores.shape[0], scores.shape[1]
    d = ((torch.arange(W, device=dev) - n_linear).to(torch.float64)
         * resolution).to(f32)
    X = torch.stack([
        d[None, :, None].expand(R, W, W),
        d[None, None, :].expand(R, W, W),
        (thetas - init_theta)[:, None, None].expand(R, W, W),
    ], dim=-1).reshape(-1, 3)
    sflat = w.reshape(-1)
    ssum = sflat.sum()
    Xw = X * sflat[:, None]
    u = Xw.sum(0) / ssum
    cov = _bmm(Xw.T, X) / ssum - torch.outer(u, u)
    step = (thetas[1] - thetas[0]) if R > 1 else torch.tensor(
        0.01, dtype=f32, device=dev)
    floor = torch.stack([
        torch.tensor((2.5 * resolution) ** 2, dtype=f32, device=dev),
        torch.tensor((2.5 * resolution) ** 2, dtype=f32, device=dev),
        (2.5 * step) ** 2,
    ])
    return cov + torch.diag(floor)


def pin_eval_batch(
    spectra,  # (Msub, F, F2) cached grid spectra (grid_spectrum)
    high_stack,  # (Msub, G2, G2) high-res probability grids
    high_origins,  # (Msub, 2)
    ids,  # (B,) submap index per pin query
    origins,  # (B, 2) score-grid origin minus seed translation
    seeds,  # (B, 3) seed pose per query
    pts,  # (B, N, 2)
    valid,  # (B, N)
    thetas,  # (B, R) rotation set per query
    live,  # (B,) padding mask
    resolution: float,
    n_linear: int,
    size: int,
    fft_size: int,
    high_res: float = 0.05,
    iterations: int = 10,
):
    """A chunk of per-keyframe pins at once, as the JAX package's
    pin_eval_batch: the exhaustive window scores of every (pin,
    rotation) plane (_corr_planes_hist on the cached spectra), the
    centred argmax, the band-weighted volume covariance (_volume_cov),
    the high-res refinement of the live pins with its Censi covariance
    (refine_pins, in the arithmetic of the JAX program's vmapped
    refinement: the kernel's batched mode on the card, one launch per
    batch) and the occupancy overlap. Returns (B, 26) float64 rows
    [score, pose0 (3), wcov (9), refined (3), censi (9), overlap], zero
    for pins not live."""
    dev = pts.device
    f32 = torch.float32
    B, R = thetas.shape
    N = pts.shape[1]
    W = 2 * n_linear + 1
    n_valid = torch.clamp(valid.sum(1), min=1).to(f32)

    tabs = rotation_tables(thetas.reshape(-1), dev)
    rep = torch.arange(B, device=dev).repeat_interleave(R)
    # every plane's points rotated (the rotation of pin b's points by
    # pin b's thetas: gather the points per plane)
    c, s = tabs
    x, y = pts[rep, :, 0], pts[rep, :, 1]  # (B*R, N)
    px = _fma_f32(c[:, None].expand(B * R, N), x, -(s[:, None] * y))
    py = _fma_f32(s[:, None].expand(B * R, N), x, c[:, None] * y)
    inv = torch.tensor(np.float32(1.0) / np.float32(resolution), device=dev)
    org = origins[rep]
    cx = torch.floor((px - org[:, 0, None]) * inv).to(torch.int64)
    cy = torch.floor((py - org[:, 1, None]) * inv).to(torch.int64)
    nv_rep = n_valid[rep]
    corr = _corr_planes_hist(spectra[ids], cx, cy, valid[rep], nv_rep,
                             n_linear, size, fft_size, per=R)
    scores = corr.reshape(B, R, W, W)

    flat = _centre_argmax(scores, n_linear)
    best = scores.reshape(B, -1).gather(1, flat[:, None])[:, 0]
    k = torch.div(flat, W * W, rounding_mode="floor")
    rem = flat % (W * W)
    oi = (torch.div(rem, W, rounding_mode="floor") - n_linear).to(f32)
    oj = (rem % W - n_linear).to(f32)
    res_t = torch.tensor(np.float32(resolution), device=dev).expand(B)
    pose0 = torch.stack([
        _fma_f32(oi, res_t, seeds[:, 0]),
        _fma_f32(oj, res_t, seeds[:, 1]),
        thetas.gather(1, k[:, None])[:, 0],
    ], dim=1)
    out = torch.zeros((B, 26), dtype=torch.float64, device=dev)
    lv = torch.from_numpy(np.nonzero(live.cpu().numpy())[0]).to(dev)
    if not len(lv):
        return out
    refined, censi, probs = refine_pins(
        high_stack, high_origins, ids[lv], high_res, pts[lv], valid[lv],
        pose0[lv], iterations=iterations)
    for q, b in enumerate(lv.tolist()):
        wcov = _volume_cov(scores[b], thetas[b], seeds[b, 2], resolution,
                           n_linear)
        overlap = ((probs[q] > 0.55) & valid[b]).sum().to(f32) / n_valid[b]
        out[b] = torch.cat([
            best[b, None], pose0[b], wcov.reshape(-1), refined[q],
            censi[q].reshape(-1), overlap[None],
        ]).to(torch.float64)
    return out
