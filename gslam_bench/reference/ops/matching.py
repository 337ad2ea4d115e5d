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
first (`rotation_upper_bounds_batch`); `match_candidates_pruned` drives both
per candidate submap from the host, and `window_cov` re-scores the
window around the winner for the score-moment covariance. Refinement is
Gauss-Newton on a bicubic-interpolated grid (`refine_pose*`), by the
plain version (ops/refine_exact.py, on the host), which rounds as the
JAX package's compiled CPU program does. The pin helpers
(`pin_bound_host`, `correlate_window_host`, `score_volume_cov`) are
numpy on the host, as in the JAX package. Frozen copy of the port's
functions that the CPU branch of models/backend.py calls; the one-call
batched, sharded and fused matchers and the device pin batches are left
out.

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


# ---------------------------------------------------------------------------
# single-submap and batched candidate matching
# ---------------------------------------------------------------------------


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
    if stages[0][0].device.type != "cpu":
        raise ValueError("the reference refines on the CPU only")
    return refine_plain(stages, points, point_valid, init_pose,
                        iterations, want_cov)


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
    c, s = np.cos(thetas), np.sin(thetas)
    px = c[:, None] * points[None, :, 0] - s[:, None] * points[None, :, 1]
    py = s[:, None] * points[None, :, 0] + c[:, None] * points[None, :, 1]
    cx = np.floor((px - origin[0]) / resolution).astype(np.int64)
    cy = np.floor((py - origin[1]) / resolution).astype(np.int64)
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
