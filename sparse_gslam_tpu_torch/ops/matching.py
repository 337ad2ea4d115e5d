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
Gauss-Newton on a bicubic-interpolated grid (`refine_pose*`). The pin
helpers (`pin_bound_host`, `correlate_window_host`, `score_volume_cov`)
are numpy on the host, as in the JAX package.

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
copy XLA's CPU order and rounding as well. What is not bit-equal: FFTs
(pocketfft/MKL on the CPU, cuFFT on the card, XLA's own on the JAX
side: ~1e-7 relative), the other float32 sums, and the Gauss-Newton
refinement, whose interpolation XLA contracts in ways not copied here
(see the tests for the tolerances).
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
                    resolution: float, w_lin: int):
    """Band-weighted second moments of a (R, W, W) float32 score window
    (numpy), in XLA's CPU order and rounding: (3, 3) float32."""
    f32 = np.float32
    smax = scores.max()
    smin = scores.min()
    delta = np.maximum(f32(0.05), f32(0.15) * (smax - smin))
    weights = np.maximum(scores - (smax - delta), f32(0)) + f32(1e-9)
    dl = np.arange(-w_lin, w_lin + 1).astype(f32)
    xs = _fma_np(dl, f32(resolution), best_pose[0])
    ys = _fma_np(dl, f32(resolution), best_pose[1])
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
    N = len(points)
    n_bucket = 256
    while n_bucket < N:
        n_bucket *= 2
    pts_np = np.zeros((n_bucket, 2), np.float32)
    pts_np[:N] = points
    pts = torch.from_numpy(pts_np).to(dev)
    valid = torch.from_numpy(np.arange(n_bucket) < N).to(dev)
    fft_size = size + fft_margin_bucket
    R_full = 2 * spec.n_angular + 1

    # phase 1: per-rotation upper bounds for all candidates, in chunks
    # of up to 16 candidates (one host read per chunk)
    C = len(score_grids)
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


# ---------------------------------------------------------------------------
# local refinement (Ceres scan matcher replacement)
# ---------------------------------------------------------------------------


def _bicubic_kernel(t):
    """Catmull-Rom cubic weights for fractional offset t (4 taps)."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return torch.stack([w0, w1, w2, w3], dim=-1)


def interp_grid(grid, origin, resolution, pts):
    """Bicubic interpolation of grid at world pts (N,2); out-of-grid
    clamps to border (Ceres BiCubicInterpolator semantics)."""
    size = grid.shape[0]
    res = _f32(resolution, grid.device)
    u = (pts[:, 0] - origin[0]) / res - 0.5
    v = (pts[:, 1] - origin[1]) / res - 0.5
    iu = torch.floor(u)
    iv = torch.floor(v)
    wu = _bicubic_kernel(u - iu)  # (N,4)
    wv = _bicubic_kernel(v - iv)
    taps = torch.arange(-1, 3, device=grid.device)
    tu = torch.clamp(iu.long()[:, None] + taps[None, :], 0, size - 1)
    tv = torch.clamp(iv.long()[:, None] + taps[None, :], 0, size - 1)
    vals = grid[tu[:, :, None], tv[:, None, :]]  # (N,4,4)
    return torch.einsum("na,nab,nb->n", wu, vals, wv)


def _transform(points, pose):
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    return torch.stack(
        [
            c * points[:, 0] - s * points[:, 1] + pose[0],
            s * points[:, 0] + c * points[:, 1] + pose[1],
        ],
        dim=1,
    )


def refine_pose(
    grid,  # (size, size) high-res probability grid (0 = unknown)
    origin,
    resolution,
    points,  # (N, 2) query returns in submap frame
    point_valid,  # (N,)
    init_pose,  # (3,) from the correlative match
    occupied_space_weight: float = 20.0,
    translation_weight: float = 10.0,
    rotation_weight: float = 1.0,
    iterations: int = 10,
):
    """Gauss-Newton refinement of the match pose against the grid --
    the CeresScanMatcher2D replacement (options hard-coded like
    submap_loop_closer.cpp:30-39; the target translation/rotation is
    the correlative estimate). A step is kept only if the cost does not
    increase. float32; no host synchronization."""
    sgrid = torch.where(grid > 0.0, grid, PMIN)
    n = _n_valid(point_valid)
    w_occ = occupied_space_weight / torch.sqrt(n.to(grid.dtype))
    wv = point_valid.to(grid.dtype)

    def residuals(pose):
        tp = _transform(points, pose)
        occ = (1.0 - interp_grid(sgrid, origin, resolution, tp)) * w_occ * wv
        r_t = translation_weight * (pose[:2] - init_pose[:2])
        r_r = rotation_weight * (pose[2] - init_pose[2]).reshape(1)
        return torch.cat([occ, r_t, r_r])

    eye = 1e-9 * torch.eye(3, dtype=init_pose.dtype, device=grid.device)
    pose = init_pose
    for _ in range(iterations):
        r = residuals(pose)
        J = torch.func.jacfwd(residuals)(pose)
        H = J.T @ J + eye
        g = J.T @ r
        dp = torch.linalg.solve(H, -g)
        new_pose = pose + dp
        # accept only if cost does not increase (poor-man's trust
        # region, close to Ceres' nonmonotonic LM over 10 iterations)
        better = (residuals(new_pose) ** 2).sum() <= (r**2).sum()
        pose = torch.where(better, new_pose, pose)
    return pose


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
    sgrid = torch.where(grid > 0.0, grid, PMIN)
    n = _n_valid(point_valid).to(grid.dtype)
    wv = point_valid.to(grid.dtype)

    pose = refine_pose(
        grid, origin, resolution, points, point_valid, init_pose,
        iterations=iterations,
    )

    def occ_residuals(p):
        return (1.0 - interp_grid(sgrid, origin, resolution,
                                  _transform(points, p))) * wv

    r = occ_residuals(pose)
    J = torch.func.jacfwd(occ_residuals)(pose)  # (N, 3)
    H = J.T @ J
    sigma2 = (r * r).sum() / torch.clamp(n - 3.0, min=1.0)
    w, V = torch.linalg.eigh(H)
    inv_w = torch.where(w > 1e-6, 1.0 / torch.clamp(w, min=1e-6), 1e6)
    cov = (V * (sigma2 * inv_w)[None, :]) @ V.T
    probs = interp_grid(sgrid, origin, resolution, _transform(points, pose))
    return pose, cov, probs


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
    Censi covariance on the raw/high-res grid. Returns (refined_pose,
    censi_cov, coarse_probs): the overlap gate reads the COARSE-stage
    per-point occupancy."""
    coarse, _, cprobs = refine_pose_cov(
        coarse_grid, coarse_origin, coarse_res, points, point_valid,
        init_pose, iterations=iterations,
    )
    refined, cov, _ = refine_pose_cov(
        fine_grid, fine_origin, fine_res, points, point_valid, coarse,
        iterations=iterations,
    )
    return refined, cov, cprobs


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
