"""Hough-transform line extraction (experimental alternative).

Re-implements the reference's header-only Hough extractor
(src/ls_extractor/include/ls_extractor/impl/hough.h:14-343, not in its
build): an accumulator grid over (theta, rho) with per-cell point
lists, window non-max suppression (w_size=4), gap-based segment
splitting (max_line_gap=0.8), overlap merging, and LSQ refit with
covariance. Constants mirror hough.h:14-18.

The accumulation itself is vectorized (one (N, T) rho evaluation) --
the natural array form of the per-point accumulator loop. Host numpy; a
copy of sparse_gslam_tpu/ops/lines_hough.py.
"""
from __future__ import annotations

import numpy as np

from .line_geometry import calc_start_dir
from .lines import Segments, fit_line_with_cov
from ..utils.config import ExtractorConfig

MAX_THETA, MIN_THETA = np.pi, 0.0
MAX_RHO, MIN_RHO = 4.0, -4.0
THETA_STEP, RHO_STEP = np.pi / 45, 0.2
THRESHOLD, W_SIZE = 25, 4
MAX_LINE_GAP, MIN_LINE_LENGTH = 0.8, 0.6


def extract_lines_hough(points, covs, params: ExtractorConfig) -> Segments:
    pts = np.asarray(points, dtype=np.float64)
    covs = np.asarray(covs, dtype=np.float64)
    n = len(pts)
    if n == 0:
        return Segments.empty()
    num_angle = int(np.floor((MAX_THETA - MIN_THETA) / THETA_STEP))
    num_rho = int(np.ceil((MAX_RHO - MIN_RHO) / RHO_STEP))
    thetas = MIN_THETA + THETA_STEP * np.arange(num_angle)
    trig = np.stack([np.cos(thetas), np.sin(thetas)], 1)  # (T,2)

    # accumulate: rho bin of each (point, theta)
    rho = pts @ trig.T  # (N, T)
    rbin = np.round((rho - MIN_RHO) / RHO_STEP).astype(int)
    valid = (rbin >= 0) & (rbin < num_rho)
    counts = np.zeros((num_angle, num_rho), int)
    np.add.at(
        counts,
        (
            np.broadcast_to(np.arange(num_angle), (n, num_angle))[valid],
            rbin[valid],
        ),
        1,
    )

    # window non-max suppression (hough.h maxWindow over +-w_size in
    # theta, +-1 in rho): keep cells above threshold that dominate
    peaks = []
    c = counts.copy()
    order = np.argsort(counts.ravel())[::-1]
    for flat in order:
        t, r = np.unravel_index(flat, counts.shape)
        if counts[t, r] <= THRESHOLD:
            break  # all remaining cells are below threshold
        if c[t, r] == 0:
            continue  # suppressed by a stronger nearby peak
        t0, t1 = max(0, t - W_SIZE), min(num_angle, t + W_SIZE + 1)
        r0, r1 = max(0, r - 1), min(num_rho, r + 1 + 1)
        if counts[t, r] < counts[t0:t1, r0:r1].max():
            continue
        peaks.append((t, r))
        c[t0:t1, r0:r1] = 0

    seg_rt, seg_cov, seg_se = [], [], []
    for t, r in peaks:
        sel = valid[:, t] & (np.abs(rbin[:, t] - r) <= 1)
        idx = np.nonzero(sel)[0]
        if len(idx) <= THRESHOLD:
            continue
        line_rt = np.array([MIN_RHO + r * RHO_STEP, thetas[t]])
        sp, d = calc_start_dir(line_rt)
        tvals = (pts[idx] - sp) @ d
        order2 = np.argsort(tvals)
        idx, tvals = idx[order2], tvals[order2]
        # gap-based splitting (hough.h split_seg)
        breaks = np.nonzero(np.diff(tvals) >= MAX_LINE_GAP)[0]
        start = 0
        for b in list(breaks) + [len(idx) - 1]:
            chunk = idx[start : b + 1]
            tv = tvals[start : b + 1]
            start = b + 1
            if len(chunk) <= THRESHOLD:
                continue
            if tv[-1] - tv[0] <= MIN_LINE_LENGTH:
                continue
            rt, cv = fit_line_with_cov(pts[chunk], covs[chunk])
            sp2, d2 = calc_start_dir(rt)
            t2 = (pts[chunk] - sp2) @ d2
            seg_rt.append(np.asarray(rt))
            seg_cov.append(np.asarray(cv))
            seg_se.append(
                (sp2 + t2.min() * d2, sp2 + t2.max() * d2)
            )

    if not seg_rt:
        return Segments.empty()

    # overlap merge (hough.h merge_overlap): drop the worse of two
    # overlapping near-collinear segments
    drop = set()
    for i in range(len(seg_rt)):
        for j in range(len(seg_rt)):
            if i == j or i in drop or j in drop:
                continue
            rt_i = seg_rt[i]
            sp_i, dir_i = calc_start_dir(rt_i)
            perp_i = np.array(
                [np.cos(rt_i[1]), np.sin(rt_i[1])]
            )
            s2, e2 = seg_se[j]
            dp_s = (s2 - sp_i) @ perp_i
            dp_e = (e2 - sp_i) @ perp_i
            tp_s = (s2 - sp_i) @ dir_i
            tp_e = (e2 - sp_i) @ dir_i
            si, ei = seg_se[i]
            ti0 = (si - sp_i) @ dir_i
            ti1 = (ei - sp_i) @ dir_i
            lo, hi = min(ti0, ti1), max(ti0, ti1)
            if (
                abs(dp_s + dp_e) < 0.4
                and lo - 0.15 < tp_s < hi + 0.15
                and lo - 0.15 < tp_e < hi + 0.15
            ):
                len_i = np.linalg.norm(ei - si)
                len_j = np.linalg.norm(e2 - s2)
                if abs(len_j - len_i) < 0.1:
                    # drop the higher-variance one: use cov trace proxy
                    drop.add(i if np.trace(seg_cov[i]) > np.trace(seg_cov[j]) else j)
                else:
                    drop.add(i if len_i < len_j else j)
    keep = [k for k in range(len(seg_rt)) if k not in drop]
    return Segments(
        np.stack([seg_rt[k] for k in keep]),
        np.stack([seg_cov[k] for k in keep]),
        np.stack([seg_se[k][0] for k in keep]),
        np.stack([seg_se[k][1] for k in keep]),
    )
