"""SMC line-segment extraction (split-merge + clustering) with full
covariance propagation.

Re-implements the reference's default extractor algorithm
(src/ls_extractor/src/impl/smc.cpp:1-256, smc.h:1-44) from its math:

  1. agglomerative clustering with a pairwise distance threshold
     (smc.cpp:78-98); all shipped configs set cluster_threshold=100 so a
     single-cluster fast path matches evaluated behavior
  2. per cluster: sort by bearing, neighbor-rho outlier rejection
     (smc.cpp:129-147), recursive split at max-distance point or max gap
     (smc.cpp:160-196), min-points/min-length filtering (smc.cpp:151-154)
  3. weighted least-squares (rho,theta) fit with covariance propagated
     from per-point 2x2 covariances via per-point Jacobians
     (smc.cpp:30-68; formulas from "Mobile robot SLAM for line-based
     environment representation", CDC-ECC'05 appendix)
  4. chi^2-gated information-fusion merge (smc.cpp:198-254). NOTE: as
     shipped the reference's merge is unreachable -- gapBetween
     (smc.cpp:14-26) initializes its accumulator to 1e10 and only
     replaces it with larger values, so the gap test always fails.
     merge_mode="reference" replicates that (no merging);
     merge_mode="correct" implements the intended min-gap fusion.
  5. endpoint projection onto the fitted line (smc.cpp:70-76)

The interior split recursion is tiny (<= multicloud_size ~ 176 points)
and data-dependent, so it runs on host in numpy; the numeric core
(fit_line_with_cov) is array-polymorphic (numpy arrays or torch
tensors). Frozen copy of sparse_gslam_tpu_torch/ops/lines.py without
the smf and hough extractors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .line_geometry import calc_start_dir, check_rhotheta, topolar
from ..utils.config import ExtractorConfig
from ..utils.se2 import _xp


@dataclasses.dataclass
class Segments:
    """Extracted segments as struct-of-arrays.

    rhotheta: (S, 2) fitted line params; cov: (S, 2, 2) parameter
    covariance; start/end: (S, 2) endpoints projected onto the line
    (reference: _LineSegment fields, defs.h:31-39).
    """

    rhotheta: np.ndarray
    cov: np.ndarray
    start: np.ndarray
    end: np.ndarray

    @property
    def n(self) -> int:
        return len(self.rhotheta)

    @classmethod
    def empty(cls) -> "Segments":
        z2 = np.zeros((0, 2))
        return cls(z2, np.zeros((0, 2, 2)), z2.copy(), z2.copy())

    @classmethod
    def concatenate(cls, parts) -> "Segments":
        parts = list(parts)
        if not parts:
            return cls.empty()
        return cls(
            np.concatenate([p.rhotheta for p in parts]),
            np.concatenate([p.cov for p in parts]),
            np.concatenate([p.start for p in parts]),
            np.concatenate([p.end for p in parts]),
        )


def fit_line_with_cov(points, covs, mask=None):
    """Weighted LSQ (rho,theta) fit + covariance (smc.cpp:30-68).

    points: (..., N, 2), covs: (..., N, 2, 2), mask: (..., N) optional
    validity mask (fixed-shape path). Returns (rhotheta (...,2),
    cov (...,2,2)). Array-polymorphic: numpy or torch.
    """
    xp = _xp(points, covs)
    if mask is None:
        n = points.shape[-2]
        w = xp.ones(points.shape[:-1], dtype=points.dtype)
    else:
        w = mask.astype(points.dtype)
        n = w.sum(-1)[..., None]
    wsum = w.sum(-1)[..., None]
    xybar = (points * w[..., None]).sum(-2) / wsum
    d = xybar[..., None, :] - points  # matches smc.cpp:59 (xybar - point)
    dm = d * w[..., None]
    Sx2 = (dm[..., 0] * d[..., 0]).sum(-1)
    Sy2 = (dm[..., 1] * d[..., 1]).sum(-1)
    Sxy = (dm[..., 0] * d[..., 1]).sum(-1)

    Sy2_Sx2 = Sy2 - Sx2
    theta = 0.5 * xp.arctan2(-2.0 * Sxy, Sy2_Sx2)
    rho = xybar[..., 0] * xp.cos(theta) + xybar[..., 1] * xp.sin(theta)
    rhotheta = check_rhotheta(xp.stack([rho, theta], axis=-1))
    ct = xp.cos(rhotheta[..., 1])
    st = xp.sin(rhotheta[..., 1])

    denum = 1.0 / (Sy2_Sx2 * Sy2_Sx2 + 4.0 * Sxy * Sxy)
    nn = wsum[..., 0]
    # per-point Jacobian rows (smc.cpp:62-65)
    A10 = (d[..., 1] * Sy2_Sx2[..., None] + 2.0 * Sxy[..., None] * d[..., 0]) * denum[..., None]
    A11 = (d[..., 0] * Sy2_Sx2[..., None] - 2.0 * Sxy[..., None] * d[..., 1]) * denum[..., None]
    k = (xybar[..., 1] * ct - xybar[..., 0] * st)[..., None]
    A00 = (ct / nn)[..., None] + k * A10
    A01 = (st / nn)[..., None] + k * A11
    # cov = sum_i A_i C_i A_i^T with A_i = [[A00,A01],[A10,A11]]
    A = xp.stack(
        [xp.stack([A00, A01], axis=-1), xp.stack([A10, A11], axis=-1)],
        axis=-2,
    )  # (..., N, 2, 2)
    AC = xp.einsum("...nij,...njk->...nik", A, covs)
    ACA = xp.einsum("...nik,...nlk->...nil", AC, A)
    cov = (ACA * w[..., None, None]).sum(-3)
    return rhotheta, cov


def _dist_to_line(rhotheta, pts_polar):
    """|rho_p cos(theta_p - theta_l) - rho_l| (defs.h:36-38)."""
    return np.abs(
        pts_polar[:, 0] * np.cos(pts_polar[:, 1] - rhotheta[1]) - rhotheta[0]
    )


def _split(points, polar, start, end, params, out_ranges):
    """Recursive split (smc.cpp:160-196), iterative over an explicit stack."""
    stack = [(start, end)]
    while stack:
        s, e = stack.pop()
        if e - s <= 1:
            continue
        line = topolar(points[s], points[e - 1])
        gaps = np.linalg.norm(points[s + 1 : e] - points[s : e - 1], axis=1)
        i_gap_rel = 0
        gap_max = gaps[0]
        if len(gaps) > 1:
            # reference scans pairs (s,s+1) then (s+1,s+2)..(e-2,e-1) with
            # strict > comparison -> first maximum wins
            rest = gaps[1:]
            j = int(np.argmax(rest))
            if rest[j] > gap_max:
                gap_max = rest[j]
                i_gap_rel = j + 1
        if e - s > 2:
            d = _dist_to_line(line, polar[s + 1 : e - 1])
            j = int(np.argmax(d))
            dist_max = d[j]
            i_max = s + 1 + j
        else:
            dist_max = 0.0
            i_max = s + 1
        if dist_max < params.min_split_dist and gap_max < params.max_line_gap:
            out_ranges.append((s, e))
        else:
            i_split = i_max if dist_max >= params.min_split_dist else s + i_gap_rel + 1
            # preserve reference recursion order (left first)
            stack.append((i_split, e))
            stack.append((s, i_split))


def _extract_cluster(points, polar, covs, params: ExtractorConfig):
    """extract_lines_helper (smc.cpp:129-158) for one cluster.

    Returns (rhotheta (S,2), cov (S,2,2), ranges, filtered points/polar)
    where ranges index into the filtered arrays.
    """
    order = np.argsort(polar[:, 1], kind="stable")
    points = points[order]
    polar = polar[order]
    covs = covs[order]
    n = len(points)

    # neighbor-rho outlier rejection (smc.cpp:132-146). Reads the original
    # sorted arrays (compaction in the reference never clobbers unread slots).
    keep = np.ones(n, dtype=bool)
    if n > 2:
        rho = polar[:, 0]
        prev_far = np.abs(rho[:-2] - rho[1:-1]) >= params.outlier_dist
        next_far = np.abs(rho[2:] - rho[1:-1]) >= params.outlier_dist
        cand = np.nonzero(prev_far & next_far)[0] + 1
        if len(cand):
            lines = topolar(points[cand - 1], points[cand + 1])
            d = np.abs(
                polar[cand, 0] * np.cos(polar[cand, 1] - lines[:, 1])
                - lines[:, 0]
            )
            keep[cand[d > params.min_split_dist]] = False
    points, polar, covs = points[keep], polar[keep], covs[keep]

    ranges: list[tuple[int, int]] = []
    _split(points, polar, 0, len(points), params, ranges)
    # min-points / min-length filter (smc.cpp:151-154)
    ranges = [
        (s, e)
        for (s, e) in ranges
        if e - s >= params.min_line_points
        and np.linalg.norm(points[s] - points[e - 1]) >= params.min_line_length
    ]
    if not ranges:
        return (
            np.zeros((0, 2)),
            np.zeros((0, 2, 2)),
            ranges,
            points,
            polar,
            covs,
        )
    rts, cvs = [], []
    for s, e in ranges:
        rt, cv = fit_line_with_cov(points[s:e], covs[s:e])
        rts.append(rt)
        cvs.append(cv)
    return np.stack(rts), np.stack(cvs), ranges, points, polar, covs


def _cluster(points, threshold):
    """Union-find clustering by pairwise distance (smc.cpp:78-98).

    Returns a list of index arrays (cluster members, original order).
    """
    n = len(points)
    if n == 0:
        return []
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    adj = d2 <= threshold * threshold
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    ncomp, labels = csgraph.connected_components(
        sp.csr_matrix(adj), directed=False
    )
    return [np.nonzero(labels == c)[0] for c in range(ncomp)]


def _project_endpoints(rhotheta, p_first, p_last):
    """projectEndpoints (smc.cpp:70-76)."""
    start, direction = calc_start_dir(rhotheta)
    t0 = ((p_first - start) * direction).sum(-1)
    t1 = ((p_last - start) * direction).sum(-1)
    lo = np.minimum(t0, t1)
    hi = np.maximum(t0, t1)
    return start + lo[..., None] * direction, start + hi[..., None] * direction


def _fuse(rt_a, cov_a, rt_b, cov_b):
    """Information-weighted line fusion (smc.cpp:210-216, eq. 13-14)."""
    ia = np.linalg.inv(cov_a)
    ib = np.linalg.inv(cov_b)
    cov = np.linalg.inv(ia + ib)
    rt = cov @ (ia @ rt_a + ib @ rt_b)
    return rt, cov


def _merge_chi2(rt_a, cov_a, rt_b, cov_b):
    dL = rt_b - rt_a
    return float(dL @ np.linalg.inv(cov_a + cov_b) @ dL)


def _min_gap(pts_a, pts_b):
    """Minimum endpoint-pair distance -- the *intended* semantics of the
    reference's gapBetween (smc.cpp:14-26), whose comparison direction
    bug makes it return sqrt(1e10) instead."""
    d = np.linalg.norm(pts_a[:, None, :] - pts_b[None, :, :], axis=-1)
    return float(d.min())


def extract_lines(points, covs, params: ExtractorConfig) -> Segments:
    """Full SMC pipeline (smc.cpp:100-127 extract_lines).

    points: (N, 2) float, covs: (N, 2, 2) per-point covariance.
    """
    points = np.asarray(points, dtype=np.float64)
    covs = np.asarray(covs, dtype=np.float64)
    polar = np.stack(
        [np.linalg.norm(points, axis=1), np.arctan2(points[:, 1], points[:, 0])],
        axis=1,
    )

    if params.cluster_threshold >= 50.0 or len(points) <= 1:
        clusters = [np.arange(len(points))]
    else:
        clusters = _cluster(points, params.cluster_threshold)

    seg_rt, seg_cov, seg_pts = [], [], []
    n_clusters_used = 0
    for idx in clusters:
        if len(idx) < params.min_line_points:
            continue
        n_clusters_used += 1
        rts, cvs, ranges, fp, _, _ = _extract_cluster(
            points[idx], polar[idx], covs[idx], params
        )
        for (s, e), rt, cv in zip(ranges, rts, cvs):
            seg_rt.append(rt)
            seg_cov.append(cv)
            seg_pts.append((fp[s], fp[e - 1]))

    if not seg_rt:
        return Segments.empty()

    if params.merge_mode == "correct" and len(seg_rt) > 1:
        # adjacent merge (single cluster) / pairwise merge (multi cluster)
        # with the intended min-gap semantics (smc.cpp:198-254)
        merged = True
        while merged:
            merged = False
            for i in range(len(seg_rt)):
                for j in range(i + 1, len(seg_rt)):
                    chi2 = _merge_chi2(
                        seg_rt[i], seg_cov[i], seg_rt[j], seg_cov[j]
                    )
                    gap = _min_gap(
                        np.stack(seg_pts[i]), np.stack(seg_pts[j])
                    )
                    if chi2 < 4.605 and gap <= params.max_line_gap:
                        seg_rt[i], seg_cov[i] = _fuse(
                            seg_rt[i], seg_cov[i], seg_rt[j], seg_cov[j]
                        )
                        # extend extremal points
                        cand = np.stack(
                            [*seg_pts[i], *seg_pts[j]]
                        )
                        s0, d0 = calc_start_dir(seg_rt[i])
                        t = ((cand - s0) * d0).sum(-1)
                        seg_pts[i] = (cand[np.argmin(t)], cand[np.argmax(t)])
                        del seg_rt[j], seg_cov[j], seg_pts[j]
                        merged = True
                        break
                if merged:
                    break
    # merge_mode == "reference": merging disabled (matches shipped behavior)

    rts = np.stack(seg_rt)
    cvs = np.stack(seg_cov)
    firsts = np.stack([p[0] for p in seg_pts])
    lasts = np.stack([p[1] for p in seg_pts])
    starts, ends = _project_endpoints(rts, firsts, lasts)
    return Segments(rts, cvs, starts, ends)


def extract_lines_any(points, covs, params: ExtractorConfig) -> Segments:
    """Dispatch on params.algorithm (the reference's compile-time
    include swap, ls_extractor/README.md:9)."""
    if params.algorithm == "smc":
        return extract_lines(points, covs, params)
    # the benchmark's configurations use smc; the frozen copy leaves the
    # smf and hough extractors out
    raise ValueError(f"the reference has no extractor {params.algorithm!r}")
