"""SMF line extraction: prototype-based fuzzy split-merge.

Re-implements the reference's alternative extractor
(src/ls_extractor/src/impl/smf.cpp:1-325, smf.h): recursive
prototype-based fuzzying (PBF) -- a point set whose dispersion exceeds
0.06 m is split into two fuzzy line prototypes whose membership weights
uj iterate to convergence (fuzzy c-means with m=3) -- followed by
dispersion-ranked merging (merge2) and membership-weighted LSQ fits
with covariance.

Selectable like the reference's compile-time include swap
(src/ls_extractor/README.md:9) via ExtractorConfig.algorithm = "smf".
Host numpy; a copy of sparse_gslam_tpu/ops/lines_smf.py.

Deviation: the reference's SMF leastSqFit never refreshes rho after
updating theta (smf.cpp:78-84 -- rho keeps its initialization), which
the cited CDC-ECC'05 formulation does not intend; we restore
rho = xybar . (cos theta, sin theta). Membership-weighted covariance
replicates the reference's Jacobian including its d = xybar - u*p term
(smf.cpp:96-104).
"""
from __future__ import annotations

import numpy as np

from .line_geometry import calc_start_dir, check_rhotheta, topolar
from .lines import Segments
from ..utils.config import ExtractorConfig

_M = 3.0  # fuzzifier
_DISPERSION_THRESH = 0.06


class _FuzzySeg:
    __slots__ = ("idx", "uj", "rhotheta", "dj", "cov")

    def __init__(self, idx, uj=None, rhotheta=None):
        self.idx = np.asarray(idx, dtype=np.int64)
        self.uj = (
            np.ones(len(self.idx)) if uj is None else np.asarray(uj)
        )
        self.rhotheta = rhotheta
        self.dj = None
        self.cov = None


def _xybar(pts, uj):
    um = uj**_M
    s = um.sum()
    return (pts * um[:, None]).sum(0) / s, s


def _fit(pts, covs, seg: _FuzzySeg, calc_dij=False, calc_cov=False):
    p = pts[seg.idx]
    um = seg.uj**_M
    xybar, sum_uj = _xybar(p, seg.uj)
    d = p - xybar
    Sx2 = (um * d[:, 0] * d[:, 0]).sum()
    Sy2 = (um * d[:, 1] * d[:, 1]).sum()
    Sxy = (um * d[:, 0] * d[:, 1]).sum()
    Sy2_Sx2 = Sy2 - Sx2
    theta = 0.5 * np.arctan2(-2.0 * Sxy, Sy2_Sx2)
    rho = xybar @ [np.cos(theta), np.sin(theta)]
    seg.rhotheta = np.asarray(check_rhotheta(np.array([rho, theta])))
    if calc_dij:
        ct, st = np.cos(seg.rhotheta[1]), np.sin(seg.rhotheta[1])
        dist = seg.rhotheta[0] - p[:, 0] * ct - p[:, 1] * st
        seg.dj = dist * dist + ((p - xybar) ** 2).sum(1)
    if calc_cov:
        ct, st = np.cos(seg.rhotheta[1]), np.sin(seg.rhotheta[1])
        denum = 1.0 / (Sy2_Sx2 * Sy2_Sx2 + 4.0 * Sxy * Sxy)
        du = xybar[None, :] - um[:, None] * p  # smf.cpp:100 (u inside)
        A10 = (du[:, 1] * Sy2_Sx2 + 2 * Sxy * du[:, 0]) * denum
        A11 = (du[:, 0] * Sy2_Sx2 - 2 * Sxy * du[:, 1]) * denum
        k = xybar[1] * ct - xybar[0] * st
        A00 = ct / sum_uj * um + k * A10
        A01 = st / sum_uj * um + k * A11
        A = np.stack(
            [np.stack([A00, A01], -1), np.stack([A10, A11], -1)], -2
        )
        seg.cov = np.einsum(
            "nij,njk,nlk->il", A, covs[seg.idx], A
        )


def _dispersion(pts, seg: _FuzzySeg) -> float:
    p = pts[seg.idx]
    trig = np.array(
        [np.cos(seg.rhotheta[1]), np.sin(seg.rhotheta[1])]
    )
    v = seg.rhotheta[0] - p @ trig
    return float(np.sqrt((v * v).mean()))


def _satisfy(pts, seg: _FuzzySeg, max_gap, min_length) -> bool:
    """smf.cpp:124-141 satisfy_param."""
    start, direction = calc_start_dir(seg.rhotheta)
    t = np.sort((pts[seg.idx] - start) @ direction)
    if t[-1] - t[0] < min_length:
        return False
    return not np.any(np.diff(t) >= max_gap)


def _pbf(pts, covs, seg: _FuzzySeg, out, params):
    """Recursive prototype-based fuzzying (smf.cpp:256-324)."""
    N = len(seg.idx)
    if N <= params.min_line_points:
        return
    if _dispersion(pts, seg) <= _DISPERSION_THRESH:
        _fit(pts, covs, seg, calc_cov=True)
        out.append(seg)
        return
    p = pts[seg.idx]
    protos = [
        _FuzzySeg(seg.idx, rhotheta=np.asarray(topolar(p[0], p[1]))),
        _FuzzySeg(seg.idx, rhotheta=np.asarray(topolar(p[-1], p[-2]))),
    ]
    for pr in protos:
        xb, _ = _xybar(p, pr.uj)
        ct, st = np.cos(pr.rhotheta[1]), np.sin(pr.rhotheta[1])
        dist = pr.rhotheta[0] - p[:, 0] * ct - p[:, 1] * st
        pr.dj = dist * dist + ((p - xb) ** 2).sum(1)

    for _ in range(100):
        converged = True
        for i in range(2):
            ratio = np.zeros(N)
            for k in range(2):
                ratio += (protos[i].dj / protos[k].dj) ** (
                    1.0 / (_M - 1.0)
                )
            new_u = 1.0 / ratio
            if np.any(np.abs(protos[i].uj - new_u) > 5e-4):
                converged = False
            protos[i].uj = new_u
        if converged:
            break
        for pr in protos:
            _fit(pts, covs, pr, calc_dij=True)
    else:
        return  # not converged: abort (smf.cpp:322)

    assign = protos[0].uj < protos[1].uj  # True -> proto 1
    if assign.all() or (~assign).all():
        return  # no progress (smf.cpp:305-308)
    for i, mask in enumerate([~assign, assign]):
        child = _FuzzySeg(
            seg.idx[mask], uj=protos[i].uj[mask],
            rhotheta=protos[i].rhotheta,
        )
        _pbf(pts, covs, child, out, params)


def _merge2(pts, covs, segs, params):
    """Dispersion-ranked merge (smf.cpp:202-253): repeatedly fuse a
    segment with one of its two closest-centroid peers when the fused
    dispersion stays below the threshold."""
    changed = True
    while changed and len(segs) > 1:
        changed = False
        for i in range(len(segs)):
            xb_i, _ = _xybar(pts[segs[i].idx], segs[i].uj)
            dists = []
            for j in range(i + 1, len(segs)):
                xb_j, _ = _xybar(pts[segs[j].idx], segs[j].uj)
                dists.append((float(((xb_j - xb_i) ** 2).sum()), j))
            dists.sort()
            best = None
            for _, j in dists[:2]:
                pi = pts[segs[i].idx]
                pj = pts[segs[j].idx]
                gap = np.sqrt(
                    ((pi[:, None, :] - pj[None, :, :]) ** 2)
                    .sum(-1)
                    .min()
                )
                if gap > params.max_line_gap:
                    continue
                fused = _FuzzySeg(
                    np.concatenate([segs[i].idx, segs[j].idx]),
                    uj=np.concatenate([segs[i].uj, segs[j].uj]),
                    rhotheta=segs[i].rhotheta,
                )
                _fit(pts, covs, fused)
                disp = _dispersion(pts, fused)
                if best is None or disp < best[0]:
                    best = (disp, j, fused)
            if best is not None and best[0] <= _DISPERSION_THRESH:
                segs[i] = best[2]
                del segs[best[1]]
                changed = True
                break
    return segs


def extract_lines_smf(points, covs, params: ExtractorConfig) -> Segments:
    """Full SMF pipeline (smf.cpp:144-167 extract_lines)."""
    pts = np.asarray(points, dtype=np.float64)
    covs = np.asarray(covs, dtype=np.float64)
    if len(pts) <= params.min_line_points:
        return Segments.empty()
    root = _FuzzySeg(np.arange(len(pts)))
    _fit(pts, covs, root)
    out: list[_FuzzySeg] = []
    _pbf(pts, covs, root, out, params)
    out = [s for s in out if _satisfy(pts, s, params.max_line_gap, 0.0)]
    out = _merge2(pts, covs, out, params)
    for s in out:
        _fit(pts, covs, s, calc_cov=True)
    out = [
        s
        for s in out
        if len(s.idx) >= params.min_line_points
        and _satisfy(pts, s, params.max_line_gap, params.min_line_length)
    ]
    if not out:
        return Segments.empty()
    rts = np.stack([s.rhotheta for s in out])
    cvs = np.stack([s.cov for s in out])
    starts, ends = [], []
    for s in out:
        sp, d = calc_start_dir(s.rhotheta)
        t = (pts[s.idx] - sp) @ d
        starts.append(sp + t.max() * d)  # smf.cpp:109-120 order
        ends.append(sp + t.min() * d)
    return Segments(rts, cvs, np.stack(starts), np.stack(ends))
