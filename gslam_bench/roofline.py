"""The least time each hand-written kernel could take for one launch,
from the launch's own inputs: the larger of the bytes it must move over
the card's memory bandwidth and its float32 operations over the card's
float32 peak (peaks.json). Frozen copies of chip_smoke.py's
insertion_bound and refine_bound_parts; they count the work the inputs
need, whatever implements the kernel.
"""
from __future__ import annotations

import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# float32 operations of the refinement per padded point (an FMA counts
# two; compares, selects and conversions none): the evaluation without
# the Jacobian 89, its Jacobian 272 more; per residual row the residual
# 3 and its Jacobian row 6; per covariance row 4
OPS_EVAL, OPS_JAC = 89, 272
OPS_RESIDUAL, OPS_JAC_ROW, OPS_COV_ROW = 3, 6, 4


def peaks(kind: str):
    """(bytes/s, float32 operations/s) of the card named `kind`, or None
    for a card the table does not hold."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        row = json.load(f)["cards"].get(kind)
    return None if row is None else (row["bytes_per_s"],
                                     row["f32_ops_per_s"])


def insertion_work(args) -> tuple:
    """(bytes, operations) of one insertion launch, from the arguments
    of insert_rays_cuda(probs, origin, scan_origins, scan_points,
    scan_kind, hit_miss_p, resolution, n_steps, size): the grid read and
    written once, the scans read once; 10 operations per valid ray
    sample and 4 per hit for the cell arithmetic, 7 per cell update (a
    distinct (scan, cell) pair among the in-grid samples and hits)."""
    probs, org, origins, pts, kind, hm, res, n_steps, size = args
    nbytes = (2 * probs.numel() * 4 + origins.numel() * 4
              + pts.numel() * 4 + kind.numel() + hm.numel() * 4 + 8)
    valid = kind > 0
    n_valid = int(valid.sum())
    n_hits = int((kind == 1).sum())
    dev = probs.device
    ts = ((torch.arange(n_steps, device=dev, dtype=torch.float64) + 0.5)
          / n_steps).float()
    ray = origins[:, None, None, :] + (pts - origins[:, None, :])[
        :, :, None, :] * ts[None, None, :, None]
    cells = torch.floor((ray - org) / res).long()
    ends = torch.floor((pts - org) / res).long()
    inb = ((cells >= 0) & (cells < size)).all(-1) & valid[..., None]
    s_idx = torch.arange(kind.shape[0], device=dev)[:, None, None].expand(
        inb.shape)
    keys = (s_idx * size + cells[..., 0]) * size + cells[..., 1]
    e_inb = ((ends >= 0) & (ends < size)).all(-1) & (kind == 1)
    e_keys = (torch.arange(kind.shape[0], device=dev)[:, None] * size
              + ends[..., 0]) * size + ends[..., 1]
    n_updates = int(torch.unique(torch.cat([keys[inb], e_keys[e_inb]]))
                    .numel())
    return nbytes, 10 * n_valid * n_steps + 4 * n_hits + 7 * n_updates


def refine_work(n: int, steps, want_cov: bool = True) -> tuple:
    """(bytes, operations) of one refinement of N = n padded points whose
    stages ran `steps` GN steps each (the kernel's steps output; 0 for a
    stage not run). Bytes: the points, mask, initial pose, origins and
    one rsqrt table entry read once, pose, covariance and probabilities
    written once; the grid cells the bicubic taps read are left out (the
    bound is then at most the true one). Operations, per GN step: the
    evaluation with the Jacobian and the trial's without, then over the
    K = N + 3 rows J^T J (18 K), J^T r (6 K and 24 for the lanes' sum),
    the two sums of squares (2 K and a sum of the windows each) and the
    anchor rows (10); with want_cov each stage's probabilities and the
    last stage's Jacobian, J^T J (18 N) and sum of squares (2 N)."""
    K = n + 3
    nw, nwc = -(-K // 32), -(-n // 32)
    n_stages = sum(1 for s in steps if s > 0) or 1
    nbytes = (n * 9 + 12 + 8 * n_stages + 4 + 12
              + (36 + n * 4 if want_cov else 0))
    per_it = (n * (2 * OPS_EVAL + OPS_JAC + 2 * OPS_RESIDUAL + OPS_JAC_ROW)
              + K * (18 + 6 + 2 + 2) + 24 + 2 * nw + 10)
    ops = sum(int(s) for s in steps) * per_it
    if want_cov:
        ops += (n_stages * n * OPS_EVAL
                + n * (OPS_JAC + OPS_COV_ROW + 18 + 2) + nwc)
    return nbytes, ops


def bound_s(nbytes: float, ops: float, peak: tuple) -> float:
    """Least seconds for `nbytes` and `ops` on a card of `peak`."""
    bw, flops = peak
    return max(nbytes / bw, ops / flops)
