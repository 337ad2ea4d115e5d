"""Probability occupancy grids: odds-space hit/miss insertion with
per-scan update semantics (reference: Cartographer's ProbabilityGrid +
MultirangeDataInserter, src/cartographer_bindings/
range_data_inserter_2d.cc:51-94). Port of sparse_gslam_tpu/ops/grid.py.

`insert_rays` is the dispatching wrapper: a CUDA grid goes to the
hand-written kernel (ops/grid_cuda.py, csrc/insert_rays.cu), a CPU grid
to `insert_rays_plain`, the literal torch port of the JAX function.
There is no fallback between the two.

Probability semantics match Cartographer: p clamped to
[PMIN, PMAX] = [0.1, 0.9], unknown cells stored as 0, odds-space
multiplicative updates p' = odds^-1(odds(p_obs) * odds(p)). The grid
path is float32 throughout, as in the JAX package.

Bit parity with the JAX package. XLA's CPU backend, which computes the
reference maps, rewrites the division by the (static) resolution into
a multiplication by its float32 reciprocal, and contracts the ray point
s + (e - s) * t into one fused multiply-add. Both are carried over
here (`cell_index`, `_fma_f32`) and in the CUDA kernel, so the three
agree bit for bit; the odds update itself is not contracted by XLA.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import se2

PMIN = 0.1
PMAX = 0.9


def odds(p):
    return p / (1.0 - p)


def odds_inv(o):
    return o / (1.0 + o)


class GridSpec(NamedTuple):
    size: int  # cells per side (square, static)
    resolution: float

    @property
    def extent(self) -> float:
        return self.size * self.resolution


class SubmapGrid(NamedTuple):
    """One submap's occupancy grid. origin = world coords of cell (0,0)
    corner, in the submap's anchor frame."""

    probs: torch.Tensor  # (size, size) float32, 0 = unknown
    origin: torch.Tensor  # (2,) float32
    resolution: float


def cell_index(points, origin, resolution):
    """world float32 points (...,2) -> integer cells (...,2) [ix, iy],
    as XLA computes floor((points - origin) / resolution): times the
    float32 reciprocal of the resolution."""
    inv_res = 1.0 / torch.tensor(resolution, dtype=torch.float32,
                                 device=points.device)
    return torch.floor((points - origin) * inv_res).to(torch.int32)


def _fma_f32(a, b, c):
    """float32 a * b + c rounded once, like a fused multiply-add.

    The product of two float32 values is exact in float64; the float64
    sum is rounded to odd (TwoSum error, then the last bit forced to 1
    when inexact), after which rounding to float32 is correct."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def insert_rays_plain(
    probs,
    origin,
    scan_origins,  # (S, 2) per-scan ray origin
    scan_points,  # (S, B, 2) endpoints
    scan_kind,  # (S, B) int8: 0=invalid, 1=hit, 2=miss(at range_max)
    hit_miss_p,  # (2,) [hit_probability, miss_probability]
    resolution: float,
    n_steps: int,
    size: int,
):
    """Plain torch version of the insertion (grid.py:65-151 of the JAX
    package, operation for operation): per scan, a hit mask and a miss
    mask scattered with `index_put_`, then one `torch.where` update.
    Runs on any device; `insert_rays` sends only CPU grids here.

    Misses trace the whole ray; hits mark only the endpoint cell and
    trace the ray as miss up to (not including) the endpoint cell.
    """
    dev = probs.device
    # t in float32: the JAX package's (arange + 0.5) / n_steps is a
    # weakly typed value that joins the float32 ray arithmetic
    ts = (torch.arange(n_steps, device=dev, dtype=torch.float64) + 0.5)
    ts = (ts / n_steps).to(torch.float32)
    hit_p, miss_p = hit_miss_p[0], hit_miss_p[1]
    # masks carry one spare row/column: out-of-grid writes land there
    # and are cut away (the JAX scatter's mode="drop")
    for s in range(scan_kind.shape[0]):
        s_origin, pts, kind = scan_origins[s], scan_points[s], scan_kind[s]
        valid = kind > 0
        is_hit = kind == 1

        end_cells = cell_index(pts, origin, resolution)  # (B,2)
        # s_origin + (pts - s_origin) * t, one rounding as in XLA
        ray_pts = _fma_f32(
            (pts - s_origin[None, :])[:, None, :],
            ts[None, :, None],
            s_origin[None, None, :].expand(pts.shape[0], n_steps, 2),
        )  # (B, T, 2)
        ray_cells = cell_index(ray_pts, origin, resolution)  # (B, T, 2)

        oob_h = (
            (end_cells[:, 0] < 0)
            | (end_cells[:, 0] >= size)
            | (end_cells[:, 1] < 0)
            | (end_cells[:, 1] >= size)
        )
        h_idx = torch.where(
            (is_hit & valid & ~oob_h)[:, None], end_cells, size
        ).long()
        hit_mask = torch.zeros((size + 1, size + 1), dtype=torch.bool,
                               device=dev)
        hit_mask[h_idx[:, 0], h_idx[:, 1]] = True
        hit_mask = hit_mask[:size, :size]

        not_end = ~(
            (ray_cells[..., 0] == end_cells[:, None, 0])
            & (ray_cells[..., 1] == end_cells[:, None, 1])
            & is_hit[:, None]
        )
        m_valid = valid[:, None] & not_end
        oob_m = (
            (ray_cells[..., 0] < 0)
            | (ray_cells[..., 0] >= size)
            | (ray_cells[..., 1] < 0)
            | (ray_cells[..., 1] >= size)
        )
        m_idx = torch.where(
            (m_valid & ~oob_m)[..., None], ray_cells, size
        ).reshape(-1, 2).long()
        miss_mask = torch.zeros((size + 1, size + 1), dtype=torch.bool,
                                device=dev)
        miss_mask[m_idx[:, 0], m_idx[:, 1]] = True
        miss_mask = miss_mask[:size, :size] & ~hit_mask  # hits beat misses

        known = probs > 0.0
        p_eff = torch.where(known, probs, 0.5)

        def apply(p, obs_p):
            newp = odds_inv(odds(obs_p) * odds(p))
            return torch.clamp(newp, PMIN, PMAX)

        # unknown cell first observed: becomes p_obs directly
        p_hit = torch.where(known, apply(p_eff, hit_p), hit_p)
        p_miss = torch.where(known, apply(p_eff, miss_p), miss_p)
        probs = torch.where(
            hit_mask, p_hit, torch.where(miss_mask, p_miss, probs)
        )
    return probs


def insert_rays(
    probs,
    origin,
    scan_origins,
    scan_points,
    scan_kind,
    hit_miss_p,
    resolution: float,
    n_steps: int,
    size: int,
):
    """Insert S scans into the grid with per-scan hit-priority odds
    updates (range_data_inserter_2d.cc:55-94); the JAX signature.

    A CUDA `probs` launches the CUDA kernel (or raises); a CPU `probs`
    runs `insert_rays_plain`. Returns the new (size, size) float32 grid.
    """
    if probs.device.type != "cpu":
        raise ValueError(f"no ray insertion for device {probs.device}")
    return insert_rays_plain(
        probs, origin, scan_origins, scan_points, scan_kind, hit_miss_p,
        resolution, n_steps, size,
    )


def _pack(points, metas, origins, s_min: int):
    """Scan origins, endpoints and kinds packed into bucketed shapes:
    S_pad a power of two >= s_min, B a power of two >= 4. Returns
    (origins_pad (S_pad,2) f32, scan_pts (S_pad,B,2) f32, scan_kind
    (S_pad,B) int8)."""
    S = len(metas)
    counts = []
    prev = 0
    for re_, e_, _ in metas:
        counts.append(e_ - prev)
        prev = e_
    B = 4
    while B < max(max(counts), 1):
        B *= 2
    S_pad = s_min
    while S_pad < S:
        S_pad *= 2
    scan_pts = np.zeros((S_pad, B, 2), np.float32)
    scan_kind = np.zeros((S_pad, B), np.int8)
    i = 0
    for s, (re_, e_, _) in enumerate(metas):
        n_hit = re_ - i
        n_all = e_ - i
        scan_pts[s, :n_all] = points[i:e_]
        scan_kind[s, :n_hit] = 1
        scan_kind[s, n_hit:n_all] = 2
        i = e_
    origins_pad = np.zeros((S_pad, 2), np.float32)
    origins_pad[:S] = origins
    return origins_pad, scan_pts, scan_kind


def pack_scans(range_data):
    """Host prep shared by every grid build: scan origins, endpoints and
    kinds packed into bucketed shapes -- S_pad a power of two >= 32,
    B a power of two >= 4 (grid.py:183-207 of the JAX package).

    Returns (origins_pad (S_pad,2) f32, scan_pts (S_pad,B,2) f32,
    scan_kind (S_pad,B) int8, origins (S,2) f64)."""
    origins = np.stack([m[2] for m in range_data.meta])
    return (*_pack(range_data.points, range_data.meta, origins, 32),
            origins)


def submap_insert_args(
    range_data,
    spec: GridSpec,
    hit_p: float = 0.7,
    miss_p: float = 0.4,
    n_steps: int = 96,
    device="cuda",
):
    """The arguments of `insert_rays` (and `insert_rays_plain`) that
    build a fixed-size grid from a non-empty RangeData2D on `device`.
    The grid is centered on the data's bounding box like GrowAsNeeded +
    ComputeCroppedGrid (range_data_inserter_2d.cc:35-47)."""
    dev = torch.device(device)
    origins_pad, scan_pts, scan_kind, origins = pack_scans(range_data)
    all_xy = np.concatenate([range_data.points, origins])
    lo = all_xy.min(0)
    hi = all_xy.max(0)
    center = (lo + hi) / 2.0
    origin = torch.tensor(center - spec.extent / 2.0, dtype=torch.float32,
                          device=dev)
    return (
        torch.zeros((spec.size, spec.size), dtype=torch.float32,
                    device=dev),
        origin,
        torch.from_numpy(origins_pad).to(dev),
        torch.from_numpy(scan_pts).to(dev),
        torch.from_numpy(scan_kind).to(dev),
        torch.tensor([hit_p, miss_p], dtype=torch.float32, device=dev),
        spec.resolution,
        n_steps,
        spec.size,
    )


def insert_range_data(
    probs,  # (size, size) existing grid (tensor)
    grid_origin,  # (2,) grid origin in the grid frame
    range_data,  # RangeData2D (one keyframe's scans, own frame)
    pose,  # (3,) se2 store frame -> grid frame (None = identity)
    spec: GridSpec,
    hit_p: float = 0.7,
    miss_p: float = 0.4,
    n_steps: int = 96,
):
    """Insert one keyframe's range store into an EXISTING grid at
    `pose` -- the incremental active-submap insertion of the
    Cartographer local-SLAM pattern (the reference's batch submap
    build, range_data_inserter_2d.cc:51-94, applied one keyframe at a
    time so each new keyframe can first be matched against the grid
    built from its predecessors). The points are transformed in float64
    on the host, then packed as the JAX package packs them here: S_pad
    a power of two >= 8, B a power of two >= 4 (not pack_scans' ladder).
    Runs `insert_rays` on the device of `probs`: the CUDA kernel for a
    grid on the card, insert_rays_plain on the CPU. Returns the new
    grid (`probs` itself when the store is empty)."""
    pts = np.asarray(range_data.points)
    metas = range_data.meta
    if not metas or len(pts) == 0:
        return probs
    origins = np.stack([m[2] for m in metas])
    if pose is not None:
        if isinstance(pose, torch.Tensor):
            pose = pose.detach().cpu().numpy()
        pose = np.asarray(pose, np.float64)
        pts = se2.apply(pose, pts)
        origins = origins + pose[:2]
    origins_pad, scan_pts, scan_kind = _pack(pts, metas, origins, 8)
    dev = probs.device
    return insert_rays(
        probs,
        torch.as_tensor(grid_origin, dtype=torch.float32).to(dev),
        torch.from_numpy(origins_pad).to(dev),
        torch.from_numpy(scan_pts).to(dev),
        torch.from_numpy(scan_kind).to(dev),
        torch.tensor([hit_p, miss_p], dtype=torch.float32, device=dev),
        spec.resolution,
        n_steps,
        spec.size,
    )


def binomial_blur(x, s: int):
    """(2s+1)-tap separable binomial (approx. Gaussian) blur with PMIN
    border -- the reference's convolve2DFast smoothing kernel
    (fast_correlative_scan_matcher_2d.cc:439-444; their 3x3 is s=1).
    Rows then columns; each output sums its taps' products in tap order,
    which is XLA's order on the CPU (bit-equal with the JAX package at
    s=1, where every product is exact)."""
    k = torch.tensor([math.comb(2 * s, i) for i in range(2 * s + 1)],
                     dtype=x.dtype, device=x.device)
    k = k / k.sum()
    n = x.shape[0]

    def conv_rows(a):  # valid convolution along dim 1
        out = a[:, 0:n] * k[0]
        for i in range(1, 2 * s + 1):
            out = out + a[:, i:i + n] * k[i]
        return out

    xp = F.pad(x[None, None], (s, s, s, s), value=PMIN)[0, 0]
    x1 = conv_rows(xp)  # (n + 2s, n)
    return conv_rows(x1.T).T


def precompute_pyramid(probs, depth: int, smooth: int = 0):
    """Max-pool precomputation stack (PrecomputationGrid2D semantics,
    fast_correlative_scan_matcher_2d.cc:368-468): level i holds, at
    full resolution, the max of scores over the forward-looking
    (2^i + 1)-wide square window at each cell, so that scoring a
    candidate at stride 2^i upper-bounds all finer candidates beneath
    it. As in the reference (width+1 at :468), even level 0 is a 2x2
    max. Unknown cells score PMIN; the window is padded with -inf on
    the right and bottom only. smooth > 0 blurs the base scores first
    (binomial_blur), so every level stays an exact upper bound of the
    smoothed level 0. Plain torch (max_pool2d, stride 1) on the device
    of `probs`. Returns (depth, size, size) float32."""
    score0 = torch.where(probs > 0.0, probs, PMIN)
    if smooth > 0:
        score0 = binomial_blur(score0, smooth)
    levels = []
    for i in range(depth):
        width = (1 << i) + 1
        padded = F.pad(score0[None, None], (0, width - 1, 0, width - 1),
                       value=-torch.inf)
        levels.append(F.max_pool2d(padded, width, stride=1)[0, 0])
    return torch.stack(levels)


def build_submap_grid(
    range_data,
    spec: GridSpec,
    hit_p: float = 0.7,
    miss_p: float = 0.4,
    n_steps: int = 96,
    device="cuda",
):
    """Build a fixed-size grid from a RangeData2D (host prep + insertion
    on `device`). Returns SubmapGrid."""
    if len(range_data.meta) == 0 or len(range_data.points) == 0:
        dev = torch.device(device)
        return SubmapGrid(
            torch.zeros((spec.size, spec.size), dtype=torch.float32,
                        device=dev),
            torch.zeros(2, dtype=torch.float32, device=dev),
            spec.resolution,
        )
    args = submap_insert_args(range_data, spec, hit_p, miss_p, n_steps,
                              device)
    return SubmapGrid(insert_rays(*args), args[1], spec.resolution)


# matplotlib's "gray" colormap as imsave writes it: 256 levels,
# level k = k / 255 stored as the byte floor(255 k / 255 in float64)
