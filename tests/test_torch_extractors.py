"""The port's smf and hough line extractors (sparse_gslam_tpu_torch/ops/
lines_smf.py, lines_hough.py, reached through ops.lines.
extract_lines_any) against the JAX package's, on seeded point clouds:
boxes, a corridor with a doorway gap, a box with clutter and per-point
covariances, an empty cloud and too few points. Both packages compute
in host numpy, so every output array is equal.
"""
import numpy as np
import pytest

from sparse_gslam_tpu.ops.lines import extract_lines_any as j_extract
from sparse_gslam_tpu.utils.config import ExtractorConfig as JExtractorConfig
from sparse_gslam_tpu_torch.ops.lines import extract_lines_any as t_extract
from sparse_gslam_tpu_torch.utils.config import ExtractorConfig

PARAMS = dict(outlier_dist=0.1, min_split_dist=0.1, max_line_gap=0.6,
              min_line_length=0.5, min_line_points=10,
              cluster_threshold=100.0)


def wall_points(segs, per_seg, noise, seed):
    """Points sampled along segments with normal noise, shuffled."""
    r = np.random.default_rng(seed)
    pts = []
    for (x0, y0), (x1, y1) in segs:
        t = np.sort(r.uniform(0, 1, per_seg))
        p = np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0)], 1)
        n = np.array([-(y1 - y0), x1 - x0]) / np.hypot(x1 - x0, y1 - y0)
        pts.append(p + n[None, :] * r.normal(0, noise, (per_seg, 1)))
    pts = np.concatenate(pts) if pts else np.zeros((0, 2))
    r.shuffle(pts)
    return pts


BOX = [((-2.0, -1.5), (2.0, -1.5)), ((2.0, -1.5), (2.0, 1.5)),
       ((2.0, 1.5), (-2.0, 1.5)), ((-2.0, -0.5), (-2.0, 1.0))]
CORRIDOR = [((-4.0, -0.8), (-0.5, -0.8)), ((0.5, -0.8), (4.0, -0.8)),
            ((-4.0, 0.8), (4.0, 0.8)), ((4.0, -0.8), (4.0, 0.8))]


def cloud(case):
    """(points, per-point 2x2 covariances) of a named seeded case."""
    eye = np.eye(2) * 0.01
    if case == "box":
        pts = wall_points(BOX, 60, 0.02, 0)
    elif case == "box_dense":
        pts = wall_points(BOX, 120, 0.01, 1)
    elif case == "corridor":
        pts = wall_points(CORRIDOR, 50, 0.02, 2)
    elif case == "box_clutter":
        r = np.random.default_rng(3)
        pts = np.concatenate([wall_points(BOX, 40, 0.03, 3),
                              r.uniform(-1.5, 1.5, (15, 2))])
        a = r.uniform(0.002, 0.02, (len(pts), 2))
        rot = r.uniform(-np.pi, np.pi, len(pts))
        c, s = np.cos(rot), np.sin(rot)
        R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
        covs = R @ (a[:, :, None] * np.eye(2)) @ np.swapaxes(R, -1, -2)
        return pts, covs
    elif case == "empty":
        pts = np.zeros((0, 2))
    elif case == "too_few":
        pts = wall_points(BOX[:1], 5, 0.01, 4)
    else:
        raise ValueError(case)
    return pts, np.tile(eye, (len(pts), 1, 1))


CASES = ["box", "box_dense", "corridor", "box_clutter", "empty", "too_few"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("algorithm", ["smf", "hough"])
def test_extractor_equals_jax(algorithm, case):
    pts, covs = cloud(case)
    got = t_extract(pts, covs, ExtractorConfig(algorithm=algorithm,
                                               **PARAMS))
    ref = j_extract(pts, covs, JExtractorConfig(algorithm=algorithm,
                                                **PARAMS))
    assert got.n == ref.n
    for name in ("rhotheta", "cov", "start", "end"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    if case in ("box", "box_dense", "corridor"):
        assert got.n >= 3
    if case in ("empty", "too_few"):
        assert got.n == 0


def test_unknown_extractor_raises():
    with pytest.raises(ValueError, match="unknown extractor"):
        t_extract(np.zeros((20, 2)), np.zeros((20, 2, 2)),
                  ExtractorConfig(algorithm="ransac"))
