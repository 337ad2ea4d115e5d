"""The port's matcher functions against the benchmark's frozen reference
(gslam_bench/reference/ops/matching.py) at the sizes 60 beams sends
them, on seeded inputs on the CPU.

At 60 beams a 960-point window makes the backend refine at padded
N = 512 to 4096 (the pins and chain edges at 512, the loop closures
above) and the pins score 512-point queries. A whole 60-beam session is
too slow for these tests (its CPU replay takes minutes), so they hold the
functions that take the larger inputs, on a seeded room: a probability
grid at 0.1 m (G = 320, the 28 m submap extent) and at 0.05 m (G = 576),
a query of `n` wall returns seen from a pose off the grid's frame, and
a seed near that pose.

- refine_pose_cov and refine_pose_cov_two_stage at N = 512, 1024, 2048
  and 4096: pose, covariance and probabilities bit-equal, as the cell's
  `refine_gap` limit of 0 demands;
- correlate_window_host, pin_bound_host and score_volume_cov on a
  512-point query: bit-equal.

The card's cell check and `python3 -m gslam_bench.witness`
(sim-office-beams60) hold whole sessions."""
import numpy as np
import pytest
import torch

from gslam_bench.reference.ops import matching as ref
from sparse_gslam_tpu_torch.ops import matching
from sparse_gslam_tpu_torch.utils.config import SlamConfig

F32 = np.float32
# a 7 x 6 m room: (point on the wall, direction, length)
WALLS = [((4.0, -1.0), (0.0, 1.0), 6.0), ((-3.0, -1.0), (0.0, 1.0), 6.0),
         ((-3.0, -1.0), (1.0, 0.0), 7.0), ((-3.0, 5.0), (1.0, 0.0), 7.0)]
TRUE_POSE = np.array([0.4, 1.1, 0.3])
CASES = ([("refine_pose_cov", n) for n in (512, 1024, 2048, 4096)]
         + [("refine_pose_cov_two_stage", n) for n in (512, 1024, 2048, 4096)]
         + [("correlate_window_host", 512), ("pin_bound_host", 512),
            ("score_volume_cov", 512)])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def room_grid(res, size, occupied=0.9, free=0.2):
    """(grid, origin): `occupied` within 1.5 cells of a wall, `free`
    inside the room, 0 (unknown) outside; the submap frame's origin at
    the grid's centre."""
    origin = np.full(2, -size * res / 2, F32)
    c = origin[0] + (np.arange(size) + 0.5) * res
    x, y = np.meshgrid(c, c, indexing="ij")
    near = np.zeros(x.shape, bool)
    for (px, py), (dx, dy), length in WALLS:
        t = np.clip((x - px) * dx + (y - py) * dy, 0.0, length)
        near |= np.hypot(x - px - t * dx, y - py - t * dy) < 1.5 * res
    inside = (x > -3.0) & (x < 4.0) & (y > -1.0) & (y < 5.0)
    return np.where(near, occupied, np.where(inside, free, 0.0)).astype(
        F32), origin


def query(n, rng):
    """`n` wall returns with 1 cm noise, in the frame of TRUE_POSE."""
    w = rng.integers(0, len(WALLS), n)
    pts = np.empty((n, 2))
    for k, ((px, py), (dx, dy), length) in enumerate(WALLS):
        m = w == k
        t = rng.uniform(0.0, length, m.sum())
        pts[m] = np.stack([px + t * dx, py + t * dy], 1)
    pts += rng.normal(0.0, 0.01, pts.shape)
    x, y, th = TRUE_POSE
    c, s = np.cos(th), np.sin(th)
    d = pts - (x, y)
    return np.stack([c * d[:, 0] + s * d[:, 1],
                     -s * d[:, 0] + c * d[:, 1]], 1).astype(F32)


@pytest.fixture(scope="module")
def grids():
    probs, origin = room_grid(0.1, 320)
    score = np.maximum(probs, np.roll(probs, 1, 0))
    score = np.maximum(score, np.roll(score, 1, 1))
    high, high_origin = room_grid(0.05, 576)
    return {"probs": probs, "score": score, "origin": origin,
            "high": high, "high_origin": high_origin}


def _refine_args(fn, n, g, rng):
    """The arguments the backend passes, as tensors: the query padded to
    `n` points as _padded_query pads it."""
    valid_n = n // 2 + int(rng.integers(1, n // 2))
    pts = np.zeros((n, 2), F32)
    pts[:valid_n] = query(valid_n, rng)
    seed = (TRUE_POSE + rng.normal(0.0, [0.05, 0.05, 0.02])).astype(F32)
    t = torch.from_numpy
    tail = (t(pts), t(np.arange(n) < valid_n), t(seed))
    if fn == "refine_pose_cov":
        return (t(g["high"]), t(g["high_origin"]), 0.05) + tail
    return (t(g["score"]), t(g["origin"]), 0.1, t(g["probs"]),
            t(g["origin"]), 0.1) + tail


def _pin_args(fn, g, rng):
    """A pin's arguments as _pin_match_grid makes them, on a 512-point
    query (the backend's cap)."""
    cfg = SlamConfig()
    q = query(512, rng).astype(np.float64)
    res = 0.1
    spec = matching.search_spec(cfg.kf_search_window, cfg.kf_angular_window,
                                float(np.linalg.norm(q, axis=1).max()), res)
    seed = TRUE_POSE + rng.normal(0.0, [0.1, 0.1, 0.03])
    origin = g["origin"].astype(np.float64) - seed[:2]
    thetas = seed[2] + np.arange(-spec.n_angular,
                                 spec.n_angular + 1) * spec.angular_step
    if fn == "pin_bound_host":
        pooled = g["score"]
        for _ in range(4):
            pooled = np.maximum(pooled, np.roll(pooled, -1, 0))
            pooled = np.maximum(pooled, np.roll(pooled, -1, 1))
        return (pooled.astype(np.float64), origin, res, q, thetas,
                spec.n_linear), {"stride": 16}
    scores = ref.correlate_window_host(g["score"].astype(np.float64),
                                       origin, res, q, thetas, spec.n_linear)
    if fn == "score_volume_cov":
        return (scores, thetas, seed[2], res, spec.n_linear), {}
    return (g["score"].astype(np.float64), origin, res, q, thetas,
            spec.n_linear), {}


@pytest.mark.parametrize("fn,n", CASES, ids=[f"{f}-{n}" for f, n in CASES])
def test_port_matches_reference_at_60_beam_sizes(fn, n, grids):
    rng = np.random.default_rng(6000 + n + len(fn))
    if fn.startswith("refine"):
        args, kw = _refine_args(fn, n, grids, rng), {}
    else:
        args, kw = _pin_args(fn, grids, rng)
    got = getattr(matching, fn)(*args, **kw)
    want = getattr(ref, fn)(*args, **kw)
    if fn.startswith("refine"):
        pose, cov, probs = (x.numpy() for x in got)
        assert np.all(np.isfinite(pose)) and np.all(np.isfinite(cov))
        # the seed lies in the basin: the refinement stays in the room's
        # (the dilated grid leans its walls by up to a cell)
        assert np.abs(pose[:2] - TRUE_POSE[:2]).max() < 0.15
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
