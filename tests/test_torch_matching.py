"""The port's matcher (sparse_gslam_tpu_torch/ops/matching.py) against
the JAX package's CPU branch on the same seeded inputs (CPU, float32
device work as in both packages).

Tolerances, and why:
  - cell indices, rotation tables, the host helpers, the argmax and
    the returned match pose: bit-equal;
  - scores (rotation bounds, FFT correlation): atol 2e-6. The FFTs
    (pocketfft/MKL against XLA's) and the float32 sums differ in
    rounding, ~1e-7 relative on scores <= 1;
  - window_cov: rtol 2.4e-7 (two float32 ulp). Its moments
    K/s - u u^T/s^2 cancel heavily, so the port takes them in XLA's CPU
    order and rounding; it agrees bit for bit but for the last bit of
    the rotation entry in some cases;
  - refinement: pose, covariance and per-point probabilities bit-equal
    (the port computes XLA's CPU program's arithmetic, ops/refine_exact
    .py; tests/test_torch_refine_exact.py has the wider cases).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.models.range_data import RangeData2D
from sparse_gslam_tpu.ops import matching as jm
from sparse_gslam_tpu.ops.grid import (
    GridSpec,
    build_submap_grid,
    precompute_pyramid,
)
from sparse_gslam_tpu.utils import se2
from sparse_gslam_tpu_torch.ops import matching as tm

SCORE_ATOL = 2e-6
COV_RTOL = 2.4e-7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def scan_table(n=45, fov=np.pi):
    a = np.linspace(-fov / 2, fov / 2, n)
    return np.stack([np.cos(a), np.sin(a)], 1), a


@pytest.fixture(scope="module")
def room():
    """The two-wall room of test_grid_matching.TestMatching: the JAX
    grids (probs, pyramid) as numpy, plus the query base points."""
    table, angles = scan_table()
    rd = RangeData2D()
    for i in range(12):
        pose = np.array([0.0, 0.2 * i, 0.0])
        th = pose[2] + angles
        with np.errstate(divide="ignore"):
            r = (4.0 - pose[0]) / np.cos(th)
        r = np.where((r > 0) & (np.abs(np.cos(th)) > 1e-6), r, np.inf)
        rd.insert_scan(np.minimum(r, 8.0), table, 8.0, pose=pose)
    for i in range(6):
        pose = np.array([0.3 * i, 3.0, -np.pi / 2])
        th = pose[2] + angles
        with np.errstate(divide="ignore"):
            r = (pose[1] - (-1.0)) / -np.sin(th)
        r = np.where((r > 0) & (np.abs(np.sin(th)) > 1e-6), r, np.inf)
        rd.insert_scan(np.minimum(r, 8.0), table, 8.0, pose=pose)
    sm = build_submap_grid(rd, GridSpec(size=128, resolution=0.1))
    pyr = np.asarray(precompute_pyramid(sm.probs, 5))
    base = np.concatenate([
        np.column_stack([np.full(50, 4.0), np.linspace(-0.5, 2.5, 50)]),
        np.column_stack([np.linspace(0.0, 2.0, 40), np.full(40, -1.0)]),
    ])
    return dict(probs=np.asarray(sm.probs), origin=np.asarray(sm.origin),
                pyr=pyr, base=base)


def padded(points, n=128):
    pts = np.zeros((n, 2), np.float32)
    pts[: len(points)] = points
    return pts, np.arange(n) < len(points)


def T(a):
    return torch.from_numpy(np.array(a))


def test_search_spec_equal():
    for args in [(5.0, 1.0, 7.0, 0.1), (0.8, 0.2, 3.3, 0.1),
                 (2.0, 0.6, 0.05, 0.05)]:
        assert tm.search_spec(*args) == tuple(jm.search_spec(*args))


def test_rotation_tables_equal_xla():
    """cos/sin of float32 angles exactly as XLA's CPU backend gives."""
    th = np.random.default_rng(0).uniform(-4, 4, 4000).astype(np.float32)
    c, s = tm.cos_sin_f32(th)
    np.testing.assert_array_equal(c, np.asarray(jax.jit(jnp.cos)(th)))
    np.testing.assert_array_equal(s, np.asarray(jax.jit(jnp.sin)(th)))


def _coded_grid(S):
    """A grid whose every cell holds a distinct float32 value > PMIN:
    a rotation bound with one valid point and no offsets reads back
    exactly the value of that point's cell."""
    return (np.arange(S * S, dtype=np.float64).reshape(S, S) / (S * S)
            + 0.2).astype(np.float32)


def _knife_edge_cases(rng, origin, res, n):
    """(point, theta) pairs whose rotated point lies within a few ulp of
    a cell border: axis-aligned points on borders (theta = 0) nudged by
    an ulp, and rotated points where rounding the products separately
    or fused picks different cells."""
    out = []
    for k in range(n // 2):
        border = origin + np.float32(res) * rng.integers(5, 100, 2)
        pt = border.astype(np.float32)
        pt = np.nextafter(pt, pt + rng.choice([-1, 1], 2)).astype(np.float32)
        out.append((pt, np.float32(0.0)))
    f64 = np.float64
    while len(out) < n:
        pt = rng.uniform(-9, 9, 2).astype(np.float32)
        th = rng.uniform(-3.2, 3.2, 4096).astype(np.float32)
        c, s = tm.cos_sin_f32(th)
        fused = (c.astype(f64) * pt[0] - (s * pt[1]).astype(f64)).astype(
            np.float32)
        plain = c * pt[0] - s * pt[1]
        q = np.floor((fused - origin[0]) / np.float32(res)) != np.floor(
            (plain - origin[0]) / np.float32(res))
        out += [(pt, th[k]) for k in np.nonzero(q)[0][:4]]
    return out


def test_cell_indices_bit_equal_at_knife_edges():
    S, res = 512, 0.1
    grid = _coded_grid(S)
    origin = np.array([-25.6, -25.6], np.float32)
    rng = np.random.default_rng(1)
    cases = _knife_edge_cases(rng, origin, res, 24)
    cases += [(rng.uniform(-9, 9, 2).astype(np.float32),
               np.float32(rng.uniform(-3.2, 3.2))) for _ in range(40)]
    for pt, th in cases:
        pts = np.zeros((8, 2), np.float32)
        pts[0] = pt
        valid = np.arange(8) < 1
        thetas = np.array([th], np.float32)
        ref = np.asarray(jm.rotation_upper_bounds(
            jnp.asarray(grid), jnp.asarray(origin), jnp.asarray(pts),
            jnp.asarray(valid), jnp.asarray(thetas), res, 0, S, 4))
        got = tm.rotation_upper_bounds(
            T(grid), T(origin), T(pts), T(valid), T(thetas), res, 0, S,
            4).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("gt", [(0.4, -0.3, 0.1), (0.0, 0.0, 0.0),
                                (-0.7, 0.5, -0.2)])
def test_correlate_rotations_and_bounds_match_jax(room, gt):
    query = se2.apply(se2.inverse(np.array(gt)), room["base"])
    pts, valid = padded(query)
    thetas = np.linspace(-0.4, 0.4, 24).astype(np.float32)
    args_j = (jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(thetas))
    args_t = (T(pts), T(valid), T(thetas))
    ref = np.asarray(jm.correlate_rotations(
        room["pyr"][0], room["origin"], *args_j, 0.1, 20, 128, 192))
    got = tm.correlate_rotations(
        T(room["pyr"][0]), T(room["origin"]), *args_t, 0.1, 20, 128,
        192).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_ATOL)
    assert tm._argmax_center_tiebreak(got, 20) == \
        jm._argmax_center_tiebreak(ref, 20)
    ub_ref = np.asarray(jm.rotation_upper_bounds(
        room["pyr"][4], room["origin"], *args_j, 0.1, 20, 128, 16))
    ub = tm.rotation_upper_bounds(
        T(room["pyr"][4]), T(room["origin"]), *args_t, 0.1, 20, 128,
        16).numpy()
    np.testing.assert_allclose(ub, ub_ref, rtol=0, atol=SCORE_ATOL)
    assert np.all(got.max(axis=(1, 2)) <= ub + 1e-5)


def test_window_cov_matches_jax(room):
    query = se2.apply(se2.inverse(np.array([0.4, -0.3, 0.1])), room["base"])
    pts, valid = padded(query)
    bp = np.array([0.4, -0.3, 0.1], np.float32)
    f = np.float32
    args = (bp, f(0.0), f(0.02), f(-0.3), f(0.3), 0.1, 128)
    ref = np.asarray(jm.window_cov(
        room["pyr"][0], room["origin"], jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(bp), *map(jnp.float32, args[1:5]), 0.1, 128))
    got = tm.window_cov(T(room["pyr"][0]), T(room["origin"]), T(pts),
                        T(valid), T(bp), *args[1:]).numpy()
    np.testing.assert_allclose(got, ref, rtol=COV_RTOL, atol=0)


def _pruned_inputs(room, gt, n_cands):
    query = se2.apply(se2.inverse(np.array(gt)), room["base"])
    spec = jm.search_spec(2.0, 0.6, 8.0, 0.1)
    rng = np.random.default_rng(3)
    shifts = [np.zeros(2, np.float32)] + [
        rng.uniform(-3, 3, 2).astype(np.float32) for _ in range(n_cands - 1)
    ]
    thetas0 = [0.0] + list(rng.uniform(-0.5, 0.5, n_cands - 1))
    return query, spec, shifts, thetas0


@pytest.mark.parametrize("gt,n_cands,min_score,hit", [
    ((0.4, -0.3, 0.1), 1, 0.5, True),
    ((0.6, -0.4, 0.15), 3, 0.5, True),
    ((0.4, -0.3, 0.1), 3, 0.999, False),
])
def test_match_candidates_pruned_matches_jax(room, gt, n_cands, min_score,
                                             hit):
    query, spec, shifts, thetas0 = _pruned_inputs(room, gt, n_cands)
    sg, pg, o = room["pyr"][0], room["pyr"][4], room["origin"]
    ref = jm.match_candidates_pruned(
        [sg] * n_cands, [pg] * n_cands,
        [jnp.asarray(o) - jnp.asarray(s) for s in shifts], thetas0, query,
        spec, min_score, 16)
    got = tm.match_candidates_pruned(
        [T(sg)] * n_cands, [T(pg)] * n_cands,
        [T(o) - T(s) for s in shifts], thetas0, query,
        tm.search_spec(2.0, 0.6, 8.0, 0.1), min_score, 16)
    assert got[0] == ref[0]
    assert (got[0] is not None) == hit
    if hit:
        assert abs(got[1] - ref[1]) <= SCORE_ATOL
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_allclose(got[3], ref[3], rtol=COV_RTOL, atol=0)


def test_pruned_miss_on_garbage_query(room):
    query = np.random.default_rng(0).uniform(40, 60, (64, 2))
    spec = tm.search_spec(2.0, 0.6, 8.0, 0.1)
    ci, s, p, cov = tm.match_candidates_pruned(
        [T(room["pyr"][0])], [T(room["pyr"][4])], [T(room["origin"])],
        [0.0], query, spec, min_score=0.7, stride=16)
    assert ci is None and p is None and cov is None


def _refine_case(room, gt, off):
    query = se2.apply(se2.inverse(np.array(gt)), room["base"])
    pts, valid = padded(query)
    init = (np.array(gt) + np.array(off)).astype(np.float32)
    return pts, valid, init


@pytest.mark.parametrize("gt,off", [
    ((0.3, -0.2, 0.08), (0.08, -0.06, 0.02)),
    ((0.6, -0.4, 0.15), (-0.05, 0.04, -0.01)),
])
def test_refinement_matches_jax(room, gt, off):
    """The port's refinement rounds as the JAX package's CPU program:
    pose, covariance and probabilities bit for bit."""
    pts, valid, init = _refine_case(room, gt, off)
    probs, origin = room["probs"], room["origin"]
    jargs = (jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(init))
    targs = (T(pts), T(valid), T(init))
    p_ref = np.asarray(jm.refine_pose(probs, origin, 0.1, *jargs))
    p_got = tm.refine_pose(T(probs), T(origin), 0.1, *targs).numpy()
    np.testing.assert_array_equal(p_got, p_ref)

    ref = [np.asarray(a) for a in jm.refine_pose_cov(
        probs, origin, 0.1, *jargs)]
    got = [a.numpy() for a in tm.refine_pose_cov(
        T(probs), T(origin), 0.1, *targs)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)

    ref = [np.asarray(a) for a in jm.refine_pose_cov_two_stage(
        room["pyr"][0], origin, 0.1, probs, origin, 0.1, *jargs)]
    got = [a.numpy() for a in tm.refine_pose_cov_two_stage(
        T(room["pyr"][0]), T(origin), 0.1, T(probs), T(origin), 0.1,
        *targs)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("stride", [None, 8, 16, 32])
def test_host_helpers_bit_equal(room, stride):
    rng = np.random.default_rng(5)
    score = room["pyr"][0].astype(np.float64)
    pooled = room["pyr"][4].astype(np.float64)
    origin = room["origin"].astype(np.float64) - rng.uniform(-1, 1, 2)
    query = se2.apply(se2.inverse(np.array([0.2, 0.1, 0.05])),
                      room["base"][::3])
    spec = jm.search_spec(0.8, 0.2, float(np.linalg.norm(query, axis=1).max()),
                          0.1)
    thetas = 0.05 + np.arange(-spec.n_angular, spec.n_angular + 1) * \
        spec.angular_step
    assert tm.pin_bound_host(pooled, origin, 0.1, query, thetas,
                             spec.n_linear, stride=stride) == \
        jm.pin_bound_host(pooled, origin, 0.1, query, thetas, spec.n_linear,
                          stride=stride)
    s_ref = jm.correlate_window_host(score, origin, 0.1, query, thetas,
                                     spec.n_linear)
    s_got = tm.correlate_window_host(score, origin, 0.1, query, thetas,
                                     spec.n_linear)
    np.testing.assert_array_equal(s_got, s_ref)
    np.testing.assert_array_equal(
        tm.score_volume_cov(s_got, thetas, 0.05, 0.1, spec.n_linear),
        jm.score_volume_cov(s_ref, thetas, 0.05, 0.1, spec.n_linear))
    assert tm._argmax_center_tiebreak(s_got, spec.n_linear) == \
        jm._argmax_center_tiebreak(s_ref, spec.n_linear)
