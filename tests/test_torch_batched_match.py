"""The port's single-submap and batched matchers and pin bounds
(sparse_gslam_tpu_torch/ops/matching.py: match_submap, correlate_batch,
match_submaps_batched, correlate_rotations_batch,
match_candidates_pruned_batched, pin_bounds_batch, score_pose,
interp_grid) against the JAX package's functions on the same seeded
inputs (CPU, float32 as in both packages), and the batched pruned
matcher against the port's own sequential match_candidates_pruned.

Tolerances, and why:
  - scores from the FFT correlator: atol 2e-6 (SCORE_ATOL), as
    tests/test_torch_matching.py holds correlate_rotations: pocketfft/MKL
    against XLA's FFT, ~1e-7 relative on scores <= 1;
  - the argmax, the match pose and the chosen candidate: equal;
  - best_candidate_with_cov's covariance: rtol 1e-4 as
    tests/test_torch_sharded.py holds it (torch sums, not XLA's order),
    and, since its scores come from the two FFTs here, atol
    2e-6 (1 + |t|^2 / m^2) at a match translation t: the moments
    K/s - u u^T/s^2 are taken about the coordinate origin, so K/s is
    ~|t|^2 and cancels down to entries of ~1e-3..1e-1; score differences
    of ~1e-7 relative carry through that cancellation (seen: 1.1e-7 at
    |t| = 0.42 m, 6.7e-6 at |t| = 2.06 m);
  - window_cov's covariance (the pruned matchers): rtol 2.4e-7 (two
    float32 ulp), as tests/test_torch_matching.py holds it;
  - pin_bounds_batch: bit-equal with the JAX function (same cells, the
    sums in XLA's CPU order); against the float64 host bound
    pin_bound_host atol 1e-5, as tests/test_grid_matching.py holds the
    JAX pair;
  - score_pose: bit-equal for N > 32 (every caller's query bucket is
    256 * 2^k); for N <= 32 XLA vectorizes the short sum in another
    order, so one float32 ulp of the score (atol 6e-8 on scores <= 1);
  - interp_grid: rtol 1e-6 (torch's einsum and XLA's dot sum the
    16 taps in different orders).
"""
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
BEST_COV_RTOL = 1e-4


def best_cov_atol(pose):
    return 2e-6 * (1.0 + float(pose[0]) ** 2 + float(pose[1]) ** 2)
PIN_HOST_ATOL = 1e-5
SHORT_SUM_ATOL = 6e-8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def room():
    """The two-wall room of test_grid_matching.TestMatching (the JAX
    grid and its pyramid, as numpy) and the query base points."""
    a = np.linspace(-np.pi / 2, np.pi / 2, 45)
    table = np.stack([np.cos(a), np.sin(a)], 1)
    rd = RangeData2D()
    for i in range(12):
        pose = np.array([0.0, 0.2 * i, 0.0])
        th = pose[2] + a
        with np.errstate(divide="ignore"):
            r = (4.0 - pose[0]) / np.cos(th)
        r = np.where((r > 0) & (np.abs(np.cos(th)) > 1e-6), r, np.inf)
        rd.insert_scan(np.minimum(r, 8.0), table, 8.0, pose=pose)
    for i in range(6):
        pose = np.array([0.3 * i, 3.0, -np.pi / 2])
        th = pose[2] + a
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


def query_at(room, gt):
    return se2.apply(se2.inverse(np.array(gt)), room["base"])


SPEC_ARGS = (2.0, 0.6, 8.0, 0.1)


@pytest.mark.parametrize("gt,th0", [((0.4, -0.3, 0.1), 0.0),
                                    ((-0.6, 0.5, -0.15), 0.05)])
def test_match_submap_matches_jax(room, gt, th0):
    query = query_at(room, gt)
    ref = jm.match_submap(jnp.asarray(room["pyr"][0]),
                          jnp.asarray(room["origin"]), 0.1, query, th0,
                          jm.search_spec(*SPEC_ARGS))
    got = tm.match_submap(T(room["pyr"][0]), T(room["origin"]), 0.1, query,
                          th0, tm.search_spec(*SPEC_ARGS))
    assert abs(got[0] - ref[0]) <= SCORE_ATOL
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_allclose(got[2], np.asarray(ref[2]),
                               rtol=BEST_COV_RTOL, atol=best_cov_atol(got[1]))
    np.testing.assert_allclose(got[1], gt, atol=0.1 + 1e-6)


def _candidates(room, n):
    """n candidates: the true submap among decoys with shifted origins
    and other seed rotations (the true one at index 1 when n > 1)."""
    rng = np.random.default_rng(7)
    o = room["origin"]
    origins = [o + rng.uniform(-3, 3, 2).astype(np.float32)
               for _ in range(n)]
    thetas = list(rng.uniform(-0.3, 0.3, n))
    k = min(1, n - 1)
    origins[k], thetas[k] = o.copy(), 0.0
    return origins, thetas


@pytest.mark.parametrize("n,chunk", [(3, 8), (5, 2)])
def test_match_submaps_batched_matches_jax(room, n, chunk):
    """Chunks padded to a power of two by repeating their first
    candidate (3 -> 4; chunks of 2, 2, 1): the padding does not show,
    each candidate's triple equals the JAX one and the port's own
    match_submap on that candidate."""
    query = query_at(room, (0.4, -0.3, 0.1))
    origins, thetas = _candidates(room, n)
    sg = room["pyr"][0]
    ref = jm.match_submaps_batched(
        [jnp.asarray(sg)] * n, [jnp.asarray(o) for o in origins], thetas,
        query, jm.search_spec(*SPEC_ARGS), chunk=chunk)
    got = tm.match_submaps_batched(
        [T(sg)] * n, [T(o) for o in origins], thetas, query,
        tm.search_spec(*SPEC_ARGS), chunk=chunk)
    assert len(got) == len(ref) == n
    for k, (g, r) in enumerate(zip(got, ref)):
        assert abs(g[0] - r[0]) <= SCORE_ATOL
        np.testing.assert_array_equal(g[1], r[1])
        np.testing.assert_allclose(g[2], r[2], rtol=BEST_COV_RTOL,
                                   atol=best_cov_atol(g[1]))
        one = tm.match_submap(T(sg), T(origins[k]), 0.1, query, thetas[k],
                              tm.search_spec(*SPEC_ARGS))
        assert g[0] == one[0]
        np.testing.assert_array_equal(g[1], one[1])
        np.testing.assert_array_equal(g[2], one[2])
    assert max(range(n), key=lambda k: got[k][0]) == 1


def test_correlate_rotations_batch_matches_jax(room):
    query = query_at(room, (0.4, -0.3, 0.1))
    pts = np.zeros((128, 2), np.float32)
    pts[:len(query)] = query
    valid = np.arange(128) < len(query)
    rng = np.random.default_rng(2)
    B, R = 3, 16
    grids = np.stack([room["pyr"][0]] * B)
    origins = (room["origin"][None]
               + rng.uniform(-1, 1, (B, 2))).astype(np.float32)
    thetas = rng.uniform(-0.4, 0.4, (B, R)).astype(np.float32)
    ref = np.asarray(jm.correlate_rotations_batch(
        jnp.asarray(grids), jnp.asarray(origins), jnp.asarray(pts),
        jnp.asarray(valid), jnp.asarray(thetas), 0.1, 12, 128, 192))
    got = tm.correlate_rotations_batch(
        T(grids), T(origins), T(pts), T(valid), T(thetas), 0.1, 12, 128,
        192).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_ATOL)
    # and candidate by candidate, the port's single correlate_rotations
    for b in range(B):
        one = tm.correlate_rotations(T(grids[b]), T(origins[b]), T(pts),
                                     T(valid), T(thetas[b]), 0.1, 12, 128,
                                     192).numpy()
        np.testing.assert_allclose(got[b], one, rtol=0, atol=SCORE_ATOL)
        assert tm._argmax_center_tiebreak(got[b], 12) == \
            jm._argmax_center_tiebreak(ref[b], 12)


@pytest.mark.parametrize("gt,n_cands,min_score,chunk,hit", [
    ((0.4, -0.3, 0.1), 3, 0.5, 8, True),
    ((0.6, -0.4, 0.15), 6, 0.5, 2, True),
    ((0.4, -0.3, 0.1), 3, 0.999, 8, False),
])
def test_pruned_batched_matches_jax_and_sequential(room, gt, n_cands,
                                                   min_score, chunk, hit):
    """The batched pruned matcher accepts the JAX one's candidate, score,
    pose and covariance, and the port's sequential pruned matcher's."""
    query = query_at(room, gt)
    rng = np.random.default_rng(3)
    shifts = [np.zeros(2, np.float32)] + [
        rng.uniform(-3, 3, 2).astype(np.float32) for _ in range(n_cands - 1)]
    thetas0 = [0.0] + list(rng.uniform(-0.5, 0.5, n_cands - 1))
    sg, pg, o = room["pyr"][0], room["pyr"][4], room["origin"]
    ref = jm.match_candidates_pruned_batched(
        [jnp.asarray(sg)] * n_cands, [jnp.asarray(pg)] * n_cands,
        [jnp.asarray(o - s) for s in shifts], thetas0, query,
        jm.search_spec(*SPEC_ARGS), min_score, 16, chunk=chunk)
    spec = tm.search_spec(*SPEC_ARGS)
    args = ([T(sg)] * n_cands, [T(pg)] * n_cands,
            [T(o - s) for s in shifts], thetas0, query, spec, min_score, 16)
    got = tm.match_candidates_pruned_batched(*args, chunk=chunk)
    seq = tm.match_candidates_pruned(*args)
    assert got[0] == ref[0] == seq[0]
    assert (got[0] is not None) == hit
    if not hit:
        assert got[2] is None and got[3] is None
        return
    assert abs(got[1] - ref[1]) <= SCORE_ATOL
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[3], ref[3], rtol=COV_RTOL, atol=0)
    assert got[1] == seq[1]
    np.testing.assert_array_equal(got[2], seq[2])
    np.testing.assert_array_equal(got[3], seq[3])


def _pin_case(seed=11):
    """tests/test_grid_matching.py TestPinBoundsBatch's case."""
    rng = np.random.default_rng(seed)
    depth, n_linear, res, size, M = 5, 8, 0.1, 128, 3
    pyrs = []
    for _ in range(M):
        probs = np.zeros((size, size), np.float32)
        occ = rng.integers(10, size - 10, (40, 2))
        probs[occ[:, 0], occ[:, 1]] = rng.uniform(0.55, 0.95, 40)
        pyrs.append(np.asarray(precompute_pyramid(jnp.asarray(probs), depth)))
    Kp, N, R = 5, 60, 9
    pts = np.zeros((Kp, N, 2), np.float32)
    val = np.zeros((Kp, N), bool)
    orgs = np.zeros((Kp, 2), np.float32)
    ths = np.zeros((Kp, R), np.float32)
    ids = rng.integers(0, M, Kp).astype(np.int32)
    for k in range(Kp):
        n = int(rng.integers(20, N))
        pts[k, :n] = rng.uniform(2.0, 10.0, (n, 2))
        val[k, :n] = True
        orgs[k] = rng.uniform(-1, 1, 2)
        ths[k] = rng.uniform(-0.2, 0.2) + np.linspace(-0.1, 0.1, R)
    stack = np.stack([p[depth - 1] for p in pyrs])
    return stack, ids, orgs, pts, val, ths, res, n_linear


@pytest.mark.parametrize("extra", [True, False])
def test_pin_bounds_batch_matches_jax_and_host(extra):
    stack, ids, orgs, pts, val, ths, res, n_linear = _pin_case()
    ref = np.asarray(jm.pin_bounds_batch(
        jnp.asarray(stack), jnp.asarray(ids), jnp.asarray(orgs),
        jnp.asarray(pts), jnp.asarray(val), jnp.asarray(ths), res, n_linear,
        extra=extra))
    got = tm.pin_bounds_batch(T(stack), T(ids), T(orgs), T(pts), T(val),
                              T(ths), res, n_linear, extra=extra).numpy()
    np.testing.assert_array_equal(got, ref)
    for k in range(len(ids)):
        n = int(val[k].sum())
        host = tm.pin_bound_host(
            stack[ids[k]].astype(np.float64), orgs[k].astype(np.float64),
            res, pts[k, :n].astype(np.float64), ths[k].astype(np.float64),
            n_linear, stride=16 if extra else None)
        assert abs(got[k] - host) <= PIN_HOST_ATOL


@pytest.mark.parametrize("n", [256, 300, 512, 20, 8])
def test_score_pose_matches_jax(room, n):
    rng = np.random.default_rng(n)
    sg, o = room["pyr"][0], room["origin"]
    for _ in range(8):
        pts = rng.uniform(-7, 7, (n, 2)).astype(np.float32)
        valid = rng.random(n) < 0.9
        pose = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                         rng.uniform(-3.2, 3.2)], np.float32)
        ref = np.asarray(jm.score_pose(jnp.asarray(sg), jnp.asarray(o),
                                       jnp.asarray(pts), jnp.asarray(valid),
                                       jnp.asarray(pose), 0.1, 128))
        got = tm.score_pose(T(sg), T(o), T(pts), T(valid), T(pose), 0.1,
                            128).numpy()
        assert got.dtype == ref.dtype == np.float32
        if n > 32:
            assert got == ref
        else:
            assert abs(float(got) - float(ref)) <= SHORT_SUM_ATOL


def test_score_pose_at_the_match(room):
    """score_pose at match_submap's pose is the matcher's own score."""
    query = query_at(room, (0.4, -0.3, 0.1))
    spec = tm.search_spec(*SPEC_ARGS)
    sc, pose, _ = tm.match_submap(T(room["pyr"][0]), T(room["origin"]), 0.1,
                                  query, 0.0, spec)
    got = tm.score_pose(T(room["pyr"][0]), T(room["origin"]),
                        T(query.astype(np.float32)),
                        torch.ones(len(query), dtype=torch.bool), T(pose),
                        0.1, 128)
    assert abs(float(got) - sc) <= 1e-5


def test_interp_grid_matches_jax(room):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-8, 8, (500, 2)).astype(np.float32)
    ref = np.asarray(jm.interp_grid(jnp.asarray(room["probs"]),
                                    jnp.asarray(room["origin"]), 0.1,
                                    jnp.asarray(pts)))
    got = tm.interp_grid(T(room["probs"]), T(room["origin"]), 0.1,
                         T(pts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
