"""Cases of the port that need a CUDA card: the backend's device work on
the card against the same functions on the CPU. They skip without a
card. This file imports neither jax nor the JAX package, so it also
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Tolerances: grids and cell indices bit-equal (the insertion kernel is
bit-exact with its plain twin; the rotation tables come from the host
on both devices); scores 1e-5 (cuFFT against pocketfft/MKL); the
refinement bit-equal (the kernel rounds as its plain version); the float64
pose graph rtol 1e-9 (atomics sum in a run-dependent order); the
blocked pose-graph solver 1e-8 m/rad after 40 iterations in float64
(converged: in-flight iterates of a long chain spread rounding
differences), 1e-5 in float32 after four float64 refinement rounds;
the joint landmark + pose solve 1e-8 m/rad and chi2 rtol 1e-9 (cuBLAS
and cuSOLVER against the CPU's BLAS and LAPACK on a well-conditioned
loop); insert_range_data over successive keyframes into one grid
bit-equal (each launch against the plain version on the same grid);
the single-submap and batched matchers: candidate and pose equal,
scores 1e-5, best_candidate_with_cov's covariance rtol 1e-4 / atol
1e-5, window_cov's equal, pin bounds bit-equal.
"""
import numpy as np
import pytest
import torch

from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
from sparse_gslam_tpu_torch.models.frontend import Frontend, Keyframe
from sparse_gslam_tpu_torch.models.range_data import RangeData2D
from sparse_gslam_tpu_torch.ops import grid as grid_mod
from sparse_gslam_tpu_torch.ops import grid_cuda, matching, solvers
from sparse_gslam_tpu_torch.ops.grid import (
    GridSpec,
    build_submap_grid,
    insert_range_data,
    insert_rays_plain,
    precompute_pyramid,
)
from sparse_gslam_tpu_torch.utils import se2
from sparse_gslam_tpu_torch.utils.config import SlamConfig


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these cases run only on a GPU")


def room():
    """A two-wall room grid (probs, pyramid levels 0 and 4, origin) on
    the CPU and the query base points seen in it."""
    a = np.linspace(-np.pi / 2, np.pi / 2, 45)
    table = np.stack([np.cos(a), np.sin(a)], 1)
    rd = RangeData2D()
    for i in range(12):
        pose = np.array([0.0, 0.2 * i, 0.0])
        with np.errstate(divide="ignore"):
            r = (4.0 - pose[0]) / np.cos(a)
        r = np.where((r > 0) & (np.abs(np.cos(a)) > 1e-6), r, np.inf)
        rd.insert_scan(np.minimum(r, 8.0), table, 8.0, pose=pose)
    sm = build_submap_grid(rd, GridSpec(size=128, resolution=0.1),
                           device="cpu")
    pyr = precompute_pyramid(sm.probs, 5)
    base = np.column_stack([np.full(50, 4.0), np.linspace(-0.5, 2.5, 50)])
    return sm.probs, pyr[0], pyr[4], sm.origin, base


@pytest.mark.gpu
def test_pruned_matcher_and_refinement_on_cuda_match_cpu():
    need_card()
    probs, score, pooled, origin, base = room()
    query = se2.apply(se2.inverse(np.array([0.4, -0.3, 0.1])), base)
    spec = matching.search_spec(2.0, 0.6, 8.0, 0.1)
    rng = np.random.default_rng(3)
    shifts = [np.zeros(2, np.float32)] + [
        rng.uniform(-3, 3, 2).astype(np.float32) for _ in range(2)]
    thetas0 = [0.0] + list(rng.uniform(-0.5, 0.5, 2))
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = matching.match_candidates_pruned(
            [score.to(dev)] * 3, [pooled.to(dev)] * 3,
            [(origin - torch.from_numpy(s)).to(dev) for s in shifts],
            thetas0, query, spec, 0.5, 16)
    assert out["cuda"][0] == out["cpu"][0] is not None
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5
    np.testing.assert_array_equal(out["cuda"][2], out["cpu"][2])
    np.testing.assert_array_equal(out["cuda"][3], out["cpu"][3])

    # padded as the backend pads a query (_bucket(n, 256))
    pts = np.zeros((256, 2), np.float32)
    pts[:len(query)] = query
    init = np.array([0.45, -0.33, 0.11], np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        res[dev] = matching.refine_pose_cov(
            probs.to(dev), origin.to(dev), 0.1,
            torch.from_numpy(pts).to(dev),
            torch.from_numpy(np.arange(256) < len(query)).to(dev),
            torch.from_numpy(init).to(dev))
    for a, b in zip(res["cuda"], res["cpu"]):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


def refine_world(G, res, n=512):
    """A 7 x 6 m room as a (G, G) grid centred on the origin: walls 0.9
    three cells wide, free space 0.2 with seeded noise, unknown outside;
    and a scan of its walls from (0.3, 0.4, 0.2) (400 beams, n - 64
    above n = 512), padded to n (or not cut: the caller takes n)."""
    rng = np.random.default_rng(G)
    origin = np.full(2, -G * res / 2, np.float32)
    c = origin[0] + (np.arange(G) + 0.5) * res
    X, Y = np.meshgrid(c, c, indexing="ij")
    inside = (X > -3) & (X < 4) & (Y > -1) & (Y < 5)
    g = np.where(inside, 0.2 + rng.uniform(-0.05, 0.05, X.shape), 0.0)
    band = 1.5 * res
    near = (X > -3 - band) & (X < 4 + band) & (Y > -1 - band) & (Y < 5 + band)
    wall = near & ((np.abs(X - 4) < band) | (np.abs(X + 3) < band)
                   | (np.abs(Y + 1) < band) | (np.abs(Y - 5) < band))
    g = np.where(wall, 0.9, g).astype(np.float32)
    beams = 400 if n <= 512 else n - 64
    a = np.linspace(-np.pi, np.pi, beams, endpoint=False)
    gt = np.array([0.3, 0.4, 0.2])
    walls = [((4.0, 0.0), (0.0, 1.0)), ((-3.0, 0.0), (0.0, 1.0)),
             ((0.0, -1.0), (1.0, 0.0)), ((0.0, 5.0), (1.0, 0.0))]
    best = np.full(a.shape, np.inf)
    for (px, py), (dx, dy) in walls:
        cx, cy = np.cos(a + gt[2]), np.sin(a + gt[2])
        den = cx * dy - cy * dx
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((px - gt[0]) * dy - (py - gt[1]) * dx) / den
        best = np.minimum(best, np.where((np.abs(den) > 1e-9) & (t > 0), t,
                                         np.inf))
    pts = np.zeros((max(n, beams), 2), np.float32)
    pts[:beams] = np.stack([best * np.cos(a), best * np.sin(a)], 1)
    return g, origin, pts, beams


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192, 16384,
                               32768, 65536])
def test_refine_kernel_matches_plain_on_cuda(n):
    """The refinement kernel (one launch per call) against its plain
    version on the same CUDA tensors, torch.equal, at padded point
    counts it takes (refine_cuda.takes_points; above 8192 its rows in
    global scratch, staged through shared memory): one stage at 0.1 m,
    two stages (0.1 m dilated, then 0.05 m) and the pose alone."""
    need_card()
    from sparse_gslam_tpu_torch.ops import refine_cuda

    assert refine_cuda.takes_points(n)
    dev = torch.device("cuda")
    g1, o1, pts, beams = refine_world(320, 0.1, n)
    g2, o2, _, _ = refine_world(576, 0.05, n)
    coarse = precompute_pyramid(torch.from_numpy(g1).to(dev), 1)[0]
    s1 = (torch.from_numpy(g1).to(dev), torch.from_numpy(o1).to(dev), 0.1)
    s2 = (torch.from_numpy(g2).to(dev), torch.from_numpy(o2).to(dev), 0.05)
    q = (torch.from_numpy(pts[:n]).to(dev),
         (torch.arange(n) < min(n, beams) - 20).to(dev),
         torch.tensor([0.33, 0.36, 0.21], dtype=torch.float32, device=dev))
    s0 = (coarse.contiguous(), s1[1], 0.1)
    before = refine_cuda.refine_cuda.launches
    got = [matching.refine_pose_cov(*s1, *q),
           matching.refine_pose_cov_two_stage(*s0, *s2, *q),
           (matching.refine_pose(*s1, *q),)]
    assert refine_cuda.refine_cuda.launches == before + 3
    ref = [matching.refine_plain([s1], *q),
           matching.refine_plain([s0, s2], *q),
           (matching.refine_plain([s1], *q, want_cov=False),)]
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.is_cuda and b.is_cuda
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_pose_graph_on_cuda_matches_cpu():
    need_card()
    rng = np.random.default_rng(0)
    N, n, C = 128, 100, 16
    steps = np.column_stack([np.full(n, 0.5), np.zeros(n),
                             rng.normal(0.0, 0.1, n)])
    truth = [np.zeros(3)]
    for k in range(1, n):
        truth.append(se2.compose(truth[-1], steps[k]))
    truth = np.stack(truth)
    noisy = steps + rng.normal(0.0, [0.02, 0.02, 0.005], steps.shape)
    poses = np.zeros((N, 3))
    poses[0] = truth[0]
    for k in range(1, n):
        poses[k] = se2.compose(poses[k - 1], noisy[k])
    ci = rng.integers(0, n // 2, C)
    cj = rng.integers(n // 2, n, C)
    fields = dict(
        poses=poses, valid=np.arange(N) < n, fixed=np.arange(N) == 0,
        chain_meas=np.concatenate([noisy, np.zeros((N - n, 3))]),
        chain_info=np.tile(np.eye(3) * 100.0, (N, 1, 1)),
        chain_valid=(np.arange(N) > 0) & (np.arange(N) < n),
        clo_i=ci, clo_j=cj,
        clo_meas=np.stack([se2.relative(truth[i], truth[j])
                           for i, j in zip(ci, cj)]),
        clo_info=np.tile(np.eye(3) * 50.0, (C, 1, 1)),
        clo_valid=np.ones(C, bool),
    )
    from sparse_gslam_tpu_torch.interop import pose_graph_from_numpy

    ref = solvers.optimize_pose_graph(
        pose_graph_from_numpy(fields, "cpu"), 1.0, 20)
    out = solvers.optimize_pose_graph(
        pose_graph_from_numpy(fields, "cuda"), 1.0, 20)
    np.testing.assert_allclose(out.poses.cpu().numpy(), ref.poses.numpy(),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.gpu
def test_backend_precompute_on_cuda_launches_the_kernel():
    """precompute on the card inserts both grids of a submap with the
    kernel (two launches) and gives the CPU run's grids bit for bit."""
    need_card()
    from sparse_gslam_tpu_torch.ops.grid_cuda import insert_rays_cuda

    cfg = SlamConfig(range_max=8.0, scan_size=8,
                     submap_trajectory_length=2.0, submap_overlap_poses=0)
    table = np.stack([np.cos(np.linspace(-1, 1, 8)),
                      np.sin(np.linspace(-1, 1, 8))], 1)
    closers = {}
    for dev in ("cpu", "cuda"):
        fe = Frontend(cfg, device=dev)
        for i in range(8):
            p = np.array([0.5 * i, 0.0, 0.0])
            kf = Keyframe(estimate=p, odom_meas=np.zeros(3),
                          odom_info=np.eye(3), data=RangeData2D(),
                          odom_times=[float(i)], odom_dposes=[p])
            kf.data.insert_scan(np.full(8, 3.0), table, cfg.range_max)
            fe.keyframes.append(kf)
        closers[dev] = SubmapLoopCloser(cfg, fe, device=dev)
    before = insert_rays_cuda.launches
    closers["cpu"].precompute()
    closers["cuda"].precompute()
    torch.cuda.synchronize()
    assert insert_rays_cuda.launches == before + 2
    a, b = closers["cuda"].submaps[0], closers["cpu"].submaps[0]
    for name in ("probs", "high_res", "score_grid", "pooled_grid"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_blocked_pose_graph_on_cuda_matches_cpu(dtype):
    """The keyframe-partitioned solver (4 blocks of 128) on the card
    against the same solve on the CPU; float32 with float64
    refinement as optimize_partitioned offers it."""
    need_card()
    from sparse_gslam_tpu_torch.eval.synthetic_graphs import (
        make_chain_graph,
        to_pose_graph,
    )
    from sparse_gslam_tpu_torch.parallel import dist_solver

    fields, _ = make_chain_graph(n_poses=500, n_closures=16, pad_to=512,
                                 drift=0.005, seed=4)
    rounds = 0 if dtype == torch.float64 else 4
    out = {}
    for dev in ("cpu", "cuda"):
        g = to_pose_graph(fields, dev, dtype)
        out[dev] = dist_solver.optimize_partitioned(
            g, 1.0, 4, iterations=40, refine_rounds=rounds).poses
        assert out[dev].device.type == dev and out[dev].dtype == dtype
    np.testing.assert_allclose(out["cuda"].cpu().double().numpy(),
                               out["cpu"].double().numpy(), rtol=0,
                               atol=1e-8 if rounds == 0 else 1e-5)


@pytest.mark.gpu
def test_joint_solve_on_cuda_matches_cpu():
    """optimize_joint_graph on the card against the same solve on the
    CPU (float64 both): a 40-pose loop padded to 64 that observes 8
    lines outside it, one closure end to start and one gross outlier
    closure (DCS), padded edge and closure slots at index 0."""
    need_card()
    from sparse_gslam_tpu_torch.interop import joint_graph_from_numpy
    from sparse_gslam_tpu_torch.ops.line_geometry import transform_line

    rng = np.random.default_rng(3)
    P, n, L, C = 64, 40, 8, 4
    truth = [np.zeros(3)]
    for k in range(1, n):
        turn = np.pi / 2 if k % (n // 4) == 0 else 0.0
        truth.append(se2.compose(truth[-1], np.array([0.5, 0.0, turn])))
    truth = np.stack(truth)
    lines = np.stack([np.array([8.0 + 0.5 * k, 0.8 * k]) for k in range(L)])
    odom = np.zeros((P, 3))
    poses = np.zeros((P, 3))
    for k in range(1, n):
        odom[k] = se2.relative(truth[k - 1], truth[k]) + rng.normal(
            0.0, [0.03, 0.03, 0.01])
        poses[k] = se2.compose(poses[k - 1], odom[k])
    obs = [(k, m) for k in range(n) for m in range(L) if (k + m) % 2 == 0]
    E = 256
    obs_pose = np.zeros(E, np.int64)
    obs_lm = np.zeros(E, np.int64)
    obs_meas = np.zeros((E, 2))
    for e, (k, m) in enumerate(obs):
        inv = se2.inverse(truth[k])
        obs_pose[e], obs_lm[e] = k, m
        obs_meas[e] = np.asarray(transform_line(lines[m], inv[:2], inv[2]))
    clo = [(0, n - 1), (5, n // 2)]
    clo_meas = np.zeros((C, 3))
    for c, (i, j) in enumerate(clo):
        clo_meas[c] = se2.relative(truth[i], truth[j])
    clo_meas[1] += [1.5, -1.0, 0.5]
    fields = dict(
        poses=poses, pose_valid=np.arange(P) < n,
        pose_fixed=np.arange(P) == 0, odom_meas=odom,
        odom_info=np.tile(np.eye(3) * 400.0, (P, 1, 1)),
        odom_valid=(np.arange(P) > 0) & (np.arange(P) < n),
        lms=lines + rng.normal(0.0, 0.05, lines.shape),
        lm_valid=np.ones(L, bool), obs_pose=obs_pose, obs_lm=obs_lm,
        obs_meas=obs_meas, obs_info=np.tile(np.eye(2) * 1e4, (E, 1, 1)),
        obs_valid=np.arange(E) < len(obs),
        clo_i=np.array([c[0] for c in clo] + [0, 0]),
        clo_j=np.array([c[1] for c in clo] + [0, 0]),
        clo_meas=clo_meas, clo_info=np.tile(np.eye(3) * 1e4, (C, 1, 1)),
        clo_valid=np.arange(C) < len(clo),
    )
    out = {}
    for dev in ("cpu", "cuda"):
        g, chi2 = solvers.optimize_joint_graph(
            joint_graph_from_numpy(fields, dev), 10.0, 12)
        out[dev] = (g.poses.cpu().numpy(), g.lms.cpu().numpy(), float(chi2))
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-9)
    assert out["cpu"][2] < 0.1 * float(solvers.joint_graph_chi2(
        joint_graph_from_numpy(fields, "cpu"), 10.0))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 512, 16384])
def test_refine_pins_kernel_matches_batched_plain_on_cuda(n):
    """The refinement kernel's batched mode (one launch for a batch of
    pins, each against its own grid of a stack, in the arithmetic of the
    JAX program's vmapped refinement) against its batched plain version
    on the same CUDA tensors, torch.equal."""
    need_card()
    from sparse_gslam_tpu_torch.ops import refine_cuda

    dev = torch.device("cuda")
    grids, origins, pts = [], [], []
    for k in range(3):
        g, o, p, _ = refine_world(576, 0.05, n)
        grids.append(np.roll(g, 2 * k, axis=0))
        origins.append(o)
        pts.append(p[:n])
    ids = torch.tensor([2, 0, 1, 2], dtype=torch.int32, device=dev)
    B = len(ids)
    grids = torch.from_numpy(np.stack(grids)).to(dev)
    origins = torch.from_numpy(np.stack(origins)).to(dev)
    q = torch.from_numpy(np.stack([pts[i] for i in ids.tolist()])).to(dev)
    valid = (torch.arange(n, device=dev)[None] < torch.tensor(
        [[n - 20], [n // 2], [n - 1], [100]], device=dev)).contiguous()
    init = torch.tensor([[0.33, 0.36, 0.21]] * B, dtype=torch.float32,
                        device=dev)
    init[:, 2] += torch.arange(B, device=dev) * 0.01
    before = refine_cuda.refine_pins_cuda.launches
    got = matching.refine_pins(grids, origins, ids, 0.05, q, valid, init)
    assert refine_cuda.refine_pins_cuda.launches == before + 1
    ref = matching.refine_pins_plain(grids, origins, ids, 0.05, q, valid,
                                     init)
    for a, b in zip(got, ref):
        assert a.is_cuda and b.is_cuda
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_pose_graph_on_cuda_matches_blocked(shards):
    """The sharded solver on an in-process mesh of `shards` shards on the
    card (cuda:0 repeated where there is one card) against the blocked
    solver on the card, float64, 1e-10."""
    need_card()
    from sparse_gslam_tpu_torch.eval.synthetic_graphs import (
        make_chain_graph,
        to_pose_graph,
    )
    from sparse_gslam_tpu_torch.parallel import dist_solver, multihost

    fields, _ = make_chain_graph(n_poses=500, n_closures=16, pad_to=512,
                                 drift=0.005, seed=4)
    g = to_pose_graph(fields, "cuda")
    k = torch.cuda.device_count()
    mesh = multihost.block_mesh(
        shards, [torch.device(f"cuda:{i % k}") for i in range(shards)])
    sh = dist_solver.optimize_partitioned(g, 1.0, 8, iterations=20,
                                          mesh=mesh).poses
    bl = dist_solver.optimize_partitioned(g, 1.0, 8, iterations=20).poses
    assert sh.is_cuda
    assert float((sh - bl).abs().max()) <= 1e-10


@pytest.mark.gpu
def test_insert_range_data_on_cuda_matches_plain():
    """Successive keyframes into one grid on the card: each launch reads
    the odds the earlier ones wrote, and equals the plain version on the
    same grid and inputs; S below and above 8 scans a keyframe."""
    need_card()
    rng = np.random.default_rng(4)
    a = np.linspace(-1.2, 1.2, 45)
    table = np.stack([np.cos(a), np.sin(a)], 1)
    spec = GridSpec(size=320, resolution=0.1)
    origin = torch.tensor([-16.0, -16.0], device="cuda")
    probs = torch.zeros((320, 320), device="cuda")
    calls = []
    real = grid_mod.insert_rays

    def recording(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    grid_cuda.reset_launches(grid_cuda.insert_rays_cuda)
    try:
        grid_mod.insert_rays = recording
        for k in range(6):
            rd = RangeData2D()
            for _ in range(3 if k % 2 else 11):
                ranges = rng.uniform(1.0, 9.0, len(a))
                ranges[rng.random(len(a)) < 0.2] = 12.0
                sp = np.array([*rng.uniform(-0.2, 0.2, 2),
                               rng.uniform(-0.1, 0.1)])
                rd.insert_scan(ranges, table, 10.0, pose=sp)
            pose = np.array([0.6 * k, 0.2 * k, 0.15 * k])
            probs = insert_range_data(probs, origin, rd, pose, spec)
    finally:
        grid_mod.insert_rays = real
    assert grid_cuda.insert_rays_cuda.launches == len(calls) == 6
    for args, out in calls:
        assert torch.equal(out, insert_rays_plain(*args))
    assert (probs > 0.5).sum() > 100


def _match_inputs():
    """tests/test_grid_matching.py TestBatchedPrunedMatching's case: the
    true submap (index 1) among decoys whose origins lie far off, so
    that no two candidates tie within the FFTs' rounding."""
    probs, score, pooled, origin, base = room()
    query = se2.apply(se2.inverse(np.array([0.4, -0.3, 0.1])), base)
    shifts = [(30.0, 30.0), (0.0, 0.0), (-25.0, 10.0), (12.0, -28.0),
              (-30.0, -30.0)]
    origins = [origin + torch.tensor(s) for s in shifts]
    thetas0 = [0.3, 0.0, -0.2, 0.1, -0.4]
    return score, pooled, origins, thetas0, query


@pytest.mark.gpu
def test_batched_matchers_on_cuda_match_cpu():
    need_card()
    score, pooled, origins, thetas0, query = _match_inputs()
    spec = matching.search_spec(2.0, 0.6, 8.0, 0.1)
    out = {}
    for dev in ("cpu", "cuda"):
        sg = [score.to(dev)] * 5
        pg = [pooled.to(dev)] * 5
        og = [o.to(dev) for o in origins]
        out[dev] = (
            matching.match_submap(sg[0], og[0], 0.1, query, 0.0, spec),
            matching.match_submaps_batched(sg, og, thetas0, query, spec,
                                           chunk=4),
            matching.match_candidates_pruned_batched(
                sg, pg, og, thetas0, query, spec, 0.5, 16, chunk=2),
            matching.match_candidates_pruned(sg, pg, og, thetas0, query,
                                             spec, 0.5, 16),
        )
    c, h = out["cuda"], out["cpu"]
    for a, b in [(c[0], h[0])] + list(zip(c[1], h[1])):
        assert abs(a[0] - b[0]) <= 1e-5
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[2], b[2], rtol=1e-4, atol=1e-5)
    for a, b in ((c[2], h[2]), (c[2], c[3])):
        assert a[0] == b[0] == 1
        assert abs(a[1] - b[1]) <= 1e-5
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.gpu
def test_pin_bounds_and_score_pose_on_cuda_match_cpu():
    need_card()
    probs, score, pooled, origin, base = room()
    rng = np.random.default_rng(6)
    Kp, N, R = 6, 200, 9
    pts = torch.from_numpy(rng.uniform(0, 6, (Kp, N, 2)).astype(np.float32))
    val = torch.from_numpy(rng.random((Kp, N)) < 0.8)
    orgs = origin[None] + torch.from_numpy(
        rng.uniform(-1, 1, (Kp, 2)).astype(np.float32))
    ths = torch.from_numpy(rng.uniform(-0.3, 0.3, (Kp, R)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 2, Kp))
    stack = torch.stack([pooled, score])
    b = {dev: matching.pin_bounds_batch(
        stack.to(dev), ids.to(dev), orgs.to(dev), pts.to(dev), val.to(dev),
        ths.to(dev), 0.1, 8, extra=True).cpu() for dev in ("cpu", "cuda")}
    assert torch.equal(b["cuda"], b["cpu"])
    pose = torch.tensor([0.4, -0.3, 0.1])
    s = {dev: matching.score_pose(
        score.to(dev), origin.to(dev), pts[0].to(dev), val[0].to(dev),
        pose.to(dev), 0.1, 128).cpu() for dev in ("cpu", "cuda")}
    assert torch.equal(s["cuda"], s["cpu"])
