"""Cases of the port that need a CUDA card: the backend's device work on
the card against the same functions on the CPU. They skip without a
card. This file imports neither jax nor the JAX package, so it also
runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

Tolerances: grids and cell indices bit-equal (the insertion kernel is
bit-exact with its plain twin; the rotation tables come from the host
on both devices); scores 1e-5 (cuFFT against pocketfft/MKL); the
refined pose 1e-5 m/rad (float32 sums in another order); the float64
pose graph rtol 1e-9 (atomics sum in a run-dependent order).
"""
import numpy as np
import pytest
import torch

from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
from sparse_gslam_tpu_torch.models.frontend import Frontend, Keyframe
from sparse_gslam_tpu_torch.models.range_data import RangeData2D
from sparse_gslam_tpu_torch.ops import matching, solvers
from sparse_gslam_tpu_torch.ops.grid import (
    GridSpec,
    build_submap_grid,
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

    pts = np.zeros((128, 2), np.float32)
    pts[:len(query)] = query
    init = np.array([0.45, -0.33, 0.11], np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        res[dev] = matching.refine_pose_cov(
            probs.to(dev), origin.to(dev), 0.1,
            torch.from_numpy(pts).to(dev),
            torch.from_numpy(np.arange(128) < len(query)).to(dev),
            torch.from_numpy(init).to(dev))
    np.testing.assert_allclose(res["cuda"][0].cpu().numpy(),
                               res["cpu"][0].numpy(), rtol=0, atol=1e-5)


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
