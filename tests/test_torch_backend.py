"""The port's loop-closing backend (sparse_gslam_tpu_torch/models/
backend.py) against the JAX package's, on the CPU.

1. The cases of tests/test_backend_unit.py (submap creation geometry,
   map-frame transforms, the match flow, the ridge-drift gate) through
   both SubmapLoopClosers on the same hand-built frontends.
2. The first N_FRAMES frames of sim-office, through the first live loop
   closure (query mid 174, accepted at frame 425), through both
   SlamSystems with the backend on: the submap grids bit for bit, the
   same (i, j, kind, active) closure list, and the pose-graph vertices
   within POSE_ATOL.

POSE_ATOL: closure measurements come from float32 Gauss-Newton
refinement, which the port does not round as XLA does (up to ~2e-5 m
apart on the same inputs); the solved vertices differ by ~1.5e-5 at
N_FRAMES, and 1e-4 m/rad holds them.
"""
import os

import numpy as np
import pytest
import torch

from sparse_gslam_tpu.io.providers import create_data_provider
from sparse_gslam_tpu.models.backend import SubmapLoopCloser as JCloser
from sparse_gslam_tpu.models.frontend import Frontend as JFrontend
from sparse_gslam_tpu.models.frontend import Keyframe as JKeyframe
from sparse_gslam_tpu.models.range_data import RangeData2D as JRangeData2D
from sparse_gslam_tpu.models.slam import SlamSystem as JSlamSystem
from sparse_gslam_tpu.utils.config import SlamConfig as JSlamConfig
from sparse_gslam_tpu.utils.config import load_dataset_config
from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
from sparse_gslam_tpu_torch.models.frontend import Frontend, Keyframe
from sparse_gslam_tpu_torch.models.range_data import RangeData2D
from sparse_gslam_tpu_torch.models.slam import SlamSystem
from sparse_gslam_tpu_torch.utils import se2
from sparse_gslam_tpu_torch.utils.config import SlamConfig
from sparse_gslam_tpu_torch.utils.config import (
    load_dataset_config as t_load_dataset_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFICE = os.path.join(ROOT, "datasets", "sim-office")
N_FRAMES = 430
POSE_ATOL = 1e-4

PORT = dict(cfg=SlamConfig, fe=Frontend, kf=Keyframe, rd=RangeData2D)
JAX = dict(cfg=JSlamConfig, fe=JFrontend, kf=JKeyframe, rd=JRangeData2D)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def cfg(pkg, **kw):
    args = dict(
        range_max=8.0, scan_size=8, submap_trajectory_length=2.0,
        submap_overlap_poses=0, last_submap_not_match=0,
        max_match_distance=100.0, last_traj_length=1.0,
        loop_closure_min_score=0.7, match_interval=1,
    )
    return pkg["cfg"](**{**args, **kw})


def frontend_with_path(pkg, poses, c):
    """Frontend with keyframes at given poses, each holding a small
    range scan of a wall 3 m ahead (test_backend_unit's fixture)."""
    fe = pkg["fe"](c) if pkg is JAX else pkg["fe"](c, device="cpu")
    table = np.stack(
        [np.cos(np.linspace(-1, 1, 8)), np.sin(np.linspace(-1, 1, 8))], 1
    )
    for i, p in enumerate(poses):
        kf = pkg["kf"](
            estimate=np.asarray(p, dtype=np.float64),
            odom_meas=se2.relative(poses[i - 1], p) if i else np.zeros(3),
            odom_info=np.eye(3) * 100.0,
            data=pkg["rd"](),
            odom_times=[float(i)],
            odom_dposes=[np.asarray(p, dtype=np.float64)],
        )
        kf.data.insert_scan(np.full(8, 3.0), table, c.range_max)
        fe.keyframes.append(kf)
    return fe


def closers(poses, **kw):
    """(port, JAX) SubmapLoopClosers over the same path."""
    out = []
    for pkg in (PORT, JAX):
        c = cfg(pkg, **kw)
        fe = frontend_with_path(pkg, poses, c)
        out.append(SubmapLoopCloser(c, fe, device="cpu") if pkg is PORT
                   else JCloser(c, fe))
    return out


def line_path(n, step):
    return [np.array([step * i, 0.0, 0.0]) for i in range(n)]


def loop_path():
    """Out-and-back path revisiting the start with a wall ahead."""
    fwd = [np.array([0.4 * i, 0.0, 0.0]) for i in range(10)]
    back = [np.array([0.4 * (9 - i), 0.02, 0.0]) for i in range(10)]
    return fwd + back


def assert_same_submaps(t, j):
    assert t.submap_count == j.submap_count
    for a, b in zip(t.submaps, j.submaps):
        assert (a.anchor_idx, a.start_idx, a.end_idx) == (
            b.anchor_idx, b.start_idx, b.end_idx)
        for name in ("score_grid", "pooled_grid", "probs", "origin",
                     "high_res", "high_origin"):
            np.testing.assert_array_equal(
                getattr(a, name).cpu().numpy(), np.asarray(getattr(b, name)),
                err_msg=name)


def closure_keys(closer):
    return [(c.i, c.j, c.kind, c.active) for c in closer.closures]


@pytest.mark.parametrize("n,step,overlap,submaps,anchor,last", [
    (8, 0.5, 0, 1, 3, 3),  # submap after the trajectory length
    (5, 0.2, 0, 0, None, 0),  # too short: none
    (8, 0.5, 2, 1, 3, 1),  # overlap poses: last = mid - overlap
])
def test_precompute_matches_jax(n, step, overlap, submaps, anchor, last):
    t, j = closers(line_path(n, step), submap_overlap_poses=overlap)
    t.precompute()
    j.precompute()
    assert t.submap_count == submaps
    if submaps:
        assert t.submaps[0].anchor_idx == anchor
    assert t.last_pose_idx == j.last_pose_idx == last
    assert_same_submaps(t, j)


def test_map_transforms_match_jax():
    t, j = closers(line_path(6, 0.5))
    for b in (t, j):
        b._ensure_pg_init()
        # pretend a closure shifted the pose graph by (0, 1, 0)
        b.pg_poses[0] = np.array([0.0, 1.0, 0.0])
    mt, mj = t._map_transforms(), j._map_transforms()
    for i in range(6):
        np.testing.assert_allclose(mt(i), mj(i), rtol=0, atol=1e-12)
    np.testing.assert_allclose(mt(3), [1.5, 1.0, 0.0], atol=1e-12)


@pytest.mark.parametrize("min_score", [0.7, 0.999])
def test_match_flow_matches_jax(min_score):
    t, j = closers(loop_path(), loop_closure_min_score=min_score)
    for _ in range(6):
        t.precompute()
        j.precompute()
    assert t.submap_count >= 2
    assert_same_submaps(t, j)
    ok = t.match()
    assert ok == j.match()
    assert closure_keys(t) == closure_keys(j)
    if min_score > 0.99:
        assert not ok and t.closure_count == 0
    if ok:
        n = len(t.frontend.keyframes)
        assert t.last_opt_pose_index == n == len(t.pg_poses)
        assert t.frontend.window_start == n - 1
        assert len(t.frontend.obs_edges) == 0
        np.testing.assert_allclose(np.stack(t.pg_poses),
                                   np.stack(j.pg_poses), rtol=0,
                                   atol=POSE_ATOL)


def ridge_cov(sigma_along=0.9, sigma_cross=0.05, axis=0.0):
    ca, sa = np.cos(axis), np.sin(axis)
    V = np.array([[ca, -sa], [sa, ca]])
    out = np.eye(3) * 1e-4
    out[:2, :2] = V @ np.diag([sigma_along**2, sigma_cross**2]) @ V.T
    return out


@pytest.mark.parametrize("cov,refined,max_drift,reject", [
    (ridge_cov(), [2.0, 0.03, 0.0], 1.3, True),  # alias drift
    (ridge_cov(), [0.15, 0.02, 0.0], 1.3, False),  # true ridge closure
    (ridge_cov(sigma_along=0.1), [2.0, 0.0, 0.0], 1.3, False),  # sharp
    (ridge_cov(axis=np.pi / 2), [2.0, 0.1, 0.0], 1.3, False),  # cross
    (ridge_cov(), [5.0, 0.0, 0.0], 0.0, False),  # gate disabled
])
def test_ridge_drift_gate_matches_jax(cov, refined, max_drift, reject):
    t, j = closers(line_path(4, 0.5), closure_ridge_max_drift=max_drift)
    args = (cov, np.array(refined), np.zeros(2))
    got = t._ridge_drift_gate(*args)
    assert got == j._ridge_drift_gate(*args)
    assert got[2] == reject


def test_unported_options_are_refused():
    fe = Frontend(SlamConfig(), device="cpu")
    for kw in (dict(pg_solver="blocked"), dict(final_refine_rounds=1),
               dict(final_joint=True), dict(chain_info_mode="marginal")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SubmapLoopCloser(SlamConfig(**kw), fe, device="cpu")


@pytest.fixture(scope="module")
def office_runs():
    """Both systems, backend on, after the same N_FRAMES frames."""
    log = os.path.join(OFFICE, "sim-office.log")
    js = JSlamSystem(*load_dataset_config(OFFICE))
    ts = SlamSystem(*t_load_dataset_config(OFFICE), device="cpu")
    for k, fr in enumerate(create_data_provider("carmen", log).frames()):
        if k == N_FRAMES:
            break
        js.process_frame(fr)
        ts.process_frame(fr)
    return js, ts


def test_office_backend_matches_jax(office_runs):
    js, ts = office_runs
    jb, tb = js.backend, ts.backend
    assert tb.submap_count == jb.submap_count > 10
    assert_same_submaps(tb, jb)
    assert closure_keys(tb) == closure_keys(jb)
    # the first live loop closure (query mid 174 on submap anchor 25)
    assert (25, 174, "loop", True) in closure_keys(tb)
    assert tb.last_opt_pose_index == jb.last_opt_pose_index
    np.testing.assert_allclose(np.stack(tb.pg_poses), np.stack(jb.pg_poses),
                               rtol=0, atol=POSE_ATOL)
    assert len(ts.frontend.archived_obs) == len(js.frontend.archived_obs) > 0
    assert len(ts.backend_times) == len(js.backend_times)


def test_office_frontend_after_prune_matches_jax(office_runs):
    """After the closure pruned the landmark window, the frontend keeps
    solving the same window from the pruned fixed pose."""
    js, ts = office_runs
    assert ts.frontend.window_start == js.frontend.window_start > 0
    assert len(ts.frontend.obs_edges) == len(js.frontend.obs_edges)
    np.testing.assert_allclose(ts.frontend.estimates(),
                               js.frontend.estimates(), rtol=0, atol=1e-8)


def test_office_result_uses_pose_graph(office_runs, tmp_path):
    js, ts = office_runs
    ts.write_result(str(tmp_path / "t.result"))
    js.write_result(str(tmp_path / "j.result"))
    t = np.loadtxt(tmp_path / "t.result", usecols=(2, 3, 4, 8))
    j = np.loadtxt(tmp_path / "j.result", usecols=(2, 3, 4, 8))
    assert t.shape == j.shape
    np.testing.assert_array_equal(t[:, 3], j[:, 3])
    d = t[:, :3] - j[:, :3]
    d[:, 2] = se2.wrap_angle(d[:, 2])
    # 6-decimal file format on top of POSE_ATOL
    assert np.abs(d).max() <= POSE_ATOL + 2e-6
