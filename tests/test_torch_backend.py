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

3. refine_map, and the final joint landmark + pose solve, on copies of
   both backends after those frames; the marginal chain information of
   both frontends' windows.

POSE_ATOL: the closure measurements are bit-equal (the port's float32
refinement rounds as XLA's CPU program); the solved vertices differ by
the float64 solves' rounding (5.7e-13 m at N_FRAMES), and 1e-9 m/rad
holds them. JOINT_ATOL: the joint LM's 12 iterations stop in flight on
an ill-conditioned (3P)^2 = 1536^2 Schur system whose fill-in and
Cholesky sum in other orders than XLA's. One damped solve of the full
sim-office run's final joint graph already differs by 4.7e-9 m between
the packages, the iterates in flight by up to 7e-7 m, the fixpoint
(its rtol stop, 13 iterations) by 1.1e-9 m; here 1.2e-8 m after the
12 iterations
(an Intel Xeon CPU; scripts/joint_pair.py on SLAM_DUMP_JOINT dumps).
"""
import dataclasses
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
POSE_ATOL = 1e-9
JOINT_ATOL = 5e-8

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


def test_office_blocked_route_matches_jax(office_runs, monkeypatch):
    """With dist_solver_min_poses lowered to 256, copies of both
    backends after N_FRAMES take the keyframe-partioned solver (the
    dense one is made to raise in both packages) through a final-style
    match at min score 0.5, the chi2 prune and a solve: the same
    closures, activity and consistency suppression, and pose-graph
    vertices within POSE_ATOL."""
    import copy

    import sparse_gslam_tpu.models.backend as jbackend
    import sparse_gslam_tpu_torch.ops.solvers as tsolvers

    def refuse(*a, **k):
        raise AssertionError("dense pose-graph solver called")

    monkeypatch.setattr(jbackend, "_get_pg_solver", refuse)
    monkeypatch.setattr(tsolvers, "optimize_pose_graph", refuse)
    backends = [copy.deepcopy(s.backend) for s in office_runs]
    for b in backends:
        b.config = dataclasses.replace(b.config, dist_solver_min_poses=256)
        assert b._build_pg_data().poses.shape[0] == 256
        b.loop_closure_min_score = 0.5
        b.match()
        b.prune_false_closures()
        b.optimize()
    jb, tb = backends
    assert closure_keys(tb) == closure_keys(jb)
    assert ([c.suppressed for c in tb.closures]
            == [c.suppressed for c in jb.closures])
    np.testing.assert_allclose(np.stack(tb.pg_poses), np.stack(jb.pg_poses),
                               rtol=0, atol=POSE_ATOL)


def test_office_refine_map_matches_jax(office_runs):
    """refine_map (final_refine_rounds: one round) on copies of both
    backends after N_FRAMES: the grids rebuilt at the optimized poses
    bit for bit, the same closures re-measured (the seeded two-stage
    refinement on the 0.05 m grid rounds as XLA does, so each
    measurement agrees to the rebuilt grids' inputs, whose poses come
    from the float64 solves), and the re-solved pose graph within
    POSE_ATOL."""
    import copy

    backends = [copy.deepcopy(s.backend) for s in office_runs]
    before = [[np.array(c.meas) for c in b.closures] for b in backends]
    for b in backends:
        b.refine_map(rounds=1, iterations=20)
    jb, tb = backends
    assert_same_submaps(tb, jb)
    assert closure_keys(tb) == closure_keys(jb)
    moved = 0
    for a, b, m0 in zip(jb.closures, tb.closures, before[0]):
        np.testing.assert_allclose(b.meas, a.meas, rtol=0, atol=1e-9)
        np.testing.assert_allclose(b.info, a.info, rtol=1e-9, atol=0)
        moved += not np.array_equal(np.asarray(a.meas), m0)
    assert moved > 0  # refine_map re-measured closures
    np.testing.assert_allclose(np.stack(tb.pg_poses), np.stack(jb.pg_poses),
                               rtol=0, atol=POSE_ATOL)


def test_office_joint_solve_matches_jax(office_runs):
    """joint_solve (final_joint) on copies of both backends after
    N_FRAMES, each chain first extended to every keyframe as
    final_cleanup does: both run, over the same archived and active
    observation edges and closures, and give pose-graph vertices within
    JOINT_ATOL and the same landmark estimates."""
    import copy

    backends = [copy.deepcopy(s.backend) for s in office_runs]
    for b in backends:
        b.extend_chain()
        assert len(b.frontend.archived_obs) > 0
        assert b.joint_solve()
    jb, tb = backends
    np.testing.assert_allclose(np.stack(tb.pg_poses), np.stack(jb.pg_poses),
                               rtol=0, atol=JOINT_ATOL)
    before = np.stack(office_runs[1].backend.pg_poses)
    moved = np.abs(np.stack(tb.pg_poses)[: len(before)] - before).max()
    assert moved > 1e-4  # the joint solve moved the graph
    lids = {e.lm_idx for e in tb.frontend.archived_obs + tb.frontend.obs_edges}
    for lid in lids:
        np.testing.assert_allclose(tb.frontend.landmarks[lid].rhotheta,
                                   jb.frontend.landmarks[lid].rhotheta,
                                   rtol=0, atol=JOINT_ATOL)


@pytest.mark.parametrize("granularity", [1, 2, 6])
def test_office_relative_chain_info_matches_jax(office_runs, granularity):
    """relative_chain_info (chain_info_mode: marginal; read-only) over
    the active window of both frontends after N_FRAMES (the window the
    closure at frame 425 left: three keyframes and their landmarks),
    with blocks of 1, 2 and the default 6 edges: the same edges with
    informations within rtol 1e-9 (host numpy in both packages; the
    window's estimates come from the float64 LM solves)."""
    js, ts = office_runs
    ws = ts.frontend.window_start
    n = len(ts.frontend.keyframes)
    assert n - ws >= 3 and ts.frontend.obs_edges
    got = ts.frontend.relative_chain_info(ws + 1, n, granularity)
    ref = js.frontend.relative_chain_info(ws + 1, n, granularity)
    assert sorted(got) == sorted(ref) == list(range(ws + 1, n))
    for idx in ref:
        np.testing.assert_allclose(got[idx], ref[idx], rtol=1e-9,
                                   atol=1e-9 * np.abs(ref[idx]).max())
