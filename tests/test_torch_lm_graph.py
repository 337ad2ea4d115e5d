"""The landmark-graph LM's set-up and step as functions of state
(ops/solvers.py `_lm_prologue`, `_lm_step`) and their CUDA graphs.

- On the CPU the refactored eager solve is bit-equal to the benchmark's
  frozen reference (gslam_bench/reference/ops/solvers.py, the port's CPU
  path before the refactor), dense and block-tridiagonal paths, with
  and without the early stop; no graph is captured or replayed there.
- On the card (gpu marker; jax-free, `pytest --noconftest -m gpu`):
  solves replayed from the graphs are bit-equal to the eager loop
  (`_lm_solve` with no graphs) at the frontend's three most common
  padded shapes; the first solve of a key captures nothing, the second
  one prologue and one step graph, later ones replay; a new shape gets
  its own graphs; a capture succeeds while another thread runs CUDA
  work on its own stream (the realtime layout); a shape whose capture
  raises stays eager.
"""
import threading

import numpy as np
import pytest
import torch

from gslam_bench.reference.ops import solvers as ref
from sparse_gslam_tpu_torch.interop import lm_graph_from_numpy
from sparse_gslam_tpu_torch.ops import solvers
from sparse_gslam_tpu_torch.ops.line_geometry import transform_line
from sparse_gslam_tpu_torch.utils import se2
from sparse_gslam_tpu_torch.utils.trace import Recorder

STOPS = ("lm.stop.rtol", "lm.stop.lambda", "lm.stop.cap")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these cases run only on a GPU")


@pytest.mark.parametrize("rtol", [1e-7, 0.0], ids=["early_stop", "fixed"])
@pytest.mark.parametrize("graph", ["dense", "tridiag"])
def test_eager_lm_equals_frozen_reference(graph, rtol, monkeypatch):
    # the seeded windows of the JAX comparison (imports jax: CPU only)
    from test_torch_solvers import GRAPHS, lm_fields

    g = lm_graph_from_numpy(lm_fields(**GRAPHS[graph]), "cpu")
    rec = Recorder()
    out, chi2, dof = solvers.optimize_landmark_graph(g, 15, rtol=rtol,
                                                     rec=rec)
    calls = []
    inner = ref.lm_graph_chi2

    def counted(gg):
        calls.append(1)
        return inner(gg)
    monkeypatch.setattr(ref, "lm_graph_chi2", counted)
    r_out, r_chi2, r_dof = ref.optimize_landmark_graph(
        ref.LMGraphData(*g), 15, rtol=rtol)
    assert torch.equal(out.poses, r_out.poses)
    assert torch.equal(out.lms, r_out.lms)
    assert torch.equal(chi2, r_chi2) and torch.equal(dof, r_dof)
    counts = rec.counts
    # the reference's chi2 calls: one at the start, one a step
    assert counts["lm.iterations"] == len(calls) - 1 > 0
    if rtol == 0.0:
        assert counts["lm.iterations"] == 15
    assert counts["lm.graph.captures"] == counts["lm.graph.replays"] == 0
    assert counts["lm.graph.eager"] == counts["lm.iterations"]
    assert counts["lm.graph.fallback"] == 0
    assert solvers._LM_GRAPHS == {}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def window(P, L, E, n_poses, n_lms, seed):
    """A seeded padded window as numpy fields (test_torch_solvers'
    lm_fields built with the port's numpy SE(2) helpers): a noisy pose
    chain observing rho-theta lines, three observations a pose."""
    r = np.random.default_rng(seed)
    gt = np.zeros((n_poses, 3))
    for i in range(1, n_poses):
        gt[i] = se2.compose(gt[i - 1],
                            np.array([0.5, 0.02, r.uniform(-0.2, 0.2)]))
    gt_lms = np.stack(
        [r.uniform(1, 8, n_lms), r.uniform(-np.pi, np.pi, n_lms)], 1)
    f = dict(
        poses=np.zeros((P, 3)), pose_valid=np.zeros(P, bool),
        pose_fixed=np.zeros(P, bool), odom_meas=np.zeros((P, 3)),
        odom_info=np.tile(np.eye(3), (P, 1, 1)),
        odom_valid=np.zeros(P, bool), lms=np.zeros((L, 2)),
        lm_valid=np.zeros(L, bool), obs_pose=np.zeros(E, np.int64),
        obs_lm=np.zeros(E, np.int64), obs_meas=np.zeros((E, 2)),
        obs_info=np.tile(np.eye(2), (E, 1, 1)), obs_valid=np.zeros(E, bool),
    )
    f["pose_valid"][:n_poses] = True
    f["pose_fixed"][0] = True
    f["poses"][:n_poses] = gt + r.normal(0, 0.05, (n_poses, 3))
    f["poses"][0] = gt[0]
    for i in range(1, n_poses):
        f["odom_meas"][i] = se2.relative(gt[i - 1], gt[i]) + r.normal(
            0, 0.01, 3)
        a = r.normal(0, 1, (3, 3))
        f["odom_info"][i] = a @ a.T + np.eye(3) * 50.0
        f["odom_valid"][i] = True
    f["lms"][:n_lms] = gt_lms + r.normal(0, 0.03, (n_lms, 2))
    f["lm_valid"][:n_lms] = True
    k = 0
    for i in range(n_poses):
        inv = se2.inverse(gt[i])
        for j in r.choice(n_lms, size=min(3, n_lms), replace=False):
            if k >= E:
                break
            z = transform_line(gt_lms[j], inv[:2], inv[2])
            f["obs_pose"][k], f["obs_lm"][k] = i, j
            f["obs_meas"][k] = z + r.normal(0, 0.005, 2)
            a = r.normal(0, 1, (2, 2))
            f["obs_info"][k] = a @ a.T + np.eye(2) * 300.0
            f["obs_valid"][k] = True
            k += 1
    return f


# the frontend's three most common padded (P, L, E) on office, with
# the window's live poses and landmarks
SHAPES = {
    "16x16x16": (16, 16, 16, 5, 6),
    "32x16x64": (32, 16, 64, 20, 12),
    "256x64x512": (256, 64, 512, 150, 50),
}


def card_window(shape, seed):
    return lm_graph_from_numpy(window(*SHAPES[shape], seed), "cuda")


def eager(g, rtol=1e-7):
    """The eager loop on the card, and its recorder."""
    rec = Recorder()
    out = solvers._lm_solve(g, 15, 1e-5, rtol, g.poses.shape[0] >= 128,
                            rec, None)
    return out, rec


def assert_same(a, b):
    (ga, chi2a, dofa), (gb, chi2b, dofb) = a, b
    assert torch.equal(ga.poses, gb.poses)
    assert torch.equal(ga.lms, gb.lms)
    assert torch.equal(chi2a, chi2b) and torch.equal(dofa, dofb)


def stops(rec):
    return {k: rec.counts[k] for k in STOPS}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(SHAPES))
def test_replayed_solves_equal_eager_on_card(shape):
    need_card()
    solvers._LM_GRAPHS.clear()
    # solve k of the shape: a window of its own, so each replay reads
    # the inputs it was given; the last one not laid out as interop
    # packs it (one copy per field)
    gs = [card_window(shape, seed) for seed in (11, 12, 13, 14)]
    gs[3] = gs[3]._replace(poses=gs[3].poses.clone())
    for k, g in enumerate(gs):
        want, want_rec = eager(g)
        rec = Recorder()
        got = solvers.optimize_landmark_graph(g, 15, rec=rec)
        assert_same(got, want)
        assert stops(rec) == stops(want_rec)
        c = rec.counts
        n = c["lm.iterations"]
        assert n == want_rec.counts["lm.iterations"] > 0
        assert c["lm.graph.fallback"] == 0
        if k == 0:
            assert c["lm.graph.captures"] == c["lm.graph.replays"] == 0
            assert c["lm.graph.eager"] == n
        else:
            assert c["lm.graph.captures"] == (2 if k == 1 else 0)
            assert c["lm.graph.replays"] == n and c["lm.graph.eager"] == 0
        # no caller holds a static tensor of the graphs
        entry = next(iter(solvers._LM_GRAPHS.values()))
        if k > 0:
            static = {t.data_ptr() for t in (entry.g.poses, entry.g.lms,
                                             entry.chi2, entry.dof)}
            assert not static & {t.data_ptr() for t in
                                 (got[0].poses, got[0].lms, got[1], got[2])}


@pytest.mark.gpu
def test_fixed_trips_replay_on_card():
    """rtol 0: 15 replays, no host read of the flags."""
    need_card()
    solvers._LM_GRAPHS.clear()
    g = card_window("32x16x64", 21)
    want, _ = eager(g, rtol=0.0)
    for k in range(3):
        rec = Recorder()
        got = solvers.optimize_landmark_graph(g, 15, rtol=0.0, rec=rec)
        assert_same(got, want)
        assert rec.counts["lm.iterations"] == 15
        assert rec.counts["lm.graph.replays"] == (0 if k == 0 else 15)


@pytest.mark.gpu
def test_new_shape_gets_its_own_graphs():
    need_card()
    solvers._LM_GRAPHS.clear()
    rec = Recorder()
    a, b = card_window("16x16x16", 31), card_window("32x16x64", 32)
    for g in (a, a, b, b, a):
        solvers.optimize_landmark_graph(g, 15, rec=rec)
    graphs = [v for v in solvers._LM_GRAPHS.values()
              if isinstance(v, solvers._LMGraphs)]
    assert len(graphs) == 2 and graphs[0] is not graphs[1]
    assert graphs[0].groups[0][0].data_ptr() != (
        graphs[1].groups[0][0].data_ptr())
    assert rec.counts["lm.graph.captures"] == 4
    assert rec.counts["lm.graph.fallback"] == 0
    assert_same(solvers.optimize_landmark_graph(a, 15), eager(a)[0])


@pytest.mark.gpu
def test_capture_beside_another_threads_stream():
    """The realtime layout: the backend thread enqueues work on its own
    stream, and reads it back, while the frontend captures."""
    need_card()
    solvers._LM_GRAPHS.clear()
    g = card_window("256x64x512", 41)
    want, _ = eager(g)
    go, stop, errors, reads = (threading.Event(), threading.Event(), [],
                               [])

    def backend():
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                a = torch.rand(256, 256, dtype=torch.float64, device="cuda")
                go.set()
                while not stop.is_set():
                    b = a @ a.T + torch.linalg.cholesky_ex(a @ a.T)[0]
                    reads.append(float(b.sum()))
        except Exception as e:  # surfaced below
            errors.append(e)
            go.set()

    th = threading.Thread(target=backend)
    th.start()
    try:
        go.wait()
        rec = Recorder()
        outs = [solvers.optimize_landmark_graph(g, 15, rec=rec)
                for _ in range(3)]
    finally:
        stop.set()
        th.join()
    assert errors == [] and len(reads) > 0
    assert rec.counts["lm.graph.captures"] == 2
    assert rec.counts["lm.graph.fallback"] == 0
    for out in outs:
        assert_same(out, want)


@pytest.mark.gpu
def test_failed_capture_stays_eager(monkeypatch):
    """A shape whose capture raises (here: a host read in the set-up,
    which no stream capture allows) is solved eagerly, counted once
    under lm.graph.fallback and never captured again."""
    need_card()
    solvers._LM_GRAPHS.clear()
    g = card_window("32x16x64", 61)
    want, _ = eager(g)
    inner = solvers._lm_prologue

    def reading(*a, **k):
        out = inner(*a, **k)
        out[0].item()
        return out
    monkeypatch.setattr(solvers, "_lm_prologue", reading)
    rec = Recorder()
    for k in range(3):
        assert_same(solvers.optimize_landmark_graph(g, 15, rec=rec), want)
    c = rec.counts
    assert c["lm.graph.fallback"] == 1
    assert c["lm.graph.captures"] == c["lm.graph.replays"] == 0
    assert c["lm.graph.eager"] == c["lm.iterations"]
    assert list(solvers._LM_GRAPHS.values()) == [solvers._EAGER]
