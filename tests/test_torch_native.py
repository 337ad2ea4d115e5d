"""The port's native C++ layer (sparse_gslam_tpu_torch/io/native.py,
csrc/carmen_parser.cpp and csrc/correlative_matcher.cpp, its own copies
of the JAX package's sources) against the JAX package's bindings, and
the CARMEN provider's native default.

- parse_carmen_native on every sim world's log: its arrays equal the
  JAX package's (np.array_equal), and the provider's frames equal the
  JAX provider's and the port's Python parser's; on a log with equal
  timestamps the C++ stable sort and Python's stable list.sort give the
  same order;
- a parser that cannot be built, or a log it cannot read, raises and
  names use_native=False (no fallback);
- correlative_match_native and correlative_match_many_native: equal
  tuples with the JAX bindings (the same C++ source); numpy and torch
  inputs alike;
- match_submap's optimum equals the branch-and-bound optimum on
  identical inputs, as tests/test_native_matcher.py holds the JAX pair:
  score within 2e-3, translation within 2 cells, rotation within 2.5
  steps (ties may fall on neighbouring near-equal candidates).
"""
import glob
import os

import numpy as np
import pytest
import torch

from sparse_gslam_tpu.io import native as jn
from sparse_gslam_tpu.io.providers import create_data_provider as j_create
from sparse_gslam_tpu_torch.io import native as tn
from sparse_gslam_tpu_torch.io import providers as tprov
from sparse_gslam_tpu_torch.ops import matching as tm
from sparse_gslam_tpu_torch.ops.grid import precompute_pyramid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = sorted(
    p for p in glob.glob(os.path.join(ROOT, "datasets", "sim-*", "*.log"))
    if os.path.basename(p) == os.path.basename(os.path.dirname(p)) + ".log")


def frames_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.time == y.time
        np.testing.assert_array_equal(x.pose, y.pose)
        np.testing.assert_array_equal(x.ranges, y.ranges)


def test_all_sim_logs_found():
    assert [os.path.basename(p) for p in LOGS] == [
        "sim-corridor.log", "sim-killian.log", "sim-loops.log",
        "sim-office.log"]


@pytest.mark.parametrize("log", LOGS, ids=os.path.basename)
def test_parse_carmen_native_matches_jax(log):
    got = tn.parse_carmen_native(log)
    ref = jn.parse_carmen_native(log)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    native = list(tprov.CarmenLogDataProvider(log).frames())
    python = list(tprov.CarmenLogDataProvider(log, use_native=False).frames())
    frames_equal(native, list(j_create("carmen", log).frames()))
    frames_equal(native, python)
    assert len(native) > 600


def test_equal_timestamps_keep_file_order(tmp_path):
    """Frames with equal times keep their order in the file in both
    parsers (stable sorts), and both equal the JAX provider's."""
    rng = np.random.default_rng(9)
    lines = ["# CARMEN", "PARAM x 1"]
    for k in range(30):
        t = 5.0 + 0.5 * (k % 4)  # many equal times, out of order
        beams = int(rng.integers(3, 9))
        vals = rng.uniform(0.2, 8.0, beams)
        pose = rng.normal(0, 2, 3)
        lines.append(" ".join(
            ["FLASER", str(beams), *(f"{v:.6f}" for v in vals),
             *(f"{v:.6f}" for v in pose), *(f"{v:.6f}" for v in pose),
             f"{t:.6f}", "host", f"{t:.6f}"]))
        if k % 7 == 0:
            lines.append(f"ODOM 0 0 0 0 0 0 {t:.6f} host {t:.6f}")
    path = tmp_path / "ties.log"
    path.write_text("\n".join(lines) + "\n")
    native = list(tprov.CarmenLogDataProvider(str(path)).frames())
    python = list(tprov.CarmenLogDataProvider(str(path),
                                              use_native=False).frames())
    frames_equal(native, python)
    frames_equal(native, list(j_create("carmen", str(path)).frames()))
    times = [f.time for f in native]
    assert times == sorted(times) and len(set(times)) == 4
    # within a time, the file's order (the beams counts tell them apart)
    assert [len(f.ranges) for f in native] != sorted(
        len(f.ranges) for f in native)


def test_native_failure_raises(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="use_native=False"):
        tprov.CarmenLogDataProvider(str(tmp_path / "missing.log"))

    def no_build():
        raise RuntimeError("g++ failed (1)")

    monkeypatch.setattr(tn, "_carmen_lib", no_build)
    log = tmp_path / "one.log"
    log.write_text("FLASER 2 1.0 2.0 0 0 0 0 0 0 1.0 h 1.0\n")
    with pytest.raises(RuntimeError, match="use_native=False"):
        tprov.CarmenLogDataProvider(str(log))
    frames = list(tprov.CarmenLogDataProvider(str(log),
                                              use_native=False).frames())
    assert len(frames) == 1 and frames[0].time == 1.0


def make_case(seed=0, size=128, n_points=80, resolution=0.1):
    """tests/test_native_matcher.py's case: a wall-like occupancy grid
    and a query scan sampled from its occupied cells, displaced by a
    known rigid transform."""
    rng = np.random.default_rng(seed)
    probs = np.zeros((size, size), np.float32)
    probs[30:100, 40] = 0.9
    probs[30, 40:90] = 0.9
    occ = rng.integers(25, size - 25, size=(30, 2))
    probs[occ[:, 0], occ[:, 1]] = 0.8
    probs[probs == 0.0] = 0.15
    origin = np.array([-size * resolution / 2, -size * resolution / 2])
    occ_cells = np.argwhere(probs > 0.7)
    sel = rng.choice(len(occ_cells), size=n_points, replace=True)
    pts_map = origin[None, :] + (occ_cells[sel] + 0.5) * resolution
    th = 0.12
    t = np.array([0.7, -0.4])
    c, s = np.cos(-th), np.sin(-th)
    R = np.array([[c, -s], [s, c]])
    pts_query = (pts_map - t) @ R.T
    return probs, origin, resolution, pts_query, th, t


SPEC = tm.search_spec(1.5, 0.35, 8.0, 0.1)


@pytest.mark.parametrize("seed,min_score,as_torch", [
    (0, 0.2, False), (1, 0.2, True), (4, 0.999, False)])
def test_correlative_match_native_matches_jax(seed, min_score, as_torch):
    probs, origin, res, pts, th, t = make_case(seed)
    args = (res,)
    rest = (0.03, SPEC.angular_step, SPEC.n_angular, SPEC.n_linear, 4,
            min_score)
    ref = jn.correlative_match_native(probs, origin, *args, pts, *rest)
    if as_torch:
        probs, origin, pts = (torch.from_numpy(np.asarray(a))
                              for a in (probs, origin, pts))
    got = tn.correlative_match_native(probs, origin, *args, pts, *rest)
    assert (got is None) == (ref is None) == (min_score > 0.9)
    if ref is not None:
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
        assert np.linalg.norm(got[1][:2] - t) < 2.5 * res
        assert abs(got[1][2] - th) < 2 * SPEC.angular_step


@pytest.mark.parametrize("n_threads,min_score", [(2, 0.2), (1, 0.2),
                                                 (8, 0.999)])
def test_correlative_match_many_native_matches_jax(n_threads, min_score):
    probs, origin, res, pts, th, t = make_case(5)
    decoy = np.full_like(probs, 0.15)
    grids = np.stack([decoy, probs, probs[::-1].copy()])
    origins = np.stack([origin, origin, origin + 0.3])
    args = (res, pts, [0.0, 0.0, 0.1], SPEC.angular_step, SPEC.n_angular,
            SPEC.n_linear, 4, min_score)
    ref = jn.correlative_match_many_native(grids, origins, *args,
                                           n_threads=n_threads)
    got = tn.correlative_match_many_native(grids, origins, *args,
                                           n_threads=n_threads)
    if min_score > 0.9:
        assert got is None and ref is None
        return
    assert got[0] == ref[0] == 1
    assert got[1] == ref[1]
    np.testing.assert_array_equal(got[2], ref[2])
    assert np.linalg.norm(got[2][:2] - t) < 2.5 * res


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_submap_optimum_equals_native(seed):
    probs, origin, res, pts, th, t = make_case(seed)
    depth = 4
    pyr = precompute_pyramid(torch.from_numpy(probs), depth)
    score_f, pose_f, _ = tm.match_submap(
        pyr[0], torch.tensor(origin, dtype=torch.float32), res,
        pts.astype(np.float32), 0.0, SPEC)
    got = tn.correlative_match_native(
        probs, origin, res, pts, 0.0, SPEC.angular_step, SPEC.n_angular,
        SPEC.n_linear, depth, min_score=0.2)
    assert got is not None
    score_n, pose_n = got
    assert abs(score_n - score_f) < 2e-3, (score_n, score_f)
    assert np.allclose(pose_n[:2], pose_f[:2], atol=2 * res + 1e-6)
    assert abs(pose_n[2] - pose_f[2]) < 2.5 * SPEC.angular_step
