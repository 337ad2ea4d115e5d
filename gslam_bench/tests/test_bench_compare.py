"""The comparison's numbers on synthetic session records."""
import numpy as np

from gslam_bench import compare


def _snap(n_kf=5, n_grids=2, shift=0.0):
    kf = np.arange(n_kf * 3, dtype=np.float64).reshape(n_kf, 3) * 0.1
    kf[:, 0] += shift
    grids = [(np.zeros((4, 4), np.float32), np.zeros((8, 8), np.float32))
             for _ in range(n_grids)]
    return {"frames": 10, "kf": kf, "pg": kf[:3].copy(),
            "closures": {("loop", 0, 4, True): np.array([1.0, 2.0, 0.1])},
            "grids": grids}


def test_equal_sides_read_zero():
    assert all(v == 0.0 for v in compare.compare(_snap(), _snap()).values())


def test_each_number():
    a, b = _snap(), _snap(shift=2e-3)
    b["pg"][1, 2] += 2 * np.pi + 5e-4  # wrapped: 5e-4 rad
    b["closures"][("loop", 0, 4, True)] = np.array([1.0, 2.0 + 3e-3, 0.1])
    b["closures"][("kf", 1, 3, True)] = np.zeros(3)
    b["grids"][0][1][0, 0] = 0.5
    r = compare.compare(a, b)
    assert r["closures"] == 1.0
    assert np.isclose(r["lm_pose_gap"], 2e-3)
    assert np.isclose(r["pg_pose_gap"], 2e-3)
    assert np.isclose(r["refine_gap"], 3e-3)
    assert np.isclose(r["grid_cells"], 1 / (2 * (16 + 64)))
    limits = {"closures": 0.0, "lm_pose_gap": 1e-6, "pg_pose_gap": 1e-5,
              "refine_gap": 1e-5, "grid_cells": 1e-5}
    assert not compare.judge(r, limits)
    assert compare.worst([r, compare.compare(a, a)]) == r


def test_missing_poses_and_submaps():
    r = compare.compare(_snap(n_kf=5, n_grids=2), _snap(n_kf=4, n_grids=3))
    assert r["lm_pose_gap"] == compare.MISSING_POSE
    assert np.isclose(r["grid_cells"], 80 / (3 * 80))
