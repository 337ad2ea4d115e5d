"""The comparison catches a broken timed path: the rest of a run driven
on the CPU (the harness's look for a card skipped), with the program
broken underneath, reads `correct` false; the sound run reads true.

The faults a cell of this benchmark can have: a step that returns its
state unchanged (the frontend LM hands back its initial graph), half of
the batch left out (every insertion drops half of its scans), an answer
altered where it is produced (every refinement's pose moved by 1 mm).
A cell runs on one card, so no exchange between cards can be left out.

A window holds whole sessions. The first two faults show within one lap
of the tour (the `one_lap` fixture), the third only where a refined
pose is kept, which in this log comes with the closures of lap 2: its
run replays the whole log (minutes on the CPU).
"""
import json

import pytest
import torch

from gslam_bench import run
from sparse_gslam_tpu_torch.ops import grid, matching, solvers


def _run(capsys):
    torch.set_num_threads(2)
    assert run.main(["--workload", "beams11.office", "--seed", "123456789",
                     "--seconds", "1", "--trace", "0"],
                    device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _lm_unchanged(calls):
    def lm(g, *a, **k):
        calls.append(1)
        chi2, dof = solvers.lm_graph_chi2(g)
        return g, chi2, dof
    return "optimize_landmark_graph", solvers, lm


def _half_batch(calls):
    inner = grid.insert_rays

    def insert(probs, origin, scan_origins, scan_points, scan_kind, *rest):
        calls.append(1)
        kind = scan_kind.clone()
        kind[: kind.shape[0] // 2] = 0  # those scans marked empty
        return inner(probs, origin, scan_origins, scan_points, kind, *rest)
    return "insert_rays", grid, insert


def _answer_altered(calls):
    inner = matching._refine

    def refine(*a, **k):
        calls.append(1)
        out = inner(*a, **k)
        pose = out[0] if isinstance(out, tuple) else out
        pose = pose + torch.tensor([1e-3, 0.0, 0.0], dtype=pose.dtype)
        return (pose, *out[1:]) if isinstance(out, tuple) else pose
    return "_refine", matching, refine


def test_sound_run_is_correct(capsys, one_lap):
    line = _run(capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert all(v["value"] == 0.0 for v in line["checks"].values())


@pytest.mark.parametrize("fault,laps", [(_lm_unchanged, "one"),
                                        (_half_batch, "one"),
                                        (_answer_altered, "all")],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_fault_is_caught(capsys, monkeypatch, request, fault, laps):
    if laps == "one":
        request.getfixturevalue("one_lap")
    calls = []
    name, module, fn = fault(calls)
    monkeypatch.setattr(module, name, fn)
    line = _run(capsys)
    assert calls, "the fault was never on the timed path"
    assert line["correct"] is False
    assert line["failed"] > 0
    over = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert over, line["checks"]
