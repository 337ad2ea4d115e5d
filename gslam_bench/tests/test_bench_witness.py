"""The plain reference computes what the JAX package's CPU runs of the
committed stand-in logs recorded: every match decision it prints and the
trajectory of the whole session and its final cleanup (witness.py). A
whole session each, on the CPU: minutes per world."""
import pytest
import torch

from gslam_bench import witness


@pytest.mark.parametrize("world", sorted(witness.WORLDS))
def test_reference_holds_the_jax_run(world):
    torch.set_num_threads(2)
    r = witness.hold(world)
    assert r["first_decision_difference"] is None, r
    assert r["decision_lines"] == r["jax_decision_lines"] > 0, r
    assert r["result_times_equal"], r
    assert r["result_max_abs_err"] <= witness.RESULT_ATOL, r
    assert r["held"]


def test_a_changed_decision_is_found():
    ref = ["[match] mid=68 cands=3 MISS best=0.4829123616218567 (submap "
           "anchor=5)", "[chain] kf5->kf10 hop=1 n=102 overlap=0.46"]
    assert witness.first_decision_difference(ref, ref) is None
    near = [ref[0].replace("0.4829123616218567", "0.482912"), ref[1]]
    assert witness.first_decision_difference(near, ref) is None
    moved = [ref[0], ref[1].replace("n=102", "n=103")]
    assert witness.first_decision_difference(moved, ref)["index"] == 1
    assert witness.first_decision_difference(ref[:1], ref)["index"] == 1
