"""The plain reference held to the JAX package's recorded CPU runs.

The reference (reference/) is a frozen copy of the port's CPU path, so
the comparison in each run (compare.py) shows that the card computes
what that CPU path computes, and that a later change to the program
still does: a check of the card against the CPU. What the CPU path
computes is held here to an implementation that shares no code with
it: the JAX package, whose CPU runs of the committed stand-in logs
(the generator's seeds 2, 5 and 9) were recorded with the match
decisions printed (SLAM_LOG_MATCHES=1) and the trajectory written
(.result). reference/jax_runs/<world>/ keeps each run's slam.yaml,
line_extractor.yaml, jax.decisions and jax.result; WORLDS names the
traffic and seed that make its log.

    python3 -m gslam_bench.witness [WORLD ...]

replays each world's log through the reference, on the CPU, to its
final cleanup and prints one JSON line per world: the first decision
line that differs (None where none does), the largest pose gap of the
trajectory and whether the world is held. Exits with 1 where one is
not. No card is needed.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = os.path.join(HERE, "reference", "jax_runs")

# world -> the traffic mix and seed that write its committed log, and
# the decision lines (1-based) whose printed field the port's CPU run
# prints one unit of its last digit away from the JAX run's
WORLDS = {
    "sim-office": {"traffic": "office", "seed": 2},
    "sim-office-beams60": {"traffic": "office", "seed": 2},
    "sim-loops": {"traffic": "loops", "seed": 5,
                  "printed_fields": {55: "score", 137: "sigma_along"}},
    "sim-corridor": {"traffic": "corridor", "seed": 9},
}
# a MISS line's best score, compared within this (the JAX runs print it
# with all its digits; FFT sums in another order move its last ones)
MISS_SCORE_ATOL = 1e-5
# the trajectory's largest |dx|, |dy| (m) or |dtheta| (rad) against the
# JAX run's .result (printed to 6 decimals): read 0 (office, corridor),
# 1e-6 (loops) and 3.4e-5 (office at 60 beams)
RESULT_ATOL = 1e-4
DECISION_PREFIXES = ("[match]", "[chain]", "[kfpin]", "[rematch]")


def first_decision_difference(got, ref, printed=None):
    """Index and pair of the first decision line that differs, or None.
    A MISS line's best score is compared within MISS_SCORE_ATOL; a
    printed zero's sign is no difference; `printed` maps a 1-based line
    number to a field whose number may be one unit of its last printed
    digit apart there."""
    num = re.compile(r"best=([0-9.eE+-]+)")
    zero = re.compile(r"-(0\.0+)(?![0-9])")
    for k in range(max(len(got), len(ref))):
        a = zero.sub(r"+\1", got[k]) if k < len(got) else "<missing>"
        b = zero.sub(r"+\1", ref[k]) if k < len(ref) else "<missing>"
        field = (printed or {}).get(k + 1)
        if field is not None:
            pat = re.compile(rf"\b{field}=([0-9]+\.([0-9]+))")
            fa, fb = pat.search(a), pat.search(b)
            if fa and fb and len(fa.group(2)) == len(fb.group(2)) and abs(
                    float(fa.group(1)) - float(fb.group(1))
            ) <= 1.5 * 10.0 ** -len(fb.group(2)):
                a, b = pat.sub(f"{field}=*", a), pat.sub(f"{field}=*", b)
        ma, mb = num.search(a), num.search(b)
        if ma and mb and num.sub("", a) == num.sub("", b):
            if abs(float(ma.group(1)) - float(mb.group(1))) <= MISS_SCORE_ATOL:
                continue
        elif a == b:
            continue
        return {"index": k, "got": a, "reference": b}
    return None


def trajectory_lines(system) -> list:
    """The session's .result lines (the port's SlamSystem.write_result
    and io/result_writer.write_trajectory, log_runner.cpp:258-268): each
    keyframe's pose-graph estimate up to the last optimised one, the
    landmark graph's dead reckoning after it, expanded over the
    keyframe's odometry."""
    from .reference.utils import se2

    lm_est = system.frontend.estimates()
    odom = [(k.odom_times, k.odom_dposes) for k in system.frontend.keyframes]
    be = system.backend
    if be is not None and be.pose_count > 0:
        pg = be.pose_estimates()
        last_opt = be.last_opt_pose_index
        est = np.concatenate([pg, lm_est[len(pg):]])
    else:
        est, last_opt = lm_est, len(lm_est)
    lines = []

    def line(pose, t):
        x, y, th = (float(v) for v in pose[:3])
        lines.append(f"FLASER 0 {x:.6f} {y:.6f} {th:.6f} {x:.6f} {y:.6f} "
                     f"{th:.6f} {t:.6f} myhost {t:.6f}")

    def expand(base, times, dposes):
        line(base, times[0])
        for t, dp in zip(times[1:], dposes[1:]):
            line(se2.compose(base, dp), t)

    n = len(odom)
    for i in range(min(last_opt, n)):
        expand(est[i], *odom[i])
    if last_opt < n:
        base = np.array(est[max(last_opt - 1, 0)])
        for i in range(last_opt, n):
            base = se2.compose(base, se2.relative(lm_est[max(i - 1, 0)],
                                                  lm_est[i]))
            expand(base, *odom[i])
    return lines


def parse_result(lines) -> tuple:
    """(times, poses) of .result lines."""
    rows = [ln.split() for ln in lines if ln.startswith("FLASER")]
    times = np.array([float(r[8]) for r in rows])
    poses = np.array([[float(v) for v in r[2:5]] for r in rows])
    return times, poses


def hold(world: str) -> dict:
    """Replay `world`'s log through the reference and hold it to the JAX
    run."""
    from .generator import load_json, make_traffic, write_carmen_log
    from .reference.io.providers import carmen_frames
    from .reference.models.slam import SlamSystem
    from .reference.utils.config import load_dataset_config

    spec = WORLDS[world]
    src = os.path.join(RUNS, world)
    work = tempfile.mkdtemp(prefix="gslam_witness_")
    old = os.environ.get("SLAM_LOG_MATCHES")
    os.environ["SLAM_LOG_MATCHES"] = "1"
    printed = io.StringIO()
    try:
        for name in ("slam.yaml", "line_extractor.yaml"):
            shutil.copy(os.path.join(src, name), work)
        log = os.path.join(work, world + ".log")
        write_carmen_log(log, make_traffic(load_json("traffic",
                                                     spec["traffic"]),
                                           spec["seed"]))
        cfg, ls = load_dataset_config(work)
        system = SlamSystem(cfg, ls, enable_backend=True, device="cpu")
        with contextlib.redirect_stdout(printed):
            for frame in carmen_frames(log):
                system.process_frame(frame)
            system.final_cleanup()
    finally:
        if old is None:
            os.environ.pop("SLAM_LOG_MATCHES", None)
        else:
            os.environ["SLAM_LOG_MATCHES"] = old
        shutil.rmtree(work, ignore_errors=True)
    got = [ln for ln in printed.getvalue().splitlines()
           if ln.startswith(DECISION_PREFIXES)]
    with open(os.path.join(src, "jax.decisions")) as f:
        want = f.read().splitlines()
    diff = first_decision_difference(got, want, spec.get("printed_fields"))
    times, poses = parse_result(trajectory_lines(system))
    with open(os.path.join(src, "jax.result")) as f:
        ref_times, ref_poses = parse_result(f.read().splitlines())
    same_times = bool(np.array_equal(times, ref_times))
    gap = float("inf")
    if same_times:
        d = poses - ref_poses
        d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
        gap = float(np.abs(d).max())
    return {"world": world, "decision_lines": len(got),
            "jax_decision_lines": len(want),
            "first_decision_difference": diff,
            "result_times_equal": same_times, "result_max_abs_err": gap,
            "result_atol": RESULT_ATOL,
            "held": diff is None and gap <= RESULT_ATOL}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("worlds", nargs="*", default=list(WORLDS))
    args = ap.parse_args(argv)
    ok = True
    for world in args.worlds:
        r = hold(world)
        print(json.dumps(r), flush=True)
        ok = ok and r["held"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
