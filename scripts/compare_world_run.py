"""Hold one full run's output against the JAX package's CPU reference.

    python scripts/compare_world_run.py WORLD LOG RESULT

WORLD is one of chip_smoke.py's WORLDS: sim-office, sim-killian,
sim-loops, sim-corridor, or a copy of sim-office with one line added to
its slam.yaml: sim-office-refine1 (final_refine_rounds: 1),
sim-office-beams60 (scan_size: 60, multicloud_size: 960),
sim-office-joint (final_joint: true), sim-office-marginal
(chain_info_mode: marginal), sim-office-smf (algorithm: smf) or
sim-office-hough (algorithm: hough), sim-office-beams4, -beams6 and
-beams8 (scan_size 4/6/8, multicloud_size 16 times that: the beam
sweep's points, against scripts/jax_beam_runs.py's runs),
sim-office-accel, sim-office-beams60-accel and sim-office-beams4-accel
(sim-office and its 60- and 4-beam copies run with the runner's
--accel-branch, against scripts/jax_accel_branch.py's runs), and
sim-office-mesh (sim-office with the backend's mesh and match_mesh set to
2-shard meshes, against scripts/jax_mesh_run.py's run).
LOG is the run's standard output under SLAM_LOG_MATCHES=1 (python -m
sparse_gslam_tpu_torch.runner --dataset-dir <copy of the dataset>
--dataset-name <dataset> --eval ...); RESULT is the .result it wrote. Prints chip_smoke.compare_run's
readings as one JSON line (the decision lines counted, not listed).
Needs no GPU.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> None:
    world, log, result = sys.argv[1:4]
    with open(log) as fh:
        cmp = chip_smoke.compare_run(world, fh.read(), result)
    cmp["decision_lines"] = len(cmp.pop("decisions"))
    cmp["reference_decision_lines"] = len(cmp.pop("reference_decisions"))
    print(json.dumps(cmp))


if __name__ == "__main__":
    main()
