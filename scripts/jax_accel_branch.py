"""Run the JAX package's runner down its accelerator branch on the CPU.

    JAX_PLATFORMS=cpu SLAM_LOG_MATCHES=1 python scripts/jax_accel_branch.py \
        --dataset-dir <copy of datasets/sim-office> --dataset-name sim-office \
        --eval

The JAX package picks its matcher and pin path by jax.default_backend()
(sparse_gslam_tpu/models/backend.py): on "cpu" the pruned matcher and
host numpy pins, on an accelerator the fused one-call matcher
(fused_match, with the rotation count frozen at range_max) and the
device pin batches. This wrapper makes jax.default_backend() answer
"gpu" and then calls sparse_gslam_tpu.runner.main with the command
line, so the accelerator branch runs on the CPU in float64 with no file
of the JAX package changed. The runner writes into the dataset
directory: run it on a copy. It prints the runner's own lines; its
numbers on sim-office are in ROADMAP.md (queue 1, item 3).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402


def main() -> int:
    jax.default_backend = lambda: "gpu"
    from sparse_gslam_tpu import runner

    return runner.main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
