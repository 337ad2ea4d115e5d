"""Run the JAX package's runner with the backend's two mesh hooks set.

    JAX_PLATFORMS=cpu SLAM_LOG_MATCHES=1 python scripts/jax_mesh_run.py \
        --devices 2 --dataset-dir <copy of datasets/sim-office> \
        --dataset-name sim-office --eval

The JAX runner has no flag for SubmapLoopCloser.mesh (every pose-graph
solve through parallel/dist_solver.optimize_pose_graph_sharded) or
SubmapLoopCloser.match_mesh (the candidate search through
ops/matching.match_candidates_sharded); tests/test_pipeline_dist.py sets
them in code. This wrapper asks XLA for --devices virtual CPU devices,
sets both hooks on every SubmapLoopCloser the runner builds to 1-D
meshes over them ("blocks" and "cands"), and calls
sparse_gslam_tpu.runner.main with the rest of the command line, so no
file of the JAX package changes. The runner writes into the dataset
directory: run it on a copy. Its output is the reference of the port's
run with the same hooks (sparse_gslam_tpu_torch/data/sim-office-mesh.*).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str]) -> int:
    n = 2
    if argv[:1] == ["--devices"]:
        n, argv = int(argv[1]), argv[2:]
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count={n}").strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np
    from jax.sharding import Mesh

    jax.config.update("jax_platforms", "cpu")
    from sparse_gslam_tpu import runner
    from sparse_gslam_tpu.models import backend

    devs = np.array(jax.devices("cpu")[:n])
    init = backend.SubmapLoopCloser.__init__

    def with_meshes(self, *a, **k):
        init(self, *a, **k)
        self.mesh = Mesh(devs, ("blocks",))
        self.match_mesh = Mesh(devs, ("cands",))

    backend.SubmapLoopCloser.__init__ = with_meshes
    return runner.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
