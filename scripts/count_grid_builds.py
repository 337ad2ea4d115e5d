"""Count the occupancy-grid builds of one run of the JAX package.

    JAX_PLATFORMS=cpu python scripts/count_grid_builds.py \
        --dataset-dir datasets/sim-office --dataset-name sim-office

Runs sparse_gslam_tpu.runner with the backend (and --eval) on a
temporary copy of the dataset, with build_submap_grid wrapped, and
prints one JSON line: the number of submaps, and the grid builds by
calling method (precompute, rebuild_grids) and by (grid edge, scans).
Each build is one ray insertion, so once the PyTorch port has the
backend, one launch of its CUDA insertion kernel. A count, not a time.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sparse_gslam_tpu import runner  # noqa: E402
from sparse_gslam_tpu.models import backend  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--dataset-name", required=True)
    a = ap.parse_args()

    by_caller = collections.Counter()
    by_shape = collections.Counter()
    build = backend.build_submap_grid

    def counted(range_data, spec, *args, **kw):
        by_caller[sys._getframe(1).f_code.co_name] += 1
        by_shape[f"G={spec.size} S={len(range_data.meta)}"] += 1
        return build(range_data, spec, *args, **kw)

    backend.build_submap_grid = counted
    closers = []
    init = backend.SubmapLoopCloser.__init__

    def keep(self, *args, **kw):
        init(self, *args, **kw)
        closers.append(self)

    backend.SubmapLoopCloser.__init__ = keep
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, a.dataset_name)
        shutil.copytree(a.dataset_dir, data)
        runner.main(["--dataset-dir", data, "--dataset-name",
                     a.dataset_name, "--eval"])
    print(json.dumps({
        "dataset": a.dataset_name,
        "submaps": [len(c.submaps) for c in closers],
        "builds": sum(by_caller.values()),
        "by_caller": dict(by_caller),
        "by_shape": dict(sorted(by_shape.items())),
    }))


if __name__ == "__main__":
    main()
