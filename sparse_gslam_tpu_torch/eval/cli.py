"""Metric-evaluation CLI: the metricEvaluator + eval.sh replacement.

`python -m sparse_gslam_tpu_torch.eval.cli <dataset_dir> <name> <tag>` reads
<dir>/<name>.result and <dir>/<name>.relations and writes
<dir>/<name>-<tag>_trans_error.log / _rot_error.log in the format the
reference's table/plot tooling expects (line 2 = "mean, std, ..."; cf.
datasets/gen_acc_table.py:1-2, eval.sh:2-3). Rotational errors are in
degrees like the published tables. Port of sparse_gslam_tpu/eval/cli.py.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from .relations import evaluate_files


def write_error_log(path: str, errors: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("mean, std, min, max, n\n")
        f.write(
            f"{errors.mean():.6f}, {errors.std():.6f}, "
            f"{errors.min():.6f}, {errors.max():.6f}, {len(errors)}\n"
        )
        for e in errors:
            f.write(f"{e:.6f}\n")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    dataset_dir, name = argv[0], argv[1]
    tag = argv[2] if len(argv) > 2 else "run"
    prefix = os.path.join(dataset_dir, name)
    res = evaluate_files(prefix + ".result", prefix + ".relations")
    write_error_log(
        f"{prefix}-{tag}_trans_error.log", res.trans_errors
    )
    write_error_log(
        f"{prefix}-{tag}_rot_error.log", np.degrees(res.rot_errors)
    )
    print(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
