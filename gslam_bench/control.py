"""The control of the comparison that decides `correct`: the reference
put in the program's place in the nearest precision below the one the
configuration states (the landmark, pose and joint graphs solved in
float32 instead of float64), held against the reference in float64 by
the same comparison (compare.py). Its numbers have to fail a cell's
limits; the benchmark's own runs never run it.

    python3 -m gslam_bench.control --workload <cell> --seeds 1 2 3 \\
        [--frames N]

For each seed it prints one JSON line with the numbers, after N frames
(the frames a run's window reaches) or, with N = 0, after the whole log
and its final cleanup. CPU only: no card is needed.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np


def control_numbers(workload: str, seed: int, frames: int) -> dict:
    from . import compare, run
    from .generator import make_traffic
    from .reference import interop, replay

    _, cell, config, traffic = run.load_cell(workload)
    work = tempfile.mkdtemp(prefix="gslam_control_")
    try:
        run.write_dataset(work, cell["traffic"], config,
                          make_traffic(traffic, seed))
        stops = [frames] if frames else []
        key = frames if frames else "end"
        out = {}
        for name, dtype in (("reference", np.float64),
                            ("control", np.float32)):
            interop.SOLVE_FLOAT = dtype
            try:
                out[name] = replay(work, cell["traffic"], stops,
                                   cleanup=not frames)[key]
            finally:
                interop.SOLVE_FLOAT = np.float64
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return compare.compare(out["control"], out["reference"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        nums = control_numbers(args.workload, seed, args.frames)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "frames": args.frames, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
