"""Write a copy of a dataset whose odometry carries a tiny seeded jitter.

    python scripts/jitter_world.py WORLD OUT_DIR [--seed 1] [--sigma 1e-6]

Copies datasets/WORLD to OUT_DIR/WORLD and adds Gaussian noise of
standard deviation SIGMA (m for x and y, rad for theta) to the odometry
fields of every FLASER line of WORLD.log (printed to 9 decimals; the
committed logs print 6). Ranges, ground truth and relations are kept.
Running the JAX package on several such copies shows how far its own
decisions and ATE move under a perturbation of the size of float32
rounding: the spread that a bit-inexact port of it is measured against.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jitter_log(src: str, dst: str, rng, sigma: float) -> int:
    """Write src's FLASER lines to dst with the odometry jittered;
    returns the number of lines changed."""
    n_lines = 0
    with open(src) as fin, open(dst, "w") as fout:
        for line in fin:
            parts = line.split()
            if parts and parts[0] == "FLASER":
                n = int(parts[1])
                noise = rng.normal(0.0, sigma, 3)
                # x y theta, then odom_x odom_y odom_theta (the parser's)
                for k in range(3):
                    for off in (2 + n, 2 + n + 3):
                        parts[off + k] = f"{float(parts[off + k]) + noise[k]:.9f}"
                line = " ".join(parts) + "\n"
                n_lines += 1
            fout.write(line)
    return n_lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("world")
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sigma", type=float, default=1e-6)
    args = ap.parse_args()
    dst = os.path.join(args.out_dir, args.world)
    shutil.copytree(os.path.join(ROOT, "datasets", args.world), dst)
    log = os.path.join(dst, f"{args.world}.log")
    tmp = log + ".tmp"
    n = jitter_log(log, tmp, np.random.default_rng(args.seed), args.sigma)
    os.replace(tmp, log)
    print(f"{dst}: {n} FLASER lines jittered (sigma {args.sigma}, "
          f"seed {args.seed})")


if __name__ == "__main__":
    main()
