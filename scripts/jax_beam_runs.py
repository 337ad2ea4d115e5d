"""The JAX package's CPU-branch runs of a world at other beam counts.

    JAX_PLATFORMS=cpu python scripts/jax_beam_runs.py OUT \
        [--world sim-office] [--beams 4 6 8]

For each beam count B it copies datasets/<world> to OUT/<world>-beamsB,
sets scan_size: B and multicloud_size: 16 B in the copy's slam.yaml
(scripts/sweep.py's window of 16 scans), and runs the JAX runner
(python -m sparse_gslam_tpu.runner --dataset-dir <copy> --dataset-name
<world> --eval) under SLAM_LOG_MATCHES=1, one process per count, all at
once. Each run's standard output goes to OUT/<world>-beamsB.log, its
[match]/[chain]/[kfpin]/[rematch] lines to OUT/<world>-beamsB.decisions
and its .result to OUT/<world>-beamsB.result: the port's references
sparse_gslam_tpu_torch/data/<world>-beamsB.{decisions,result}. The
dataset directories under datasets/ are not written.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECISION = ("[match]", "[chain]", "[kfpin]", "[rematch]")


def set_yaml(path: str, values: dict) -> None:
    with open(path) as fh:
        text = fh.read()
    for key, value in values.items():
        pat = re.compile(rf"^{key}:.*$", re.M)
        if pat.search(text):
            text = pat.sub(f"{key}: {value}", text)
        else:
            text += f"\n{key}: {value}\n"
    with open(path, "w") as fh:
        fh.write(text)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--world", default="sim-office")
    ap.add_argument("--beams", type=int, nargs="+", default=[4, 6, 8])
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", SLAM_LOG_MATCHES="1",
               PYTHONPATH=REPO)
    procs = []
    for b in args.beams:
        stem = os.path.join(args.out, f"{args.world}-beams{b}")
        d = stem + ".dataset"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(REPO, "datasets", args.world), d)
        set_yaml(os.path.join(d, "slam.yaml"),
                 {"scan_size": b, "multicloud_size": 16 * b})
        log = open(stem + ".log", "w")
        procs.append((b, stem, d, log, subprocess.Popen(
            [sys.executable, "-m", "sparse_gslam_tpu.runner",
             "--dataset-dir", d, "--dataset-name", args.world, "--eval"],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO)))
    rc = 0
    for b, stem, d, log, p in procs:
        rc |= p.wait()
        log.close()
        with open(stem + ".log") as fh:
            lines = [ln for ln in fh.read().splitlines()
                     if ln.startswith(DECISION)]
        with open(stem + ".decisions", "w") as fh:
            fh.write("".join(ln + "\n" for ln in lines))
        shutil.copyfile(os.path.join(d, f"{args.world}.result"),
                        stem + ".result")
        print(f"beams={b}: rc {p.returncode}, {len(lines)} decision lines "
              f"-> {stem}.{{log,decisions,result}}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
