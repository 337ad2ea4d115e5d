"""The port's blocked pose-graph solver against the C++ and dense
solvers on one make_chain_graph graph, on the CPU (or --device cuda).

    python scripts/blocked_solver_cpu.py --poses 2000 --pad 2048 \
        --closures 64 --drift 0.02 --iterations 20 [--dense] \
        [--by-iteration 1,3,8,40] [--profile]

Prints one JSON line per measurement: the partition's separator slots
S (in use, capacity) and local slots K; seconds per solve of the
blocked, C++ (host, float64) and, with --dense, dense solvers; the
largest pose differences between them (m/rad, valid poses) and the
ATE mean against the ground truth. --by-iteration repeats the
blocked/C++ comparison at each listed iteration count (how far apart
two exact Gauss-Newton iterates are in flight); --profile counts the
aten calls of one blocked GN iteration with torch.profiler.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sparse_gslam_tpu_torch.eval.synthetic_graphs import (  # noqa: E402
    make_chain_graph,
    to_pose_graph,
)
from sparse_gslam_tpu_torch.io.native import posegraph_gn_native  # noqa: E402
from sparse_gslam_tpu_torch.ops import solvers  # noqa: E402
from sparse_gslam_tpu_torch.parallel import dist_solver  # noqa: E402


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--poses", type=int, default=2000)
    ap.add_argument("--pad", type=int, default=2048)
    ap.add_argument("--closures", type=int, default=64)
    ap.add_argument("--drift", type=float, default=0.02)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--by-iteration", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    n = args.poses
    fields, gt = make_chain_graph(n_poses=n, n_closures=args.closures,
                                  pad_to=args.pad, drift=args.drift)
    g = to_pose_graph(fields, args.device)
    plan = dist_solver.partition_of(g, args.pad // args.block_size)
    bg, sg = dist_solver.split_graph(g, plan)

    def ate(p):
        return float(np.sqrt(((p[:n, :2] - gt[:n, :2]) ** 2).sum(1)).mean())

    def blocked(iterations):
        return dist_solver.optimize_pose_graph_blocked(
            bg, sg, 1.0, iterations).reshape(-1, 3)

    posegraph_gn_native(g, 1.0, 1)  # builds and loads the library
    b, b_s = timed(lambda: blocked(args.iterations))
    b = b.cpu().numpy()
    nat, nat_s = timed(lambda: posegraph_gn_native(g, 1.0, args.iterations))
    row = {
        "N": args.pad, "poses": n, "closures": args.closures,
        "drift": args.drift, "iterations": args.iterations,
        "blocks": plan.n_blocks, "S": int(plan.sep_valid.sum()),
        "S_capacity": len(plan.sep_pose), "K": int(plan.loc_sep.shape[1]),
        "device": args.device, "blocked_s": b_s, "native_s": nat_s,
        "max_abs_blocked_native": float(np.abs(b[:n] - nat[:n]).max()),
        "ate_blocked": ate(b), "ate_native": ate(nat),
    }
    if args.dense:
        d, d_s = timed(lambda: solvers.optimize_pose_graph(
            g, 1.0, args.iterations).poses)
        d = d.cpu().numpy()
        row.update(dense_s=d_s, ate_dense=ate(d),
                   max_abs_blocked_dense=float(np.abs(b[:n] - d[:n]).max()))
    print(json.dumps(row), flush=True)

    for it in [int(x) for x in args.by_iteration.split(",") if x]:
        b = blocked(it).cpu().numpy()
        nat = posegraph_gn_native(g, 1.0, it)
        print(json.dumps({
            "iterations": it,
            "max_abs_blocked_native": float(np.abs(b[:n] - nat[:n]).max()),
            "ate_blocked": ate(b), "ate_native": ate(nat),
        }), flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        blocked(1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            blocked(1)
        ev = prof.key_averages()
        aten = [e for e in ev if e.key.startswith("aten::")]
        top = sorted(aten, key=lambda e: -e.count)[:12]
        print(json.dumps({
            "aten_calls_per_iteration": sum(e.count for e in aten),
            "top": {e.key: e.count for e in top},
        }), flush=True)


if __name__ == "__main__":
    main()
