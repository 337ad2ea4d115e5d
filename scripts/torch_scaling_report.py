"""Scaling report of the port's sharded pose-graph solver.

    python scripts/torch_scaling_report.py [--poses 16384] [--closures 256]
        [--shards 1 2 4 8] [--device cpu] [--link-gbs G --link-us L
        --host-gbs G --host-us L]

Measures GN iterations per second of dist_solver.optimize_pose_graph_sharded
at each shard count (multihost.scaling_report, 128 blocks, 20
iterations), with the shards on this process's cards in turn (several on
one card where there are fewer cards than shards) or on the CPU. Shards
that share a device share its time, so this measures the sharded
program's overhead, not a speed-up. Then it calibrates the collective-
traffic model (multihost.model_efficiency) on this device: the time of
one GN iteration with one shard, and of the replicated separator
Cholesky alone at this graph's separator count. The model's link rates
are arguments (GB/s and microseconds per step, within and between
hosts); without them only the measured table is printed. One JSON line
at the end. The port's counterpart of scripts/scaling_report.py.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=16384)
    ap.add_argument("--closures", type=int, default=256)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--device", default="")
    ap.add_argument("--link-gbs", type=float, default=0.0)
    ap.add_argument("--link-us", type=float, default=0.0)
    ap.add_argument("--host-gbs", type=float, default=0.0)
    ap.add_argument("--host-us", type=float, default=0.0)
    args = ap.parse_args()

    import numpy as np
    import torch

    from sparse_gslam_tpu_torch.eval.synthetic_graphs import (
        make_chain_graph,
        to_pose_graph,
    )
    from sparse_gslam_tpu_torch.parallel import dist_solver, multihost

    cpu = args.device == "cpu"
    dev = torch.device("cpu" if cpu else "cuda")
    f, _ = make_chain_graph(n_poses=args.poses - 100,
                            n_closures=args.closures, pad_to=args.poses)
    g = to_pose_graph(f, dev)
    rep = multihost.scaling_report(
        g, 1.0, device_counts=args.shards,
        devices=[dev] if cpu else None)
    base = rep.get(1)
    out = {}
    for n, ips in sorted(rep.items()):
        eff = ips / (base * n) if base else float("nan")
        out[n] = {"iters_per_s": ips, "efficiency": eff}
        print(f"  {n} shards: {ips:8.1f} iters/s  efficiency {eff:.2f}",
              flush=True)

    # calibration: one shard's iteration, and the separator solve alone
    iterations = 20
    bg, sg = dist_solver.split_graph(g, dist_solver.partition_of(g, 128))
    S = int(sg.sep_valid.shape[0])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dist_solver.optimize_pose_graph_blocked(bg, sg, 1.0, iterations)
    sync()
    t0 = time.perf_counter()
    dist_solver.optimize_pose_graph_blocked(bg, sg, 1.0, iterations)
    sync()
    t_iter = (time.perf_counter() - t0) / iterations
    A = torch.eye(3 * S, dtype=torch.float64, device=dev) * 4.0 + 0.1
    b = torch.ones(3 * S, dtype=torch.float64, device=dev)
    dist_solver._eq_chol_solve(A, b)
    sync()
    t0 = time.perf_counter()
    for _ in range(iterations):
        b = dist_solver._eq_chol_solve(A, b)
    sync()
    t_sep = (time.perf_counter() - t0) / iterations
    t_int = max(t_iter - t_sep, 0.0)
    sep_bytes = 8.0 * (9.0 * S * S + 3.0 * S)  # the float64 all-reduce
    print(f"calibration ({dev}): t_iter {t_iter * 1e3:.2f} ms = t_int "
          f"{t_int * 1e3:.2f} + t_sep {t_sep * 1e3:.2f}; S={S} separators "
          f"-> all-reduce {sep_bytes / 1e6:.2f} MB per iteration",
          flush=True)
    modeled = {}
    if args.link_gbs > 0 and args.host_gbs > 0:
        for n, (tn, eff) in multihost.model_efficiency(
                t_int, t_sep, sep_bytes, args.link_gbs * 1e9,
                args.host_gbs * 1e9, args.link_us * 1e-6,
                args.host_us * 1e-6).items():
            modeled[n] = {"t_iter_ms": tn * 1e3, "efficiency": eff}
            print(f"  modeled {n:3d} devices: {1.0 / tn:8.1f} iters/s "
                  f"efficiency {eff:.2f}", flush=True)
    print(json.dumps({"scaling": out, "t_iter_ms": t_iter * 1e3,
                      "t_sep_ms": t_sep * 1e3, "separators": S,
                      "modeled": modeled}), flush=True)


if __name__ == "__main__":
    main()
