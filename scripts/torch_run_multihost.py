"""Multi-process launcher of the port's sharded pose-graph solver.

One process per host (or per card):

    SLAM_NUM_PROCESSES=2 SLAM_PROCESS_ID=0 SLAM_COORDINATOR=host0:12321 \
        python scripts/torch_run_multihost.py --shards 2 &
    SLAM_NUM_PROCESSES=2 SLAM_PROCESS_ID=1 SLAM_COORDINATOR=host0:12321 \
        python scripts/torch_run_multihost.py --shards 2

One process, n shards on its cards in turn (or several on one card, or
on the CPU with --device cpu):

    python scripts/torch_run_multihost.py --shards 4 [--device cpu]

The port's counterpart of scripts/run_multihost.py: the same chain
(16000 poses padded to 16384, 256 closures, 128 blocks, 20 GN
iterations), partitioned and solved by
dist_solver.optimize_pose_graph_sharded on
multihost.block_mesh(--shards), in float64 as the port's solvers run;
prints GN iterations per second
(the mean of --reps solves after one warm-up). With --scaling it sweeps
1, 2, 4 ... --shards shards in one process (multihost.scaling_report).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-poses", type=int, default=16000)
    ap.add_argument("--pad-to", type=int, default=16384)
    ap.add_argument("--closures", type=int, default=256)
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="",
                    help="cpu: the shards on the CPU (default: the cards)")
    ap.add_argument("--scaling", action="store_true",
                    help="sweep 1..--shards shards in this process")
    args = ap.parse_args()

    import torch

    from sparse_gslam_tpu_torch.eval.synthetic_graphs import (
        make_chain_graph,
        to_pose_graph,
    )
    from sparse_gslam_tpu_torch.parallel import dist_solver, multihost

    cpu = args.device == "cpu"
    multihost.initialize(backend="gloo" if cpu else None)
    try:
        f, _ = make_chain_graph(n_poses=args.n_poses,
                                n_closures=args.closures,
                                pad_to=args.pad_to)
        if args.scaling:
            devs = [torch.device("cpu")] if cpu else None
            g = to_pose_graph(f, "cpu" if cpu else "cuda")
            counts = [c for c in (1, 2, 4, 8, 16, 32)
                      if c <= max(args.shards, 1)]
            rep = multihost.scaling_report(
                g, 1.0, device_counts=counts, iterations=args.iterations,
                reps=args.reps, n_blocks=args.blocks, devices=devs)
            base = rep.get(1)
            for n, ips in rep.items():
                eff = ips / (base * n) if base else float("nan")
                print(f"{n} shards: {ips:.1f} it/s (efficiency {eff:.2f})")
            return 0
        world = _world()
        shards = args.shards or world
        mesh = multihost.block_mesh(
            shards, [torch.device("cpu")] * (shards // world) if cpu
            else None)
        print(f"process {mesh.rank}/{mesh.world}, {len(mesh.devices)} local "
              f"/ {mesh.size} shards on {mesh.home}", flush=True)
        g = to_pose_graph(f, mesh.home)
        bg, sg = dist_solver.split_graph(
            g, dist_solver.partition_of(g, args.blocks))

        def solve():
            out = dist_solver.optimize_pose_graph_sharded(
                bg, sg, 1.0, mesh, iterations=args.iterations)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            return out

        out = solve()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = solve()
        dt_s = (time.perf_counter() - t0) / args.reps
        assert bool(torch.isfinite(out).all())
        print(f"{mesh.size} shards x {mesh.world} processes: "
              f"{args.iterations / dt_s:.1f} it/s (N={args.pad_to}, "
              f"C={args.closures}, blocks={args.blocks})")
        return 0
    finally:
        multihost.shutdown()


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


if __name__ == "__main__":
    sys.exit(main())
