"""One process of the port's real multi-process sharded solve:

    python scripts/torch_dist_test_worker.py PID NPROCS PORT [--device cpu]

Each of NPROCS processes starts torch.distributed through
sparse_gslam_tpu_torch.parallel.multihost.initialize (gloo on the CPU,
NCCL on cards, the coordinator at localhost:PORT), takes two shards of
a 2 * NPROCS-shard mesh (block_mesh) and runs the keyframe-partitioned
solver (dist_solver.optimize_pose_graph_sharded) on the same seeded
float64 chain in every process: 480 poses padded to 512, 16 closures,
8 blocks, 12 GN iterations. It exits 0 only if the result equals the
blocked single-device solve within 1e-10 and the dense solve within
1e-6 on every rank. The port's counterpart of scripts/dist_test_worker.py
(tests/test_torch_sharded.py launches two).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("pid", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("port")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    torch.set_num_threads(1)
    from sparse_gslam_tpu_torch.eval.synthetic_graphs import (
        make_chain_graph,
        to_pose_graph,
    )
    from sparse_gslam_tpu_torch.ops.solvers import optimize_pose_graph
    from sparse_gslam_tpu_torch.parallel import dist_solver, multihost

    cuda = args.device == "cuda"
    multihost.initialize(f"localhost:{args.port}", args.nprocs, args.pid,
                         backend="nccl" if cuda else "gloo")
    try:
        dev = (torch.device(f"cuda:{args.pid % torch.cuda.device_count()}")
               if cuda else torch.device("cpu"))
        mesh = multihost.block_mesh(2 * args.nprocs, [dev, dev])
        print(f"proc {mesh.rank}: {len(mesh.devices)} local / {mesh.size} "
              f"global shards on {dev}", flush=True)
        f, _ = make_chain_graph(n_poses=480, n_closures=16, pad_to=512,
                                drift=0.02, seed=7)
        g = to_pose_graph(f, dev)
        plan = dist_solver.partition_of(g, 8)
        bg, sg = dist_solver.split_graph(g, plan)
        out = dist_solver.optimize_pose_graph_sharded(bg, sg, 1.0, mesh,
                                                      iterations=12)
        ref = dist_solver.optimize_pose_graph_blocked(bg, sg, 1.0,
                                                      iterations=12)
        dense = optimize_pose_graph(g, 1.0, 12).poses.reshape(out.shape)
        e_b = float((out - ref).abs().max())
        e_d = float((out[..., :] - dense).abs().reshape(-1, 3)[:480].max())
        ok = bool(torch.isfinite(out).all()) and e_b <= 1e-10 and e_d <= 1e-6
        print(f"proc {mesh.rank}: {'OK' if ok else 'FAIL'} (blocked "
              f"{e_b:.3g}, dense {e_d:.3g}, {out.numel()} values)",
              flush=True)
        return 0 if ok else 1
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    sys.exit(main())
