"""The port's counterparts of the JAX package's graft entry points
(__graft_entry__.py).

entry(): one forward step of the flagship compute kernel -- a
DCS-robustified Gauss-Newton pass over a 512-pose chain with the
block-partitioned Schur solver on one device -- returned as (fn, args).

dryrun_multichip(n): the keyframe-partitioned pose-graph GN sharded over
an n-shard mesh (parallel/multihost.block_mesh: the chain halo between
shards and the summed separator system), run once at the JAX package's
sizes (128 poses a shard, 32 closures across the chain, 24 GN iterations
with GNC annealing) and held to the dense single-device solve within
1e-3. Both run on the card unless `device` says otherwise.
"""
from __future__ import annotations

import numpy as np
import torch


def _device(device):
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def entry(device=None):
    from .eval.synthetic_graphs import make_chain_graph, to_pose_graph
    from .parallel.dist_solver import (
        optimize_pose_graph_blocked,
        partition_of,
        split_graph,
    )

    f, _ = make_chain_graph(n_poses=512, n_closures=16, pad_to=512,
                            dtype=np.float32)
    g = to_pose_graph(f, _device(device), torch.float32)
    bg, sg = split_graph(g, partition_of(g, 8))

    def fn(bg_, sg_):
        return optimize_pose_graph_blocked(bg_, sg_, 1.0, iterations=2)

    return fn, (bg, sg)


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Runs the sharded solve on n_devices shards (this process's cards
    in turn, or `device` for all of them; the CPU without a card) and
    asserts it within 1e-3 of the dense solver. Returns the largest
    difference."""
    from .eval.synthetic_graphs import make_chain_graph, to_pose_graph
    from .ops.solvers import optimize_pose_graph
    from .parallel import multihost
    from .parallel.dist_solver import optimize_partitioned

    dev = _device(device)
    if device is None and dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device(f"cuda:{i % cards}")
                   for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    mesh = multihost.block_mesh(n_devices, devices)
    n = 128 * n_devices
    # make_chain_graph places closures between far-apart poses, so with
    # blocks of 128 most closures couple different blocks (separators
    # shared across shards)
    f, _ = make_chain_graph(n_poses=n, n_closures=32, pad_to=n,
                            dtype=np.float32)
    g = to_pose_graph(f, devices[0], torch.float32)
    out = optimize_partitioned(g, phi=1.0, n_blocks=n_devices,
                               iterations=24, mesh=mesh,
                               gnc_init_scale=100.0)
    dense = optimize_pose_graph(g, phi=1.0, iterations=24,
                                gnc_init_scale=100.0)
    got = out.poses.cpu().numpy()
    want = dense.poses.cpu().numpy()
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err < 1e-3, f"sharded vs dense max diff {err}"
    return err
