"""Process start-up and the 1-D mesh of the port's multi-device routes.

Port of sparse_gslam_tpu/parallel/multihost.py. The JAX package builds a
jax.sharding.Mesh with one axis ("blocks" or "cands") over the global
devices and runs shard_map on it; its collectives are XLA's psum and
ppermute. The port's mesh (BlockMesh) is the same 1-D layout in one
design for one process and for many:

  - `devices` are this process's local devices, one per local shard, in
    shard order; a process holds a contiguous run of the global shards
    (rank r holds shards r * L .. r * L + L - 1, L = len(devices));
  - in one process the shards loop over the local devices and their
    partial sums are added in shard order on the first (`home`) device;
    a device may repeat ([cuda:0] * n is n shards on one card, the
    counterpart of the JAX package's virtual CPU mesh);
  - across processes `group` (a torch.distributed process group) joins
    them: all_reduce for the psum, all_gather for the gathers and the
    chain halo.

Usage (one process per host or card):

    from sparse_gslam_tpu_torch.parallel import multihost
    multihost.initialize()         # SLAM_NUM_PROCESSES, SLAM_PROCESS_ID,
                                   # SLAM_COORDINATOR; no-op in one process
    mesh = multihost.block_mesh(4)  # 4 shards over this process's devices
    ... dist_solver.optimize_pose_graph_sharded(bg, sg, phi, mesh) ...
"""
from __future__ import annotations

import dataclasses
import math
import os
import time

import torch


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               single_rank_group: bool = False) -> bool:
    """torch.distributed.init_process_group with the JAX package's
    environment variables as fallbacks (SLAM_NUM_PROCESSES,
    SLAM_PROCESS_ID, SLAM_COORDINATOR, default localhost:12321). NCCL
    where the process has a CUDA device, gloo otherwise, unless
    `backend` names one. With one process it does nothing, as the JAX
    package's does, unless `single_rank_group` asks for a group of one
    rank (the collective path on one process). Returns whether a group
    was started."""
    import torch.distributed as dist

    n = num_processes or int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    if n <= 1 and not single_rank_group:
        return False
    if dist.is_initialized():
        return False
    addr = (coordinator_address
            or os.environ.get("SLAM_COORDINATOR", "localhost:12321"))
    rank = (process_id if process_id is not None
            else int(os.environ.get("SLAM_PROCESS_ID", "0")))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=max(n, 1), rank=rank)
    return True


def shutdown() -> None:
    """Destroy the process group initialize started, if any."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class BlockMesh:
    """A 1-D mesh of shards: this process's `devices` (one per local
    shard) and, across processes, the process `group` of `world` ranks
    of which this is `rank` (None, 1 and 0 in one process)."""

    devices: tuple
    group: object = None
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """Shards over all processes (the JAX mesh's axis size)."""
        return len(self.devices) * self.world

    @property
    def first(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where the partial sums meet and the replicated work runs."""
        return self.devices[0]

    def psum(self, parts):
        """The sum over every shard of its part (one tensor per local
        shard): the local parts added in shard order on `home`, then
        all_reduce over the group. Every rank gets the same total."""
        total = parts[0].to(self.home)
        for p in parts[1:]:
            total = total + p.to(self.home)
        if self.group is not None:
            import torch.distributed as dist

            total = total.contiguous()
            dist.all_reduce(total, group=self.group)
        return total

    def gather(self, parts):
        """Every shard's part (one tensor per local shard, the same
        shape), concatenated along dim 0 in global shard order on
        `home`, on every rank."""
        local = torch.cat([p.to(self.home) for p in parts])
        if self.group is None:
            return local
        import torch.distributed as dist

        out = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(out, local.contiguous(), group=self.group)
        return torch.cat(out)

    def from_previous_rank(self, t):
        """The previous rank's `t` (zeros on rank 0): the halo that the
        JAX package's ppermute ring carries from device to device."""
        if self.group is None:
            return torch.zeros_like(t)
        allt = self.gather([t[None]])
        return allt[self.rank - 1] if self.rank > 0 else torch.zeros_like(t)


def block_mesh(n_shards: int | None = None, devices=None) -> BlockMesh:
    """The port's 1-D mesh of `n_shards` shards over all processes (the
    JAX package's block_mesh(n), a Mesh over the first n global
    devices). `devices` lists this process's shard devices explicitly
    (e.g. [torch.device("cuda:0")] * 4). Otherwise each process takes
    n_shards / world shards: in a group on its own card
    (cuda:rank % cards) or the CPU; in one process on cards 0..k-1 in
    turn (cuda:i % k) or the CPU. n_shards defaults to one per process
    (one per card, or 1, in one process)."""
    import torch.distributed as dist

    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if devices is None:
        if n_shards is None:
            n_shards = world if group is not None else max(cards, 1)
        if n_shards % world:
            raise ValueError(f"{n_shards} shards do not divide over "
                             f"{world} processes")
        per = n_shards // world
        if group is not None:
            dev = (torch.device(f"cuda:{rank % cards}") if cards
                   else torch.device("cpu"))
            devices = [dev] * per
        else:
            devices = ([torch.device(f"cuda:{i % cards}") for i in range(per)]
                       if cards else [torch.device("cpu")] * per)
    devices = tuple(torch.device(d) for d in devices)
    if n_shards is not None and len(devices) * world != n_shards:
        raise ValueError(f"{len(devices)} devices x {world} processes is "
                         f"not {n_shards} shards")
    return BlockMesh(devices, group, rank, world)


def model_efficiency(t_int_s: float, t_sep_s: float, sep_bytes: float,
                     bw_link: float, bw_host: float, lat_link: float,
                     lat_host: float, device_counts=(2, 4, 8, 16, 32, 64),
                     devices_per_host: int = 8):
    """Projected scaling efficiency of the sharded GN solver from a
    collective-traffic model, calibrated by one device's interior time
    `t_int_s` and replicated separator time `t_sep_s` per iteration.

    Per GN iteration optimize_pose_graph_sharded does the interior work
    split n ways (t_int / n), the replicated separator solve (t_sep),
    one all-reduce of the dense separator system (`sep_bytes`), and one
    three-float halo exchange (latency only). The all-reduce costs
    2 (n - 1) / n * bytes / bandwidth (a ring reduce-scatter and
    all-gather) over the links within a host (`bw_link`, B/s, latency
    `lat_link` s per step), plus the same over the links between hosts
    (`bw_host`, `lat_host`) once n exceeds devices_per_host. The rates
    are the caller's: the hardware's, or measured. Returns {n:
    (t_iter_s, efficiency)} with efficiency = t_1 / (n t_n)."""
    t1 = t_int_s + t_sep_s
    out = {}
    for n in device_counts:
        hosts = max(1, math.ceil(n / devices_per_host))
        comm = 2.0 * (n - 1) / n * sep_bytes / bw_link
        comm += lat_link * max(1.0, math.log2(max(n, 2)))
        if hosts > 1:
            comm += 2.0 * (hosts - 1) / hosts * sep_bytes / bw_host
            comm += lat_host * max(1.0, math.log2(hosts))
        tn = t_int_s / n + t_sep_s + comm
        out[n] = (tn, t1 / (n * tn))
    return out


def scaling_report(g, phi: float, device_counts=(1, 2, 4, 8),
                   iterations: int = 20, reps: int = 3, n_blocks: int = 128,
                   devices=None):
    """Measured pose-graph GN throughput of the sharded solver at several
    mesh sizes, with the block count fixed (n_blocks) so that the
    numeric work is the same at every size. `devices` is the pool the
    shards take in turn (default: this process's cards, or the CPU);
    shards beyond the pool share its devices, as on a one-card
    machine. Returns {n_shards: GN iterations per second}."""
    from .dist_solver import optimize_partitioned

    if devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([torch.device(f"cuda:{i}") for i in range(cards)]
                   or [torch.device("cpu")])
    out = {}
    for n in device_counts:
        if n_blocks % n:
            continue
        mesh = block_mesh(n, [devices[i % len(devices)] for i in range(n)])

        def run():
            p = optimize_partitioned(g, phi, n_blocks=n_blocks,
                                     iterations=iterations, mesh=mesh).poses
            if p.is_cuda:
                torch.cuda.synchronize(p.device)
            return p

        run()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        out[n] = iterations / ((time.perf_counter() - t0) / reps)
    return out
