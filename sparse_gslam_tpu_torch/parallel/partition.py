"""Host-side partitioning of a pose graph into contiguous keyframe
blocks + separator bookkeeping for the distributed Schur solver.

There is no reference code for this: the reference is single-process
(SURVEY.md §2.7); this implements the BASELINE.json north-star design
(submap/keyframe-partitioned graph, distributed Schur-complement
solves, cross-partition loop edges as separator variables).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PartitionPlan(NamedTuple):
    """Static partition metadata (host-computed, device-constant).

    n_blocks * block_size = padded pose count. Separators = the last
    pose of every block except the final one, plus every closure
    endpoint. sep_pose (S,): global pose index per separator slot
    (filler slots point at pose 0 with sep_valid False);
    sep_id_of_pose (N,): inverse map, -1 where not a separator;
    clo_sep_i / clo_sep_j (C,): separator slot of each closure endpoint.

    Locality (keeps the per-block Schur work O(local separators), not
    O(S)): loc_sep (P, K): global slot ids of the separators each block
    touches (the previous block's boundary first, then slots whose pose
    lies in the block), -1 padded; sep_local_id (N,): position of a
    pose's separator slot within its OWN block's loc_sep list, -1 where
    not a separator.
    """

    n_blocks: int
    block_size: int
    sep_pose: np.ndarray
    sep_valid: np.ndarray
    sep_id_of_pose: np.ndarray
    clo_sep_i: np.ndarray
    clo_sep_j: np.ndarray
    loc_sep: np.ndarray
    sep_local_id: np.ndarray
    # compact (block, local-slot) enumerations for the Schur scatter:
    # most of the (P, K, K) local-pair lattice is padding (-1 slots);
    # these list only the real entries, pow2-padded with -1. pair_*:
    # every ordered slot pair within a block (the (3K,3K) local Schur
    # block at (ki, kj) goes to global (si, sj)); single_*: every
    # (block, slot) for the rhs accumulation.
    pair_block: np.ndarray  # (Q,)
    pair_ki: np.ndarray
    pair_kj: np.ndarray
    pair_si: np.ndarray
    pair_sj: np.ndarray
    single_block: np.ndarray  # (Q2,)
    single_k: np.ndarray
    single_s: np.ndarray


def make_partition(
    n_poses_padded: int,
    n_blocks: int,
    clo_i: np.ndarray,
    clo_j: np.ndarray,
    clo_valid: np.ndarray,
    sep_capacity: int | None = None,
) -> PartitionPlan:
    assert n_poses_padded % n_blocks == 0
    M = n_poses_padded // n_blocks
    boundaries = [b * M + M - 1 for b in range(n_blocks - 1)]
    sep_set: dict[int, int] = {}
    for p in boundaries:
        sep_set.setdefault(int(p), len(sep_set))
    C = len(clo_i)
    clo_sep_i = np.zeros(C, np.int32)
    clo_sep_j = np.zeros(C, np.int32)
    for k in range(C):
        if not clo_valid[k]:
            continue
        for arr, idx in ((clo_sep_i, int(clo_i[k])), (clo_sep_j, int(clo_j[k]))):
            if idx not in sep_set:
                sep_set[idx] = len(sep_set)
            arr[k] = sep_set[idx]

    S = len(sep_set)
    if sep_capacity is None:
        # multiple-of-64 padding (not pow2): the separator Cholesky is
        # O(S^3) and the global scatters O(S^2) -- at bench scale 639
        # active slots pow2-pad to 1024 (1.6x), while 640 keeps the
        # (3S) dim lane-aligned (1920 = 15*128) at no waste
        sep_capacity = max(8, -(-max(S, 1) // 64) * 64)
    if S > sep_capacity:
        raise ValueError(f"separator count {S} exceeds capacity")
    sep_pose = np.zeros(sep_capacity, np.int32)
    sep_valid = np.zeros(sep_capacity, bool)
    sep_id_of_pose = np.full(n_poses_padded, -1, np.int32)
    for pose_idx, slot in sep_set.items():
        sep_pose[slot] = pose_idx
        sep_valid[slot] = True
        sep_id_of_pose[pose_idx] = slot

    # per-block local separator lists: previous boundary first, then
    # this block's own separator slots in pose order
    per_block: list[list[int]] = [[] for _ in range(n_blocks)]
    for b in range(1, n_blocks):
        per_block[b].append(b - 1)  # previous block's boundary slot
    for pose_idx in sorted(sep_set):
        per_block[pose_idx // M].append(sep_set[pose_idx])
    K = max(max(len(l) for l in per_block), 1)
    Kcap = 4
    while Kcap < K:
        Kcap *= 2
    loc_sep = np.full((n_blocks, Kcap), -1, np.int32)
    sep_local_id = np.full(n_poses_padded, -1, np.int32)
    for b, slots in enumerate(per_block):
        for li, slot in enumerate(slots):
            loc_sep[b, li] = slot
            pose_idx = int(sep_pose[slot])
            if pose_idx // M == b:
                sep_local_id[pose_idx] = li
    pairs = []
    singles = []
    for b, slots in enumerate(per_block):
        for ki, si in enumerate(slots):
            singles.append((b, ki, si))
            for kj, sj in enumerate(slots):
                pairs.append((b, ki, kj, si, sj))

    def _pad(rows, width):
        Q = 8
        while Q < max(len(rows), 1):
            Q *= 2
        out = np.full((Q, width), -1, np.int32)
        if rows:
            out[: len(rows)] = rows
        return out

    pr = _pad(pairs, 5)
    sg = _pad(singles, 3)
    return PartitionPlan(
        n_blocks, M, sep_pose, sep_valid, sep_id_of_pose,
        clo_sep_i, clo_sep_j, loc_sep, sep_local_id,
        pr[:, 0], pr[:, 1], pr[:, 2], pr[:, 3], pr[:, 4],
        sg[:, 0], sg[:, 1], sg[:, 2],
    )
