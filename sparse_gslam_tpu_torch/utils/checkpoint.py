"""Periodic SLAM-state checkpointing (save/resume).

The reference has no checkpointing (SURVEY.md §5: only the final
.result is persisted; g2o serializers are stubbed,
vertex_rhotheta.cpp:36-42). This adds npz-based snapshots of the full
functional state -- keyframe poses/odometry, landmarks, observation
edges, pose-graph chain + closures -- enabling resume and the
incremental multi-config workflow.

Submap grids are intentionally NOT stored: they are deterministic
functions of the keyframe range data, which is stored, so resume
rebuilds them on demand: load_checkpoint runs Backend.precompute() until
it makes no new submap, which inserts on the backend's device (the CUDA
kernel on the card) and, as in the JAX package, also runs the pins and
chain edges of that precompute over the restored closures.

Port of sparse_gslam_tpu/utils/checkpoint.py with the same npz layout:
either package loads what the other saved. Everything saved is numpy on
the host.
"""
from __future__ import annotations

import numpy as np


def save_checkpoint(path: str, system) -> None:
    fe = system.frontend
    be = system.backend
    arrays: dict[str, np.ndarray] = {}
    n = len(fe.keyframes)
    arrays["kf_estimates"] = (
        fe.estimates() if n else np.zeros((0, 3))
    )
    arrays["kf_odom_meas"] = np.stack(
        [k.odom_meas for k in fe.keyframes]
    ) if n else np.zeros((0, 3))
    arrays["kf_odom_info"] = np.stack(
        [k.odom_info for k in fe.keyframes]
    ) if n else np.zeros((0, 3, 3))
    # ragged per-keyframe data flattened with offsets
    pts, meta, offs_p, offs_m = [], [], [0], [0]
    odom_t, odom_d, offs_o = [], [], [0]
    for k in fe.keyframes:
        pts.append(k.data.points)
        offs_p.append(offs_p[-1] + len(k.data.points))
        for re_, e_, o in k.data.meta:
            meta.append([re_, e_, o[0], o[1]])
        offs_m.append(len(meta))
        odom_t.extend(k.odom_times)
        odom_d.extend(k.odom_dposes)
        offs_o.append(len(odom_t))
    arrays["kf_points"] = (
        np.concatenate(pts) if pts else np.zeros((0, 2))
    )
    arrays["kf_meta"] = np.asarray(meta, dtype=np.float64).reshape(-1, 4)
    arrays["kf_offs_p"] = np.asarray(offs_p)
    arrays["kf_offs_m"] = np.asarray(offs_m)
    arrays["kf_odom_t"] = np.asarray(odom_t)
    arrays["kf_odom_d"] = (
        np.stack(odom_d) if odom_d else np.zeros((0, 3))
    )
    arrays["kf_offs_o"] = np.asarray(offs_o)

    arrays["lm_rhotheta"] = np.stack(
        [l.rhotheta for l in fe.landmarks]
    ) if fe.landmarks else np.zeros((0, 2))
    arrays["lm_start"] = np.stack(
        [l.start for l in fe.landmarks]
    ) if fe.landmarks else np.zeros((0, 2))
    arrays["lm_end"] = np.stack(
        [l.end for l in fe.landmarks]
    ) if fe.landmarks else np.zeros((0, 2))
    arrays["lm_dist"] = np.asarray([l.dist for l in fe.landmarks])

    for prefix, e in (
        ("obs", fe.obs_edges),
        ("aobs", fe.archived_obs),
    ):
        arrays[f"{prefix}_pose"] = np.asarray(
            [x.pose_idx for x in e], np.int64
        )
        arrays[f"{prefix}_lm"] = np.asarray(
            [x.lm_idx for x in e], np.int64
        )
        arrays[f"{prefix}_meas"] = (
            np.stack([x.meas for x in e]) if e else np.zeros((0, 2))
        )
        arrays[f"{prefix}_info"] = (
            np.stack([x.info for x in e]) if e else np.zeros((0, 2, 2))
        )
        arrays[f"{prefix}_start"] = (
            np.stack([x.start_bl for x in e]) if e else np.zeros((0, 2))
        )
        arrays[f"{prefix}_end"] = (
            np.stack([x.end_bl for x in e]) if e else np.zeros((0, 2))
        )
    arrays["scalars"] = np.asarray(
        [
            fe.window_start, fe.traveled_dist, fe.last_landmark_edge,
            float(fe.need_reinit),
            fe.prev_time if fe.prev_time is not None else np.nan,
        ]
    )
    arrays["prev_odom"] = (
        fe.prev_odom if fe.prev_odom is not None else np.full(3, np.nan)
    )
    arrays["odom_prop_pose"] = fe.odom_prop.pose
    arrays["odom_prop_cov"] = fe.odom_prop.cov

    if be is not None:
        arrays["pg_poses"] = (
            np.stack(be.pg_poses) if be.pg_poses else np.zeros((0, 3))
        )
        arrays["pg_meas"] = (
            np.stack(be.pg_meas) if be.pg_meas else np.zeros((0, 3))
        )
        arrays["pg_info"] = (
            np.stack(be.pg_info) if be.pg_info else np.zeros((0, 3, 3))
        )
        kind_code = {"loop": 0, "local": 1, "kf": 2}
        arrays["clo"] = np.asarray(
            [
                [
                    c.i, c.j, float(c.active),
                    kind_code.get(c.kind, 0), float(c.suppressed),
                ]
                for c in be.closures
            ]
        ).reshape(-1, 5)
        arrays["clo_meas"] = (
            np.stack([c.meas for c in be.closures])
            if be.closures
            else np.zeros((0, 3))
        )
        arrays["clo_info"] = (
            np.stack([c.info for c in be.closures])
            if be.closures
            else np.zeros((0, 3, 3))
        )
        arrays["be_scalars"] = np.asarray(
            [be.last_pose_idx, be.last_opt_pose_index, be.false_closures]
        )
        arrays["submap_anchors"] = np.asarray(
            [s.anchor_idx for s in be.submaps], np.int64
        )
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, system) -> None:
    """Restore state saved by save_checkpoint into `system` (must be
    constructed with the same configs). Submap grids are rebuilt."""
    from ..models.frontend import Keyframe, Landmark, ObsEdge
    from ..models.range_data import RangeData2D

    z = np.load(path, allow_pickle=False)
    fe = system.frontend
    fe.keyframes.clear()
    n = len(z["kf_estimates"])
    for i in range(n):
        data = RangeData2D()
        p0, p1 = z["kf_offs_p"][i], z["kf_offs_p"][i + 1]
        data.points = z["kf_points"][p0:p1].copy()
        m0, m1 = z["kf_offs_m"][i], z["kf_offs_m"][i + 1]
        for row in z["kf_meta"][m0:m1]:
            # meta indices are already relative to the keyframe's own
            # point array
            data.meta.append(
                (int(row[0]), int(row[1]), np.array([row[2], row[3]]))
            )
        o0, o1 = z["kf_offs_o"][i], z["kf_offs_o"][i + 1]
        fe.keyframes.append(
            Keyframe(
                estimate=z["kf_estimates"][i].copy(),
                odom_meas=z["kf_odom_meas"][i].copy(),
                odom_info=z["kf_odom_info"][i].copy(),
                data=data,
                odom_times=list(z["kf_odom_t"][o0:o1]),
                odom_dposes=list(z["kf_odom_d"][o0:o1]),
            )
        )
    fe.landmarks = [
        Landmark(
            rhotheta=z["lm_rhotheta"][i].copy(),
            start=z["lm_start"][i].copy(),
            end=z["lm_end"][i].copy(),
            dist=float(z["lm_dist"][i]),
        )
        for i in range(len(z["lm_rhotheta"]))
    ]
    def _edges(prefix):
        if f"{prefix}_pose" not in z:
            return []
        return [
            ObsEdge(
                pose_idx=int(z[f"{prefix}_pose"][i]),
                lm_idx=int(z[f"{prefix}_lm"][i]),
                meas=z[f"{prefix}_meas"][i].copy(),
                info=z[f"{prefix}_info"][i].copy(),
                start_bl=z[f"{prefix}_start"][i].copy(),
                end_bl=z[f"{prefix}_end"][i].copy(),
            )
            for i in range(len(z[f"{prefix}_pose"]))
        ]

    fe.obs_edges = _edges("obs")
    fe.archived_obs = _edges("aobs")
    sc = z["scalars"]
    fe.window_start = int(sc[0])
    fe.traveled_dist = float(sc[1])
    fe.last_landmark_edge = int(sc[2])
    fe.need_reinit = bool(sc[3])
    fe.prev_time = None if np.isnan(sc[4]) else float(sc[4])
    fe.prev_odom = (
        None if np.isnan(z["prev_odom"][0]) else z["prev_odom"].copy()
    )
    fe.odom_prop.pose = z["odom_prop_pose"].copy()
    fe.odom_prop.cov = z["odom_prop_cov"].copy()

    be = system.backend
    if be is not None and "pg_poses" in z:
        be.pg_poses = [p.copy() for p in z["pg_poses"]]
        be.pg_meas = [p.copy() for p in z["pg_meas"]]
        be.pg_info = [p.copy() for p in z["pg_info"]]
        from ..models.backend import Closure

        kind_name = {0: "loop", 1: "local", 2: "kf"}
        be.closures = [
            Closure(
                i=int(row[0]), j=int(row[1]),
                meas=z["clo_meas"][k].copy(),
                info=z["clo_info"][k].copy(),
                active=bool(row[2]),
                kind=kind_name.get(
                    int(row[3]) if len(row) > 3 else 0, "loop"
                ),
                suppressed=bool(row[4]) if len(row) > 4 else False,
            )
            for k, row in enumerate(z["clo"])
        ]
        bs = z["be_scalars"]
        be.last_pose_idx = int(bs[0])
        be.last_opt_pose_index = int(bs[1])
        be.false_closures = int(bs[2])
        # rebuild submap grids deterministically from stored range data
        be.submaps.clear()
        saved_last = be.last_pose_idx
        be.last_pose_idx = 0
        for _ in range(len(z["submap_anchors"]) + 2):
            before = len(be.submaps)
            be.precompute()
            if len(be.submaps) == before:
                break
        be.last_pose_idx = max(be.last_pose_idx, saved_last)
