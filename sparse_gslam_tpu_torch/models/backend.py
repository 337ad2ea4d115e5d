"""Submap construction + loop-closure detection + pose-graph backend.

Re-implements SubmapLoopCloser (src/sparse_gslam/src/submap_loop_closer
.cpp:43-297, include/loop_closer/submap_loop_closer.h) and the
pose-graph bookkeeping of graphs.h:30-40 / log_runner.cpp:176-206.
Port of sparse_gslam_tpu/models/backend.py, its CPU branch:

  precompute(): accumulate ~submap_trajectory_length of keyframes into
  a multicloud, ray-trace it into a match-resolution grid + a fixed
  0.05 m high-res grid (the CUDA insertion kernel on the card), anchor
  at the middle keyframe, precompute the max-pool pyramid; then the
  per-keyframe pins (window correlation: numpy on the CPU, a CUDA
  kernel on the card) and the submap chain edges (Gauss-Newton on the
  previous submaps' grids).

  match(): build the query multiscan from the last ~last_traj_length of
  keyframes, select candidate submaps by distance, run the pruned
  correlative matcher (ops/matching.match_candidates_pruned), refine on
  the high-res grid, extend the pose-graph chain, prune the landmark
  graph to one fixed pose, add the DCS closure edge and run 20 GN
  iterations: the dense solver (ops/solvers.optimize_pose_graph) below
  dist_solver_min_poses padded poses, the keyframe-partitioned Schur
  solver (parallel/dist_solver.optimize_pose_graph_blocked) from there.

Grids, the matcher, the refinement and the pose-graph solve run on
`device`; what the JAX package computes in numpy stays numpy on the
host. final_cleanup may end with joint_solve, the joint landmark +
pose bundle adjustment (ops/solvers.optimize_joint_graph) on `device`.

accel_branch=True takes the JAX package's other branch, which it picks
by jax.default_backend() != "cpu", at the same places and nowhere else:
the rotation count frozen at range_max (_match_snapshot, rematch_all),
the fused one-call matcher on cached per-submap spectra
(ops/matching.match_candidates_fused; _match_search, rematch_all) and
the device pin batches (ops/matching.pin_eval_batch; _kf_edges_device).
It runs on whichever device the backend was built with. Unlike the JAX
package it leaves the frontend where it is (frontend_on_host is not
carried over). Off (the default) is the CPU branch on every device.
Two attributes, set in code as the JAX package's are (its runner has no
flag for them), take the multi-device routes: `mesh`
(parallel/multihost.BlockMesh) sends every pose-graph solve through the
sharded solver (parallel/dist_solver.optimize_pose_graph_sharded), and
`match_mesh` the candidate search through
ops/matching.match_candidates_sharded. Not ported (ROADMAP.md): the
ground-truth diagnostics; no configuration selects them on this path.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import os

import numpy as np
import torch

from ..interop import (
    joint_graph_from_numpy,
    pin_batch_from_numpy,
    pose_graph_from_numpy,
)
from ..ops import matching, solvers
from ..ops.grid import GridSpec, build_submap_grid, precompute_pyramid
from ..ops.line_geometry import transform_line
from ..parallel import dist_solver
from ..utils import se2
from ..utils.config import SlamConfig
from ..utils.trace import Recorder
from .frontend import Frontend, _bucket
from .range_data import construct_multicloud


def _host(*tensors):
    """float64 numpy copies of device tensors, in one transfer."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    out, o = [], 0
    flat = flat.cpu().numpy()
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(tuple(t.shape)))
        o += t.numel()
    return out


def _padded_query(query, device):
    """(points, valid) float32/bool tensors on `device`, the query
    padded to _bucket(n, 256) points."""
    n = len(query)
    Nb = _bucket(n, 256)
    pts = np.zeros((Nb, 2), np.float32)
    pts[:n] = query
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(np.arange(Nb) < n).to(device))


@dataclasses.dataclass
class Submap:
    """Reference: include/submap.h:18-41. Grids are float32 tensors on
    the backend's device."""

    anchor_idx: int  # keyframe index of the anchoring pose
    score_grid: torch.Tensor  # (G,G) dilated level-0 score grid
    pooled_grid: torch.Tensor  # (G,G) level-(depth-1) pooled bound grid
    probs: torch.Tensor  # (G,G) raw (undilated) probability grid
    origin: torch.Tensor  # (2,)
    high_res: torch.Tensor  # (G2,G2) probability grid
    high_origin: torch.Tensor
    resolution: float
    # keyframe index range [start_idx, end_idx) the grids were built
    # from (for the local-refinement non-overlap constraint)
    start_idx: int = 0
    end_idx: int = 0
    # lazily-cached host copy of pooled_grid (the per-keyframe pins
    # bound their windows with numpy gathers)
    pooled_np: object = None
    # lazily-cached (F, F//2+1) spectrum of score_grid (the accelerator
    # branch's fused matcher and pin batches read it; dropped when
    # rebuild_grids replaces the grids)
    spectrum: object = None

    def get_spectrum(self, fft_size: int):
        if self.spectrum is None or self.spectrum.shape[-2] != fft_size:
            self.spectrum = matching.grid_spectrum(
                self.score_grid[None], int(fft_size),
                int(self.score_grid.shape[0]),
            )[0]
        return self.spectrum


@dataclasses.dataclass
class Closure:
    i: int  # pose index of submap anchor
    j: int  # pose index of matched query mid
    meas: np.ndarray  # (3,)
    info: np.ndarray  # (3,3)
    active: bool = True
    # "loop" = correlative loop closure (the reference's only kind);
    # "local" = submap-to-previous-submap chain edge; "kf" = per-
    # keyframe scan-to-previous-submap pin
    kind: str = "loop"
    # recomputed by _gate_consistent_loops before every solve: True =
    # currently outvoted by pairwise odometry-consistency; distinct
    # from `active`, which is the permanent 11.345 chi2 prune
    suppressed: bool = False
    # accept-time diagnostics of live loop closures: drift of the
    # measurement from the graph prediction along the wide axis of its
    # own covariance, and that axis's sigma
    along_drift: float = float("nan")
    sigma_along: float = float("nan")


class SubmapLoopCloser:
    def __init__(self, config: SlamConfig, frontend: Frontend,
                 device="cuda", accel_branch: bool = False, rec=None):
        """rec: the utils.trace.Recorder of the owning system (a fresh
        one, off, without)."""
        self.config = config
        self.frontend = frontend
        self.rec = rec if rec is not None else Recorder()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the pins' window kernel, built before the first tick
            from ..ops import pin_window_cuda

            pin_window_cuda.load()
        # the JAX package's accelerator branch (module docstring)
        self.accel_branch = bool(accel_branch)
        # its device stacks of every submap's spectrum and high-res
        # grid: (submap count, stack...), rebuilt when the set changes
        self._spectra_stack = None
        self._high_stack = None
        self.submaps: list[Submap] = []
        self.last_pose_idx = 0
        self.last_opt_pose_index = 0
        self.loop_closure_min_score = config.loop_closure_min_score
        # pose graph state (parallel arrays per chain vertex)
        self.pg_poses: list[np.ndarray] = []
        self.pg_meas: list[np.ndarray] = []
        self.pg_info: list[np.ndarray] = []
        self.closures: list[Closure] = []
        self.false_closures = 0
        self.ridge_drift_rejects = 0
        # grid geometry: big enough for traj_len + 2*range_max
        extent = (
            config.submap_trajectory_length + 2.0 * config.range_max + 2.0
        )
        size = int(math.ceil(extent / config.submap_resolution / 64.0) * 64)
        self.spec = GridSpec(size=size, resolution=config.submap_resolution)
        hsize = int(math.ceil(extent / 0.05 / 64.0) * 64)
        self.high_spec = GridSpec(size=hsize, resolution=0.05)
        self.match_calls = 0
        # intra-tick wall-time accounting (seconds per phase): the
        # slam.backend.<phase> spans of self.rec, timed whether or not
        # it records them
        self.prof = collections.defaultdict(float)
        # local-refinement accept/reject counters (diagnostics)
        self.local_stats = {
            "dist": 0, "no_submap": 0, "corr": 0, "score": 0,
            "few_points": 0, "covered": 0, "accepted": 0,
        }
        # per-keyframe refinement counters (diagnostics)
        self.kf_stats = {
            "no_submap": 0, "corr": 0, "score": 0, "few_points": 0,
            "bound": 0, "accepted": 0,
        }
        self._kf_edge_done = 1  # next keyframe to consider for kf edges
        # optional parallel/multihost.BlockMesh: when set, every
        # pose-graph solve runs the sharded solver
        # (parallel/dist_solver.optimize_pose_graph_sharded)
        self.mesh = None
        # optional BlockMesh: when set, the candidate search fans out
        # over it (ops/matching.match_candidates_sharded, the multi-device
        # counterpart of the reference's ctpl pool)
        self.match_mesh = None

    # -- stats -----------------------------------------------------------
    @property
    def pose_count(self) -> int:
        return len(self.pg_poses)

    @property
    def submap_count(self) -> int:
        return len(self.submaps)

    @property
    def closure_count(self) -> int:
        """Active LOOP closures (the reference's closure statistic;
        local refinement edges are counted separately)."""
        return sum(
            1
            for c in self.closures
            if c.active and not c.suppressed and c.kind == "loop"
        )

    @property
    def local_edge_count(self) -> int:
        return sum(
            1 for c in self.closures if c.active and c.kind == "local"
        )

    @property
    def kf_edge_count(self) -> int:
        return sum(
            1 for c in self.closures if c.active and c.kind == "kf"
        )

    @property
    def false_closure_count(self) -> int:
        return self.false_closures

    def pose_estimates(self) -> np.ndarray:
        return np.stack(self.pg_poses)

    # --------------------------------------------------------------------
    def _build_grids(self, rd):
        """(score, pooled, probs, origin, high_res, high_origin) of one
        submap's multicloud, on the backend's device."""
        cfg = self.config
        sm_grid = build_submap_grid(
            rd, self.spec, cfg.hit_probability, cfg.miss_probability,
            device=self.device,
        )
        hi_grid = build_submap_grid(
            rd, self.high_spec, cfg.hit_probability, cfg.miss_probability,
            device=self.device,
        )
        depth = max(1, cfg.branch_and_bound_depth)
        pyr = precompute_pyramid(
            sm_grid.probs, depth, smooth=cfg.smoothing_kernel
        )
        return (pyr[0], pyr[depth - 1], sm_grid.probs, sm_grid.origin,
                hi_grid.probs, hi_grid.origin)

    def precompute(self):
        """Finalize a submap when enough trajectory accumulated
        (submap_loop_closer.cpp:63-98)."""
        kfs = self.frontend.keyframes
        if not kfs:
            return
        if self.config.kf_refine:
            with self.rec.timed("slam.backend.kf_edges") as _t:
                self._keyframe_edges()
            self.prof["kf_edges"] += _t.seconds
        est = self.frontend.estimates()
        traj_len = 0.0
        mid = -1
        i = self.last_pose_idx + 1
        while i < len(kfs):
            traj_len += float(
                np.linalg.norm(est[i, :2] - est[i - 1, :2])
            )
            if traj_len > self.config.submap_trajectory_length / 2 and mid == -1:
                mid = i
            if traj_len > self.config.submap_trajectory_length:
                break
            i += 1
        if traj_len <= self.config.submap_trajectory_length:
            return
        with self.rec.timed("slam.backend.grid_build") as _t:
            rd = construct_multicloud(
                [k.data for k in kfs], est, self.last_pose_idx, mid, i + 1
            )
            score, pooled, probs, origin, high, high_origin = (
                self._build_grids(rd)
            )
        self.prof["grid_build"] += _t.seconds
        self.submaps.append(
            Submap(
                anchor_idx=mid, score_grid=score, pooled_grid=pooled,
                probs=probs, origin=origin, high_res=high,
                high_origin=high_origin, resolution=self.spec.resolution,
                start_idx=self.last_pose_idx, end_idx=i + 1,
            )
        )
        cfg = self.config
        self._spectra_stack = None
        self._high_stack = None
        self.last_pose_idx = max(0, mid - cfg.submap_overlap_poses)
        if cfg.local_refine:
            with self.rec.timed("slam.backend.chain_edges") as _t:
                self._chain_edges()
            self.prof["chain_edges"] += _t.seconds

    # --------------------------------------------------------------------
    def _ensure_pg_init(self):
        if not self.pg_poses and self.frontend.keyframes:
            k0 = self.frontend.keyframes[0]
            self.pg_poses.append(k0.estimate.copy())
            self.pg_meas.append(np.zeros(3))
            self.pg_info.append(np.eye(3))
            self.last_opt_pose_index = 1

    def _map_transforms(self):
        """trans_pre and per-pose map-frame lookup
        (submap_loop_closer.cpp:144-148)."""
        lm_est = self.frontend.estimates()
        lo = self.last_opt_pose_index
        trans_pre = se2.compose(
            self.pg_poses[lo - 1], se2.inverse(lm_est[lo - 1])
        )

        def map_pose(idx):
            if idx < lo:
                return self.pg_poses[idx]
            return se2.compose(trans_pre, lm_est[idx])

        return map_pose

    # --------------------------------------------------------------------
    def match(self, lock=None) -> bool:
        """Find + apply one loop closure (submap_loop_closer.cpp:118-297).
        Returns True if a closure was accepted. Three phases as in the
        reference's lock discipline: snapshot, search, apply.

        lock: optional mutex guarding frontend state (the realtime
        mode's concurrent frontend). As in the reference's shared-lock
        discipline (submap_loop_closer.cpp:122-157), state is
        snapshotted under the lock, the expensive candidate matching
        runs unlocked, and the apply phase locks again."""
        guard = lock if lock is not None else contextlib.nullcontext()
        with self.rec.timed("slam.backend.match_snapshot") as _t, guard:
            snap = self._match_snapshot()
        self.prof["match_snapshot"] += _t.seconds
        result = None
        if snap is not None:
            with self.rec.timed("slam.backend.match_search") as _t:
                result = self._match_search(snap)  # runs unlocked
            self.prof["match_search"] += _t.seconds
        if result is None:
            return False
        with self.rec.timed("slam.backend.match_apply") as _t, guard:
            self._match_apply(snap, result)
        self.prof["match_apply"] += _t.seconds
        return True

    def _match_snapshot(self):
        """Build the query multiscan + candidate set
        (submap_loop_closer.cpp:122-157)."""
        cfg = self.config
        kfs = self.frontend.keyframes
        n = len(kfs)
        if n <= 2 or len(self.submaps) <= cfg.last_submap_not_match:
            return None
        self._ensure_pg_init()
        est = self.frontend.estimates()

        traj_len = 0.0
        mid = -1
        i = n - 2
        while i >= 0:
            traj_len += float(np.linalg.norm(est[i + 1, :2] - est[i, :2]))
            if traj_len >= cfg.last_traj_length / 2 and mid == -1:
                if i - self.last_opt_pose_index < 2:
                    return None
                mid = i
            if traj_len >= cfg.last_traj_length:
                break
            i -= 1
        i = max(i, 0)
        if mid < 0:
            return None

        query = construct_multicloud(
            [k.data for k in kfs], est, i, mid, n, returns_only=True
        )
        if len(query) == 0:
            return None
        map_pose = self._map_transforms()
        bl_trans = map_pose(mid)
        max_range = float(np.linalg.norm(query, axis=1).max())
        if self.accel_branch:
            # the rotation count frozen at range_max (its finest angular
            # step: a superset of the rotations)
            max_range = cfg.range_max
        spec = matching.search_spec(
            cfg.linear_search_window,
            cfg.angular_search_window,
            max_range,
            cfg.submap_resolution,
        )

        eit = len(self.submaps) - cfg.last_submap_not_match
        candidates = []
        for sm in self.submaps[:eit]:
            anchor = map_pose(sm.anchor_idx)
            if (
                np.linalg.norm(bl_trans[:2] - anchor[:2])
                >= cfg.max_match_distance
            ):
                continue
            # estimated relative pose anchor -> query mid: the search
            # window covers +-linear_search_window of DRIFT around this
            # estimate (fast_correlative_scan_matcher_2d.cc:480-507),
            # implemented by shifting the candidate's grid origin
            t_est = se2.relative(anchor, bl_trans)[:2]
            candidates.append(
                (
                    sm,
                    float(se2.wrap_angle(bl_trans[2] - anchor[2])),
                    t_est,
                )
            )
        if not candidates:
            return None
        return dict(query=query, spec=spec, candidates=candidates, mid=mid)

    def _shifted_origins(self, candidates):
        """Each candidate's grid origin minus its t_est, in float32."""
        return [
            c[0].origin - torch.tensor(np.asarray(c[2], np.float32),
                                       device=self.device)
            for c in candidates
        ]

    def _refine_query(self, caller: str, query):
        """_padded_query of a refinement's query, tallied under
        refine.n as (caller, padded N): one per refinement launch."""
        pts, valid = _padded_query(query, self.device)
        self.rec.tally("refine.n", (caller, int(pts.shape[0])))
        return pts, valid

    def _refine_high(self, sm: Submap, query, pose):
        """High-res refinement of a correlative match (the Ceres
        replacement): (refined (3,), censi_cov (3,3)) on the host."""
        refined, censi_cov, _ = matching.refine_pose_cov(
            sm.high_res, sm.high_origin, 0.05,
            *self._refine_query("closure", query),
            torch.tensor(np.asarray(pose, np.float32), device=self.device),
        )
        return _host(refined, censi_cov)

    def _match_fn(self, candidates):
        """The candidate-set matcher: the pruned matcher, or with the
        accelerator branch the fused one-call matcher (chunks of 16
        candidates, K = 256 planes a call) on the candidates' cached
        spectra."""
        if not self.accel_branch:
            return matching.match_candidates_pruned
        fft_size = int(candidates[0][0].score_grid.shape[0]) + 64
        return functools.partial(
            matching.match_candidates_fused, c_bucket=16, K=256,
            spectra_list=[c[0].get_spectrum(fft_size) for c in candidates],
        )

    def _match_search(self, snap):
        """Candidate matching + high-res refinement."""
        cfg = self.config
        query = snap["query"]
        spec = snap["spec"]
        candidates = snap["candidates"]
        # the ctpl-pool fan-out of submap_loop_closer.cpp:158-171 as
        # exact upper-bound rotation pruning + FFT correlation, candidate
        # by candidate (the running-best floor prunes later ones), or
        # the fused matcher (_match_fn)
        stride = 1 << (max(1, cfg.branch_and_bound_depth) - 1)
        origins = self._shifted_origins(candidates)
        match_fn = self._match_fn(candidates)

        def run(min_score):
            return match_fn(
                [c[0].score_grid for c in candidates],
                [c[0].pooled_grid for c in candidates],
                origins,
                [c[1] for c in candidates],
                query, spec, float(min_score), stride,
            )

        if self.match_mesh is not None:
            ci, score, pose, cov = matching.match_candidates_sharded(
                [c[0].score_grid for c in candidates], origins,
                [c[1] for c in candidates], query, spec, self.match_mesh,
                float(self.loop_closure_min_score))
        else:
            with self.rec.timed("slam.backend.match_correlate") as _t:
                ci, score, pose, cov = run(self.loop_closure_min_score)
            self.prof["match_correlate"] += _t.seconds
        self.match_calls += len(candidates)
        if os.environ.get("SLAM_LOG_MATCHES"):
            # match-score progress lines like the reference's stdout
            # (submap_loop_closer.cpp:174); on a miss, re-run with a low
            # floor to report the best sub-threshold score
            if ci is None:
                dci, dscore, _, _ = run(0.30)
                print(
                    f"[match] mid={snap['mid']} cands={len(candidates)} "
                    f"MISS best={dscore if dci is not None else '<0.30'}"
                    + (
                        f" (submap anchor={candidates[dci][0].anchor_idx})"
                        if dci is not None
                        else ""
                    ),
                    flush=True,
                )
            else:
                drift = np.asarray(pose[:2], np.float64)
                print(
                    f"[match] mid={snap['mid']} cands={len(candidates)} "
                    f"HIT score={score:.3f} "
                    f"anchor={candidates[ci][0].anchor_idx} "
                    f"offset={np.linalg.norm(drift):.2f}m",
                    flush=True,
                )
        if ci is None:
            return None
        sm = candidates[ci][0]
        # matcher pose is drift around the estimate; full relative
        # translation = t_est + matched offset
        pose = np.asarray(pose, np.float64).copy()
        pose[:2] += np.asarray(candidates[ci][2], np.float64)

        with self.rec.timed("slam.backend.match_refine") as _t:
            refined, censi_cov = self._refine_high(sm, query, pose)
        self.prof["match_refine"] += _t.seconds
        cov = self._closure_cov(censi_cov, cov)

        along_drift, sigma_along, reject = self._ridge_drift_gate(
            cov, refined, np.asarray(candidates[ci][2], np.float64)
        )
        if reject:
            if os.environ.get("SLAM_LOG_MATCHES"):
                print(
                    f"[match] mid={snap['mid']} REJECT ridge-drift "
                    f"anchor={sm.anchor_idx} along={along_drift:.2f}m "
                    f"(sigma_along={sigma_along:.2f})",
                    flush=True,
                )
            self.ridge_drift_rejects += 1
            return None
        return dict(
            sm=sm, refined=refined, cov=cov,
            along_drift=along_drift, sigma_along=sigma_along,
        )

    def _ridge_drift_gate(self, cov, refined, t_est):
        """Along-ridge drift arbitration: project the accepted
        measurement's drift from the graph prediction (search center
        t_est) onto the WIDE axis of its own covariance; where the score
        surface declared itself ambiguous (sigma_along >
        closure_ridge_sigma), a large claimed correction along that
        axis is an alias (see utils/config.closure_ridge_max_drift).

        Returns (along_drift, sigma_along, reject)."""
        cfg = self.config
        tcov = 0.5 * (cov[:2, :2] + cov[:2, :2].T)
        w_e, V_e = np.linalg.eigh(tcov)
        sigma_along = float(np.sqrt(max(w_e[1], 0.0)))
        along_drift = float(
            abs((np.asarray(refined[:2], np.float64) - t_est) @ V_e[:, 1])
        )
        max_ad = cfg.closure_ridge_max_drift
        reject = bool(
            max_ad > 0
            and sigma_along > cfg.closure_ridge_sigma
            and along_drift > max_ad
        )
        return along_drift, sigma_along, reject

    def _closure_cov(self, censi_cov: np.ndarray, win_cov: np.ndarray):
        """Closure covariance = high-res GN (Censi) measurement
        covariance + the EXCESS score-surface ambiguity of the
        correlative window + a small floor; a match whose window
        moments report a translational ridge keeps the window
        covariance (or its ridge-inflated form). closure_cov_mode=
        "window" is the window covariance alone."""
        cfg = self.config
        if cfg.closure_cov_mode == "window":
            return win_cov
        w_t = np.linalg.eigvalsh(win_cov[:2, :2])
        if float(np.sqrt(w_t.max())) > cfg.closure_ridge_sigma:
            if cfg.closure_ridge_mode == "inflate":
                return self._ridge_inflate(win_cov)
            return win_cov
        return self._cov_hybrid(
            censi_cov, win_cov, 0.01,
            cfg.closure_sigma_xy, cfg.closure_sigma_th,
        )

    def _ridge_inflate(self, win_cov: np.ndarray) -> np.ndarray:
        """Inflate every translational eigendirection wider than the
        ridge threshold to at least the uniform-over-window variance
        L^2/3; cross-ridge and rotation keep their measured values."""
        cfg = self.config
        L = cfg.linear_search_window
        ridge_var = L * L / 3.0
        t = 0.5 * (win_cov[:2, :2] + win_cov[:2, :2].T)
        w, V = np.linalg.eigh(t)
        w2 = np.where(
            np.sqrt(np.maximum(w, 0.0)) > cfg.closure_ridge_sigma,
            np.maximum(w, ridge_var),
            w,
        )
        out = win_cov.copy()
        out[:2, :2] = V @ np.diag(w2) @ V.T
        return out

    def _cov_hybrid(self, censi_cov, win_cov, angular_step,
                    floor_xy, floor_th):
        """Censi + above-floor window excess + floor (see _closure_cov).
        The window floor (2.5 cells / 2.5 rotation steps) matches the
        calibration floor window_cov/score_volume_cov always add."""
        res = self.spec.resolution
        f = np.array(
            [2.5 * res, 2.5 * res, 2.5 * angular_step], np.float64
        )
        Fi = np.diag(1.0 / f)
        M = Fi @ win_cov @ Fi
        M = 0.5 * (M + M.T)
        w, V = np.linalg.eigh(M)
        excess = (
            np.diag(f) @ V @ np.diag(np.maximum(w - 1.0, 0.0)) @ V.T
            @ np.diag(f)
        )
        floor = np.diag([floor_xy**2, floor_xy**2, floor_th**2])
        return censi_cov + excess + floor

    def _pooled_grid_host(self, sm: Submap):
        if sm.pooled_np is None:
            sm.pooled_np = sm.pooled_grid.cpu().numpy().astype(np.float64)
        return sm.pooled_np

    def _pin_match_grid(self, sm: Submap, query, seed):
        """Small-window exhaustive correlative match of a short query
        against one submap, centered on the pose-estimate seed -- the
        per-keyframe pin measurement: exact pooled bound first, then
        the window correlation of the score grid (the kernel on the
        card, numpy on the CPU), then _pin_accept on the high-res grid.
        Returns (refined, cov, score, None) or (None, None, None,
        reason)."""
        cfg = self.config
        res = float(sm.resolution)
        max_range = float(np.linalg.norm(query, axis=1).max())
        spec = matching.search_spec(
            cfg.kf_search_window, cfg.kf_angular_window, max_range, res
        )
        origin = _host(sm.origin)[0] - seed[:2]
        ks = np.arange(-spec.n_angular, spec.n_angular + 1)
        thetas = seed[2] + ks * spec.angular_step
        stride = 1 << (max(1, cfg.branch_and_bound_depth) - 1)
        if stride >= 2 * spec.n_linear:
            # exact B&B-root bound from the pooled pyramid level (see
            # pin_bound_host for the coverage at stride == 2*n_linear)
            with self.rec.timed("slam.backend.pin_bound") as _t:
                bound = matching.pin_bound_host(
                    self._pooled_grid_host(sm), origin, res, query, thetas,
                    spec.n_linear, stride=stride,
                )
            self.prof["pin_bound"] += _t.seconds
            if bound < cfg.kf_min_score:
                return None, None, None, "bound"
        # ends in the volume's host read, so it times the kernel too
        with self.rec.timed("slam.backend.pin_window") as _t:
            scores = matching.correlate_window(
                sm.score_grid, origin, res, query, thetas, spec.n_linear,
                self.rec,
            )
        self.prof["pin_window"] += _t.seconds
        return self._pin_accept(scores, thetas, spec, seed, sm, query, res)

    def _pin_accept(self, scores, thetas, spec, seed, sm: Submap, query,
                    res):
        """Pin acceptance from a computed (R, W, W) score volume:
        centered-tie-break argmax, score gate, band-weighted volume
        covariance, GN refinement on the high-res grid, overlap + basin
        gates, hybrid covariance."""
        cfg = self.config
        with self.rec.timed("slam.backend.pin_cov") as _t:
            k, i, jx = matching._argmax_center_tiebreak(scores,
                                                        spec.n_linear)
            sc = float(scores[k, i, jx])
            wcov = (matching.score_volume_cov(scores, thetas, seed[2], res,
                                              spec.n_linear)
                    if sc >= cfg.kf_min_score else None)
        self.prof["pin_cov"] += _t.seconds
        if wcov is None:
            return None, None, None, "score"
        pose0 = np.array(
            [
                (i - spec.n_linear) * res + seed[0],
                (jx - spec.n_linear) * res + seed[1],
                thetas[k],
            ]
        )
        # ends in the host read, so it times the kernel too
        with self.rec.timed("slam.backend.pin_refine") as _t:
            refined, censi, probs = matching.refine_pose_cov(
                sm.high_res, sm.high_origin, 0.05,
                *self._refine_query("pin", query),
                torch.tensor(pose0.astype(np.float32), device=self.device),
            )
            refined, censi, probs = _host(refined, censi, probs)
        self.prof["pin_refine"] += _t.seconds
        # fraction of query points on occupied high-res cells at the
        # refined pose
        if float((probs[: len(query)] > 0.55).mean()) < cfg.kf_min_overlap:
            return None, None, None, "score"
        # refinement polishes sub-cell; a larger move left the
        # correlative peak's basin
        if (
            np.linalg.norm(refined[:2] - pose0[:2]) > 0.3
            or abs(se2.wrap_angle(refined[2] - pose0[2])) > 0.1
        ):
            return None, None, None, "corr"
        cov = self._cov_hybrid(
            censi, wcov, spec.angular_step,
            cfg.kf_refine_sigma_xy, cfg.kf_refine_sigma_th,
        )
        return refined, cov, sc, None

    def extend_chain(self):
        """Extend the pose-graph chain to the CURRENT keyframe count and
        prune the landmark-graph window to one fixed pose
        (submap_loop_closer.cpp:204-225, 256-270). Called at closure
        apply and at final cleanup. Each chain edge carries raw
        odometry information, or with chain_info_mode="marginal" the
        landmark-posterior marginal (frontend.relative_chain_info)
        where there is one."""
        self._ensure_pg_init()
        if not self.pg_poses:
            return
        kfs = self.frontend.keyframes
        est = self.frontend.estimates()
        n = len(kfs)
        marg = {}
        if (
            self.config.chain_info_mode == "marginal"
            and n > self.last_opt_pose_index
        ):
            marg = self.frontend.relative_chain_info(
                self.last_opt_pose_index, n
            )
        for idx in range(self.last_opt_pose_index, n):
            meas = se2.relative(est[idx - 1], est[idx])
            self.pg_meas.append(meas)
            self.pg_info.append(marg.get(idx, kfs[idx].odom_info).copy())
            self.pg_poses.append(se2.compose(self.pg_poses[-1], meas))
        if n > self.last_opt_pose_index:
            self.last_opt_pose_index = n
            self.frontend.window_start = max(
                1, self.last_opt_pose_index - 1
            )
            # retire the window's observation edges into the archive
            # before pruning the active landmark graph to one fixed pose
            self.frontend.archived_obs.extend(self.frontend.obs_edges)
            self.frontend.obs_edges.clear()
            self.frontend.last_landmark_edge = 0
            self.frontend.need_reinit = True

    def _match_apply(self, snap, result):
        """Extend the pose-graph chain, add the DCS closure edge
        (submap_loop_closer.cpp:272-285) and optimize."""
        sm = result["sm"]
        self.extend_chain()
        self.closures.append(
            Closure(
                i=sm.anchor_idx,
                j=snap["mid"],
                meas=result["refined"],
                info=np.linalg.inv(result["cov"]),
                along_drift=result["along_drift"],
                sigma_along=result["sigma_along"],
            )
        )
        self.optimize(iterations=20)

    # --------------------------------------------------------------------
    def _refine_on_submap(self, sm: Submap, query: np.ndarray, seed,
                          max_correction: float, min_overlap: float,
                          high_res: bool = False):
        """Two-stage GN refinement of query points against a submap's
        grids, seeded at the current pose estimate: first on the
        dilated score grid (wide convergence basin), then on the raw
        probability grid (unbiased), or with high_res on the 0.05 m
        high-res grid (refine_map's polish); Censi covariance from the
        second stage's GN Hessian.

        Returns (refined (3,), cov (3,3), overlap) on success or
        (None, reason, None) where reason is a stats-counter key."""
        fine = ((sm.high_res, sm.high_origin, 0.05) if high_res
                else (sm.probs, sm.origin, float(sm.resolution)))
        # high_res only under refine_map; the chain edges refine on the
        # probability grid
        refined, cov, probs = matching.refine_pose_cov_two_stage(
            sm.score_grid, sm.origin, float(sm.resolution), *fine,
            *self._refine_query("map" if high_res else "chain", query),
            torch.tensor(np.asarray(seed, np.float32), device=self.device),
        )
        refined, cov, probs = _host(refined, cov, probs)
        # reject a jump the pose estimate cannot plausibly have drifted
        if (
            np.linalg.norm(refined[:2] - seed[:2]) > max_correction
            or abs(se2.wrap_angle(refined[2] - seed[2])) > 0.35
        ):
            return None, "corr", None
        # overlap gate: fraction of query points landing on occupied
        # (dilated) cells at the refined pose
        overlap = float((probs[: len(query)] > 0.55).mean())
        if overlap < min_overlap:
            return None, "score", None
        return refined, cov, overlap

    # --------------------------------------------------------------------
    def _keyframe_edges(self) -> int:
        """Per-keyframe pins: small-window EXHAUSTIVE correlative match
        of a short multicloud around each completed keyframe against
        the newest finalized submap that did not include it, gated by
        score >= kf_min_score and high-res overlap >= kf_min_overlap
        (new-engine capability, no reference counterpart). The CPU
        branch of the JAX package: host numpy window correlation
        (_kf_edges_host)."""
        cfg = self.config
        if not cfg.kf_refine or not self.submaps:
            return 0
        kfs = self.frontend.keyframes
        self._ensure_pg_init()
        map_pose = self._map_transforms()
        # a keyframe's scan store is complete once its successor exists
        last_complete = len(kfs) - 1
        est_arr = None
        pending = []
        for j in range(self._kf_edge_done, last_complete):
            smi = None
            for si in range(len(self.submaps) - 1, -1, -1):
                if self.submaps[si].end_idx <= j:
                    smi = si
                    break
            if smi is None:
                self._kf_stat("no_submap")
                continue
            # query = short multicloud centered on j (a single 11-beam
            # keyframe store aliases to its neighbour's beam pattern)
            if est_arr is None:
                est_arr = np.stack(
                    [map_pose(k) for k in range(len(kfs))]
                )
            query = construct_multicloud(
                [k.data for k in kfs], est_arr, max(0, j - 1), j,
                min(j + 2, len(kfs)), returns_only=True,
            )
            if len(query) < 12:
                self._kf_stat("few_points")
                continue
            if len(query) > 512:  # bound the GN cost
                query = query[
                    np.linspace(0, len(query) - 1, 512).astype(int)
                ]
            seed = se2.relative(
                map_pose(self.submaps[smi].anchor_idx), map_pose(j)
            )
            pending.append((j, smi, query, seed))
        self._kf_edge_done = max(self._kf_edge_done, last_complete)
        if not pending:
            return 0
        if self.accel_branch:
            return self._kf_edges_device(pending)
        return self._kf_edges_host(pending)

    def _kf_edges_host(self, pending) -> int:
        """One pin at a time: _pin_match_grid, then _pin_finish."""
        made = 0
        for j, smi, query, seed in pending:
            sm = self.submaps[smi]
            refined, cov, score, why = self._pin_match_grid(sm, query, seed)
            made += self._pin_finish(j, sm, query, refined, cov,
                                     score, why)
        return made

    def _kf_edges_device(self, pending) -> int:
        """The accelerator branch's pins: matching.pin_eval_batch scores
        the windows on the cached spectra, takes the argmax, the volume
        covariance, the high-res refinement and the overlap for up to 8
        pins at once into one (8, 26) block, read back once; the host
        keeps only the accept gates (_pin_accept_packed). The rotation
        set is frozen at range_max, as _match_snapshot's."""
        cfg = self.config
        res = float(self.spec.resolution)
        spec = matching.search_spec(
            cfg.kf_search_window, cfg.kf_angular_window, cfg.range_max, res,
        )
        R = 2 * spec.n_angular + 1
        ks = np.arange(R) - spec.n_angular
        size = self.spec.size
        fft_size = size + 64
        with self.rec.timed("slam.backend.kf_stack") as _t:
            spectra = self._get_spectra_stack(fft_size)
            high_stack, high_origins = self._get_high_stack()
        self.prof["kf_stack"] += _t.seconds
        made = 0
        B = 8
        for lo in range(0, len(pending), B):
            chunk = pending[lo:lo + B]
            with self.rec.timed("slam.backend.kf_window") as _t:
                pts = np.zeros((B, 512, 2), np.float32)
                val = np.zeros((B, 512), bool)
                orgs = np.zeros((B, 2), np.float32)
                seeds = np.zeros((B, 3), np.float32)
                ths = np.zeros((B, R), np.float32)
                ids = np.zeros(B, np.int64)
                live = np.zeros(B, bool)
                for k, (j, smi, query, seed) in enumerate(chunk):
                    pts[k, :len(query)] = query
                    val[k, :len(query)] = True
                    orgs[k] = _host(self.submaps[smi].origin)[0] - seed[:2]
                    seeds[k] = seed
                    ths[k] = seed[2] + ks * spec.angular_step
                    ids[k] = smi
                    live[k] = True
                t = pin_batch_from_numpy(
                    dict(ids=ids, orgs=orgs, seeds=seeds, pts=pts, val=val,
                         ths=ths, live=live), self.device)
                out = matching.pin_eval_batch(
                    spectra, high_stack, high_origins, t["ids"], t["orgs"],
                    t["seeds"], t["pts"], t["val"], t["ths"], t["live"],
                    resolution=res, n_linear=int(spec.n_linear),
                    size=int(size), fft_size=int(fft_size),
                ).cpu().numpy()
            self.prof["kf_window"] += _t.seconds
            with self.rec.timed("slam.backend.kf_accept") as _t:
                for k, (j, smi, query, seed) in enumerate(chunk):
                    refined, cov, score, why = self._pin_accept_packed(
                        out[k], spec, cfg.kf_min_score, cfg.kf_min_overlap,
                        cfg.kf_refine_sigma_xy, cfg.kf_refine_sigma_th,
                    )
                    made += self._pin_finish(j, self.submaps[smi], query,
                                             refined, cov, score, why)
            self.prof["kf_accept"] += _t.seconds
        return made

    def _pin_accept_packed(self, row, spec, min_score, min_overlap,
                           floor_xy, floor_th):
        """_pin_accept's gates on one pin_eval_batch row [score, pose0
        (3), wcov (9), refined (3), censi (9), overlap]."""
        sc = float(row[0])
        if sc < min_score:
            return None, None, None, "score"
        pose0 = row[1:4]
        wcov = row[4:13].reshape(3, 3)
        refined = row[13:16].copy()
        censi = row[16:25].reshape(3, 3)
        overlap = float(row[25])
        if min_overlap > 0.0 and overlap < min_overlap:
            return None, None, None, "score"
        if (
            np.linalg.norm(refined[:2] - pose0[:2]) > 0.3
            or abs(se2.wrap_angle(refined[2] - pose0[2])) > 0.1
        ):
            return None, None, None, "corr"
        cov = self._cov_hybrid(
            censi, wcov, spec.angular_step, floor_xy, floor_th,
        )
        return refined, cov, sc, None

    @staticmethod
    def _stack_size(n: int) -> int:
        """Stacks are padded to a power of two from 32 submaps."""
        m = 32
        while m < n:
            m *= 2
        return m

    def _get_spectra_stack(self, fft_size: int):
        """(M, F, F//2+1) device stack of every submap's cached
        spectrum, padded with the last to _stack_size."""
        n = len(self.submaps)
        if self._spectra_stack is None or self._spectra_stack[0] != n:
            arrs = [sm.get_spectrum(fft_size) for sm in self.submaps]
            arrs += [arrs[-1]] * (self._stack_size(n) - n)
            self._spectra_stack = (n, torch.stack(arrs))
        return self._spectra_stack[1]

    def _get_high_stack(self):
        """(M, G2, G2) device stack of the high-res grids and their
        (M, 2) origins, padded as _get_spectra_stack."""
        n = len(self.submaps)
        if self._high_stack is None or self._high_stack[0] != n:
            pad = self._stack_size(n) - n
            grids = [sm.high_res for sm in self.submaps]
            origs = [sm.high_origin.to(torch.float32) for sm in self.submaps]
            self._high_stack = (n, torch.stack(grids + grids[-1:] * pad),
                                torch.stack(origs + origs[-1:] * pad))
        return self._high_stack[1], self._high_stack[2]

    def _kf_stat(self, key: str) -> None:
        """One more pin outcome `key` in kf_stats and in the counter
        pins.<key>, so that the two agree."""
        self.kf_stats[key] += 1
        self.rec.count("pins." + key)

    def _pin_finish(self, j, sm, query, refined, cov, score, why) -> int:
        """Book a pin result: count the reject reason or append the
        closure edge."""
        if refined is None:
            self._kf_stat(why)
            return 0
        self.closures.append(
            Closure(
                i=sm.anchor_idx, j=j, meas=refined,
                info=np.linalg.inv(cov), kind="kf",
            )
        )
        self._kf_stat("accepted")
        if os.environ.get("SLAM_LOG_MATCHES"):
            print(
                f"[kfpin] kf{sm.anchor_idx}->kf{j} n={len(query)} "
                f"score={score:.2f}",
                flush=True,
            )
        return 1

    # --------------------------------------------------------------------
    def _chain_edges(self) -> int:
        """Submap chain edges (new-engine capability): right after a new
        submap finalizes, GN-refine its multicloud (restricted to
        keyframes the target did NOT see) against the previous
        `local_refine_hops` submaps' grids, seeded at the current pose
        estimates; accepted only if the refined pose stays near the seed
        AND enough query points land on occupied target cells, and
        skipped where the landmark frontend already covers the span."""
        cfg = self.config
        stats = self.local_stats
        kfs = self.frontend.keyframes
        new = self.submaps[-1]
        if len(self.submaps) < 2:
            stats["no_submap"] += 1
            return 0
        self._ensure_pg_init()
        map_pose = self._map_transforms()
        bl = map_pose(new.anchor_idx)
        est = self.frontend.estimates()
        # coarse work-skip only (the real gate is the overlap fraction)
        max_dist = cfg.local_refine_max_dist or (
            cfg.range_max + 2.0 * cfg.submap_trajectory_length
        )
        made = 0
        hops = min(cfg.local_refine_hops, len(self.submaps) - 1)
        for hop in range(1, hops + 1):
            prev = self.submaps[-1 - hop]
            qs = max(new.start_idx, prev.end_idx)
            qe = new.end_idx
            if qe - qs < 2:
                stats["few_points"] += 1
                continue
            if (
                np.linalg.norm(bl[:2] - map_pose(prev.anchor_idx)[:2])
                > max_dist
            ):
                stats["dist"] += 1
                continue
            # landmark-coverage gate: where the frontend has solid
            # observations over the query span, its relative estimates
            # beat a scan-to-submap edge
            obs = [
                e
                for e in self.frontend.obs_edges
                if qs <= e.pose_idx < qe
            ]
            if (
                len(obs) >= cfg.local_refine_lm_cover * (qe - qs)
                and len({e.lm_idx for e in obs}) >= 2
            ):
                stats["covered"] += 1
                continue
            query = construct_multicloud(
                [k.data for k in kfs], est, qs, new.anchor_idx, qe,
                returns_only=True,
            )
            if len(query) < 12:
                stats["few_points"] += 1
                continue
            if len(query) > 512:  # bound the GN cost
                query = query[
                    np.linspace(0, len(query) - 1, 512).astype(int)
                ]
            seed = se2.relative(map_pose(prev.anchor_idx), bl)
            refined, cov, overlap = self._refine_on_submap(
                prev, query, seed, cfg.local_refine_max_correction,
                cfg.local_refine_min_overlap,
            )
            if refined is None:
                stats[cov] += 1
                continue
            cov += np.diag(
                [
                    cfg.local_refine_sigma_xy**2,
                    cfg.local_refine_sigma_xy**2,
                    cfg.local_refine_sigma_th**2,
                ]
            )
            self.closures.append(
                Closure(
                    i=prev.anchor_idx, j=new.anchor_idx, meas=refined,
                    info=np.linalg.inv(cov), kind="local",
                )
            )
            stats["accepted"] += 1
            made += 1
            if os.environ.get("SLAM_LOG_MATCHES"):
                sig = np.sqrt(np.diag(cov))
                print(
                    f"[chain] kf{prev.anchor_idx}->kf{new.anchor_idx} "
                    f"hop={hop} n={len(query)} overlap={overlap:.2f} "
                    f"corr=({refined[0]-seed[0]:+.3f},"
                    f"{refined[1]-seed[1]:+.3f},"
                    f"{se2.wrap_angle(refined[2]-seed[2]):+.3f}) "
                    f"sigma=({sig[0]:.3f},{sig[1]:.3f},{sig[2]:.3f})",
                    flush=True,
                )
        return made

    # --------------------------------------------------------------------
    def refine_map(self, rounds: int = 1, iterations: int = 40,
                   gnc_scale: float = 1.0) -> None:
        """Iterative map refinement (final_cleanup with
        config.final_refine_rounds, after the global re-match sweep):
        rebuild every submap's grids from the current optimized poses,
        re-measure every active loop/local edge with a seeded two-stage
        refinement (the dilated grid, then the 0.05 m high-res grid)
        and the exhaustive window's ambiguity covariance against the
        rebuilt grids, and re-solve. Match-time stitching distortion of
        the query multicloud and the target grid dominates a closure's
        measurement error; after a global solve the poses are better,
        so re-building and re-measuring shrinks that term."""
        cfg = self.config
        kfs = self.frontend.keyframes
        if not self.submaps or len(self.pg_poses) < 2:
            return
        with self.rec.timed("slam.backend.refine_map") as _t:
            for _ in range(max(0, rounds)):
                map_pose = self._map_transforms()
                est_arr = np.stack([map_pose(k) for k in range(len(kfs))])
                self.rebuild_grids(est_arr)
                by_anchor = {sm.anchor_idx: sm for sm in self.submaps}
                n = len(self.pg_poses)
                for c in self.closures:
                    if not c.active or c.kind == "kf":
                        continue
                    if c.i not in by_anchor or c.i >= n or c.j >= n:
                        continue
                    sm = by_anchor[c.i]
                    # a short query window around the j endpoint (a query
                    # multicloud's mid, or another submap's anchor after
                    # rematch_all)
                    query = construct_multicloud(
                        [k.data for k in kfs], est_arr, max(0, c.j - 3), c.j,
                        min(len(kfs), c.j + 4), returns_only=True,
                    )
                    if len(query) < 12:
                        continue
                    if len(query) > 512:
                        query = query[
                            np.linspace(0, len(query) - 1, 512).astype(int)
                        ]
                    # seeded at the current estimate, within ~0.1 m of the
                    # truth after the solve: no basin to escape, and no
                    # window argmax, which would reproduce the estimate
                    seed = se2.relative(est_arr[c.i], est_arr[c.j])
                    refined, censi, _ = self._refine_on_submap(
                        sm, query, seed, 0.4, 0.0, high_res=True
                    )
                    if refined is None:
                        continue
                    # ambiguity (ridge) covariance from the exhaustive
                    # window around the refined pose
                    res = float(sm.resolution)
                    spec = matching.search_spec(
                        cfg.kf_search_window, cfg.kf_angular_window,
                        float(np.linalg.norm(query, axis=1).max()), res,
                    )
                    ks = np.arange(-spec.n_angular, spec.n_angular + 1)
                    thetas = refined[2] + ks * spec.angular_step
                    scores = matching.correlate_window(
                        sm.score_grid, _host(sm.origin)[0] - refined[:2],
                        res, query, thetas, spec.n_linear, self.rec,
                    )
                    wcov = matching.score_volume_cov(
                        scores, thetas, refined[2], res, spec.n_linear
                    )
                    cov = self._cov_hybrid(
                        censi, wcov, spec.angular_step,
                        cfg.closure_sigma_xy, cfg.closure_sigma_th,
                    )
                    c.meas = refined
                    c.info = np.linalg.inv(cov)
                self.optimize(iterations=iterations, gnc_scale=gnc_scale)
        self.prof["refine_map"] += _t.seconds

    # --------------------------------------------------------------------
    def rebuild_grids(self, est_arr: np.ndarray) -> None:
        """Rebuild every submap's grids from the given keyframe poses
        (the final re-match sweep's targets, so they align with its
        queries, which are stitched from the same post-optimization
        estimates)."""
        kfs = self.frontend.keyframes
        for sm in self.submaps:
            rd = construct_multicloud(
                [k.data for k in kfs], est_arr, sm.start_idx,
                sm.anchor_idx, min(sm.end_idx, len(kfs)),
            )
            (sm.score_grid, sm.pooled_grid, sm.probs, sm.origin,
             sm.high_res, sm.high_origin) = self._build_grids(rd)
            sm.pooled_np = None
            sm.spectrum = None
        self._spectra_stack = None
        self._high_stack = None

    # --------------------------------------------------------------------
    def rematch_all(self) -> int:
        """Global re-match sweep (final_cleanup with
        config.final_rematch): every submap's multicloud is matched
        against every non-overlapping submap within max_match_distance,
        at the live min_score minus rematch_score_margin (floored at
        0.5), keeping only SHARP matches (rematch_skip_ridge). Returns
        the number of closures added."""
        cfg = self.config
        kfs = self.frontend.keyframes
        if len(self.submaps) < 2 or not kfs:
            return 0
        self._ensure_pg_init()
        self.extend_chain()
        map_pose = self._map_transforms()
        est_arr = np.stack([map_pose(k) for k in range(len(kfs))])
        if cfg.final_rebuild_grids:
            with self.rec.timed("slam.backend.grid_build") as _t:
                self.rebuild_grids(est_arr)
            self.prof["grid_build"] += _t.seconds
        have = {
            (c.i, c.j)
            for c in self.closures
            if c.kind == "loop" and c.active
        }
        stride = 1 << (max(1, cfg.branch_and_bound_depth) - 1)
        min_sc = max(
            0.5, cfg.loop_closure_min_score - cfg.rematch_score_margin
        )
        made = 0
        for qi, qsm in enumerate(self.submaps):
            q_anchor = est_arr[qsm.anchor_idx]
            query = construct_multicloud(
                [k.data for k in kfs], est_arr, qsm.start_idx,
                qsm.anchor_idx, qsm.end_idx, returns_only=True,
            )
            if len(query) < 12:
                continue
            if len(query) > 512:
                query = query[
                    np.linspace(0, len(query) - 1, 512).astype(int)
                ]
            max_range = float(np.linalg.norm(query, axis=1).max())
            if self.accel_branch:
                max_range = cfg.range_max  # as _match_snapshot's
            spec = matching.search_spec(
                cfg.linear_search_window, cfg.angular_search_window,
                max_range, cfg.submap_resolution,
            )
            cands = []
            for ti, tsm in enumerate(self.submaps):
                if tsm.end_idx > qsm.start_idx and (
                    tsm.start_idx < qsm.end_idx
                ):
                    continue  # keyframe ranges overlap
                if abs(ti - qi) <= cfg.last_submap_not_match:
                    continue
                if (tsm.anchor_idx, qsm.anchor_idx) in have or (
                    qsm.anchor_idx, tsm.anchor_idx
                ) in have:
                    continue
                anchor = est_arr[tsm.anchor_idx]
                if (
                    np.linalg.norm(q_anchor[:2] - anchor[:2])
                    >= cfg.max_match_distance
                ):
                    continue
                t_est = se2.relative(anchor, q_anchor)[:2]
                cands.append(
                    (
                        tsm,
                        float(se2.wrap_angle(q_anchor[2] - anchor[2])),
                        t_est,
                    )
                )
            if not cands:
                continue
            ci, score, pose, cov = self._match_fn(cands)(
                [c[0].score_grid for c in cands],
                [c[0].pooled_grid for c in cands],
                self._shifted_origins(cands),
                [c[1] for c in cands],
                query, spec, float(min_sc), stride,
            )
            if ci is None:
                continue
            tsm = cands[ci][0]
            pose = np.asarray(pose, np.float64).copy()
            pose[:2] += np.asarray(cands[ci][2], np.float64)
            refined, censi_cov = self._refine_high(tsm, query, pose)
            if cfg.rematch_skip_ridge:
                # sweep-only gate: keep only SHARP (junction/corner)
                # anchors; rematch_ridge_gate relaxes it to the
                # along-ridge drift arbitration
                w_t = np.linalg.eigvalsh(np.asarray(cov)[:2, :2])
                if float(np.sqrt(w_t.max())) > cfg.closure_ridge_sigma:
                    if not cfg.rematch_ridge_gate:
                        continue
                    _, _, rej = self._ridge_drift_gate(
                        np.asarray(cov, np.float64), refined,
                        np.asarray(cands[ci][2], np.float64),
                    )
                    if rej:
                        self.ridge_drift_rejects += 1
                        continue
            cov = self._closure_cov(censi_cov, cov)
            self.closures.append(
                Closure(
                    i=tsm.anchor_idx, j=qsm.anchor_idx, meas=refined,
                    info=np.linalg.inv(cov),
                )
            )
            have.add((tsm.anchor_idx, qsm.anchor_idx))
            made += 1
            if os.environ.get("SLAM_LOG_MATCHES"):
                print(
                    f"[rematch] kf{tsm.anchor_idx}->kf{qsm.anchor_idx} "
                    f"score={score:.3f}",
                    flush=True,
                )
        return made

    # --------------------------------------------------------------------
    def _build_pg_data(self):
        """The pose graph as fixed-shape tensors on the backend's
        device: N = _bucket(n, bucket_min_pg) poses, C = _bucket(#
        closures) closure slots, masked."""
        n = len(self.pg_poses)
        N = _bucket(n, self.config.bucket_min_pg)
        C = _bucket(max(len(self.closures), 1))
        poses = np.zeros((N, 3))
        valid = np.zeros(N, bool)
        fixed = np.zeros(N, bool)
        chain_meas = np.zeros((N, 3))
        chain_info = np.tile(np.eye(3), (N, 1, 1))
        chain_valid = np.zeros(N, bool)
        poses[:n] = np.stack(self.pg_poses)
        valid[:n] = True
        fixed[0] = True
        chain_meas[1:n] = np.stack(self.pg_meas[1:])
        chain_info[1:n] = np.stack(self.pg_info[1:])
        chain_valid[1:n] = True

        clo_i = np.zeros(C, np.int64)
        clo_j = np.zeros(C, np.int64)
        clo_meas = np.zeros((C, 3))
        clo_info = np.tile(np.eye(3), (C, 1, 1))
        clo_valid = np.zeros(C, bool)
        for k, c in enumerate(self.closures):
            clo_i[k] = min(c.i, n - 1)
            clo_j[k] = min(c.j, n - 1)
            clo_meas[k] = c.meas
            # exact symmetry: covariance inversion leaves ~1e-5
            # relative asymmetry, which a one-triangle Cholesky can turn
            # into NaN
            clo_info[k] = 0.5 * (c.info + c.info.T)
            # an edge whose endpoint the chain has not reached yet
            # activates once extend_chain covers it
            clo_valid[k] = (
                c.active and not c.suppressed and c.i < n and c.j < n
            )
        return pose_graph_from_numpy(
            dict(
                poses=poses, valid=valid, fixed=fixed,
                chain_meas=chain_meas, chain_info=chain_info,
                chain_valid=chain_valid, clo_i=clo_i, clo_j=clo_j,
                clo_meas=clo_meas, clo_info=clo_info, clo_valid=clo_valid,
            ),
            self.device,
        )

    def _gate_consistent_loops(self):
        """Pairwise odometry-consistency gating of loop closures
        (PCM-flavored, after Mangelson et al. 2018): closures a and b
        whose endpoints are near each other on the chain must satisfy
        Ta*B == A*Tb (A, B the dead-reckoned ia->ib and ja->jb) within a
        Mahalanobis chi2 of 11.345; the most conflicted are suppressed
        greedily, and a survivor that had comparable partners but
        supports none of the survivors goes too. Recomputed from
        scratch before every solve."""
        n = len(self.pg_poses)
        idx = [
            k
            for k, c in enumerate(self.closures)
            if c.active and c.kind == "loop" and c.i < n and c.j < n
        ]
        for k in idx:
            self.closures[k].suppressed = False
        if len(idx) < 2:
            return
        # dead-reckoned chain poses + cumulative travel distance
        dr = np.zeros((n, 3))
        dist = np.zeros(n)
        for k in range(1, n):
            dr[k] = se2.compose(dr[k - 1], self.pg_meas[k])
            dist[k] = dist[k - 1] + float(
                np.linalg.norm(self.pg_meas[k][:2])
            )
        cls = [self.closures[k] for k in idx]
        m = len(cls)
        covs = [np.linalg.inv(c.info) for c in cls]
        conflict = [set() for _ in range(m)]
        support = [set() for _ in range(m)]
        for a in range(m):
            for b in range(a + 1, m):
                ca, cb = cls[a], cls[b]
                gi = abs(dist[ca.i] - dist[cb.i])
                gj = abs(dist[ca.j] - dist[cb.j])
                if max(gi, gj) > 80.0:
                    continue  # not comparable: too much chain between
                A = se2.relative(dr[ca.i], dr[cb.i])
                B = se2.relative(dr[ca.j], dr[cb.j])
                err = se2.relative(
                    se2.compose(A, cb.meas), se2.compose(ca.meas, B)
                )
                err[2] = se2.wrap_angle(err[2])
                g = gi + gj
                S = covs[a] + covs[b] + np.diag(
                    [
                        (0.15 + 0.01 * g) ** 2,
                        (0.15 + 0.01 * g) ** 2,
                        (0.03 + 0.001 * g) ** 2,
                    ]
                )
                chi2 = float(err @ np.linalg.solve(S, err))
                ok = chi2 <= 11.345
                (support if ok else conflict)[a].add(b)
                (support if ok else conflict)[b].add(a)
        # iteratively drop the most-conflicted / least-supported until
        # conflict-free (greedy max consistent subset)
        alive = set(range(m))
        while True:
            worst, worst_key = None, None
            for k in alive:
                ncon = len(conflict[k] & alive)
                if ncon == 0:
                    continue
                key = (ncon - len(support[k] & alive), ncon, -k)
                if worst_key is None or key > worst_key:
                    worst, worst_key = k, key
            if worst is None:
                break
            alive.remove(worst)
        frozen = frozenset(alive)
        for k in frozen:
            if (conflict[k] | support[k]) and not (support[k] & frozen):
                alive.discard(k)
        for k in range(m):
            cls[k].suppressed = k not in alive

    @property
    def suppressed_closure_count(self) -> int:
        return sum(
            1
            for c in self.closures
            if c.active and c.kind == "loop" and c.suppressed
        )

    def optimize(self, iterations: int = 20, gnc_scale: float = 1.0):
        if len(self.pg_poses) < 2:
            return
        with self.rec.span("slam.backend.pg_solve"):
            self._gate_consistent_loops()
            g = self._build_pg_data()
            new_poses = self._solve(g, iterations,
                                    gnc_scale).poses.cpu().numpy()
            for k in range(len(self.pg_poses)):
                self.pg_poses[k] = new_poses[k]

    def _solve(self, g, iterations: int, gnc_scale: float):
        """Route one pose-graph solve (the product path replacing
        submap_loop_closer.cpp:286-288) to the dense or the
        keyframe-partitioned Schur solver per config.pg_solver:
        "blocked", or "auto" from dist_solver_min_poses padded poses
        up, takes parallel/dist_solver in blocks of dist_block_size. A
        mesh set on the closer always takes the sharded solver, in
        max(mesh size, N / dist_block_size) blocks."""
        cfg = self.config
        N = g.poses.shape[0]
        blocked = self.mesh is not None or cfg.pg_solver == "blocked" or (
            cfg.pg_solver == "auto" and N >= cfg.dist_solver_min_poses
        )
        if not blocked:
            return solvers.optimize_pose_graph(
                g, cfg.dcs_phi, iterations, gnc_init_scale=gnc_scale,
                rec=self.rec,
            )
        self.rec.count("pg.solves")
        self.rec.count("pg.iterations", iterations)
        # N is a power of two, and so is dist_block_size: the blocks
        # tile the padded graph
        n_blocks = max(1, N // max(1, cfg.dist_block_size))
        if self.mesh is not None:
            # N and the mesh size are powers of two: n_blocks divides N
            # and is a multiple of the mesh size
            n_blocks = max(self.mesh.size, n_blocks)
        plan = dist_solver.partition_of(g, n_blocks)
        bg, sg = dist_solver.split_graph(g, plan)
        if self.mesh is not None:
            poses = dist_solver.optimize_pose_graph_sharded(
                bg, sg, cfg.dcs_phi, self.mesh, iterations, gnc_scale
            )
        else:
            poses = dist_solver.optimize_pose_graph_blocked(
                bg, sg, cfg.dcs_phi, iterations, gnc_scale
            )
        return g._replace(poses=poses.reshape(g.poses.shape))

    # --------------------------------------------------------------------
    def prune_false_closures(self) -> int:
        """chi2 > 11.345 closure pruning (log_runner.cpp:182-190).
        Returns the number of edges deactivated by this call."""
        if not self.closures or len(self.pg_poses) < 2:
            return 0
        self._gate_consistent_loops()
        g = self._build_pg_data()
        chi2 = solvers.closure_chi2(g).cpu().numpy()
        n = len(self.pg_poses)
        pruned = 0
        for k, c in enumerate(self.closures):
            if c.suppressed:
                continue  # not in the graph; chi2[k] is meaningless
            if c.active and c.i < n and c.j < n and chi2[k] > 11.345:
                c.active = False
                pruned += 1
                # the reference's counter tracks rejected LOOP closures
                if c.kind == "loop":
                    self.false_closures += 1
        return pruned

    # --------------------------------------------------------------------
    def joint_solve(self) -> bool:
        """Final joint landmark + pose bundle adjustment
        (solvers.optimize_joint_graph; no reference counterpart: the
        reference finishes pose-graph-only, log_runner.cpp:203-205).

        Uses every original measurement: raw odometry between keyframes
        (kf.odom_meas/odom_info), every archived and active line-landmark
        observation edge, and the vetted closure/chain/pin edges with
        DCS. Each landmark is re-initialized from its median observation
        at the current pose estimate (the frontend's landmark frame
        drifts from the map frame across prunes). Warm-started from the
        pose-graph solution. Returns True if it ran (and wrote back
        pg_poses and the frontend's landmark estimates); it runs only
        once the chain reaches every keyframe."""
        cfg = self.config
        kfs = self.frontend.keyframes
        n = len(self.pg_poses)
        if n < 2 or n != len(kfs):
            return False
        edges = [
            e
            for e in (self.frontend.archived_obs + self.frontend.obs_edges)
            if e.pose_idx < n
        ]
        if not edges:
            return False
        lm_map = {}
        by_lm: dict[int, list] = {}
        for e in edges:
            lm_map.setdefault(e.lm_idx, len(lm_map))
            by_lm.setdefault(e.lm_idx, []).append(e)
        closures = [
            c
            for c in self.closures
            if c.active and not c.suppressed and c.i < n and c.j < n
        ]
        P = _bucket(n, cfg.bucket_min_pg)
        L = _bucket(max(len(lm_map), 1), 64)
        E = _bucket(max(len(edges), 1), 256)
        C = _bucket(max(len(closures), 1))

        f = dict(
            poses=np.zeros((P, 3)), pose_valid=np.zeros(P, bool),
            pose_fixed=np.zeros(P, bool), odom_meas=np.zeros((P, 3)),
            odom_info=np.tile(np.eye(3), (P, 1, 1)),
            odom_valid=np.zeros(P, bool),
            lms=np.zeros((L, 2)), lm_valid=np.zeros(L, bool),
            obs_pose=np.zeros(E, np.int64), obs_lm=np.zeros(E, np.int64),
            obs_meas=np.zeros((E, 2)), obs_info=np.tile(np.eye(2), (E, 1, 1)),
            obs_valid=np.zeros(E, bool),
            clo_i=np.zeros(C, np.int64), clo_j=np.zeros(C, np.int64),
            clo_meas=np.zeros((C, 3)), clo_info=np.tile(np.eye(3), (C, 1, 1)),
            clo_valid=np.zeros(C, bool),
        )
        f["poses"][:n] = np.stack(self.pg_poses)
        f["pose_valid"][:n] = True
        f["pose_fixed"][0] = True
        for i in range(1, n):
            f["odom_meas"][i] = kfs[i].odom_meas
            f["odom_info"][i] = kfs[i].odom_info
            f["odom_valid"][i] = True
        # the world line of the median observation under the current
        # pose estimate
        for lid, k in lm_map.items():
            les = by_lm[lid]
            e = les[len(les) // 2]
            pose = f["poses"][e.pose_idx]
            f["lms"][k] = np.asarray(transform_line(e.meas, pose[:2], pose[2]))
            f["lm_valid"][k] = True
        for k, e in enumerate(edges):
            f["obs_pose"][k] = e.pose_idx
            f["obs_lm"][k] = lm_map[e.lm_idx]
            f["obs_meas"][k] = e.meas
            f["obs_info"][k] = e.info
            f["obs_valid"][k] = True
        for k, c in enumerate(closures):
            f["clo_i"][k] = c.i
            f["clo_j"][k] = c.j
            f["clo_meas"][k] = c.meas
            f["clo_info"][k] = c.info
            f["clo_valid"][k] = True

        g = joint_graph_from_numpy(f, self.device)
        g_opt, _ = solvers.optimize_joint_graph(
            g, cfg.dcs_phi, cfg.final_joint_iterations
        )
        new_poses, new_lms = _host(g_opt.poses, g_opt.lms)
        for k in range(n):
            self.pg_poses[k] = new_poses[k]
        # keep the frontend's landmark estimates in the solved map frame
        # (maps and diagnostics; associations are over)
        for lid, k in lm_map.items():
            self.frontend.landmarks[lid].rhotheta = new_lms[k]
        return True
