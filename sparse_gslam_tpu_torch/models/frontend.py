"""Landmark-graph frontend: keyframing, data association, chi^2-gated
incremental LM optimization, landmark endpoint maintenance.

Re-implements Drone (src/sparse_gslam/src/drone.cpp:26-263,
include/drone.h:23-56) as a host-orchestrated state machine whose solve
step is the fixed-shape LM solve of ops.solvers on the frontend's
device. State is functional-by-copy: the chi^2 rejection gate
(drone.cpp:161-189) is a snapshot restore instead of g2o push/pop, and
g2o's pointer graph becomes masked arrays rebuilt per keyframe from
compact host lists. Port of sparse_gslam_tpu/models/frontend.py;
relative_chain_info (the backend's marginal chain information) is host
numpy float64 in both packages.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..interop import lm_graph_from_numpy
from ..ops import solvers
from ..ops.line_geometry import (
    calc_endpoints_t,
    calc_start_dir,
    ll_distance,
    topolar,
)
from ..ops.lines import Segments
from ..ops.multicloud import OdomErrorPropagator
from ..utils import se2
from ..utils.chi2 import chi2_quantile
from ..utils.config import SlamConfig
from ..utils.trace import Recorder
from .range_data import RangeData2D

def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class Landmark:
    """VertexRhoTheta equivalent (g2o_bindings/vertex_rhotheta.h:11-22)."""

    rhotheta: np.ndarray  # (2,)
    start: np.ndarray  # (2,) endpoint cache
    end: np.ndarray  # (2,)
    dist: float  # traveled-dist stamp for association gating


@dataclasses.dataclass
class ObsEdge:
    """EdgeSE2RhoTheta equivalent (edge_se2_rhotheta.h:8-17)."""

    pose_idx: int
    lm_idx: int
    meas: np.ndarray  # (2,)
    info: np.ndarray  # (2, 2)
    start_bl: np.ndarray  # observed endpoints in the observing pose's
    end_bl: np.ndarray  # body frame (drone.cpp:205-206)


@dataclasses.dataclass
class Keyframe:
    """PoseWithObservation equivalent (pose_with_observation.h:9-23)."""

    estimate: np.ndarray  # (3,) current landmark-graph estimate
    odom_meas: np.ndarray  # (3,) edge from previous keyframe
    odom_info: np.ndarray  # (3, 3)
    data: RangeData2D
    odom_times: list  # intra-keyframe odometry stream for .result
    odom_dposes: list


class Frontend:
    """Keyframing, association, LM solve and chi^2 gate. The LM solve
    runs on `device` (float64) whatever `config.frontend_on_host` says:
    the port never moves it to the CPU behind the caller's back."""

    def __init__(self, config: SlamConfig, device="cuda", rec=None):
        """rec: the utils.trace.Recorder of the owning system (a fresh
        one, off, without)."""
        self.config = config
        self.device = torch.device(device)
        self.rec = rec if rec is not None else Recorder()
        self.odom_prop = OdomErrorPropagator(
            config.std_x, config.std_y, config.std_w,
            getattr(config, "noise_model", "reference"),
        )
        self.keyframes: list[Keyframe] = []
        self.landmarks: list[Landmark] = []
        self.obs_edges: list[ObsEdge] = []  # active-window edges only
        # edges retired by the backend's window prunes (extend_chain)
        self.archived_obs: list[ObsEdge] = []
        self.window_start = 0  # first pose in the active optimization
        self.traveled_dist = 0.0
        self.prev_odom = None  # last raw odom pose
        self.prev_time = None
        self.need_reinit = True
        self.last_landmark_edge = 0
        # beam table for inserting scans into RangeData2D
        angles = config.angle_min + config.angle_increment * np.arange(
            config.scan_size
        )
        self.table = np.stack([np.cos(angles), np.sin(angles)], axis=1)
        self.rejected_ticks = 0

    # ------------------------------------------------------------------
    def estimates(self) -> np.ndarray:
        return np.stack([k.estimate for k in self.keyframes])

    # ------------------------------------------------------------------
    def tick(self, segments: Segments, time: float, odom_pose, ranges,
             table=None) -> bool:
        """One frontend step (drone.cpp:44-196). segments are in the
        current base_link frame; odom_pose is the raw odometry pose;
        ranges the subsampled scan. Returns True if a keyframe was made.
        """
        odom_pose = np.asarray(odom_pose, dtype=np.float64)
        if table is not None:
            self.table = table
        if not self.keyframes:
            kf = Keyframe(
                estimate=odom_pose.copy(),
                odom_meas=np.zeros(3),
                odom_info=np.eye(3),
                data=RangeData2D(),
                odom_times=[time],
                odom_dposes=[odom_pose.copy()],
            )
            kf.data.insert_scan(ranges, self.table, self.config.range_max)
            self.keyframes.append(kf)
            self.prev_odom = odom_pose.copy()
            self.prev_time = time
            return True

        delta = se2.relative(self.prev_odom, odom_pose)
        self.odom_prop.step(delta)
        self.prev_odom = odom_pose.copy()
        self.prev_time = time

        prev_est = self.keyframes[-1].estimate
        cor_pose = se2.compose(prev_est, self.odom_prop.pose)

        disp = float(np.linalg.norm(self.odom_prop.pose[:2]))
        if disp > 0.5 or abs(self.odom_prop.pose[2]) >= math.pi / 6:
            self._make_keyframe(segments, time, odom_pose, ranges, cor_pose)
            return True
        elif (
            np.linalg.norm(delta[:2]) > 0.01
            or abs(delta[2]) >= math.pi / 180
        ):
            # accumulate scan into the open keyframe (drone.cpp:191-195)
            kf = self.keyframes[-1]
            kf.data.insert_scan(
                ranges, self.table, self.config.range_max,
                pose=self.odom_prop.pose,
            )
            kf.odom_times.append(time)
            kf.odom_dposes.append(self.odom_prop.pose.copy())
        return False

    # ------------------------------------------------------------------
    def _make_keyframe(self, segments, time, odom_pose, ranges, cor_pose):
        cfg = self.config
        self.traveled_dist += float(np.linalg.norm(self.odom_prop.pose[:2]))

        kf = Keyframe(
            estimate=np.asarray(cor_pose, dtype=np.float64).copy(),
            odom_meas=self.odom_prop.pose.copy(),
            odom_info=np.linalg.inv(self.odom_prop.cov),
            data=RangeData2D(),
            odom_times=[time],
            odom_dposes=[odom_pose.copy()],
        )
        kf.data.insert_scan(ranges, self.table, cfg.range_max)
        self.keyframes.append(kf)
        new_pose_idx = len(self.keyframes) - 1

        # snapshot for the chi^2 rollback gate
        snap_poses = [
            k.estimate.copy()
            for k in self.keyframes[self.window_start :]
        ]
        snap_lms = [
            (lm.rhotheta.copy(), lm.start.copy(), lm.end.copy())
            for lm in self.landmarks
        ]
        n_lms_before = len(self.landmarks)
        n_edges_before = len(self.obs_edges)

        # data association + observation edges (drone.cpp:134-141)
        rot = se2.rotation_matrix(cor_pose[2])
        with self.rec.span("slam.frontend.update"):
            for s in range(segments.n):
                start_w = rot @ segments.start[s] + cor_pose[:2]
                end_w = rot @ segments.end[s] + cor_pose[:2]
                lm_idx = self._merge_line(start_w, end_w)
                self.obs_edges.append(
                    ObsEdge(
                        pose_idx=new_pose_idx,
                        lm_idx=lm_idx,
                        meas=segments.rhotheta[s].copy(),
                        info=np.linalg.inv(segments.cov[s]),
                        start_bl=segments.start[s].copy(),
                        end_bl=segments.end[s].copy(),
                    )
                )
        self.odom_prop.reset()

        # incremental LM solve over the active window (drone.cpp:146-156)
        chi2, dof = self._solve()

        # chi^2 consistency gate (drone.cpp:161-189)
        if dof > 0 and chi2 > chi2_quantile(0.99, dof):
            self.rejected_ticks += 1
            # roll back estimates
            for k, p in zip(self.keyframes[self.window_start :], snap_poses):
                k.estimate = p
            for lm, (rt, st, en) in zip(self.landmarks, snap_lms):
                lm.rhotheta, lm.start, lm.end = rt, st, en
            # drop this tick's landmark edges + orphaned new landmarks
            del self.obs_edges[n_edges_before:]
            used = {e.lm_idx for e in self.obs_edges}
            while (
                len(self.landmarks) > n_lms_before
                and (len(self.landmarks) - 1) not in used
            ):
                self.landmarks.pop()
            self.need_reinit = True
        else:
            with self.rec.span("slam.frontend.update"):
                self._update_endpoints()
        self.last_landmark_edge = len(self.obs_edges)

    # ------------------------------------------------------------------
    def _merge_line(self, start_w, end_w) -> int:
        """Nearest-landmark association (drone.cpp:217-256 mergeLine).

        Vectorized over all landmarks; returns landmark index (creating
        one if no association)."""
        cfg = self.config
        best_idx = -1
        best_err = np.inf
        if self.landmarks:
            lm_rt = np.stack([lm.rhotheta for lm in self.landmarks])
            lm_s = np.stack([lm.start for lm in self.landmarks])
            lm_e = np.stack([lm.end for lm in self.landmarks])
            dists = np.array([lm.dist for lm in self.landmarks])
            fresh = self.traveled_dist - dists < cfg.landmark_max_dist
            tl0, tl1 = calc_endpoints_t(lm_rt, lm_s, lm_e)
            err, tp0, tp1 = ll_distance(
                lm_rt,
                np.broadcast_to(start_w, lm_rt[:, :2].shape),
                np.broadcast_to(end_w, lm_rt[:, :2].shape),
            )
            overlap = ~(
                (tl0 > tp1 + cfg.landmark_max_gap)
                | (tl1 + cfg.landmark_max_gap < tp0)
            )
            cand = fresh & overlap
            err = np.where(cand, err, np.inf)
            i = int(np.argmin(err))
            if np.isfinite(err[i]):
                best_idx, best_err = i, float(err[i])

        if best_err > cfg.landmark_assoc_thresh:
            if best_idx >= 0 and best_err < 1.0:
                stale = self.traveled_dist - self.landmarks[best_idx].dist
                if 15.0 < stale < cfg.landmark_max_dist:
                    # implicit loop closure re-association
                    return best_idx
            # create a new landmark (drone.cpp:242-251)
            self.landmarks.append(
                Landmark(
                    rhotheta=np.asarray(topolar(start_w, end_w)),
                    start=np.asarray(start_w, dtype=np.float64).copy(),
                    end=np.asarray(end_w, dtype=np.float64).copy(),
                    dist=self.traveled_dist,
                )
            )
            return len(self.landmarks) - 1
        self.landmarks[best_idx].dist = self.traveled_dist
        return best_idx

    # ------------------------------------------------------------------
    def _active_lm_ids(self):
        """Landmarks with edges in the active window, in stable order."""
        seen = {}
        for e in self.obs_edges:
            if e.lm_idx not in seen:
                seen[e.lm_idx] = len(seen)
        return seen

    def _solve(self):
        """Build the fixed-shape LMGraphData for the active window, run
        the LM solve on the frontend's device, scatter results back.
        Returns (chi2, dof).
        """
        ws = self.window_start
        with self.rec.span("slam.frontend.graph"):
            g, lm_map = self._window_graph()
        with self.rec.span("slam.frontend.lm"):
            g_opt, chi2, dof = solvers.optimize_landmark_graph(
                g, 15, rec=self.rec)
        with self.rec.span("slam.frontend.readback"):
            # one device-to-host copy for everything the host reads back
            out = torch.cat([
                g_opt.poses.reshape(-1), g_opt.lms.reshape(-1),
                chi2.reshape(1), dof.reshape(1).to(chi2.dtype),
            ]).cpu().numpy()
            P, L = g.poses.shape[0], g.lms.shape[0]
            new_poses = out[: 3 * P].reshape(P, 3)
            new_lms = out[3 * P : 3 * P + 2 * L].reshape(L, 2)
            for i in range(len(self.keyframes) - ws):
                self.keyframes[ws + i].estimate = new_poses[i].copy()
            for lid, k in lm_map.items():
                self.landmarks[lid].rhotheta = new_lms[k].copy()
        return float(out[-2]), int(out[-1])

    def _window_graph(self):
        """The active window as a padded LMGraphData on the frontend's
        device, and the map from landmark index to its row."""
        ws = self.window_start
        n_poses = len(self.keyframes) - ws
        lm_map = self._active_lm_ids()
        n_lms = len(lm_map)
        n_edges = len(self.obs_edges)

        cfg = self.config
        P = _bucket(n_poses, cfg.bucket_min_poses)
        L = _bucket(max(n_lms, 1), cfg.bucket_min_lms)
        E = _bucket(max(n_edges, 1), cfg.bucket_min_edges)

        poses = np.zeros((P, 3))
        pose_valid = np.zeros(P, bool)
        pose_fixed = np.zeros(P, bool)
        odom_meas = np.zeros((P, 3))
        odom_info = np.tile(np.eye(3), (P, 1, 1))
        odom_valid = np.zeros(P, bool)
        for i in range(n_poses):
            kf = self.keyframes[ws + i]
            poses[i] = kf.estimate
            pose_valid[i] = True
            if i > 0:
                odom_meas[i] = kf.odom_meas
                odom_info[i] = kf.odom_info
                odom_valid[i] = True
        pose_fixed[0] = True

        lms = np.zeros((L, 2))
        lm_valid = np.zeros(L, bool)
        for lid, k in lm_map.items():
            lms[k] = self.landmarks[lid].rhotheta
            lm_valid[k] = True

        obs_pose = np.zeros(E, np.int64)
        obs_lm = np.zeros(E, np.int64)
        obs_meas = np.zeros((E, 2))
        obs_info = np.tile(np.eye(2), (E, 1, 1))
        obs_valid = np.zeros(E, bool)
        for k, e in enumerate(self.obs_edges):
            obs_pose[k] = e.pose_idx - ws
            obs_lm[k] = lm_map[e.lm_idx]
            obs_meas[k] = e.meas
            obs_info[k] = e.info
            obs_valid[k] = True

        g = lm_graph_from_numpy(
            dict(
                poses=poses, pose_valid=pose_valid, pose_fixed=pose_fixed,
                odom_meas=odom_meas, odom_info=odom_info,
                odom_valid=odom_valid, lms=lms, lm_valid=lm_valid,
                obs_pose=obs_pose, obs_lm=obs_lm, obs_meas=obs_meas,
                obs_info=obs_info, obs_valid=obs_valid,
            ),
            self.device,
        )
        return g, lm_map

    def relative_chain_info(
        self, start_idx: int, end_idx: int, granularity: int = 6
    ):
        """Information matrices of the chain-edge measurements
        rel(est[idx-1], est[idx]) for idx in [start_idx, end_idx),
        from the landmark-graph posterior (new-engine capability; the
        reference carries raw odometry information on every pose-graph
        chain edge, submap_loop_closer.cpp:209-218).

        Why: the chain measurement handed to the pose graph is the
        landmark-LM-refined relative estimate, which is far better
        than raw odometry wherever landmarks constrain the window
        (measured on the sim worlds: actual chain error RMS 0.014 m
        against a claimed raw-odometry sigma of 0.08-0.10 -- a 5-7x
        under-confidence that makes the graph over-trust closures,
        including corridor ridge aliases, relative to its excellent
        chain; scripts/edge_budget.py). The honest information comes
        from the marginal covariance of relative poses under the
        current window's landmark graph: assemble the window GN
        Hessian at the current estimates (odometry edges +
        line-landmark observation edges, pose window_start fixed as
        gauge) and invert. Landmark-starved stretches recover
        ~raw-odometry information automatically (the marginal reduces
        to the odom chain there).

        Correlation handling (the part a naive per-edge marginal gets
        wrong): consecutive chain edges share landmarks, so their
        errors are POSITIVELY correlated -- per-edge marginals chained
        independently under-claim the accumulated drift over a loop,
        stiffening the chain until good closures fail the 11.345
        chi2 prune (measured on sim-office: ATE 0.080 -> 0.150 with
        per-edge marginals). Instead the span is cut into blocks of
        `granularity` edges (~the landmark-visibility scale set by
        landmark_max_dist); each block's endpoint-to-endpoint relative
        marginal -- which DOES absorb all intra-block correlation --
        is spread uniformly over its edges. Accumulation across blocks
        is then approximately independent because blocks share few
        landmarks. Validated against ATE + per-edge chi2 on all four
        sim worlds (RESULTS.md round 4).

        Host-side numpy float64 throughout: the window Hessian is a
        few-hundred-dim dense matrix, and the call happens once per
        closure apply, not per frame."""
        ws = self.window_start
        n = len(self.keyframes)
        P = n - ws
        if P < 2:
            return {}
        lm_map = self._active_lm_ids()
        L = len(lm_map)
        # variable layout: pose ws is the fixed gauge (no variables);
        # poses ws+1..n-1 -> 3 vars each, then landmarks -> 2 vars each
        D = 3 * (P - 1) + 2 * L
        H = np.zeros((D, D))

        def pvar(gi):  # global keyframe idx -> var offset or None
            li = gi - ws
            return None if li == 0 else 3 * (li - 1)

        est = self.estimates()

        def add_block(r, c, m):
            H[r : r + m.shape[0], c : c + m.shape[1]] += m

        # odometry edges (i-1 -> i) over the window
        for gi in range(ws + 1, n):
            kf = self.keyframes[gi]
            xi, xj, z = est[gi - 1], est[gi], kf.odom_meas
            ci, si = math.cos(xi[2]), math.sin(xi[2])
            cz, sz = math.cos(z[2]), math.sin(z[2])
            dx, dy = xj[0] - xi[0], xj[1] - xi[1]
            m00 = cz * ci - sz * si
            m01 = cz * si + sz * ci
            m10 = -sz * ci - cz * si
            m11 = -sz * si + cz * ci
            g0 = -si * dx + ci * dy
            g1 = -ci * dx - si * dy
            Ji = np.array(
                [
                    [-m00, -m01, cz * g0 + sz * g1],
                    [-m10, -m11, -sz * g0 + cz * g1],
                    [0.0, 0.0, -1.0],
                ]
            )
            Jj = np.array(
                [[m00, m01, 0.0], [m10, m11, 0.0], [0.0, 0.0, 1.0]]
            )
            info = kf.odom_info
            vi, vj = pvar(gi - 1), pvar(gi)
            if vi is not None:
                add_block(vi, vi, Ji.T @ info @ Ji)
                add_block(vi, vj, Ji.T @ info @ Jj)
                add_block(vj, vi, Jj.T @ info @ Ji)
            add_block(vj, vj, Jj.T @ info @ Jj)

        # line-landmark observation edges (the closed form of
        # ops/solvers.rhotheta_edge_jacobians)
        for e in self.obs_edges:
            gp = e.pose_idx
            if gp < ws:
                continue
            pose = est[gp]
            lm = self.landmarks[e.lm_idx].rhotheta
            c, s = math.cos(pose[2]), math.sin(pose[2])
            x, y = pose[0], pose[1]
            itx = -(c * x + s * y)
            ity = s * x - c * y
            theta_raw = se2.wrap_angle(lm[1] - pose[2])
            nx, ny = math.cos(theta_raw), math.sin(theta_raw)
            rho_raw = lm[0] + itx * nx + ity * ny
            sigma = -1.0 if rho_raw < 0 else 1.0
            dr_dx = -c * nx + s * ny
            dr_dy = -s * nx - c * ny
            dr_dthl = -itx * ny + ity * nx
            Jp = np.array(
                [[-sigma * dr_dx, -sigma * dr_dy, 0.0], [0.0, 0.0, 1.0]]
            )
            Jl = np.array([[-sigma, -sigma * dr_dthl], [0.0, -1.0]])
            vp = pvar(gp)
            vl = 3 * (P - 1) + 2 * lm_map[e.lm_idx]
            info = e.info
            if vp is not None:
                add_block(vp, vp, Jp.T @ info @ Jp)
                add_block(vp, vl, Jp.T @ info @ Jl)
                add_block(vl, vp, Jl.T @ info @ Jp)
            add_block(vl, vl, Jl.T @ info @ Jl)

        # regularize: a landmark observed once along its line direction
        # (or an all-endpoint-degenerate window) can leave H singular
        H[np.diag_indices_from(H)] += 1e-9
        try:
            cov = np.linalg.inv(H)
        except np.linalg.LinAlgError:
            return {}

        def pair_rel_cov(a, b):
            """Marginal covariance of rel(est[a], est[b])."""
            vi, vj = pvar(a), pvar(b)
            S = np.zeros((6, 6))
            if vi is not None:
                S[:3, :3] = cov[vi : vi + 3, vi : vi + 3]
                S[:3, 3:] = cov[vi : vi + 3, vj : vj + 3]
                S[3:, :3] = cov[vj : vj + 3, vi : vi + 3]
            S[3:, 3:] = cov[vj : vj + 3, vj : vj + 3]
            xi, xj = est[a], est[b]
            ci, si = math.cos(xi[2]), math.sin(xi[2])
            dx, dy = xj[0] - xi[0], xj[1] - xi[1]
            # d rel / d (xi, xj) at the current estimates
            J = np.array(
                [
                    [-ci, -si, -si * dx + ci * dy, ci, si, 0.0],
                    [si, -ci, -ci * dx - si * dy, -si, ci, 0.0],
                    [0.0, 0.0, -1.0, 0.0, 0.0, 1.0],
                ]
            )
            rc = J @ S @ J.T
            rc = 0.5 * (rc + rc.T)
            rc[np.diag_indices_from(rc)] += 1e-10
            return rc

        out = {}
        s0 = max(start_idx, ws + 1)
        g = max(1, granularity)
        a = s0 - 1
        while a < end_idx - 1:
            b = min(a + g, end_idx - 1)
            rc = pair_rel_cov(a, b)
            # spread the block's (correlation-absorbing) endpoint
            # covariance uniformly over its edges
            per_edge = rc / float(b - a)
            try:
                info = np.linalg.inv(per_edge)
            except np.linalg.LinAlgError:
                a = b
                continue
            for idx in range(a + 1, b + 1):
                out[idx] = info
            a = b
        return out

    # ------------------------------------------------------------------
    def _update_endpoints(self):
        """Algorithm 2: re-project the union of observing edges'
        endpoints onto the updated line (vertex_rhotheta.cpp:9-27):
        body-frame endpoints transformed by the *current* estimate of
        the observing pose, projected onto the updated landmark line.
        """
        by_lm: dict[int, list[ObsEdge]] = {}
        for e in self.obs_edges:
            by_lm.setdefault(e.lm_idx, []).append(e)
        for lid, edges in by_lm.items():
            lm = self.landmarks[lid]
            start, direction = calc_start_dir(lm.rhotheta)
            t_min, t_max = np.inf, -np.inf
            for e in edges:
                pose = self.keyframes[e.pose_idx].estimate
                for p_bl in (e.start_bl, e.end_bl):
                    p_w = se2.apply(pose, p_bl)
                    t = float((p_w - start) @ direction)
                    t_min = min(t_min, t)
                    t_max = max(t_max, t)
            lm.start = np.asarray(start + t_min * direction)
            lm.end = np.asarray(start + t_max * direction)
