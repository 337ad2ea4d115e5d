"""Landmark-graph Levenberg-Marquardt and pose-graph Gauss-Newton
solvers on torch tensors.

Port of sparse_gslam_tpu/ops/solvers.py. The landmark graph (the reference's g2o LM
+ BlockSolver<-1,2>, src/sparse_gslam/src/graphs.cpp:9-37): fixed-shape
masked edge tables, batched residuals and closed-form Jacobians,
scatter-assembled normal equations, Schur elimination of the 2-DoF
landmark blocks, and either a dense Cholesky of the reduced pose system
or, for long windows, a block-tridiagonal solve of the pose chain with
a Woodbury correction for the landmarks. The pose graph (chain +
DCS-robustified closures, submap_loop_closer.cpp:286-288): a dense
(3N)^2 Jacobi-equilibrated Cholesky per Gauss-Newton iteration; its
keyframe-partitioned counterpart for long graphs is
parallel/dist_solver.py, which solves its blocks' interiors with
tridiag_solve_cr batched over the blocks. The joint system (the final
bundle adjustment over poses, landmarks and DCS closures) is the
landmark graph's dense assembly plus the closures, with the landmarks
Schur-eliminated through one (3P, 2L) matmul.

Everything runs on the device of the input tensors, in their dtype
(float64 in the port). Differences from the JAX package:
  - scatter-adds are `index_put_(..., accumulate=True)`; their order
    of summation differs from XLA's, so results agree to rounding
    (~1e-15 relative per operation), not bit for bit;
  - the block-tridiagonal chain solve is `tridiag_solve_cr` (cyclic
    reduction, log2 P batched levels, any leading batch dimensions)
    where the JAX package runs the sequential `tridiag_solve` (under
    vmap in its blocked solver); both solve the same SPD system;
  - the early-stopping LM loops are Python loops with one host sync
    per iteration (the stop flags); on the card the landmark-graph
    LM replays its set-up and its step as one CUDA graph each per
    padded (P, L, E) (optimize_landmark_graph), the step enqueueing no
    other host read.

Edge types:
  - SE2->SE2 odometry edges (g2o EdgeSE2 semantics:
    e = t2v(Z^-1 (Xi^-1 Xj)))
  - SE2->(rho,theta) line observation edges (g2o_bindings
    edge_se2_rhotheta.cpp:9-16: e = z - transform_line(l, Xi^-1))
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from ..utils.se2 import wrap_angle
from ..utils.trace import Recorder
from .line_geometry import transform_line

# Normal-equation assembly needs full-precision products: no TF32 on
# the solver paths (the counterpart of the JAX package's `precise`).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _mm(a, b):
    """Batched (..., i, k) @ (..., k, j) with a^T: einsum 'nba,nbc->nac'."""
    return torch.einsum("nba,nbc->nac", a, b)


# ---------------------------------------------------------------------------
# residuals + Jacobians
# ---------------------------------------------------------------------------


def se2_edge_residual(xi, xj, z):
    """e = t2v(Z^-1 * (Xi^-1 * Xj)) for batches of edges.

    xi, xj, z: (...,3). Returns (...,3) with wrapped angle.
    """
    ci, si = torch.cos(xi[..., 2]), torch.sin(xi[..., 2])
    dx = xj[..., 0] - xi[..., 0]
    dy = xj[..., 1] - xi[..., 1]
    # d = Ri^T (tj - ti)
    d0 = ci * dx + si * dy
    d1 = -si * dx + ci * dy
    cz, sz = torch.cos(z[..., 2]), torch.sin(z[..., 2])
    e0 = cz * (d0 - z[..., 0]) + sz * (d1 - z[..., 1])
    e1 = -sz * (d0 - z[..., 0]) + cz * (d1 - z[..., 1])
    e2 = wrap_angle(xj[..., 2] - xi[..., 2] - z[..., 2])
    return torch.stack([e0, e1, e2], dim=-1)


def se2_edge_jacobians(xi, xj, z):
    """Closed-form (...,3,3) Jacobians (Ji, Jj) of se2_edge_residual."""
    ci, si = torch.cos(xi[..., 2]), torch.sin(xi[..., 2])
    cz, sz = torch.cos(z[..., 2]), torch.sin(z[..., 2])
    dx = xj[..., 0] - xi[..., 0]
    dy = xj[..., 1] - xi[..., 1]
    # M = Rz^T @ Ri^T with Ri^T = [[ci, si], [-si, ci]]
    m00 = cz * ci + sz * (-si)
    m01 = cz * si + sz * ci
    m10 = -sz * ci + cz * (-si)
    m11 = -sz * si + cz * ci
    # dRi^T/dtheta_i = [[-si, ci], [-ci, -si]]
    g0 = -si * dx + ci * dy
    g1 = -ci * dx - si * dy
    # de_t/dtheta_i = Rz^T @ [g0, g1]
    e0_ti = cz * g0 + sz * g1
    e1_ti = -sz * g0 + cz * g1
    o = torch.zeros_like(ci)
    i1 = torch.ones_like(ci)
    Ji = torch.stack(
        [
            torch.stack([-m00, -m01, e0_ti], dim=-1),
            torch.stack([-m10, -m11, e1_ti], dim=-1),
            torch.stack([o, o, -i1], dim=-1),
        ],
        dim=-2,
    )
    Jj = torch.stack(
        [
            torch.stack([m00, m01, o], dim=-1),
            torch.stack([m10, m11, o], dim=-1),
            torch.stack([o, o, i1], dim=-1),
        ],
        dim=-2,
    )
    return Ji, Jj


def rhotheta_edge_residual(pose, lm, z):
    """e = z - transform_line(lm, pose^-1), angle wrapped
    (edge_se2_rhotheta.cpp:9-16)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    inv_t = torch.stack(
        [
            -(c * pose[..., 0] + s * pose[..., 1]),
            -(-s * pose[..., 0] + c * pose[..., 1]),
        ],
        dim=-1,
    )
    pred = transform_line(lm, inv_t, -pose[..., 2])
    e = z - pred
    return torch.stack([e[..., 0], wrap_angle(e[..., 1])], dim=-1)


def rhotheta_edge_jacobians(poses, lms, zs):
    """Closed-form (E,2,3) d e/d pose and (E,2,2) d e/d lm.

    With c,s = cos/sin(theta_p), inv_t = (-(c x + s y), s x - c y),
    theta_raw = theta_l - theta_p, n = (cos, sin)(theta_raw) and
    rho_raw = rho_l + inv_t.n, the prediction is (sigma*rho_raw,
    theta_raw [+pi]) where sigma = -1 on the rho<0 normalization flip
    (check_rhotheta) -- the branch is differentiated as taken.
    """
    c, s = torch.cos(poses[..., 2]), torch.sin(poses[..., 2])
    x, y = poses[..., 0], poses[..., 1]
    itx = -(c * x + s * y)
    ity = s * x - c * y
    theta_raw = wrap_angle(lms[..., 1] - poses[..., 2])
    nx, ny = torch.cos(theta_raw), torch.sin(theta_raw)
    rho_raw = lms[..., 0] + itx * nx + ity * ny
    o = torch.zeros_like(c)
    one = torch.ones_like(c)
    sigma = torch.where(rho_raw < 0, -one, one)

    # d rho_raw / d {x, y, theta_l}; d rho_raw / d theta_p == 0 exactly
    dr_dx = -c * nx + s * ny  # = -cos(theta_l)
    dr_dy = -s * nx - c * ny  # = -sin(theta_l)
    dr_dthl = -itx * ny + ity * nx  # inv_t . dn/dtheta_raw

    Jp = torch.stack(
        [
            torch.stack([-sigma * dr_dx, -sigma * dr_dy, o], dim=-1),
            torch.stack([o, o, one], dim=-1),
        ],
        dim=-2,
    )
    Jl = torch.stack(
        [
            torch.stack([-sigma, -sigma * dr_dthl], dim=-1),
            torch.stack([o, -one], dim=-1),
        ],
        dim=-2,
    )
    return Jp, Jl


# ---------------------------------------------------------------------------
# block-tridiagonal machinery (3x3 blocks)
# ---------------------------------------------------------------------------


def inv3(m):
    """Explicit 3x3 inverse (adjugate), batched."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    rows = [
        torch.stack([A, B, C], dim=-1),
        torch.stack([D, E, F], dim=-1),
        torch.stack([G, H, I], dim=-1),
    ]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


def tridiag_solve(D, O, rhs):
    """Solve a block-tridiagonal SPD system (3x3 blocks) for multiple
    right-hand sides via block LDL^T with a forward/backward sweep.

    D: (P, 3, 3) diagonal blocks; O: (P, 3, 3) with O[i] the
    H[i-1, i] coupling block (O[0] ignored); rhs: (P, 3, R).
    Returns x (P, 3, R). Sequential in P: the port's LM uses
    tridiag_solve_cr, which solves the same system in log2 P levels.
    """
    P = D.shape[0]
    R = rhs.shape[-1]
    S_inv = torch.zeros((3, 3), dtype=D.dtype, device=D.device)
    y = torch.zeros((3, R), dtype=D.dtype, device=D.device)
    S_invs, ys = [], []
    for i in range(P):
        O_i = O[i] if i > 0 else torch.zeros_like(O[0])
        L = O_i.T @ S_inv
        S_inv = inv3(D[i] - L @ O_i)
        y = rhs[i] - L @ y
        S_invs.append(S_inv)
        ys.append(y)
    x = torch.zeros((3, R), dtype=D.dtype, device=D.device)
    xs = [None] * P
    for i in reversed(range(P)):
        O_next = O[i + 1] if i + 1 < P else torch.zeros_like(O[0])
        x = S_invs[i] @ (ys[i] - O_next @ x)
        xs[i] = x
    return torch.stack(xs)


def tridiag_solve_cr(D, O, rhs):
    """Block cyclic reduction for the same SPD block-tridiagonal system
    as tridiag_solve: O(log P) batched elimination levels instead of an
    O(P) sequential sweep -- each level eliminates all odd-indexed
    blocks at once. Equivalent to block Cholesky under a
    nested-dissection ordering, so stability matches the LDL sweep for
    SPD input.

    D: (..., P, 3, 3); O: (..., P, 3, 3) with O[..., i] = H[i-1, i]
    (O[..., 0] ignored); rhs: (..., P, 3, R). Leading dimensions are
    independent systems (the blocked pose-graph solver's P blocks).
    Returns x (..., P, 3, R).
    """
    P = D.shape[-3]
    batch = D.shape[:-3]
    M = 1
    while M < max(P, 1):
        M *= 2
    dt, dev = D.dtype, D.device

    def zeros(n, like):
        return torch.zeros(like.shape[:-3] + (n,) + like.shape[-2:],
                           dtype=dt, device=dev)

    if M != P:
        pad = M - P
        eye = torch.eye(3, dtype=dt, device=dev)
        D = torch.cat([D, eye.expand(batch + (pad, 3, 3))], dim=-3)
        O = torch.cat([O, zeros(pad, O)], dim=-3)
        rhs = torch.cat([rhs, zeros(pad, rhs)], dim=-3)
    E = O.clone()
    E[..., 0, :, :] = 0.0
    r = rhs

    # forward elimination: per level, remove odd-indexed blocks
    stack = []  # per-level (D_o_inv, E_e, E_o, r_o) for back-substitution
    m = M
    while m > 1:
        D_e, D_o = D[..., 0::2, :, :], D[..., 1::2, :, :]
        E_e, E_o = E[..., 0::2, :, :], E[..., 1::2, :, :]
        r_e, r_o = r[..., 0::2, :, :], r[..., 1::2, :, :]
        Dinv_o = inv3(D_o)
        Dinv_prev = torch.cat([zeros(1, Dinv_o), Dinv_o[..., :-1, :, :]],
                              dim=-3)
        E_o_prev = torch.cat([zeros(1, E_o), E_o[..., :-1, :, :]], dim=-3)
        r_o_prev = torch.cat([zeros(1, r_o), r_o[..., :-1, :, :]], dim=-3)
        EeT = E_e.transpose(-1, -2)
        L = EeT @ Dinv_prev  # couples eq 2k to odd 2k-1
        Rr = E_o @ Dinv_o  # couples eq 2k to odd 2k+1
        D_new = D_e - L @ EeT.transpose(-1, -2) - Rr @ E_o.transpose(-1, -2)
        r_new = r_e - L @ r_o_prev - Rr @ r_o
        # convention E'[k] = H'[k-1, k]: the elimination of odd block
        # 2k-1 couples eq 2k to x_{2k-2} with -E_e^T Dinv E_o_prev^T,
        # which is H'[k, k-1]; store its transpose
        E_new = -(E_o_prev @ Dinv_prev @ E_e)
        stack.append((Dinv_o, E_e, E_o, r_o))
        D, E, r = D_new, E_new, r_new
        m //= 2

    x = inv3(D) @ r  # (..., 1, 3, R)

    # back-substitution: recover the odd blocks of each level
    for Dinv_o, E_e, E_o, r_o in reversed(stack):
        half = Dinv_o.shape[-3]
        x_e = x  # (..., half, 3, R)
        E_e_next = torch.cat([E_e[..., 1:, :, :], zeros(1, E_e)], dim=-3)
        x_e_next = torch.cat([x_e[..., 1:, :, :], zeros(1, x_e)], dim=-3)
        x_o = Dinv_o @ (
            r_o - E_o.transpose(-1, -2) @ x_e - E_e_next @ x_e_next
        )
        x = torch.stack([x_e, x_o], dim=-3).reshape(
            batch + (2 * half,) + x.shape[-2:])
    return x[..., :P, :, :]


# ---------------------------------------------------------------------------
# landmark-graph system (poses + rho-theta landmarks)
# ---------------------------------------------------------------------------


class LMGraphData(NamedTuple):
    """Fixed-shape landmark-graph tensors (reference:
    include/graphs.h:15-28).

    Pose i connects to pose i-1 via odometry edge i (odom_valid[i]).
    Obs edge e connects pose obs_pose[e] to landmark obs_lm[e].
    """

    poses: torch.Tensor  # (P, 3)
    pose_valid: torch.Tensor  # (P,) bool
    pose_fixed: torch.Tensor  # (P,) bool
    odom_meas: torch.Tensor  # (P, 3)
    odom_info: torch.Tensor  # (P, 3, 3)
    odom_valid: torch.Tensor  # (P,) bool
    lms: torch.Tensor  # (L, 2)
    lm_valid: torch.Tensor  # (L,) bool
    obs_pose: torch.Tensor  # (E,) int64
    obs_lm: torch.Tensor  # (E,) int64
    obs_meas: torch.Tensor  # (E, 2)
    obs_info: torch.Tensor  # (E, 2, 2)
    obs_valid: torch.Tensor  # (E,) bool


def _idx_prev(P, device):
    return torch.clamp(torch.arange(P, device=device) - 1, min=0)


def lm_graph_chi2(g: LMGraphData):
    """Total chi2 and dof over active edges (drone.cpp:161-165).
    Returns 0-dim tensors (chi2, dof)."""
    xi = g.poses[_idx_prev(g.poses.shape[0], g.poses.device)]
    eo = se2_edge_residual(xi, g.poses, g.odom_meas)
    c_o = torch.einsum("ni,nij,nj->n", eo, g.odom_info, eo)
    chi2 = torch.where(g.odom_valid, c_o, 0.0).sum()
    el = rhotheta_edge_residual(
        g.poses[g.obs_pose], g.lms[g.obs_lm], g.obs_meas
    )
    c_l = torch.einsum("ni,nij,nj->n", el, g.obs_info, el)
    chi2 = chi2 + torch.where(g.obs_valid, c_l, 0.0).sum()
    dof = 3 * g.odom_valid.sum() + 2 * g.obs_valid.sum()
    return chi2, dof


def _odom_terms(g: LMGraphData):
    """Masked odometry-edge Jacobians and residuals shared by both
    assemblies: (idx_prev, eo_w, Ji, Jj, OJi, OJj)."""
    P = g.poses.shape[0]
    dt = g.poses.dtype
    idx_prev = _idx_prev(P, g.poses.device)
    xi = g.poses[idx_prev]
    eo = se2_edge_residual(xi, g.poses, g.odom_meas)
    Ji, Jj = se2_edge_jacobians(xi, g.poses, g.odom_meas)
    w_o = g.odom_valid.to(dt)
    # free-variable masks: fixed poses contribute nothing
    free_i = (~g.pose_fixed[idx_prev]).to(dt)
    free_j = (~g.pose_fixed).to(dt)
    Ji = Ji * (w_o * free_i)[:, None, None]
    Jj = Jj * (w_o * free_j)[:, None, None]
    OJi = g.odom_info @ Ji
    OJj = g.odom_info @ Jj
    return idx_prev, eo * w_o[:, None], Ji, Jj, OJi, OJj


def _obs_terms(g: LMGraphData):
    """Masked observation-edge Jacobians and residuals:
    (r_w, Jp, Jl, OJp, OJl)."""
    dt = g.poses.dtype
    ep = g.poses[g.obs_pose]
    el = g.lms[g.obs_lm]
    r = rhotheta_edge_residual(ep, el, g.obs_meas)
    Jp, Jl = rhotheta_edge_jacobians(ep, el, g.obs_meas)
    w_e = g.obs_valid.to(dt)
    free_p = (~g.pose_fixed[g.obs_pose]).to(dt)
    Jp = Jp * (w_e * free_p)[:, None, None]
    Jl = Jl * w_e[:, None, None]
    return r * w_e[:, None], Jp, Jl, g.obs_info @ Jp, g.obs_info @ Jl


def _vec(OJ, e):
    """einsum 'nba,nb->na'."""
    return torch.einsum("nba,nb->na", OJ, e)


def _assemble_lm_system(g: LMGraphData):
    """Build the (masked, fixed-aware) normal equations of the landmark
    graph: pose block Hpp (P,P,3,3), landmark diag Hll (L,2,2), coupling
    via obs edges kept in edge-list form for the Schur product."""
    P = g.poses.shape[0]
    L = g.lms.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    ar = torch.arange(P, device=dev)
    idx_prev, eo_w, Ji, Jj, OJi, OJj = _odom_terms(g)
    H_ij = _mm(Ji, OJj)

    Hpp = torch.zeros((P, P, 3, 3), dtype=dt, device=dev)
    Hpp.index_put_((idx_prev, idx_prev), _mm(Ji, OJi), accumulate=True)
    Hpp.index_put_((idx_prev, ar), H_ij, accumulate=True)
    Hpp.index_put_((ar, idx_prev), H_ij.transpose(-1, -2), accumulate=True)
    Hpp.index_put_((ar, ar), _mm(Jj, OJj), accumulate=True)
    bp = torch.zeros((P, 3), dtype=dt, device=dev)
    bp.index_put_((idx_prev,), -_vec(OJi, eo_w), accumulate=True)
    bp.index_put_((ar,), -_vec(OJj, eo_w), accumulate=True)

    r_w, Jp, Jl, OJp, OJl = _obs_terms(g)
    Hpl_e = _mm(Jp, OJl)  # (E,3,2)
    Hpp.index_put_((g.obs_pose, g.obs_pose), _mm(Jp, OJp), accumulate=True)
    bp.index_put_((g.obs_pose,), -_vec(OJp, r_w), accumulate=True)
    Hll = torch.zeros((L, 2, 2), dtype=dt, device=dev)
    Hll.index_put_((g.obs_lm,), _mm(Jl, OJl), accumulate=True)
    bl = torch.zeros((L, 2), dtype=dt, device=dev)
    bl.index_put_((g.obs_lm,), -_vec(OJl, r_w), accumulate=True)
    return Hpp, bp, Hll, bl, Hpl_e


def _cholesky_solve(A, b):
    """Solve SPD A x = b; NaN where the factorization fails (as the
    JAX package's cho_factor gives), so the LM step is rejected."""
    chol, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.nan)


def _schur_solve(g: LMGraphData, Hpp, bp, Hll, bl, Hpl_e, lam):
    """Solve the damped system via Schur elimination of landmarks.

    Damping: g2o's Levenberg adds lambda to every diagonal entry
    (BlockSolver::setLambda); inactive/fixed variables get identity
    diagonals so the dense factorization stays SPD and their update is 0.
    The factorizations check nothing on the host (the `_ex` calls): a
    failed one gives NaN, which the caller's chi2 test turns into a
    rejected step, as _cholesky_solve's does.
    """
    P = Hpp.shape[0]
    L = Hll.shape[0]
    dt, dev = Hpp.dtype, Hpp.device
    pose_free = (g.pose_valid & (~g.pose_fixed)).to(dt)
    lm_free = g.lm_valid.to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye2 = torch.eye(2, dtype=dt, device=dev)
    ar = torch.arange(P, device=dev)
    Hpp = Hpp.clone()
    Hpp[ar, ar] += (
        lam * eye3 * pose_free[:, None, None]
        + (1.0 - pose_free)[:, None, None] * eye3
    )
    Hll = Hll + lam * eye2 * lm_free[:, None, None] + (
        (1.0 - lm_free)[:, None, None] * eye2
    )
    bp = bp * pose_free[:, None]
    bl = bl * lm_free[:, None]

    Hll_inv, _ = torch.linalg.inv_ex(Hll, check_errors=False)
    # Schur: S = Hpp - sum over landmarks of the coupling products, with
    # the coupling scattered into a dense (P, L, 3, 2) tensor
    Hpl = torch.zeros((P, L, 3, 2), dtype=dt, device=dev)
    Hpl.index_put_((g.obs_pose, g.obs_lm), Hpl_e, accumulate=True)
    HplHinv = torch.einsum("plab,lbc->plac", Hpl, Hll_inv)
    S = Hpp - torch.einsum("plab,qlcb->pqac", HplHinv, Hpl)
    rhs = bp - torch.einsum("plab,lb->pa", HplHinv, bl)

    Sd = S.permute(0, 2, 1, 3).reshape(3 * P, 3 * P)
    dp = _cholesky_solve(Sd, rhs.reshape(3 * P)).reshape(P, 3)
    dl = torch.einsum(
        "lab,lb->la",
        Hll_inv,
        bl - torch.einsum("plab,pa->lb", Hpl, dp),
    )
    return dp * pose_free[:, None], dl * lm_free[:, None]


def _chol2(m):
    """Closed-form 2x2 Cholesky factor of SPD matrices (...,2,2)."""
    a = torch.sqrt(torch.clamp(m[..., 0, 0], min=1e-30))
    b = m[..., 1, 0] / a
    c = torch.sqrt(torch.clamp(m[..., 1, 1] - b * b, min=1e-30))
    z = torch.zeros_like(a)
    return torch.stack(
        [torch.stack([a, z], -1), torch.stack([b, c], -1)], -2
    )


def _lm_tridiag_assemble(g: LMGraphData):
    """Assemble the chain-structured landmark-graph normal equations:
    (D (P,3,3) undamped pose diag, O (P,3,3) chain off-diag, bp,
    Hll (L,2,2) undamped, bl, W_e (E,3,2) pose-landmark coupling)."""
    P = g.poses.shape[0]
    L = g.lms.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    ar = torch.arange(P, device=dev)
    idx_prev, eo_w, Ji, Jj, OJi, OJj = _odom_terms(g)
    D = torch.zeros((P, 3, 3), dtype=dt, device=dev)
    D.index_put_((idx_prev,), _mm(Ji, OJi), accumulate=True)
    D.index_put_((ar,), _mm(Jj, OJj), accumulate=True)
    O = _mm(Ji, OJj)  # H[i-1, i]
    bp = torch.zeros((P, 3), dtype=dt, device=dev)
    bp.index_put_((idx_prev,), -_vec(OJi, eo_w), accumulate=True)
    bp.index_put_((ar,), -_vec(OJj, eo_w), accumulate=True)

    r_w, Jp, Jl, OJp, OJl = _obs_terms(g)
    D.index_put_((g.obs_pose,), _mm(Jp, OJp), accumulate=True)
    Hll = torch.zeros((L, 2, 2), dtype=dt, device=dev)
    Hll.index_put_((g.obs_lm,), _mm(Jl, OJl), accumulate=True)
    W_e = _mm(Jp, OJl)  # (E,3,2) at (p_e, l_e)
    bp.index_put_((g.obs_pose,), -_vec(OJp, r_w), accumulate=True)
    bl = torch.zeros((L, 2), dtype=dt, device=dev)
    bl.index_put_((g.obs_lm,), -_vec(OJl, r_w), accumulate=True)
    return D, O, bp, Hll, bl, W_e


def _schur_solve_tridiag(g: LMGraphData, parts, lam):
    """O(P) landmark-graph solve: the pose chain factorizes as a block
    tridiagonal (tridiag_solve_cr), landmark elimination enters as a
    rank-2L Woodbury downdate.

    Math: after eliminating landmarks, S = T - V V^T with
    V[:, 2l:2l+2] = W_l chol(Hll_l^-1); then
    S^-1 b = T^-1 b + T^-1 V (I - V^T T^-1 V)^-1 V^T T^-1 b.
    No host read: the inverse and the solve are the `_ex` calls, a
    failed factorization giving NaN (a rejected step).
    """
    D, O, bp, Hll, bl, W_e = parts
    P = g.poses.shape[0]
    L = g.lms.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    pose_free = (g.pose_valid & (~g.pose_fixed)).to(dt)
    lm_free = g.lm_valid.to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye2 = torch.eye(2, dtype=dt, device=dev)
    D = D + (lam * pose_free + (1.0 - pose_free))[:, None, None] * eye3
    Hll = Hll + (lam * lm_free + (1.0 - lm_free))[:, None, None] * eye2
    bp = bp * pose_free[:, None]
    bl = bl * lm_free[:, None]
    Hll_inv, _ = torch.linalg.inv_ex(Hll, check_errors=False)

    # reduced rhs: b' = bp - W Hll^-1 bl (edge-wise scatter)
    hb = torch.einsum("lab,lb->la", Hll_inv, bl)  # (L,2)
    bp_red = bp.index_put(
        (g.obs_pose,),
        -torch.einsum("nab,nb->na", W_e, hb[g.obs_lm]),
        accumulate=True,
    )

    # V = W blockdiag(chol(Hll^-1)): assemble dense (3P, 2L) in 2-D
    R2 = _chol2(Hll_inv)  # (L,2,2)
    WR = W_e @ R2[g.obs_lm]  # (E,3,2)
    V = torch.zeros((3 * P, 2 * L), dtype=dt, device=dev)
    rows = (3 * g.obs_pose)[:, None] + torch.arange(3, device=dev)[None, :]
    cols = (2 * g.obs_lm)[:, None] + torch.arange(2, device=dev)[None, :]
    V.index_put_((rows[:, :, None], cols[:, None, :]), WR, accumulate=True)

    rhs = torch.cat([bp_red.reshape(3 * P, 1), V], dim=1).reshape(
        P, 3, 1 + 2 * L
    )
    X = tridiag_solve_cr(D, O, rhs).reshape(3 * P, 1 + 2 * L)
    xb, XV = X[:, 0], X[:, 1:]
    Mmat = torch.eye(2 * L, dtype=dt, device=dev) - V.T @ XV
    wvec, _ = torch.linalg.solve_ex(Mmat, V.T @ xb, check_errors=False)
    dp = (xb + XV @ wvec).reshape(P, 3)
    dp = dp * pose_free[:, None]

    # back-substitute landmarks: dl = Hll^-1 (bl - W^T dp)
    wtdp = torch.zeros((L, 2), dtype=dt, device=dev)
    wtdp.index_put_(
        (g.obs_lm,),
        torch.einsum("nab,na->nb", W_e, dp[g.obs_pose]),
        accumulate=True,
    )
    dl = torch.einsum("lab,lb->la", Hll_inv, bl - wtdp)
    dl = dl * lm_free[:, None]
    return dp, dl, bp, bl


def _lm_apply(g: LMGraphData, dp, dl) -> LMGraphData:
    poses = g.poses + dp
    poses[:, 2] = wrap_angle(poses[:, 2])
    lms = g.lms + dl
    lms[:, 1] = wrap_angle(lms[:, 1])
    return g._replace(poses=poses, lms=lms)


def _lm_prologue(g: LMGraphData, tau: float, use_tridiag: bool):
    """The LM solve's set-up: chi2 and dof at the start, and the initial
    lambda = tau * the largest diagonal entry of the first assembly.
    Returns 0-dim tensors (chi2, dof, lam, ni)."""
    chi2, dof = lm_graph_chi2(g)
    if use_tridiag:
        D0, _, _, Hll0, _, _ = _lm_tridiag_assemble(g)
        pose_diag = torch.diagonal(D0, dim1=-2, dim2=-1)
    else:
        Hpp0, _, Hll0, _, _ = _assemble_lm_system(g)
        ar = torch.arange(Hpp0.shape[0], device=Hpp0.device)
        pose_diag = torch.diagonal(Hpp0[ar, ar], dim1=-2, dim2=-1)
    diag_max = torch.maximum(
        pose_diag.abs().max(),
        torch.diagonal(Hll0, dim1=-2, dim2=-1).abs().max(),
    )
    lam = tau * diag_max
    return chi2, dof, lam, torch.full_like(lam, 2.0)


def _lm_step(g: LMGraphData, chi2, lam, ni, rtol: float, use_tridiag: bool,
             rec, read: bool):
    """One LM step from the state (g.poses, g.lms, chi2, lam, ni):
    assemble at g, solve the damped system, apply, chi2 of the trial,
    then the gain ratio, the lambda update and accept or restore.
    Returns the new state (poses, lms, chi2, lam, ni) and the stop flags
    (small, damped, accept): a (3,) bool tensor, its list where `read`
    (the step's one host read, at the end of slam.lm.decide), None
    where rtol is 0 (no early stop to decide)."""
    with rec.span("slam.lm.assemble"):
        if use_tridiag:
            parts = _lm_tridiag_assemble(g)
            bp, bl = parts[2], parts[4]
        else:
            Hpp, bp, Hll, bl, Hpl_e = _assemble_lm_system(g)
    with rec.span("slam.lm.solve"):
        if use_tridiag:
            dp, dl, _, _ = _schur_solve_tridiag(g, parts, lam)
        else:
            dp, dl = _schur_solve(g, Hpp, bp, Hll, bl, Hpl_e, lam)
        g_new = _lm_apply(g, dp, dl)
    with rec.span("slam.lm.chi2"):
        chi2_new, _ = lm_graph_chi2(g_new)
    with rec.span("slam.lm.decide"):
        # gain ratio rho = (chi2 - chi2_new) / (d^T (lam d + b))
        lin = ((dp * (lam * dp + bp)).sum()
               + (dl * (lam * dl + bl)).sum())
        rho = (chi2 - chi2_new) / torch.clamp(lin, min=1e-12)
        accept = (rho > 0.0) & torch.isfinite(chi2_new)
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_new = torch.where(accept, lam * factor, lam * ni)
        ni_new = torch.where(accept, 2.0, ni * 2.0)
        poses = torch.where(accept, g_new.poses, g.poses)
        lms = torch.where(accept, g_new.lms, g.lms)
        flags = None
        if rtol > 0.0:
            rel_impr = torch.where(
                accept,
                (chi2 - chi2_new) / torch.clamp(chi2, min=1e-30),
                torch.inf,
            )
            flags = torch.stack((rel_impr < rtol, lam_new > 1e10, accept))
            if read:
                flags = flags.tolist()
        chi2_new = torch.where(accept, chi2_new, chi2)
    return poses, lms, chi2_new, lam_new, ni_new, flags


# the graph cache of optimize_landmark_graph: key -> _SEEN after a first
# (eager) solve, then the key's _LMGraphs, or _EAGER where capture raised
_LM_GRAPHS: dict = {}
_LM_GRAPHS_LOCK = threading.Lock()
_SEEN, _EAGER = "seen", "eager"
_CAPTURE_STREAMS: dict = {}


@contextlib.contextmanager
def _capturing(graph, pool):
    """Capture the block into `graph` on the current stream, in
    thread-local mode: other threads (the realtime backend on its own
    stream) may go on calling CUDA meanwhile."""
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        yield
    except BaseException:
        try:
            graph.capture_end()
        except RuntimeError:
            pass
        raise
    graph.capture_end()


class _LMGraphs:
    """The prologue and the step of one cache key, each captured once as
    a CUDA graph, with their static tensors: the inputs (`g`, laid out
    in one flat buffer per dtype, in field order, as
    interop.lm_graph_from_numpy packs them), the state (g.poses, g.lms,
    chi2, lam, ni, which each step replay overwrites in place), dof and
    the stop flags. Both graphs share one private memory pool, which no
    other key's graphs use."""

    def __init__(self, g: LMGraphData, tau: float, rtol: float,
                 use_tridiag: bool):
        dev = g.poses.device
        groups, views = {}, {}
        for name, t in zip(g._fields, g):
            groups.setdefault(t.dtype, []).append(name)
        self.groups = []
        for dt, names in groups.items():
            buf = torch.empty(sum(getattr(g, k).numel() for k in names),
                              dtype=dt, device=dev)
            layout, o = [], 0
            for k in names:
                t = getattr(g, k)
                views[k] = buf[o : o + t.numel()].view(t.shape)
                layout.append((k, o))
                o += t.numel()
            self.groups.append((buf, layout))
        self.g = LMGraphData(**views)
        self.prologue = torch.cuda.CUDAGraph()
        self.step = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        quiet = Recorder()
        stream = _CAPTURE_STREAMS.get(dev)
        if stream is None:
            stream = _CAPTURE_STREAMS.setdefault(dev, torch.cuda.Stream(dev))
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            with _capturing(self.prologue, pool):
                self.chi2, self.dof, self.lam, self.ni = _lm_prologue(
                    self.g, tau, use_tridiag)
            with _capturing(self.step, pool):
                poses, lms, chi2, lam, ni, self.flags = _lm_step(
                    self.g, self.chi2, self.lam, self.ni, rtol, use_tridiag,
                    quiet, read=False)
                for dst, src in ((self.g.poses, poses), (self.g.lms, lms),
                                 (self.chi2, chi2), (self.lam, lam),
                                 (self.ni, ni)):
                    dst.copy_(src)
        torch.cuda.current_stream(dev).wait_stream(stream)

    def load(self, g: LMGraphData) -> None:
        """Copy g into the static inputs: one copy per dtype where g's
        fields are views of one flat buffer in this layout (as
        interop.lm_graph_from_numpy uploads them), else one per field."""
        for buf, layout in self.groups:
            base = getattr(g, layout[0][0])._base
            if base is not None and (base.dim() == 1 and
                                     base.numel() == buf.numel()):
                b0 = base.storage_offset()
                for k, o in layout:
                    t = getattr(g, k)
                    if (t._base is not base or not t.is_contiguous()
                            or t.storage_offset() - b0 != o):
                        base = None
                        break
            else:
                base = None
            if base is not None:
                buf.copy_(base)
            else:
                for k, _ in layout:
                    getattr(self.g, k).copy_(getattr(g, k))


def _lm_graphs(g: LMGraphData, tau: float, rtol: float, use_tridiag: bool,
               rec):
    """The _LMGraphs to replay this solve with, or None to run it
    eagerly: always on the CPU; on the card the first solve of a key
    (the padded (P, L, E), the fields' dtypes, the device and its
    current stream, tau, rtol and the path) runs eagerly, which warms the
    cuBLAS and cuSOLVER handles and workspaces, the second captures,
    later ones replay. A key whose capture raised stays eager."""
    if not g.poses.is_cuda:
        return None
    dev = g.poses.device
    key = (tuple(g.poses.shape), tuple(g.lms.shape), tuple(g.obs_pose.shape),
           tuple(t.dtype for t in g), dev, torch.cuda.current_stream(dev),
           tau, rtol, use_tridiag)
    with _LM_GRAPHS_LOCK:
        entry = _LM_GRAPHS.get(key)
        if entry is None:
            _LM_GRAPHS[key] = _SEEN
            return None
        if entry is _SEEN:
            try:
                entry = _LMGraphs(g, tau, rtol, use_tridiag)
                rec.count("lm.graph.captures", 2)
            except Exception:
                entry = _EAGER
                rec.count("lm.graph.fallback")
            _LM_GRAPHS[key] = entry
    return None if entry is _EAGER else entry


def _lm_solve(g: LMGraphData, iterations: int, tau: float, rtol: float,
              use_tridiag: bool, rec, graphs):
    """optimize_landmark_graph's loop: eager where `graphs` is None,
    else by replaying its captured prologue and step."""
    if graphs is None:
        chi2, dof, lam, ni = _lm_prologue(g, tau, use_tridiag)
    else:
        graphs.load(g)
        graphs.prologue.replay()
    stop = "lm.stop.cap"
    for _ in range(iterations):
        with rec.span("slam.lm.step"):
            if graphs is None:
                poses, lms, chi2, lam, ni, flags = _lm_step(
                    g, chi2, lam, ni, rtol, use_tridiag, rec,
                    read=rtol > 0.0)
                g = g._replace(poses=poses, lms=lms)
            else:
                with rec.span("slam.lm.replay"):
                    graphs.step.replay()
                with rec.span("slam.lm.decide"):
                    if rtol > 0.0:
                        flags = graphs.flags.tolist()
        rec.count("lm.iterations")
        rec.count("lm.graph.eager" if graphs is None else "lm.graph.replays")
        if rtol > 0.0:
            small, damped, took = flags
            if not took:
                rec.count("lm.rejected")
            if small or damped:
                stop = "lm.stop.rtol" if small else "lm.stop.lambda"
                break
    if rtol > 0.0:
        rec.count(stop)
    if graphs is not None:
        # clones: no caller holds a graph's static tensor
        g = g._replace(poses=graphs.g.poses.clone(),
                       lms=graphs.g.lms.clone())
        chi2, dof = graphs.chi2.clone(), graphs.dof.clone()
    return g, chi2, dof


def optimize_landmark_graph(
    g: LMGraphData, iterations: int = 15, tau: float = 1e-5,
    tridiag_threshold: int = 128, rtol: float = 1e-7, rec=None,
):
    """Levenberg-Marquardt with g2o's damping schedule
    (OptimizationAlgorithmLevenberg): initial lambda = tau * max diag(H),
    gain-ratio-driven lambda update, reject restores the previous state.
    Replaces lm_graph.opt.optimize(15) (drone.cpp:146-156).

    Returns (g_optimized, chi2, dof) with 0-dim tensors chi2, dof.

    The linear-solve path is chosen by the padded window size: dense
    Schur below `tridiag_threshold` poses, block-tridiagonal + Woodbury
    (O(P)) from there up.

    rtol > 0 stops once an accepted step improves chi2 by less than
    rtol relatively (or lambda passes 1e10); rtol=0 runs exactly
    `iterations` steps.

    On the CPU both the set-up (_lm_prologue) and each step (_lm_step)
    run eagerly. On the card, from the second solve of a padded shape
    on (_lm_graphs), each is one CUDA graph replayed on the current
    stream: the solve copies g into the graphs' static inputs, replays
    the set-up once and the step per iteration, and reads the step's
    stop flags on the host after each replay, as the eager loop does.
    The step enqueues no other host read. The same kernels run either
    way, so the results are the same bits.

    rec: the caller's utils.trace.Recorder. Counted: lm.solves,
    lm.iterations, lm.tridiag, the padded (P, L, E) under the tally
    lm.shapes and, where rtol > 0 (the one host read of each step
    reads them), lm.rejected and why the solve ended (lm.stop.rtol,
    lm.stop.lambda, lm.stop.cap); lm.graph.captures (graphs captured,
    two a shape), lm.graph.replays and lm.graph.eager (steps replayed,
    steps run eagerly) and lm.graph.fallback (shapes whose capture
    raised, eager from then on). Spans: slam.lm.step per iteration;
    eagerly with slam.lm.assemble, slam.lm.solve, slam.lm.chi2 and
    slam.lm.decide, on a graph with slam.lm.replay and slam.lm.decide;
    slam.lm.decide ends in the host read.
    """
    rec = rec if rec is not None else Recorder()
    use_tridiag = g.poses.shape[0] >= tridiag_threshold
    rec.count("lm.solves")
    rec.tally("lm.shapes", (g.poses.shape[0], g.lms.shape[0],
                            g.obs_pose.shape[0]))
    if use_tridiag:
        rec.count("lm.tridiag")
    graphs = _lm_graphs(g, tau, rtol, use_tridiag, rec)
    return _lm_solve(g, iterations, tau, rtol, use_tridiag, rec, graphs)


# ---------------------------------------------------------------------------
# robust kernel
# ---------------------------------------------------------------------------


def dcs_weight(chi2, phi):
    """Dynamic Covariance Scaling weight s^2, s = min(1, 2 phi/(phi+chi2))
    (g2o RobustKernelDCS::robustify; reference submap_loop_closer.cpp:41)."""
    s = torch.clamp(2.0 * phi / (phi + chi2), max=1.0)
    return s * s


# ---------------------------------------------------------------------------
# pose-graph system (chain + loop closures, DCS-robustified GN)
# ---------------------------------------------------------------------------


class PoseGraphData(NamedTuple):
    """Fixed-shape pose-graph tensors (reference: include/graphs.h:30-40)."""

    poses: torch.Tensor  # (N, 3)
    valid: torch.Tensor  # (N,) bool
    fixed: torch.Tensor  # (N,) bool
    chain_meas: torch.Tensor  # (N, 3) edge i-1 -> i
    chain_info: torch.Tensor  # (N, 3, 3)
    chain_valid: torch.Tensor  # (N,) bool
    clo_i: torch.Tensor  # (C,) int64
    clo_j: torch.Tensor  # (C,) int64
    clo_meas: torch.Tensor  # (C, 3)
    clo_info: torch.Tensor  # (C, 3, 3)
    clo_valid: torch.Tensor  # (C,) bool


def posegraph_chi2(g: PoseGraphData, phi: float | None = None):
    """chi2 of all active edges; closure chi2 optionally DCS-scaled
    (g2o adds rho(chi2) = w chi2 to the robust objective)."""
    N = g.poses.shape[0]
    idx_prev = _idx_prev(N, g.poses.device)
    eo = se2_edge_residual(g.poses[idx_prev], g.poses, g.chain_meas)
    c_o = torch.einsum("ni,nij,nj->n", eo, g.chain_info, eo)
    chi2 = torch.where(g.chain_valid, c_o, 0.0).sum()
    c_c = closure_chi2(g)
    if phi is not None:
        c_c = dcs_weight(c_c, phi) * c_c
    return chi2 + torch.where(g.clo_valid, c_c, 0.0).sum()


def closure_chi2(g: PoseGraphData):
    """Raw chi2 per closure edge (for the 11.345 pruning gate,
    log_runner.cpp:182-190)."""
    ec = se2_edge_residual(g.poses[g.clo_i], g.poses[g.clo_j], g.clo_meas)
    return torch.einsum("ni,nij,nj->n", ec, g.clo_info, ec)


def _assemble_posegraph(g: PoseGraphData, phi):
    """Block diagonal (N,3,3), chain off-diagonal (N,3,3) at (i-1, i),
    closure off-diagonal (C,3,3) at (clo_i, clo_j) and gradient (N,3)
    of the DCS-weighted normal equations."""
    N = g.poses.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    ar = torch.arange(N, device=dev)
    idx_prev = _idx_prev(N, dev)

    def edge_terms(ii, jj, meas, info, valid, robust):
        xi, xj = g.poses[ii], g.poses[jj]
        e = se2_edge_residual(xi, xj, meas)
        Ji, Jj = se2_edge_jacobians(xi, xj, meas)
        w = valid.to(dt)
        if robust:
            chi2_e = torch.einsum("ni,nij,nj->n", e, info, e)
            w = w * dcs_weight(chi2_e, phi)
        Ji = Ji * (~g.fixed[ii]).to(dt)[:, None, None]
        Jj = Jj * (~g.fixed[jj]).to(dt)[:, None, None]
        info_w = info * w[:, None, None]
        return e, Ji, Jj, info_w @ Ji, info_w @ Jj

    Hd = torch.zeros((N, 3, 3), dtype=dt, device=dev)
    b = torch.zeros((N, 3), dtype=dt, device=dev)

    # chain edges: prev -> cur
    e, Ji, Jj, OJi, OJj = edge_terms(
        idx_prev, ar, g.chain_meas, g.chain_info, g.chain_valid, False
    )
    Hd.index_add_(0, idx_prev, _mm(Ji, OJi))
    Hd.index_add_(0, ar, _mm(Jj, OJj))
    H_off_chain = _mm(Ji, OJj)
    b.index_add_(0, idx_prev, -_vec(OJi, e))
    b.index_add_(0, ar, -_vec(OJj, e))

    # closure edges (DCS)
    ec, Jci, Jcj, OJci, OJcj = edge_terms(
        g.clo_i, g.clo_j, g.clo_meas, g.clo_info, g.clo_valid, True
    )
    Hd.index_add_(0, g.clo_i, _mm(Jci, OJci))
    Hd.index_add_(0, g.clo_j, _mm(Jcj, OJcj))
    H_off_clo = _mm(Jci, OJcj)
    b.index_add_(0, g.clo_i, -_vec(OJci, ec))
    b.index_add_(0, g.clo_j, -_vec(OJcj, ec))
    return Hd, H_off_chain, H_off_clo, b


def _posegraph_dense_solve(g: PoseGraphData, Hd, H_off_chain, H_off_clo, b):
    """Assemble the dense (3N,3N) H and Cholesky-solve it, with Jacobi
    equilibration and a 1e-6 ridge on the equilibrated diagonal (the
    JAX package's treatment: odometry informations span ~2e-4..6e3 on
    real logs, cond(H) ~1e8-1e9). Inactive and fixed poses get identity
    blocks and a zero step."""
    N = g.poses.shape[0]
    dt, dev = Hd.dtype, Hd.device
    ar = torch.arange(N, device=dev)
    free = (g.valid & (~g.fixed)).to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hd = Hd + (1.0 - free)[:, None, None] * eye3 + 1e-8 * eye3
    b = b * free[:, None]

    H = torch.zeros((N, N, 3, 3), dtype=dt, device=dev)
    H.index_put_((ar, ar), Hd, accumulate=True)
    idx_prev = _idx_prev(N, dev)
    cv = g.chain_valid.to(dt)[:, None, None]
    H.index_put_((idx_prev, ar), H_off_chain * cv, accumulate=True)
    H.index_put_((ar, idx_prev), H_off_chain.transpose(-1, -2) * cv,
                 accumulate=True)
    clv = g.clo_valid.to(dt)[:, None, None]
    H.index_put_((g.clo_i, g.clo_j), H_off_clo * clv, accumulate=True)
    H.index_put_((g.clo_j, g.clo_i), H_off_clo.transpose(-1, -2) * clv,
                 accumulate=True)

    Hdense = H.permute(0, 2, 1, 3).reshape(3 * N, 3 * N)
    s = torch.rsqrt(torch.clamp(torch.diagonal(Hdense), min=1e-30))
    Hs = Hdense * s[:, None] * s[None, :]
    Hs = Hs + 1e-6 * torch.eye(3 * N, dtype=dt, device=dev)
    chol, _ = torch.linalg.cholesky_ex(Hs)
    y = torch.cholesky_solve((s * b.reshape(3 * N))[:, None], chol)[:, 0]
    d = (s * y).reshape(N, 3)
    return d * free[:, None]


def gnc_phi_schedule(phi, iterations: int, init_scale: float,
                     anneal_frac: float = 0.75, dtype=torch.float64,
                     device="cpu"):
    """Graduated non-convexity schedule for the DCS parameter: start at
    phi*init_scale (large phi => w ~ 1, convex least squares) and decay
    geometrically to the target phi over the first anneal_frac of the
    iterations, then hold. init_scale=1 reproduces fixed-phi DCS (the
    reference's g2o RobustKernelDCS behavior)."""
    t = torch.arange(iterations, dtype=torch.float64)
    T_a = max(int(anneal_frac * iterations), 1)
    expo = torch.clamp(1.0 - t / T_a, 0.0, 1.0)
    out = phi * torch.pow(torch.tensor(init_scale, dtype=torch.float64),
                          expo)
    return out.to(dtype=dtype, device=device)


def optimize_pose_graph(
    g: PoseGraphData, phi: float, iterations: int = 20,
    gnc_init_scale: float = 1.0, rec=None,
) -> PoseGraphData:
    """Gauss-Newton with DCS-reweighted closures, fixed iteration count
    (pose_graph.opt.optimize(20), submap_loop_closer.cpp:286-288), on
    the device of `g`; no host synchronization. gnc_init_scale > 1
    enables graduated non-convexity (gnc_phi_schedule). rec: the
    caller's utils.trace.Recorder, which counts pg.solves and
    pg.iterations."""
    if rec is not None:
        rec.count("pg.solves")
        rec.count("pg.iterations", iterations)
    phis = gnc_phi_schedule(phi, iterations, gnc_init_scale,
                            dtype=g.poses.dtype, device=g.poses.device)
    for k in range(iterations):
        Hd, Hoc, Hocl, b = _assemble_posegraph(g, phis[k])
        d = _posegraph_dense_solve(g, Hd, Hoc, Hocl, b)
        poses = g.poses + d
        poses[:, 2] = wrap_angle(poses[:, 2])
        g = g._replace(poses=poses)
    return g


# ---------------------------------------------------------------------------
# joint landmark + pose-graph system (final global bundle adjustment)
# ---------------------------------------------------------------------------


class JointGraphData(NamedTuple):
    """Fixed-shape tensors for the final joint solve: the landmark graph
    (odometry chain + line-landmark observations, LMGraphData layout)
    plus the pose graph's extra edges (loop closures, submap chain
    edges, keyframe pins) as DCS-robustified SE2 edges. No reference
    counterpart: the reference discards the landmark graph at every
    loop closure and finishes pose-graph-only (log_runner.cpp:203-205);
    the joint solve keeps every original measurement (raw odometry,
    each landmark observation, the closures)."""

    poses: torch.Tensor  # (P, 3)
    pose_valid: torch.Tensor  # (P,) bool
    pose_fixed: torch.Tensor  # (P,) bool
    odom_meas: torch.Tensor  # (P, 3)
    odom_info: torch.Tensor  # (P, 3, 3)
    odom_valid: torch.Tensor  # (P,) bool
    lms: torch.Tensor  # (L, 2)
    lm_valid: torch.Tensor  # (L,) bool
    obs_pose: torch.Tensor  # (E,) int64
    obs_lm: torch.Tensor  # (E,) int64
    obs_meas: torch.Tensor  # (E, 2)
    obs_info: torch.Tensor  # (E, 2, 2)
    obs_valid: torch.Tensor  # (E,) bool
    clo_i: torch.Tensor  # (C,) int64
    clo_j: torch.Tensor  # (C,) int64
    clo_meas: torch.Tensor  # (C, 3)
    clo_info: torch.Tensor  # (C, 3, 3)
    clo_valid: torch.Tensor  # (C,) bool


def _joint_lm_view(g: JointGraphData) -> LMGraphData:
    return LMGraphData(*g[: len(LMGraphData._fields)])


def joint_graph_chi2(g: JointGraphData, phi: float):
    """Robust objective: odometry + observation chi2 plus the
    DCS-scaled closure chi2 (0-dim tensor)."""
    chi2, _ = lm_graph_chi2(_joint_lm_view(g))
    ec = se2_edge_residual(g.poses[g.clo_i], g.poses[g.clo_j], g.clo_meas)
    c_c = torch.einsum("ni,nij,nj->n", ec, g.clo_info, ec)
    c_c = dcs_weight(c_c, phi) * c_c
    return chi2 + torch.where(g.clo_valid, c_c, 0.0).sum()


def _assemble_joint_system(g: JointGraphData, phi: float):
    """Normal equations of the joint system: the landmark-graph terms
    (dense pose block Hpp, landmark diagonal, coupling edges) plus the
    DCS-weighted closure terms added into Hpp and bp. Padded closures
    all point at (0, 0) with zero weight: the scatter-adds accumulate."""
    Hpp, bp, Hll, bl, Hpl_e = _assemble_lm_system(_joint_lm_view(g))
    dt = g.poses.dtype
    xi, xj = g.poses[g.clo_i], g.poses[g.clo_j]
    e = se2_edge_residual(xi, xj, g.clo_meas)
    Ji, Jj = se2_edge_jacobians(xi, xj, g.clo_meas)
    chi2_e = torch.einsum("ni,nij,nj->n", e, g.clo_info, e)
    w = g.clo_valid.to(dt) * dcs_weight(chi2_e, phi)
    Ji = Ji * (~g.pose_fixed[g.clo_i]).to(dt)[:, None, None]
    Jj = Jj * (~g.pose_fixed[g.clo_j]).to(dt)[:, None, None]
    info_w = g.clo_info * w[:, None, None]
    OJi = info_w @ Ji
    OJj = info_w @ Jj
    H_ij = _mm(Ji, OJj)
    Hpp.index_put_((g.clo_i, g.clo_i), _mm(Ji, OJi), accumulate=True)
    Hpp.index_put_((g.clo_j, g.clo_j), _mm(Jj, OJj), accumulate=True)
    Hpp.index_put_((g.clo_i, g.clo_j), H_ij, accumulate=True)
    Hpp.index_put_((g.clo_j, g.clo_i), H_ij.transpose(-1, -2),
                   accumulate=True)
    bp.index_put_((g.clo_i,), -_vec(OJi, e), accumulate=True)
    bp.index_put_((g.clo_j,), -_vec(OJj, e), accumulate=True)
    return Hpp, bp, Hll, bl, Hpl_e


def _joint_schur_solve(g: JointGraphData, Hpp, bp, Hll, bl, Hpl_e, lam):
    """Damped joint solve, Schur-eliminating the landmarks. The fill-in
    is one matmul, S = Hpp - U U^T with U = Hpl chol(Hll^-1) laid out
    (3P, 2L), as the JAX package forms it (not _schur_solve's pairwise
    einsum, which sums in another order). A failed Cholesky gives NaN,
    which the caller's chi2 test turns into a rejected step."""
    P = Hpp.shape[0]
    L = Hll.shape[0]
    dt, dev = Hpp.dtype, Hpp.device
    pose_free = (g.pose_valid & (~g.pose_fixed)).to(dt)
    lm_free = g.lm_valid.to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye2 = torch.eye(2, dtype=dt, device=dev)
    ar = torch.arange(P, device=dev)
    Hpp = Hpp.clone()
    Hpp[ar, ar] += (
        lam * eye3 * pose_free[:, None, None]
        + (1.0 - pose_free)[:, None, None] * eye3
    )
    Hll = Hll + lam * eye2 * lm_free[:, None, None] + (
        (1.0 - lm_free)[:, None, None] * eye2
    )
    bp = bp * pose_free[:, None]
    bl = bl * lm_free[:, None]

    Hll_inv, _ = torch.linalg.inv_ex(Hll, check_errors=False)
    Hpl = torch.zeros((P, L, 3, 2), dtype=dt, device=dev)
    Hpl.index_put_((g.obs_pose, g.obs_lm), Hpl_e, accumulate=True)
    R2 = _chol2(Hll_inv)  # (L,2,2): Hll_inv = R2 R2^T
    U = torch.einsum("plab,lbc->plac", Hpl, R2)
    # (3P, 2L): row p*3+a, col l*2+c
    U2 = U.permute(0, 2, 1, 3).reshape(3 * P, 2 * L)
    Sd = Hpp.permute(0, 2, 1, 3).reshape(3 * P, 3 * P) - U2 @ U2.T
    rhs = (
        bp - torch.einsum("plab,lbc,lc->pa", Hpl, Hll_inv, bl)
    ).reshape(3 * P)
    dp = _cholesky_solve(Sd, rhs).reshape(P, 3)
    dl = torch.einsum(
        "lab,lb->la",
        Hll_inv,
        bl - torch.einsum("plab,pa->lb", Hpl, dp),
    )
    return dp * pose_free[:, None], dl * lm_free[:, None]


def optimize_joint_graph(
    g: JointGraphData, phi: float, iterations: int = 12,
    tau: float = 1e-6, rtol: float = 1e-9,
):
    """Levenberg-Marquardt on the joint landmark + pose system, with
    optimize_landmark_graph's damping schedule; closures are
    DCS-reweighted at every relinearization. Warm-started from the
    pose-graph solution. One host sync per iteration decides the early
    stop (an accepted step improving chi2 by less than rtol
    relatively, or lambda past 1e10).

    Returns (g_optimized, chi2) with a 0-dim chi2."""
    chi2 = joint_graph_chi2(g, phi)
    Hpp0, _, Hll0, _, _ = _assemble_joint_system(g, phi)
    ar = torch.arange(Hpp0.shape[0], device=Hpp0.device)
    lam = tau * torch.maximum(
        torch.diagonal(Hpp0[ar, ar], dim1=-2, dim2=-1).abs().max(),
        torch.diagonal(Hll0, dim1=-2, dim2=-1).abs().max(),
    )
    del Hpp0
    ni = torch.full_like(lam, 2.0)
    for _ in range(iterations):
        Hpp, bp, Hll, bl, Hpl_e = _assemble_joint_system(g, phi)
        dp, dl = _joint_schur_solve(g, Hpp, bp, Hll, bl, Hpl_e, lam)
        del Hpp
        g_new = _lm_apply(g, dp, dl)
        chi2_new = joint_graph_chi2(g_new, phi)
        lin = (dp * (lam * dp + bp)).sum() + (dl * (lam * dl + bl)).sum()
        rho = (chi2 - chi2_new) / torch.clamp(lin, min=1e-12)
        accept = (rho > 0.0) & torch.isfinite(chi2_new)
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_next = torch.where(accept, lam * factor, lam * ni)
        ni = torch.where(accept, 2.0, ni * 2.0)
        g = g._replace(
            poses=torch.where(accept, g_new.poses, g.poses),
            lms=torch.where(accept, g_new.lms, g.lms),
        )
        rel_impr = torch.where(
            accept, (chi2 - chi2_new) / torch.clamp(chi2, min=1e-30),
            torch.inf,
        )
        chi2 = torch.where(accept, chi2_new, chi2)
        lam = lam_next
        if bool((rel_impr < rtol) | (lam > 1e10)):
            break
    return g, chi2
