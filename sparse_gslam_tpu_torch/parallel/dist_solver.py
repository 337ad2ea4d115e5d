"""Keyframe-partitioned Gauss-Newton pose-graph solver via the Schur
complement of the block boundaries, on torch tensors.

Port of sparse_gslam_tpu/parallel/dist_solver.py, its single-device
driver. The scalable counterpart of ops.solvers.optimize_pose_graph
(which assembles one dense (3N,3N) system): poses split into P
contiguous blocks of M; each block's interior chain system is
block-tridiagonal and is solved by batched cyclic reduction
(ops.solvers.tridiag_solve_cr, log2 M levels over all P blocks at
once), the separator system (block boundaries + closure endpoints; a
few hundred DOF) is assembled from the per-block Schur pieces and
solved by one equilibrated Cholesky, then interiors back-substitute.
One GN iteration is exact -- the dense solve up to roundoff.

Separator slot convention (parallel.partition.make_partition): slot b
(b < n_blocks-1) is the boundary pose of block b (its last pose), so
the pose preceding block p's first pose is separator slot p-1, always
local slot 0 of block p. Closure endpoints occupy later slots.

Everything runs on the device of the input tensors, in their dtype
(float64 in the port), with TF32 off (ops/solvers.py). Differences from
the JAX package:
  - its vmap over blocks is a leading P dimension of every tensor, its
    lax.scan over the GNC schedule a Python loop;
  - scatter-adds are `index_put_(accumulate=True)` into buffers with
    one sentinel row or slot that is sliced off (the JAX package's
    `.at[].add(mode="drop")`), and its one-hot products (a workaround
    for slow TPU gathers) are gathers; the values are the same, the
    order of summation differs, so results agree to rounding;
  - the interior solve is cyclic reduction where the JAX package runs
    the sequential LDL sweep (`tridiag_solve`); both solve the same
    equilibrated SPD system.
The multi-device driver (optimize_pose_graph_sharded) is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.solvers import (
    PoseGraphData,
    dcs_weight,
    gnc_phi_schedule,
    se2_edge_jacobians,
    se2_edge_residual,
    tridiag_solve_cr,
)
from ..utils.se2 import wrap_angle
from .partition import PartitionPlan, make_partition


class BlockedGraph(NamedTuple):
    poses: torch.Tensor  # (P, M, 3)
    valid: torch.Tensor  # (P, M)
    fixed: torch.Tensor  # (P, M)
    chain_meas: torch.Tensor  # (P, M, 3)
    chain_info: torch.Tensor  # (P, M, 3, 3)
    chain_valid: torch.Tensor  # (P, M)
    sep_local: torch.Tensor  # (P, M) int64 LOCAL separator id or -1
    loc_sep: torch.Tensor  # (P, K) int64 global slot ids, -1 padded


class SepGraph(NamedTuple):
    """Separator + closure tensors, shared by all blocks."""

    sep_pose_block: torch.Tensor  # (S,) owning block of each separator
    sep_pose_off: torch.Tensor  # (S,) local offset within block
    sep_valid: torch.Tensor  # (S,)
    clo_sep_i: torch.Tensor  # (C,)
    clo_sep_j: torch.Tensor  # (C,)
    clo_meas: torch.Tensor  # (C, 3)
    clo_info: torch.Tensor  # (C, 3, 3)
    clo_valid: torch.Tensor  # (C,)
    # compact (block, slot) enumerations (see PartitionPlan)
    pair_block: torch.Tensor  # (Q,)
    pair_ki: torch.Tensor
    pair_kj: torch.Tensor
    pair_si: torch.Tensor
    pair_sj: torch.Tensor
    single_block: torch.Tensor  # (Q2,)
    single_k: torch.Tensor
    single_s: torch.Tensor


def split_graph(g: PoseGraphData, plan: PartitionPlan):
    """(BlockedGraph, SepGraph) of `g` under `plan`, on g's device."""
    P, M = plan.n_blocks, plan.block_size
    dev = g.poses.device

    def r(a):
        return a.reshape((P, M) + tuple(a.shape[1:]))

    def idx(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    bg = BlockedGraph(
        poses=r(g.poses), valid=r(g.valid), fixed=r(g.fixed),
        chain_meas=r(g.chain_meas), chain_info=r(g.chain_info),
        chain_valid=r(g.chain_valid),
        sep_local=r(idx(plan.sep_local_id)),
        loc_sep=idx(plan.loc_sep),
    )
    # a separator slot whose underlying pose is padding or fixed must
    # get an identity row (update 0), not a (singular) zero row --
    # sep_valid below therefore means "free separator variable"
    sp = idx(plan.sep_pose)
    sep_valid = (torch.from_numpy(np.asarray(plan.sep_valid)).to(dev)
                 & g.valid[sp] & (~g.fixed[sp]))
    sg = SepGraph(
        sep_pose_block=idx(plan.sep_pose // M),
        sep_pose_off=idx(plan.sep_pose % M),
        sep_valid=sep_valid,
        clo_sep_i=idx(plan.clo_sep_i),
        clo_sep_j=idx(plan.clo_sep_j),
        clo_meas=g.clo_meas,
        clo_info=g.clo_info,
        clo_valid=g.clo_valid,
        pair_block=idx(plan.pair_block),
        pair_ki=idx(plan.pair_ki),
        pair_kj=idx(plan.pair_kj),
        pair_si=idx(plan.pair_si),
        pair_sj=idx(plan.pair_sj),
        single_block=idx(plan.single_block),
        single_k=idx(plan.single_k),
        single_s=idx(plan.single_s),
    )
    return bg, sg


# ---------------------------------------------------------------------------
# per-block pieces (a leading P dimension over the blocks)
# ---------------------------------------------------------------------------


def _eq_chol_solve(Amat, rhs):
    """SPD solve with Jacobi equilibration. rhs may be a vector or a
    matrix (columns). NaN where the factorization fails, as the JAX
    package's cho_factor gives.

    Symmetrization first: closure information matrices arrive with
    ~1e-5 relative asymmetry (float32 covariance assembly amplified by
    the inversion), which propagates into the separator system; a
    Cholesky reads one triangle, and when the asymmetry exceeds the
    smallest equilibrated eigenvalue that triangle is indefinite.

    The dtype-scaled relative ridge (the equilibrated diagonal is
    exactly 1; 8*eps = ~1e-6 in float32, ~2e-15 in float64): the
    separator Schur complement Hss - sum His A^-1 His^T is formed by
    floating subtraction and can come out marginally indefinite when a
    sharp closure pushes cond(H) toward 1/eps. The ridge must scale
    with eps: a flat 1e-6 on the float64 path damps the long-chain
    compliant modes (equilibrated eigenvalues ~1e-7) and doubles the
    sim-killian trajectory error."""
    Amat = 0.5 * (Amat + Amat.T)
    d = torch.clamp(torch.diagonal(Amat), min=1e-20)
    s = torch.rsqrt(d)
    A_eq = Amat * s[:, None] * s[None, :]
    ridge = 8.0 * torch.finfo(A_eq.dtype).eps
    A_eq = A_eq + ridge * torch.eye(A_eq.shape[0], dtype=A_eq.dtype,
                                    device=A_eq.device)
    chol, info = torch.linalg.cholesky_ex(A_eq)
    col = rhs.ndim == 1
    b = (rhs * s)[:, None] if col else rhs * s[:, None]
    x = torch.cholesky_solve(b, chol)
    x = torch.where(info == 0, x, torch.nan)
    return x[:, 0] * s if col else x * s[:, None]


def _scatter_blocks(buf, bi, bj, vals):
    """Add (K,3,3) blocks into a block buffer (S+1, S+1, 3, 3) at block
    indices (bi, bj); entries with bi < 0 or bj < 0 go to the sentinel
    slot S, which the caller slices off."""
    sent = buf.shape[0] - 1
    ok = (bi >= 0) & (bj >= 0)
    buf.index_put_((torch.where(ok, bi, sent), torch.where(ok, bj, sent)),
                   vals, accumulate=True)


def _blocks_to_dense(buf):
    """(S+1, S+1, 3, 3) block buffer without its sentinel -> (3S, 3S)."""
    S = buf.shape[0] - 1
    return buf[:S, :S].permute(0, 2, 1, 3).reshape(3 * S, 3 * S)


def _shift_up(x):
    """out[:, m] = x[:, m+1], out[:, -1] = 0 (moves edge-m values to slot
    m-1), along the block's pose dimension."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def _ones_where(mask, value, dtype):
    """`value` where mask, else 1, in `dtype` (the constant is not
    rounded through the default float32 as torch.where(mask, v, 1.0)
    would)."""
    return torch.ones(mask.shape, dtype=dtype,
                      device=mask.device).masked_fill(mask, value)


def _mmT(a, b):
    """Batched a^T b over (P, M, 3, 3): einsum 'pnba,pnbc->pnac'."""
    return a.transpose(-1, -2) @ b


def _block_system(bg: BlockedGraph, poses, prev_last_pose, K: int,
                  b_ext=None):
    """Assemble every block's partitioned-system pieces in LOCAL
    separator indexing (K = local capacity; the driver scatters the
    local pieces into the global separator system via loc_sep).

    poses (P, M, 3); prev_last_pose (P, 3): the last pose of the
    previous block (zeros for block 0). b_ext (P, M, 3): an externally
    supplied gradient (refinement mode).

    Returns (Db (P,M,3,3) and Ob (P,M,3,3): the block-tridiagonal
    interior matrix, Ob[:, m] at (m-1, m); b_i (P, 3M); His (P, 3K,
    3M); Hss (P, 3K, 3K); b_s (P, 3K))."""
    P, M = poses.shape[0], poses.shape[1]
    dt, dev = poses.dtype, poses.device
    xi = torch.cat([prev_last_pose[:, None], poses[:, :-1]], dim=1)
    e = se2_edge_residual(xi, poses, bg.chain_meas)
    Ji, Jj = se2_edge_jacobians(xi, poses, bg.chain_meas)

    free = bg.valid & (~bg.fixed)
    interior = free & (bg.sep_local < 0)
    not_first = (torch.arange(P, device=dev) > 0)[:, None]

    # endpoint A of edge m: m=0 -> previous block's boundary (always
    # LOCAL separator id 0 by construction), m>0 -> local pose m-1
    sepA = torch.cat([torch.where(not_first, 0, -1), bg.sep_local[:, :-1]],
                     dim=1)
    intA = torch.cat([torch.zeros_like(not_first), interior[:, :-1]], dim=1)
    freeA = torch.cat([not_first, free[:, :-1]], dim=1)
    sepB, intB, freeB = bg.sep_local, interior, free

    w = bg.chain_valid.to(dt)
    Ji = Ji * (w * freeA.to(dt))[..., None, None]
    Jj = Jj * (w * freeB.to(dt))[..., None, None]
    OJi = bg.chain_info @ Ji
    OJj = bg.chain_info @ Jj
    Hii = _mmT(Ji, OJi)
    Hij = _mmT(Ji, OJj)
    Hjj = _mmT(Jj, OJj)
    ew = (e * w[..., None])[..., None]
    bi_ = -(OJi.transpose(-1, -2) @ ew)[..., 0]
    bj_ = -(OJj.transpose(-1, -2) @ ew)[..., 0]

    m_idx = torch.arange(M, device=dev)
    HijT = Hij.transpose(-1, -2)
    both = intA & intB & (m_idx > 0)

    if b_ext is None:
        # edge m contributes bi_ to pose m-1 (shift up) and bj_ to m
        b_i = torch.where(intB[..., None], bj_, 0.0) + _shift_up(
            torch.where(intA[..., None], bi_, 0.0))
    else:
        # refinement mode: the full gradient (chain + closures) was
        # computed externally in float64; interior rows take it
        # directly, separator rows get theirs via the driver's bs_ext
        b_i = torch.where(interior[..., None], b_ext.to(dt), 0.0)

    # block-tridiagonal interior system (identity rows keep padding /
    # separator slots decoupled)
    eye = torch.eye(3, dtype=dt, device=dev)
    Db = eye * _ones_where(interior, 1e-12, dt)[..., None, None]
    Db = Db + _shift_up(torch.where(intA[..., None, None], Hii, 0.0))
    Db = Db + torch.where(intB[..., None, None], Hjj, 0.0)
    Ob = torch.where(both[..., None, None], Hij, 0.0)

    # separator coupling (K local slots + a sentinel K)
    sA = torch.where(intA, -1, sepA)  # valid slot only when A is separator
    sB = torch.where(intB, -1, sepB)
    pp = torch.arange(P, device=dev)[:, None].expand(P, M)
    mm = m_idx[None].expand(P, M)
    His = torch.zeros((P, K + 1, M, 3, 3), dtype=dt, device=dev)
    # H_{A,B} = Hij with A = separator row, B = interior column m
    put = (sA >= 0) & intB
    His.index_put_((pp, torch.where(put, sA, K), mm), Hij, accumulate=True)
    # H_{B,A} = Hij^T with B = separator row, A = interior column m-1
    put2 = (sB >= 0) & intA
    His.index_put_((pp, torch.where(put2, sB, K), (mm - 1).clamp(min=0)),
                   HijT, accumulate=True)
    His_mat = His[:, :K].permute(0, 1, 3, 2, 4).reshape(P, 3 * K, 3 * M)

    putA = (sA >= 0) & freeA
    putB = (sB >= 0) & freeB
    putAB = (sA >= 0) & (sB >= 0)
    Hss = torch.zeros((P, K + 1, K + 1, 3, 3), dtype=dt, device=dev)
    a_ = torch.where(putA, sA, K)
    b_ = torch.where(putB, sB, K)
    abi = torch.where(putAB, sA, K)
    abj = torch.where(putAB, sB, K)
    Hss.index_put_((pp, a_, a_), Hii, accumulate=True)
    Hss.index_put_((pp, b_, b_), Hjj, accumulate=True)
    Hss.index_put_((pp, abi, abj), Hij, accumulate=True)
    Hss.index_put_((pp, abj, abi), HijT, accumulate=True)
    Hss_mat = Hss[:, :K, :K].permute(0, 1, 3, 2, 4).reshape(
        P, 3 * K, 3 * K)
    b_s = torch.zeros((P, K + 1, 3), dtype=dt, device=dev)
    if b_ext is None:
        b_s.index_put_((pp, a_), bi_, accumulate=True)
        b_s.index_put_((pp, b_), bj_, accumulate=True)

    return (Db, Ob, b_i.reshape(P, 3 * M), His_mat, Hss_mat,
            b_s[:, :K].reshape(P, 3 * K))


def _closure_system(sep_poses, sg: SepGraph, phi, S):
    """Closure contributions to the separator system (DCS-weighted), as
    an (S+1, S+1, 3, 3) block buffer (sentinel slot S) and b_s (3S,).
    sep_poses: (S, 3) current separator pose values."""
    dt, dev = sep_poses.dtype, sep_poses.device
    si, sj = sg.clo_sep_i, sg.clo_sep_j
    xi, xj = sep_poses[si], sep_poses[sj]
    e = se2_edge_residual(xi, xj, sg.clo_meas)
    Ji, Jj = se2_edge_jacobians(xi, xj, sg.clo_meas)
    # fixed/invalid separator endpoints contribute no Jacobian columns
    Ji = Ji * sg.sep_valid[si].to(dt)[:, None, None]
    Jj = Jj * sg.sep_valid[sj].to(dt)[:, None, None]
    chi2 = torch.einsum("ni,nij,nj->n", e, sg.clo_info, e)
    w = sg.clo_valid.to(dt) * dcs_weight(chi2, phi)
    info_w = sg.clo_info * w[:, None, None]
    OJi = info_w @ Ji
    OJj = info_w @ Jj

    buf = torch.zeros((S + 1, S + 1, 3, 3), dtype=dt, device=dev)
    _scatter_blocks(buf, si, si, _mmT(Ji, OJi))
    _scatter_blocks(buf, sj, sj, _mmT(Jj, OJj))
    Hij = _mmT(Ji, OJj)
    _scatter_blocks(buf, si, sj, Hij)
    _scatter_blocks(buf, sj, si, Hij.transpose(-1, -2))
    b_s = torch.zeros((S, 3), dtype=dt, device=dev)
    b_s.index_put_((si,), -(OJi.transpose(-1, -2) @ e[..., None])[..., 0],
                   accumulate=True)
    b_s.index_put_((sj,), -(OJj.transpose(-1, -2) @ e[..., None])[..., 0],
                   accumulate=True)
    return buf, b_s.reshape(3 * S)


def _block_gn_pieces(bg: BlockedGraph, poses, prev_last_pose, K,
                     b_ext=None):
    """Local factorization + Schur pieces for every block.

    Returns (S_contrib (P,3K,3K), rhs_contrib (P,3K), Hss_part, bs_part,
    Y (P, 3M, 1+3K) solved columns) -- Y is carried to
    back-substitution. The interior solve is block-tridiagonal cyclic
    reduction of the row-wise Jacobi-equilibrated system."""
    Db, Ob, b_i, His, Hss, b_s = _block_system(
        bg, poses, prev_last_pose, K, b_ext)
    P, M = Db.shape[0], Db.shape[1]
    rhs = torch.cat([b_i[..., None], His.transpose(-1, -2)], dim=-1)
    R = rhs.shape[-1]
    d = torch.clamp(torch.diagonal(Db, dim1=-2, dim2=-1), min=1e-20)
    sdiag = torch.rsqrt(d)  # (P, M, 3)
    Ds = Db * sdiag[..., :, None] * sdiag[..., None, :]
    s_prev = torch.cat([sdiag[:, :1], sdiag[:, :-1]], dim=1)
    Os = Ob * s_prev[..., :, None] * sdiag[..., None, :]
    rhs_s = rhs.reshape(P, M, 3, R) * sdiag[..., None]
    Ys = tridiag_solve_cr(Ds, Os, rhs_s)
    Y = (Ys * sdiag[..., None]).reshape(P, 3 * M, R)
    S_contrib = His @ Y[..., 1:]  # (P, 3K, 3K)
    rhs_contrib = (His @ Y[..., :1])[..., 0]  # (P, 3K)
    return S_contrib, rhs_contrib, Hss, b_s, Y


def _compute_delta(Y, d_loc, sep_local):
    """delta_i = Y0 - (A^-1 His^T) d_loc; separator poses take their
    local separator update. Y (P, 3M, 1+3K), d_loc (P, 3K), sep_local
    (P, M). Returns (P, M, 3)."""
    P, M = sep_local.shape
    d_i = (Y[..., 0] - (Y[..., 1:] @ d_loc[..., None])[..., 0]).reshape(
        P, M, 3)
    dl = d_loc.reshape(P, -1, 3)
    is_sep = sep_local >= 0
    d_sep = torch.gather(
        dl, 1, sep_local.clamp(min=0)[..., None].expand(P, M, 3))
    return torch.where(is_sep[..., None], d_sep, d_i)


def _apply_updates(poses, Y, d_loc, sep_local):
    poses = poses + _compute_delta(Y, d_loc, sep_local)
    return torch.cat([poses[..., :2], wrap_angle(poses[..., 2:])], dim=-1)


def _gather_local(d_s, loc_sep):
    """(3S,) global separator update -> (P, 3K) local (0 for padding)."""
    dsr = d_s.reshape(-1, 3)
    out = dsr[loc_sep.clamp(min=0)]
    out = torch.where((loc_sep >= 0)[..., None], out, 0.0)
    return out.reshape(loc_sep.shape[0], -1)


def _locals_to_global_compact(buf, b_base, sg: SepGraph, S_loc, b_loc):
    """Scatter the per-block local Schur pieces into the global
    separator system, through the compact (block, ki, kj) -> (si, sj)
    enumeration of PartitionPlan.pair_* / single_* (most of the
    (P, K, K) local-pair lattice is padding). buf: the (S+1, S+1, 3, 3)
    block buffer, added to in place; returns the rhs (3S,)."""
    P = S_loc.shape[0]
    K = S_loc.shape[1] // 3
    V = S_loc.reshape(P, K, 3, K, 3)
    ok = sg.pair_block >= 0
    vals = V[sg.pair_block.clamp(min=0), sg.pair_ki.clamp(min=0), :,
             sg.pair_kj.clamp(min=0), :]  # (Q, 3, 3)
    _scatter_blocks(buf, torch.where(ok, sg.pair_si, -1),
                    torch.where(ok, sg.pair_sj, -1), vals)
    S_dim = b_base.shape[0] // 3
    ok2 = sg.single_block >= 0
    bvals = b_loc.reshape(P, K, 3)[sg.single_block.clamp(min=0),
                                   sg.single_k.clamp(min=0)]  # (Q2, 3)
    out = torch.cat([b_base.reshape(-1, 3), b_base.new_zeros((1, 3))])
    out.index_put_((torch.where(ok2, sg.single_s, S_dim),), bvals,
                   accumulate=True)
    return out[:S_dim].reshape(-1)


def _separator_step(buf, rhs_s, sg: SepGraph):
    """Solve the assembled separator system: fixed/padding slots get
    identity rows and zero rhs. Returns d_s (3S,)."""
    S = sg.sep_valid.shape[0]
    dt, dev = rhs_s.dtype, rhs_s.device
    eye = torch.eye(3 * S, dtype=dt, device=dev)
    sep_free = sg.sep_valid.repeat_interleave(3)
    S_dense = _blocks_to_dense(buf) + _ones_where(sep_free, 1e-12, dt) * eye
    S_dense = torch.where(sep_free[:, None] & sep_free[None, :], S_dense,
                          eye)
    rhs_s = torch.where(sep_free, rhs_s, 0.0)
    return _eq_chol_solve(S_dense, rhs_s)


def _prev_last(poses):
    return torch.cat([poses.new_zeros((1, 3)), poses[:-1, -1, :]], dim=0)


# ---------------------------------------------------------------------------
# single-device driver
# ---------------------------------------------------------------------------


def optimize_pose_graph_blocked(
    bg: BlockedGraph, sg: SepGraph, phi, iterations: int = 20,
    gnc_init_scale=1.0,
) -> torch.Tensor:
    """Block-sparse GN on the device of `bg`. Returns updated (P, M, 3)
    poses. gnc_init_scale > 1 anneals the DCS phi (graduated
    non-convexity, ops.solvers.gnc_phi_schedule). No host
    synchronization."""
    S = sg.sep_valid.shape[0]
    K = bg.loc_sep.shape[1]
    poses = bg.poses
    phis = gnc_phi_schedule(phi, iterations, gnc_init_scale,
                            dtype=poses.dtype, device=poses.device)
    for k in range(iterations):
        sep_poses = poses[sg.sep_pose_block, sg.sep_pose_off]
        Sc, rc, Hss, bs, Y = _block_gn_pieces(bg, poses, _prev_last(poses),
                                              K)
        buf, bs_c = _closure_system(sep_poses, sg, phis[k], S)
        rhs_s = _locals_to_global_compact(buf, bs_c, sg, Hss - Sc, bs - rc)
        d_s = _separator_step(buf, rhs_s, sg)
        poses = _apply_updates(poses, Y, _gather_local(d_s, bg.loc_sep),
                               bg.sep_local)
    return poses


# ---------------------------------------------------------------------------
# mixed-precision iterative refinement (float64 gradient on the host,
# partitioned H-solve on the device)
# ---------------------------------------------------------------------------
#
# A GN fixpoint is where the gradient b = -J^T(Omega)e vanishes; H only
# preconditions the iteration. In float32 the gradient evaluation
# carries absolute rounding noise ~eps*|Omega e| per edge, and the pose
# graph's chain compliance (H^-1 entries grow ~O(N) along the chain)
# amplifies that noise into meter-level pose error at N~10^4.
# Mixed-precision refinement fixes the fixpoint: keep a float64 master
# copy of the poses on the host, evaluate the exact gradient there
# (O(N) numpy), and let the device compute the Schur-partitioned step
# H^-1 b in the graph's dtype -- near the fixpoint b is tiny, so its
# relative precision on the step suffices.


def _np_edge_residual(xi, xj, z):
    ci, si = np.cos(xi[:, 2]), np.sin(xi[:, 2])
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    d0 = ci * dx + si * dy
    d1 = -si * dx + ci * dy
    cz, sz = np.cos(z[:, 2]), np.sin(z[:, 2])
    e0 = cz * (d0 - z[:, 0]) + sz * (d1 - z[:, 1])
    e1 = -sz * (d0 - z[:, 0]) + cz * (d1 - z[:, 1])
    e2 = xj[:, 2] - xi[:, 2] - z[:, 2]
    e2 = (e2 + np.pi) % (2 * np.pi) - np.pi
    return np.stack([e0, e1, e2], axis=-1)


def _np_edge_jacobians(xi, xj, z):
    ci, si = np.cos(xi[:, 2]), np.sin(xi[:, 2])
    cz, sz = np.cos(z[:, 2]), np.sin(z[:, 2])
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    m00 = cz * ci + sz * (-si)
    m01 = cz * si + sz * ci
    m10 = -sz * ci + cz * (-si)
    m11 = -sz * si + cz * ci
    g0 = -si * dx + ci * dy
    g1 = -ci * dx - si * dy
    e0_ti = cz * g0 + sz * g1
    e1_ti = -sz * g0 + cz * g1
    o = np.zeros_like(ci)
    i1 = np.ones_like(ci)
    Ji = np.stack(
        [
            np.stack([-m00, -m01, e0_ti], axis=-1),
            np.stack([-m10, -m11, e1_ti], axis=-1),
            np.stack([o, o, -i1], axis=-1),
        ],
        axis=-2,
    )
    Jj = np.stack(
        [
            np.stack([m00, m01, o], axis=-1),
            np.stack([m10, m11, o], axis=-1),
            np.stack([o, o, i1], axis=-1),
        ],
        axis=-2,
    )
    return Ji, Jj


def pose_graph_gradient_np(poses64, arrs, phi) -> np.ndarray:
    """Exact float64 gradient b = -J^T Omega e of the (IRLS-weighted)
    pose-graph objective; mirrors the device pieces' semantics (DCS
    weight evaluated at the current poses, treated constant). arrs:
    the graph's fields as numpy arrays by name."""
    N = poses64.shape[0]
    b = np.zeros((N, 3))
    xi, xj = poses64[:-1], poses64[1:]
    z = arrs["chain_meas"][1:]
    info = arrs["chain_info"][1:]
    v = arrs["chain_valid"][1:].astype(np.float64)
    e = _np_edge_residual(xi, xj, z)
    Ji, Jj = _np_edge_jacobians(xi, xj, z)
    Oe = np.einsum("nij,nj->ni", info, e) * v[:, None]
    b[:-1] -= np.einsum("nji,nj->ni", Ji, Oe)
    b[1:] -= np.einsum("nji,nj->ni", Jj, Oe)

    ci_, cj_ = arrs["clo_i"], arrs["clo_j"]
    xi, xj = poses64[ci_], poses64[cj_]
    z, info = arrs["clo_meas"], arrs["clo_info"]
    cv = arrs["clo_valid"].astype(np.float64)
    e = _np_edge_residual(xi, xj, z)
    Ji, Jj = _np_edge_jacobians(xi, xj, z)
    chi2 = np.einsum("ni,nij,nj->n", e, info, e)
    s = np.minimum(1.0, 2.0 * phi / (phi + chi2))
    Oe = np.einsum("nij,nj->ni", info, e) * (s * s * cv)[:, None]
    np.subtract.at(b, ci_, np.einsum("nji,nj->ni", Ji, Oe))
    np.subtract.at(b, cj_, np.einsum("nji,nj->ni", Jj, Oe))
    return b


def gn_refine_delta_blocked(
    bg: BlockedGraph, sg: SepGraph, phi, b_ext, bs_ext
) -> torch.Tensor:
    """One partitioned GN step with an externally supplied gradient.
    b_ext (P, M, 3): gradient rows per pose; bs_ext (3S,): gradient at
    separator poses. Returns the delta (P, M, 3), not applied."""
    S = sg.sep_valid.shape[0]
    K = bg.loc_sep.shape[1]
    dt = bg.poses.dtype
    poses = bg.poses
    sep_poses = poses[sg.sep_pose_block, sg.sep_pose_off]
    Sc, rc, Hss, bs, Y = _block_gn_pieces(bg, poses, _prev_last(poses), K,
                                          b_ext)
    buf, _ = _closure_system(sep_poses, sg, torch.as_tensor(
        phi, dtype=dt, device=poses.device), S)
    rhs_s = _locals_to_global_compact(buf, bs_ext.to(dt), sg, Hss - Sc,
                                      bs - rc)
    d_s = _separator_step(buf, rhs_s, sg)
    return _compute_delta(Y, _gather_local(d_s, bg.loc_sep), bg.sep_local)


def refine_f64(
    g: PoseGraphData, plan, bg: BlockedGraph, sg: SepGraph, phi,
    poses_start, rounds: int = 4,
) -> np.ndarray:
    """Polish a solved graph to its float64-gradient fixpoint. Returns
    (N, 3) float64 numpy poses."""
    P, M = plan.n_blocks, plan.block_size
    dt, dev = bg.poses.dtype, bg.poses.device
    arrs = {
        k: v.detach().cpu().numpy().astype(np.float64)
        if v.is_floating_point() else v.detach().cpu().numpy()
        for k, v in g._asdict().items()
    }
    poses64 = (poses_start.detach().cpu().numpy().astype(np.float64)
               if isinstance(poses_start, torch.Tensor)
               else np.asarray(poses_start, np.float64)).reshape(-1, 3).copy()
    sep_gate = np.asarray(plan.sep_valid, np.float64)[:, None]

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    for _ in range(rounds):
        b64 = pose_graph_gradient_np(poses64, arrs, phi)
        bg_r = bg._replace(poses=dev_t(poses64.reshape(P, M, 3)))
        delta = gn_refine_delta_blocked(
            bg_r, sg, phi, dev_t(b64.reshape(P, M, 3)),
            dev_t((b64[plan.sep_pose] * sep_gate).reshape(-1)))
        poses64 += delta.cpu().numpy().astype(np.float64).reshape(-1, 3)
        poses64[:, 2] = (poses64[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return poses64


# ---------------------------------------------------------------------------
# convenience: full path from PoseGraphData
# ---------------------------------------------------------------------------


def partition_of(g: PoseGraphData, n_blocks: int) -> PartitionPlan:
    """make_partition over g's closures (read to the host once)."""
    return make_partition(
        g.poses.shape[0], n_blocks, g.clo_i.cpu().numpy(),
        g.clo_j.cpu().numpy(), g.clo_valid.cpu().numpy(),
    )


def optimize_partitioned(
    g: PoseGraphData, phi: float, n_blocks: int, iterations: int = 20,
    refine_rounds: int = 0, gnc_init_scale: float = 1.0,
) -> PoseGraphData:
    """Partition + solve on g's device (the JAX package's mesh=None
    path).

    refine_rounds > 0 polishes the solution with mixed-precision
    iterative refinement (float64 gradient on the host, partitioned
    H-solve on the device): the fixpoint moves to the float64
    gradient's zero, which matters for float32 graphs on long chains."""
    plan = partition_of(g, n_blocks)
    bg, sg = split_graph(g, plan)
    poses = optimize_pose_graph_blocked(bg, sg, phi, iterations,
                                        gnc_init_scale)
    if refine_rounds > 0:
        poses64 = refine_f64(g, plan, bg, sg, phi, poses, refine_rounds)
        poses = torch.from_numpy(poses64).to(g.poses.device, g.poses.dtype)
    return g._replace(poses=poses.reshape(g.poses.shape))
