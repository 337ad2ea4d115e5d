"""The port's keyframe-partitioned pose-graph solver
(sparse_gslam_tpu_torch/parallel/{partition,dist_solver}.py), its
batched interior solve and its native oracle, against the JAX package's
on the same seeded numpy inputs, on the CPU in float64 (the conftest
enables x64).

Tolerances:
  - partition plans: equal, array for array;
  - blocked solve against the JAX package's blocked solve: 1e-10
    (m/rad). The port sums scatter-adds in another order and solves the
    interior by cyclic reduction where the JAX package runs the
    sequential sweep; ~1e-15 relative per operation, spread by the
    chain's compliance over 10-25 iterations (measured <= 3e-14);
  - blocked against the port's dense solver: 1e-6, as
    tests/test_dist_solver.py holds the JAX package's pair (the dense
    solver adds a 1e-6 ridge to the equilibrated diagonal, the blocked
    one 8 eps);
  - blocked against the float64 C++ solver at the same iteration
    count: 1e-8 (both take exact Gauss-Newton steps; measured <= 1e-14
    on these graphs);
  - the batched interior solve against vmap of the JAX package's
    tridiag_solve: 1e-10 relative to each right-hand side's largest
    entry;
  - float32 refinement: the float32 device steps of the two packages
    differ in rounding (~1e-7 relative), and each round's float64
    gradient pulls both to the same fixpoint: 1e-5;
  - the separator Cholesky: rtol 1e-8 on an asymmetric system of
    condition ~1e6;
  - the native oracle against the JAX package's build of the same
    source: 1e-12 (both build with -march=native, and a build made on
    another host contracts other products into FMAs: measured
    3.6e-15).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.eval.synthetic_graphs import (
    make_chain_graph as j_make_chain_graph,
)
from sparse_gslam_tpu.io.native import posegraph_gn_native as j_native
from sparse_gslam_tpu.ops import solvers as jsol
from sparse_gslam_tpu.parallel import dist_solver as jds
from sparse_gslam_tpu.parallel.partition import (
    make_partition as j_make_partition,
)
from sparse_gslam_tpu.utils import se2 as jse2
from sparse_gslam_tpu_torch.eval.synthetic_graphs import (
    make_chain_graph,
    to_pose_graph,
)
from sparse_gslam_tpu_torch.interop import pose_graph_from_numpy
from sparse_gslam_tpu_torch.io.native import posegraph_gn_native
from sparse_gslam_tpu_torch.ops import solvers as tsol
from sparse_gslam_tpu_torch.parallel import dist_solver as tds
from sparse_gslam_tpu_torch.parallel.partition import make_partition

BLOCKED_ATOL = 1e-10
DENSE_ATOL = 1e-6
NATIVE_ATOL = 1e-8
REFINE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def closure_graph(N, n, C, seed, drift=0.01, lap=50):
    """n poses driving laps of a circle (`lap` poses per lap), dead
    reckoned with drift, padded to N, with C closure slots: ~3/4 of
    them valid revisits (a pose and the one a whole number of laps
    later, measured from the ground truth plus noise, information
    400-900), the rest invalid. Returns numpy fields by PoseGraphData
    name."""
    r = np.random.default_rng(seed)
    gt = np.zeros((n, 3))
    for i in range(1, n):
        gt[i] = jse2.compose(gt[i - 1],
                             np.array([1.0, 0.0, 2 * np.pi / lap]))
    f = dict(
        poses=np.zeros((N, 3)), valid=np.arange(N) < n,
        fixed=np.arange(N) == 0, chain_meas=np.zeros((N, 3)),
        chain_info=np.tile(np.eye(3), (N, 1, 1)),
        chain_valid=(np.arange(N) > 0) & (np.arange(N) < n),
        clo_i=np.zeros(C, np.int32), clo_j=np.zeros(C, np.int32),
        clo_meas=np.zeros((C, 3)), clo_info=np.tile(np.eye(3), (C, 1, 1)),
        clo_valid=np.zeros(C, bool),
    )
    f["poses"][0] = gt[0]
    for i in range(1, n):
        d = jse2.relative(gt[i - 1], gt[i]) + r.normal(0, drift, 3)
        f["chain_meas"][i] = d
        f["chain_info"][i] = np.diag([120.0, 120.0, 400.0])
        f["poses"][i] = jse2.compose(f["poses"][i - 1], d)
    for k in range(C):
        a = int(r.integers(0, n - lap))
        b = a + lap * int(r.integers(1, (n - 1 - a) // lap + 1))
        f["clo_i"][k], f["clo_j"][k] = a, b
        f["clo_meas"][k] = jse2.relative(gt[a], gt[b]) + r.normal(0, 0.01, 3)
        f["clo_info"][k] = np.eye(3) * r.uniform(400, 900)
        f["clo_valid"][k] = r.random() < 0.75
    return f


def jax_graph(f):
    return jsol.PoseGraphData(*(jnp.asarray(f[k])
                                for k in jsol.PoseGraphData._fields))


def plan_arrays(plan):
    return {k: np.asarray(v) for k, v in plan._asdict().items()}


# -- partition ---------------------------------------------------------------

PARTITIONS = {
    # tests/test_dist_solver.py TestPartition's two cases
    "boundaries_then_closures": (64, 4, [3, 10], [60, 20], [True, True]),
    "closure_on_boundary": (64, 4, [15], [40], [True]),
    "invalid_and_shared": (128, 8, [5, 5, 70, 127, 31], [90, 64, 71, 0, 100],
                           [True, True, False, True, True]),
    "one_block": (32, 1, [2, 9], [30, 20], [True, True]),
}


@pytest.mark.parametrize("case", list(PARTITIONS) + ["seeded_0", "seeded_1"])
def test_partition_matches_jax(case):
    if case in PARTITIONS:
        N, P, ci, cj, cv = PARTITIONS[case]
        ci, cj, cv = (np.array(ci, np.int32), np.array(cj, np.int32),
                      np.array(cv))
    else:
        r = np.random.default_rng(int(case[-1]))
        N, P = 1024, 8
        ci = r.integers(0, N, 40).astype(np.int32)
        cj = r.integers(0, N, 40).astype(np.int32)
        cv = r.random(40) < 0.8
    got = plan_arrays(make_partition(N, P, ci, cj, cv))
    ref = plan_arrays(j_make_partition(N, P, ci, cj, cv))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if case == "boundaries_then_closures":
        assert list(got["sep_pose"][:3]) == [15, 31, 47]
        assert got["sep_id_of_pose"][5] == -1
    if case == "closure_on_boundary":
        assert got["clo_sep_i"][0] == 0  # reuses the boundary slot


# -- the blocked solve --------------------------------------------------------


@pytest.mark.parametrize("N,n,C,n_blocks", [
    (64, 60, 8, 1), (64, 60, 8, 4), (64, 60, 8, 8),
    (256, 250, 32, 1), (256, 250, 32, 4), (256, 250, 32, 8),
])
def test_blocked_matches_jax_and_dense(N, n, C, n_blocks):
    f = closure_graph(N, n, C, seed=N + n_blocks)
    g = pose_graph_from_numpy(f, "cpu")
    got = tds.optimize_partitioned(g, 1.0, n_blocks, iterations=20)
    ref = jds.optimize_partitioned(jax_graph(f), phi=1.0, n_blocks=n_blocks,
                                   iterations=20)
    dense = tsol.optimize_pose_graph(g, 1.0, 20)
    got = got.poses.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref.poses), rtol=0,
                               atol=BLOCKED_ATOL)
    np.testing.assert_allclose(got[:n], dense.poses.numpy()[:n], rtol=0,
                               atol=DENSE_ATOL)
    np.testing.assert_allclose(got[:n], posegraph_gn_native(g, 1.0, 20)[:n],
                               rtol=0, atol=NATIVE_ATOL)


def test_gnc_schedule_and_blocked_gnc_match_jax():
    for it, scale in ((25, 1e6), (10, 1.0), (4, 30.0)):
        np.testing.assert_allclose(
            tsol.gnc_phi_schedule(2.5, it, scale).numpy(),
            np.asarray(jsol.gnc_phi_schedule(2.5, it, scale)), rtol=1e-15)
    f, _ = make_chain_graph(n_poses=250, n_closures=8, pad_to=256, seed=5)
    g = to_pose_graph(f, "cpu")
    gnc = tds.optimize_partitioned(g, 1.0, 4, iterations=25,
                                   gnc_init_scale=1e6).poses.numpy()
    ref = jds.optimize_partitioned(jax_graph(f), phi=1.0, n_blocks=4,
                                   iterations=25, gnc_init_scale=1e6)
    np.testing.assert_allclose(gnc, np.asarray(ref.poses), rtol=0,
                               atol=BLOCKED_ATOL)
    dense = tsol.optimize_pose_graph(g, 1.0, 25, gnc_init_scale=1e6)
    np.testing.assert_allclose(gnc[:250], dense.poses.numpy()[:250], rtol=0,
                               atol=DENSE_ATOL)
    # gnc_init_scale=1 is the fixed-phi solve, bit for bit
    a = tds.optimize_partitioned(g, 1.0, 4, iterations=10)
    b = tds.optimize_partitioned(g, 1.0, 4, iterations=10,
                                 gnc_init_scale=1.0)
    assert torch.equal(a.poses, b.poses)


def test_chain_graph_matches_jax():
    """make_chain_graph gives the JAX package's graph for a seed."""
    f, gt = make_chain_graph(n_poses=500, n_closures=16, pad_to=512, seed=3)
    jg, jgt = j_make_chain_graph(n_poses=500, n_closures=16, pad_to=512,
                                 seed=3)
    np.testing.assert_array_equal(gt, jgt)
    for k in jsol.PoseGraphData._fields:
        np.testing.assert_array_equal(f[k], np.asarray(getattr(jg, k)),
                                      err_msg=k)


# -- mixed-precision refinement ---------------------------------------------


def test_refine_f64_matches_jax():
    f, _ = make_chain_graph(n_poses=250, n_closures=8, pad_to=256,
                            drift=0.005, seed=1, dtype=np.float32)
    g = to_pose_graph(f, "cpu", torch.float32)
    jg = jax_graph(f)
    ref64 = posegraph_gn_native(g, 1.0, 120)  # converged float64
    # the port's gradient is the JAX package's, and refinement started
    # at the float64 fixpoint stays there
    arrs = {k: np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f"
            else np.asarray(v) for k, v in f.items()}
    np.testing.assert_array_equal(
        tds.pose_graph_gradient_np(ref64, arrs, 1.0),
        jds.pose_graph_gradient_np(ref64, arrs, 1.0))
    plan = tds.partition_of(g, 4)
    bg, sg = tds.split_graph(g, plan)
    out = tds.refine_f64(g, plan, bg, sg, 1.0,
                         torch.from_numpy(ref64.astype(np.float32)), rounds=3)
    assert np.abs(out[:250] - ref64[:250]).max() < 1e-6
    grad = tds.pose_graph_gradient_np(out, arrs, 1.0)
    assert np.abs(grad[:250]).max() < 1e-6
    # from a float32 solve: the port's refined poses against the JAX
    # package's, and both nearer the float64 solution than the start
    got = tds.optimize_partitioned(g, 1.0, 4, iterations=30, refine_rounds=4)
    ref = jds.optimize_partitioned(jg, phi=1.0, n_blocks=4, iterations=30,
                                   refine_rounds=4)
    base = tds.optimize_partitioned(g, 1.0, 4, iterations=30)
    got = got.poses.numpy().astype(np.float64)
    np.testing.assert_allclose(got, np.asarray(ref.poses, np.float64),
                               rtol=0, atol=REFINE_ATOL)
    e0 = np.abs(base.poses.numpy()[:250].astype(np.float64)
                - ref64[:250]).max()
    assert np.abs(got[:250] - ref64[:250]).max() <= e0 + 1e-9


# -- the separator Cholesky -------------------------------------------------


def test_eq_chol_solve_asymmetric_near_indefinite():
    """A separator-like system whose symmetric part is SPD with a
    smallest eigenvalue of 1e-6 (before scaling) and which carries a
    skew part of 1e-5 relative size: its lower triangle alone is indefinite (a
    plain Cholesky fails), the symmetrized, equilibrated solve is
    finite and equals the JAX package's."""
    r = np.random.default_rng(9)
    n = 48
    q, _ = np.linalg.qr(r.normal(size=(n, n)))
    sym = (q * np.geomspace(1.0, 1e-6, n)) @ q.T
    scale = np.geomspace(1e-2, 1e3, n)
    E = r.normal(size=(n, n)) * 1e-5
    A = (sym + E - E.T) * scale[:, None] * scale[None, :]
    rhs = r.normal(size=n)
    d = np.diag(A) ** -0.5
    low = np.tril(A) + np.tril(A, -1).T
    assert torch.linalg.cholesky_ex(
        torch.from_numpy(low * d[:, None] * d[None, :]))[1] != 0
    got = tds._eq_chol_solve(torch.from_numpy(A), torch.from_numpy(rhs))
    ref = jds._eq_chol_solve(jnp.asarray(A), jnp.asarray(rhs))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8,
                               atol=0)
    # columns at once, as a matrix right-hand side
    R = r.normal(size=(n, 3))
    np.testing.assert_allclose(
        tds._eq_chol_solve(torch.from_numpy(A), torch.from_numpy(R)).numpy(),
        np.asarray(jds._eq_chol_solve(jnp.asarray(A), jnp.asarray(R))),
        rtol=1e-8, atol=0)


# -- the batched interior solve ---------------------------------------------


def interior_blocks(kind):
    """(Ds, Os, rhs) of P=4 blocks of M=128: equilibrated blocks of a
    real chain (the port's own assembly of make_chain_graph) or seeded
    SPD blocks."""
    if kind == "chain":
        f, _ = make_chain_graph(n_poses=500, n_closures=16, pad_to=512,
                                seed=2)
        g = to_pose_graph(f, "cpu")
        bg, sg = tds.split_graph(g, tds.partition_of(g, 4))
        K = bg.loc_sep.shape[1]
        Db, Ob, b_i, His, _, _ = tds._block_system(
            bg, bg.poses, tds._prev_last(bg.poses), K)
        rhs = torch.cat([b_i[..., None], His.transpose(-1, -2)], -1)
        s = torch.rsqrt(torch.diagonal(Db, dim1=-2, dim2=-1))
        s_prev = torch.cat([s[:, :1], s[:, :-1]], 1)
        return (Db * s[..., :, None] * s[..., None, :],
                Ob * s_prev[..., :, None] * s[..., None, :],
                rhs.reshape(4, 128, 3, -1) * s[..., None])
    r = np.random.default_rng(21)
    a = r.normal(size=(4, 128, 3, 3))
    D = a @ np.swapaxes(a, -1, -2) + 8.0 * np.eye(3)
    O = r.normal(size=(4, 128, 3, 3))
    rhs = r.normal(size=(4, 128, 3, 7))
    return torch.from_numpy(D), torch.from_numpy(O), torch.from_numpy(rhs)


@pytest.mark.parametrize("kind", ["chain", "seeded"])
def test_batched_interior_solve_matches_jax_tridiag(kind):
    D, O, rhs = interior_blocks(kind)
    got = tsol.tridiag_solve_cr(D, O, rhs)
    ref = jax.vmap(jsol.tridiag_solve)(jnp.asarray(D.numpy()),
                                       jnp.asarray(O.numpy()),
                                       jnp.asarray(rhs.numpy()))
    ref = np.asarray(ref)
    # relative to each right-hand side's largest entry: the chain blocks
    # have condition 1e5-2e6, and entries that cancel to near zero carry
    # cond * eps of their column's scale
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got.numpy() - ref) <= 1e-10 * scale).all()
    # each block alone gives the batched solve
    for p in range(D.shape[0]):
        np.testing.assert_allclose(
            tsol.tridiag_solve_cr(D[p], O[p], rhs[p]).numpy(),
            got[p].numpy(), rtol=1e-13, atol=0)


# -- the native oracle --------------------------------------------------------


def test_native_copy_matches_jax_native():
    f = closure_graph(256, 240, 16, seed=4)
    got = posegraph_gn_native(pose_graph_from_numpy(f, "cpu"), 1.0, 15)
    np.testing.assert_allclose(got, j_native(jax_graph(f), 1.0, 15), rtol=0,
                               atol=1e-12)
    # and the blocked solve converges onto it
    g = pose_graph_from_numpy(f, "cpu")
    blocked = tds.optimize_partitioned(g, 1.0, 2, iterations=15)
    np.testing.assert_allclose(blocked.poses.numpy()[:240], got[:240],
                               rtol=0, atol=DENSE_ATOL)
