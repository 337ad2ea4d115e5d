"""The port's solvers (sparse_gslam_tpu_torch.ops.solvers): the
landmark-graph LM and the pose-graph Gauss-Newton, against the JAX
package's, on the same seeded float64 graphs.

Tolerance: rtol=1e-10 (atol 1e-12 for entries that are zero up to
rounding); the pose-graph solves rtol 1e-9 (atol 1e-10). The two packages sum scatter-adds and small matrix products
in different orders, and the port's block-tridiagonal path uses cyclic
reduction where the JAX package runs the sequential sweep; each is a
few ulps per operation on well-conditioned systems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.eval.synthetic_graphs import make_chain_graph
from sparse_gslam_tpu.ops import solvers as jsol
from sparse_gslam_tpu.ops.line_geometry import transform_line as j_transform
from sparse_gslam_tpu.utils import se2 as jse2
from sparse_gslam_tpu_torch.interop import (
    lm_graph_from_numpy,
    pose_graph_from_numpy,
)
from sparse_gslam_tpu_torch.ops import solvers as tsol
from sparse_gslam_tpu_torch.ops.line_geometry import transform_line

RTOL = 1e-10
ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def lm_fields(P, L, E, n_poses, n_lms, seed):
    """Seeded landmark graph as numpy fields: a noisy pose chain that
    observes rho-theta lines, with padded (invalid) pose, landmark and
    edge slots as the frontend builds them."""
    r = np.random.default_rng(seed)
    gt = np.zeros((n_poses, 3))
    for i in range(1, n_poses):
        step = np.array([0.5, 0.02, r.uniform(-0.2, 0.2)])
        gt[i] = jse2.compose(gt[i - 1], step)
    gt_lms = np.stack(
        [r.uniform(1, 8, n_lms), r.uniform(-np.pi, np.pi, n_lms)], 1
    )
    f = dict(
        poses=np.zeros((P, 3)), pose_valid=np.zeros(P, bool),
        pose_fixed=np.zeros(P, bool), odom_meas=np.zeros((P, 3)),
        odom_info=np.tile(np.eye(3), (P, 1, 1)),
        odom_valid=np.zeros(P, bool), lms=np.zeros((L, 2)),
        lm_valid=np.zeros(L, bool), obs_pose=np.zeros(E, np.int32),
        obs_lm=np.zeros(E, np.int32), obs_meas=np.zeros((E, 2)),
        obs_info=np.tile(np.eye(2), (E, 1, 1)), obs_valid=np.zeros(E, bool),
    )
    f["pose_valid"][:n_poses] = True
    f["pose_fixed"][0] = True
    f["poses"][:n_poses] = gt + r.normal(0, 0.05, (n_poses, 3))
    f["poses"][0] = gt[0]
    for i in range(1, n_poses):
        f["odom_meas"][i] = jse2.relative(gt[i - 1], gt[i]) + r.normal(
            0, 0.01, 3)
        a = r.normal(0, 1, (3, 3))
        f["odom_info"][i] = a @ a.T + np.eye(3) * 50.0
        f["odom_valid"][i] = True
    f["lms"][:n_lms] = gt_lms + r.normal(0, 0.03, (n_lms, 2))
    f["lm_valid"][:n_lms] = True
    k = 0
    for i in range(n_poses):
        for j in r.choice(n_lms, size=min(3, n_lms), replace=False):
            if k >= E:
                break
            inv = jse2.inverse(gt[i])
            z = np.asarray(j_transform(gt_lms[j], inv[:2], inv[2]))
            f["obs_pose"][k], f["obs_lm"][k] = i, j
            f["obs_meas"][k] = z + r.normal(0, 0.005, 2)
            a = r.normal(0, 1, (2, 2))
            f["obs_info"][k] = a @ a.T + np.eye(2) * 300.0
            f["obs_valid"][k] = True
            k += 1
    return f


def both(fields):
    jg = jsol.LMGraphData(*(jnp.asarray(fields[k])
                            for k in jsol.LMGraphData._fields))
    return jg, lm_graph_from_numpy(fields, "cpu")


GRAPHS = {
    "dense": dict(P=16, L=16, E=64, n_poses=12, n_lms=9, seed=1),
    "tridiag": dict(P=128, L=16, E=512, n_poses=100, n_lms=14, seed=2),
}


def rand_poses(r, n):
    p = r.uniform(-3, 3, (n, 3))
    p[:, 2] = r.uniform(-np.pi, np.pi, n)
    return p


def test_interop_roundtrip_dtypes():
    fields = lm_fields(**GRAPHS["dense"])
    g = lm_graph_from_numpy(fields, "cpu")
    assert g.poses.dtype == torch.float64
    assert g.obs_pose.dtype == torch.int64
    assert g.obs_valid.dtype == torch.bool
    for k in tsol.LMGraphData._fields:
        np.testing.assert_array_equal(getattr(g, k).numpy(), fields[k])


@pytest.mark.parametrize("fn", ["residual", "jacobians"])
def test_se2_edge(fn):
    r = np.random.default_rng(10)
    xi, xj, z = rand_poses(r, 50), rand_poses(r, 50), rand_poses(r, 50)
    name = f"se2_edge_{fn}"
    port = getattr(tsol, name)(t(xi), t(xj), t(z))
    ref = getattr(jsol, name)(jnp.asarray(xi), jnp.asarray(xj),
                              jnp.asarray(z))
    for a, b in zip(port if fn == "jacobians" else [port],
                    ref if fn == "jacobians" else [ref]):
        close(a, b)


@pytest.mark.parametrize("fn", ["residual", "jacobians"])
def test_rhotheta_edge(fn):
    r = np.random.default_rng(11)
    poses = rand_poses(r, 50)
    lms = np.stack([r.uniform(0.1, 8, 50), r.uniform(-np.pi, np.pi, 50)], 1)
    z = lms + r.normal(0, 0.1, lms.shape)
    name = f"rhotheta_edge_{fn}"
    port = getattr(tsol, name)(t(poses), t(lms), t(z))
    ref = getattr(jsol, name)(jnp.asarray(poses), jnp.asarray(lms),
                              jnp.asarray(z))
    for a, b in zip(port if fn == "jacobians" else [port],
                    ref if fn == "jacobians" else [ref]):
        close(a, b)


def test_transform_line_torch():
    r = np.random.default_rng(12)
    lms = np.stack([r.uniform(-8, 8, 64), r.uniform(-np.pi, np.pi, 64)], 1)
    tr = r.uniform(-5, 5, (64, 2))
    ang = r.uniform(-np.pi, np.pi, 64)
    close(transform_line(t(lms), t(tr), t(ang)),
          j_transform(jnp.asarray(lms), jnp.asarray(tr), jnp.asarray(ang)))


def spd_blocks(r, P, R):
    D = np.zeros((P, 3, 3))
    O = r.normal(0, 1, (P, 3, 3))
    for i in range(P):
        a = r.normal(0, 1, (3, 3))
        D[i] = a @ a.T + np.eye(3) * 8.0
    return D, O, r.normal(0, 1, (P, 3, R))


def test_inv3():
    D, _, _ = spd_blocks(np.random.default_rng(13), 40, 1)
    close(tsol.inv3(t(D)), jsol.inv3(jnp.asarray(D)))


@pytest.mark.parametrize("P", [1, 37, 64])
@pytest.mark.parametrize("port_fn", ["tridiag_solve", "tridiag_solve_cr"])
def test_tridiag_against_jax_sweep(P, port_fn):
    """Both port solvers against the JAX package's sequential sweep."""
    D, O, rhs = spd_blocks(np.random.default_rng(P), P, 5)
    port = getattr(tsol, port_fn)(t(D), t(O), t(rhs))
    ref = jsol.tridiag_solve(jnp.asarray(D), jnp.asarray(O),
                             jnp.asarray(rhs))
    close(port, ref)


def test_tridiag_cr_against_jax_cr():
    D, O, rhs = spd_blocks(np.random.default_rng(14), 50, 3)
    close(tsol.tridiag_solve_cr(t(D), t(O), t(rhs)),
          jsol.tridiag_solve_cr(jnp.asarray(D), jnp.asarray(O),
                                jnp.asarray(rhs)))


def test_chol2():
    r = np.random.default_rng(15)
    a = r.normal(0, 1, (20, 2, 2))
    m = a @ np.swapaxes(a, -1, -2) + np.eye(2)
    close(tsol._chol2(t(m)), jsol._chol2(jnp.asarray(m)))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_lm_graph_chi2(graph):
    jg, tg = both(lm_fields(**GRAPHS[graph]))
    c_t, d_t = tsol.lm_graph_chi2(tg)
    c_j, d_j = jsol.lm_graph_chi2(jg)
    close(c_t, c_j)
    assert int(d_t) == int(d_j)


def test_assemble_lm_system():
    jg, tg = both(lm_fields(**GRAPHS["dense"]))
    for a, b in zip(tsol._assemble_lm_system(tg),
                    jsol._assemble_lm_system(jg)):
        close(a, b)


def test_lm_tridiag_assemble():
    jg, tg = both(lm_fields(**GRAPHS["tridiag"]))
    for a, b in zip(tsol._lm_tridiag_assemble(tg),
                    jsol._lm_tridiag_assemble(jg)):
        close(a, b)


def test_schur_solve():
    jg, tg = both(lm_fields(**GRAPHS["dense"]))
    lam = 0.37
    dp_t, dl_t = tsol._schur_solve(
        tg, *tsol._assemble_lm_system(tg), torch.tensor(lam,
                                                        dtype=torch.float64))
    dp_j, dl_j = jsol._schur_solve(jg, *jsol._assemble_lm_system(jg), lam)
    close(dp_t, dp_j)
    close(dl_t, dl_j)


def test_schur_solve_tridiag():
    """The port's cyclic-reduction chain solve against the JAX package's
    sequential sweep inside the same Woodbury solve."""
    jg, tg = both(lm_fields(**GRAPHS["tridiag"]))
    lam = 0.37
    port = tsol._schur_solve_tridiag(
        tg, tsol._lm_tridiag_assemble(tg),
        torch.tensor(lam, dtype=torch.float64))
    ref = jsol._schur_solve_tridiag(jg, jsol._lm_tridiag_assemble(jg), lam)
    for a, b in zip(port, ref):
        close(a, b)


def test_lm_apply():
    jg, tg = both(lm_fields(**GRAPHS["dense"]))
    r = np.random.default_rng(16)
    dp, dl = r.normal(0, 2, (16, 3)), r.normal(0, 2, (16, 2))
    a = tsol._lm_apply(tg, t(dp), t(dl))
    b = jsol._lm_apply(jg, jnp.asarray(dp), jnp.asarray(dl))
    close(a.poses, b.poses)
    close(a.lms, b.lms)


_jax_lm = {}


def jax_optimize(g, rtol):
    if rtol not in _jax_lm:
        _jax_lm[rtol] = jax.jit(
            lambda gg: jsol.optimize_landmark_graph(gg, 15, rtol=rtol))
    return _jax_lm[rtol](g)


@pytest.mark.parametrize("rtol", [1e-7, 0.0], ids=["early_stop", "fixed"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_optimize_landmark_graph(graph, rtol):
    """Dense (P=16) and block-tridiagonal (P=128) paths, with the early
    stop and with fixed trips (JAX's lax.scan branch)."""
    jg, tg = both(lm_fields(**GRAPHS[graph]))
    g_t, chi2_t, dof_t = tsol.optimize_landmark_graph(tg, 15, rtol=rtol)
    g_j, chi2_j, dof_j = jax_optimize(jg, rtol)
    close(g_t.poses, g_j.poses)
    close(g_t.lms, g_j.lms)
    close(chi2_t, chi2_j)
    assert int(dof_t) == int(dof_j)
    # the solve did work: chi2 fell from its start
    assert float(chi2_t) < float(tsol.lm_graph_chi2(tg)[0])


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------


def pose_graphs(n_poses, n_closures, pad_to, seed):
    """(JAX PoseGraphData, the port's) for make_chain_graph's graph,
    with a share of the closures corrupted so DCS has outliers to
    down-weight."""
    g, _ = make_chain_graph(n_poses=n_poses, n_closures=n_closures,
                            pad_to=pad_to, seed=seed)
    meas = np.asarray(g.clo_meas).copy()
    r = np.random.default_rng(seed)
    bad = r.random(len(meas)) < 0.25
    meas[bad] += r.normal(0.0, 1.5, (int(bad.sum()), 3))
    g = g._replace(clo_meas=jnp.asarray(meas))
    fields = {k: np.asarray(getattr(g, k)) for k in g._fields}
    return g, pose_graph_from_numpy(fields, "cpu")


PG_CASES = {"n60_c8": (60, 8, 64, 0), "n200_c24": (200, 24, 256, 1)}


def test_pose_graph_from_numpy_dtypes():
    _, tg = pose_graphs(*PG_CASES["n60_c8"])
    assert tg.poses.dtype == torch.float64
    assert tg.clo_i.dtype == torch.int64 and tg.valid.dtype == torch.bool
    assert tuple(tg.chain_info.shape) == (64, 3, 3)


@pytest.mark.parametrize("phi", [0.5, 1.0, 4.0])
def test_dcs_weight(phi):
    chi2 = np.concatenate([[0.0], np.logspace(-3, 4, 40)])
    close(tsol.dcs_weight(t(chi2), phi), jsol.dcs_weight(chi2, phi))


@pytest.mark.parametrize("case", list(PG_CASES))
def test_closure_chi2(case):
    g, tg = pose_graphs(*PG_CASES[case])
    close(tsol.closure_chi2(tg), jsol.closure_chi2(g), rtol=1e-12)


@pytest.mark.parametrize("case", list(PG_CASES))
def test_assemble_posegraph(case):
    g, tg = pose_graphs(*PG_CASES[case])
    for port, ref in zip(tsol._assemble_posegraph(tg, 1.0),
                         jsol._assemble_posegraph(g, 1.0)):
        close(port, ref)


@pytest.mark.parametrize("iterations,init_scale", [(20, 1.0), (12, 8.0)])
def test_gnc_phi_schedule(iterations, init_scale):
    close(tsol.gnc_phi_schedule(1.0, iterations, init_scale),
          jsol.gnc_phi_schedule(1.0, iterations, init_scale), rtol=1e-15)


@pytest.mark.parametrize("gnc", [1.0, 8.0], ids=["dcs", "gnc"])
@pytest.mark.parametrize("case", list(PG_CASES))
def test_optimize_pose_graph(case, gnc):
    g, tg = pose_graphs(*PG_CASES[case])
    ref = jsol.optimize_pose_graph(g, 1.0, 20, gnc_init_scale=gnc)
    out = tsol.optimize_pose_graph(tg, 1.0, 20, gnc_init_scale=gnc)
    close(out.poses, ref.poses, rtol=1e-9, atol=1e-10)
    # padding poses stay where they were
    n = int(np.asarray(g.valid).sum())
    close(out.poses[n:], np.asarray(g.poses)[n:], rtol=0, atol=0)
