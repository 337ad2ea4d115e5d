"""The port's joint landmark + pose solve (sparse_gslam_tpu_torch.ops.
solvers: _assemble_joint_system, _joint_schur_solve, joint_graph_chi2,
optimize_joint_graph; interop.joint_graph_from_numpy) against the JAX
package's, on the same seeded float64 graphs: the loop of
tests/test_solvers.py's TestJointGraph (P = 24 poses, L = 6 lines,
pose 0 fixed, one end-to-start closure), optionally padded with invalid
pose, landmark, edge and closure slots as the backend pads them, and
with a gross outlier closure that DCS must down-weight.

Tolerances: the assembly, the Schur solve and chi2 at rtol 1e-12 (the
packages sum scatter-adds and small products in other orders: a few
ulps per operation); the LM's poses and landmarks at atol 1e-9 and its
chi2 at rtol 1e-9 (up to 40 relinearizations of those few ulps, each
step an SPD solve of condition ~1e6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.ops import solvers as jsol
from sparse_gslam_tpu_torch.interop import joint_graph_from_numpy
from sparse_gslam_tpu_torch.ops import solvers as tsol
from sparse_gslam_tpu_torch.ops.line_geometry import transform_line
from sparse_gslam_tpu_torch.utils import se2

RTOL = 1e-12
LM_ATOL = 1e-9
LM_RTOL = 1e-9
PHI = 10.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def joint_fields(seed=7, P=24, L=6, drift=0.03, pad=False, outlier=False):
    """TestJointGraph's graph as numpy fields: a square loop of P poses
    dead-reckoned from noisy odometry, every pose observing L lines
    outside the loop, one closure from the last pose to the first.
    pad adds 8 invalid poses, 2 invalid landmarks, 16 invalid edges and
    2 invalid closure slots (all at index 0, as the backend pads);
    outlier adds a closure whose measurement is 1.5 m and 0.6 rad off."""
    r = np.random.default_rng(seed)
    gt = np.zeros((P, 3))
    for i in range(1, P):
        step = np.array([0.5, 0.0, 0.0])
        if i % (P // 4) == 0:
            step[2] = np.pi / 2
        gt[i] = se2.compose(gt[i - 1], step)
    lms_gt = np.stack([np.array([6.0 + 0.7 * k, 0.3 + 0.9 * (k % 3)])
                       for k in range(L)])
    odom_meas = np.zeros((P, 3))
    odom_valid = np.zeros(P, bool)
    for i in range(1, P):
        noise = r.normal(0, drift, 3) * np.array([1, 1, 0.5])
        odom_meas[i] = se2.relative(gt[i - 1], gt[i]) + noise
        odom_valid[i] = True
    poses0 = np.zeros((P, 3))
    for i in range(1, P):
        poses0[i] = se2.compose(poses0[i - 1], odom_meas[i])
    obs_pose, obs_lm, obs_meas = [], [], []
    for i in range(P):
        inv = se2.inverse(gt[i])
        for k in range(L):
            obs_pose.append(i)
            obs_lm.append(k)
            obs_meas.append(np.asarray(transform_line(lms_gt[k], inv[:2],
                                                      inv[2]))
                            + r.normal(0, 0.01, 2))
    E = len(obs_pose)
    clo = [(0, P - 1, se2.relative(gt[0], gt[P - 1]))]
    if outlier:
        clo.append((3, P // 2, se2.relative(gt[3], gt[P // 2])
                    + np.array([1.5, -1.0, 0.6])))
    f = dict(
        poses=poses0, pose_valid=np.ones(P, bool),
        pose_fixed=np.arange(P) == 0, odom_meas=odom_meas,
        odom_info=np.tile(np.eye(3) * 400.0, (P, 1, 1)),
        odom_valid=odom_valid,
        lms=lms_gt + r.normal(0, 0.05, lms_gt.shape),
        lm_valid=np.ones(L, bool),
        obs_pose=np.asarray(obs_pose, np.int32),
        obs_lm=np.asarray(obs_lm, np.int32),
        obs_meas=np.stack(obs_meas),
        obs_info=np.tile(np.eye(2) * 1e4, (E, 1, 1)),
        obs_valid=np.ones(E, bool),
        clo_i=np.asarray([c[0] for c in clo], np.int32),
        clo_j=np.asarray([c[1] for c in clo], np.int32),
        clo_meas=np.stack([c[2] for c in clo]),
        clo_info=np.tile(np.eye(3) * 1e4, (len(clo), 1, 1)),
        clo_valid=np.ones(len(clo), bool),
    )
    if pad:
        extra = {"poses": 8, "lms": 2, "obs_pose": 16, "clo_i": 2}
        groups = {
            "poses": ("poses", "pose_valid", "pose_fixed", "odom_meas",
                      "odom_info", "odom_valid"),
            "lms": ("lms", "lm_valid"),
            "obs_pose": ("obs_pose", "obs_lm", "obs_meas", "obs_info",
                         "obs_valid"),
            "clo_i": ("clo_i", "clo_j", "clo_meas", "clo_info",
                      "clo_valid"),
        }
        for lead, names in groups.items():
            k = extra[lead]
            for name in names:
                a = f[name]
                if name.endswith("info"):
                    fill = np.tile(np.eye(a.shape[-1]), (k, 1, 1))
                elif name == "poses":
                    fill = np.full((k, 3), 7.0)
                else:
                    fill = np.zeros((k,) + a.shape[1:], a.dtype)
                f[name] = np.concatenate([a, fill])
    return f


def jax_graph(f):
    return jsol.JointGraphData(**{k: jnp.asarray(f[k])
                                  for k in jsol.JointGraphData._fields})


def port_graph(f):
    return joint_graph_from_numpy(f, "cpu")


def close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


GRAPHS = {
    "loop": dict(),
    "padded": dict(pad=True),
    "outlier": dict(outlier=True),
    "padded_outlier": dict(pad=True, outlier=True, seed=11),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_assemble_joint_system_matches_jax(graph):
    f = joint_fields(**GRAPHS[graph])
    got = tsol._assemble_joint_system(port_graph(f), PHI)
    ref = jsol._assemble_joint_system(jax_graph(f), PHI)
    for a, b in zip(got, ref):
        scale = float(np.abs(np.asarray(b)).max())
        close(a, b, atol=RTOL * scale)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_joint_schur_solve_matches_jax(graph):
    f = joint_fields(**GRAPHS[graph])
    tg, jg = port_graph(f), jax_graph(f)
    parts = jsol._assemble_joint_system(jg, PHI)
    lam = 1e-2
    ref = jsol._joint_schur_solve(jg, *parts, lam)
    # the same (JAX-assembled) system through the port's solve
    got = tsol._joint_schur_solve(
        tg, *[torch.from_numpy(np.array(p)) for p in parts],
        torch.tensor(lam, dtype=torch.float64))
    for a, b in zip(got, ref):
        assert np.isfinite(np.asarray(a)).all()
        scale = float(np.abs(np.asarray(b)).max())
        close(a, b, atol=RTOL * scale)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_joint_graph_chi2_matches_jax(graph):
    f = joint_fields(**GRAPHS[graph])
    close(tsol.joint_graph_chi2(port_graph(f), PHI),
          jsol.joint_graph_chi2(jax_graph(f), PHI))


@pytest.mark.parametrize("graph,iterations", [
    ("loop", 12), ("padded", 12), ("outlier", 12), ("padded_outlier", 12),
    ("padded_outlier", 40),
])
def test_optimize_joint_graph_matches_jax(graph, iterations):
    f = joint_fields(**GRAPHS[graph])
    tg, tchi2 = tsol.optimize_joint_graph(port_graph(f), PHI, iterations)
    jg, jchi2 = jsol.optimize_joint_graph(jax_graph(f), PHI, iterations)
    close(tg.poses, jg.poses, rtol=0, atol=LM_ATOL)
    close(tg.lms, jg.lms, rtol=0, atol=LM_ATOL)
    close(tchi2, jchi2, rtol=LM_RTOL)
    # the solve moved the loop, kept the fixed pose, left padding alone
    assert float(tchi2) < 0.1 * float(tsol.joint_graph_chi2(port_graph(f),
                                                            PHI))
    np.testing.assert_array_equal(tg.poses[0].numpy(), f["poses"][0])
    P = len(f["pose_valid"])
    if P > 24:
        np.testing.assert_array_equal(tg.poses[24:, :2].numpy(), 7.0)


def test_dcs_downweights_the_outlier_closure():
    f = joint_fields(outlier=True)
    g, _ = tsol.optimize_joint_graph(port_graph(f), PHI, 12)
    e = tsol.se2_edge_residual(g.poses[g.clo_i], g.poses[g.clo_j],
                               g.clo_meas)
    chi2 = torch.einsum("ni,nij,nj->n", e, g.clo_info, e)
    w = tsol.dcs_weight(chi2, PHI)
    assert float(w[0]) > 0.5 > 1e-2 > float(w[1])


def test_failed_cholesky_rejects_the_step():
    """A damped system that is not SPD (one odometry edge with negative
    information) makes both packages' Cholesky fail: NaN steps, the
    step rejected, the graph and chi2 unchanged, lambda raised."""
    f = joint_fields(pad=True)
    f["odom_info"][5] = -1e7 * np.eye(3)
    tg, jg = port_graph(f), jax_graph(f)
    parts = tsol._assemble_joint_system(tg, PHI)
    dp, dl = tsol._joint_schur_solve(tg, *parts,
                                     torch.tensor(1e-3, dtype=torch.float64))
    jparts = jsol._assemble_joint_system(jg, PHI)
    jdp, jdl = jsol._joint_schur_solve(jg, *jparts, 1e-3)
    for a, b in ((dp, jdp), (dl, jdl)):
        free = ~np.isclose(np.asarray(b), 0.0)
        assert np.isnan(np.asarray(b)[free]).all()
        assert np.isnan(a.numpy()[free]).all()
    tout, tchi2 = tsol.optimize_joint_graph(tg, PHI, 1)
    jout, jchi2 = jsol.optimize_joint_graph(jg, PHI, 1)
    np.testing.assert_array_equal(tout.poses.numpy(), f["poses"])
    np.testing.assert_array_equal(np.asarray(jout.poses), f["poses"])
    np.testing.assert_array_equal(tout.lms.numpy(), f["lms"])
    close(tchi2, jchi2)
    close(tchi2, tsol.joint_graph_chi2(tg, PHI), rtol=0)


def test_joint_graph_from_numpy_round_trip():
    f = joint_fields(pad=True, outlier=True)
    g = joint_graph_from_numpy(f, "cpu")
    assert g._fields == jsol.JointGraphData._fields
    for name in g._fields:
        t = getattr(g, name)
        a = np.asarray(f[name])
        if a.dtype == np.bool_:
            assert t.dtype == torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            assert t.dtype == torch.int64
        else:
            assert t.dtype == torch.float64
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
    # the JAX graph's own arrays give the same tensors
    jg = jax_graph(f)
    g2 = joint_graph_from_numpy(
        {k: np.asarray(getattr(jg, k)) for k in jg._fields}, "cpu")
    for a, b in zip(g, g2):
        assert torch.equal(a, b)
