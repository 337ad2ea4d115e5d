"""The JAX package's small public helpers in the port, against the JAX
functions on the same seeded inputs (CPU, float64):
ops/solvers.posegraph_chi2, ops/multicloud.propagate_chain,
eval/synthetic_graphs.graph_to_arrays and
eval/relations.evaluate_per_separation.

Tolerances: posegraph_chi2 rtol 1e-12 (float64 sums of the same terms in
torch's and XLA's orders); the host numpy helpers bit-equal (the same
numpy operations).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from sparse_gslam_tpu.eval import relations as jrel
from sparse_gslam_tpu.eval import synthetic_graphs as jsyn
from sparse_gslam_tpu.ops import multicloud as jmc
from sparse_gslam_tpu.ops import solvers as jsol
from sparse_gslam_tpu_torch.eval import relations as trel
from sparse_gslam_tpu_torch.eval import synthetic_graphs as tsyn
from sparse_gslam_tpu_torch.ops import multicloud as tmc
from sparse_gslam_tpu_torch.ops import solvers as tsol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("phi", [None, 1.0, 10.0])
def test_posegraph_chi2_matches_jax(phi):
    jg, _ = jsyn.make_chain_graph(n_poses=200, n_closures=12, seed=3,
                                  pad_to=256)
    fields = {k: np.asarray(v) for k, v in jg._asdict().items()}
    # poses off their measurements, so every edge has a residual
    fields["poses"] = fields["poses"] + np.random.default_rng(0).normal(
        0, 0.05, fields["poses"].shape)
    jg = jg._replace(poses=jnp.asarray(fields["poses"]))
    tg = tsyn.to_pose_graph(fields, "cpu")
    ref = float(jsol.posegraph_chi2(jg, phi))
    got = float(tsol.posegraph_chi2(tg, phi))
    assert ref > 0
    assert abs(got - ref) <= 1e-12 * ref


def test_graph_to_arrays_matches_jax():
    jg, _ = jsyn.make_chain_graph(n_poses=64, n_closures=4, seed=1)
    fields = {k: np.asarray(v) for k, v in jg._asdict().items()}
    ref = jsyn.graph_to_arrays(jg)
    got = tsyn.graph_to_arrays(tsyn.to_pose_graph(fields, "cpu"))
    assert set(got) == set(ref)
    for k in ref:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("model", ["reference", "additive"])
def test_propagate_chain_matches_jax(model):
    rng = np.random.default_rng(2)
    deltas = np.column_stack([rng.uniform(0, 0.3, 12),
                              rng.normal(0, 0.02, 12),
                              rng.normal(0, 0.05, 12)])
    var = np.array([0.01, 0.002, 0.005])
    pj, cj = jmc.propagate_chain(deltas, var, model)
    pt, ct = tmc.propagate_chain(deltas, var, model)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ct, cj)
    # the suffix sweep's first entry is the whole chain
    ps, cs = tmc.propagate_suffixes(deltas, var, model)
    np.testing.assert_allclose(ps[0], pt, atol=1e-12)


def test_evaluate_per_separation_matches_jax():
    d = os.path.join(ROOT, "datasets", "sim-office")
    args = (os.path.join(d, "sim-office.result"),
            os.path.join(d, "sim-office.relations"))
    ref = jrel.evaluate_per_separation(*args)
    got = trel.evaluate_per_separation(*args)
    assert got == ref
    assert len(got) >= 2
    assert list(got) == sorted(got)
