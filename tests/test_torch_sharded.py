"""The port's multi-device routes against the JAX package's, on the CPU.

- The sharded pose-graph solver (parallel/dist_solver.py
  optimize_pose_graph_sharded) on in-process meshes of 2, 4 and 8 shards
  (parallel/multihost.block_mesh, the shards on the CPU) against the JAX
  package's optimize_pose_graph_sharded on virtual CPU meshes of the same
  size (conftest.py's 8 devices), with GNC as
  tests/test_dist_solver.py's TestGNCAndRefine runs it;
- two real processes (gloo through multihost.initialize,
  scripts/torch_dist_test_worker.py) against the blocked and dense
  solves, as tests/test_multiprocess.py runs the JAX package's;
- the sharded candidate search (ops/matching.match_candidates_sharded)
  on tests/test_grid_matching.py's TestShardedMatching cases;
- correlate_all and best_candidate_with_cov against the JAX functions;
- the backend's hooks: with `mesh` set every solve takes the sharded
  solver (and equals the blocked one), with `match_mesh` the candidate
  search takes the sharded matcher; and, marked slow (four pipeline
  runs, the JAX package's compiles included: ~9 min on the CPU),
  tests/test_pipeline_dist.py's world through both packages with the
  same meshes;
- graft_entry.dryrun_multichip and entry();
- multihost: the one-process no-op, the mesh layouts, model_efficiency
  against the JAX package's formula;
- the card as the default: without a card (torch.cuda made to report
  none), graft_entry.entry(), dryrun_multichip(2), block_mesh(2),
  scaling_report and an NCCL initialize raise, naming the CPU option.

Tolerances: sharded against the JAX package's sharded solve 1e-6 and
against its blocked solve 1e-8 (tests/test_dist_solver.py's); against the
port's blocked solve 1e-10 in float64 (the same steps, the separator
system's shard parts summed in another order). The sharded matcher: the
same candidate and refusal; score 1e-5, pose 1e-5 m/rad and covariance
1e-6 (tests/test_grid_matching.py's sequential-against-sharded pair);
correlate_all's thetas equal and its scores 1e-5 (FFT rounding, as
tests/test_torch_matching.py holds correlate_rotations).
"""
import inspect
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sparse_gslam_tpu.eval.synthetic_graphs import (
    make_chain_graph as j_make_chain_graph,
)
from sparse_gslam_tpu.ops import matching as jm
from sparse_gslam_tpu.ops.grid import precompute_pyramid as j_pyramid
from sparse_gslam_tpu.parallel import dist_solver as jds
from sparse_gslam_tpu.parallel import multihost as jmh
from sparse_gslam_tpu.utils import se2 as jse2
from sparse_gslam_tpu_torch import graft_entry
from sparse_gslam_tpu_torch.eval.synthetic_graphs import (
    make_chain_graph,
    to_pose_graph,
)
from sparse_gslam_tpu_torch.interop import pose_graph_from_numpy
from sparse_gslam_tpu_torch.ops import matching as tm
from sparse_gslam_tpu_torch.parallel import dist_solver as tds
from sparse_gslam_tpu_torch.parallel import multihost
import test_grid_matching
from test_torch_dist_solver import closure_graph, jax_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SHARDED_ATOL = 1e-6
JAX_BLOCKED_ATOL = 1e-8
BLOCKED_ATOL = 1e-10
MATCH_SCORE_ATOL = 1e-5
MATCH_POSE_ATOL = 1e-5
MATCH_COV_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n):
    return multihost.block_mesh(n, ["cpu"] * n)


def jax_mesh(n, axis="blocks"):
    return Mesh(np.array(jax.devices("cpu")[:n]), (axis,))


@pytest.mark.parametrize("shards,n_blocks", [(2, 4), (4, 4), (8, 8)])
def test_sharded_matches_jax_sharded_and_blocked(shards, n_blocks):
    f = closure_graph(64 * n_blocks // 4, 60 * n_blocks // 4, 8,
                      seed=shards + n_blocks)
    g = pose_graph_from_numpy(f, "cpu")
    got = tds.optimize_partitioned(g, 1.0, n_blocks, iterations=10,
                                   mesh=cpu_mesh(shards)).poses.numpy()
    jg = jax_graph(f)
    ref = jds.optimize_partitioned(jg, phi=1.0, n_blocks=n_blocks,
                                   iterations=10, mesh=jax_mesh(shards))
    ref_b = jds.optimize_partitioned(jg, phi=1.0, n_blocks=n_blocks,
                                     iterations=10)
    blocked = tds.optimize_partitioned(g, 1.0, n_blocks,
                                       iterations=10).poses.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref.poses), rtol=0,
                               atol=JAX_SHARDED_ATOL)
    np.testing.assert_allclose(got, np.asarray(ref_b.poses), rtol=0,
                               atol=JAX_BLOCKED_ATOL)
    np.testing.assert_allclose(got, blocked, rtol=0, atol=BLOCKED_ATOL)


def test_sharded_gnc_matches_jax_and_blocked():
    """tests/test_dist_solver.py's test_gnc_sharded_matches_blocked."""
    kw = dict(n_poses=250, n_closures=8, pad_to=256, drift=0.02, seed=3)
    f, _ = make_chain_graph(**kw)
    g = to_pose_graph(f, "cpu")
    got = tds.optimize_partitioned(g, 1.0, 4, iterations=15,
                                   gnc_init_scale=1e6,
                                   mesh=cpu_mesh(4)).poses.numpy()
    jg, _ = j_make_chain_graph(**kw)
    ref = jds.optimize_partitioned(jg, phi=1.0, n_blocks=4, iterations=15,
                                   gnc_init_scale=1e6, mesh=jax_mesh(4))
    blocked = tds.optimize_partitioned(g, 1.0, 4, iterations=15,
                                       gnc_init_scale=1e6).poses.numpy()
    np.testing.assert_allclose(got, np.asarray(ref.poses), rtol=0,
                               atol=JAX_SHARDED_ATOL)
    np.testing.assert_allclose(got, blocked, rtol=0, atol=BLOCKED_ATOL)


def test_sharded_refuses_blocks_that_do_not_divide():
    f = closure_graph(64, 60, 8, seed=1)
    g = pose_graph_from_numpy(f, "cpu")
    with pytest.raises(ValueError, match="do not divide"):
        tds.optimize_partitioned(g, 1.0, 4, iterations=2, mesh=cpu_mesh(3))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_solve():
    """Two processes, two shards each, joined by gloo: each rank's result
    equals the blocked solve within 1e-10 and the dense one within 1e-6
    (scripts/torch_dist_test_worker.py exits 0 only then)."""
    port = str(_free_port())
    worker = os.path.join(REPO, "scripts", "torch_dist_test_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker, str(pid), "2", port],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        outs = [p.communicate(timeout=50)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid}: OK" in out, out
        assert "4 global shards" in out, out


def matching_case():
    """tests/test_grid_matching.py's sharded-matching world: its submap,
    three candidates (one true) and the query seen from gt."""
    sm, _ = test_grid_matching.TestMatching()._setup()
    pyr5 = j_pyramid(sm.probs, 5)
    gt = np.array([0.4, -0.3, 0.1])
    base = np.concatenate([
        np.column_stack([np.full(50, 4.0), np.linspace(-0.5, 2.5, 50)]),
        np.column_stack([np.linspace(0.0, 2.0, 40), np.full(40, -1.0)]),
    ])
    query = jse2.apply(jse2.inverse(gt), base)
    origins = [np.asarray(sm.origin) + np.array(d) for d in
               ([30.0, 30.0], [0.0, 0.0], [-25.0, 10.0])]
    return (np.asarray(pyr5[0]), np.asarray(pyr5[4]),
            [np.asarray(o, np.float32) for o in origins], [0.3, 0.0, -0.2],
            query, np.asarray(sm.origin, np.float32))


@pytest.mark.parametrize("shards", [4])
def test_sharded_matcher_matches_jax(shards):
    score, pooled, origins, thetas, query, _ = matching_case()
    spec = jm.search_spec(2.0, 0.6, 8.0, 0.1)
    ref = jm.match_candidates_sharded(
        [jnp.asarray(score)] * 3, [jnp.asarray(o) for o in origins],
        thetas, query, spec, jax_mesh(shards, "cands"), min_score=0.5)
    t_spec = tm.search_spec(2.0, 0.6, 8.0, 0.1)
    got = tm.match_candidates_sharded(
        [torch.from_numpy(score)] * 3,
        [torch.from_numpy(o) for o in origins], thetas, query, t_spec,
        cpu_mesh(shards), min_score=0.5)
    seq = tm.match_candidates_pruned(
        [torch.from_numpy(score)] * 3, [torch.from_numpy(pooled)] * 3,
        [torch.from_numpy(o) for o in origins], thetas, query, t_spec,
        min_score=0.5, stride=16)
    assert got[0] == ref[0] == seq[0] == 1
    assert abs(got[1] - ref[1]) < MATCH_SCORE_ATOL
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=MATCH_POSE_ATOL)
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=MATCH_COV_ATOL)
    np.testing.assert_allclose(got[2], seq[2], rtol=0, atol=MATCH_POSE_ATOL)


def test_sharded_matcher_refuses_below_min_score_as_jax():
    score, _, _, _, _, origin = matching_case()
    query = np.random.default_rng(0).uniform(40, 60, (64, 2))
    spec = jm.search_spec(2.0, 0.6, 8.0, 0.1)
    ref = jm.match_candidates_sharded(
        [jnp.asarray(score)], [jnp.asarray(origin)], [0.0], query, spec,
        jax_mesh(4, "cands"), min_score=0.7)
    got = tm.match_candidates_sharded(
        [torch.from_numpy(score)], [torch.from_numpy(origin)], [0.0], query,
        tm.search_spec(2.0, 0.6, 8.0, 0.1), cpu_mesh(4), min_score=0.7)
    assert ref[0] is None and got[0] is None
    assert got[2] is None and got[3] is None
    assert abs(got[1] - ref[1]) < MATCH_SCORE_ATOL


def test_correlate_all_and_best_candidate_match_jax():
    score, _, origins, _, query, _ = matching_case()
    n = 256
    pts = np.zeros((n, 2), np.float32)
    pts[:len(query)] = query
    valid = np.arange(n) < len(query)
    th0, step = np.float32(0.05), np.float32(0.013)
    ref_s, ref_th = jm.correlate_all(
        jnp.asarray(score), jnp.asarray(origins[1]), jnp.asarray(pts),
        jnp.asarray(valid), jnp.float32(th0), jnp.float32(step), 0.1, 12,
        20, score.shape[0], score.shape[0] + 64)
    got_s, got_th = tm.correlate_all(
        torch.from_numpy(score), torch.from_numpy(origins[1]),
        torch.from_numpy(pts), torch.from_numpy(valid), th0, step, 0.1, 12,
        20, score.shape[0], score.shape[0] + 64)
    np.testing.assert_array_equal(got_th.numpy(), np.asarray(ref_th))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0,
                               atol=MATCH_SCORE_ATOL)
    # the centred argmax on the same score volume
    rb, rp, rc = jm.best_candidate_with_cov(ref_s, ref_th, jnp.float32(th0),
                                            jnp.float32(step), 0.1, 20)
    gb, gp, gc = tm.best_candidate_with_cov(
        torch.from_numpy(np.asarray(ref_s)),
        torch.from_numpy(np.asarray(ref_th)), th0, step, 0.1, 20)
    assert float(gb) == float(rb)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-4,
                               atol=1e-9)


@pytest.mark.parametrize("shards", [2])
def test_dryrun_multichip_passes(shards):
    assert graft_entry.dryrun_multichip(shards, "cpu") < 1e-3


def test_dryrun_multichip_at_four_fails_as_jax_does():
    """At 4 shards (512 poses) the JAX package's own dryrun_multichip
    leaves the sharded and the dense solves 0.028 m apart after its 24
    GNC iterations on the CPU (both still moving: at 48 they are 7.5e-5
    apart), above its 1e-3, and raises; the port's raises the same way
    (0.024 m; ROADMAP.md section 3)."""
    with pytest.raises(AssertionError, match="sharded vs dense"):
        graft_entry.dryrun_multichip(4, "cpu")


def test_entry_runs_the_blocked_step():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert out.shape == (8, 64, 3) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())


def test_multihost_single_process_and_mesh_layout(monkeypatch):
    monkeypatch.delenv("SLAM_NUM_PROCESSES", raising=False)
    assert multihost.initialize() is False  # one process: no group
    mesh = cpu_mesh(4)
    assert (mesh.size, mesh.first, mesh.world, mesh.group) == (4, 0, 1, None)
    parts = [torch.full((3,), float(k)) for k in range(4)]
    assert torch.equal(mesh.psum(parts), torch.full((3,), 6.0))
    assert torch.equal(mesh.gather([p[None] for p in parts]),
                       torch.stack(parts))
    assert torch.equal(mesh.from_previous_rank(parts[2]), torch.zeros(3))
    with pytest.raises(ValueError):
        multihost.block_mesh(4, ["cpu"] * 3)


NO_CARD_CALLS = {
    "entry": (lambda: graft_entry.entry(), 'device="cpu"'),
    "dryrun_multichip": (lambda: graft_entry.dryrun_multichip(2),
                         'device="cpu"'),
    "block_mesh": (lambda: multihost.block_mesh(2), r'\["cpu"\] \* n'),
    "scaling_report": (lambda: multihost.scaling_report(
        None, 1.0, device_counts=(1,)), r'devices=\["cpu"\]'),
    "initialize_nccl": (lambda: multihost.initialize(
        "localhost:1", 2, 0), r'backend="gloo"'),
}


@pytest.mark.parametrize("name", list(NO_CARD_CALLS))
def test_entry_points_raise_without_a_card(name, monkeypatch):
    """The entry points run on the card unless the caller names the CPU:
    on a host without one they raise, naming how to ask for the CPU,
    and build nothing on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    call, cpu_option = NO_CARD_CALLS[name]
    with pytest.raises(RuntimeError, match=cpu_option):
        call()


def test_model_efficiency_matches_jax_formula():
    """The same model; the port takes the link rates as arguments, so the
    JAX package's defaults are read from its signature here."""
    d = {k: v.default for k, v in
         inspect.signature(jmh.model_efficiency).parameters.items()
         if v.default is not inspect.Parameter.empty}
    args = (2e-3, 5e-4, 3.2e6)
    ref = jmh.model_efficiency(*args)
    got = multihost.model_efficiency(
        *args, d["bw_ici"], d["bw_dcn"], d["lat_ici"], d["lat_dcn"],
        device_counts=d["device_counts"],
        devices_per_host=d["chips_per_host"])
    assert got.keys() == ref.keys()
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-15)


def closer():
    from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
    from sparse_gslam_tpu_torch.models.frontend import Frontend
    from sparse_gslam_tpu_torch.utils.config import SlamConfig

    cfg = SlamConfig()
    return SubmapLoopCloser(cfg, Frontend(cfg, device="cpu"), device="cpu")


def test_backend_mesh_routes_every_solve_to_the_sharded_solver(monkeypatch):
    """As the JAX package's _solve: a mesh takes the sharded solver even
    below dist_solver_min_poses, in max(mesh size, N / dist_block_size)
    blocks; it equals the blocked solve."""
    be = closer()
    g = pose_graph_from_numpy(closure_graph(64, 60, 8, seed=5), "cpu")
    calls = []
    orig = tds.optimize_pose_graph_sharded

    def spy(bg, sg, phi, mesh, iterations=20, gnc_init_scale=1.0):
        calls.append((bg.poses.shape[0], mesh.size))
        return orig(bg, sg, phi, mesh, iterations, gnc_init_scale)

    monkeypatch.setattr(tds, "optimize_pose_graph_sharded", spy)
    dense = be._solve(g, 10, 1.0).poses.numpy()
    assert not calls
    be.mesh = cpu_mesh(4)
    got = be._solve(g, 10, 1.0).poses.numpy()
    assert calls == [(4, 4)]
    blocked = tds.optimize_partitioned(g, be.config.dcs_phi, 4,
                                       iterations=10).poses.numpy()
    np.testing.assert_allclose(got, blocked, rtol=0, atol=BLOCKED_ATOL)
    assert np.isfinite(dense).all()


def test_backend_match_mesh_takes_the_sharded_matcher(monkeypatch):
    """With match_mesh set, _match_search's candidate search is
    match_candidates_sharded (here a miss: the query lies off the walls,
    so no refinement follows)."""
    from types import SimpleNamespace

    be = closer()
    score, pooled, origins, _, _, _ = matching_case()
    sm = SimpleNamespace(score_grid=torch.from_numpy(score),
                         pooled_grid=torch.from_numpy(pooled),
                         origin=torch.from_numpy(origins[1]), anchor_idx=0)
    snap = {"query": np.random.default_rng(0).uniform(40, 60, (64, 2)),
            "spec": tm.search_spec(2.0, 0.6, 8.0, 0.1), "mid": 7,
            "candidates": [(sm, 0.0, np.zeros(2))]}
    calls = []
    orig = tm.match_candidates_sharded

    def spy(*a, **k):
        calls.append(a[5].size)
        return orig(*a, **k)

    monkeypatch.setattr(tm, "match_candidates_sharded", spy)
    be.match_mesh = cpu_mesh(2)
    assert be._match_search(snap) is None
    assert calls == [2]


@pytest.mark.slow
def test_pipeline_world_with_meshes_matches_jax(tmp_path):
    """tests/test_pipeline_dist.py's loop world through both packages,
    once with `mesh` and once with `match_mesh` set to 2-shard meshes:
    the same closures, poses within 1e-4 (the JAX package's own
    mesh-against-dense tolerance there). Slow: four full pipeline runs
    with the JAX package's compiles."""
    from sparse_gslam_tpu.eval.simulate import SimConfig, generate_dataset
    from sparse_gslam_tpu.io.providers import (
        create_data_provider as j_provider,
    )
    from sparse_gslam_tpu.models.slam import SlamSystem as JSlam
    from sparse_gslam_tpu_torch.io.providers import create_data_provider
    from sparse_gslam_tpu_torch.models.slam import SlamSystem
    from sparse_gslam_tpu_torch.utils.config import (
        ExtractorConfig,
        SlamConfig,
    )
    from test_pipeline_dist import pipeline_configs

    generate_dataset(str(tmp_path), SimConfig(n_beams=60, seed=11),
                     name="t")
    log = str(tmp_path / "t.log")
    j_frames = list(j_provider("carmen", log).frames())
    t_frames = list(create_data_provider("carmen", log).frames())
    for hook in ("mesh", "match_mesh"):
        jcfg, jls = pipeline_configs(pg_solver="dense")
        js = JSlam(jcfg, jls, enable_backend=True)
        setattr(js.backend, hook,
                jax_mesh(2, "blocks" if hook == "mesh" else "cands"))
        for fr in j_frames:
            js.process_frame(fr)
        js.final_cleanup()
        tcfg = SlamConfig(**{f: getattr(jcfg, f) for f in
                             SlamConfig.__dataclass_fields__})
        tls = ExtractorConfig(**{f: getattr(jls, f) for f in
                                 ExtractorConfig.__dataclass_fields__})
        ts = SlamSystem(tcfg, tls, enable_backend=True, device="cpu")
        setattr(ts.backend, hook, cpu_mesh(2))
        for fr in t_frames:
            ts.process_frame(fr)
        ts.final_cleanup()
        assert ts.backend.closure_count == js.backend.closure_count >= 1
        np.testing.assert_allclose(np.stack(ts.backend.pg_poses),
                                   np.stack(js.backend.pg_poses),
                                   rtol=0, atol=1e-4)
