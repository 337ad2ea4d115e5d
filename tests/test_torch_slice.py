"""The port end to end against the JAX package: the first 150 frames of
sim-office through both frontend-only SlamSystems on the CPU (float64),
the global map through both render_maps, and the port's runner, with
and without the backend, in a process of its own that never imports
jax (nor does importing the blocked pose-graph solver, its partition,
the synthetic graphs, the native layer (the C++ CARMEN parser through
the provider's default path, the branch-and-bound matchers), the
single-submap and batched matchers, the pin bounds, the incremental
insertion, the refinement kernel's wrapper, the checkpoint, live-view,
timing, cli, simulator, wall follower or Crazyflie modules there). (The backend-on systems are compared in test_torch_backend.py.)

Tolerance for keyframe estimates: atol=1e-8. The two LM solvers sum in
different orders (and the port's long-window path uses cyclic
reduction), ~1e-15 relative per operation, compounded over the run's
incremental solves. (tests/test_torch_live.py runs the runner's
realtime, live-view, checkpoint and resume flags in a process of its
own under the same check.)"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparse_gslam_tpu.eval.maps import render_map as j_render_map
from sparse_gslam_tpu.io.providers import create_data_provider
from sparse_gslam_tpu.models.slam import SlamSystem as JSlamSystem
from sparse_gslam_tpu.utils.config import load_dataset_config
from sparse_gslam_tpu_torch.eval.maps import render_map
from sparse_gslam_tpu_torch.models.slam import SlamSystem
from sparse_gslam_tpu_torch.utils.config import (
    load_dataset_config as t_load_dataset_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFICE = os.path.join(ROOT, "datasets", "sim-office")
N_FRAMES = 150


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def runs():
    """Both systems after the same N_FRAMES frames."""
    log = os.path.join(OFFICE, "sim-office.log")
    js = JSlamSystem(*load_dataset_config(OFFICE), enable_backend=False)
    ts = SlamSystem(*t_load_dataset_config(OFFICE), enable_backend=False,
                    device="cpu")
    for k, fr in enumerate(create_data_provider("carmen", log).frames()):
        if k == N_FRAMES:
            break
        js.process_frame(fr)
        ts.process_frame(fr)
    return js, ts


def test_frontend_matches_jax(runs):
    js, ts = runs
    jf, tf = js.frontend, ts.frontend
    assert len(tf.keyframes) == len(jf.keyframes) > 40
    assert len(tf.landmarks) == len(jf.landmarks) > 10
    assert tf.rejected_ticks == jf.rejected_ticks
    assert len(tf.obs_edges) == len(jf.obs_edges)
    np.testing.assert_allclose(tf.estimates(), jf.estimates(), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(
        np.stack([lm.rhotheta for lm in tf.landmarks]),
        np.stack([lm.rhotheta for lm in jf.landmarks]), rtol=0, atol=1e-8)


def test_render_map_matches_jax_bitwise(runs):
    """Both packages' render_map on the same keyframe estimates (the
    JAX run's): the grid, its origin and resolution bit for bit."""
    js, ts = runs
    est = js.frontend.estimates()
    p_t, o_t, r_t = render_map(ts.frontend.keyframes, est, device="cpu")
    p_j, o_j, r_j = j_render_map(js.frontend.keyframes, est)
    assert (p_t > 0).sum() > 1000
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(o_t, o_j)
    assert r_t == r_j


# the backend-on run goes through the first live loop closure
# (query mid 174, accepted at frame 425); the accelerator branch's
# through its first fused-matcher query (mid 68) and pin batches
RUNNER_CASES = {"frontend_only": (["--no-backend"], N_FRAMES),
                "backend": ([], 430),
                "accel_branch": (["--accel-branch"], 200)}


@pytest.mark.parametrize("case", list(RUNNER_CASES))
def test_runner_subprocess_imports_no_jax(tmp_path, case):
    flags, frames = RUNNER_CASES[case]
    data = tmp_path / "sim-office"
    shutil.copytree(OFFICE, data)
    png = tmp_path / "map.png"
    code = (
        "import sys\n"
        "from sparse_gslam_tpu_torch import runner\n"
        "import sparse_gslam_tpu_torch.parallel.partition\n"
        "import sparse_gslam_tpu_torch.parallel.dist_solver\n"
        "import sparse_gslam_tpu_torch.eval.synthetic_graphs\n"
        "import sparse_gslam_tpu_torch.io.native\n"
        "import sparse_gslam_tpu_torch.ops.refine_cuda\n"
        "import sparse_gslam_tpu_torch.ops.lines_smf\n"
        "import sparse_gslam_tpu_torch.ops.lines_hough\n"
        "import sparse_gslam_tpu_torch.io.rosbag\n"
        "import sparse_gslam_tpu_torch.interop\n"
        "import sparse_gslam_tpu_torch.utils.checkpoint\n"
        "import sparse_gslam_tpu_torch.eval.live_view\n"
        "import sparse_gslam_tpu_torch.eval.timing\n"
        "import sparse_gslam_tpu_torch.eval.cli\n"
        "import sparse_gslam_tpu_torch.eval.simulate\n"
        "import sparse_gslam_tpu_torch.models.wall_follower\n"
        "import sparse_gslam_tpu_torch.io.crazyflie\n"
        "import sparse_gslam_tpu_torch.parallel.multihost\n"
        "import sparse_gslam_tpu_torch.graft_entry\n"
        "import sparse_gslam_tpu_torch.eval.sweep\n"
        "import numpy as np\n"
        "import torch\n"
        "from sparse_gslam_tpu_torch.io import native, providers\n"
        "from sparse_gslam_tpu_torch.ops import grid, matching\n"
        "from sparse_gslam_tpu_torch.ops.multicloud import propagate_chain\n"
        "from sparse_gslam_tpu_torch.ops.solvers import posegraph_chi2\n"
        "from sparse_gslam_tpu_torch.eval.relations import "
        "evaluate_per_separation\n"
        "from sparse_gslam_tpu_torch.eval.synthetic_graphs import "
        "graph_to_arrays\n"
        f"log = {str(data / 'sim-office.log')!r}\n"
        "assert native.parse_carmen_native(log)[0].shape == (663,)\n"
        "assert len(list(providers.CarmenLogDataProvider(log).frames())) "
        "== 663\n"
        "g = np.full((64, 64), 0.15, np.float32); g[20:40, 30] = 0.9\n"
        "q = np.stack([np.full(20, 0.05), (np.arange(20) - 10) * 0.1], 1)\n"
        "assert native.correlative_match_many_native(g[None], "
        "np.array([[-3.0, -3.2]]), 0.1, q, [0.0], 0.01, 4, 5, 3, 0.2) "
        "is not None\n"
        "pyr = grid.precompute_pyramid(torch.from_numpy(g), 5)\n"
        "o = torch.tensor([-3.0, -3.2])\n"
        "spec = matching.search_spec(0.5, 0.05, 3.0, 0.1)\n"
        "matching.match_submap(pyr[0], o, 0.1, q, 0.0, spec)\n"
        "matching.match_submaps_batched([pyr[0]] * 2, [o] * 2, [0.0, 0.1], "
        "q, spec)\n"
        "matching.match_candidates_pruned_batched([pyr[0]], [pyr[4]], [o], "
        "[0.0], q, spec, 0.2, 16)\n"
        "matching.pin_bounds_batch(pyr[4][None], torch.zeros(1, "
        "dtype=torch.long), o[None], torch.from_numpy(q[None].astype("
        "np.float32)), torch.ones(1, 20, dtype=torch.bool), "
        "torch.zeros(1, 3), 0.1, 5, True)\n"
        "p = grid.insert_range_data(torch.zeros(64, 64), o, "
        "__import__('sparse_gslam_tpu_torch.models.range_data', "
        "fromlist=['x']).RangeData2D(), None, grid.GridSpec(64, 0.1))\n"
        f"runner.main(['--dataset-dir', {str(data)!r}, '--dataset-name', "
        f"'sim-office', '--device', 'cpu', *{flags!r}, '--max-frames', "
        f"'{frames}', '--eval', '--map-png', {str(png)!r}])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'sparse_gslam_tpu.')) or m == 'sparse_gslam_tpu']\n"
        "print('IMPORTED', bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPORTED []" in out.stdout
    assert f"done: {frames} frames" in out.stdout
    assert "ATE trans" in out.stdout
    assert ("backend: " in out.stdout) == (case != "frontend_only")
    if case == "backend":
        assert "backend: 17 submaps, 1 closures (0 pruned)" in out.stdout
        assert "closures: precision" in out.stdout
    assert png.stat().st_size > 0
    assert (data / "sim-office.result").stat().st_size > 0
