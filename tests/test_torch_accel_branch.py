"""The accelerator branch of both packages' backends on sim-office, on
the CPU: the JAX package's (jax.default_backend() made to answer "gpu",
as scripts/jax_accel_branch.py does, in a process of its own that runs
beside the port's) and the port's (SlamSystem(..., accel_branch=True)).

Both load the committed JAX checkpoint of sim-office at frame 330
(scripts/make_office_checkpoint.py; the runner fields it leaves out set
from its sidecar; each rebuilds the submaps and runs the device pins of
all its keyframes) and run frames 330 to N_FRAMES = 430 under
SLAM_LOG_MATCHES: the fused matcher's queries at mids 141 and 174 (loop
closures) and 154 and 164 (misses), the device pin batches of every
precompute, the chain edges. (All 430 frames from the start take 167 s
in the JAX package and 449 s in the port on one CPU thread of an Intel
Xeon, too long for the suite; the full run is held by
scripts/compare_world_run.py sim-office-accel and chip_smoke.py's
`accel` phase.) Held: the decision lines (MISS scores within
chip_smoke.MISS_SCORE_ATOL), the (i, j, kind, active) closure list,
the pin counters, and the closure measurements and pose-graph vertices
within POSE_ATOL. Then rebuild_grids on the port's backend must drop
every cached spectrum and device stack.

POSE_ATOL: the window covariances' float32 sums (tests/
test_torch_fused_match.py, test_torch_pin_batch.py) and the pins'
refinement (one pin at a time in the port, under vmap in the JAX
program: up to 5.4e-5 apart on seeded pins, test_torch_pin_batch.py)
move the solved vertices: 1.3e-7 m here on an Intel Xeon (printed).
"""
import contextlib
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sparse_gslam_tpu_torch.io.providers import create_data_provider
from sparse_gslam_tpu_torch.models.slam import SlamSystem
from sparse_gslam_tpu_torch.ops import matching as tm
from sparse_gslam_tpu_torch.utils import checkpoint as tck
from sparse_gslam_tpu_torch.utils.config import (
    load_dataset_config as t_load_dataset_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

OFFICE = os.path.join(ROOT, "datasets", "sim-office")
N_FRAMES = 430
POSE_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def resumed(system, load):
    """`system` with the committed checkpoint loaded and the runner
    fields it leaves out set from the sidecar; the first frame to run."""
    load(chip_smoke.RESUME_CHECKPOINT, system)
    with np.load(chip_smoke.RESUME_RUN) as z:
        system.frame_idx = int(z["frame_idx"])
        system.deltas = list(z["deltas"])
        system.zero_pose = z["zero_pose"].copy()
        system.last_pose = z["last_pose"].copy()
        system.mc._cloud_odom = z["cloud_odom"].copy()
        return int(z["cut"])


def run(system, frames):
    """Process `frames` under SLAM_LOG_MATCHES; the decision lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for fr in frames:
            system.process_frame(fr)
    return chip_smoke.decision_lines(out.getvalue())


def frames():
    return list(create_data_provider(
        "carmen", os.path.join(OFFICE, "sim-office.log")).frames())


def jax_side(out_path):
    """The JAX package's run (in a process of its own, beside the
    port's): its decision lines, closures, pose graph and pin counters
    to `out_path` (npz)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.environ["SLAM_LOG_MATCHES"] = "1"
    jax.default_backend = lambda: "gpu"
    from sparse_gslam_tpu.models.slam import SlamSystem as JSlamSystem
    from sparse_gslam_tpu.utils import checkpoint as jck
    from sparse_gslam_tpu.utils.config import load_dataset_config

    js = JSlamSystem(*load_dataset_config(OFFICE))
    cut = resumed(js, jck.load_checkpoint)
    lines = run(js, frames()[cut:N_FRAMES])
    be = js.backend
    np.savez(
        out_path, lines=np.array(lines),
        closures=np.array([(c.i, c.j, ("loop", "local", "kf").index(
            c.kind), c.active) for c in be.closures]),
        meas=np.array([c.meas for c in be.closures]),
        poses=be.pose_estimates(), submaps=be.submap_count,
        loop_closures=be.closure_count,
        kf_stats=np.array(sorted(be.kf_stats.items()), dtype=object))


@pytest.fixture(scope="module")
def accel_runs(tmp_path_factory):
    """The JAX run in a subprocess while the port runs here; (JAX
    results, the port's SlamSystem, its decision lines)."""
    out = str(tmp_path_factory.mktemp("accel") / "jax.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    proc = subprocess.Popen([sys.executable, __file__, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SLAM_LOG_MATCHES", "1")
            ts = SlamSystem(*t_load_dataset_config(OFFICE), device="cpu",
                            accel_branch=True)
            cut = resumed(ts, tck.load_checkpoint)
            tlines = run(ts, frames()[cut:N_FRAMES])
    finally:
        log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    with np.load(out, allow_pickle=True) as z:
        j = {k: z[k] for k in z.files}
    return j, ts, tlines


def test_decision_lines_match_jax(accel_runs):
    j, _, tlines = accel_runs
    jlines = [str(ln) for ln in j["lines"]]
    print("\n".join(tlines))
    assert sum("HIT" in ln for ln in jlines) >= 2
    assert sum("MISS" in ln for ln in jlines) >= 2
    assert chip_smoke.first_decision_difference(tlines, jlines) is None


def test_closures_and_pose_graph_match_jax(accel_runs):
    j, ts, _ = accel_runs
    tb = ts.backend
    keys = [(c.i, c.j, ("loop", "local", "kf").index(c.kind), c.active)
            for c in tb.closures]
    assert keys == [tuple(int(v) for v in k) for k in j["closures"]]
    assert tb.closure_count == int(j["loop_closures"]) >= 1
    assert tb.submap_count == int(j["submaps"])
    assert sorted(tb.kf_stats.items()) == [tuple(kv) for kv in
                                           j["kf_stats"]]
    tp = tb.pose_estimates()
    assert tp.shape == j["poses"].shape
    d = tp - j["poses"]
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    print("pose graph max |port - JAX|:", float(np.abs(d).max()))
    np.testing.assert_allclose(tp, j["poses"], rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(np.array([c.meas for c in tb.closures]),
                               j["meas"], rtol=0, atol=POSE_ATOL)


def test_rebuild_grids_drops_every_cached_spectrum(accel_runs):
    """After the run the backend has cached spectra (and here its
    device stacks, built as the next pin batch would); rebuild_grids
    (refine_map's and rematch_all's) must drop them all, and the next
    get_spectrum must be the new score grid's."""
    _, ts, _ = accel_runs
    be = ts.backend
    F = be.spec.size + 64
    be._get_spectra_stack(F)
    be._get_high_stack()
    assert all(sm.spectrum is not None for sm in be.submaps)
    assert be._spectra_stack is not None and be._high_stack is not None
    stale = [sm.spectrum for sm in be.submaps]
    est = be.pose_estimates()
    est = np.concatenate([est, ts.frontend.estimates()[len(est):]])
    est = est + np.array([0.05, -0.03, 0.0])  # moves every grid
    be.rebuild_grids(est)
    assert all(sm.spectrum is None for sm in be.submaps)
    assert be._spectra_stack is None and be._high_stack is None
    for sm, old in zip(be.submaps, stale):
        new = sm.get_spectrum(F)
        assert torch.equal(new, tm.grid_spectrum(sm.score_grid[None], F,
                                                 be.spec.size)[0])
        if old is not None:
            assert not torch.equal(new, old)


if __name__ == "__main__":
    jax_side(sys.argv[1])
