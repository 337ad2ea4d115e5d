"""The port's live entry points on the CPU: SlamSystem.run_realtime with
its backend thread, the LiveVisualizer render thread, the runner's
--realtime/--map-every/--live-view/--checkpoint/--resume/--profile
flags, and the kernel wrappers' launch counters under threads.

- Realtime: the JAX package's test_failure_paths.py
  TestRealtimeInterleave on the port (rate 1e9: the frontend never
  sleeps, the most interleaving), with the same invariants: finite
  estimates, aligned pose-graph arrays, closure endpoints inside the
  chain, a monotone .result. A second run beside a LiveVisualizer at
  20 Hz writes its PNGs and status JSON with no render error.
- Failures: an exception in the backend thread ends the run and is
  raised by run_realtime; a render error is counted and the run goes on.
- Runner: a realtime run with map dumps, live view, a checkpoint and a
  profiler trace, then a run resumed from that checkpoint, each in a
  process that never imports jax.
- Counters: grid_cuda.count_launch from eight threads, and the
  refinement's host build called from four threads at once, each call
  counted: the counts are exact and the results equal serial ones."""
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparse_gslam_tpu_torch.eval.live_view import LiveVisualizer
from sparse_gslam_tpu_torch.eval.relations import load_result
from sparse_gslam_tpu_torch.eval.simulate import SimConfig, generate_dataset
from sparse_gslam_tpu_torch.io.providers import create_data_provider
from sparse_gslam_tpu_torch.models.slam import SlamSystem
from sparse_gslam_tpu_torch.ops import grid_cuda, refine_cuda
from sparse_gslam_tpu_torch.utils.config import ExtractorConfig, SlamConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFICE = os.path.join(ROOT, "datasets", "sim-office")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("rt")
    generate_dataset(str(d), SimConfig(n_beams=60, seed=4), name="t")
    return d, list(create_data_provider("carmen", str(d / "t.log")).frames())


def small_system():
    slam = SlamConfig(
        std_r=0.05, range_max=10.0, scan_size=11, multicloud_size=88,
        landmark_max_gap=0.5, match_interval=20, dcs_phi=10.0,
        max_match_distance=10.0, submap_trajectory_length=6.0,
    )
    ls = ExtractorConfig(min_line_points=8, cluster_threshold=100.0)
    return SlamSystem(slam, ls, enable_backend=True, device="cpu")


def check_invariants(sys_, path):
    fe, be = sys_.frontend, sys_.backend
    assert len(fe.keyframes) > 20
    assert np.isfinite(fe.estimates()).all()
    # pose-graph invariants: parallel arrays aligned, measurements
    # finite, closure endpoints inside the chain
    assert len(be.pg_poses) == len(be.pg_meas) == len(be.pg_info)
    assert len(be.pg_poses) <= len(fe.keyframes)
    if be.pg_poses:
        assert np.isfinite(np.stack(be.pg_poses)).all()
    for c in be.closures:
        assert 0 <= c.i < len(fe.keyframes)
        assert 0 <= c.j < len(fe.keyframes)
        assert np.isfinite(c.meas).all()
    # the result writer must produce a consistent trajectory
    sys_.write_result(str(path))
    times, poses = load_result(str(path))
    assert np.isfinite(poses).all()
    assert (np.diff(times) >= 0).all()


def test_realtime_run_is_uncorrupted(world, tmp_path):
    _, frames = world
    sys_ = small_system()
    sys_.run_realtime(frames[:260], rate=1e9)
    check_invariants(sys_, tmp_path / "t.result")
    rt = sys_.realtime
    assert rt.frames == 260 and len(rt.lags) == 260


def test_realtime_with_live_view(world, tmp_path):
    _, frames = world
    sys_ = small_system()
    prefix = str(tmp_path / "t")
    live = LiveVisualizer(sys_, prefix, rate=20.0)
    live.start()
    sys_.run_realtime(frames[:160], rate=1e9)
    live.stop(final=True)
    check_invariants(sys_, tmp_path / "t.result")
    assert live.errors == 0 and live.renders >= 1
    for suffix in ("_live_lm.png", "_live_pg.png"):
        with open(prefix + suffix, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(prefix + "_live_status.json") as fh:
        status = json.load(fh)
    assert status["frame"] == 160 and status["renders"] == live.renders
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_backend_thread_failure_ends_the_run(world):
    _, frames = world
    sys_ = small_system()

    def broken():
        raise FloatingPointError("backend failed")

    sys_.backend.precompute = broken
    # rate 20: the frontend sleeps ~10 ms a frame, so the backend thread
    # gets the lock early
    with pytest.raises(FloatingPointError, match="backend failed"):
        sys_.run_realtime(frames[:200], rate=20.0)
    assert sys_.frame_idx < 200


def test_render_errors_are_counted(world, tmp_path, monkeypatch):
    _, frames = world
    sys_ = small_system()
    for fr in frames[:60]:
        sys_.process_frame(fr)
    from sparse_gslam_tpu_torch.eval import maps

    def broken(*a, **k):
        raise RuntimeError("render failed")

    monkeypatch.setattr(maps, "render_map", broken)
    live = LiveVisualizer(sys_, str(tmp_path / "t"), rate=50.0)
    live.start()
    deadline = time.monotonic() + 60
    while live.errors < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    live.stop(final=False)
    assert live.errors >= 2 and live.renders == 0


def test_runner_realtime_checkpoint_resume_imports_no_jax(tmp_path):
    data = tmp_path / "sim-office"
    shutil.copytree(OFFICE, data)
    ckpt = tmp_path / "c.npz"
    prof = tmp_path / "prof"
    code = (
        "import sys\n"
        "from sparse_gslam_tpu_torch import runner\n"
        "common = ['--dataset-dir', sys.argv[1], '--dataset-name', "
        "'sim-office', '--device', 'cpu', '--max-frames', '80']\n"
        "runner.main(common + ['--realtime', '--rate', '1e9', "
        "'--map-every', '40', '--live-view', '5', '--checkpoint', "
        "sys.argv[2], '--profile', sys.argv[3]])\n"
        "runner.main(common + ['--resume', sys.argv[2]])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'sparse_gslam_tpu.')) or m == 'sparse_gslam_tpu']\n"
        "print('IMPORTED', bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-c", code, str(data), str(ckpt), str(prof)],
        capture_output=True, text=True, env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPORTED []" in out.stdout
    assert out.stdout.count("done: 80 frames") == 2
    assert "realtime: rate 1e+09, 80 frames" in out.stdout
    assert "live view: " in out.stdout and " 0 render errors" in out.stdout
    assert f"resumed from {ckpt}" in out.stdout
    for name in ("sim-office-map-00040.png", "sim-office-map-00080.png",
                 "sim-office_live_lm.png", "sim-office_live_status.json",
                 "sim-office.result"):
        assert (data / name).stat().st_size > 0, name
    with np.load(ckpt) as z:
        assert len(z["kf_estimates"]) > 20
    assert any(f.endswith(".json") for f in os.listdir(prof))


def test_launch_counter_is_exact_under_threads():
    class Wrapper:
        pass

    w = Wrapper()
    grid_cuda.reset_launches(w)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [grid_cuda.count_launch(w) for _ in range(3000)],
            name=f"t{k}") for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert w.launches == 24000
    assert w.launches_by_thread == {f"t{k}": 3000 for k in range(8)}
    grid_cuda.reset_launches(w)
    assert w.launches == 0 and w.launches_by_thread == {}


def host_refine(lib, seed):
    """One refinement through the kernel's host build on a seeded room
    grid (one stage at 0.1 m, N = 256)."""
    import ctypes

    rng = np.random.default_rng(seed)
    G, n = 96, 256
    grid = rng.uniform(0.0, 0.9, (G, G)).astype(np.float32)
    origin = np.full(2, -G * 0.05, np.float32)
    pts = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    valid = (np.arange(n) < 200).astype(np.uint8)
    init = np.array([0.02, -0.01, 0.01], np.float32)
    y0 = refine_cuda.rsqrtss_table()
    pose = np.zeros(3, np.float32)
    cov = np.zeros(9, np.float32)
    probs = np.zeros(n, np.float32)
    steps = np.zeros(2, np.int32)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.refine_pose_host(
        p(grid), G, p(origin), 0.1, p(grid), G, p(origin), 0.1, 1, p(pts),
        p(valid), p(init), p(y0), 1, n, 10, 1, p(pose), p(cov), p(probs),
        p(steps))
    assert rc == 0
    return np.concatenate([pose, cov, probs])


def test_host_build_counted_from_threads():
    """The refinement's host build (ctypes drops the GIL while it runs)
    called from four threads at once, each call counted as a wrapper
    counts its launch: every result equals the serial one and the
    count is exact."""
    lib = refine_cuda.host_library()
    serial = [host_refine(lib, s) for s in range(4)]

    class Wrapper:
        pass

    w = Wrapper()
    grid_cuda.reset_launches(w)
    results = {}

    def work(seed):
        for _ in range(5):
            out = host_refine(lib, seed)
            grid_cuda.count_launch(w)
            results.setdefault(seed, []).append(out)

    threads = [threading.Thread(target=work, args=(s,), name=f"h{s}")
               for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert w.launches == 20
    assert w.launches_by_thread == {f"h{s}": 5 for s in range(4)}
    for s in range(4):
        for out in results[s]:
            np.testing.assert_array_equal(out, serial[s])
