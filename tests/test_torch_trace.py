"""The port's recorder (utils/trace.py) on the CPU: the first frames of
sim-office through two SlamSystems with the backend and the final
cleanup, the recorder on in one and off in the other.

- the spans nest: each lies inside its parent, every span of a frame
  inside that frame's slam.frame;
- slam.lm.step spans number lm.iterations, which equals what the
  chi2 calls count (one per solve plus one per iteration);
- SubmapLoopCloser.prof, frontend_times and backend_times keep their
  keys and are the seconds of their spans;
- the two systems' outputs are bit-identical, and the one that is off
  enters no record_function;
- under a CPU torch.profiler the spans appear in key_averages(), and
  eval/profile.py's breakdown puts device operations down to the span
  of the runtime call that launched them (by correlation id);
- the runner's --profile and eval/profile.py read the recorder."""
import collections
import os
import shutil
import sys
import threading
import types

import numpy as np
import pytest
import torch

from sparse_gslam_tpu_torch.eval import profile as tprofile
from sparse_gslam_tpu_torch.io.providers import create_data_provider
from sparse_gslam_tpu_torch.models.slam import SlamSystem
from sparse_gslam_tpu_torch.ops import solvers
from sparse_gslam_tpu_torch.utils.config import load_dataset_config
from sparse_gslam_tpu_torch.utils.trace import Recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFICE = os.path.join(ROOT, "datasets", "sim-office")
N_FRAMES = 60
PROF_KEYS = {"kf_edges", "grid_build", "chain_edges", "match_snapshot",
             "match_search", "match_correlate", "match_refine",
             "match_apply", "kf_stack", "kf_window", "kf_accept",
             "refine_map", "pin_bound", "pin_window", "pin_cov",
             "pin_refine"}
LM_CHILDREN = ["slam.lm.assemble", "slam.lm.solve", "slam.lm.chi2",
               "slam.lm.decide"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    log = os.path.join(OFFICE, "sim-office.log")
    return list(create_data_provider("carmen", log).frames())[:N_FRAMES]


class _Counting:
    """Stands in for record_function and counts its entries."""

    def __init__(self, inner, entered):
        self.inner, self.entered = inner, entered

    def __call__(self, *a, **k):
        self.entered.append(a[0] if a else None)
        return self.inner(*a, **k)


def _replay(frames, enabled, chi2_calls=None, entered=None):
    """One session with the backend and its final cleanup. chi2_calls:
    a list that gets one entry per solvers.lm_graph_chi2 call (the
    patch eval/profile.py once made); entered: one per record_function
    entered."""
    saved = (solvers.lm_graph_chi2, torch.profiler.record_function,
             torch.autograd.profiler.record_function)
    if chi2_calls is not None:
        inner = solvers.lm_graph_chi2

        def counted(g):
            chi2_calls.append(1)
            return inner(g)
        solvers.lm_graph_chi2 = counted
    if entered is not None:
        torch.profiler.record_function = _Counting(saved[1], entered)
        torch.autograd.profiler.record_function = _Counting(saved[2],
                                                            entered)
    try:
        system = SlamSystem(*load_dataset_config(OFFICE),
                            enable_backend=True, device="cpu")
        system.rec.enabled = enabled
        for fr in frames:
            system.process_frame(fr)
        system.final_cleanup()
    finally:
        (solvers.lm_graph_chi2, torch.profiler.record_function,
         torch.autograd.profiler.record_function) = saved
    return system


@pytest.fixture(scope="module")
def runs(frames):
    """(on, off, chi2 calls of the off run, record_function entries of
    the off run and of the on run, which has no profiler)."""
    chi2_calls, off_entered, on_entered = [], [], []
    on = _replay(frames, True, entered=on_entered)
    off = _replay(frames, False, chi2_calls=chi2_calls, entered=off_entered)
    return on, off, chi2_calls, off_entered, on_entered


def test_spans_nest_inside_their_frame(runs):
    on = runs[0]
    spans = on.rec.closed()
    assert len(spans) == len(on.rec.spans) > 100
    frames = {s.frame: s for s in spans if s.name == "slam.frame"}
    assert sorted(frames) == list(range(N_FRAMES))
    names = collections.Counter(s.name for s in spans)
    for name in ("slam.extract", "slam.frontend.tick", "slam.frontend.graph",
                 "slam.frontend.lm", "slam.frontend.readback",
                 "slam.frontend.update", "slam.backend.tick",
                 "slam.backend.kf_edges", "slam.backend.grid_build",
                 "slam.backend.pg_solve", "slam.cleanup", *LM_CHILDREN):
        assert names[name] > 0, name
    for s in spans:
        assert s.name.startswith("slam.") and s.end_ns >= s.start_ns
        if s.parent is None:
            assert s.name in ("slam.frame", "slam.cleanup"), s
            continue
        assert s.thread == s.parent.thread
        assert s.parent.start_ns <= s.start_ns <= s.end_ns <= s.parent.end_ns
        root = s
        while root.parent is not None:
            root = root.parent
        if root.name == "slam.frame":
            assert root is frames[s.frame]
    # the tick takes in the extraction; the frontend's parts lie in it
    for s in spans:
        if s.name == "slam.frontend.tick":
            assert s.parent.name == "slam.frame"
        elif s.name == "slam.extract" or s.name.startswith("slam.frontend."):
            assert s.parent.name == "slam.frontend.tick", s


def test_lm_steps_number_the_iterations(runs):
    on, off, chi2_calls = runs[:3]
    counts = on.rec.counts
    steps = on.rec.closed("slam.lm.step")
    solves = on.rec.closed("slam.frontend.lm")
    assert counts["lm.solves"] == len(solves)
    assert counts["lm.iterations"] == len(steps) > counts["lm.solves"] > 0
    for st in steps:
        assert st.parent.name == "slam.frontend.lm"
        kids = [s.name for s in on.rec.spans if s.parent is st]
        assert kids == LM_CHILDREN
    # why each solve ended (rtol > 0 on this path), and its shape
    stops = sum(counts[k] for k in ("lm.stop.rtol", "lm.stop.lambda",
                                    "lm.stop.cap"))
    assert stops == counts["lm.solves"]
    assert 0 <= counts["lm.rejected"] < counts["lm.iterations"]
    shapes = on.rec.tallies("lm.shapes")
    assert sum(shapes.values()) == counts["lm.solves"]
    assert all(len(k) == 3 and all(v >= 16 for v in k) for k in shapes)
    assert counts["pg.solves"] >= 1
    assert counts["pg.iterations"] == (
        on.config.final_opt_iterations * counts["pg.solves"])
    # the counters are always on: the off run counts the same
    assert off.rec.counts == counts and off.rec.spans == []
    # eval/profile.py's old count: the chi2 calls less one per solve
    assert len(chi2_calls) - counts["lm.solves"] == counts["lm.iterations"]


def test_prof_and_tick_times_are_their_spans(runs):
    on, off = runs[:2]
    for system in (on, off):
        prof = system.backend.prof
        assert set(prof) <= PROF_KEYS
        assert {"kf_edges", "grid_build", "chain_edges",
                "match_snapshot"} <= set(prof)
        assert all(v > 0 for v in prof.values())
        assert len(system.frontend_times) > 0
        assert len(system.backend_times) > 0
        assert all(t > 0 for t in system.frontend_times
                   + system.backend_times)
    rec = on.rec
    assert on.frontend_times == rec.durations("slam.frontend.tick")
    assert on.backend_times == rec.durations("slam.backend.tick")
    for key, v in on.backend.prof.items():
        assert v == pytest.approx(sum(rec.durations("slam.backend." + key)),
                                  rel=1e-12), key


def test_outputs_bit_identical_on_and_off(runs):
    on, off = runs[:2]
    np.testing.assert_array_equal(on.frontend.estimates(),
                                  off.frontend.estimates())
    np.testing.assert_array_equal(
        np.stack([lm.rhotheta for lm in on.frontend.landmarks]),
        np.stack([lm.rhotheta for lm in off.frontend.landmarks]))
    np.testing.assert_array_equal(on.backend.pose_estimates(),
                                  off.backend.pose_estimates())
    assert sorted(on.backend.prof) == sorted(off.backend.prof)


def test_no_record_function_without_profiler(runs):
    """Off: never entered. On with no profiler recording: never entered
    either (it costs ~9 us a span even then)."""
    assert runs[3] == [] and runs[4] == []


def test_profiler_sees_the_spans(frames, tmp_path):
    system = SlamSystem(*load_dataset_config(OFFICE), enable_backend=False,
                        device="cpu")
    system.rec.enabled = True
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for fr in frames[:30]:
            system.process_frame(fr)
    keys = {e.key for e in prof.key_averages()}
    for name in ("slam.frame", "slam.extract", "slam.frontend.tick",
                 "slam.frontend.lm", "slam.lm.step", *LM_CHILDREN):
        assert name in keys, name
    out = tprofile.program_breakdown(prof)
    assert out["spans"] == len(system.rec.closed())
    # no card: no device operation, no launch
    assert out["launches_program"] == [] and out["unmatched"] == 0


def _event(name, device, start, dur, corr=0, thread=1, annotation=False):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        correlation_id=lambda: corr, start_thread_id=lambda: thread,
        is_user_annotation=lambda: annotation,
        device_type=lambda: ("DeviceType.CUDA" if device
                             else "DeviceType.CPU"))


def test_breakdown_matches_launches_by_correlation():
    """A synthetic trace: kernels run on the device long after their
    launch calls, so their device start lies in another span; the
    breakdown puts each down to the span that holds its launch call,
    counts the copy to the host, and puts idle time down by the gap's
    midpoint; the summary's busy time counts no span's device-side
    range."""
    ev = [
        _event("slam.frame", False, 0, 1000, annotation=True),
        _event("slam.lm.step", False, 100, 300, annotation=True),
        _event("slam.lm.solve", False, 150, 100, annotation=True),
        _event("slam.lm.step", False, 500, 300, annotation=True),
        _event("slam.lm.step", True, 150, 600, annotation=True),
        # CPU operators reuse the runtime calls' correlation ids
        _event("aten::add", False, 160, 10, corr=7),
        _event("cudaLaunchKernel", False, 160, 5, corr=7),
        _event("cudaLaunchKernel", False, 120, 5, corr=8),
        _event("cudaLaunchKernel", False, 520, 5, corr=9),
        _event("cudaMemcpyAsync", False, 900, 5, corr=10),
        _event("cudaLaunchKernel", False, 950, 5, corr=11, thread=2),
        _event("add_kernel", True, 600, 10, corr=7),
        _event("mul_kernel", True, 610, 10, corr=8),
        _event("sum_kernel", True, 700, 20, corr=9),
        _event("Memcpy DtoH (Device -> Pageable)", True, 905, 5, corr=10),
        _event("late_kernel", True, 1100, 10, corr=11),
        _event("lost_kernel", True, 1200, 10, corr=99),
    ]
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: ev)),
        key_averages=lambda: [])
    out = tprofile.program_breakdown(prof)
    assert out["spans"] == 4
    launches = {k: (n, c) for k, n, c in out["launches_program"]}
    outside = "outside the program's spans"
    assert launches == {"slam.lm.solve": (1, 0), "slam.lm.step": (2, 0),
                        "slam.frame": (0, 1), outside: (1, 0)}
    assert out["unmatched"] == 1
    assert out["lm_launches_per_step"] == pytest.approx(3 / 2)
    idle = dict(out["idle_gaps_program"])
    # busy [600, 620], [700, 720], [905, 910], [1100, 1110], [1200, 1210]
    assert idle["slam.lm.step"] == pytest.approx(80e-9)
    assert idle["slam.frame"] == pytest.approx(185e-9)
    assert idle[outside] == pytest.approx(280e-9)
    assert out["idle_outside_share"] == pytest.approx(280 / 545)
    # the device's busy time leaves out the spans' device-side ranges
    summary = tprofile._summarize(prof, 1000e-9, torch.device("cuda"), 1)
    assert summary["device_kernels"] == 6
    assert summary["device_busy_s"] == pytest.approx(65e-9)
    assert summary["device_idle_share"] == pytest.approx(1 - 65 / 1000)


def test_threads_keep_their_own_parents_and_counts():
    """Spans opened in several threads at once nest within their own
    thread, and counts from all of them add up."""
    rec = Recorder(enabled=True)
    n_threads, n_iter = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                with rec.span("slam.outer"):
                    with rec.span("slam.inner"):
                        rec.count("n")
                        rec.tally("keys", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counts["n"] == n_threads * n_iter
    assert rec.tallies("keys")[1] == n_threads * n_iter
    inner = rec.closed("slam.inner")
    assert len(inner) == n_threads * n_iter
    assert all(s.parent.name == "slam.outer" and s.parent.thread == s.thread
               for s in inner)
    assert all(s.parent is None for s in rec.closed("slam.outer"))


def test_off_span_and_timed_span():
    rec = Recorder()
    with rec.span("slam.a"):
        with rec.timed("slam.b") as t:
            pass
    assert rec.spans == [] and t.seconds >= 0 and t.parent is None
    rec.enabled = True
    with rec.timed("slam.b") as t:
        rec.frame = 3
    assert rec.spans == [t] and t.frame == -1 and t.end_ns >= t.start_ns


def _short_copy(tmp_path, n):
    """sim-office with its first `n` frames, in a directory of its own."""
    d = tmp_path / "so"
    shutil.copytree(OFFICE, d)
    with open(d / "sim-office.log") as f:
        lines = f.readlines()[:n]
    with open(d / "sim-office.log", "w") as f:
        f.writelines(lines)
    return d


def test_profile_tool_reads_the_recorder(tmp_path):
    d = _short_copy(tmp_path, 40)
    out = tprofile.profile_run(str(d), "sim-office", "cpu", (20, 30),
                               backend=False)
    for key in ("lm_calls", "lm_iterations", "lm_total_s", "lm_ms_per_call",
                "lm_ms_per_iteration", "frontend_mean_ms", "window"):
        assert key in out, key
    assert out["lm_calls"] == out["counters"]["lm.solves"] > 0
    assert out["lm_iterations"] == out["counters"]["lm.iterations"]
    assert sum(s[3] for s in out["lm_shapes"]) == out["lm_calls"]
    w = out["window"]
    assert 0 < w["lm_calls"] <= out["lm_calls"] and w["lm_s"] > 0
    assert w["program"]["spans"] > 0


def test_runner_profile_prints_the_counters(tmp_path, capsys):
    from sparse_gslam_tpu_torch import runner

    d = _short_copy(tmp_path, 30)
    trace_dir = tmp_path / "trace"
    runner.main(["--dataset-dir", str(d), "--dataset-name", "sim-office",
                 "--no-backend", "--device", "cpu",
                 "--profile", str(trace_dir)])
    text = capsys.readouterr().out
    line = [ln for ln in text.splitlines() if ln.startswith("counters:")]
    assert len(line) == 1 and "lm.solves" in line[0]
    assert "lm.iterations" in line[0]
    assert any(ln.startswith("lm shapes (P, L, E) x solves: (")
               for ln in text.splitlines())
    traces = [os.path.join(r, f) for r, _, fs in os.walk(trace_dir)
              for f in fs]
    assert traces
    body = "".join(open(p, errors="replace").read() for p in traces)
    assert '"slam.frame"' in body and '"slam.lm.step"' in body
