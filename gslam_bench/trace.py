"""What a `--trace 1` run records, from the benchmark's own wrappers
around the program's calls (nothing inside the program changes).

Over the measured window:

- host spans, timed on the host clock and named for the profiler with
  torch.profiler.record_function: `host.extract` (line extraction,
  patched where models/slam.py looks it up), `frontend.lm` (the LM solve,
  synchronised before and after, as eval/profile.py times it),
  `backend.precompute`, `backend.match` and `session.cleanup`;
- the inputs of each launch of the two hand-written kernels, with CUDA
  events recorded on its stream before and after it (the kernel's time
  on the card, for the roofline shares).

After the window, a torch.profiler trace of a fixed slice of frames
(the cell's trace_frames) of one more session replayed from frame 0,
reduced to device intervals and host spans. The profiler runs only
there: its first start takes seconds, and from then on every kernel
launch of the process pays for its callbacks, so no host-clock number
is read after it.
"""
from __future__ import annotations

import collections
import functools
import time

import numpy as np
import torch

# the device-side wait queued ahead of each timed launch: ~0.5 ms at the
# H100's 1.98 GHz, longer than the host takes to enqueue the kernel
SLEEP_CYCLES = 1_000_000

SPAN_NAMES = ("host.extract", "frontend.lm", "backend.precompute",
              "backend.match", "session.cleanup")


class Tracer:
    """Installs the wrappers for one run and holds what they record.
    `device` "cpu" is for the harness's own tests (no card: no events,
    no profiler)."""

    def __init__(self, device: str = "cuda"):
        self.cuda = device == "cuda"
        # False once the window has closed: the spans still name the
        # profiler's ranges, but record nothing
        self.recording = True
        self.spans = collections.defaultdict(list)  # name -> seconds
        # kernel -> (the launch's inputs, CUDA events before and after it)
        self.launches = {"insert_rays": [], "refine_pose": []}
        self.prof = None
        self.wall_s = 0.0
        self._undo = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    # -- wrappers ---------------------------------------------------------
    def _patch(self, obj, name, new):
        old = getattr(obj, name)
        self._undo.append((obj, name, old))
        setattr(obj, name, new)

    def span(self, name, fn, synced=False):
        """fn timed on the host clock and named in the profiler."""
        times = self.spans[name]

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                if synced:
                    self._sync()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if synced:
                    self._sync()
                if self.recording:
                    times.append(time.perf_counter() - t0)
            return out
        return wrapped

    def install(self):
        from sparse_gslam_tpu_torch.models import frontend, slam
        from sparse_gslam_tpu_torch.ops import grid_cuda, refine_cuda

        self._patch(slam, "extract_lines_any",
                    self.span("host.extract", slam.extract_lines_any))
        self._patch(frontend.solvers, "optimize_landmark_graph",
                    self.span("frontend.lm",
                              frontend.solvers.optimize_landmark_graph,
                              synced=True))
        rec = self

        ins = grid_cuda.insert_rays_cuda

        @functools.wraps(ins)
        def insert(*a, **k):
            t = rec._events()
            out = ins(*a, **k)
            rec._close("insert_rays", t, a[:9])
            return out
        self._patch(grid_cuda, "insert_rays_cuda", insert)

        ref = refine_cuda.refine_cuda

        @functools.wraps(ref)
        def refine(stages, points, *a, **k):
            t = rec._events()
            out = ref(stages, points, *a, **k)
            want_cov = k.get("want_cov", a[3] if len(a) > 3 else True)
            rec._close("refine_pose", t,
                       (int(points.shape[1]), out[3], bool(want_cov)))
            return out
        self._patch(refine_cuda, "refine_cuda", refine)

    def _events(self):
        """A CUDA event recorded on the current stream before a launch,
        behind a short device-side wait: the card would otherwise idle
        from the event until the host has enqueued the kernel, and that
        gap would count as the kernel's time."""
        if not (self.cuda and self.recording):
            return None
        torch.cuda._sleep(SLEEP_CYCLES)
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _close(self, kernel, start, record):
        if start is None:
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.launches[kernel].append((record, start, end))

    def session(self, system):
        """Spans on one session's backend calls."""
        be = system.backend
        if be is not None:
            be.precompute = self.span("backend.precompute", be.precompute)
            be.match = self.span("backend.match", be.match)

    def cleanup(self):
        return torch.profiler.record_function("session.cleanup")

    def uninstall(self):
        while self._undo:
            obj, name, old = self._undo.pop()
            setattr(obj, name, old)

    # -- the traced slice ---------------------------------------------------
    def traced_session(self, make_system, frames, trace_frames):
        """One more session over frames [0, b), the profiler on over
        [a, b). Returns the session as the window's are given:
        (system, frames, ended, backend phase seconds)."""
        self.recording = False
        a, b = trace_frames
        system = make_system()
        self.session(system)
        for k, fr in enumerate(frames[:b]):
            if k == a and self.cuda:
                self._sync()
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.__enter__()
                t0 = time.perf_counter()
            system.process_frame(fr)
        if self.prof is not None:
            self._sync()
            self.wall_s = time.perf_counter() - t0
            self.prof.__exit__(None, None, None)
        return system, min(b, len(frames)), False, {}

    def reduce(self) -> dict:
        """The slice as plain lists: device operations (name, start ns,
        end ns, is_kernel) and host spans (name, start ns, end ns)."""
        dev, host = [], []
        if self.prof is None:
            return {"device": dev, "host": host, "wall_s": 0.0}
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            on_card = "CUDA" in str(e.device_type())
            if name in SPAN_NAMES:
                if not on_card:
                    host.append((name, start, end))
                continue
            if not on_card or name.startswith("ProfilerStep") or (
                    getattr(e, "is_user_annotation", lambda: False)()):
                continue
            kernel = not name.startswith(("Memcpy", "Memset"))
            dev.append((name, start, end, kernel))
        return {"device": dev, "host": host, "wall_s": self.wall_s}


def _ns(e, what):
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def busy_intervals(dev):
    """The union of the device operations' intervals, merged, sorted."""
    iv = sorted((s, t) for _, s, t, _ in dev)
    out = []
    for s, t in iv:
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def breakdown(tr: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    between device operations by the innermost host span they fall in."""
    by_op = collections.defaultdict(int)
    for name, s, t, _ in tr["device"]:
        by_op[name[:120]] += t - s
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    busy = np.asarray(busy_intervals(tr["device"]), np.int64).reshape(-1, 2)
    gap_s, gap_t = busy[:-1, 1], busy[1:, 0]
    mid = (gap_s + gap_t) // 2
    owner = np.full(len(mid), -1)
    width = np.full(len(mid), np.iinfo(np.int64).max)
    names = sorted({h[0] for h in tr["host"]})
    for name, a, b in tr["host"]:
        inside = (mid >= a) & (mid <= b) & (b - a < width)
        owner[inside] = names.index(name)
        width[inside] = b - a
    gaps = collections.defaultdict(int)
    for k, name in [(-1, "host, outside the named spans")] + list(
            enumerate(names)):
        gaps[name] += int((gap_t - gap_s)[owner == k].sum())
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v * 1e-9] for k, v in ops],
            "idle_gaps": [[k, v * 1e-9] for k, v in idle]}
