"""Where a run's time goes, on a CUDA card or the CPU.

    python -m sparse_gslam_tpu_torch.eval.profile \\
        [--dataset-dir datasets/sim-office] [--dataset-name sim-office] \\
        [--device cuda|cpu] [--window 300:400] [--backend] \\
        [--out profile.json]

Replays the dataset from a temporary copy (the dataset directory is
never written) through the port's frontend (and, with --backend, the
loop-closing backend and its final cleanup), with the system's recorder
(utils/trace.py) on, and prints one JSON object:

- the frame loop's wall time, frames/s and the frontend tick's mean and
  max (host clock; each tick ends in a device-to-host copy, so it
  includes the device work; starting and stopping the profiler is
  left out);
- the LM solve's share of it: solves and LM iterations (the recorder's
  lm.solves and lm.iterations), and the wall time of the
  slam.frontend.lm spans (each ends in the LM's last host read); every
  counter under `counters` (the pins' outcomes `pins.<reason>` among
  them), the padded (P, L, E) shapes the LM solved with their counts
  under `lm_shapes`, and the backend's refinement launches by caller
  and padded N under `refine_n`;
- with --backend, the backend tick's mean and max, the final
  cleanup's seconds and the backend's own split by phase
  (`SubmapLoopCloser.prof`);
- for the frames of `--window`, a torch.profiler trace: the device's
  busy time (sum of its operations' times) over the window's wall time, the
  number of kernel launches, the LM calls and iterations inside the
  window, the operators that take most device time, and under
  `program` the device's idle time and the launches by the program's
  spans (program_breakdown).

Names the device it ran on; a time from a CPU run is a CPU time.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..io.providers import create_data_provider
from ..models.slam import SlamSystem
from ..utils.config import load_dataset_config

# the names of the recorder's spans (utils/trace.py)
SPAN_PREFIX = "slam."


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_run(dataset_dir, dataset_name, device, window, backend=False):
    device = torch.device(device)
    slam_cfg, ls_cfg = load_dataset_config(dataset_dir)
    system = SlamSystem(slam_cfg, ls_cfg, enable_backend=backend,
                        device=device)
    rec = system.rec
    rec.enabled = True
    frames = list(create_data_provider(
        slam_cfg.data_provider,
        os.path.join(dataset_dir, dataset_name + ".log")).frames())

    w0, w1 = window
    prof = None
    counts_at = {}
    overhead = 0.0  # starting and stopping the profiler, not the run's
    t0 = time.perf_counter()
    for k, fr in enumerate(frames):
        if k == w0:
            _sync(device)
            ta = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            counts_at[w0] = rec.counts
            tw = time.perf_counter()
            overhead += tw - ta
        system.process_frame(fr)
        if k == w1 - 1:
            _sync(device)
            tb = time.perf_counter()
            wall_w = tb - tw
            counts_at[w1] = rec.counts
            prof.__exit__(None, None, None)
            overhead += time.perf_counter() - tb
    tc = time.perf_counter()
    system.final_cleanup()
    _sync(device)
    cleanup = time.perf_counter() - tc
    wall = time.perf_counter() - t0 - overhead
    counts = rec.counts
    lm_spans = rec.closed("slam.frontend.lm")
    lm_s = sum(s.seconds for s in lm_spans)
    prof_summary = None
    if prof is not None:
        prof_summary = _summarize(prof, wall_w, device, w1 - w0)
        delta = counts_at[w1] - counts_at[w0]
        prof_summary["lm_calls"] = delta["lm.solves"]
        prof_summary["lm_iterations"] = delta["lm.iterations"]
        prof_summary["lm_s"] = sum(s.seconds for s in lm_spans
                                   if w0 <= s.frame < w1)
        prof_summary["program"] = program_breakdown(prof)

    ft = np.asarray(system.frontend_times)
    fe = system.frontend
    be = {}
    if system.backend is not None:
        bt = np.asarray(system.backend_times)
        be = {"backend_mean_ms": float(bt.mean() * 1e3),
              "backend_max_ms": float(bt.max() * 1e3),
              "backend_ticks": len(bt), "cleanup_s": cleanup,
              "backend_prof_s": dict(system.backend.prof)}
    calls, iters = counts["lm.solves"], counts["lm.iterations"]
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "frames": len(frames), "keyframes": len(fe.keyframes),
        "landmarks": len(fe.landmarks),
        "rejected_ticks": fe.rejected_ticks,
        "wall_s": wall, "fps": len(frames) / wall,
        "frontend_mean_ms": float(ft.mean() * 1e3),
        "frontend_max_ms": float(ft.max() * 1e3),
        "frontend_total_s": float(ft.sum()),
        "lm_calls": calls, "lm_iterations": iters,
        "lm_total_s": lm_s,
        "lm_ms_per_call": lm_s / max(calls, 1) * 1e3,
        "lm_ms_per_iteration": lm_s / max(iters, 1) * 1e3,
        "counters": dict(sorted(counts.items())),
        "lm_shapes": shape_counts(rec),
        "refine_n": refine_counts(rec),
        **be,
        "window": prof_summary,
    }


def shape_counts(rec):
    """[P, L, E, solves] of each padded shape the LM solved, most
    solved first."""
    return [[*key, n] for key, n in rec.tallies("lm.shapes").most_common()]


def refine_counts(rec):
    """[caller, padded N, launches] of the backend's refinements
    (pin, closure, chain, map), most frequent first."""
    return [[*key, n] for key, n in rec.tallies("refine.n").most_common()]


def program_breakdown(prof, prefix: str = SPAN_PREFIX) -> dict:
    """The device's idle time and the launches of a torch.profiler run,
    by the program's spans (the recorder's record_function ranges,
    whose names start with `prefix`), on the profiler's own clock.

    - `idle_gaps_program`: [span name, seconds] of the gaps between the
      device's busy intervals, each put down to the innermost span that
      holds its midpoint (any thread), or to "outside the program's
      spans"; `idle_outside_share` is that last part over all idle time;
    - `launches_program`: [span name, kernels, device-to-host copies]:
      each device operation is matched to the runtime call that
      launched it by Kineto's correlation id (not by its start on the
      device), and put down to the innermost span of the launching
      thread that holds the call; `unmatched` counts operations whose
      call the trace lacks;
    - `lm_launches_per_step`: kernels launched inside a slam.lm.step
      span, over the number of such spans (None without one)."""
    spans, runtime, dev = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_card = "CUDA" in str(e.device_type())
        if e.is_user_annotation():
            if not on_card and name.startswith(prefix):
                start = e.start_ns()
                spans.append((name, start, start + e.duration_ns(),
                              e.start_thread_id()))
        elif not on_card:
            # the CUDA API calls (cuda*, cu*); the correlation ids of
            # the CPU operators are another count
            if name.startswith("cu"):
                runtime[e.correlation_id()] = (e.start_ns(),
                                               e.start_thread_id())
        elif not name.startswith("ProfilerStep"):
            start = e.start_ns()
            dev.append((name, start, start + e.duration_ns(),
                        e.correlation_id()))
    names = [s[0] for s in spans]
    # idle gaps: the device's busy intervals merged
    busy = []
    for _, s, t, _ in sorted(dev, key=lambda d: d[1]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    busy = np.asarray(busy, np.int64).reshape(-1, 2)
    gap = busy[1:, 0] - busy[:-1, 1]
    owner = _innermost((busy[1:, 0] + busy[:-1, 1]) // 2, None, spans)
    outside = "outside the program's spans"
    idle = collections.Counter()
    for j, g in zip(owner.tolist(), gap.tolist()):
        idle[outside if j < 0 else names[j]] += g
    # launches: each device operation at its runtime call
    calls = [runtime.get(c) for _, _, _, c in dev]
    found = [k for k, c in enumerate(calls) if c is not None]
    times = np.asarray([calls[k][0] for k in found], np.int64)
    threads = np.asarray([calls[k][1] for k in found], np.int64)
    owner = _innermost(times, threads, spans)
    launches = collections.defaultdict(lambda: [0, 0])
    for k, j in zip(found, owner.tolist()):
        name = dev[k][0]
        where = outside if j < 0 else names[j]
        if name.startswith("Memcpy DtoH"):
            launches[where][1] += 1
        elif not name.startswith(("Memcpy", "Memset")):
            launches[where][0] += 1
    steps = [s for s in spans if s[0] == "slam.lm.step"]
    in_step = _innermost(times, threads, steps) >= 0
    kernel = np.asarray([not dev[k][0].startswith(("Memcpy", "Memset"))
                         for k in found], bool)
    total_idle = int(gap.sum())
    return {
        "spans": len(spans),
        "idle_gaps_program": [[k, v * 1e-9] for k, v in idle.most_common()],
        "idle_outside_share": (idle[outside] / total_idle
                               if total_idle else None),
        "launches_program": sorted(([k, *v] for k, v in launches.items()),
                                   key=lambda r: -r[1]),
        "unmatched": len(dev) - len(found),
        "lm_launches_per_step": (int((in_step & kernel).sum()) / len(steps)
                                 if steps else None),
    }


def _innermost(times, threads, spans) -> np.ndarray:
    """For each time, the index in `spans` ((name, start, end, thread))
    of the narrowest span that holds it, of the same thread where
    `threads` is given; -1 where none does."""
    owner = np.full(len(times), -1, np.int64)
    order = np.argsort(times, kind="stable")
    sorted_t = np.asarray(times)[order]
    # widest first: a narrower span that holds the time overwrites
    for j in sorted(range(len(spans)),
                    key=lambda j: spans[j][1] - spans[j][2]):
        _, a, b, th = spans[j]
        lo = np.searchsorted(sorted_t, a, side="left")
        hi = np.searchsorted(sorted_t, b, side="right")
        idx = order[lo:hi]
        if threads is not None:
            idx = idx[threads[idx] == th]
        owner[idx] = j
    return owner


def _summarize(prof, wall_s, device, n_frames):
    # busy time and operations on the card from Kineto's device events;
    # the recorder's record_function ranges also lie on the device
    # timeline, as user annotations, and are no device work
    busy_ns = kernels = 0
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()) and not e.is_user_annotation():
            busy_ns += e.duration_ns()
            kernels += 1
    rows = []
    for e in prof.key_averages():
        dev_us = 0.0 if e.key.startswith(SPAN_PREFIX) else float(
            getattr(e, "self_device_time_total", 0.0) or 0.0)
        rows.append((dev_us, e.key, e.count,
                     float(e.self_cpu_time_total)))
    rows.sort(reverse=True)
    out = {
        "frames": n_frames, "wall_s": wall_s,
        "device_busy_s": busy_ns * 1e-9,
        "device_kernels": kernels,
        "top_device_ops": [
            {"op": k, "device_ms": d * 1e-3, "count": c}
            for d, k, c, _ in rows[:10] if d > 0
        ],
    }
    if device.type == "cuda":
        out["device_idle_share"] = 1.0 - busy_ns * 1e-9 / wall_s
    else:
        rows.sort(key=lambda r: -r[3])
        out["top_cpu_ops"] = [
            {"op": k, "self_cpu_ms": s * 1e-3, "count": c}
            for _, k, c, s in rows[:10]
        ]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "datasets", "sim-office"))
    ap.add_argument("--dataset-name", default="sim-office")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--window", default="300:400",
                    help="frames traced by torch.profiler, start:stop")
    ap.add_argument("--backend", action="store_true",
                    help="run the loop-closing backend too")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device")
    w0, w1 = (int(x) for x in args.window.split(":"))
    tmp = tempfile.mkdtemp(prefix="gslam_profile_")
    try:
        data = os.path.join(tmp, args.dataset_name)
        shutil.copytree(args.dataset_dir, data)
        res = profile_run(data, args.dataset_name, args.device, (w0, w1),
                          backend=args.backend)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text = json.dumps(res)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
