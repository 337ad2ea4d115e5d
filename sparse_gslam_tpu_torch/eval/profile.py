"""Where a run's time goes, on a CUDA card or the CPU.

    python -m sparse_gslam_tpu_torch.eval.profile \\
        [--dataset-dir datasets/sim-office] [--dataset-name sim-office] \\
        [--device cuda|cpu] [--window 300:400] [--backend] \\
        [--out profile.json]

Replays the dataset from a temporary copy (the dataset directory is
never written) through the port's frontend (and, with --backend, the
loop-closing backend and its final cleanup) and prints one JSON object:

- the frame loop's wall time, frames/s and the frontend tick's mean and
  max (host clock; each tick ends in a device-to-host copy, so it
  includes the device work; starting and stopping the profiler is
  left out);
- the LM solve's share of it: calls, LM iterations, and wall time spent
  inside `optimize_landmark_graph` (synchronised on the device);
- with --backend, the backend tick's mean and max, the final
  cleanup's seconds and the backend's own split by phase
  (`SubmapLoopCloser.prof`);
- for the frames of `--window`, a torch.profiler trace: the device's
  busy time (sum of kernel times) over the window's wall time, the
  number of kernel launches, the LM calls and iterations inside the
  window, and the operators that take most device time.

Names the device it ran on; a time from a CPU run is a CPU time.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from ..io.providers import create_data_provider
from ..models import frontend as frontend_mod
from ..models.slam import SlamSystem
from ..ops import solvers
from ..utils.config import load_dataset_config


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_run(dataset_dir, dataset_name, device, window, backend=False):
    device = torch.device(device)
    slam_cfg, ls_cfg = load_dataset_config(dataset_dir)
    system = SlamSystem(slam_cfg, ls_cfg, enable_backend=backend,
                        device=device)
    frames = list(create_data_provider(
        slam_cfg.data_provider,
        os.path.join(dataset_dir, dataset_name + ".log")).frames())

    lm = {"calls": 0, "iterations": 0, "seconds": 0.0}
    inner_chi2 = solvers.lm_graph_chi2
    inner_opt = solvers.optimize_landmark_graph

    def counted_chi2(g):
        lm["iterations"] += 1
        return inner_chi2(g)

    def timed_opt(g, *a, **k):
        _sync(device)
        t0 = time.perf_counter()
        out = inner_opt(g, *a, **k)
        _sync(device)
        lm["seconds"] += time.perf_counter() - t0
        lm["calls"] += 1
        lm["iterations"] -= 1  # the initial chi2 is not an iteration
        return out

    solvers.lm_graph_chi2 = counted_chi2
    frontend_mod.solvers.optimize_landmark_graph = timed_opt
    w0, w1 = window
    prof = None
    lm_at = {}
    overhead = 0.0  # starting and stopping the profiler, not the run's
    try:
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
                lm_at[w0] = dict(lm)
                tw = time.perf_counter()
                overhead += tw - ta
            system.process_frame(fr)
            if k == w1 - 1:
                _sync(device)
                tb = time.perf_counter()
                wall_w = tb - tw
                lm_at[w1] = dict(lm)
                prof.__exit__(None, None, None)
                overhead += time.perf_counter() - tb
        tc = time.perf_counter()
        system.final_cleanup()
        _sync(device)
        cleanup = time.perf_counter() - tc
        wall = time.perf_counter() - t0 - overhead
    finally:
        solvers.lm_graph_chi2 = inner_chi2
        frontend_mod.solvers.optimize_landmark_graph = inner_opt
    prof_summary = None
    if prof is not None:
        prof_summary = _summarize(prof, wall_w, device, w1 - w0)
        prof_summary["lm_calls"] = lm_at[w1]["calls"] - lm_at[w0]["calls"]
        prof_summary["lm_iterations"] = (lm_at[w1]["iterations"]
                                         - lm_at[w0]["iterations"])
        prof_summary["lm_s"] = lm_at[w1]["seconds"] - lm_at[w0]["seconds"]

    ft = np.asarray(system.frontend_times)
    fe = system.frontend
    be = {}
    if system.backend is not None:
        bt = np.asarray(system.backend_times)
        be = {"backend_mean_ms": float(bt.mean() * 1e3),
              "backend_max_ms": float(bt.max() * 1e3),
              "backend_ticks": len(bt), "cleanup_s": cleanup,
              "backend_prof_s": dict(system.backend.prof)}
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
        "lm_calls": lm["calls"], "lm_iterations": lm["iterations"],
        "lm_total_s": lm["seconds"],
        "lm_ms_per_call": lm["seconds"] / max(lm["calls"], 1) * 1e3,
        "lm_ms_per_iteration": lm["seconds"] / max(lm["iterations"], 1)
        * 1e3,
        **be,
        "window": prof_summary,
    }


def _summarize(prof, wall_s, device, n_frames):
    rows = []
    busy_us = 0.0
    for e in prof.key_averages():
        dev_us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        busy_us += dev_us
        rows.append((dev_us, e.key, e.count,
                     float(e.self_cpu_time_total)))
    kernels = sum(1 for e in prof.events()
                  if getattr(e, "device_type", None) is not None
                  and str(e.device_type).endswith("CUDA"))
    rows.sort(reverse=True)
    out = {
        "frames": n_frames, "wall_s": wall_s,
        "device_busy_s": busy_us * 1e-6,
        "device_kernels": kernels,
        "top_device_ops": [
            {"op": k, "device_ms": d * 1e-3, "count": c}
            for d, k, c, _ in rows[:10] if d > 0
        ],
    }
    if device.type == "cuda":
        out["device_idle_share"] = 1.0 - busy_us * 1e-6 / wall_s
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
