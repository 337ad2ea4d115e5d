"""Run one benchmark cell once.

    python3 -m gslam_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration
(configs/<name>.json: the engine's slam.yaml and line_extractor.yaml
keys) and a traffic mix (traffic/<name>.json: a world file and the
simulator's settings). One run:

1. set-up (timed as setup_s): open the card (a run without enough CUDA
   cards prints no result and exits with 2), build or load the port's
   kernel and host libraries from its build cache, make the sensor log
   from --seed and write it with the configuration's YAML files into a
   fresh directory under TMPDIR, parse it through the port's provider,
   and run one discarded session up to its first backend tick that
   matches, then its final cleanup;
2. the window: the log is replayed as the upstream log_runner's
   sequential mode does (each frame to SlamSystem.process_frame as soon
   as the previous one returns, final_cleanup at the log's end, then a
   fresh SlamSystem from frame 0), in whole sessions: the window closes
   at the end of the first session that ends --seconds or more after
   it opened, so every window holds the same work per session whatever
   the host's speed; with --trace 1 the benchmark's wrappers are on, and
   after the window one more session replays the cell's traced slice of
   frames under the profiler (trace.py);
3. the check: every session of the window is compared (compare.py) with
   the plain reference (reference/) run on the CPU over the same log,
   and the numbers are printed beside their limits, as the last lines
   on standard error;
4. the result: no module named jax, jaxlib, flax or sparse_gslam_tpu
   (whole top-level names) may be loaded by then, or the run prints no
   result and exits with 3; one JSON line, last on standard output: the
   end-to-end metrics with --trace 0, the per-layer metrics
   (metrics/<name>.py) with --trace 1.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may load (compared whole: the port's own
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_gslam_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = {m.split(".", 1)[0] for m in list(modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def load_cell(name: str) -> tuple:
    """(cell, configuration, traffic) entries for workload `name`."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def _yaml_value(v) -> str:
    return repr(v) if isinstance(v, float) else str(v)


def write_dataset(out_dir: str, name: str, config: dict, sim: dict) -> None:
    """<out_dir>/<name>.log, slam.yaml and line_extractor.yaml."""
    from .generator import write_carmen_log

    write_carmen_log(os.path.join(out_dir, name + ".log"), sim)
    for fname, group in (("slam.yaml", "slam"),
                         ("line_extractor.yaml", "line_extractor")):
        with open(os.path.join(out_dir, fname), "w") as f:
            for k, v in config[group].items():
                f.write(f"{k}: {_yaml_value(v)}\n")


def read_metric(name: str, ctx: dict):
    """metrics/<name>.py's read(ctx), or None where it finds nothing."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gslam_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(ctx)
    return None if value is None else float(value)


def power_limit() -> str:
    """nvidia-smi's name and power limit of card 0, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def host_reading() -> dict:
    """This process's CPU seconds and the mean `cpu MHz` of
    /proc/cpuinfo (absent where the file gives none)."""
    out = {"cpu_s": sum(os.times()[:2])}
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(ln.split(":")[1]) for ln in f
                   if ln.startswith("cpu MHz")]
        if mhz:
            out["mhz"] = sum(mhz) / len(mhz)
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_share(a: dict, b: dict, seconds: float) -> dict:
    """The host between two readings: the CPUs this process kept busy,
    and the clock at both ends."""
    out = {"own_cpus": (b["cpu_s"] - a["cpu_s"]) / seconds}
    if "mhz" in a and "mhz" in b:
        out["mhz"] = [a["mhz"], b["mhz"]]
    return out


def open_card(chips: int):
    """torch on the card, or a SystemExit(2) where the cell's cards are
    missing (no CPU fallback)."""
    # the port builds into its own sparse_gslam_tpu_torch/_build/; any
    # PyTorch or Triton cache also stays at a fixed path in the checkout
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    import torch

    if not torch.cuda.is_available():
        print("gslam_bench: torch.cuda.is_available() is false; the "
              "benchmark runs on a CUDA card only", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"gslam_bench: the cell needs {chips} CUDA cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        raise SystemExit(2)
    torch.zeros(1, device="cuda").sum().item()
    return torch


def setup(config: dict, traffic: dict, cell: dict, seed: int, device: str,
          work: str):
    """Everything before the window; returns (slam config, extractor
    config, frames, dataset directory)."""
    import torch

    from sparse_gslam_tpu_torch.io.providers import create_data_provider
    from sparse_gslam_tpu_torch.models.slam import SlamSystem
    from sparse_gslam_tpu_torch.utils.config import load_dataset_config

    from .generator import make_traffic

    if device == "cuda":
        from sparse_gslam_tpu_torch.ops import grid_cuda, refine_cuda

        grid_cuda.load()
        refine_cuda.load()
    sim = make_traffic(traffic, seed)
    write_dataset(work, cell["traffic"], config, sim)
    slam_cfg, ls_cfg = load_dataset_config(work)
    frames = list(create_data_provider(
        slam_cfg.data_provider,
        os.path.join(work, cell["traffic"] + ".log")).frames())
    # one discarded session up to its first backend tick with candidates
    # to match (or the traffic's warmup_frames, where none comes sooner),
    # then its cleanup: cuFFT plans, cuSOLVER/cuBLAS handles and the
    # allocator warm
    warm = SlamSystem(slam_cfg, ls_cfg, enable_backend=True, device=device)
    for fr in frames[:traffic["warmup_frames"]]:
        warm.process_frame(fr)
        if warm.backend.prof.get("match_search", 0.0) > 0.0:
            break
    warm.final_cleanup()
    if device == "cuda":
        torch.cuda.synchronize()
    del warm
    gc.collect()
    return slam_cfg, ls_cfg, frames


def window(slam_cfg, ls_cfg, frames, seconds: float, device: str,
           tracer=None):
    """Replay `frames` in whole sessions until one ends `seconds` or more
    after the window opened. Returns (sessions, frames done, window
    seconds); each session is (system, frames it took, whether it ended
    with final_cleanup, its backend prof before the cleanup)."""
    import torch

    from sparse_gslam_tpu_torch.models.slam import SlamSystem

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    sessions = []
    done = 0
    sync()
    t0 = time.perf_counter()
    while True:
        system = SlamSystem(slam_cfg, ls_cfg, enable_backend=True,
                            device=device)
        if tracer is not None:
            tracer.session(system)
        for fr in frames:
            system.process_frame(fr)
        done += len(frames)
        ticks_prof = dict(system.backend.prof)
        if tracer is not None:
            with tracer.cleanup():
                system.final_cleanup()
        else:
            system.final_cleanup()
        sessions.append((system, len(frames), True, ticks_prof))
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return sessions, done, time.perf_counter() - t0


def end_to_end(done: int, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics: name -> (value, unit)."""
    return {"frames_per_s": (done / window_s, "frames/s"),
            "setup_s": (setup_s, "s")}


def check(snaps, work: str, name: str, limits: dict):
    """Compare every session's snapshot (compare.snapshot, with its frame
    count and whether it ended) with the reference's; returns (numbers,
    correct, frames of the sessions that failed)."""
    from . import compare
    from .reference import replay

    partial = sorted({k for _, k, ended in snaps if not ended and k > 0})
    ref = replay(work, name, partial, any(e for _, _, e in snaps))
    readings, failed = [], 0
    for snap, k, ended in snaps:
        if k == 0:
            continue
        r = compare.compare(snap, ref["end" if ended else k])
        readings.append(r)
        if not compare.judge(r, limits):
            failed += k
    numbers = compare.worst(readings)
    return numbers, compare.judge(numbers, limits), failed


def main(argv=None, device: str = "cuda") -> int:
    """One run; `device="cpu"` is for the harness's own tests, which
    drive the rest of a run without a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    from .compare import CHECKS, load_cell_file

    cell_file = load_cell_file(cell["name"])
    limits = cell_file["limits"]
    if device == "cuda":
        torch = open_card(int(cell["chips"]))
    else:
        import torch
    kind = (torch.cuda.get_device_name(0) if device == "cuda" else "cpu")
    smi = power_limit() if device == "cuda" else "cpu"
    work = tempfile.mkdtemp(prefix="gslam_bench_")
    try:
        slam_cfg, ls_cfg, frames = setup(config, traffic, cell, args.seed,
                                         device, work)
        tracer = None
        if args.trace:
            from .trace import Tracer

            tracer = Tracer(device)
            tracer.install()
        setup_s = time.perf_counter() - T_START
        host_before = host_reading()
        sessions, done, window_s = window(
            slam_cfg, ls_cfg, frames, args.seconds, device, tracer)
        host = host_share(host_before, host_reading(), window_s)
        extra_sessions = []
        if tracer is not None:
            from sparse_gslam_tpu_torch.models.slam import SlamSystem

            extra_sessions.append(tracer.traced_session(
                lambda: SlamSystem(slam_cfg, ls_cfg, enable_backend=True,
                                   device=device),
                frames, cell_file["trace_frames"]))
            tracer.uninstall()
        if _forbidden_found():
            return 3
        peak = (int(torch.cuda.max_memory_allocated(0))
                if device == "cuda" else 0)
        device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                       "kind": kind, "count": int(cell["chips"]),
                       "memory_peak_bytes": peak}
        result_metrics, extra = {}, {}
        ft = [t for sy, *_ in sessions for t in sy.frontend_times]
        bt = [t for sy, *_ in sessions for t in sy.backend_times]
        if args.trace:
            from . import trace

            tr = tracer.reduce()
            busy = sum(t - s for s, t in trace.busy_intervals(tr["device"]))
            device_info["busy_s"] = busy * 1e-9
            device_info["window_s"] = tr["wall_s"]
            a, b = cell_file["trace_frames"]
            ctx = {"spans": dict(tracer.spans), "launches": tracer.launches,
                   "trace": tr, "device_kind": kind, "frames": done,
                   "frontend_times": ft, "backend_times": bt,
                   "slice_frames": b - a,
                   "backend_ticks": len(bt),
                   "prof": _sum_prof(sessions)}
            for m in bench["per_layer"]:
                if cell["name"] not in m.get("workloads", [cell["name"]]):
                    continue
                v = read_metric(m["name"], ctx)
                if v is not None:
                    result_metrics[m["name"]] = {"value": v,
                                                 "unit": m["unit"]}
            if tr["device"]:
                extra["breakdown"] = trace.breakdown(tr)
            print(f"traced slice: frames [{a}, {b}) in {tr['wall_s']!r} s, "
                  f"{len(tr['device'])} device operations; timed launches "
                  + ", ".join(f"{k} {len(v)}"
                              for k, v in tracer.launches.items()),
                  file=sys.stderr)
        else:
            e2e = end_to_end(done, window_s, setup_s)
            for m in bench["end_to_end"]:
                if cell["name"] in m.get("workloads", [cell["name"]]) and (
                        m["name"] in e2e):
                    v, unit = e2e[m["name"]]
                    result_metrics[m["name"]] = {"value": v, "unit": unit}
        print(f"window: {done} frames in {window_s!r} s, sessions "
              f"{[[k, e] for _, k, e, _ in sessions]}, {len(ft)} frontend "
              f"ticks ({sum(ft)!r} s), {len(bt)} backend ticks "
              f"({sum(bt)!r} s); set-up {setup_s!r} s", file=sys.stderr)
        print(f"host over the window: {json.dumps(host)}", file=sys.stderr)
        # the program's outputs to the host, its state freed, then the
        # reference
        from .compare import snapshot

        snaps = [(snapshot(sy), k, e)
                 for sy, k, e, _ in sessions + extra_sessions]
        session_list = [[k, e] for _, k, e, _ in sessions]
        del sessions, extra_sessions, tracer
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers, correct, failed = check(snaps, work, cell["traffic"],
                                         limits)
        print(f"check took {time.perf_counter() - t_check!r} s",
              file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the last look, once the comparison and the metric readers have run
    if _forbidden_found():
        return 3
    for k in CHECKS:
        print(f"check {k}: {numbers[k]!r} (limit {limits[k]!r})",
              file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(done),
            "failed": int(failed), "metrics": result_metrics,
            "device": device_info, **extra,
            "card": smi, "sessions": session_list, "host": host,
            "checks": {k: {"value": numbers[k], "limit": limits[k]}
                       for k in CHECKS}}
    print(json.dumps(line), flush=True)
    return 0


def _forbidden_found() -> bool:
    """True, with the names on standard error, where a module that no
    run may load is loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"gslam_bench: modules loaded that no run may load: {bad}",
              file=sys.stderr)
    return bool(bad)


def _sum_prof(sessions) -> dict:
    """The backend's phase seconds over the window's ticks, the final
    cleanups left out."""
    out = {}
    for _, _, _, prof in sessions:
        for k, v in prof.items():
            out[k] = out.get(k, 0.0) + v
    return out


if __name__ == "__main__":
    raise SystemExit(main())
