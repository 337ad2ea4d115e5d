"""Dataset driver CLI: the log_runner equivalent (src/log_runner.cpp).

Usage:
    python -m sparse_gslam_tpu_torch.runner --dataset-dir datasets/sim \\
        --dataset-name sim [--postfix -11] [--no-backend] [--eval] \\
        [--max-frames N] [--map-png map.png] [--device cuda|cpu] \\
        [--realtime [--rate R]] [--map-every N] [--live-view HZ] \\
        [--checkpoint c.npz] [--resume c.npz] [--profile DIR] \\
        [--accel-branch]

Reads <dir>/slam<postfix>.yaml (+ line_extractor.yaml), replays
<dir>/<name>.log through the SLAM system, writes <dir>/<name>.result
+ .ftime/.btime/.dtime, optionally renders the global occupancy map to
a PNG, and (with --eval) computes the relations ATE against
<dir>/<name>.relations and, where <dir>/<name>.gt exists, the loop
closures' precision and recall. Port of sparse_gslam_tpu/runner.py
without its TPU-only flags (--prewarm, --platform): --device takes
their place, and --accel-branch selects the backend branch that the JAX
package picks by platform.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import NamedTuple, Optional


class RunResult(NamedTuple):
    """What one run produced, for callers that drive the runner from
    Python (chip_smoke.py): the system with its final state, the frame
    count, the frame loop's wall seconds, the ATE (None without --eval
    or a .relations file), the map as (probs, origin, resolution)
    (None without --map-png) and the LiveVisualizer (None without
    --live-view)."""

    system: object
    n_frames: int
    wall_s: float
    ate: Optional[object]
    map: Optional[tuple]
    live: Optional[object] = None


def _map_estimates(system):
    """Keyframe poses for a map: the pose graph's where it has them, the
    landmark graph's after."""
    import numpy as np

    est = system.frontend.estimates()
    if system.backend is not None and system.backend.pose_count > 0:
        pg = system.backend.pose_estimates()
        est = np.concatenate([pg, est[len(pg):]])
    return est


def _dump_periodic_map(system, slam_cfg, args, prefix, n):
    """Periodic occupancy-map dump (--map-every): the live-rate
    visualization surface (reference visualizer.cpp:287-384 publishes
    occupancy maps from a background thread at visualize_rate)."""
    from .eval.maps import render_map, save_map_png

    est = _map_estimates(system)
    if len(est) < 2:
        return
    probs, origin, res = render_map(
        system.frontend.keyframes, est, resolution=slam_cfg.map_resolution,
        device=args.device,
    )
    base = args.map_png or (prefix + "-map.png")
    path = base.rsplit(".", 1)[0] + f"-{n:05d}.png"
    save_map_png(path, probs, est, origin, resolution=res)


def run(argv=None) -> RunResult:
    """Parse the command line, run it, print the summary lines."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--dataset-name", required=True)
    ap.add_argument("--postfix", default="")
    ap.add_argument("--no-backend", action="store_true",
                    help="frontend only")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument(
        "--realtime", action="store_true",
        help="simulated-realtime mode: frontend paced by timestamps, "
        "backend free-running on its own thread (log_runner.cpp:214-239)",
    )
    ap.add_argument("--rate", type=float, default=1.0)
    ap.add_argument(
        "--map-png", default="",
        help="write a global occupancy map PNG after the run",
    )
    ap.add_argument(
        "--map-every", type=int, default=0,
        help="also dump a map PNG every N frames during the run "
        "(<name>-map-NNNNN.png next to --map-png, or in the dataset "
        "dir): the periodic-visualization analog of the reference's "
        "live rviz occupancy topics (visualizer.cpp:287-384)",
    )
    ap.add_argument(
        "--live-view", type=float, default=0.0, metavar="HZ",
        help="render live maps at this rate on a background thread "
        "while the run progresses (<name>_live_{lm,pg}.png + "
        "_live_status.json, atomically replaced): the runtime "
        "equivalent of the reference's visualize_rate rviz surface "
        "(visualizer.cpp:425-441)",
    )
    ap.add_argument("--checkpoint", default="", help="save state here")
    ap.add_argument("--resume", default="", help="load state first")
    ap.add_argument(
        "--profile", default="",
        help="write a torch.profiler trace of the run (CPU and, on the "
        "card, CUDA activity) to this directory as a Chrome trace, "
        "with the system's recorder on (the program's slam.* spans in "
        "the trace), and print the recorder's counters",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="device for the solvers, the grids and the matcher",
    )
    ap.add_argument(
        "--accel-branch", action="store_true",
        help="take the JAX package's accelerator branch, which it picks "
        "by jax.default_backend() != 'cpu' (sparse_gslam_tpu/models/"
        "backend.py: the rotation count frozen at range_max in "
        "_match_snapshot, the fused one-call matcher in _match_search "
        "and rematch_all, the device pin batches of _kf_edges_device), "
        "on --device; its reference on the CPU is "
        "scripts/jax_accel_branch.py. Off: the CPU branch on every "
        "device",
    )
    args = ap.parse_args(argv)

    from .io.providers import create_data_provider
    from .io.result_writer import TimingWriter
    from .models.slam import SlamSystem, steady_stats
    from .utils.config import load_dataset_config

    slam_cfg, ls_cfg = load_dataset_config(args.dataset_dir, args.postfix)
    prefix = os.path.join(args.dataset_dir, args.dataset_name)
    provider = create_data_provider(slam_cfg.data_provider, prefix + ".log")

    system = SlamSystem(slam_cfg, ls_cfg, enable_backend=not args.no_backend,
                        device=args.device, accel_branch=args.accel_branch)
    system.timing = TimingWriter(prefix)
    system.rec.enabled = bool(args.profile)
    if args.resume:
        from .utils.checkpoint import load_checkpoint

        load_checkpoint(args.resume, system)
        print(f"resumed from {args.resume}")

    profiler = _start_profiler(args.profile, args.device)
    live = None
    if args.live_view > 0:
        from .eval.live_view import LiveVisualizer

        live = LiveVisualizer(system, prefix, rate=args.live_view)
        live.start()

    t0 = time.time()
    n = 0
    if args.realtime:
        frames = list(provider.frames())
        if args.max_frames:
            frames = frames[: args.max_frames]
        n = len(frames)
        if args.map_every:
            # periodic dumps interleave with the paced frontend; take
            # the system lock so the free-running backend thread can't
            # move the graph mid-render
            def paced(frames=frames):
                for k, fr in enumerate(frames):
                    yield fr
                    if (k + 1) % args.map_every == 0:
                        with system.lock:
                            _dump_periodic_map(
                                system, slam_cfg, args, prefix, k + 1
                            )

            system.run_realtime(paced(), rate=args.rate)
        else:
            system.run_realtime(frames, rate=args.rate)
        if live is not None:
            live.stop(final=True)
    else:
        for frame in provider.frames():
            if live is not None:
                # the live thread snapshots under system.lock; pair it
                # here (the realtime path already locks its ticks)
                with system.lock:
                    system.process_frame(frame)
            else:
                system.process_frame(frame)
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
            if args.map_every and n % args.map_every == 0:
                _dump_periodic_map(system, slam_cfg, args, prefix, n)
            if n % 500 == 0:
                print(
                    f"frame {n} kf={len(system.frontend.keyframes)} "
                    f"lms={len(system.frontend.landmarks)} "
                    f"({time.time() - t0:.1f}s)",
                    flush=True,
                )
        if live is not None:
            # quiesce the render thread before cleanup mutates the
            # graphs without the lock; a final frame renders below
            live.stop(final=False)
        system.final_cleanup()
        if live is not None:
            live.render_once()
    wall = time.time() - t0
    if profiler is not None:
        profiler.stop()
        print(f"profiler trace written to {args.profile}")
    if args.checkpoint:
        from .utils.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, system)
    system.timing.close()
    system.write_result(prefix + ".result")
    nkf = len(system.frontend.keyframes)
    print(
        f"done: {n} frames, {nkf} keyframes, "
        f"{len(system.frontend.landmarks)} landmarks, "
        f"{system.frontend.rejected_ticks} rejected ticks, "
        f"{wall:.1f}s wall ({n / max(wall, 1e-9):.1f} fps)"
    )
    backend = system.backend
    if backend is not None:
        print(
            f"backend: {backend.submap_count} submaps, "
            f"{backend.closure_count} closures "
            f"({backend.false_closure_count} pruned)"
        )
    fm, fx, fn_ = steady_stats(system.frontend_times)
    bm, bx, bn_ = steady_stats(system.backend_times)
    # same line as the JAX runner; the port has no compile phase
    print(
        f"steady-state: frontend mean {fm * 1e3:.1f} ms / max "
        f"{fx * 1e3:.1f} ms (n={fn_}), backend mean {bm * 1e3:.1f} ms "
        f"/ max {bx * 1e3:.1f} ms (n={bn_}); compile total 0.0 s"
    )
    if args.profile:
        from .eval.profile import refine_counts, shape_counts

        counts = system.rec.counts
        print("counters: " + ", ".join(
            f"{k} {v}" for k, v in sorted(counts.items())
            if k.startswith(("lm.", "pg.", "pins.", "pin_window."))))
        print("lm shapes (P, L, E) x solves: " + ", ".join(
            f"({p}, {l}, {e}) x {n}" for p, l, e, n in shape_counts(
                system.rec)))
        print("refine.n (caller, N) x launches: " + ", ".join(
            f"({c}, {nb}) x {n}" for c, nb, n in refine_counts(system.rec)))
    if args.realtime:
        rt = system.realtime
        print(
            f"realtime: rate {rt.rate:g}, {rt.frames} frames, {rt.late} "
            f"late, max lag {max(rt.lags, default=0.0):.3f} s, "
            f"{len(rt.backend_ticks)} backend ticks"
        )
    if live is not None:
        print(f"live view: {live.renders} renders, {live.errors} render "
              f"errors")

    grid = None
    if args.map_png:
        from .eval.maps import render_map, save_map_png

        est = _map_estimates(system)
        grid = render_map(
            system.frontend.keyframes, est,
            resolution=slam_cfg.map_resolution, device=args.device,
        )
        probs, origin, res = grid
        save_map_png(args.map_png, probs, est, origin, resolution=res)
        print(f"map written to {args.map_png}")

    ate = None
    if args.eval:
        from .eval.relations import evaluate_files

        rel = prefix + ".relations"
        if os.path.exists(rel):
            ate = evaluate_files(prefix + ".result", rel)
            print(ate)
        else:
            print(f"no relations file at {rel}; skipping eval")
        gt_path = prefix + ".gt"
        if os.path.exists(gt_path) and backend is not None and (
            backend.closures
        ):
            _print_closure_eval(system, gt_path, slam_cfg)
    return RunResult(system, n, wall, ate, grid, live)


def _start_profiler(directory, device):
    """A started torch.profiler run that writes a Chrome trace to
    `directory` when stopped (CUDA activity too on the card), or None
    without a directory. The counterpart of the JAX runner's
    jax.profiler trace."""
    if not directory:
        return None
    from torch import profiler

    activities = [profiler.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(profiler.ProfilerActivity.CUDA)
    prof = profiler.profile(
        activities=activities,
        on_trace_ready=profiler.tensorboard_trace_handler(directory),
    )
    prof.start()
    return prof


def _print_closure_eval(system, gt_path, slam_cfg):
    """The `local refinement edges:`, `consistency-suppressed closures:`
    and `closures:` lines of the JAX runner (runner.py:274-324)."""
    from .eval.closures import closure_pr, load_gt

    backend = system.backend
    gt_times, gt_poses = load_gt(gt_path)
    kfs = system.frontend.keyframes
    loops = [
        c for c in backend.closures
        if c.active and not c.suppressed and c.kind == "loop"
    ]
    triples = [
        (kfs[c.i].odom_times[0], kfs[c.j].odom_times[0], c.meas)
        for c in loops
    ]
    if backend.local_edge_count:
        print(f"local refinement edges: {backend.local_edge_count}")
    n_sup = backend.suppressed_closure_count
    if n_sup:
        print(f"consistency-suppressed closures: {n_sup}")
    pr = closure_pr(
        triples, gt_times, gt_poses,
        # a closure across the full candidate-gate distance is
        # legitimate; what makes one false is a wrong MEASUREMENT
        match_radius=max(6.0, slam_cfg.max_match_distance + 2.0),
        infos=[c.info for c in loops],
    )
    print(
        f"closures: precision {pr['precision']:.2f} "
        f"({pr['n_true']}/{pr['n_closures']} true), "
        f"ridge-aware precision {pr['precision_ridge']:.2f} "
        f"({pr['n_true_ridge']}/{pr['n_closures']}), "
        f"recall {pr['recall']:.2f} "
        f"({pr['n_detected']}/{pr['n_segments']} revisit "
        f"segments detected)"
    )


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
