"""Dataset driver CLI: the log_runner equivalent (src/log_runner.cpp).

Usage:
    python -m sparse_gslam_tpu_torch.runner --dataset-dir datasets/sim \\
        --dataset-name sim [--postfix -11] [--no-backend] [--eval] \\
        [--max-frames N] [--map-png map.png] [--device cuda|cpu]

Reads <dir>/slam<postfix>.yaml (+ line_extractor.yaml), replays
<dir>/<name>.log through the SLAM system, writes <dir>/<name>.result
+ .ftime/.btime/.dtime, optionally renders the global occupancy map to
a PNG, and (with --eval) computes the relations ATE against
<dir>/<name>.relations and, where <dir>/<name>.gt exists, the loop
closures' precision and recall. Port of sparse_gslam_tpu/runner.py;
its other flags are listed in ROADMAP.md as later work.
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
    or a .relations file) and the map as (probs, origin, resolution)
    (None without --map-png)."""

    system: object
    n_frames: int
    wall_s: float
    ate: Optional[object]
    map: Optional[tuple]


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
        "--map-png", default="",
        help="write a global occupancy map PNG after the run",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="device for the solvers, the grids and the matcher",
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
                        device=args.device)
    system.timing = TimingWriter(prefix)

    t0 = time.time()
    n = 0
    for frame in provider.frames():
        system.process_frame(frame)
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
        if n % 500 == 0:
            print(
                f"frame {n} kf={len(system.frontend.keyframes)} "
                f"lms={len(system.frontend.landmarks)} "
                f"({time.time() - t0:.1f}s)",
                flush=True,
            )
    system.final_cleanup()
    wall = time.time() - t0
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

    grid = None
    if args.map_png:
        import numpy as np

        from .eval.maps import render_map, save_map_png

        est = system.frontend.estimates()
        if backend is not None and backend.pose_count > 0:
            pg = backend.pose_estimates()
            est = np.concatenate([pg, est[len(pg):]])
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
    return RunResult(system, n, wall, ate, grid)


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
