"""Dataset driver CLI: the log_runner equivalent (src/log_runner.cpp).

Usage:
    python -m sparse_gslam_tpu_torch.runner --dataset-dir datasets/sim \\
        --dataset-name sim --no-backend [--postfix -11] [--eval] \\
        [--max-frames N] [--map-png map.png] [--device cuda|cpu]

Reads <dir>/slam<postfix>.yaml (+ line_extractor.yaml), replays
<dir>/<name>.log through the SLAM system, writes <dir>/<name>.result
+ .ftime/.btime/.dtime, optionally renders the global occupancy map to
a PNG, and (with --eval) computes the relations ATE against
<dir>/<name>.relations. Port of sparse_gslam_tpu/runner.py for the
frontend-only configuration (--no-backend); the backend and the
JAX-only flags are listed in ROADMAP.md as later work.
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
    ap.add_argument(
        "--no-backend", action="store_true",
        help="frontend only (required: the backend is not ported yet)",
    )
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument(
        "--map-png", default="",
        help="write a global occupancy map PNG after the run",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="device for the LM solve and the map insertion",
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
    fm, fx, fn_ = steady_stats(system.frontend_times)
    # same line as the JAX runner; the port has no backend yet and no
    # compile phase
    print(
        f"steady-state: frontend mean {fm * 1e3:.1f} ms / max "
        f"{fx * 1e3:.1f} ms (n={fn_}), backend mean 0.0 ms "
        f"/ max 0.0 ms (n=0); compile total 0.0 s"
    )

    grid = None
    if args.map_png:
        from .eval.maps import render_map, save_map_png

        est = system.frontend.estimates()
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
    return RunResult(system, n, wall, ate, grid)


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
