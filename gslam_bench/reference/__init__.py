"""The plain reference: a frozen copy of the CPU path of the port
(sparse_gslam_tpu_torch, commit 932b323: models/{slam,frontend,backend,
range_data}, ops/{grid,matching,refine_exact,solvers,lines,multicloud,
line_geometry}, utils/, interop), cut to what the cells' configurations
reach. It imports numpy and torch only, runs on the CPU with the plain
insertion and refinement in place of the two CUDA kernels, and parses
the log in Python. Held against it, a run shows that the card computes
what this CPU path computes. The CPU path itself is held to the JAX
package's recorded CPU runs of the committed stand-in logs, with which
it shares no code (gslam_bench/witness.py, jax_runs/).

`replay` runs one session of the engine over a log and returns
compare.snapshot's record at the frames asked for and after the final
cleanup.
"""
from __future__ import annotations

import os


def replay(dataset_dir: str, log_name: str, stops, cleanup: bool) -> dict:
    """Snapshots of one session over <dataset_dir>/<log_name>.log, read
    after each frame count in `stops` and, with `cleanup`, after the
    whole log and final_cleanup (key "end")."""
    from ..compare import snapshot
    from .io.providers import carmen_frames
    from .models.slam import SlamSystem
    from .utils.config import load_dataset_config

    cfg, ls = load_dataset_config(dataset_dir)
    system = SlamSystem(cfg, ls, enable_backend=True, device="cpu")
    stops = set(stops)
    last = max(stops, default=0)
    out = {}
    for k, frame in enumerate(carmen_frames(
            os.path.join(dataset_dir, log_name + ".log"))):
        if not cleanup and k >= last:
            break
        system.process_frame(frame)
        if k + 1 in stops:
            out[k + 1] = snapshot(system)
    if cleanup:
        system.final_cleanup()
        out["end"] = snapshot(system)
    return out
