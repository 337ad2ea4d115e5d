"""Run the JAX package and the port side by side on one world, on the
CPU, and print where and why they part.

    JAX_PLATFORMS=cpu python scripts/pair_run.py --world sim-killian \
        [--max-frames 2100] [--hlo-dump DIR]

Both SlamSystems take the same frames (the port on the CPU in
float64). After every backend tick one JSON line gives: whether the
closure lists agree (i, j, kind, active), the largest differences of
the closure edges' measurements (m/rad) and informations (relative to
each edge's largest entry), of the pose-graph vertices and of the
frontend estimates; and, for the tick's calls inside the JAX run, the
port's functions given the JAX run's own inputs:

- every scan refinement (`refine_pose_cov`, `refine_pose_cov_two_stage`):
  the largest pose and relative covariance difference to the JAX
  result;
- every pose-graph solve: the port's routed solve (dense or blocked)
  on the JAX run's graph, against the JAX result.

After the last frame both systems run final_cleanup and one more line
(frame "final_cleanup") gives the same readings; every line also
counts the active closures and names the pose-graph vertex that is
furthest apart. It stops after the first tick whose closure lists
differ. --hlo-dump
has XLA write the compiled programs to DIR and prints, at the end, the
fusions, dots and LAPACK calls of the compiled `refine_pose_cov`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", default="sim-killian")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--hlo-dump", default=None)
    return ap.parse_args()


ARGS = parse() if __name__ == "__main__" else None
if ARGS is not None and ARGS.hlo_dump:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={ARGS.hlo_dump}").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sparse_gslam_tpu.models.backend as jbackend  # noqa: E402
from sparse_gslam_tpu.io.providers import create_data_provider  # noqa: E402
from sparse_gslam_tpu.models.slam import SlamSystem as JSlamSystem  # noqa: E402
from sparse_gslam_tpu.ops import matching as jmatching  # noqa: E402
from sparse_gslam_tpu.utils.config import load_dataset_config  # noqa: E402
from sparse_gslam_tpu_torch.interop import pose_graph_from_numpy  # noqa: E402
from sparse_gslam_tpu_torch.models.slam import SlamSystem  # noqa: E402
from sparse_gslam_tpu_torch.ops import matching  # noqa: E402
from sparse_gslam_tpu_torch.utils.config import (  # noqa: E402
    load_dataset_config as t_load_dataset_config,
)
from sparse_gslam_tpu_torch.utils.se2 import wrap_angle  # noqa: E402


class Tick:
    """The largest differences found in the current tick's calls."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.refine_pose = 0.0
        self.refine_cov_rel = 0.0
        self.refines = 0
        self.solve = 0.0
        self.solves = 0


def _np(x):
    return np.asarray(x) if hasattr(x, "shape") else x


def _t(x):
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


def wrap_refine(name, tick):
    jfn, tfn = getattr(jmatching, name), getattr(matching, name)

    def wrapped(*a, **k):
        out = jfn(*a, **k)
        if not any(isinstance(x, jax.core.Tracer) for x in a):
            got = tfn(*[_t(_np(x)) for x in a], **k)
            pose = np.asarray(out[0], np.float64)
            cov = np.asarray(out[1], np.float64)
            tick.refine_pose = max(tick.refine_pose, float(np.abs(
                got[0].numpy().astype(np.float64) - pose).max()))
            tick.refine_cov_rel = max(tick.refine_cov_rel, float(
                np.abs(got[1].numpy() - cov).max() / np.abs(cov).max()))
            tick.refines += 1
        return out
    setattr(jmatching, name, wrapped)


def wrap_solve(tick, port_closer):
    jsolve = jbackend.SubmapLoopCloser._solve

    def wrapped(self, g, iterations, gnc_scale):
        out = jsolve(self, g, iterations, gnc_scale)
        fields = {k: np.asarray(v) for k, v in g._asdict().items()}
        got = port_closer()._solve(pose_graph_from_numpy(fields, "cpu"),
                                   iterations, gnc_scale)
        d = got.poses.numpy() - np.asarray(out.poses)
        d[:, 2] = wrap_angle(d[:, 2])
        tick.solve = max(tick.solve, float(np.abs(d[fields["valid"]]).max()))
        tick.solves += 1
        return out
    jbackend.SubmapLoopCloser._solve = wrapped


def keys(closer):
    return [(c.i, c.j, c.kind, c.active) for c in closer.closures]


def hlo_counts(dump_dir):
    files = glob.glob(os.path.join(
        dump_dir, "*jit_refine_pose_cov.cpu_after_optimizations.txt"))
    if not files:
        return None
    text = open(sorted(files)[0]).read()
    return {
        "fusions": len(re.findall(r"= \S+ fusion\(", text)),
        "dots": len(re.findall(r"= \S+ dot\(", text)),
        "lapack_calls": sorted(re.findall(
            r'custom_call_target="(lapack_[a-z]+)', text)),
    }


def main() -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    data = os.path.join(ROOT, "datasets", ARGS.world)
    js = JSlamSystem(*load_dataset_config(data))
    ts = SlamSystem(*t_load_dataset_config(data), device="cpu")
    tick = Tick()
    for name in ("refine_pose_cov", "refine_pose_cov_two_stage"):
        wrap_refine(name, tick)
    wrap_solve(tick, lambda: ts.backend)
    log = os.path.join(data, f"{ARGS.world}.log")
    interval = js.config.match_interval
    frames = enumerate(create_data_provider("carmen", log).frames())
    for k, fr in list(frames) + [("final_cleanup", None)]:
        if k == ARGS.max_frames:
            break
        if fr is None:
            js.final_cleanup()
            ts.final_cleanup()
        else:
            js.process_frame(fr)
            ts.process_frame(fr)
            if k % interval or not js.backend.pg_poses:
                continue
        jb, tb = js.backend, ts.backend
        same = keys(jb) == keys(tb)
        d_meas = d_info = 0.0
        if same:
            for a, b in zip(jb.closures, tb.closures):
                d_meas = max(d_meas, float(np.abs(
                    np.asarray(a.meas) - np.asarray(b.meas)).max()))
                ia = np.asarray(a.info)
                d_info = max(d_info, float(
                    np.abs(ia - np.asarray(b.info)).max() / np.abs(ia).max()))
        n = min(len(jb.pg_poses), len(tb.pg_poses))
        d_pg, at = 0.0, None
        if n:
            d = np.stack(jb.pg_poses[:n]) - np.stack(tb.pg_poses[:n])
            d[:, 2] = wrap_angle(d[:, 2])
            d_pg = float(np.abs(d).max())
            at = int(np.abs(d).max(axis=1).argmax())
        print(json.dumps({
            "frame": k, "keyframes": len(js.frontend.keyframes),
            "active_closures": [sum(c.active for c in jb.closures),
                                sum(c.active for c in tb.closures)],
            "d_pose_graph_at": at,
            "pose_graph": [len(jb.pg_poses), len(tb.pg_poses)],
            "closures": [len(jb.closures), len(tb.closures)],
            "closures_equal": same, "d_meas": d_meas, "d_info_rel": d_info,
            "d_pose_graph": d_pg,
            "d_frontend": float(np.abs(js.frontend.estimates()
                                       - ts.frontend.estimates()).max()),
            "refines": tick.refines, "refine_d_pose": tick.refine_pose,
            "refine_d_cov_rel": tick.refine_cov_rel,
            "solves": tick.solves, "solve_d_pose": tick.solve,
        }), flush=True)
        tick.reset()
        if not same:
            break
    if ARGS.hlo_dump:
        print(json.dumps({"refine_pose_cov_hlo": hlo_counts(ARGS.hlo_dump)}))


if __name__ == "__main__":
    main()
