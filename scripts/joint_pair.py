"""Hold the port's joint landmark + pose solve against the JAX
package's on the inputs of a real run's final joint solve.

    SLAM_DUMP_JOINT=DUMP.npz python -m sparse_gslam_tpu.runner \
        --dataset-dir <copy of a dataset whose slam.yaml sets
        final_joint: true> --dataset-name NAME
    python scripts/joint_pair.py DUMP.npz

The JAX runner writes the solver's inputs (JointGraphData's fields) to
DUMP.npz. This script runs solvers.optimize_joint_graph of both
packages on them on the CPU in float64 (the JAX package's second call
timed) with the backend's DCS phi and
iteration count, and prints one JSON line: the padded and live sizes,
the port's LM iterations, each package's seconds, chi2 before and
after, and the largest pose and landmark differences over the live
slots (m/rad).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump")
    ap.add_argument("--phi", type=float, default=10.0)
    ap.add_argument("--iterations", type=int, default=12)
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from sparse_gslam_tpu.ops import solvers as jsol
    from sparse_gslam_tpu_torch.interop import joint_graph_from_numpy
    from sparse_gslam_tpu_torch.ops import solvers as tsol

    d = np.load(args.dump)
    fields = {k: d[k] for k in jsol.JointGraphData._fields}

    port_iterations = []
    schur = tsol._joint_schur_solve

    def counted(*a, **k):
        port_iterations.append(1)
        return schur(*a, **k)

    jg = jsol.JointGraphData(**{k: jnp.asarray(v) for k, v in fields.items()})
    tg = joint_graph_from_numpy(fields, "cpu")
    # the first call compiles; the second is timed
    jsol.optimize_joint_graph(jg, args.phi, args.iterations)[1].block_until_ready()
    t0 = time.perf_counter()
    jout, jchi2 = jsol.optimize_joint_graph(jg, args.phi, args.iterations)
    jchi2.block_until_ready()
    jax_s = time.perf_counter() - t0
    tsol._joint_schur_solve = counted
    t0 = time.perf_counter()
    tout, tchi2 = tsol.optimize_joint_graph(tg, args.phi, args.iterations)
    port_s = time.perf_counter() - t0

    pv, lv = fields["pose_valid"], fields["lm_valid"]
    dp = np.asarray(jout.poses)[pv] - tout.poses.cpu().numpy()[pv]
    dp[:, 2] = (dp[:, 2] + np.pi) % (2 * np.pi) - np.pi
    dl = np.asarray(jout.lms)[lv] - tout.lms.cpu().numpy()[lv]
    dl[:, 1] = (dl[:, 1] + np.pi) % (2 * np.pi) - np.pi
    print(json.dumps({
        "dump": args.dump,
        "P": len(pv), "L": len(lv), "E": len(fields["obs_valid"]),
        "C": len(fields["clo_valid"]), "poses": int(pv.sum()),
        "lms": int(lv.sum()), "edges": int(fields["obs_valid"].sum()),
        "closures": int(fields["clo_valid"].sum()),
        "chi2_start": float(tsol.joint_graph_chi2(tg, args.phi)),
        "chi2_jax": float(jchi2), "chi2_port": float(tchi2),
        "port_iterations": len(port_iterations),
        "jax_s": jax_s, "port_s": port_s,
        "max_abs_pose_diff": float(np.abs(dp).max()),
        "max_abs_lm_diff": float(np.abs(dl).max()),
    }))


if __name__ == "__main__":
    main()
