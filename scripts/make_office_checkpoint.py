"""Write the JAX package's checkpoint of sim-office at frame 330, and its
continuation, for the port's resume check (chip_smoke.py `resume`;
tests/test_torch_checkpoint.py).

    JAX_PLATFORMS=cpu python scripts/make_office_checkpoint.py

Runs the JAX package's SlamSystem (backend on, float64 on the CPU, as
its runner runs) over the first CUT frames of datasets/sim-office and
saves its checkpoint (sparse_gslam_tpu/utils/checkpoint.py) to
sparse_gslam_tpu_torch/data/sim-office-ckpt330.npz. Then loads that file
into a fresh JAX system, sets the runner fields the checkpoint leaves
out (frame_idx, deltas, zero_pose, last_pose, mc._cloud_odom) by hand,
as tests/test_checkpoint_and_system.py does, and continues CONTINUE
frames. It also saves the loaded state again, loads that into a third
system and continues it the same frames: loading adds a chain edge to
those saved (ROADMAP.md, section 3), so this second continuation's pose
graph differs from the first. The sidecar
sparse_gslam_tpu_torch/data/sim-office-ckpt330-run.npz holds those
runner fields and both continuations' keyframe estimates, pose-graph
estimates and loop-closure and submap counts. The machine with the card
has no jax, which is why both files are committed. About a minute.
"""
from __future__ import annotations

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from sparse_gslam_tpu.io.providers import create_data_provider  # noqa: E402
from sparse_gslam_tpu.models.slam import SlamSystem  # noqa: E402
from sparse_gslam_tpu.utils.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)
from sparse_gslam_tpu.utils.config import load_dataset_config  # noqa: E402

DATASET = os.path.join(ROOT, "datasets", "sim-office")
DATA = os.path.join(ROOT, "sparse_gslam_tpu_torch", "data")
CKPT = os.path.join(DATA, "sim-office-ckpt330.npz")
RUN = os.path.join(DATA, "sim-office-ckpt330-run.npz")
CUT = 330
CONTINUE = 60


def main() -> None:
    frames = list(create_data_provider(
        "carmen", os.path.join(DATASET, "sim-office.log")).frames())
    first = SlamSystem(*load_dataset_config(DATASET))
    for fr in frames[:CUT]:
        first.process_frame(fr)
    save_checkpoint(CKPT, first)

    def resumed(path):
        s = SlamSystem(*load_dataset_config(DATASET))
        load_checkpoint(path, s)
        s.frame_idx = first.frame_idx
        s.deltas = list(first.deltas)
        s.zero_pose = first.zero_pose.copy()
        s.last_pose = first.last_pose.copy()
        s.mc._cloud_odom = first.mc._cloud_odom.copy()
        return s

    system = resumed(CKPT)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(os.path.join(tmp, "again.npz"), system)
        again = resumed(os.path.join(tmp, "again.npz"))
    for fr in frames[CUT:CUT + CONTINUE]:
        system.process_frame(fr)
        again.process_frame(fr)
    np.savez_compressed(
        RUN, cut=CUT, continue_frames=CONTINUE, frame_idx=first.frame_idx,
        deltas=np.asarray(first.deltas), zero_pose=first.zero_pose,
        last_pose=first.last_pose, cloud_odom=first.mc._cloud_odom,
        estimates=system.frontend.estimates(),
        pg_estimates=system.backend.pose_estimates(),
        closures=system.backend.closure_count,
        submaps=system.backend.submap_count,
        second_estimates=again.frontend.estimates(),
        second_pg_estimates=again.backend.pose_estimates(),
        second_closures=again.backend.closure_count,
        second_submaps=again.backend.submap_count,
    )
    print(f"{CKPT}: {len(first.frontend.keyframes)} keyframes, "
          f"{first.backend.submap_count} submaps; continued {CONTINUE} "
          f"frames: {len(system.frontend.keyframes)} keyframes, "
          f"{system.backend.submap_count} submaps, "
          f"{system.backend.closure_count} loop closures")


if __name__ == "__main__":
    main()
