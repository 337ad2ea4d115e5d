#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparse_gslam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out OUT] [--all-worlds]

OUT (default smoke_out/ beside this script, gitignored) receives the
files too long for standard output, and every JSON line in
OUT/phases.jsonl. Phases, each printed as one JSON
line; any failure fails the script (the full runs all run first, and
their failures fail it after the kernels line):

1. device  -- the card's name and count, and nvidia-smi's name and
   power limit (a raw line of its own as well). Fails without CUDA.
2. build   -- compiles both kernels with nvcc (sm_90a), started
   together: csrc/insert_rays.cu and csrc/refine_pose.cu (with
   --fmad=false), and the refinement's host build
   (csrc/refine_pose_host.cpp, g++); prints the seconds and the
   -Xptxas -v reports.
3. kernel  -- the CUDA insertion kernel against its plain torch twin on
   the card, at every tile size it is built for, on seeded cases from
   the test sizes up to the largest map the code allows (G=2048,
   S_pad=4096), the backend's submap grids, rays on tile borders and a
   grid edge no tile divides; torch.equal is required.
4. refine  -- the refinement kernel: the header's sinf/cosf on the
   card against the host C library's for every float32 of |theta| <=
   4 pi, then seeded cases (a room and a corridor whose J^T J is
   singular along it, every N the callers pad to from 256 to 8192,
   grids at 0.1 m (G=320) and 0.05 m (G=576), one stage, two stages
   and the pose alone), each one launch and torch.equal to the plain
   version on pose, covariance and probabilities, with its time, its
   bound, its serial-chain latency and the GN steps its stages ran;
   and a launch at N = 16384 refused.
5. main    -- the frontend-only runner on a temporary copy of
   datasets/sim-office on cuda (--no-backend --eval --map-png): the
   kernel must have launched, the ATE line and the counts must equal
   the float64 CPU JAX reference, the .result must match the committed
   reference (sparse_gslam_tpu_torch/data/sim-office-nobackend.result),
   and the map must equal the plain twin's on the same inputs; then
   every insertion case's time beside its bound and the first
   version's time (PERF.md).
6. backend -- the full runner (backend on: submaps, matcher, pins,
   chain edges, DCS pose graph; --eval --map-png) on sim-office on cuda
   under SLAM_LOG_MATCHES=1. Every insertion and every refinement of
   the run is recorded and replayed through its plain version
   (torch.equal each); the insertion launches must be 105 (52 in
   precompute, 52 in rebuild_grids, 1 for the map) and the refinement
   launches one per refinement. compare_run holds the output against
   the JAX CPU run's (WORLDS): the counts and the
   `backend:`/`closures:` lines equal, the decision lines (written to
   OUT/sim-office.decisions.log) equal to its log
   (sparse_gslam_tpu_torch/data/sim-office-full.decisions), the ATE
   line equal, and the .result within FULL_RESULT_ATOL of
   sparse_gslam_tpu_torch/data/sim-office-full.result.
7. refine_map -- as phase 6 on a copy of sim-office whose slam.yaml
   sets final_refine_rounds: 1 (Backend.refine_map in final_cleanup),
   held in full against data/sim-office-refine1.*.
8. beams60 -- as phase 6 on a copy of sim-office whose slam.yaml reads
   60 beams (scan_size: 60, multicloud_size: 960: the paper's upper
   beam count), whose queries the callers pad up to N = 4096; held in
   full against data/sim-office-beams60.*, with the refinement
   launches by N.
8a. beams4 -- as phase 8 at 4 beams (scan_size: 4, multicloud_size: 64:
   the paper's lowest beam count, eval/sweep.py's window), held in full
   against data/sim-office-beams4.* (scripts/jax_beam_runs.py).
9. joint  -- as phase 6 on a copy of sim-office whose slam.yaml sets
   final_joint: true (final_cleanup ends with the joint landmark + pose
   solve, Backend.joint_solve), held in full against
   data/sim-office-joint.*, with the joint solves' seconds, sizes and
   LM iterations and the final cleanup's seconds.
10. marginal -- as phase 6 with chain_info_mode: marginal (chain edges
   carry Frontend.relative_chain_info), held in full against
   data/sim-office-marginal.*.
10a. accel -- as phase 6 with the runner's --accel-branch (the JAX
   package's accelerator branch: the fused matcher on cached spectra,
   the device pin batches), held in full against
   data/sim-office-accel.* (the JAX run: scripts/jax_accel_branch.py),
   with the fused matcher's queries and calls (pages); then one line,
   accel_split, with its backend split (match_search, match_correlate,
   kf_stack, kf_window, kf_accept, match_apply, final cleanup, frame
   loop) beside phase 6's.
10b. fused -- fused_match, match_candidates_fused (18 candidates: two
   chunks; at K = 256 and, to page, at FUSED_PAGE_K) and pin_eval_batch
   (8 pins, 6 live) on seeded walls at sim-office's sizes, on the card
   against the same calls through the port on the host CPU (score,
   bounds and covariance tolerances FUSED_*, PIN_WCOV_ATOL; pose,
   candidate, pins' argmax and refinement equal), with each call's ms
   on the card and the fused_match calls per query.
11. realtime -- sim-office's first REALTIME_FRAMES frames through the
   runner's simulated-realtime mode (--realtime --rate 2 --map-every 100
   --live-view 2 --max-frames REALTIME_FRAMES: the frontend
   paced at twice the log's 5 Hz, the backend thread and the live-view
   thread each on a CUDA stream of its own); every insertion and
   refinement of the backend and main threads replayed torch.equal,
   and LIVE_VIEW_REPLAYS of the live view's map renders; the frontend tick
   (mean, p99, max) beside the batch run's of phase 6, late frames,
   backend ticks, the `backend:`/`closures:`/ATE lines (reported, not
   held: the run is not deterministic), launches by thread, live-view
   renders and render errors. Fails on a thread's exception, a render
   error, a broken invariant or a frame not processed.
12. resume -- the JAX package's checkpoint of sim-office at frame 330
   (data/sim-office-ckpt330.npz, scripts/make_office_checkpoint.py)
   loaded on the card (grids rebuilt by the kernel, each insertion
   torch.equal), continued 60 frames against the JAX continuation
   (RESUME_ATOL); saved by the port, loaded and continued again, the
   same.
13. blocked -- the keyframe-partitioned pose-graph solver on the card on
   synthetic chains of 2k and 16k poses (BLOCKED_CASES), against the
   float64 C++ solver on the host at the same iteration count and, at
   2k, against the dense solver on the card; GN iterations/s of both.
13a. mesh -- the multi-device routes on the card (phase_mesh): the
   sharded pose-graph solver on in-process meshes of 2 and 4 shards and
   through a one-rank NCCL group, against the blocked solver and the C++
   solver at the 2k chain, with GN iterations/s; a two-process NCCL run
   where the machine has two or more cards (else a line saying it waits
   for one); the sharded candidate search against the pruned matcher at
   sim-office's sizes; graft_entry.dryrun_multichip.
14. joint_solver -- optimize_joint_graph on the card on seeded graphs at
   sim-office's and sim-killian's joint-solve sizes (JOINT_CASES; P =
   512 and 2048 padded poses), against the same solve on the CPU
   (JOINT_ATOL, JOINT_CHI2_RTOL, the same LM iterations); ms per
   iteration and per solve.
15. killian -- the full runner on sim-killian (2626 frames, a pose graph
   padded to 2048) on cuda, as phase 6, with every pose-graph solve
   recorded: from dist_solver_min_poses padded poses up each must take
   the blocked solver and agree with the C++ solver on its graph; held
   in full but for the two printed numbers WORLDS exempts.
16. world  -- with --all-worlds, sim-loops and sim-corridor as phase 6,
   sim-office with algorithm: smf and algorithm: hough (phases smf
   and hough, held against data/sim-office-{smf,hough}.*),
   sim-killian in realtime at rate 1.5 (as phase 11), the 60-beam
   sim-office with --accel-branch (beams60_accel, held against
   data/sim-office-beams60-accel.*; its accel_split beside phase 8's),
   the sweep's other points (beams6, beams8 held in full against
   data/sim-office-beams{6,8}.*; beams4_accel, the 4-beam run with
   --accel-branch, its parity reported as beams60_accel's), and
   mesh_office: sim-office with the backend's mesh and match_mesh set to
   2-shard meshes on the card (every solve sharded, every candidate
   search fanned out), held in full against data/sim-office-mesh.* (the
   JAX run with 2-device meshes, scripts/jax_mesh_run.py).
17. kernels -- one line per hand-written kernel: launches summed over
   every path's run (launches_by_path has each, counted from 0 before
   it), error against the plain version, and its time, the plain
   version's time and the least time the card could take, summed over
   the sim-killian run's calls (timed_launches); and the refinement
   kernel's batched mode (refine_pins: the accelerator branch's device
   pin batches, one launch per batch, each replayed through the batched
   plain version), summed over the paths that launch it.

The last line is {"ok": true, "device": {...}}. Imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from sparse_gslam_tpu_torch import runner
from sparse_gslam_tpu_torch.eval import maps as maps_mod
from sparse_gslam_tpu_torch.eval.maps import map_range_data
from sparse_gslam_tpu_torch.eval.relations import load_result
from sparse_gslam_tpu_torch.eval.synthetic_graphs import (
    make_chain_graph,
    to_pose_graph,
)
from sparse_gslam_tpu_torch.interop import joint_graph_from_numpy
from sparse_gslam_tpu_torch.io.native import posegraph_gn_native
from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
from sparse_gslam_tpu_torch.models.frontend import Frontend
from sparse_gslam_tpu_torch.models.slam import SlamSystem
from sparse_gslam_tpu_torch.ops import grid as grid_mod
from sparse_gslam_tpu_torch.ops import grid_cuda, refine_cuda
from sparse_gslam_tpu_torch.ops import matching as matching_mod
from sparse_gslam_tpu_torch.ops import refine_exact
from sparse_gslam_tpu_torch.ops import solvers as solvers_mod
from sparse_gslam_tpu_torch import graft_entry
from sparse_gslam_tpu_torch.parallel import dist_solver, multihost
from sparse_gslam_tpu_torch.ops.grid import (
    insert_rays,
    insert_rays_plain,
    precompute_pyramid,
    submap_insert_args,
)
from sparse_gslam_tpu_torch.ops.line_geometry import transform_line
from sparse_gslam_tpu_torch.utils import se2
from sparse_gslam_tpu_torch.utils.se2 import wrap_angle

REPO = os.path.dirname(os.path.abspath(__file__))
DATASET = os.path.join(REPO, "datasets", "sim-office")
DATA = os.path.join(REPO, "sparse_gslam_tpu_torch", "data")
REFERENCE_RESULT = os.path.join(DATA, "sim-office-nobackend.result")
# The JAX package's frontend-only run on this dataset, on the CPU in
# float64 (python -m sparse_gslam_tpu.runner ... --no-backend --eval)
REFERENCE_ATE = (
    "ATE trans 0.2020 +- 0.2765 m, rot 1.740 +- 1.803 deg (391 relations)"
)
REFERENCE_COUNTS = {"keyframes": 286, "landmarks": 90, "rejected_ticks": 0}
# The JAX package's full runs (backend on) on the CPU in float64
# (SLAM_LOG_MATCHES=1 python -m sparse_gslam_tpu.runner --dataset-dir
# <copy of datasets/W> --dataset-name W --eval): the printed lines, the
# counts, the .result and the [match]/[chain]/[kfpin]/[rematch] lines
# (sparse_gslam_tpu_torch/data/W-full.{result,decisions}). "launches"
# are the insertion kernel's launches by phase: two grids per submap
# in precompute, again in rebuild_grids where final_rematch is on, and
# the map. Every run is held to its launches, its bit-exact grid
# builds and, where the pose graph reaches dist_solver_min_poses, the
# blocked solver taking every such solve and agreeing with the C++
# solver on each solve's graph; and to the JAX run's output
# (compare_run): the counts, the `backend:`/`closures:` lines, the
# decision lines, the ATE line and the .result within FULL_RESULT_ATOL.
# A world with "printed_fields" lets the number that a named field
# prints on a named decision line (1-based) be one unit of its last
# printed digit apart, and holds the rest of that line. That is
# sim-killian: its 148 lines come out the same on the CPU and the card
# but for two printed numbers. Line 55 prints a HIT score one unit apart
# on the card (0.705 against 0.706: cuFFT rounds the correlation
# otherwise than XLA's FFT), and line 137 a ridge's sigma_along (1.26
# against 1.25) on both devices (PERF.md §6: the float64 LM and the FFT
# scores, not a decision).
WORLDS = {
    "sim-office": {
        "ate": "ATE trans 0.0821 +- 0.0844 m, rot 0.772 +- 0.590 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 6 closures (0 pruned)",
        "closures": "closures: precision 1.00 (6/6 true), ridge-aware "
                    "precision 1.00 (6/6), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 90,
                   "submaps": 26, "loop_closures": 6, "pruned": 0,
                   "local_edges": 15, "kf_pins": 4},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    "sim-office-refine1": {
        # datasets/sim-office with one refine_map round in final_cleanup
        "dataset": "sim-office",
        "slam_yaml": {"final_refine_rounds": "1"},
        "reference": "sim-office-refine1",
        "ate": "ATE trans 0.0975 +- 0.1018 m, rot 0.903 +- 0.726 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 6 closures (0 pruned)",
        "closures": "closures: precision 1.00 (6/6 true), ridge-aware "
                    "precision 1.00 (6/6), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 90,
                   "submaps": 26, "loop_closures": 6, "pruned": 0,
                   "local_edges": 15, "kf_pins": 4},
        # refine_map rebuilds every submap's grids once more
        "launches": {"precompute": 52, "rebuild_grids": 104, "map": 1},
    },
    "sim-office-beams60": {
        # datasets/sim-office read at 60 beams (the paper's upper count;
        # scripts/sweep.py's 16x multicloud window): 1024-4096 point
        # queries
        "dataset": "sim-office",
        "slam_yaml": {"scan_size": "60", "multicloud_size": "960"},
        "reference": "sim-office-beams60",
        "ate": "ATE trans 0.0671 +- 0.0729 m, rot 0.635 +- 0.502 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 26 closures (0 pruned)",
        "closures": "closures: precision 1.00 (26/26 true), ridge-aware "
                    "precision 1.00 (26/26), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 105,
                   "submaps": 26, "loop_closures": 26, "pruned": 0,
                   "local_edges": 28, "kf_pins": 48},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    # sim-office down the JAX package's accelerator branch (runner
    # --accel-branch; the JAX run: scripts/jax_accel_branch.py, which
    # makes jax.default_backend() answer "gpu" on the CPU): the rotation
    # count frozen at range_max, the fused matcher on cached spectra,
    # the device pin batches
    "sim-office-accel": {
        "dataset": "sim-office",
        "accel": True,
        "reference": "sim-office-accel",
        "ate": "ATE trans 0.2243 +- 0.3042 m, rot 1.793 +- 1.598 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 6 closures (1 pruned)",
        "closures": "closures: precision 1.00 (6/6 true), ridge-aware "
                    "precision 1.00 (6/6), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 90,
                   "submaps": 26, "loop_closures": 6, "pruned": 1,
                   "local_edges": 15, "kf_pins": 6},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    "sim-office-beams60-accel": {
        # the 60-beam sim-office down the accelerator branch. Its parity
        # with the JAX run is reported, not held (ROADMAP.md section
        # 3.4): the window scores behind the closure covariances and the
        # centred argmax round otherwise than the JAX program's NUDFT and
        # FFT (the pins' refinement is bit-equal), which can move a
        # printed score or a candidate across the argmax's band (H100:
        # decision line 103 apart, a re-match score printed 0.766
        # against 0.765; closures, ATE and counts equal). Held: every
        # insertion, refinement and pin batch, the launches and
        # "held_counts"
        "dataset": "sim-office",
        "accel": True,
        "parity": "reported",
        "held_counts": ("frames", "keyframes", "landmarks", "submaps"),
        "slam_yaml": {"scan_size": "60", "multicloud_size": "960"},
        "reference": "sim-office-beams60-accel",
        "ate": "ATE trans 0.0614 +- 0.0665 m, rot 0.595 +- 0.473 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 25 closures (0 pruned)",
        "closures": "closures: precision 1.00 (25/25 true), ridge-aware "
                    "precision 1.00 (25/25), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 105,
                   "submaps": 26, "loop_closures": 25, "pruned": 0,
                   "local_edges": 28, "kf_pins": 47},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    # the paper's beam sweep (eval/sweep.py; scripts/sweep.py's window
    # of 16 scans): sim-office read at 4, 6 and 8 beams, against the JAX
    # package's CPU-branch runs (scripts/jax_beam_runs.py)
    "sim-office-beams4": {
        "dataset": "sim-office",
        "slam_yaml": {"scan_size": "4", "multicloud_size": "64"},
        "reference": "sim-office-beams4",
        "ate": "ATE trans 0.2320 +- 0.2950 m, rot 1.948 +- 1.979 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 0 closures (0 pruned)",
        "closures": "closures: precision nan (0/0 true), ridge-aware "
                    "precision nan (0/0), recall 0.00 (0/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 39,
                   "submaps": 26, "loop_closures": 0, "pruned": 0,
                   "local_edges": 4, "kf_pins": 1},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    "sim-office-beams6": {
        "dataset": "sim-office",
        "slam_yaml": {"scan_size": "6", "multicloud_size": "96"},
        "reference": "sim-office-beams6",
        "ate": "ATE trans 0.1549 +- 0.1795 m, rot 1.360 +- 1.155 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 1 closures (0 pruned)",
        "closures": "closures: precision 1.00 (1/1 true), ridge-aware "
                    "precision 1.00 (1/1), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 52,
                   "submaps": 26, "loop_closures": 1, "pruned": 0,
                   "local_edges": 4, "kf_pins": 2},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    "sim-office-beams8": {
        "dataset": "sim-office",
        "slam_yaml": {"scan_size": "8", "multicloud_size": "128"},
        "reference": "sim-office-beams8",
        "ate": "ATE trans 0.1231 +- 0.1360 m, rot 1.139 +- 0.936 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 5 closures (0 pruned)",
        "closures": "closures: precision 1.00 (5/5 true), ridge-aware "
                    "precision 1.00 (5/5), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 74,
                   "submaps": 26, "loop_closures": 5, "pruned": 0,
                   "local_edges": 9, "kf_pins": 6},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    # the sweep's 4-beam point down the accelerator branch (its 60-beam
    # point is sim-office-beams60-accel), against the JAX package's run
    # of that branch (scripts/jax_accel_branch.py on the 4-beam copy);
    # parity reported as at 60 beams
    "sim-office-beams4-accel": {
        "dataset": "sim-office",
        "accel": True,
        "parity": "reported",
        "held_counts": ("frames", "keyframes", "landmarks", "submaps"),
        "slam_yaml": {"scan_size": "4", "multicloud_size": "64"},
        "reference": "sim-office-beams4-accel",
        "ate": "ATE trans 0.2320 +- 0.2950 m, rot 1.948 +- 1.979 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 0 closures (0 pruned)",
        "closures": "closures: precision nan (0/0 true), ridge-aware "
                    "precision nan (0/0), recall 0.00 (0/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 39,
                   "submaps": 26, "loop_closures": 0, "pruned": 0,
                   "local_edges": 4, "kf_pins": 1},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    # sim-office with the backend's two mesh hooks set to 2-shard meshes
    # (every pose-graph solve sharded, the candidate search fanned out),
    # against the JAX package's run with 2-device meshes on a virtual CPU
    # mesh (scripts/jax_mesh_run.py)
    "sim-office-mesh": {
        "dataset": "sim-office",
        "mesh": 2,
        "reference": "sim-office-mesh",
        "ate": "ATE trans 0.0820 +- 0.0844 m, rot 0.772 +- 0.590 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 6 closures (0 pruned)",
        "closures": "closures: precision 1.00 (6/6 true), ridge-aware "
                    "precision 1.00 (6/6), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 90,
                   "submaps": 26, "loop_closures": 6, "pruned": 0,
                   "local_edges": 15, "kf_pins": 4},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    # sim-office with one option of the JAX package's config added to
    # slam.yaml; the options are off by default because they measured
    # worse (utils/config.py), and the port reproduces them
    "sim-office-joint": {
        # final_cleanup ends with the joint landmark + pose solve
        "dataset": "sim-office",
        "slam_yaml": {"final_joint": "true"},
        "reference": "sim-office-joint",
        "ate": "ATE trans 0.0989 +- 0.1036 m, rot 0.788 +- 0.665 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 6 closures (0 pruned)",
        "closures": "closures: precision 1.00 (6/6 true), ridge-aware "
                    "precision 1.00 (6/6), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 90,
                   "submaps": 26, "loop_closures": 6, "pruned": 0,
                   "local_edges": 15, "kf_pins": 4},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
        "joint": True,
    },
    "sim-office-marginal": {
        # chain edges carry the landmark-posterior marginal information
        "dataset": "sim-office",
        "slam_yaml": {"chain_info_mode": "marginal"},
        "reference": "sim-office-marginal",
        "ate": "ATE trans 0.1382 +- 0.1524 m, rot 0.971 +- 0.778 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 5 closures (1 pruned)",
        "closures": "closures: precision 1.00 (5/5 true), ridge-aware "
                    "precision 1.00 (5/5), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 90,
                   "submaps": 26, "loop_closures": 5, "pruned": 1,
                   "local_edges": 15, "kf_pins": 3},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
        "marginal": True,
    },
    "sim-office-smf": {
        # the fuzzy split-merge line extractor (ops/lines_smf.py)
        "dataset": "sim-office",
        "slam_yaml": {"algorithm": "smf"},
        "reference": "sim-office-smf",
        "ate": "ATE trans 0.1576 +- 0.1902 m, rot 1.145 +- 0.950 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 5 closures (0 pruned)",
        "closures": "closures: precision 1.00 (5/5 true), ridge-aware "
                    "precision 1.00 (5/5), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 63,
                   "submaps": 26, "loop_closures": 5, "pruned": 0,
                   "local_edges": 18, "kf_pins": 6},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    "sim-office-hough": {
        # the Hough-transform line extractor (ops/lines_hough.py)
        "dataset": "sim-office",
        "slam_yaml": {"algorithm": "hough"},
        "reference": "sim-office-hough",
        "ate": "ATE trans 0.1441 +- 0.1762 m, rot 1.247 +- 1.021 deg "
               "(391 relations)",
        "backend": "backend: 26 submaps, 5 closures (1 pruned)",
        "closures": "closures: precision 1.00 (5/5 true), ridge-aware "
                    "precision 1.00 (5/5), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 663, "keyframes": 286, "landmarks": 37,
                   "submaps": 26, "loop_closures": 5, "pruned": 1,
                   "local_edges": 14, "kf_pins": 12},
        "launches": {"precompute": 52, "rebuild_grids": 52, "map": 1},
    },
    "sim-killian": {
        "ate": "ATE trans 0.1862 +- 0.2625 m, rot 0.648 +- 0.573 deg "
               "(1963 relations)",
        "backend": "backend: 105 submaps, 24 closures (0 pruned)",
        "closures": "closures: precision 0.83 (20/24 true), ridge-aware "
                    "precision 1.00 (24/24), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 2626, "keyframes": 1262, "landmarks": 256,
                   "submaps": 105, "loop_closures": 24, "pruned": 0,
                   "local_edges": 64, "kf_pins": 7},
        "launches": {"precompute": 210, "map": 1},
        "printed_fields": {55: "score", 137: "sigma_along"},
    },
    "sim-loops": {
        "ate": "ATE trans 0.1286 +- 0.1257 m, rot 1.049 +- 0.788 deg "
               "(667 relations)",
        "backend": "backend: 40 submaps, 25 closures (10 pruned)",
        "closures": "closures: precision 1.00 (25/25 true), ridge-aware "
                    "precision 1.00 (25/25), recall 1.00 (2/2 revisit "
                    "segments detected)",
        "counts": {"frames": 1008, "keyframes": 437, "landmarks": 132,
                   "submaps": 40, "loop_closures": 25, "pruned": 10,
                   "local_edges": 25, "kf_pins": 0},
        "launches": {"precompute": 80, "rebuild_grids": 80, "map": 1},
    },
    "sim-corridor": {
        "ate": "ATE trans 0.1400 +- 0.1751 m, rot 0.576 +- 0.478 deg "
               "(347 relations)",
        "backend": "backend: 24 submaps, 3 closures (0 pruned)",
        "closures": "closures: precision 1.00 (3/3 true), ridge-aware "
                    "precision 1.00 (3/3), recall 1.00 (1/1 revisit "
                    "segments detected)",
        "counts": {"frames": 608, "keyframes": 297, "landmarks": 29,
                   "submaps": 24, "loop_closures": 3, "pruned": 0,
                   "local_edges": 1, "kf_pins": 0},
        "launches": {"precompute": 48, "rebuild_grids": 48, "map": 1},
    },
}
# .result of a full run against the JAX CPU run's (m/rad): the closures'
# window covariances come from FFT scores, which round otherwise on the
# CPU (pocketfft) and the card (cuFFT) than in XLA, and the pose graph
# spreads their ~1e-7 relative differences over the trajectory (up to
# 1.72e-4 m on sim-killian on both devices, 1e-6 on sim-loops, 0 on
# the other worlds, the 6-decimal file format included)
FULL_RESULT_ATOL = 1e-3
# the mesh phase: in-process shard counts; the sharded solver against
# the blocked one on the card in float64 (the same steps summed in
# another order; measured 0 on the CPU); the sharded candidate search
# against the pruned matcher (as tests/test_grid_matching.py holds the
# JAX package's pair: cuFFT batches the rotations otherwise); the shard
# counts of graft_entry.dryrun_multichip (at 4 its 24 GNC iterations
# leave the sharded and dense solves 0.024-0.028 m apart in both
# packages, above its own 1e-3: ROADMAP section 3)
MESH_SHARDS = (2, 4)
MESH_MATCH_SHARDS = (2,)
MESH_BLOCKED_ATOL = 1e-10
MESH_MATCH_SCORE_ATOL = 1e-5
MESH_MATCH_POSE_ATOL = 1e-5
MESH_MATCH_COV_ATOL = 1e-6
MESH_DRYRUNS = (2, 8)
# the blocked solver phase: make_chain_graph sizes (n poses padded to N,
# C closures, blocks of 128), GN iterations (converged from drift 0.005,
# so the comparisons hold fixpoints, not iterates in flight), and the
# tolerances (m/rad) against the float64 C++ solver at the same count
# and against the dense solver run to its own fixpoint (its 1e-6 ridge
# leaves a 2k chain unconverged after 40 iterations)
BLOCKED_CASES = ((2000, 2048, 64), (16000, 16384, 256))
BLOCKED_ITERS = 40
DENSE_ITERS = 120
BLOCKED_NATIVE_ATOL = 1e-8
BLOCKED_DENSE_ATOL = 1e-8
# the joint_solver phase: seeded joint graphs at the sizes of the
# final joint solve of sim-office (P = 512 padded poses) and of
# sim-killian (P = 2048), their live counts read from the JAX package's
# CPU runs with final_joint: true (SLAM_DUMP_JOINT): poses, landmarks,
# observation edges and closure edges, each live and padded
JOINT_CASES = {
    "office": dict(n=286, P=512, n_lms=90, L=128, e_live=745, E=1024,
                   c_live=25, C=32),
    "killian": dict(n=1262, P=2048, n_lms=256, L=256, e_live=2981,
                    E=4096, c_live=95, C=128),
}
# the card's joint solve against the port's on this machine's CPU, both
# float64 from the same graph (m/rad; chi2 relative): cuSOLVER's and
# LAPACK's Cholesky and cuBLAS's and the CPU's DGEMM round otherwise,
# a few ulps per operation on systems of condition ~1e6
JOINT_ATOL = 1e-8
JOINT_CHI2_RTOL = 1e-9
# the backend's DCS phi (slam.yaml dcs_phi) and final_joint_iterations
JOINT_PHI = 10.0
JOINT_ITERS = 12
# every blocked solve of a full run against the float64 C++ solver on
# the same graph, both 20 iterations from the backend's warm start
# (sim-killian's solves: <= 1.1e-12 on a CPU, scripts/pair_run.py;
# <= 1.6e-12 on an H100)
RUN_BLOCKED_NATIVE_ATOL = 1e-8
# MISS lines print the best sub-threshold score at full precision:
# compared at this tolerance (cuFFT against XLA's CPU FFT)
MISS_SCORE_ATOL = 1e-5
# .result poses: float64 atomics sum in a run-dependent order on the
# card (~1e-15 relative per scatter-add); 1e-6 m/rad absorbs that, and
# the 6-decimal file format can turn a 1e-12 difference into one unit
# of its last digit (hence the 1e-9 slack)
RESULT_ATOL = 1e-6 + 1e-9
# each replayed refinement is timed this many times, the least kept
REPLAY_TIMINGS = 3
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# the first version of the kernel (one block for the whole grid): its ms
# on an H100 80GB HBM3 at 700 W, final call of PR 1 (PERF.md)
V1_MS = {"slice_g320_s1024": 2.798, "max_g2048_s4096": 17.495,
         "main_path_map": 2.656}


# every emitted line is also appended here (main opens OUT/phases.jsonl):
# a caller that keeps only the end of standard output still gets all
PHASE_LOG = []


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for fh in PHASE_LOG:
        fh.write(line + "\n")
        fh.flush()


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs one CUDA GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "kind": name, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, count, smi


def phase_build():
    """Both kernels' nvcc builds, started together, and the g++ build of
    the refinement's host library."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = {"insert_rays": pool.submit(grid_cuda.build),
                "refine_pose": pool.submit(refine_cuda.build),
                "refine_pose_host": pool.submit(refine_cuda.build_host)}
        results = {k: v.result() for k, v in jobs.items()}
    sources = {"insert_rays": grid_cuda.SOURCE,
               "refine_pose": refine_cuda.SOURCE,
               "refine_pose_host": refine_cuda.HOST_SOURCE}
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "kernels": [{
              "name": k,
              "sources": [os.path.relpath(f, REPO)
                          for f in grid_cuda.source_files(sources[k])],
              "seconds": round(results[k]["seconds"], 3),
              "cached": results[k]["seconds"] == 0.0,
              "ptxas": results[k]["ptxas"]} for k in sources]})
    return refine_cuda.host_library()


def case_args(origins, pts, kind, G, res, n_steps):
    """insert_rays' arguments on the card: an empty (G, G) grid at world
    origin 0, hit/miss p 0.7/0.4."""
    dev = torch.device("cuda")
    return (
        torch.zeros((G, G), dtype=torch.float32, device=dev),
        torch.zeros(2, dtype=torch.float32, device=dev),
        torch.from_numpy(origins).to(dev),
        torch.from_numpy(pts).to(dev),
        torch.from_numpy(kind).to(dev),
        torch.tensor([0.7, 0.4], dtype=torch.float32, device=dev),
        res, n_steps, G,
    )


def seeded_case(seed, S, S_pad, B, G, res, n_steps, spread, box=None):
    """Scans at seeded origins with beams up to `spread` metres long,
    kinds mixed 0/1/2 as in a real range store; scans S..S_pad are
    padding. Origins are uniform in the square `box` = (lo, hi) metres,
    by default the middle 80 % of the (G*res)^2 map."""
    rng = np.random.default_rng(seed)
    ext = G * res
    lo, hi = box if box is not None else (0.1 * ext, 0.9 * ext)
    origins = np.zeros((S_pad, 2), np.float32)
    origins[:S] = rng.uniform(lo, hi, (S, 2))
    ang = rng.uniform(-np.pi, np.pi, (S, B))
    rng_len = rng.uniform(0.2, spread, (S, B))
    pts = np.zeros((S_pad, B, 2), np.float32)
    pts[:S] = origins[:S, None, :] + np.stack(
        [np.cos(ang), np.sin(ang)], -1
    ) * rng_len[..., None]
    kind = np.zeros((S_pad, B), np.int8)
    kind[:S] = rng.choice([0, 1, 1, 1, 2], size=(S, B))
    return case_args(origins, pts, kind, G, res, n_steps)


def submap_case(seed, G, res):
    """A backend submap grid on sim-office: 20 scans (padded to 32) of
    16 beams up to 10 m from origins in a 6 m box at the grid's
    centre."""
    c = G * res / 2
    return seeded_case(seed, 20, 32, 16, G, res, 96, 10.0,
                       box=(c - 3.0, c + 3.0))


def tile_edge_case(seed, S, S_pad, B, G, n_steps, res=0.125, tile=16):
    """Scans on the borders of the kernel's tiles: with a power-of-two
    resolution every border is exact in float32. Origins lie on tile
    corners or cell corners, endpoints at whole-cell offsets from them,
    a third of the offsets a whole number of tiles and a third of the
    rays parallel to an axis, running along a border."""
    rng = np.random.default_rng(seed)
    origins = np.zeros((S_pad, 2), np.float32)
    on_tile = rng.random(S) < 0.5
    origins[:S] = np.where(on_tile[:, None],
                           rng.integers(1, G // tile, (S, 2)) * tile,
                           rng.integers(1, G, (S, 2))) * res
    off = rng.integers(-2 * tile, 2 * tile + 1, (S, B, 2))
    snap = rng.random((S, B)) < 0.33
    off[snap] = off[snap] // tile * tile
    axis = rng.random((S, B)) < 0.33
    off[axis, rng.integers(0, 2, int(axis.sum()))] = 0
    pts = np.zeros((S_pad, B, 2), np.float32)
    pts[:S] = origins[:S, None, :] + off * res
    kind = np.zeros((S_pad, B), np.int8)
    kind[:S] = rng.integers(0, 3, (S, B))
    return case_args(origins, pts, kind, G, res, n_steps)


def time_ms(fn, reps, warmup=2):
    """Mean device ms of fn() over `reps` calls. The calls queue up
    behind a sleeping kernel (~10 ms), so for fast kernels the events
    time the card's work and not the host's cost of each launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def insertion_bound(args):
    """Least time for one insertion on an H100 SXM: the larger of the
    bytes it must move (grid read and written once, scans read once)
    over HBM bandwidth, and the float32 operations this data needs
    (10 per valid ray sample and 4 per hit for the cell arithmetic,
    7 per cell update) over the float32 peak."""
    probs, _, origins, pts, kind, hm, res, n_steps, size = args
    nbytes = (2 * probs.numel() * 4 + origins.numel() * 4
              + pts.numel() * 4 + kind.numel() + hm.numel() * 4 + 8)
    valid = kind > 0
    n_valid = int(valid.sum())
    n_hits = int((kind == 1).sum())
    # cell updates: distinct (scan, cell) pairs among in-grid samples
    dev = probs.device
    ts = ((torch.arange(n_steps, device=dev, dtype=torch.float64) + 0.5)
          / n_steps).float()
    ray = origins[:, None, None, :] + (pts - origins[:, None, :])[
        :, :, None, :] * ts[None, None, :, None]
    org = args[1]
    cells = torch.floor((ray - org) / res).long()
    ends = torch.floor((pts - org) / res).long()
    inb = ((cells >= 0) & (cells < size)).all(-1) & valid[..., None]
    s_idx = torch.arange(kind.shape[0], device=dev)[:, None, None].expand(
        inb.shape)
    keys = (s_idx * size + cells[..., 0]) * size + cells[..., 1]
    e_inb = ((ends >= 0) & (ends < size)).all(-1) & (kind == 1)
    e_keys = (torch.arange(kind.shape[0], device=dev)[:, None] * size
              + ends[..., 0]) * size + ends[..., 1]
    n_updates = int(torch.unique(torch.cat([keys[inb], e_keys[e_inb]]))
                    .numel())
    ops = 10 * n_valid * n_steps + 4 * n_hits + 7 * n_updates
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def n_blocks(size, tile):
    """The kernel's launch grid: one block per tile of the grid."""
    return ((size + tile - 1) // tile) ** 2


def compare(name, args, kernel_reps, plain_reps):
    """Kernel against its plain twin on the same CUDA inputs, at the
    wrapper's own tile through the dispatching insert_rays and at every
    tile the kernel is built for; `probs` must be left as it was."""
    probs = args[0].clone()
    ref = insert_rays_plain(*args)
    before = grid_cuda.insert_rays_cuda.launches
    out = insert_rays(*args)
    torch.cuda.synchronize()
    launches = grid_cuda.insert_rays_cuda.launches - before
    equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max())
    sweep = []
    for tile in grid_cuda.TILES:
        out_t = grid_cuda.insert_rays_cuda(*args, tile=tile)
        torch.cuda.synchronize()
        equal_t = bool(torch.equal(out_t, ref))
        equal &= equal_t
        err = max(err, float((out_t - ref).abs().max()))
        sweep.append({
            "tile": tile, "blocks": n_blocks(args[8], tile),
            "equal": equal_t,
            "ms": time_ms(lambda: grid_cuda.insert_rays_cuda(
                *args, tile=tile), kernel_reps),
        })
    equal &= bool(torch.equal(args[0], probs))
    tile = grid_cuda.pick_tile(
        args[8], torch.cuda.get_device_properties(0).multi_processor_count)
    ms = next(r["ms"] for r in sweep if r["tile"] == tile)
    plain_ms = time_ms(lambda: insert_rays_plain(*args), plain_reps,
                       warmup=1)
    bound_ms, bound_by, nbytes, ops = insertion_bound(args)
    row = {
        "case": name, "G": args[8], "S_pad": args[4].shape[0],
        "B": args[4].shape[1], "n_steps": args[7], "res": args[6],
        "tile": tile, "blocks": n_blocks(args[8], tile),
        "launches": launches, "equal": equal, "max_abs_err": err,
        "ms": ms, "sweep": sweep, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / ms, "bytes": nbytes, "ops": ops,
        "known_cells": int((out > 0).sum()),
    }
    emit({"phase": "kernel", **row})
    if launches != 1:
        raise AssertionError(f"case {name}: one insertion made {launches} "
                             f"kernel launches, not 1")
    if not equal:
        raise AssertionError(f"insert_rays kernel differs from its plain "
                             f"version on case {name}: max |d| {err}")
    return row


def phase_kernel():
    cases = [
        # the Pallas parity case of the JAX tests
        ("test_s8_b8_g64", seeded_case(3, 8, 8, 8, 64, 0.1, 24, 1.6)),
        ("test_s40_b16_g128", seeded_case(4, 40, 64, 16, 128, 0.1, 96,
                                          4.0)),
        # rays that leave the grid
        ("leaving_grid", seeded_case(5, 32, 32, 16, 64, 0.1, 96, 12.0)),
        # the backend's two submap grids on sim-office
        ("submap_g320_s32", submap_case(8, 320, 0.1)),
        ("submap_hi_g576_s32", submap_case(9, 576, 0.05)),
        # origins and endpoints on tile and cell borders
        ("tile_edges", tile_edge_case(10, 48, 64, 16, 256, 96)),
        # a grid edge that no tile divides
        ("ragged_g100", seeded_case(11, 24, 32, 16, 100, 0.1, 96, 6.0)),
        # the sim-office map's shapes
        ("slice_g320_s1024", seeded_case(6, 648, 1024, 16, 320, 0.0957,
                                         96, 10.0)),
        # the largest map the code allows
        ("max_g2048_s4096", seeded_case(7, 4096, 4096, 16, 2048, 0.1,
                                        96, 10.0)),
    ]
    rows = []
    for name, args in cases:
        big = args[8] >= 2048
        rows.append(compare(name, args, kernel_reps=5 if big else 20,
                            plain_reps=1 if big else 3))
    return rows


def emit_times(rows, smi):
    """Every case's time beside its bound and the first version's."""
    emit({"phase": "kernel_times", "card": smi, "cases": [{
        "case": r["case"], "tile": r["tile"], "ms": r["ms"],
        "ms_by_tile": {str(t["tile"]): t["ms"] for t in r["sweep"]},
        "bound_ms": r["bound_ms"], "bound_share": r["bound_share"],
        "v1_ms_pr1": V1_MS.get(r["case"]),
    } for r in rows]})


# ---------------------------------------------------------------------------
# the refinement kernel (csrc/refine_pose.cu)
# ---------------------------------------------------------------------------

# the float32 bit patterns below this one are the |theta| <= 4 pi the
# refinement can meet
SINCOS_END = int(np.float32(4 * np.pi).view(np.uint32)) + 1
SINCOS_CHUNK = 1 << 27


def check_sincosf(host_lib):
    """The header's sinf/cosf on the card against the host C library's,
    for every float32 of |theta| <= 4 pi; returns (values, mismatches,
    seconds)."""
    lib = ctypes.CDLL(refine_cuda.build()["path"])
    launch = lib.rpx_sincosf_launch
    launch.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_void_p] * 3
    launch.restype = ctypes.c_int
    t0 = time.perf_counter()
    bad = total = 0
    sin_d = torch.empty(2 * SINCOS_CHUNK, dtype=torch.float32, device="cuda")
    cos_d = torch.empty_like(sin_d)
    sin_h = torch.empty(2 * SINCOS_CHUNK, dtype=torch.float32,
                        pin_memory=True)
    cos_h = torch.empty_like(sin_h, pin_memory=True)
    for start in range(0, SINCOS_END, SINCOS_CHUNK):
        end = min(start + SINCOS_CHUNK, SINCOS_END)
        n = end - start
        rc = launch(start, end, 1, sin_d.data_ptr(), cos_d.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sincosf kernel launch failed: {rc}")
        sin_h[:2 * n].copy_(sin_d[:2 * n])
        cos_h[:2 * n].copy_(cos_d[:2 * n])
        torch.cuda.synchronize()
        bad += host_lib.rpx_libm_mismatches(start, end, 1, sin_h.data_ptr(),
                                            cos_h.data_ptr())
        total += 2 * n
    return total, bad, time.perf_counter() - t0


def refine_grid(kind, G, res, seed):
    """A (G, G) float32 probability grid centred on the world origin:
    `room`, a 7 x 6 m room whose four walls are 0.9 bands three cells
    wide around free space at 0.2 +- 0.05 (seeded), unknown (0) outside;
    `corridor`, two walls 2 m apart and uniform along x, so that J^T J
    has no information along it."""
    rng = np.random.default_rng(seed)
    origin = np.full(2, -G * res / 2, np.float32)
    c = origin[0] + (np.arange(G) + 0.5) * res
    X, Y = np.meshgrid(c, c, indexing="ij")
    band = 1.5 * res
    if kind == "room":
        inside = (X > -3) & (X < 4) & (Y > -1) & (Y < 5)
        g = np.where(inside, 0.2 + rng.uniform(-0.05, 0.05, X.shape), 0.0)
        near = (X > -3 - band) & (X < 4 + band) & (Y > -1 - band) & (
            Y < 5 + band)
        wall = near & ((np.abs(X - 4) < band) | (np.abs(X + 3) < band)
                       | (np.abs(Y + 1) < band) | (np.abs(Y - 5) < band))
    else:
        g = np.where(np.abs(Y) < 1, 0.2, 0.0)
        wall = np.abs(np.abs(Y) - 1) < band
    return np.where(wall, 0.9, g).astype(np.float32), origin


REFINE_WALLS = {
    "room": [((4.0, 0.0), (0.0, 1.0)), ((-3.0, 0.0), (0.0, 1.0)),
             ((0.0, -1.0), (1.0, 0.0)), ((0.0, 5.0), (1.0, 0.0))],
    "corridor": [((0.0, -1.0), (1.0, 0.0)), ((0.0, 1.0), (1.0, 0.0))],
}


def refine_query(kind, n_pad, seed):
    """A scan of the world's walls (up to 8 m, 1 cm noise; 720 beams, or
    2 n_pad above n_pad = 512) from a seeded pose, in its own frame,
    padded to n_pad; the initial pose a few cm and a degree or two
    off."""
    rng = np.random.default_rng(seed)
    gt = np.array([rng.uniform(-0.5, 0.5), rng.uniform(0.0, 0.8),
                   rng.uniform(-0.4, 0.4)])
    beams = 720 if n_pad <= 512 else 2 * n_pad
    a = gt[2] + np.linspace(-np.pi, np.pi, beams, endpoint=False)
    best = np.full(a.shape, np.inf)
    for (px, py), (dx, dy) in REFINE_WALLS[kind]:
        den = np.cos(a) * dy - np.sin(a) * dx
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((px - gt[0]) * dy - (py - gt[1]) * dx) / den
        best = np.minimum(best, np.where((np.abs(den) > 1e-9) & (t > 0),
                                         t, np.inf))
    ok = best <= 8.0
    r = best[ok] + rng.normal(0, 0.01, ok.sum())
    rel = a[ok] - gt[2]
    pts = np.stack([r * np.cos(rel), r * np.sin(rel)], 1)
    pts = pts[np.sort(rng.permutation(len(pts))[: n_pad - 40])]
    padded = np.zeros((n_pad, 2), np.float32)
    padded[: len(pts)] = pts
    init = gt + np.array([rng.uniform(-0.06, 0.06),
                          rng.uniform(-0.06, 0.06), rng.uniform(-0.03, 0.03)])
    return padded, np.arange(n_pad) < len(pts), init.astype(np.float32)


# float32 operations of csrc/refine_pose_exact.cuh per padded point (an
# FMA counts two; compares, selects and conversions none). eval_point
# without the Jacobian: the moved point 12, two weights() 42, the
# interpolation 28 + 7; its Jacobian 272 more: the tangents' directions
# 11, then per tangent two dweights() 40, the tap chains 28, d10/d45 16
# and their sum 3. residual_rows: the residual 3, its Jacobian row 6;
# the covariance's rows: the masked Jacobian 3 and 1 - p 1.
OPS_EVAL, OPS_JAC = 89, 272
OPS_RESIDUAL, OPS_JAC_ROW, OPS_COV_ROW = 3, 6, 4


def refine_bound(n_stages, n, cells, iterations=10, want_cov=True):
    """refine_bound_parts as (bound ms, what bounds it, serial-chain
    latency ms)."""
    t_bytes, t_ops, chain = refine_bound_parts(n_stages, n, cells,
                                               iterations, want_cov)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", chain)


def refine_bound_parts(n_stages, n, cells, iterations=10, want_cov=True):
    """Least time for one refinement on an H100 SXM: the larger of the
    bytes it must move over HBM bandwidth and its float32 operations
    over the float32 peak. Bytes: the distinct grid cells its bicubic
    taps read on this run's evaluations (`cells`, over all stages, from
    TapRecorder), the points, mask, initial pose, origins and one
    rsqrt table entry read once; pose, covariance and probabilities
    written once. Operations, per stage and iteration: the evaluation
    with the Jacobian and the trial's without (OPS_*), then over the
    K = N + 3 rows J^T J (nine FMA chains, 18 K), J^T r (6 K and 24
    for the lanes' sum), the two sums of squares (2 K and a sum of the
    windows each) and the anchor rows (10); after the last iteration
    with want_cov each stage's probabilities and the last stage's
    Jacobian, J^T J (18 N) and sum of squares (2 N). Thread 0's scalar
    work (sinf/cosf in float64 once per evaluation, the 3x3 solve, the
    3x3 eigh) is a few hundred operations per iteration, under 0.3 % of
    these, and left out. Returns the bytes' time and the operations'
    time (ms) and the latency of the serial FMA chains (J^T J walks
    N + 3 dependent FMAs per iteration) at 4 cycles each at 1.98 GHz,
    which bounds this design."""
    K = n + 3
    nw, nwc = -(-K // 32), -(-n // 32)
    nbytes = (cells * 4 + n * 9 + 12 + 8 * n_stages + 4 + 12
              + (36 + n * 4 if want_cov else 0))
    per_it = (n * (2 * OPS_EVAL + OPS_JAC + 2 * OPS_RESIDUAL + OPS_JAC_ROW)
              + K * (18 + 6 + 2 + 2) + 24 + 2 * nw + 10)
    ops = n_stages * iterations * per_it
    if want_cov:
        ops += (n_stages * n * OPS_EVAL
                + n * (OPS_JAC + OPS_COV_ROW + 18 + 2) + nwc)
    chain = n_stages * iterations * K + (n if want_cov else 0)
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            ops / PEAK_F32_OPS_PER_S * 1e3, chain_ms(chain))


def chain_ms(fmas):
    """Latency of `fmas` dependent FMAs at 4 cycles each at 1.98 GHz."""
    return fmas * 4 / 1.98e9 * 1e3


def kernel_chain_ms(n, steps, want_cov):
    """The serial J^T J chains of the GN steps the kernel ran (`steps`
    per stage): each stage that runs evaluates its first pose and then
    each step's trial, and each evaluation's reduction walks K = n + 3
    rows; the covariance walks n."""
    evals = sum(s + 1 for s in steps if s > 0)
    return chain_ms(evals * (n + 3) + (n if want_cov else 0))


class TapRecorder:
    """Wraps ops/refine_exact.evaluate (each evaluation of the plain
    refinement) to keep its grid and pose; cells() counts the distinct
    grid cells that the evaluations' bicubic taps read, stage by stage:
    the grid a refinement must read with these inputs. The kernel
    evaluates the same points at the same poses, being bit-equal."""

    def __init__(self):
        self.evals = []
        self._orig = refine_exact.evaluate

    def _evaluate(self, grid, origin, res, pts, pose, c, s, jac, inv=None):
        self.evals.append((grid, origin, res, pts, np.array(pose), c, s,
                           inv))
        return self._orig(grid, origin, res, pts, pose, c, s, jac, inv)

    @contextlib.contextmanager
    def active(self):
        self.evals = []
        refine_exact.evaluate = self._evaluate
        try:
            yield self
        finally:
            refine_exact.evaluate = self._orig

    def cells(self):
        seen = {}
        for grid, origin, res, pts, pose, c, s, inv in self.evals:
            mask = seen.setdefault(id(grid), np.zeros(grid.size, bool))
            mask[refine_exact.tap_cells(grid.shape[0], origin, res, pts,
                                        pose, c, s, inv)] = True
        return sum(int(m.sum()) for m in seen.values())


def refine_case(kind, n, res_keys, seed):
    """Stages on the card: one grid (res 0.1 at G=320, 0.05 at G=576)
    or the two-stage pair (level 0 of the pyramid at 0.1, then the
    0.1 m or the 0.05 m grid), and a query."""
    dev = torch.device("cuda")
    stages = []
    for key in res_keys:
        res, G = (0.1, 320) if key in (0.1, "score") else (0.05, 576)
        g, o = refine_grid(kind, G, res, seed)
        g = torch.from_numpy(g).to(dev)
        if key == "score":
            g = precompute_pyramid(g, 1)[0].contiguous()
        stages.append((g, torch.from_numpy(o).to(dev), res))
    pts, valid, init = refine_query(kind, n, seed)
    return stages, (torch.from_numpy(pts).to(dev),
                    torch.from_numpy(valid).to(dev),
                    torch.from_numpy(init).to(dev))


REFINE_CASES = [
    ("room", 256, (0.1,), 0), ("room", 512, (0.1,), 1),
    ("room", 256, (0.05,), 2), ("room", 512, (0.05,), 3),
    ("corridor", 256, (0.05,), 4), ("corridor", 512, (0.1,), 5),
    ("room", 256, ("score", 0.05), 6), ("room", 512, ("score", 0.1), 7),
    ("corridor", 256, ("score", 0.05), 8),
    # the query sizes of more beams (the 60-beam run pads to 4096)
    ("room", 1024, (0.1,), 10), ("corridor", 1024, ("score", 0.05), 11),
    ("room", 2048, (0.05,), 12), ("corridor", 2048, (0.1,), 13),
    ("room", 2048, ("score", 0.1), 14), ("room", 4096, (0.1,), 15),
    ("corridor", 4096, (0.05,), 16), ("room", 4096, ("score", 0.05), 17),
    ("corridor", 4096, ("score", 0.1), 18),
    # the largest query the kernel takes (rows 131 KB of shared memory)
    ("room", 8192, (0.1,), 19), ("corridor", 8192, ("score", 0.05), 20),
]
# a padded point count the kernel must refuse
REFINE_REFUSED_N = 16384


def run_refine(stages, query, iterations=10, want_cov=True):
    """The kernel through the dispatching refine functions."""
    if not want_cov:
        return (matching_mod.refine_pose(*stages[0], *query,
                                         iterations=iterations),)
    if len(stages) == 1:
        return matching_mod.refine_pose_cov(*stages[0], *query,
                                            iterations=iterations)
    return matching_mod.refine_pose_cov_two_stage(
        *stages[0], *stages[1], *query, iterations=iterations)


def plain_refine(stages, query, iterations=10, want_cov=True, taps=None):
    """The plain version; with a TapRecorder, its evaluations recorded."""
    with taps.active() if taps else contextlib.nullcontext():
        out = matching_mod.refine_plain(stages, *query, iterations,
                                        want_cov)
    return out if want_cov else (out,)


def refine_equal(got, ref):
    return all(torch.equal(a, b) for a, b in zip(got, ref))


def kernel_refine(stages, query, iterations=10, want_cov=True):
    """One launch of the kernel's wrapper on one problem: its outputs
    (as run_refine returns them) and the GN steps each stage ran, (2,)
    int32 on the card (read them after timing: reading syncs)."""
    pts, valid, init = (t[None].contiguous() for t in query)
    pose, cov, probs, steps = refine_cuda.refine_cuda(
        stages, pts, valid, init, iterations, want_cov)
    out = (pose[0], cov[0], probs[0]) if want_cov else (pose[0],)
    return out, steps[0]


def check_refusal(stages):
    """A launch at REFINE_REFUSED_N points: the wrapper raises (the
    launcher's own check is the host build's, tested on the CPU)."""
    n, dev = REFINE_REFUSED_N, torch.device("cuda")
    query = (torch.zeros((1, n, 2), device=dev),
             torch.ones((1, n), dtype=torch.bool, device=dev),
             torch.zeros((1, 3), device=dev))
    try:
        refine_cuda.refine_cuda(stages, *query)
        wrapper = "launched"
    except ValueError as e:
        wrapper = str(e)
    emit({"phase": "refine_refused", "N": n, "wrapper": wrapper})
    if wrapper == "launched":
        raise AssertionError(f"a refinement at N={n} was not refused")


def phase_refine(host_lib):
    """The refinement kernel against its plain version on the card: the
    header's sinf/cosf on every float32 of |theta| <= 4 pi against the
    host's C library, then seeded cases (a room and a near-singular
    corridor, N = 256 to 8192, grids at 0.1 m (G=320) and 0.05 m
    (G=576), one stage and two, and refine_pose alone), each
    torch.equal on pose, covariance and probabilities, with its time
    beside its bound, its serial-chain latency and the GN steps its
    stages ran; then a launch at REFINE_REFUSED_N refused."""
    total, bad, secs = check_sincosf(host_lib)
    emit({"phase": "refine_sincosf", "values": total, "mismatches": bad,
          "seconds": secs})
    if bad:
        raise AssertionError(f"the header's sinf/cosf differ from the C "
                             f"library's on {bad} of {total} values")
    rows = []
    for kind, n, keys, seed in REFINE_CASES:
        stages, query = refine_case(kind, n, keys, seed)
        for want_cov in ((True, False) if keys == (0.1,) else (True,)):
            before = refine_cuda.refine_cuda.launches
            got = run_refine(stages, query, want_cov=want_cov)
            torch.cuda.synchronize()
            launches = refine_cuda.refine_cuda.launches - before
            taps = TapRecorder()
            t0 = time.perf_counter()
            ref = plain_refine(stages, query, want_cov=want_cov, taps=taps)
            plain_ms = (time.perf_counter() - t0) * 1e3
            equal = refine_equal(got, ref)
            err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            cells = taps.cells()
            bound_ms, bound_by, all_steps_chain_ms = refine_bound(
                len(stages), n, cells, want_cov=want_cov)
            direct, steps = kernel_refine(stages, query, want_cov=want_cov)
            equal = equal and refine_equal(direct, ref)
            steps = steps.tolist()
            ms = time_ms(lambda: run_refine(stages, query,
                                            want_cov=want_cov), 20)
            w = (np.linalg.eigvalsh(got[1].double().cpu().numpy())
                 if want_cov else None)
            row = {
                "case": f"{kind}_n{n}_{'+'.join(map(str, keys))}"
                        f"{'' if want_cov else '_pose_only'}",
                "stages": len(keys), "N": n, "valid": int(query[1].sum()),
                "G": [int(g.shape[0]) for g, _, _ in stages],
                "grid_cells_read": cells,
                "launches": launches, "equal": equal, "max_abs_err": err,
                "steps": steps[:len(keys)], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "serial_chain_ms": kernel_chain_ms(n, steps, want_cov),
                "serial_chain_ms_all_steps": all_steps_chain_ms,
                "cov_eig_ratio": (float(w[-1] / w[0]) if w is not None
                                  and w[0] > 0 else None),
            }
            emit({"phase": "refine", **row})
            if launches != 1:
                raise AssertionError(f"refinement case {row['case']}: "
                                     f"{launches} launches, not 1")
            if not equal:
                raise AssertionError(f"refine_pose kernel differs from its "
                                     f"plain version on {row['case']}: "
                                     f"max |d| {err}")
            rows.append(row)
    check_refusal(stages)
    return rows


class RefineRecorder:
    """Wraps ops/matching._refine (every refinement of a run) to keep
    each call's arguments and result, to replay them through the plain
    version afterwards; `threads` counts the calls by thread name. Safe
    to call from several threads (the realtime run's)."""

    def __init__(self):
        self.calls = []
        self.threads = {}
        self._lock = threading.Lock()
        self._orig = matching_mod._refine

    def _refine(self, stages, points, point_valid, init_pose, iterations,
                want_cov):
        out = self._orig(stages, points, point_valid, init_pose,
                         iterations, want_cov)
        name = threading.current_thread().name
        with self._lock:
            self.calls.append(((stages, points, point_valid, init_pose,
                                iterations, want_cov),
                               out if want_cov else (out,)))
            self.threads[name] = self.threads.get(name, 0) + 1
        return out

    @contextlib.contextmanager
    def active(self):
        matching_mod._refine = self._refine
        try:
            yield self
        finally:
            matching_mod._refine = self._orig


_REPLAY_POOL = []


def replay_pool():
    """The worker processes (spawned, one torch and BLAS thread each, up
    to 8) that replay recorded refinements through the plain version on
    the host; main() shuts them down."""
    if not _REPLAY_POOL:
        import concurrent.futures
        import multiprocessing

        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            _REPLAY_POOL.append(concurrent.futures.ProcessPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn")))
        finally:
            if saved is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = saved
    return _REPLAY_POOL[0]


def plain_replay(job):
    """Worker: one recorded refinement (host copies of its stages and
    query) through the plain version, with the grid cells its
    evaluations read (TapRecorder) and its seconds."""
    stages, query, iterations, want_cov = job
    torch.set_num_threads(1)
    taps = TapRecorder()
    t0 = time.perf_counter()
    ref = plain_refine(stages, query, iterations, want_cov, taps)
    return ref, taps.cells(), time.perf_counter() - t0


def replay_refinements(calls):
    """Every recorded refinement of a run through the plain version
    (torch.equal on each output; on host copies of the same tensors, in
    replay_pool's processes: the plain version computes on the host
    whatever the device), the same call through the kernel's wrapper for
    the GN steps its stages ran, and the call through the kernel again,
    timed on the card (one launch behind a sleeping kernel, the least of
    REPLAY_TIMINGS such timings: a launch the host enqueues after the
    sleep ended is timed with the host's delay). Returns the
    readings summed over the calls and split by padded point count N;
    the plain time (each call's own seconds in its process) includes
    TapRecorder's appends (a list append per evaluation), not its cell
    count."""
    unequal = []
    ms = plain_ms = bound_ms = chain = all_steps_chain = err = 0.0
    cells = 0
    by = {"bytes": 0.0, "operations": 0.0}
    by_n = {}
    jobs = [([(g.cpu(), o.cpu(), r) for g, o, r in args[0]],
             tuple(x.cpu() for x in args[1:4]), args[4], args[5])
            for args, _ in calls]
    plains = replay_pool().map(plain_replay, jobs, chunksize=4)
    for k, ((args, out), (ref, n_cells, secs)) in enumerate(
            zip(calls, plains)):
        stages, pts, valid, init, iterations, want_cov = args
        query = (pts, valid, init)
        n = pts.shape[0]
        plain_ms += secs * 1e3
        out = [o.cpu() for o in out]
        if not refine_equal(out, ref):
            unequal.append(k)
        err = max(err, max(float((a - b).abs().max())
                           for a, b in zip(out, ref)))
        steps = kernel_refine(stages, query, iterations, want_cov)[1].tolist()
        call_ms = min(
            time_ms(lambda: run_refine(stages, query, iterations, want_cov),
                    1, warmup=0)
            for _ in range(REPLAY_TIMINGS))
        ms += call_ms
        cells += n_cells
        b, bound_by, c = refine_bound(len(stages), n, n_cells,
                                      iterations, want_cov)
        bound_ms += b
        all_steps_chain += c
        call_chain = kernel_chain_ms(n, steps, want_cov)
        chain += call_chain
        by[bound_by] += b
        row = by_n.setdefault(str(n), {"launches": 0, "ms": 0.0,
                                       "bound_ms": 0.0, "chain_ms": 0.0,
                                       "steps": {}})
        row["launches"] += 1
        row["ms"] += call_ms
        row["bound_ms"] += b
        row["chain_ms"] += call_chain
        for s in steps[:len(stages)]:
            row["steps"][str(s)] = row["steps"].get(str(s), 0) + 1
    return {"refine_calls_unequal": unequal, "refine_max_abs_err": err,
            "refine_device_ms": ms,
            "refine_plain_ms": plain_ms, "refine_bound_ms": bound_ms,
            "refine_bound_by": max(by, key=by.get),
            "refine_grid_cells_read": cells,
            "refine_serial_chain_ms": chain,
            "refine_serial_chain_ms_all_steps": all_steps_chain,
            "refine_by_n": by_n}


class PinRecorder:
    """Wraps ops/matching.refine_pins (the device pin batches'
    refinement: the kernel's batched mode, one launch per batch) to keep
    each call's inputs (the grids and origins its pins read, gathered by
    pin) and outputs for replay_pins."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()
        self._orig = matching_mod.refine_pins

    def _refine_pins(self, grids, origins, ids, resolution, points,
                     point_valid, init_pose, iterations=10):
        out = self._orig(grids, origins, ids, resolution, points,
                         point_valid, init_pose, iterations)
        sel = ids.to(torch.long)
        with self._lock:
            self.calls.append(((grids.index_select(0, sel).contiguous(),
                                origins.index_select(0, sel).contiguous(),
                                resolution, points, point_valid, init_pose,
                                iterations), out))
        return out

    @contextlib.contextmanager
    def active(self):
        matching_mod.refine_pins = self._refine_pins
        try:
            yield self
        finally:
            matching_mod.refine_pins = self._orig


def plain_pin_replay(job):
    """Worker: one recorded pin batch (host copies) through the batched
    plain version, pin by pin, with the grid cells each pin's
    evaluations read and the seconds."""
    grids, origins, res, pts, valid, init, iterations = job
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    outs, cells = [], []
    for b in range(len(pts)):
        taps = TapRecorder()
        with taps.active():
            outs.append(matching_mod.refine_pins_plain(
                grids[b:b + 1], origins[b:b + 1],
                torch.zeros(1, dtype=torch.long), res, pts[b:b + 1],
                valid[b:b + 1], init[b:b + 1], iterations))
        cells.append(taps.cells())
    ref = tuple(torch.cat(x) for x in zip(*outs))
    return ref, cells, time.perf_counter() - t0


def replay_pins(calls):
    """Every recorded pin batch through the batched plain version
    (torch.equal on pose, covariance and probabilities) and through the
    kernel's batched mode again, timed as replay_refinements times a
    launch; the bound sums the batch's pins' bytes and operations."""
    unequal = []
    ms = plain_ms = t_bytes = t_ops = err = 0.0
    pins = 0
    jobs = [(g.cpu(), o.cpu(), r, p.cpu(), v.cpu(), i.cpu(), it)
            for (g, o, r, p, v, i, it), _ in calls]
    for k, ((args, out), (ref, cells, secs)) in enumerate(
            zip(calls, replay_pool().map(plain_pin_replay, jobs))):
        g, o, r, p, v, i, it = args
        plain_ms += secs * 1e3
        out = [x.cpu() for x in out]
        if not refine_equal(out, ref):
            unequal.append(k)
        err = max(err, max(float((a - b).abs().max())
                           for a, b in zip(out, ref)))
        ids = torch.arange(len(p), dtype=torch.int32, device=p.device)
        ms += min(time_ms(lambda: refine_cuda.refine_pins_cuda(
            g, o, ids, r, p, v, i, it), 1, warmup=0)
            for _ in range(REPLAY_TIMINGS))
        for c in cells:
            tb, to, _ = refine_bound_parts(1, p.shape[1], c, it, True)
            t_bytes += tb
            t_ops += to
        pins += len(p)
    return {"pins_calls_unequal": unequal, "pins_max_abs_err": err,
            "pins_device_ms": ms, "pins_plain_ms": plain_ms,
            "pins_bound_ms": max(t_bytes, t_ops),
            "pins_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "pins_refined": pins}


@contextlib.contextmanager
def mesh_hooks(n):
    """Every SubmapLoopCloser built inside gets 2-shard-style meshes of
    n shards on this machine's cards in turn (backend.mesh and
    match_mesh, as tests/test_pipeline_dist.py sets the JAX package's);
    yields the counts of sharded solves and sharded candidate searches."""
    counts = {"sharded_solves": 0, "sharded_searches": 0}
    init = SubmapLoopCloser.__init__
    solve = dist_solver.optimize_pose_graph_sharded
    search = matching_mod.match_candidates_sharded

    def hooked(self, *a, **k):
        init(self, *a, **k)
        self.mesh = multihost.block_mesh(n, mesh_devices(n))
        self.match_mesh = multihost.block_mesh(n, mesh_devices(n))

    def counted(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    SubmapLoopCloser.__init__ = hooked
    dist_solver.optimize_pose_graph_sharded = counted("sharded_solves", solve)
    matching_mod.match_candidates_sharded = counted("sharded_searches",
                                                    search)
    try:
        yield counts
    finally:
        SubmapLoopCloser.__init__ = init
        dist_solver.optimize_pose_graph_sharded = solve
        matching_mod.match_candidates_sharded = search


def mesh_devices(n):
    """n shards on this machine's cards in turn (several on one card
    where there are fewer cards)."""
    k = torch.cuda.device_count()
    return [torch.device(f"cuda:{i % k}") for i in range(n)]


def phase_main():
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data = os.path.join(tmp, "sim-office")
        shutil.copytree(DATASET, data)
        png = os.path.join(tmp, "map.png")
        grid_cuda.reset_launches(grid_cuda.insert_rays_cuda)
        t0 = time.perf_counter()
        r = runner.run([
            "--dataset-dir", data, "--dataset-name", "sim-office",
            "--no-backend", "--eval", "--map-png", png, "--device", "cuda",
        ])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = grid_cuda.insert_rays_cuda.launches

        fe = r.system.frontend
        counts = {"keyframes": len(fe.keyframes),
                  "landmarks": len(fe.landmarks),
                  "rejected_ticks": fe.rejected_ticks}
        times, poses = load_result(os.path.join(data, "sim-office.result"))
        ref_times, ref_poses = load_result(REFERENCE_RESULT)
        same_times = bool(np.array_equal(times, ref_times))
        d = poses - ref_poses if same_times else np.full(1, np.inf)
        if same_times:
            d[:, 2] = wrap_angle(d[:, 2])
        result_err = float(np.abs(d).max())

        # the same map through the plain twin on the card
        probs, origin, res = r.map
        world, spec = map_range_data(fe.keyframes, fe.estimates(),
                                     r.system.config.map_resolution)
        args = submap_insert_args(world, spec, device="cuda")
        plain = insert_rays_plain(*args).cpu().numpy()
        map_equal = bool(np.array_equal(plain, probs))
        ft = np.asarray(r.system.frontend_times)
        emit({
            "phase": "main", "frames": r.n_frames, **counts,
            "ate": str(r.ate), "kernel_launches": launches,
            "result_max_abs_err": result_err, "result_atol": RESULT_ATOL,
            "map_G": spec.size, "map_S_pad": args[4].shape[0],
            "map_B": args[4].shape[1], "map_equal_plain": map_equal,
            "frontend_mean_ms": float(ft.mean() * 1e3),
            "frontend_max_ms": float(ft.max() * 1e3),
            "frontend_ticks": len(ft), "frame_loop_s": r.wall_s,
            "fps": r.n_frames / r.wall_s, "total_s": total_s,
        })
        problems = []
        if launches < 1:
            problems.append("the map render launched no insertion kernel")
        if str(r.ate) != REFERENCE_ATE:
            problems.append(f"ATE {r.ate} != reference {REFERENCE_ATE}")
        if counts != REFERENCE_COUNTS:
            problems.append(f"counts {counts} != {REFERENCE_COUNTS}")
        if not same_times or not result_err <= RESULT_ATOL:
            problems.append(f".result differs from the reference: "
                            f"times equal {same_times}, max |d| "
                            f"{result_err}")
        if not map_equal:
            problems.append("map differs from the plain twin's")
        if not os.path.getsize(png):
            problems.append("empty map PNG")
        if problems:
            raise AssertionError("; ".join(problems))
        return launches, args
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class InsertRecorder:
    """Wraps ops/grid.insert_rays (which every grid build calls) to keep
    each call's arguments, result and the phase that made it: the
    innermost of the wrapped callers on the calling thread's stack.
    `threads` counts the calls by thread name. Safe to call from several
    threads (the realtime run's)."""

    def __init__(self):
        self.calls = []
        self.call_threads = []
        self.threads = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._orig = grid_mod.insert_rays

    def _stack(self):
        if not hasattr(self._local, "phase"):
            self._local.phase = ["other"]
        return self._local.phase

    def insert(self, *args):
        out = self._orig(*args)
        name = threading.current_thread().name
        with self._lock:
            self.calls.append((self._stack()[-1], args, out))
            self.call_threads.append(name)
            self.threads[name] = self.threads.get(name, 0) + 1
        return out

    def tag(self, phase, fn):
        def wrapped(*a, **k):
            self._stack().append(phase)
            try:
                return fn(*a, **k)
            finally:
                self._stack().pop()
        return wrapped

    @contextlib.contextmanager
    def active(self):
        saved = (grid_mod.insert_rays, SubmapLoopCloser.precompute,
                 SubmapLoopCloser.rebuild_grids, maps_mod.render_map)
        grid_mod.insert_rays = self.insert
        SubmapLoopCloser.precompute = self.tag("precompute", saved[1])
        SubmapLoopCloser.rebuild_grids = self.tag("rebuild_grids", saved[2])
        maps_mod.render_map = self.tag("map", saved[3])
        try:
            yield self
        finally:
            (grid_mod.insert_rays, SubmapLoopCloser.precompute,
             SubmapLoopCloser.rebuild_grids, maps_mod.render_map) = saved


class Tee(io.TextIOBase):
    """Write to the real stdout and keep a copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def decision_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("[match]", "[chain]", "[kfpin]", "[rematch]"))]


def first_decision_difference(got, ref, printed=None):
    """Index and pair of the first decision line that differs (MISS
    scores compared at MISS_SCORE_ATOL; a printed zero's sign, -0.000
    against +0.000, is not a difference; `printed` maps a 1-based line
    number to a field whose printed number may be one unit of its last
    digit apart there), or None."""
    num = re.compile(r"best=([0-9.eE+-]+)")
    zero = re.compile(r"-(0\.0+)(?![0-9])")
    for k in range(max(len(got), len(ref))):
        a = zero.sub(r"+\1", got[k]) if k < len(got) else "<missing>"
        b = zero.sub(r"+\1", ref[k]) if k < len(ref) else "<missing>"
        field = (printed or {}).get(k + 1)
        if field is not None:
            pat = re.compile(rf"\b{field}=([0-9]+\.([0-9]+))")
            fa, fb = pat.search(a), pat.search(b)
            if fa and fb and len(fa.group(2)) == len(fb.group(2)) and abs(
                    float(fa.group(1)) - float(fb.group(1))
            ) <= 1.5 * 10.0 ** -len(fb.group(2)):
                a, b = pat.sub(f"{field}=*", a), pat.sub(f"{field}=*", b)
        ma, mb = num.search(a), num.search(b)
        if ma and mb and num.sub("", a) == num.sub("", b):
            if abs(float(ma.group(1)) - float(mb.group(1))) <= MISS_SCORE_ATOL:
                continue
        elif a == b:
            continue
        return {"index": k, "got": a, "reference": b}
    return None


def compare_run(world, text, result_path):
    """A full run of `world` (its standard output under
    SLAM_LOG_MATCHES=1 and the .result it wrote) against the JAX
    package's CPU run (WORLDS[world], data/<world>-full.*). Returns the
    readings; "problems" lists every way the run differs: the
    `backend:`/`closures:` lines, the decision lines, the ATE line, the
    .result beyond FULL_RESULT_ATOL."""
    ref = WORLDS[world]
    lines = text.splitlines()

    def line_of(prefix):
        return next((ln for ln in lines if ln.startswith(prefix)), "")

    decisions = decision_lines(text)
    stem = os.path.join(DATA, ref.get("reference", f"{world}-full"))
    with open(f"{stem}.decisions") as fh:
        ref_decisions = fh.read().splitlines()
    first_diff = first_decision_difference(decisions, ref_decisions,
                                           ref.get("printed_fields"))
    times, poses = load_result(result_path)
    ref_times, ref_poses = load_result(f"{stem}.result")
    same_times = bool(np.array_equal(times, ref_times))
    d = poses - ref_poses if same_times else np.full((1, 3), np.inf)
    if same_times:
        d[:, 2] = wrap_angle(d[:, 2])
    result_err = float(np.abs(d).max())
    ate = line_of("ATE trans")
    problems = []
    for key, prefix in (("backend", "backend:"), ("closures", "closures:")):
        if line_of(prefix) != ref[key]:
            problems.append(f"{line_of(prefix)!r} != {ref[key]!r}")
    if first_diff is not None:
        problems.append(f"decision lines differ: {first_diff}")
    if ate != ref["ate"]:
        problems.append(f"ATE {ate!r} != {ref['ate']!r}")
    if not (same_times and result_err <= FULL_RESULT_ATOL):
        problems.append(f".result differs from the reference: times "
                        f"equal {same_times}, max |d| {result_err}")
    return {
        "world": world, "done_line": line_of("done:"),
        "backend_line": line_of("backend:"),
        "closures_line": line_of("closures:"), "ate": ate,
        "decisions": decisions, "reference_decisions": ref_decisions,
        "first_decision_difference": first_diff,
        "result_times_equal": same_times, "result_max_abs_err": result_err,
        "result_atol": FULL_RESULT_ATOL,
        "printed_fields_exempt": ref.get("printed_fields", {}),
        "parity_met": not problems,
        "problems": problems,
    }


class FusedQueryCounter:
    """Counts the fused matcher's candidate-set queries
    (match_candidates_fused calls) and the fused_match calls they made
    (matching.FUSED_CALLS, its pages), while active."""

    def __init__(self):
        self.queries = 0
        self.calls = 0
        self._orig = matching_mod.match_candidates_fused

    def _match(self, *a, **k):
        n = matching_mod.FUSED_CALLS
        try:
            return self._orig(*a, **k)
        finally:
            self.queries += 1
            self.calls += matching_mod.FUSED_CALLS - n

    @contextlib.contextmanager
    def active(self):
        matching_mod.match_candidates_fused = self._match
        try:
            yield self
        finally:
            matching_mod.match_candidates_fused = self._orig


class SolveRecorder:
    """Wraps the backend's two pose-graph solvers, its _solve and its
    match() to keep, for every solve, the match tick it ran in (1-based
    count of match() calls so far), the padded pose count, the route
    and its seconds (synchronized before and after: the backend reads
    every solve back to the host anyway), and for every blocked solve
    its graph and result on the host, to hold against the float64 C++
    solver afterwards."""

    def __init__(self):
        self.solves = []
        self.ticks = 0
        self.blocked_graphs = []

    def _solve(self, fn):
        def wrapped(closer, g, iterations, gnc_scale):
            n_blocked = sum(1 for s in self.solves if s[2] == "blocked")
            out = fn(closer, g, iterations, gnc_scale)
            if sum(1 for s in self.solves if s[2] == "blocked") > n_blocked:
                self.blocked_graphs.append((
                    {k: v.cpu() for k, v in g._asdict().items()},
                    closer.config.dcs_phi, iterations, gnc_scale,
                    out.poses.cpu().numpy()))
            return out
        return wrapped

    def native_error(self):
        """Largest |blocked - C++| (m/rad, angles wrapped) over the
        recorded blocked solves with a fixed DCS phi (the C++ solver has
        no GNC schedule), over valid poses; and how many were held."""
        err, held = 0.0, 0
        for fields, phi, iterations, gnc_scale, poses in self.blocked_graphs:
            if gnc_scale != 1.0:
                continue
            g = solvers_mod.PoseGraphData(**fields)
            d = poses - posegraph_gn_native(g, phi, iterations)
            d[:, 2] = wrap_angle(d[:, 2])
            err = max(err, float(np.abs(d[fields["valid"].numpy()]).max()))
            held += 1
        return err, held

    def _timed(self, route, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            n = a[0].poses.numel() // 3
            # the blocked solver's separator slots in use, their
            # capacity and the local slots per block
            seps = ((int(a[1].sep_valid.sum()), a[1].sep_valid.numel(),
                     a[0].loc_sep.shape[1]) if route == "blocked" else None)
            self.solves.append((self.ticks, n, route,
                                time.perf_counter() - t0, seps))
            return out
        return wrapped

    def _match(self, fn):
        def wrapped(*a, **k):
            self.ticks += 1
            return fn(*a, **k)
        return wrapped

    @contextlib.contextmanager
    def active(self):
        saved = (solvers_mod.optimize_pose_graph,
                 dist_solver.optimize_pose_graph_blocked,
                 SubmapLoopCloser.match, SubmapLoopCloser._solve)
        solvers_mod.optimize_pose_graph = self._timed("dense", saved[0])
        dist_solver.optimize_pose_graph_blocked = self._timed("blocked",
                                                              saved[1])
        SubmapLoopCloser.match = self._match(saved[2])
        SubmapLoopCloser._solve = self._solve(saved[3])
        try:
            yield self
        finally:
            (solvers_mod.optimize_pose_graph,
             dist_solver.optimize_pose_graph_blocked,
             SubmapLoopCloser.match, SubmapLoopCloser._solve) = saved

    def summary(self, min_poses):
        blocked = [s for s in self.solves if s[2] == "blocked"]
        secs = [s[3] for s in blocked]
        return {
            "solves": len(self.solves), "blocked_solves": len(blocked),
            "dense_solves_at_or_above_min": sum(
                1 for s in self.solves
                if s[2] == "dense" and s[1] >= min_poses),
            "first_blocked_tick": blocked[0][0] if blocked else None,
            "first_blocked_padded_n": blocked[0][1] if blocked else None,
            "padded_n_of_blocked": sorted({s[1] for s in blocked}),
            "last_blocked_S_capacity_K": blocked[-1][4] if blocked else None,
            "blocked_solve_ms_mean": (1e3 * float(np.mean(secs))
                                      if secs else None),
            "blocked_solve_ms_max": 1e3 * max(secs) if secs else None,
            "blocked_solve_s_total": float(np.sum(secs)),
            "dense_solve_s_total": float(sum(
                s[3] for s in self.solves if s[2] == "dense")),
        }


class CleanupRecorder:
    """Wraps SlamSystem.final_cleanup, SubmapLoopCloser.joint_solve and
    Frontend.relative_chain_info to keep the final cleanup's seconds,
    each joint solve's seconds (the card synchronized before and
    after), sizes and LM iterations (SchurCounter), and the number of
    marginal chain-information calls."""

    def __init__(self):
        self.cleanup_s = None
        self.joint = []
        self.chain_info_calls = 0

    def _cleanup(self, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.cleanup_s = time.perf_counter() - t0
        return wrapped

    def _joint(self, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with SchurCounter().active() as count:
                ran = fn(*a, **k)
            torch.cuda.synchronize()
            self.joint.append({"ran": ran, "s": time.perf_counter() - t0,
                               "iterations": count.calls,
                               "sizes": count.sizes})
            return ran
        return wrapped

    def _chain_info(self, fn):
        def wrapped(*a, **k):
            self.chain_info_calls += 1
            return fn(*a, **k)
        return wrapped

    @contextlib.contextmanager
    def active(self):
        saved = (SlamSystem.final_cleanup, SubmapLoopCloser.joint_solve,
                 Frontend.relative_chain_info)
        SlamSystem.final_cleanup = self._cleanup(saved[0])
        SubmapLoopCloser.joint_solve = self._joint(saved[1])
        Frontend.relative_chain_info = self._chain_info(saved[2])
        try:
            yield self
        finally:
            (SlamSystem.final_cleanup, SubmapLoopCloser.joint_solve,
             Frontend.relative_chain_info) = saved


def graph_sizes(g):
    """Padded and live sizes of a JointGraphData."""
    return {"P": g.poses.shape[0], "L": g.lms.shape[0],
            "E": g.obs_pose.shape[0], "C": g.clo_i.shape[0],
            "poses": int(g.pose_valid.sum()), "lms": int(g.lm_valid.sum()),
            "edges": int(g.obs_valid.sum()),
            "closures": int(g.clo_valid.sum())}


def set_slam_yaml(path, values):
    """Set each `key: value` of `values` in the dataset config at `path`:
    its line rewritten where the config has one, appended otherwise."""
    with open(path) as fh:
        text = fh.read()
    for key, value in values.items():
        text, n = re.subn(rf"^{re.escape(key)}:.*$", f"{key}: {value}", text,
                          flags=re.M)
        if n > 1:
            raise AssertionError(f"{path}: {n} lines set {key}")
        if not n:
            text = text.rstrip("\n") + f"\n{key}: {value}\n"
    with open(path, "w") as fh:
        fh.write(text)


def phase_full(world, phase, out_dir):
    """The full runner (backend on) on a temporary copy of
    datasets/<world> on cuda under SLAM_LOG_MATCHES=1, held against the
    JAX package's CPU run (WORLDS). Every insertion is replayed through
    the plain twin; every pose-graph solve is recorded. Returns
    (kernel launches, recorded insertions)."""
    ref = WORLDS[world]
    dataset = ref.get("dataset", world)
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{world}_")
    os.makedirs(out_dir, exist_ok=True)
    try:
        data = os.path.join(tmp, dataset)
        shutil.copytree(os.path.join(REPO, "datasets", dataset), data)
        set_slam_yaml(os.path.join(data, "slam.yaml"),
                      ref.get("slam_yaml", {}))
        png = os.path.join(tmp, "map.png")
        rec = InsertRecorder()
        solves = SolveRecorder()
        refines = RefineRecorder()
        pins = PinRecorder()
        cleanup = CleanupRecorder()
        tee = Tee(sys.stdout)
        queries = FusedQueryCounter()
        os.environ["SLAM_LOG_MATCHES"] = "1"
        grid_cuda.reset_launches(grid_cuda.insert_rays_cuda,
                                 refine_cuda.refine_cuda,
                                 refine_cuda.refine_pins_cuda)
        t0 = time.perf_counter()
        try:
            with rec.active(), solves.active(), refines.active(), \
                    pins.active(), cleanup.active(), queries.active(), \
                    (mesh_hooks(ref["mesh"]) if ref.get("mesh")
                     else contextlib.nullcontext({})) as meshed, \
                    contextlib.redirect_stdout(tee):
                r = runner.run([
                    "--dataset-dir", data, "--dataset-name", dataset,
                    "--eval", "--map-png", png, "--device", "cuda",
                ] + (["--accel-branch"] if ref.get("accel") else []))
            torch.cuda.synchronize()
        finally:
            del os.environ["SLAM_LOG_MATCHES"]
        total_s = time.perf_counter() - t0
        launches = grid_cuda.insert_rays_cuda.launches
        refine_launches = refine_cuda.refine_cuda.launches
        pins_launches = refine_cuda.refine_pins_cuda.launches
        cmp = compare_run(world, tee.buf.getvalue(),
                          os.path.join(data, f"{dataset}.result"))
        decisions = cmp.pop("decisions")
        ref_decisions = cmp.pop("reference_decisions")
        log_path = os.path.join(out_dir, f"{world}.decisions.log")
        with open(log_path, "w") as fh:
            fh.write("\n".join(decisions) + "\n")

        # every grid build and every refinement of the run against
        # the plain versions
        by_phase = {}
        unequal = []
        for k, (ph, args, out) in enumerate(rec.calls):
            by_phase[ph] = by_phase.get(ph, 0) + int(out.is_cuda)
            if not torch.equal(out, insert_rays_plain(*args)):
                unequal.append((k, ph))
        t1 = time.perf_counter()
        replay = replay_refinements(refines.calls)
        replay["refine_replay_s"] = time.perf_counter() - t1
        refine_unequal = replay["refine_calls_unequal"]
        pins_replay = replay_pins(pins.calls)

        sysm = r.system
        be = sysm.backend
        counts = {
            "frames": r.n_frames, "keyframes": len(sysm.frontend.keyframes),
            "landmarks": len(sysm.frontend.landmarks),
            "submaps": be.submap_count, "loop_closures": be.closure_count,
            "pruned": be.false_closure_count,
            "local_edges": be.local_edge_count,
            "kf_pins": be.kf_edge_count,
        }
        ft = np.asarray(sysm.frontend_times)
        bt = np.asarray(sysm.backend_times)
        solve_info = solves.summary(sysm.config.dist_solver_min_poses)
        (solve_info["blocked_max_abs_err_native"],
         solve_info["blocked_solves_held_native"]) = solves.native_error()
        solve_info["blocked_native_atol"] = RUN_BLOCKED_NATIVE_ATOL
        problems = cmp.pop("problems")
        if ref.get("parity") == "reported":
            # compare_run's readings stay in the line; only the kernels'
            # replays, the launches and held_counts are held
            cmp["parity_problems"], problems = problems, []
        if (launches != sum(ref["launches"].values())
                or by_phase != ref["launches"]):
            problems.append(f"{launches} insertion launches {by_phase}, "
                            f"expected {ref['launches']}")
        if unequal:
            problems.append(f"grid builds differ from the plain twin: "
                            f"{unequal[:5]}")
        if not refine_launches or refine_launches != len(refines.calls):
            problems.append(f"{refine_launches} refinement launches for "
                            f"{len(refines.calls)} refinements")
        if refine_unequal:
            problems.append(f"refinements differ from the plain version: "
                            f"{refine_unequal[:5]}")
        if pins_launches != len(pins.calls):
            problems.append(f"{pins_launches} batched refinement launches "
                            f"for {len(pins.calls)} pin batches")
        if bool(ref.get("accel")) != bool(pins.calls):
            problems.append(f"{len(pins.calls)} device pin batches")
        if pins_replay["pins_calls_unequal"]:
            problems.append(f"pin batches differ from the batched plain "
                            f"version: "
                            f"{pins_replay['pins_calls_unequal'][:5]}")
        if ref.get("mesh") and not (meshed["sharded_solves"]
                                    and meshed["sharded_searches"]):
            problems.append(f"the mesh hooks did not route the run: "
                            f"{meshed}")
        for key in ref.get("held_counts", counts):
            if counts[key] != ref["counts"][key]:
                problems.append(f"{key} {counts[key]} != "
                                f"{ref['counts'][key]}")
        if solve_info["dense_solves_at_or_above_min"]:
            problems.append("a pose graph at or above dist_solver_min_poses "
                            "took the dense solver")
        if world == "sim-killian" and not solve_info["blocked_solves"]:
            problems.append("no solve took the blocked solver")
        if not (solve_info["blocked_max_abs_err_native"]
                <= RUN_BLOCKED_NATIVE_ATOL):
            problems.append(f"a blocked solve differs from the C++ solver "
                            f"on its graph by "
                            f"{solve_info['blocked_max_abs_err_native']}")
        if not os.path.getsize(png):
            problems.append("empty map PNG")
        if ref.get("joint") and not (cleanup.joint
                                     and all(j["ran"] for j in cleanup.joint)):
            problems.append(f"final_joint: the joint solve did not run "
                            f"({cleanup.joint})")
        if not ref.get("joint") and cleanup.joint:
            problems.append("a joint solve ran without final_joint")
        if bool(ref.get("marginal")) != bool(cleanup.chain_info_calls):
            problems.append(f"{cleanup.chain_info_calls} marginal "
                            f"chain-information calls")
        if bool(ref.get("accel")) != bool(queries.queries):
            problems.append(f"{queries.queries} fused-matcher queries")
        prof_s = {k: be.prof[k] for k in (
            "kf_edges", "kf_stack", "kf_window", "kf_accept", "grid_build",
            "chain_edges", "match_snapshot", "match_search",
            "match_correlate", "match_refine", "match_apply",
            "refine_map")}
        emit({
            "phase": phase, **cmp, **counts,
            "kernel_launches": launches, "launches_by_phase": by_phase,
            "grid_builds_replayed": len(rec.calls),
            "grid_builds_unequal": unequal,
            "refine_launches": refine_launches,
            "refine_calls": len(refines.calls),
            "refine_calls_replayed": len(refines.calls), **replay,
            "pins_launches": pins_launches, "pin_batches": len(pins.calls),
            **pins_replay, **meshed,
            "decision_lines": len(decisions), "decision_log": log_path,
            "problems": problems,
            **solve_info,
            "frame_loop_s": r.wall_s, "fps": r.n_frames / r.wall_s,
            "final_cleanup_s": cleanup.cleanup_s,
            "joint_solves": cleanup.joint,
            "joint_ms_per_iteration": [
                1e3 * j["s"] / j["iterations"] for j in cleanup.joint
                if j["iterations"]],
            "chain_info_calls": cleanup.chain_info_calls,
            "total_s": total_s,
            "frontend_mean_ms": float(ft.mean() * 1e3),
            "frontend_max_ms": float(ft.max() * 1e3),
            "frontend_ticks": len(ft),
            "backend_mean_ms": float(bt.mean() * 1e3),
            "backend_max_ms": float(bt.max() * 1e3),
            "backend_ticks": len(bt),
            "prof_s": prof_s,
            "fused_queries": queries.queries,
            "fused_calls": queries.calls,
            "fused_calls_per_query": queries.calls / max(queries.queries, 1),
        })
        return {"launches": launches, "insertions": rec.calls,
                "refine_launches": refine_launches, "replay": replay,
                "pins_launches": pins_launches, "pins_replay": pins_replay,
                "frontend_ms": ft * 1e3,
                "split": {**prof_s, "final_cleanup": cleanup.cleanup_s,
                          "frame_loop": r.wall_s},
                "problems": [f"{world}: " + "; ".join(problems)]
                if problems else []}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tick_stats(ms):
    """Mean, 99th percentile and max of tick times in ms, and their
    count."""
    ms = np.asarray(ms, dtype=np.float64)
    if not len(ms):
        return {"n": 0}
    return {"mean": float(ms.mean()), "p99": float(np.percentile(ms, 99)),
            "max": float(ms.max()), "n": len(ms)}


def realtime_invariants(system, result_path):
    """The realtime CPU test's invariants (tests/test_torch_live.py):
    finite estimates, aligned pose-graph arrays, finite closures with
    endpoints inside the chain, a finite .result whose times never go
    back. Returns the broken ones."""
    fe, be = system.frontend, system.backend
    est = fe.estimates()
    problems = []
    if not np.isfinite(est).all():
        problems.append("non-finite keyframe estimates")
    if not len(be.pg_poses) == len(be.pg_meas) == len(be.pg_info):
        problems.append("pose-graph arrays not aligned")
    if len(be.pg_poses) > len(est):
        problems.append("more pose-graph vertices than keyframes")
    if be.pg_poses and not np.isfinite(np.stack(be.pg_poses)).all():
        problems.append("non-finite pose-graph vertices")
    for c in be.closures:
        if not (0 <= c.i < len(est) and 0 <= c.j < len(est)
                and np.isfinite(c.meas).all()):
            problems.append(f"closure {c.i}->{c.j} outside the chain or "
                            f"non-finite")
            break
    times, poses = load_result(result_path)
    if not (np.isfinite(poses).all() and (np.diff(times) >= 0).all()):
        problems.append(".result non-finite or not monotone")
    return problems


def phase_realtime(world, rate, out_dir, batch_ms, frames=None):
    """The runner's simulated-realtime mode on a temporary copy of
    datasets/<world> on cuda: the frontend paced at the log's timestamps
    over `rate`, the backend thread free-running on its own stream, the
    live view rendering at 2 Hz on another and a map dumped every 100
    frames (--realtime --rate R --map-every 100 --live-view 2 --eval
    --map-png). Every insertion and refinement of the backend and main
    threads is replayed through its plain version (torch.equal each),
    and LIVE_VIEW_REPLAYS of the live view's map renders, evenly spaced,
    the first and last among them: the plain version inserts a map scan
    by scan, ~0.6 s a render on sim-office, which has ~320 of them, and
    seconds on sim-killian, which has ~1,850. Prints the
    frontend tick (mean, p99, max) against `batch_ms` (the same world's
    batch run in this call), the late frames, the backend ticks, the
    run's `backend:`/`closures:`/ATE lines (reported, not held: which
    snapshot the backend sees depends on timing), launches by thread
    and the live view's renders and render errors. Fails on a thread's
    exception, a render error, a broken invariant (realtime_invariants)
    or a frame not processed. `frames` cuts the log to its first frames
    (the runner's --max-frames)."""
    dataset = WORLDS[world].get("dataset", world)
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_rt_{world}_")
    try:
        data = os.path.join(tmp, dataset)
        shutil.copytree(os.path.join(REPO, "datasets", dataset), data)
        n_log = sum(1 for _ in open(os.path.join(data, f"{dataset}.log")))
        if frames:
            n_log = min(n_log, frames)
        png = os.path.join(tmp, "map.png")
        rec, refines, tee = InsertRecorder(), RefineRecorder(), Tee(
            sys.stdout)
        grid_cuda.reset_launches(grid_cuda.insert_rays_cuda,
                                 refine_cuda.refine_cuda)
        problems, r = [], None
        t0 = time.perf_counter()
        try:
            with rec.active(), refines.active(), \
                    contextlib.redirect_stdout(tee):
                r = runner.run([
                    "--dataset-dir", data, "--dataset-name", dataset,
                    "--realtime", "--rate", str(rate), "--map-every", "100",
                    "--live-view", "2", "--eval", "--map-png", png,
                    "--device", "cuda",
                ] + (["--max-frames", str(frames)] if frames else []))
        except Exception as e:  # a thread's exception ends the run
            problems.append(f"the run raised {e!r}")
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        # read before the replays, whose timing launches the kernels too
        launches = {
            "insert_rays": dict(grid_cuda.insert_rays_cuda.launches_by_thread),
            "refine_pose": dict(refine_cuda.refine_cuda.launches_by_thread)}
        live_maps = [k for k, name in enumerate(rec.call_threads)
                     if name == LIVE_VIEW_THREAD]
        keep = np.linspace(0, len(live_maps) - 1,
                           min(LIVE_VIEW_REPLAYS, len(live_maps))).round()
        skip = set(live_maps) - {live_maps[int(i)] for i in keep}
        unequal = [k for k, (_, args, out) in enumerate(rec.calls)
                   if k not in skip
                   and not torch.equal(out, insert_rays_plain(*args))]
        replay = replay_refinements(refines.calls)
        text = tee.buf.getvalue()
        lines = text.splitlines()

        def line_of(prefix):
            return next((ln for ln in lines if ln.startswith(prefix)), "")

        reading = {"phase": f"realtime_{world}", "world": world,
                   "rate": rate, "log_frames": n_log}
        if r is not None:
            sysm, rt, live = r.system, r.system.realtime, r.live
            dumps = sorted(f for f in os.listdir(tmp)
                           if re.fullmatch(r"map-\d{5}\.png", f))
            reading.update({
                "frames": r.n_frames, "frames_processed": sysm.frame_idx,
                "frame_loop_s": r.wall_s,
                "frontend_ms": tick_stats(np.asarray(sysm.frontend_times)
                                          * 1e3),
                "batch_frontend_ms": tick_stats(batch_ms),
                "late_frames": rt.late,
                "lag_s": {"mean": float(np.mean(rt.lags)),
                          "max": float(np.max(rt.lags))},
                "backend_ticks": len(rt.backend_ticks),
                "backend_tick_ms": tick_stats(np.asarray(rt.backend_ticks)
                                              * 1e3),
                "live_renders": live.renders, "render_errors": live.errors,
                "map_dumps": dumps,
            })
            if sysm.frame_idx != n_log or r.n_frames != n_log:
                problems.append(f"{sysm.frame_idx} of {n_log} frames "
                                f"processed")
            if live.errors:
                problems.append(f"{live.errors} render errors")
            if len(dumps) != n_log // 100:
                problems.append(f"map dumps {dumps}")
            problems += realtime_invariants(
                sysm, os.path.join(data, f"{dataset}.result"))
        if unequal:
            problems.append(f"insertions differ from the plain version: "
                            f"{unequal[:5]}")
        if replay["refine_calls_unequal"]:
            problems.append(f"refinements differ from the plain version: "
                            f"{replay['refine_calls_unequal'][:5]}")
        if sum(launches["insert_rays"].values()) != len(rec.calls):
            problems.append(f"insertion launches {launches} for "
                            f"{len(rec.calls)} insertions")
        if sum(launches["refine_pose"].values()) != len(refines.calls):
            problems.append(f"refinement launches {launches} for "
                            f"{len(refines.calls)} refinements")
        reading.update({
            "done_line": line_of("done:"), "backend_line": line_of("backend:"),
            "closures_line": line_of("closures:"),
            "ate": line_of("ATE trans"), "realtime_line": line_of("realtime:"),
            "live_line": line_of("live view:"),
            "launches_by_thread": launches,
            "insertions_by_thread": rec.threads,
            "refinements_by_thread": refines.threads,
            "insertions_replayed": len(rec.calls) - len(skip),
            "live_view_insertions": len(live_maps),
            "live_view_insertions_replayed": len(live_maps) - len(skip),
            "insertions_unequal": unequal,
            "refinements_replayed": len(refines.calls),
            "refine_calls_unequal": replay["refine_calls_unequal"],
            "total_s": total_s, "problems": problems,
        })
        emit(reading)
        with open(os.path.join(out_dir, f"realtime_{world}.log"), "w") as fh:
            fh.write(text)
        return {"launches": sum(launches["insert_rays"].values()),
                "refine_launches": sum(launches["refine_pose"].values()),
                "replay": replay,
                "problems": [f"realtime {world}: " + "; ".join(problems)]
                if problems else []}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the default realtime phase's depth: sim-office's first 330 of 663
# frames (the first half of the log), a cut that keeps the default
# run well under its 1,200 s with the beams4 and mesh phases (PERF.md)
REALTIME_FRAMES = 330
# the live view's map renders of a realtime run replayed through the
# plain version (phase_realtime), and the name of its thread
LIVE_VIEW_REPLAYS = 12
LIVE_VIEW_THREAD = "slam-live-view"

RESUME_CHECKPOINT = os.path.join(DATA, "sim-office-ckpt330.npz")
RESUME_RUN = os.path.join(DATA, "sim-office-ckpt330-run.npz")
# the JAX package's own checkpoint test's tolerance
# (tests/test_checkpoint_and_system.py)
RESUME_ATOL = 1e-6


def resume_continuations(device, save_path):
    """The JAX package's checkpoint of sim-office at frame 330
    (scripts/make_office_checkpoint.py) loaded into the port on
    `device` (the grids rebuilt by Backend.precompute), the runner
    fields it leaves out set from the sidecar, and continued 60 frames;
    and the loaded state saved by the port to `save_path`, loaded again
    and continued the same 60 frames. Returns the readings: the largest
    differences of each continuation's keyframe and pose-graph
    estimates from the JAX package's (which saved, loaded and continued
    the same way), and of the second continuation's keyframe estimates
    from the first's. (The second load adds a chain edge to those saved,
    in both packages, so the two pose graphs differ: ROADMAP.md,
    section 3.)"""
    from sparse_gslam_tpu_torch.io.providers import create_data_provider
    from sparse_gslam_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from sparse_gslam_tpu_torch.utils.config import load_dataset_config

    with np.load(RESUME_RUN) as z:
        run = {k: z[k] for k in z.files}
    cut, n = int(run["cut"]), int(run["continue_frames"])
    frames = list(create_data_provider(
        "carmen", os.path.join(DATASET, "sim-office.log")).frames())

    def resumed(path):
        s = SlamSystem(*load_dataset_config(DATASET), device=device)
        load_checkpoint(path, s)
        s.frame_idx = int(run["frame_idx"])
        s.deltas = list(run["deltas"])
        s.zero_pose = run["zero_pose"].copy()
        s.last_pose = run["last_pose"].copy()
        s.mc._cloud_odom = run["cloud_odom"].copy()
        return s

    first = resumed(RESUME_CHECKPOINT)
    save_checkpoint(save_path, first)
    second = resumed(save_path)
    for fr in frames[cut:cut + n]:
        first.process_frame(fr)
        second.process_frame(fr)

    def diff(a, b):
        return (float(np.abs(a - b).max()) if a.shape == b.shape
                else float("inf"))

    out = {"atol": RESUME_ATOL}
    for name, s in (("", first), ("second_", second)):
        est, pg = s.frontend.estimates(), s.backend.pose_estimates()
        out.update({
            f"{name}keyframes": len(est),
            f"{name}submaps": s.backend.submap_count,
            f"{name}loop_closures": s.backend.closure_count,
            f"{name}estimates_max_abs_err": diff(
                est, run[f"{name}estimates"]),
            f"{name}pg_max_abs_err": diff(pg, run[f"{name}pg_estimates"]),
        })
    out["reference"] = {k: int(run[k]) for k in (
        "submaps", "closures", "second_submaps", "second_closures")}
    out["reference"]["keyframes"] = len(run["estimates"])
    out["second_estimates_max_abs_diff"] = diff(
        second.frontend.estimates(), first.frontend.estimates())
    out["second_pg_max_abs_diff"] = diff(second.backend.pose_estimates(),
                                         first.backend.pose_estimates())
    return out


def resume_problems(reading):
    """Where resume_continuations' readings miss the JAX package's:
    counts unequal, or estimates beyond RESUME_ATOL (the two
    continuations' keyframe estimates also of each other)."""
    ref = reading["reference"]
    problems = []
    for key in ("estimates_max_abs_err", "pg_max_abs_err",
                "second_estimates_max_abs_err", "second_pg_max_abs_err",
                "second_estimates_max_abs_diff"):
        if not reading[key] <= RESUME_ATOL:
            problems.append(f"{key} {reading[key]}")
    for key, ref_key in (("keyframes", "keyframes"),
                         ("second_keyframes", "keyframes"),
                         ("submaps", "submaps"),
                         ("second_submaps", "second_submaps"),
                         ("loop_closures", "closures"),
                         ("second_loop_closures", "second_closures")):
        if reading[key] != ref[ref_key]:
            problems.append(f"{key} {reading[key]} != {ref[ref_key]}")
    return problems


def phase_resume(out_dir):
    """resume_continuations on the card, every insertion of the two
    grid rebuilds and the continuations, and every refinement, replayed
    through the plain version (torch.equal each); fails on any of
    resume_problems."""
    rec, refines = InsertRecorder(), RefineRecorder()
    grid_cuda.reset_launches(grid_cuda.insert_rays_cuda,
                             refine_cuda.refine_cuda)
    t0 = time.perf_counter()
    with rec.active(), refines.active():
        reading = resume_continuations(
            "cuda", os.path.join(out_dir, "resume-port.npz"))
    torch.cuda.synchronize()
    # read before the replays, whose timing launches the kernels too
    launches = grid_cuda.insert_rays_cuda.launches
    refine_launches = refine_cuda.refine_cuda.launches
    unequal = [k for k, (_, args, out) in enumerate(rec.calls)
               if not torch.equal(out, insert_rays_plain(*args))]
    replay = replay_refinements(refines.calls)
    problems = resume_problems(reading)
    if not rec.calls or unequal:
        problems.append(f"{len(rec.calls)} insertions, unequal {unequal[:5]}")
    if replay["refine_calls_unequal"]:
        problems.append(f"refinements differ from the plain version: "
                        f"{replay['refine_calls_unequal'][:5]}")
    if launches != len(rec.calls):
        problems.append(f"{launches} insertion launches for "
                        f"{len(rec.calls)} insertions")
    if refine_launches != len(refines.calls):
        problems.append(f"{refine_launches} refinement launches for "
                        f"{len(refines.calls)} refinements")
    emit({"phase": "resume", **reading, "insertion_launches": launches,
          "insertions_by_phase": {
              ph: sum(1 for c in rec.calls if c[0] == ph)
              for ph in {c[0] for c in rec.calls}},
          "insertions_unequal": unequal,
          "refine_launches": refine_launches,
          "refine_calls_unequal": replay["refine_calls_unequal"],
          "seconds": time.perf_counter() - t0, "problems": problems})
    return {"launches": launches, "refine_launches": refine_launches,
            "replay": replay,
            "problems": ["resume: " + "; ".join(problems)] if problems
            else []}


# the fused phase's seeded cases at sim-office's sizes: score grids of
# G = 320 cells at 0.1 m (F = 384), R = 225 rotations (range_max 10 m,
# 1 rad each side), +-5 m (n_linear 50), stride 16 (depth 5), K = 256
# planes a call; FUSED_CANDIDATES candidates (a chunk of 16 and one of
# 2) and a query of FUSED_POINTS points (padded to 512); the paging case
# at FUSED_PAGE_K planes a call; the pins: a batch of 8 (6 live), R = 65
# (0.2 rad), +-0.8 m (n_linear 8), N = 512, high-res G = 576 at 0.05 m,
# a stack of 32 submaps
FUSED_CANDIDATES = 18
FUSED_POINTS = 400
FUSED_PAGE_K = 64
FUSED_SCORE_ATOL = 1e-5
FUSED_BOUND_RTOL = 1e-6
FUSED_COV_RTOL, FUSED_COV_ATOL = 1e-3, 1e-5
PIN_WCOV_ATOL = 5e-6


def walls_grid(rng, G, res, origin, segs):
    """(G, G) float32 probabilities: 0.15 inside the walls' box, 0.9 on
    the wall segments `segs` (n, 2, 2) (sampled every res / 4), 0
    (unknown) outside."""
    g = np.zeros((G, G), np.float32)
    lo = int(2.0 / res)
    g[lo:G - lo, lo:G - lo] = 0.15
    for a, b in segs:
        t = np.linspace(0.0, 1.0, int(np.linalg.norm(b - a) / res * 4) + 2)
        p = a + t[:, None] * (b - a)
        c = np.floor((p - origin) / res).astype(int)
        ok = ((c >= 0) & (c < G)).all(1)
        g[c[ok, 0], c[ok, 1]] = 0.9
    return g


def fused_inputs(seed=0):
    """Host (numpy) inputs of the fused phase: per submap its wall
    segments' score grid (G = 320) and high-res grid (G = 576), the
    query drawn from the last candidate's walls, and the pin batch."""
    rng = np.random.default_rng(seed)
    M = 32
    origin, high_origin = np.array([-16.0, -16.0]), np.array([-14.4, -14.4])
    grids, highs, walls = [], [], []
    for _ in range(M):
        segs = []
        for _ in range(14):
            a = rng.uniform(-11, 11, 2)
            d = rng.uniform(2, 8) * (np.array([1, 0]) if rng.random() < 0.5
                                     else np.array([0, 1]))
            segs.append((a, a + d))
        walls.append(segs)
        grids.append(walls_grid(rng, 320, 0.1, origin, segs))
        highs.append(walls_grid(rng, 576, 0.05, high_origin, segs))

    def on_walls(segs, n):
        a = np.array([s[0] for s in segs])
        b = np.array([s[1] for s in segs])
        k = rng.integers(0, len(segs), n)
        t = rng.uniform(0, 1, n)[:, None]
        return a[k] + t * (b[k] - a[k]) + rng.normal(0, 0.02, (n, 2))

    th, shift = 0.04, np.array([0.42, -0.31])
    c, s_ = np.cos(-th), np.sin(-th)
    query = ((on_walls(walls[FUSED_CANDIDATES - 1], FUSED_POINTS) - shift)
             @ np.array([[c, -s_], [s_, c]]).T).astype(np.float32)
    B, N, R = 8, 512, 65
    pins = dict(pts=np.zeros((B, N, 2), np.float32),
                val=np.zeros((B, N), bool), orgs=np.zeros((B, 2), np.float32),
                seeds=np.zeros((B, 3), np.float32),
                ths=np.zeros((B, R), np.float32),
                ids=rng.integers(0, M, B), live=np.arange(B) < 6)
    for k in range(6):
        n = int(rng.integers(120, N))
        pins["pts"][k, :n] = on_walls(walls[pins["ids"][k]], n)
        pins["val"][k, :n] = True
        pins["seeds"][k] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                            rng.uniform(-0.05, 0.05)]
        pins["orgs"][k] = origin - pins["seeds"][k, :2]
        pins["ths"][k] = (pins["seeds"][k, 2]
                          + (np.arange(R) - R // 2) * 0.01)
    return dict(grids=np.stack(grids), highs=np.stack(highs),
                origin=origin.astype(np.float32),
                high_origin=high_origin.astype(np.float32), query=query,
                th0=list(rng.uniform(-0.05, 0.05, FUSED_CANDIDATES)),
                pins=pins)


def fused_calls(inp, device):
    """The fused phase's calls through the port on `device`: one
    fused_match (the first chunk), match_candidates_fused over every
    candidate at K = 256 and at FUSED_PAGE_K, pin_eval_batch. Returns
    (host results, fused_match calls of each query, the callables,
    each first call's wall ms)."""
    dev = torch.device(device)
    f32 = torch.float32
    spec = matching_mod.search_spec(5.0, 1.0, 10.0, 0.1)
    probs = torch.from_numpy(inp["grids"]).to(dev)
    pyr = [precompute_pyramid(p, 5) for p in probs]
    sg = [p[0] for p in pyr]
    pooled = [p[4] for p in pyr]
    spectra = matching_mod.grid_spectrum(torch.stack(sg), 384, 320)
    org = torch.from_numpy(inp["origin"]).to(dev)
    C = FUSED_CANDIDATES
    origins = [org] * C
    R = 2 * spec.n_angular + 1
    ks = np.arange(R) - spec.n_angular
    thetas = torch.from_numpy(np.stack([
        (t + ks * spec.angular_step).astype(np.float32)
        for t in inp["th0"][:16]])).to(dev)
    pts = np.zeros((512, 2), np.float32)
    pts[:FUSED_POINTS] = inp["query"]
    pts_d = torch.from_numpy(pts).to(dev)
    valid = torch.from_numpy(np.arange(512) < FUSED_POINTS).to(dev)

    def one_call():
        return matching_mod.fused_match(
            torch.stack(sg[:16]), torch.stack(pooled[:16]),
            torch.stack(origins[:16]), thetas,
            torch.ones(16, dtype=torch.bool, device=dev), pts_d, valid,
            torch.tensor(inp["th0"][:16], dtype=f32, device=dev),
            np.float32(spec.angular_step), np.float32(0.7), 0.1,
            int(spec.n_linear), 320, 384, 16, 256, spectra=spectra[:16])

    def query(K):
        return matching_mod.match_candidates_fused(
            sg[:C], pooled[:C], origins, inp["th0"], inp["query"], spec,
            0.7, 16,
            K=K, spectra_list=list(spectra[:C]))

    pins = {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in inp["pins"].items()}
    high = torch.from_numpy(inp["highs"]).to(dev)
    high_org = torch.from_numpy(np.tile(inp["high_origin"], (32, 1))).to(dev)

    def pin_batch():
        return matching_mod.pin_eval_batch(
            spectra, high, high_org, pins["ids"], pins["orgs"],
            pins["seeds"], pins["pts"], pins["val"], pins["ths"],
            pins["live"], resolution=0.1, n_linear=8, size=320,
            fft_size=384)

    fns = {"fused_match": one_call, "query_k256": lambda: query(256),
           f"query_k{FUSED_PAGE_K}": lambda: query(FUSED_PAGE_K),
           "pin_eval_batch": pin_batch}
    out, pages, first_ms = {}, {}, {}
    for key, fn in fns.items():
        n = matching_mod.FUSED_CALLS
        t0 = time.perf_counter()
        r = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        first_ms[key] = (time.perf_counter() - t0) * 1e3
        if key == "fused_match":
            r = [o.cpu().numpy() if isinstance(o, torch.Tensor) else o
                 for o in r]
        elif key == "pin_eval_batch":
            r = r.cpu().numpy()
        else:
            pages[key] = matching_mod.FUSED_CALLS - n
        out[key] = r
    return out, pages, fns, first_ms


def wall_ms(fn, reps=3):
    """Mean wall ms of fn() on the card (synchronized; the calls read
    their results on the host)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def fused_problems(card, host):
    """Every way the card's fused-phase results differ from the host
    CPU's beyond the stated tolerances."""
    problems = []
    a, b = card["fused_match"], host["fused_match"]
    if abs(float(a[0]) - float(b[0])) > FUSED_SCORE_ATOL:
        problems.append(f"fused_match score {a[0]} != {b[0]}")
    if not np.array_equal(a[1], b[1]) or a[3] != b[3]:
        problems.append(f"fused_match pose/candidate {a[1]} {a[3]} != "
                        f"{b[1]} {b[3]}")
    if not np.allclose(a[2], b[2], rtol=FUSED_COV_RTOL,
                       atol=FUSED_COV_ATOL):
        problems.append("fused_match covariance differs")
    if not np.allclose(a[6], b[6], rtol=FUSED_BOUND_RTOL, atol=0):
        problems.append("fused_match bounds differ")
    for key in card:
        if not key.startswith("query"):
            continue
        x, y = card[key], host[key]
        if x[0] != y[0] or (x[0] is not None and (
                abs(x[1] - y[1]) > FUSED_SCORE_ATOL
                or not np.array_equal(x[2], y[2])
                or not np.allclose(x[3], y[3], rtol=FUSED_COV_RTOL,
                                   atol=FUSED_COV_ATOL))):
            problems.append(f"{key}: {x[:3]} != {y[:3]}")
    p, q = card["pin_eval_batch"], host["pin_eval_batch"]
    if (np.abs(p[:, 0] - q[:, 0]).max() > FUSED_SCORE_ATOL
            or not np.array_equal(p[:, 1:4], q[:, 1:4])
            or np.abs(p[:, 4:13] - q[:, 4:13]).max() > PIN_WCOV_ATOL
            or not np.array_equal(p[:, 13:], q[:, 13:])):
        problems.append("pin_eval_batch rows differ")
    return problems


def phase_fused():
    """The accelerator branch's torch ops at sim-office's sizes on the
    card against the same calls through the port on the host CPU."""
    inp = fused_inputs()
    card, card_pages, card_fns, card_first_ms = fused_calls(inp, "cuda")
    host, host_pages, _, host_ms = fused_calls(inp, "cpu")
    problems = fused_problems(card, host)
    if card_pages[f"query_k{FUSED_PAGE_K}"] <= 2:
        problems.append("the paging query did not page")
    ms = {k: wall_ms(fn) for k, fn in card_fns.items()}
    q = card["query_k256"]
    emit({"phase": "fused", "ms": ms, "first_call_ms": card_first_ms,
          "host_cpu_ms": host_ms,
          "fused_calls_per_query": card_pages,
          "host_fused_calls_per_query": host_pages,
          "query": {"candidate": q[0], "score": q[1],
                    "pose": None if q[2] is None else q[2].tolist()},
          "pins_live": int(inp["pins"]["live"].sum()),
          "pin_scores": card["pin_eval_batch"][:, 0].tolist(),
          "tolerances": {"score_atol": FUSED_SCORE_ATOL,
                         "bound_rtol": FUSED_BOUND_RTOL,
                         "cov_rtol": FUSED_COV_RTOL,
                         "cov_atol": FUSED_COV_ATOL,
                         "pin_wcov_atol": PIN_WCOV_ATOL,
                         "pose, candidate, pin pose0 and "
                         "refinement": "equal"},
          "problems": problems})
    return {"launches": 0, "refine_launches": 0, "problems": problems}


def phase_blocked():
    """The keyframe-partitioned solver on the card on make_chain_graph
    graphs (BLOCKED_CASES, blocks of 128 poses), against the float64
    C++ solver on this machine's CPU at the same iteration count and,
    at the first size, against the dense solver on the card; GN
    iterations/s of both, with the separator slots S and the local
    slots K. Returns the rows."""
    rows = []
    for n, N, C in BLOCKED_CASES:
        fields, _ = make_chain_graph(n_poses=n, n_closures=C, pad_to=N,
                                     drift=0.005)
        g = to_pose_graph(fields, "cuda")
        plan = dist_solver.partition_of(g, N // 128)
        bg, sg = dist_solver.split_graph(g, plan)

        def solve():
            out = dist_solver.optimize_pose_graph_blocked(
                bg, sg, 1.0, BLOCKED_ITERS)
            torch.cuda.synchronize()
            return out

        solve()  # warm-up
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = solve()
            secs.append(time.perf_counter() - t0)
        got = got.reshape(-1, 3).cpu().numpy()
        posegraph_gn_native(g, 1.0, 1)  # builds and loads the library
        t0 = time.perf_counter()
        nat = posegraph_gn_native(g, 1.0, BLOCKED_ITERS)
        nat_s = time.perf_counter() - t0
        err_native = float(np.abs(got[:n] - nat[:n]).max())
        row = {
            "phase": "blocked", "N": N, "poses": n, "closures": C,
            "blocks": plan.n_blocks, "M": plan.block_size,
            "S": int(plan.sep_valid.sum()), "S_capacity": len(plan.sep_pose),
            "K": int(plan.loc_sep.shape[1]), "pairs": len(plan.pair_block),
            "iterations": BLOCKED_ITERS, "s_per_solve": min(secs),
            "s_per_solve_reps": secs,
            "gn_iters_per_s": BLOCKED_ITERS / min(secs),
            "native_s_per_solve": nat_s,
            "native_gn_iters_per_s": BLOCKED_ITERS / nat_s,
            "max_abs_err_native": err_native,
            "native_atol": BLOCKED_NATIVE_ATOL,
            "finite": bool(np.isfinite(got).all()),
        }
        problems = []
        if not row["finite"] or not err_native <= BLOCKED_NATIVE_ATOL:
            problems.append(f"blocked vs native max |d| {err_native}")
        if N == BLOCKED_CASES[0][1]:
            t0 = time.perf_counter()
            dense = solvers_mod.optimize_pose_graph(g, 1.0, DENSE_ITERS)
            dense = dense.poses.cpu().numpy()
            row["dense_iterations"] = DENSE_ITERS
            row["dense_s_per_solve"] = time.perf_counter() - t0
            row["max_abs_err_dense"] = float(np.abs(got[:n] - dense[:n]).max())
            row["dense_atol"] = BLOCKED_DENSE_ATOL
            if not row["max_abs_err_dense"] <= BLOCKED_DENSE_ATOL:
                problems.append(f"blocked vs dense max |d| "
                                f"{row['max_abs_err_dense']}")
        emit(row)
        if problems:
            raise AssertionError(f"blocked solver at N={N}: "
                                 + "; ".join(problems))
        rows.append(row)
    return rows


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_mesh():
    """The multi-device routes on the card. The sharded pose-graph
    solver (dist_solver.optimize_pose_graph_sharded) on in-process
    meshes of MESH_SHARDS shards (on this machine's cards in turn, all
    on cuda:0 where there is one) and through a one-rank NCCL group from
    multihost.initialize (the collectives' path with real NCCL calls), at
    BLOCKED_CASES' first chain, against the blocked solver on the card
    (MESH_BLOCKED_ATOL) and the float64 C++ solver on the host
    (BLOCKED_NATIVE_ATOL), with GN iterations/s of each; a two-process
    NCCL run (scripts/torch_dist_test_worker.py) where the machine has
    two or more cards, else a line that says it waits for one; the
    sharded candidate search (match_candidates_sharded) on the fused
    phase's seeded walls at sim-office's sizes against the pruned
    matcher on the card (the same candidate; score, pose and covariance
    within MESH_MATCH_*); graft_entry.dryrun_multichip at MESH_DRYRUNS
    shards. Returns the problems."""
    problems = []
    n, N, C = BLOCKED_CASES[0]
    fields, _ = make_chain_graph(n_poses=n, n_closures=C, pad_to=N,
                                 drift=0.005)
    g = to_pose_graph(fields, "cuda")
    plan = dist_solver.partition_of(g, N // 128)
    bg, sg = dist_solver.split_graph(g, plan)

    def timed_solve(fn):
        fn()  # warm-up
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out.reshape(-1, 3), min(secs)

    blocked, b_s = timed_solve(lambda: dist_solver.optimize_pose_graph_blocked(
        bg, sg, 1.0, BLOCKED_ITERS))
    nat = posegraph_gn_native(g, 1.0, BLOCKED_ITERS)
    row = {"phase": "mesh", "N": N, "poses": n, "closures": C,
           "blocks": plan.n_blocks, "iterations": BLOCKED_ITERS,
           "cards": torch.cuda.device_count(),
           "blocked_gn_iters_per_s": BLOCKED_ITERS / b_s, "sharded": {}}

    def hold(key, mesh):
        out, secs = timed_solve(
            lambda: dist_solver.optimize_pose_graph_sharded(
                bg, sg, 1.0, mesh, BLOCKED_ITERS))
        e_b = float((out - blocked).abs().max())
        e_n = float(np.abs(out.cpu().numpy()[:n] - nat[:n]).max())
        row["sharded"][key] = {
            "shards": mesh.size, "devices": [str(d) for d in mesh.devices],
            "processes": mesh.world, "gn_iters_per_s": BLOCKED_ITERS / secs,
            "s_per_solve": secs, "max_abs_err_blocked": e_b,
            "max_abs_err_native": e_n}
        if not (e_b <= MESH_BLOCKED_ATOL and e_n <= BLOCKED_NATIVE_ATOL):
            problems.append(f"sharded solver ({key}) vs blocked {e_b}, "
                            f"vs C++ {e_n}")

    for k in MESH_SHARDS:
        hold(f"in_process_{k}", multihost.block_mesh(k, mesh_devices(k)))
    started = multihost.initialize(f"localhost:{free_port()}", 1, 0,
                                   backend="nccl", single_rank_group=True)
    try:
        mesh = multihost.block_mesh(2, mesh_devices(1) * 2)
        row["nccl_group"] = {"started": started, "world": mesh.world,
                             "backend": torch.distributed.get_backend()}
        hold("nccl_1_rank_2", mesh)
    finally:
        multihost.shutdown()
    if torch.cuda.device_count() >= 2:
        port = str(free_port())
        worker = os.path.join(REPO, "scripts", "torch_dist_test_worker.py")
        procs = [subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, "--device",
             "cuda"], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
        outs = []
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        ok = all(p.returncode == 0 and f"proc {i}: OK" in o
                 for i, (p, o) in enumerate(zip(procs, outs)))
        row["two_process_nccl"] = {"ran": True, "ok": ok,
                                   "tail": [o[-400:] for o in outs]}
        if not ok:
            problems.append(f"two-process NCCL run failed: {outs}")
    else:
        row["two_process_nccl"] = {
            "ran": False, "reason": "this machine has one card: the "
            "two-process NCCL run waits for a machine with two or more"}
        print("mesh: the two-process NCCL run waits for a machine with "
              "two or more cards (this one has one)", flush=True)

    # the sharded candidate search against the pruned matcher
    inp = fused_inputs(0)
    dev = torch.device("cuda")
    spec = matching_mod.search_spec(5.0, 1.0, 10.0, 0.1)
    probs = torch.from_numpy(inp["grids"][:FUSED_CANDIDATES]).to(dev)
    pyr = [precompute_pyramid(p, 5) for p in probs]
    org = torch.from_numpy(inp["origin"]).to(dev)
    origins = [org] * FUSED_CANDIDATES
    stride = 1 << 4
    seq = matching_mod.match_candidates_pruned(
        [p[0] for p in pyr], [p[4] for p in pyr], origins, inp["th0"],
        inp["query"], spec, 0.7, stride)
    row["matcher"] = {"candidates": FUSED_CANDIDATES,
                      "points": FUSED_POINTS, "sequential": {
                          "index": seq[0], "score": seq[1]}}
    for k in MESH_MATCH_SHARDS:
        mesh = multihost.block_mesh(k, mesh_devices(k))
        t0 = time.perf_counter()
        sh = matching_mod.match_candidates_sharded(
            [p[0] for p in pyr], origins, inp["th0"], inp["query"], spec,
            mesh, 0.7)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        same = sh[0] == seq[0] and seq[0] is not None
        d = ({"score": abs(sh[1] - seq[1]),
              "pose": float(np.abs(sh[2] - seq[2]).max()),
              "cov": float(np.abs(sh[3] - seq[3]).max())} if same else {})
        row["matcher"][f"sharded_{k}"] = {"index": sh[0], "score": sh[1],
                                          "ms": ms, "max_abs_err": d}
        if not (same and d["score"] <= MESH_MATCH_SCORE_ATOL
                and d["pose"] <= MESH_MATCH_POSE_ATOL
                and d["cov"] <= MESH_MATCH_COV_ATOL):
            problems.append(f"sharded matcher on {k} shards: {sh[0]} "
                            f"against {seq[0]}, {d}")
    row["dryrun_multichip"] = {}
    for k in MESH_DRYRUNS:
        try:
            row["dryrun_multichip"][str(k)] = graft_entry.dryrun_multichip(k)
        except AssertionError as e:
            row["dryrun_multichip"][str(k)] = str(e)
            problems.append(f"dryrun_multichip({k}): {e}")
    row["problems"] = problems
    emit(row)
    return problems


def joint_case(n, P, n_lms, L, e_live, E, c_live, C, seed=0):
    """A seeded joint graph (numpy fields, JointGraphData layout) shaped
    as a final joint solve: n live poses of P driving four laps of a
    3:2 rectangle at 0.25 m a step, started 5 cm / 0.01 rad off the
    truth as the pose-graph solution warm-starts it, raw odometry
    between them; n_lms lines outside the rectangle (so no pose crosses
    one), each seen from several poses, e_live observation edges in
    all; c_live closures between the laps, two of them gross outliers
    for DCS. Informations are of the sizes sim-killian's joint solve
    carries (odometry ~diag(100, 300, 800), observations ~diag(120,
    310), closures ~diag(90, 90, 600)). Padded slots point at index 0,
    as the backend pads."""
    r = np.random.default_rng(seed)
    lap = n // 4
    perim = 0.25 * lap
    w, h = 0.3 * perim, 0.2 * perim

    def on_rect(s):
        s = s % perim
        for length, (x0, y0), th in ((w, (0.0, 0.0), 0.0),
                                      (h, (w, 0.0), np.pi / 2),
                                      (w, (w, h), np.pi),
                                      (h, (0.0, h), -np.pi / 2)):
            if s < length:
                return np.array([x0 + s * np.cos(th), y0 + s * np.sin(th),
                                 th])
            s -= length
        raise AssertionError(s)

    gt = np.stack([on_rect(0.25 * i) - [w / 2, h / 2, 0.0]
                   for i in range(n)])
    # lines with rho 20-40 m from the centre: outside the rectangle
    lms_gt = np.stack([r.uniform(20.0, 40.0, n_lms),
                       r.uniform(-np.pi, np.pi, n_lms)], 1)
    f = dict(
        poses=np.zeros((P, 3)), pose_valid=np.arange(P) < n,
        pose_fixed=np.arange(P) == 0, odom_meas=np.zeros((P, 3)),
        odom_info=np.tile(np.eye(3), (P, 1, 1)),
        odom_valid=(np.arange(P) > 0) & (np.arange(P) < n),
        lms=np.zeros((L, 2)), lm_valid=np.arange(L) < n_lms,
        obs_pose=np.zeros(E, np.int64), obs_lm=np.zeros(E, np.int64),
        obs_meas=np.zeros((E, 2)), obs_info=np.tile(np.eye(2), (E, 1, 1)),
        obs_valid=np.arange(E) < e_live,
        clo_i=np.zeros(C, np.int64), clo_j=np.zeros(C, np.int64),
        clo_meas=np.zeros((C, 3)), clo_info=np.tile(np.eye(3), (C, 1, 1)),
        clo_valid=np.arange(C) < c_live,
    )
    f["poses"][:n] = gt + r.normal(0, 1, (n, 3)) * [0.05, 0.05, 0.01]
    f["poses"][0] = gt[0]
    f["poses"][:, 2] = wrap_angle(f["poses"][:, 2])
    for i in range(1, n):
        f["odom_meas"][i] = se2.relative(gt[i - 1], gt[i]) + r.normal(
            0, 1, 3) * [0.02, 0.02, 0.005]
        f["odom_info"][i] = np.diag([100.0, 300.0, 800.0])
    f["lms"][:n_lms] = lms_gt + r.normal(0, 1, lms_gt.shape) * [0.05, 0.005]
    # each pose sees a run of landmarks that moves along the path, so
    # every landmark is seen from a stretch of poses
    per_pose = np.full(n, e_live // n)
    per_pose[: e_live % n] += 1
    k = 0
    for i in range(n):
        first = (i * n_lms) // n
        for j in range(per_pose[i]):
            m = (first + 3 * j) % n_lms
            inv = se2.inverse(gt[i])
            f["obs_pose"][k], f["obs_lm"][k] = i, m
            f["obs_meas"][k] = np.asarray(transform_line(
                lms_gt[m], inv[:2], inv[2])) + r.normal(0, 1, 2) * [0.01,
                                                                    0.002]
            f["obs_info"][k] = np.diag([120.0, 310.0])
            k += 1
    for c in range(c_live):
        i = int(r.integers(0, n - lap))
        j = i + lap * int(r.integers(1, max(2, (n - i) // lap)))
        j = min(j, n - 1)
        f["clo_i"][c], f["clo_j"][c] = i, j
        f["clo_meas"][c] = se2.relative(gt[i], gt[j]) + r.normal(
            0, 1, 3) * [0.01, 0.01, 0.002]
        if c < 2:
            f["clo_meas"][c] += [1.5, -1.0, 0.5]
        f["clo_info"][c] = np.diag([90.0, 90.0, 600.0])
    return f


class SchurCounter:
    """Counts ops/solvers._joint_schur_solve calls (one per LM iteration
    of optimize_joint_graph) and keeps the sizes of the graph solved."""

    def __init__(self):
        self.calls = 0
        self.sizes = None
        self._orig = solvers_mod._joint_schur_solve

    def _count(self, g, *a, **k):
        self.calls += 1
        self.sizes = self.sizes or graph_sizes(g)
        return self._orig(g, *a, **k)

    @contextlib.contextmanager
    def active(self):
        solvers_mod._joint_schur_solve = self._count
        try:
            yield self
        finally:
            solvers_mod._joint_schur_solve = self._orig


def timed_joint_solve(g, iterations, rtol):
    """(g_opt, chi2, seconds, LM iterations) of one optimize_joint_graph
    (the card synchronized before and after where g is on it)."""
    sync = torch.cuda.synchronize if g.poses.is_cuda else (lambda: None)
    count = SchurCounter()
    with count.active():
        sync()
        t0 = time.perf_counter()
        out, chi2 = solvers_mod.optimize_joint_graph(
            g, JOINT_PHI, iterations, rtol=rtol)
        sync()
        secs = time.perf_counter() - t0
    return out, chi2, secs, count.calls


def phase_joint_solver():
    """optimize_joint_graph on the card on seeded graphs at the sizes of
    sim-office's and sim-killian's final joint solves (JOINT_CASES),
    against the same solve on this machine's CPU (float64 both):
    poses and landmarks within JOINT_ATOL, chi2 within
    JOINT_CHI2_RTOL, the same number of LM iterations. Times the
    default solve (12 iterations at most, rtol 1e-9) and 12 iterations
    without the early stop; ms per iteration and per solve."""
    rows = []
    for name, size in JOINT_CASES.items():
        f = joint_case(**size)
        g_cuda = joint_graph_from_numpy(f, "cuda")
        g_cpu = joint_graph_from_numpy(f, "cpu")
        timed_joint_solve(g_cuda, 2, 1e-9)  # warm-up
        reps = [timed_joint_solve(g_cuda, JOINT_ITERS, 1e-9)
                for _ in range(3)]
        out, chi2, _, iters = reps[0]
        fixed = [timed_joint_solve(g_cuda, JOINT_ITERS, 0.0)
                 for _ in range(2)]
        ref, ref_chi2, cpu_s, cpu_iters = timed_joint_solve(
            g_cpu, JOINT_ITERS, 1e-9)
        chi2_0 = float(solvers_mod.joint_graph_chi2(g_cpu, JOINT_PHI))
        err_poses = float((out.poses.cpu() - ref.poses).abs().max())
        err_lms = float((out.lms.cpu() - ref.lms).abs().max())
        chi2_rel = abs(float(chi2) - float(ref_chi2)) / abs(float(ref_chi2))
        row = {
            "phase": "joint_solver", "case": name, **graph_sizes(g_cpu),
            "iterations": iters, "cpu_iterations": cpu_iters,
            "ms_per_solve": 1e3 * min(r[2] for r in reps),
            "ms_per_solve_reps": [1e3 * r[2] for r in reps],
            "ms_per_iteration": 1e3 * min(r[2] / r[3] for r in reps),
            "fixed_iterations": [r[3] for r in fixed],
            "ms_per_iteration_fixed": 1e3 * min(r[2] / r[3] for r in fixed),
            "cpu_s_per_solve": cpu_s,
            "chi2_start": chi2_0, "chi2": float(chi2),
            "chi2_cpu": float(ref_chi2), "chi2_rel_err": chi2_rel,
            "max_abs_err_poses": err_poses, "max_abs_err_lms": err_lms,
            "atol": JOINT_ATOL, "chi2_rtol": JOINT_CHI2_RTOL,
        }
        emit(row)
        problems = []
        if not (err_poses <= JOINT_ATOL and err_lms <= JOINT_ATOL
                and chi2_rel <= JOINT_CHI2_RTOL):
            problems.append(f"card vs CPU: poses {err_poses}, lms "
                            f"{err_lms}, chi2 {chi2_rel}")
        if iters != cpu_iters:
            problems.append(f"{iters} LM iterations on the card, "
                            f"{cpu_iters} on the CPU")
        if not float(chi2) < chi2_0:
            problems.append(f"chi2 {float(chi2)} not below {chi2_0}")
        if problems:
            raise AssertionError(f"joint solver ({name}): "
                                 + "; ".join(problems))
        rows.append(row)
    return rows


def pins_kernel_line(runs):
    """The kernels line's entry for the refinement kernel's batched mode
    (refine_pins_launch: the device pin batches, one launch per batch),
    its launches by path and its times summed over the paths that ran
    it (the accelerator-branch runs)."""
    paths = {k: v for k, v in runs.items() if v.get("pins_launches")}
    rp = [v["pins_replay"] for v in paths.values()]
    return {
        "name": "refine_pins",
        "route": "cuda",
        "source": "sparse_gslam_tpu_torch/csrc/refine_pose.cu",
        "replaces": "sparse_gslam_tpu/ops/matching.py:855",
        "replaces_what": "refine_pose_cov under jax.vmap in the XLA program "
                         "jit(pin_eval_batch) (:764-869; finish_one "
                         ":834-868); no Pallas kernel",
        "launches": sum(v.get("pins_launches", 0) for v in runs.values()),
        "launches_by_path": {k: v.get("pins_launches", 0)
                             for k, v in runs.items()},
        "pins_refined": sum(r["pins_refined"] for r in rp),
        "max_abs_err": max([r["pins_max_abs_err"] for r in rp] or [0.0]),
        "matched": not any(r["pins_calls_unequal"] for r in rp),
        "tolerance": "bit-exact (torch.equal)",
        "ms": sum(r["pins_device_ms"] for r in rp),
        "plain_ms": sum(r["pins_plain_ms"] for r in rp),
        "bound_ms": sum(r["pins_bound_ms"] for r in rp),
        "bound_by": max(("bytes", "operations"), key=lambda b: sum(
            r["pins_bound_ms"] for r in rp if r["pins_bound_by"] == b)),
        "library_ms": None,
        "timed": f"sum over the pin batches of {sorted(paths)}",
    }


def time_run_calls(calls):
    """The kernel, its plain twin and the bound, each summed over the
    main path's insertions (device ms; the plain twin once per call)."""
    ms = plain_ms = bound_ms = 0.0
    err = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for _, args, out in calls:
        ms += time_ms(lambda: grid_cuda.insert_rays_cuda(*args), 5)
        plain_ms += time_ms(lambda: insert_rays_plain(*args), 1, warmup=0)
        b, bound_by, _, _ = insertion_bound(args)
        bound_ms += b
        by[bound_by] += b
        err = max(err, float((insert_rays(*args) - out).abs().max()))
    return ms, plain_ms, bound_ms, max(by, key=by.get), err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"))
    ap.add_argument("--all-worlds", action="store_true",
                    help="also run sim-loops, sim-corridor and sim-office "
                         "with the smf and hough extractors in full")
    args = ap.parse_args()
    t_start = time.perf_counter()
    os.makedirs(args.out, exist_ok=True)
    PHASE_LOG.append(open(os.path.join(args.out, "phases.jsonl"), "w"))
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            seconds[name] = time.perf_counter() - t0

    name, count, smi = timed("device", phase_device)
    host_lib = timed("build", phase_build)
    rows = timed("kernel", phase_kernel)
    refine_rows = timed("refine", phase_refine, host_lib)
    launches, map_args = timed("main", phase_main)
    row = compare("main_path_map", map_args, kernel_reps=20, plain_reps=3)
    emit_times(rows + [row], smi)
    # every full run runs even if one before it failed; any failure
    # fails the script after the kernels line
    runs = {"backend": timed("backend", phase_full, "sim-office", "backend",
                             args.out),
            "refine_map": timed("refine_map", phase_full,
                                "sim-office-refine1", "refine_map",
                                args.out),
            "beams60": timed("beams60", phase_full, "sim-office-beams60",
                             "beams60", args.out),
            "beams4": timed("beams4", phase_full, "sim-office-beams4",
                            "beams4", args.out),
            "joint": timed("joint", phase_full, "sim-office-joint", "joint",
                           args.out),
            "marginal": timed("marginal", phase_full, "sim-office-marginal",
                              "marginal", args.out),
            "accel": timed("accel", phase_full, "sim-office-accel", "accel",
                           args.out)}
    emit({"phase": "accel_split", "world": "sim-office",
          "accel_branch": runs["accel"]["split"],
          "cpu_branch": runs["backend"]["split"]})
    checks = timed("fused", phase_fused)["problems"]
    runs["realtime"] = timed("realtime", phase_realtime, "sim-office", 2.0,
                             args.out, runs["backend"]["frontend_ms"],
                             REALTIME_FRAMES)
    runs["resume"] = timed("resume", phase_resume, args.out)
    timed("blocked", phase_blocked)
    checks += timed("mesh", phase_mesh)
    timed("joint_solver", phase_joint_solver)
    runs["killian"] = timed("killian", phase_full, "sim-killian", "killian",
                            args.out)
    killian_ms = runs["killian"].pop("frontend_ms")
    if args.all_worlds:
        for world in ("sim-loops", "sim-corridor"):
            runs[world] = timed(world, phase_full, world, "world", args.out)
        for algorithm in ("smf", "hough"):
            runs[algorithm] = timed(algorithm, phase_full,
                                    f"sim-office-{algorithm}", algorithm,
                                    args.out)
        runs["realtime_killian"] = timed(
            "realtime_killian", phase_realtime, "sim-killian", 1.5,
            args.out, killian_ms)
        runs["beams60_accel"] = timed(
            "beams60_accel", phase_full, "sim-office-beams60-accel",
            "beams60_accel", args.out)
        emit({"phase": "accel_split", "world": "sim-office-beams60",
              "accel_branch": runs["beams60_accel"]["split"],
              "cpu_branch": runs["beams60"]["split"]})
        for beams in (6, 8):
            runs[f"beams{beams}"] = timed(
                f"beams{beams}", phase_full, f"sim-office-beams{beams}",
                f"beams{beams}", args.out)
        runs["beams4_accel"] = timed(
            "beams4_accel", phase_full, "sim-office-beams4-accel",
            "beams4_accel", args.out)
        runs["mesh_office"] = timed("mesh_office", phase_full,
                                    "sim-office-mesh", "mesh_office",
                                    args.out)
    failed = checks + [p for r in runs.values() for p in r["problems"]]
    killian = runs["killian"]
    ms, plain_ms, bound_ms, bound_by, err = timed(
        "kernels", time_run_calls, killian["insertions"])
    rp = killian["replay"]
    emit({"kernels": [{
        "name": "insert_rays",
        "route": "cuda",
        "source": "sparse_gslam_tpu_torch/csrc/insert_rays.cu",
        "replaces": "sparse_gslam_tpu/ops/grid_pallas.py:202",
        "launches": launches + sum(v["launches"] for v in runs.values()),
        "launches_by_path": {"frontend_only": launches, **{
            k: v["launches"] for k, v in runs.items()}},
        "timed_launches": killian["launches"],
        "max_abs_err": max(err, row["max_abs_err"]),
        "matched": row["equal"],
        "tolerance": "bit-exact (torch.equal)",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "timed": f"sum over the sim-killian run's "
                 f"{len(killian['insertions'])} insertions",
    }, {
        "name": "refine_pose",
        "route": "cuda",
        "source": "sparse_gslam_tpu_torch/csrc/refine_pose.cu",
        "replaces": "sparse_gslam_tpu/ops/matching.py:630",
        "replaces_what": "the XLA programs jit(refine_pose_cov) (:630) "
                         "and jit(refine_pose_cov_two_stage) (:598); no "
                         "Pallas kernel",
        "launches": sum(v["refine_launches"] for v in runs.values()),
        "launches_by_path": {k: v["refine_launches"]
                             for k, v in runs.items()},
        "timed_launches": killian["refine_launches"],
        "max_abs_err": max([v["replay"]["refine_max_abs_err"]
                            for v in runs.values()]
                           + [r["max_abs_err"] for r in refine_rows]),
        "matched": all(r["equal"] for r in refine_rows),
        "tolerance": "bit-exact (torch.equal)",
        "ms": rp["refine_device_ms"],
        "plain_ms": rp["refine_plain_ms"],
        "bound_ms": rp["refine_bound_ms"],
        "bound_by": rp["refine_bound_by"],
        "serial_chain_ms": rp["refine_serial_chain_ms"],
        "serial_chain_ms_all_steps": rp["refine_serial_chain_ms_all_steps"],
        "library_ms": None,
        "timed": f"sum over the sim-killian run's "
                 f"{killian['refine_launches']} refinements",
        "by_n": {k: v["replay"]["refine_by_n"] for k, v in runs.items()},
    }, pins_kernel_line(runs)]})
    print(smi, flush=True)
    emit({"seconds": seconds, "total_s": time.perf_counter() - t_start})
    if failed:
        raise AssertionError("; ".join(failed))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for pool in _REPLAY_POOL:
            pool.shutdown(cancel_futures=True)
    sys.exit(code)
