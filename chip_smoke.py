#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparse_gslam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out OUT] [--all-worlds]

OUT (default smoke_out/ beside this script, gitignored) receives the
files too long for standard output. Phases, each printed as one JSON
line; any failure raises and the exit code is not 0:

1. device  -- the card's name and count, and nvidia-smi's name and
   power limit (a raw line of its own as well). Fails without CUDA.
2. build   -- compiles csrc/insert_rays.cu with nvcc (sm_90a) and
   prints the seconds and the -Xptxas -v report.
3. kernel  -- the CUDA insertion kernel against its plain torch twin on
   the card, at every tile size it is built for, on seeded cases from
   the test sizes up to the largest map the code allows (G=2048,
   S_pad=4096), the backend's submap grids, rays on tile borders and a
   grid edge no tile divides; torch.equal is required. One line per
   case, then one line with every case's time beside its bound and the
   first version's time (PERF.md, PR 1).
4. main    -- the frontend-only runner on a temporary copy of
   datasets/sim-office on cuda (--no-backend --eval --map-png): the
   kernel must have launched, the ATE line and the counts must equal
   the float64 CPU JAX reference, the .result must match the committed
   reference (sparse_gslam_tpu_torch/data/sim-office-nobackend.result),
   and the map must equal the plain twin's on the same inputs.
5. backend -- the full runner (backend on: submaps, matcher, pins,
   chain edges, DCS pose graph; --eval --map-png) on sim-office on cuda
   under SLAM_LOG_MATCHES=1. Every insertion of the run is recorded and
   replayed through the plain twin (torch.equal each); there must be
   105 launches (52 in precompute, 52 in rebuild_grids, 1 for the
   map). compare_run holds the output against the JAX CPU run's
   (WORLDS): the counts and the `backend:`/`closures:` lines equal, the
   decision lines (written to OUT/sim-office.decisions.log) equal to
   its log (sparse_gslam_tpu_torch/data/sim-office-full.decisions), the
   ATE line equal to its digits or within ATE_TOL of it, and the
   .result within FULL_RESULT_ATOL of
   sparse_gslam_tpu_torch/data/sim-office-full.result.
6. blocked -- the keyframe-partitioned pose-graph solver on the card on
   synthetic chains of 2k and 16k poses (BLOCKED_CASES), against the
   float64 C++ solver on the host at the same iteration count and, at
   2k, against the dense solver on the card; GN iterations/s of both.
7. killian -- the full runner on sim-killian (2626 frames, a pose graph
   padded to 2048) on cuda, as phase 5, with every pose-graph solve
   recorded: from dist_solver_min_poses padded poses up each must take
   the blocked solver and agree with the C++ solver on its graph. The
   JAX run's output is not reproduced (see WORLDS): the phase holds
   the counts up to the submaps and the first held_lines decision
   lines, and prints the full comparison ("parity_met": false) and
   where the run lies in the JAX package's own spread under a 1e-6 m
   odometry jitter.
8. world   -- with --all-worlds, sim-loops and sim-corridor as phase 5;
   each runs, and any failure fails the script at the end.
9. kernels -- one line per ported kernel: launches in the main path's
   run (the sim-killian run; launches_by_path has every run), error
   against the plain twin, its time, the plain twin's time and the
   least time the card could take, summed over that run's insertions.

The last line is {"ok": true, "device": {...}}. Imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
from sparse_gslam_tpu_torch.io.native import posegraph_gn_native
from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
from sparse_gslam_tpu_torch.ops import grid as grid_mod
from sparse_gslam_tpu_torch.ops import grid_cuda
from sparse_gslam_tpu_torch.ops import solvers as solvers_mod
from sparse_gslam_tpu_torch.parallel import dist_solver
from sparse_gslam_tpu_torch.ops.grid import (
    insert_rays,
    insert_rays_plain,
    submap_insert_args,
)
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
# decision lines, the ATE within ATE_TOL and the .result within
# FULL_RESULT_ATOL. sim-killian is the one exception, and it is not
# met. The float32 scan refinement does not round as XLA's does
# (~1e-7 m, up to 1.7e-4 m on the same inputs), and over killian's
# 2626 frames a match decision flips. The JAX package does not
# reproduce its own run either: on odometry jittered by 1e-6 m
# (scripts/jitter_world.py, seeds 1-3) its decision lines part from
# its reference run at lines 15, 10 and 25, and it ends with 24, 17
# and 20 closures and ATE trans means of 0.2161, 0.2143 and 0.1909 m
# (rot 0.707, 0.738, 0.652 deg; the reference: 24, 0.1862 m,
# 0.648 deg). So killian is held to the decision lines all of those
# runs reproduce ("held_lines"), and the phase prints the full
# comparison and where the run lies in that spread ("jax_spread":
# the reference and the three jittered runs), holding neither.
KILLIAN_HELD_LINES = 10
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
        "held_lines": KILLIAN_HELD_LINES,
        "jax_spread": {"ate_trans": (0.1862, 0.2161),
                       "ate_rot": (0.648, 0.738),
                       "loop_closures": (17, 24)},
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
# When the ATE line's digits differ: the largest differences of the
# trans and rot means from the reference that are accepted (m, deg)
ATE_TOL = (0.002, 0.05)
# .result of a full run against the JAX CPU run's (m/rad): the closures'
# measurements and covariances come from float32 refinement and FFT
# scores, which sum in another order on the card; the pose graph
# spreads their ~1e-6 relative differences over the trajectory (a few
# mm on sim-office, the 6-decimal file format included)
FULL_RESULT_ATOL = 5e-3
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
# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# the first version of the kernel (one block for the whole grid): its ms
# on an H100 80GB HBM3 at 700 W, final call of PR 1 (PERF.md)
V1_MS = {"slice_g320_s1024": 2.798, "max_g2048_s4096": 17.495,
         "main_path_map": 2.656}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    info = grid_cuda.build()
    emit({"phase": "build",
          "sources": [os.path.relpath(f, REPO)
                      for f in grid_cuda.source_files()],
          "seconds": round(info["seconds"], 3),
          "cached": info["seconds"] == 0.0, "ptxas": info["ptxas"]})


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


def phase_main():
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data = os.path.join(tmp, "sim-office")
        shutil.copytree(DATASET, data)
        png = os.path.join(tmp, "map.png")
        grid_cuda.insert_rays_cuda.launches = 0
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
    innermost of the wrapped callers on the stack."""

    def __init__(self):
        self.calls = []
        self.phase = ["other"]
        self._orig = grid_mod.insert_rays

    def insert(self, *args):
        out = self._orig(*args)
        self.calls.append((self.phase[-1], args, out))
        return out

    def tag(self, phase, fn):
        def wrapped(*a, **k):
            self.phase.append(phase)
            try:
                return fn(*a, **k)
            finally:
                self.phase.pop()
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


def first_decision_difference(got, ref):
    """Index and pair of the first decision line that differs (MISS
    scores compared at MISS_SCORE_ATOL; a printed zero's sign, -0.000
    against +0.000, is not a difference), or None."""
    num = re.compile(r"best=([0-9.eE+-]+)")
    zero = re.compile(r"-(0\.0+)(?![0-9])")
    for k in range(max(len(got), len(ref))):
        a = zero.sub(r"+\1", got[k]) if k < len(got) else "<missing>"
        b = zero.sub(r"+\1", ref[k]) if k < len(ref) else "<missing>"
        ma, mb = num.search(a), num.search(b)
        if ma and mb and num.sub("", a) == num.sub("", b):
            if abs(float(ma.group(1)) - float(mb.group(1))) <= MISS_SCORE_ATOL:
                continue
        elif a == b:
            continue
        return {"index": k, "got": a, "reference": b}
    return None


def parse_ate(line):
    m = re.match(r"ATE trans ([0-9.]+) \+- [0-9.]+ m, rot ([0-9.]+)", line)
    return (float(m.group(1)), float(m.group(2))) if m else None


def compare_run(world, text, result_path):
    """A full run of `world` (its standard output under
    SLAM_LOG_MATCHES=1 and the .result it wrote) against the JAX
    package's CPU run (WORLDS[world], data/<world>-full.*). Returns the
    readings; "problems" lists every way the run differs: the
    `backend:`/`closures:` lines, the decision lines, the ATE beyond
    ATE_TOL unless its line is equal, the .result beyond
    FULL_RESULT_ATOL."""
    ref = WORLDS[world]
    lines = text.splitlines()

    def line_of(prefix):
        return next((ln for ln in lines if ln.startswith(prefix)), "")

    decisions = decision_lines(text)
    with open(os.path.join(DATA, f"{world}-full.decisions")) as fh:
        ref_decisions = fh.read().splitlines()
    first_diff = first_decision_difference(decisions, ref_decisions)
    times, poses = load_result(result_path)
    ref_times, ref_poses = load_result(
        os.path.join(DATA, f"{world}-full.result"))
    same_times = bool(np.array_equal(times, ref_times))
    d = poses - ref_poses if same_times else np.full((1, 3), np.inf)
    if same_times:
        d[:, 2] = wrap_angle(d[:, 2])
    result_err = float(np.abs(d).max())
    ate = line_of("ATE trans")
    got_ate, ref_ate = parse_ate(ate), parse_ate(ref["ate"])
    ate_delta = (None if got_ate is None else
                 [abs(got_ate[0] - ref_ate[0]), abs(got_ate[1] - ref_ate[1])])
    problems = []
    for key, prefix in (("backend", "backend:"), ("closures", "closures:")):
        if line_of(prefix) != ref[key]:
            problems.append(f"{line_of(prefix)!r} != {ref[key]!r}")
    if first_diff is not None:
        problems.append(f"decision lines differ: {first_diff}")
    if ate != ref["ate"] and not (
            ate_delta is not None and ate_delta[0] <= ATE_TOL[0]
            and ate_delta[1] <= ATE_TOL[1]):
        problems.append(f"ATE {ate!r} beyond {ATE_TOL} of {ref['ate']!r}")
    if not (same_times and result_err <= FULL_RESULT_ATOL):
        problems.append(f".result differs from the reference: times "
                        f"equal {same_times}, max |d| {result_err}")
    return {
        "world": world, "done_line": line_of("done:"),
        "backend_line": line_of("backend:"),
        "closures_line": line_of("closures:"), "ate": ate,
        "ate_delta_trans_rot": ate_delta,
        "decisions": decisions, "reference_decisions": ref_decisions,
        "first_decision_difference": first_diff,
        "result_times_equal": same_times, "result_max_abs_err": result_err,
        "result_atol": FULL_RESULT_ATOL, "problems": problems,
    }


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


def phase_full(world, phase, out_dir):
    """The full runner (backend on) on a temporary copy of
    datasets/<world> on cuda under SLAM_LOG_MATCHES=1, held against the
    JAX package's CPU run (WORLDS). Every insertion is replayed through
    the plain twin; every pose-graph solve is recorded. Returns
    (kernel launches, recorded insertions)."""
    ref = WORLDS[world]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{world}_")
    os.makedirs(out_dir, exist_ok=True)
    try:
        data = os.path.join(tmp, world)
        shutil.copytree(os.path.join(REPO, "datasets", world), data)
        png = os.path.join(tmp, "map.png")
        rec = InsertRecorder()
        solves = SolveRecorder()
        tee = Tee(sys.stdout)
        os.environ["SLAM_LOG_MATCHES"] = "1"
        grid_cuda.insert_rays_cuda.launches = 0
        t0 = time.perf_counter()
        try:
            with rec.active(), solves.active(), \
                    contextlib.redirect_stdout(tee):
                r = runner.run([
                    "--dataset-dir", data, "--dataset-name", world,
                    "--eval", "--map-png", png, "--device", "cuda",
                ])
            torch.cuda.synchronize()
        finally:
            del os.environ["SLAM_LOG_MATCHES"]
        total_s = time.perf_counter() - t0
        launches = grid_cuda.insert_rays_cuda.launches
        cmp = compare_run(world, tee.buf.getvalue(),
                          os.path.join(data, f"{world}.result"))
        decisions = cmp.pop("decisions")
        ref_decisions = cmp.pop("reference_decisions")
        log_path = os.path.join(out_dir, f"{world}.decisions.log")
        with open(log_path, "w") as fh:
            fh.write("\n".join(decisions) + "\n")

        # every grid build of the run against its plain twin
        by_phase = {}
        unequal = []
        for k, (ph, args, out) in enumerate(rec.calls):
            by_phase[ph] = by_phase.get(ph, 0) + int(out.is_cuda)
            if not torch.equal(out, insert_rays_plain(*args)):
                unequal.append((k, ph))

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
        # a world with "held_lines" is held to its counts up to the
        # submaps and to its first held_lines decision lines; the rest
        # of the comparison is printed as not met
        held_lines = ref.get("held_lines")
        count_keys = tuple(counts)
        parity = cmp.pop("problems")
        problems = []
        spread = ref.get("jax_spread")
        if spread is not None:
            got = parse_ate(cmp["ate"]) or (np.nan, np.nan)
            got = {"ate_trans": got[0], "ate_rot": got[1],
                   "loop_closures": counts["loop_closures"]}
            cmp["jax_spread"] = spread
            cmp["within_jax_spread"] = {
                k: bool(lo <= got[k] <= hi) for k, (lo, hi) in spread.items()}
        if held_lines is not None:
            count_keys = ("frames", "keyframes", "landmarks", "submaps")
            diff = first_decision_difference(decisions[:held_lines],
                                             ref_decisions[:held_lines])
            if diff is not None:
                problems.append(f"held decision lines differ: {diff}")
        else:
            problems += parity
        emit({
            "phase": phase, **cmp, **counts,
            "kernel_launches": launches, "launches_by_phase": by_phase,
            "grid_builds_replayed": len(rec.calls),
            "grid_builds_unequal": unequal,
            "decision_lines": len(decisions), "decision_log": log_path,
            "decision_lines_held": (len(ref_decisions) if held_lines is None
                                    else held_lines),
            "parity_met": not parity, "parity_problems": parity,
            **solve_info,
            "frame_loop_s": r.wall_s, "fps": r.n_frames / r.wall_s,
            "total_s": total_s,
            "frontend_mean_ms": float(ft.mean() * 1e3),
            "frontend_max_ms": float(ft.max() * 1e3),
            "frontend_ticks": len(ft),
            "backend_mean_ms": float(bt.mean() * 1e3),
            "backend_max_ms": float(bt.max() * 1e3),
            "backend_ticks": len(bt),
            "prof_s": {k: be.prof[k] for k in (
                "kf_edges", "grid_build", "chain_edges", "match_snapshot",
                "match_search", "match_correlate", "match_refine",
                "match_apply")},
        })
        if (launches != sum(ref["launches"].values())
                or by_phase != ref["launches"]):
            problems.append(f"{launches} insertion launches {by_phase}, "
                            f"expected {ref['launches']}")
        if unequal:
            problems.append(f"grid builds differ from the plain twin: "
                            f"{unequal[:5]}")
        for key in count_keys:
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
        if problems:
            raise AssertionError(f"{world}: " + "; ".join(problems))
        return launches, rec.calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
                    help="also run sim-loops and sim-corridor in full")
    args = ap.parse_args()
    name, count, smi = phase_device()
    phase_build()
    rows = phase_kernel()
    launches, map_args = phase_main()
    row = compare("main_path_map", map_args, kernel_reps=20, plain_reps=3)
    emit_times(rows + [row], smi)
    office_launches, _ = phase_full("sim-office", "backend", args.out)
    phase_blocked()
    killian_launches, calls = phase_full("sim-killian", "killian", args.out)
    by_path = {"frontend_only": launches, "backend": office_launches,
               "killian": killian_launches}
    failed = []
    if args.all_worlds:
        # each world runs even if one before it failed; any failure
        # fails the script after the kernels line
        for world in ("sim-loops", "sim-corridor"):
            try:
                by_path[world], _ = phase_full(world, "world", args.out)
            except AssertionError as exc:
                failed.append(str(exc))
    ms, plain_ms, bound_ms, bound_by, err = time_run_calls(calls)
    emit({"kernels": [{
        "name": "insert_rays",
        "route": "cuda",
        "source": "sparse_gslam_tpu_torch/csrc/insert_rays.cu",
        "replaces": "sparse_gslam_tpu/ops/grid_pallas.py:202",
        "launches": killian_launches,
        "launches_by_path": by_path,
        "max_abs_err": max(err, row["max_abs_err"]),
        "matched": row["equal"],
        "tolerance": "bit-exact (torch.equal)",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "timed": f"sum over the sim-killian run's {len(calls)} insertions",
    }]})
    if failed:
        raise AssertionError("; ".join(failed))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
