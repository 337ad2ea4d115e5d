#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparse_gslam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out OUT]

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
   chain edges, DCS pose graph; --eval --map-png) on cuda under
   SLAM_LOG_MATCHES=1. Every insertion of the run is recorded and
   replayed through the plain twin (torch.equal each); there must be
   105 launches (52 in precompute, 52 in rebuild_grids, 1 for the
   map). The counts and the `backend:`/`closures:` lines must equal the
   JAX CPU run's, the [match]/[chain]/[kfpin] decision lines
   (written to OUT/decisions.log) are held against its log
   (sparse_gslam_tpu_torch/data/sim-office-full.decisions), the ATE
   line must equal its digits or lie within ATE_TOL of it, and the
   .result must match sparse_gslam_tpu_torch/data/sim-office-full.result
   within FULL_RESULT_ATOL.
6. kernels -- one line per ported kernel: launches in the main path's
   run (the backend run; launches_by_path has both runs), error against
   the plain twin, its time, the plain twin's time and the least time
   the card could take, summed over the backend run's 105 insertions.

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
from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
from sparse_gslam_tpu_torch.ops import grid as grid_mod
from sparse_gslam_tpu_torch.ops import grid_cuda
from sparse_gslam_tpu_torch.ops.grid import (
    insert_rays,
    insert_rays_plain,
    submap_insert_args,
)
from sparse_gslam_tpu_torch.utils.se2 import wrap_angle

REPO = os.path.dirname(os.path.abspath(__file__))
DATASET = os.path.join(REPO, "datasets", "sim-office")
REFERENCE_RESULT = os.path.join(
    REPO, "sparse_gslam_tpu_torch", "data", "sim-office-nobackend.result"
)
# The JAX package's frontend-only run on this dataset, on the CPU in
# float64 (python -m sparse_gslam_tpu.runner ... --no-backend --eval)
REFERENCE_ATE = (
    "ATE trans 0.2020 +- 0.2765 m, rot 1.740 +- 1.803 deg (391 relations)"
)
REFERENCE_COUNTS = {"keyframes": 286, "landmarks": 90, "rejected_ticks": 0}
# The JAX package's full run (backend on) on this dataset, on the CPU in
# float64 (python -m sparse_gslam_tpu.runner ... --eval)
FULL_RESULT = os.path.join(
    REPO, "sparse_gslam_tpu_torch", "data", "sim-office-full.result"
)
FULL_DECISIONS = os.path.join(
    REPO, "sparse_gslam_tpu_torch", "data", "sim-office-full.decisions"
)
FULL_ATE = (
    "ATE trans 0.0821 +- 0.0844 m, rot 0.772 +- 0.590 deg (391 relations)"
)
FULL_BACKEND = "backend: 26 submaps, 6 closures (0 pruned)"
FULL_CLOSURES = (
    "closures: precision 1.00 (6/6 true), ridge-aware precision 1.00 "
    "(6/6), recall 1.00 (2/2 revisit segments detected)"
)
FULL_COUNTS = {"frames": 663, "keyframes": 286, "landmarks": 90,
               "submaps": 26, "loop_closures": 6, "pruned": 0,
               "local_edges": 15, "kf_pins": 4}
FULL_LAUNCHES = {"precompute": 52, "rebuild_grids": 52, "map": 1}
# When the ATE line's digits differ: the largest differences of the
# trans and rot means from the reference that are accepted (m, deg)
ATE_TOL = (0.002, 0.05)
# .result of the full run: the closures' measurements and covariances
# come from float32 refinement and FFT scores, which sum in another
# order on the card; the pose graph spreads their ~1e-6 relative
# differences over the trajectory (a few mm on this dataset, the
# 6-decimal file format included)
FULL_RESULT_ATOL = 5e-3
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
    scores compared at MISS_SCORE_ATOL), or None."""
    num = re.compile(r"best=([0-9.eE+-]+)")
    for k in range(max(len(got), len(ref))):
        a = got[k] if k < len(got) else "<missing>"
        b = ref[k] if k < len(ref) else "<missing>"
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


def phase_backend(out_dir):
    tmp = tempfile.mkdtemp(prefix="chip_smoke_full_")
    os.makedirs(out_dir, exist_ok=True)
    try:
        data = os.path.join(tmp, "sim-office")
        shutil.copytree(DATASET, data)
        png = os.path.join(tmp, "map.png")
        rec = InsertRecorder()
        tee = Tee(sys.stdout)
        os.environ["SLAM_LOG_MATCHES"] = "1"
        grid_cuda.insert_rays_cuda.launches = 0
        t0 = time.perf_counter()
        try:
            with rec.active(), contextlib.redirect_stdout(tee):
                r = runner.run([
                    "--dataset-dir", data, "--dataset-name", "sim-office",
                    "--eval", "--map-png", png, "--device", "cuda",
                ])
            torch.cuda.synchronize()
        finally:
            del os.environ["SLAM_LOG_MATCHES"]
        total_s = time.perf_counter() - t0
        launches = grid_cuda.insert_rays_cuda.launches
        text = tee.buf.getvalue()
        lines = text.splitlines()

        def line_of(prefix):
            return next((ln for ln in lines if ln.startswith(prefix)), "")

        decisions = decision_lines(text)
        log_path = os.path.join(out_dir, "decisions.log")
        with open(log_path, "w") as fh:
            fh.write("\n".join(decisions) + "\n")
        with open(FULL_DECISIONS) as fh:
            ref_decisions = fh.read().splitlines()
        first_diff = first_decision_difference(decisions, ref_decisions)

        # every grid build of the run against its plain twin
        by_phase = {}
        unequal = []
        for k, (phase, args, out) in enumerate(rec.calls):
            by_phase[phase] = by_phase.get(phase, 0) + int(out.is_cuda)
            if not torch.equal(out, insert_rays_plain(*args)):
                unequal.append((k, phase))

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
        times, poses = load_result(os.path.join(data, "sim-office.result"))
        ref_times, ref_poses = load_result(FULL_RESULT)
        same_times = bool(np.array_equal(times, ref_times))
        d = poses - ref_poses if same_times else np.full((1, 3), np.inf)
        if same_times:
            d[:, 2] = wrap_angle(d[:, 2])
        result_err = float(np.abs(d).max())
        ate = line_of("ATE trans")
        got_ate, ref_ate = parse_ate(ate), parse_ate(FULL_ATE)
        ate_delta = (None if got_ate is None else
                     [abs(got_ate[0] - ref_ate[0]), abs(got_ate[1] - ref_ate[1])])
        ft = np.asarray(sysm.frontend_times)
        bt = np.asarray(sysm.backend_times)
        emit({
            "phase": "backend", **counts,
            "backend_line": line_of("backend:"), "ate": ate,
            "closures_line": line_of("closures:"),
            "kernel_launches": launches, "launches_by_phase": by_phase,
            "grid_builds_replayed": len(rec.calls),
            "grid_builds_unequal": unequal,
            "decision_lines": len(decisions), "decision_log": log_path,
            "first_decision_difference": first_diff,
            "ate_delta_trans_rot": ate_delta,
            "result_max_abs_err": result_err,
            "result_atol": FULL_RESULT_ATOL,
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
        problems = []
        if launches != sum(FULL_LAUNCHES.values()) or by_phase != FULL_LAUNCHES:
            problems.append(f"{launches} insertion launches {by_phase}, "
                            f"expected {FULL_LAUNCHES}")
        if unequal:
            problems.append(f"grid builds differ from the plain twin: "
                            f"{unequal[:5]}")
        if counts != FULL_COUNTS:
            problems.append(f"counts {counts} != {FULL_COUNTS}")
        if line_of("backend:") != FULL_BACKEND:
            problems.append(f"{line_of('backend:')!r} != {FULL_BACKEND!r}")
        if line_of("closures:") != FULL_CLOSURES:
            problems.append(f"{line_of('closures:')!r} != "
                            f"{FULL_CLOSURES!r}")
        if ate != FULL_ATE and not (
            ate_delta is not None and ate_delta[0] <= ATE_TOL[0]
            and ate_delta[1] <= ATE_TOL[1]
        ):
            problems.append(f"ATE {ate!r} beyond {ATE_TOL} of {FULL_ATE!r}")
        if not same_times or not result_err <= FULL_RESULT_ATOL:
            problems.append(f".result differs from the reference: times "
                            f"equal {same_times}, max |d| {result_err}")
        if not os.path.getsize(png):
            problems.append("empty map PNG")
        if problems:
            raise AssertionError("; ".join(problems))
        return launches, rec.calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    args = ap.parse_args()
    name, count, smi = phase_device()
    phase_build()
    rows = phase_kernel()
    launches, map_args = phase_main()
    row = compare("main_path_map", map_args, kernel_reps=20, plain_reps=3)
    emit_times(rows + [row], smi)
    full_launches, calls = phase_backend(args.out)
    ms, plain_ms, bound_ms, bound_by, err = time_run_calls(calls)
    emit({"kernels": [{
        "name": "insert_rays",
        "route": "cuda",
        "source": "sparse_gslam_tpu_torch/csrc/insert_rays.cu",
        "replaces": "sparse_gslam_tpu/ops/grid_pallas.py:202",
        "launches": full_launches,
        "launches_by_path": {"frontend_only": launches,
                             "backend": full_launches},
        "max_abs_err": max(err, row["max_abs_err"]),
        "matched": row["equal"],
        "tolerance": "bit-exact (torch.equal)",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "timed": f"sum over the backend run's {len(calls)} insertions",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
