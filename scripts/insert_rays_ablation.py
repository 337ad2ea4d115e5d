"""Where the time of the port's CUDA ray insertion goes, on one GPU.

    python3 scripts/insert_rays_ablation.py

Builds variants of sparse_gslam_tpu_torch/csrc/insert_rays.cu with one
phase cut out and times each beside the kernel as committed, at every
tile size, on chip_smoke.py's shapes: a backend submap grid, the seeded
map shape, the largest map, and the sim-office map of a frontend-only
run on the card. A variant's grid is wrong by design; only its time
counts. Variants:

    no_replay    events are gathered but never applied to the cells
    no_samples   hits only: no ray's miss samples are walked
    screen_only  the scans are screened and listed, none is gathered

Prints one JSON line per (case, variant, tile), then the card's name
and power limit. The variants are built with nvcc under
sparse_gslam_tpu_torch/_build/ablation/.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from sparse_gslam_tpu_torch.ops import grid_cuda  # noqa: E402

OUT = os.path.join(grid_cuda.BUILD_DIR, "ablation")
VARIANTS = {
    "committed": [],
    "no_replay": [("p[j] = sg::apply_events(q, p[j], h, mw);",
                   "p[j] += (float)__popc(h | mw);")],
    "no_samples": [("warp_samples(q, tile, r, n, bit, ts, n_ts, miss_words,"
                    " lane);", "if (n == -1) miss_words[0] = bit;")],
    "screen_only": [("for (int c0 = 0; c0 < n_listed;",
                     "if (n_listed == -1) p[0] = 1.0f;\n"
                     "    for (int c0 = 0; c0 < 0;")],
}


def build(name, subs):
    """The kernel library with `subs` applied to insert_rays.cu."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in grid_cuda.source_files():
        shutil.copy(f, d)
    src = os.path.join(d, os.path.basename(grid_cuda.SOURCE))
    with open(src) as fh:
        text = fh.read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in the kernel")
        text = text.replace(old, new)
    with open(src, "w") as fh:
        fh.write(text)
    lib = os.path.join(d, "libinsert_rays.so")
    subprocess.run([grid_cuda._nvcc(), *grid_cuda.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).insert_rays_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_float] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return name, fn


def launch(fn, args, tile):
    probs, origin, so, sp, sk, hm, res, n_steps, size = args
    out = torch.empty_like(probs)
    rc = fn(out.data_ptr(), probs.data_ptr(), origin.data_ptr(),
            so.data_ptr(), sp.data_ptr(), sk.data_ptr(), hm.data_ptr(),
            ctypes.c_float(res), sk.shape[0], sk.shape[1], n_steps, size,
            tile, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


def main() -> int:
    smi = chip_smoke.phase_device()[2]
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda kv: build(*kv), VARIANTS.items()))
    cases = [
        ("submap_g320_s32", chip_smoke.submap_case(8, 320, 0.1)),
        ("slice_g320_s1024", chip_smoke.seeded_case(
            6, 648, 1024, 16, 320, 0.0957, 96, 10.0)),
        ("max_g2048_s4096", chip_smoke.seeded_case(
            7, 4096, 4096, 16, 2048, 0.1, 96, 10.0)),
        ("main_path_map", chip_smoke.phase_main()[1]),
    ]
    for case, args in cases:
        ref = grid_cuda.insert_rays_cuda(*args)
        for variant, fn in built:
            for tile in grid_cuda.TILES:
                equal = bool(torch.equal(launch(fn, args, tile), ref))
                ms = chip_smoke.time_ms(lambda: launch(fn, args, tile),
                                        5 if args[8] >= 2048 else 20)
                chip_smoke.emit({"case": case, "variant": variant,
                                 "tile": tile, "ms": ms, "equal": equal})
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
