"""The paper's beam sweep: error against beams per scan, and the
smoothing-kernel ablation. The port's counterpart of scripts/sweep.py.

    python -m sparse_gslam_tpu_torch.eval.sweep DATASET_DIR NAME
        [--beams 4 6 8 11] [--kernels 0 1 2 3] [--out sweep.png]
        [--device cuda|cpu] [--accel-branch]

For each beam count B it runs the whole pipeline (frontend, backend,
final cleanup) on the dataset with scan_size B and a window of 16 scans
(multicloud_size 16 B, unless given), writes NAME.sweepB.result into the
dataset directory and evaluates it against NAME.relations; then it
draws OUT (two panels, translational and rotational ATE against beams
with the standard deviations as error bars, by the port's own PNG
writer) and writes OUT.json. With --kernels it runs the reference's
smoothing-kernel ablation instead (half-widths 0 = off, 1 = 3x3, ...,
at the dataset's scan_size), each with the acceptance threshold scaled
by the kernel's peak-score scale C(2s, s) / 4^s, into OUT.kernels.json.
--device is the runner's (the card by default; no fallback to the CPU),
--accel-branch takes the JAX package's accelerator branch as the runner
does. The runs write into the dataset directory: run it on a copy.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

# 3x5 digits for the tick labels (rows top to bottom, 3 bits each)
_GLYPHS = {
    "0": (7, 5, 5, 5, 7), "1": (2, 6, 2, 2, 7), "2": (7, 1, 7, 4, 7),
    "3": (7, 1, 7, 1, 7), "4": (5, 5, 7, 1, 1), "5": (7, 4, 7, 1, 7),
    "6": (7, 4, 7, 5, 7), "7": (7, 1, 1, 1, 1), "8": (7, 5, 7, 5, 7),
    "9": (7, 5, 7, 1, 7), ".": (0, 0, 0, 0, 2),
}


def run_one(dataset_dir, name, scan_size, multicloud_size=None, kernel=None,
            min_score_scale=1.0, device="cuda", accel_branch=False):
    """One full run at `scan_size` beams; returns its ATEResult."""
    from ..io.providers import create_data_provider
    from ..models.slam import SlamSystem
    from ..utils.config import load_dataset_config
    from .relations import evaluate_files

    slam_cfg, ls_cfg = load_dataset_config(dataset_dir)
    slam_cfg.scan_size = scan_size
    # ~16 scans per multicloud like the shipped configs
    slam_cfg.multicloud_size = multicloud_size or scan_size * 16
    if kernel is not None:
        # smoothing scales peak scores down (a point on a 1-cell wall
        # drops from ~0.9 to ~0.5 under the 3x3 kernel); the acceptance
        # threshold scales with it so the ablation compares like with like
        slam_cfg.smoothing_kernel = kernel
        slam_cfg.loop_closure_min_score *= min_score_scale
    prefix = os.path.join(dataset_dir, name)
    provider = create_data_provider(slam_cfg.data_provider, prefix + ".log")
    system = SlamSystem(slam_cfg, ls_cfg, device=device,
                        accel_branch=accel_branch)
    for frame in provider.frames():
        system.process_frame(frame)
    system.final_cleanup()
    out = prefix + f".sweep{scan_size}.result"
    system.write_result(out)
    return evaluate_files(out, prefix + ".relations")


def kernel_scale(s: int) -> float:
    """Peak-score scale of a (2s+1)-tap binomial on a 1-cell wall line:
    the central row of the separable kernel summed along the wall."""
    return math.comb(2 * s, s) / (4.0 ** s) if s > 0 else 1.0


def _text(img, x, y, s, color):
    """Draw s (digits and '.') with its top left at pixel (x, y), 2x."""
    for ch in s:
        for r, bits in enumerate(_GLYPHS.get(ch, (0,) * 5)):
            for c in range(3):
                if bits >> (2 - c) & 1:
                    yy, xx = y + 2 * r, x + 2 * c
                    img[yy:yy + 2, xx:xx + 2] = color
        x += 8


def _segment(img, a, b, color):
    """Pixels of the segment from (x, y) a to b."""
    n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
    t = np.linspace(0.0, 1.0, n)
    x = np.rint(a[0] + (b[0] - a[0]) * t).astype(int)
    y = np.rint(a[1] + (b[1] - a[1]) * t).astype(int)
    ok = (x >= 0) & (x < img.shape[1]) & (y >= 0) & (y < img.shape[0])
    img[y[ok], x[ok]] = color


def _panel(xs, means, stds, color, w=420, h=300):
    """(h, w, 3) uint8 plot of means against xs with +-std error bars."""
    img = np.full((h, w, 3), 255, np.uint8)
    left, right, top, bottom = 48, w - 16, 16, h - 32
    top_v = max(m + s for m, s in zip(means, stds)) * 1.1 or 1.0
    pad = 0.05 * ((max(xs) - min(xs)) or 1.0)
    lo_x, hi_x = min(xs) - pad, max(xs) + pad
    span_x = hi_x - lo_x

    def px(x):
        return left + (x - lo_x) / span_x * (right - left)

    def py(v):
        return bottom - max(v, 0.0) / top_v * (bottom - top)

    black, grey = (0, 0, 0), (200, 200, 200)
    for k in range(5):  # y grid and labels
        v = top_v * k / 4
        _segment(img, (left, py(v)), (right, py(v)), grey if k else black)
        _text(img, 2, int(py(v)) - 5, f"{v:.3g}"[:5], black)
    _segment(img, (left, top), (left, bottom), black)
    for x in xs:  # x ticks and labels
        _segment(img, (px(x), bottom), (px(x), bottom + 5), black)
        _text(img, int(px(x)) - 4 * len(str(x)), bottom + 9, str(x), black)
    pts = [(px(x), py(m)) for x, m in zip(xs, means)]
    for a, b in zip(pts, pts[1:]):
        _segment(img, a, b, color)
    for x, m, s in zip(xs, means, stds):
        c = px(x)
        _segment(img, (c, py(m - s)), (c, py(m + s)), color)
        for v in (m - s, m + s):
            _segment(img, (c - 4, py(v)), (c + 4, py(v)), color)
        ix, iy = int(round(c)), int(round(py(m)))
        img[max(iy - 3, 0):iy + 4, max(ix - 3, 0):ix + 4] = color
    return img


def plot(results: dict, path: str) -> None:
    """Translational (m) and rotational (deg) ATE against beams, side by
    side, with +-std error bars, as one PNG."""
    from .maps import write_png

    xs = sorted(results)
    t = _panel(xs, [results[b]["trans_mean"] for b in xs],
               [results[b]["trans_std"] for b in xs], (31, 119, 180))
    r = _panel(xs, [results[b]["rot_mean_deg"] for b in xs],
               [results[b]["rot_std_deg"] for b in xs], (214, 39, 40))
    write_png(path, np.concatenate([t, r], axis=1))


def _row(res) -> dict:
    return {"trans_mean": res.trans_mean, "trans_std": res.trans_std,
            "rot_mean_deg": float(np.degrees(res.rot_mean)),
            "rot_std_deg": float(np.degrees(res.rot_std))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset_dir")
    ap.add_argument("name")
    ap.add_argument("--beams", type=int, nargs="+", default=[4, 6, 8, 11])
    ap.add_argument(
        "--kernels", type=int, nargs="+", default=None,
        help="smoothing-kernel ablation instead of a beam sweep: kernel "
        "half-widths (0=off, 1=3x3, 2=5x5, 3=7x7) at the dataset's "
        "scan_size")
    ap.add_argument("--out", default="sweep.png")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--accel-branch", action="store_true",
                    help="the JAX package's accelerator branch (the "
                    "runner's --accel-branch)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("--device cuda: no CUDA device (use --device cpu)",
                  file=sys.stderr)
            return 2
    kw = dict(device=args.device, accel_branch=args.accel_branch)
    if args.kernels is not None:
        from ..utils.config import load_dataset_config

        slam_cfg, _ = load_dataset_config(args.dataset_dir)
        rows = {}
        for s in args.kernels:
            res = run_one(args.dataset_dir, args.name, slam_cfg.scan_size,
                          slam_cfg.multicloud_size, kernel=s,
                          min_score_scale=kernel_scale(s), **kw)
            rows[str(s)] = {k: v for k, v in _row(res).items()
                            if k != "rot_std_deg"}
            print(f"kernel={2 * s + 1}x{2 * s + 1}: {res}", flush=True)
        with open(args.out + ".kernels.json", "w") as fh:
            json.dump(rows, fh, indent=2)
        print(f"-> {args.out}.kernels.json")
        return 0
    results = {}
    for b in args.beams:
        res = run_one(args.dataset_dir, args.name, b, **kw)
        results[b] = _row(res)
        print(f"beams={b}: {res}", flush=True)
    plot(results, args.out)
    print(f"plot -> {args.out}")
    with open(args.out + ".json", "w") as fh:
        json.dump({str(b): results[b] for b in sorted(results)}, fh,
                  indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
