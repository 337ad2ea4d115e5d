"""The port's beam sweep (sparse_gslam_tpu_torch/eval/sweep.py, the
counterpart of scripts/sweep.py) on a cut sim-office: its first 40
frames, with relations one second apart from its ground truth between
4 s (after its first keyframes) and the cut's end (the dataset's own
relations start at 20 s).

- a beam sweep through main(): one .sweepB.result per beam count, the
  ATE of each equal to relations.evaluate_files on that file, the JSON
  keys of scripts/sweep.py, and a PNG that decodes to the two panels;
- the smoothing-kernel ablation: the acceptance threshold scaled by the
  JAX script's binomial scale, the kernel set in the config, its JSON;
- --device cuda without a card refuses to run (no fallback to the CPU).

The full-length sweep points are held against the JAX package's runs by
chip_smoke.py (beams4; beams6 and beams8 under --all-worlds) and, on
the CPU, by scripts/compare_world_run.py.
"""
import json
import math
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from sparse_gslam_tpu_torch.eval import sweep
from sparse_gslam_tpu_torch.eval.relations import (
    evaluate_files,
    save_relations,
)
from sparse_gslam_tpu_torch.utils import se2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cut_office(tmp_path):
    d = tmp_path / "so"
    shutil.copytree(os.path.join(REPO, "datasets", "sim-office"), d)
    lines = (d / "sim-office.log").read_text().splitlines(True)[:FRAMES]
    (d / "sim-office.log").write_text("".join(lines))
    t_end = max(float(ln.split()[-3]) for ln in lines)
    gt = np.loadtxt(d / "sim-office.gt")
    gt = gt[gt[:, 0] <= t_end + 1e-9]
    pose = {round(t, 6): p for t, p in zip(gt[:, 0], gt[:, 1:])}
    t1 = [t for t in pose if t >= 4.0 and round(t + 1.0, 6) in pose]
    t2 = [round(t + 1.0, 6) for t in t1]
    save_relations(str(d / "sim-office.relations"), t1, t2,
                   [se2.relative(pose[a], pose[b]) for a, b in zip(t1, t2)])
    assert len(t1) >= 10
    return d


def read_png(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG with one IDAT chunk."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    at = data.index(b"IDAT")
    n = struct.unpack(">I", data[at - 4:at])[0]
    raw = zlib.decompress(data[at + 4:at + 4 + n])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_beam_sweep_files(cut_office, tmp_path):
    out = str(tmp_path / "sweep.png")
    assert sweep.main([str(cut_office), "sim-office", "--beams", "4", "6",
                       "--device", "cpu", "--out", out]) == 0
    with open(out + ".json") as fh:
        rows = json.load(fh)
    assert list(rows) == ["4", "6"]
    for b in (4, 6):
        res = str(cut_office / f"sim-office.sweep{b}.result")
        stamps = [float(ln.split()[-1]) for ln in open(res)]
        assert 2 <= len(stamps) <= FRAMES and stamps == sorted(stamps)
        ate = evaluate_files(res, str(cut_office / "sim-office.relations"))
        assert rows[str(b)] == {
            "trans_mean": ate.trans_mean, "trans_std": ate.trans_std,
            "rot_mean_deg": float(np.degrees(ate.rot_mean)),
            "rot_std_deg": float(np.degrees(ate.rot_std))}
        assert all(np.isfinite(v) for v in rows[str(b)].values())
    img = read_png(out)
    assert img.shape == (300, 840, 3)
    blue = (img == np.array([31, 119, 180], np.uint8)).all(-1)
    red = (img == np.array([214, 39, 40], np.uint8)).all(-1)
    assert blue[:, :420].any() and not blue[:, 420:].any()
    assert red[:, 420:].any() and not red[:, :420].any()


def test_kernel_ablation_scales_the_threshold(cut_office, tmp_path,
                                              monkeypatch):
    from sparse_gslam_tpu_torch.models import slam

    seen = []
    init = slam.SlamSystem.__init__

    def spy(self, config, *a, **k):
        seen.append((config.smoothing_kernel, config.loop_closure_min_score,
                     config.scan_size))
        init(self, config, *a, **k)

    monkeypatch.setattr(slam.SlamSystem, "__init__", spy)
    out = str(tmp_path / "k.png")
    assert sweep.main([str(cut_office), "sim-office", "--kernels", "1",
                       "--device", "cpu", "--out", out]) == 0
    # scripts/sweep.py's scale: the 3-tap binomial's central row
    assert sweep.kernel_scale(1) == math.comb(2, 1) / 4.0 == 0.5
    assert sweep.kernel_scale(0) == 1.0
    assert sweep.kernel_scale(3) == math.comb(6, 3) / 4.0 ** 3
    assert seen == [(1, 0.7 * 0.5, 11)]
    with open(out + ".kernels.json") as fh:
        rows = json.load(fh)
    assert list(rows) == ["1"]
    assert set(rows["1"]) == {"trans_mean", "trans_std", "rot_mean_deg"}
    assert os.path.exists(cut_office / "sim-office.sweep11.result")


def test_cuda_without_a_card_refuses(cut_office, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert sweep.main([str(cut_office), "sim-office", "--beams", "4",
                       "--out", str(tmp_path / "s.png")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(cut_office / "sim-office.sweep4.result")
