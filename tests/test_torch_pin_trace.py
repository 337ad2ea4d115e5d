"""The host pins' spans and counters (models/backend.py) on the CPU.

The run: sim-office resumed from the committed frame-330 checkpoint
(`sparse_gslam_tpu_torch/data/sim-office-ckpt330*.npz`, the first 330
frames of the committed log) through frame 350's backend tick, in two
SlamSystems, the recorder on in one and off in the other. It is the
cheapest stretch of the committed log in which pins reach their
refinement at 11 beams: before the tick at frame 325 every pin stops at
its pooled bound or its score gate, and frame 350's tick refines 23
pins, one chain edge and one loop closure. Resuming costs ~8 s of grid
rebuilds against ~19 s for the 326-frame prefix.

- slam.backend.pin_bound, pin_window, pin_cov and pin_refine nest in
  slam.backend.kf_edges, are their prof keys' seconds, and sum to at
  most prof["kf_edges"];
- the counters pins.<reason> equal kf_stats;
- the tally refine.n counts every backend refinement launch, by caller
  and padded N;
- the outputs are bit-identical with the recorder on and off;
- the runner's --profile prints refine.n."""
import collections
import os
import shutil

import numpy as np
import pytest
import torch

from sparse_gslam_tpu_torch import runner
from sparse_gslam_tpu_torch.io.providers import create_data_provider
from sparse_gslam_tpu_torch.models.slam import SlamSystem
from sparse_gslam_tpu_torch.ops import matching
from sparse_gslam_tpu_torch.utils.checkpoint import load_checkpoint
from sparse_gslam_tpu_torch.utils.config import load_dataset_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFICE = os.path.join(ROOT, "datasets", "sim-office")
DATA = os.path.join(ROOT, "sparse_gslam_tpu_torch", "data")
END_FRAME = 351  # through frame 350's backend tick
PIN_SPANS = ("pin_bound", "pin_window", "pin_cov", "pin_refine")
REFINES = ("refine_pose_cov", "refine_pose_cov_two_stage")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _resumed(enabled):
    """A SlamSystem at the checkpoint, with the runner fields the
    checkpoint leaves out set from its sidecar; the first frame to
    run."""
    system = SlamSystem(*load_dataset_config(OFFICE), enable_backend=True,
                        device="cpu")
    system.rec.enabled = enabled
    load_checkpoint(os.path.join(DATA, "sim-office-ckpt330.npz"), system)
    with np.load(os.path.join(DATA, "sim-office-ckpt330-run.npz")) as z:
        system.frame_idx = int(z["frame_idx"])
        system.deltas = list(z["deltas"])
        system.zero_pose = z["zero_pose"].copy()
        system.last_pose = z["last_pose"].copy()
        system.mc._cloud_odom = z["cloud_odom"].copy()
        return system, int(z["cut"])


@pytest.fixture(scope="module")
def runs():
    """(on, off, the padded N of each refinement call of both runs, by
    function)."""
    frames = list(create_data_provider(
        "carmen", os.path.join(OFFICE, "sim-office.log")).frames())
    calls = collections.defaultdict(list)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for name in REFINES:
            inner = getattr(matching, name)

            def counted(*a, _inner=inner, _name=name, **k):
                # the padded points follow the grids: 3 of them for one
                # stage, 6 for two
                calls[_name].append(int(a[6 if "two" in _name else 3]
                                        .shape[0]))
                return _inner(*a, **k)
            mp.setattr(matching, name, counted)
        for enabled in (True, False):
            system, cut = _resumed(enabled)
            for fr in frames[cut:END_FRAME]:
                system.process_frame(fr)
            out.append(system)
    return out[0], out[1], calls


def test_pin_spans_nest_in_kf_edges(runs):
    on = runs[0]
    prof = on.backend.prof
    for key in PIN_SPANS:
        spans = on.rec.closed("slam.backend." + key)
        assert spans, key
        for s in spans:
            assert s.parent.name == "slam.backend.kf_edges", s
            assert s.parent.start_ns <= s.start_ns <= s.end_ns <= (
                s.parent.end_ns)
        assert prof[key] == pytest.approx(sum(s.seconds for s in spans),
                                          rel=1e-12), key
    for system in runs[:2]:
        prof = system.backend.prof
        assert set(PIN_SPANS) <= set(prof)
        assert sum(prof[k] for k in PIN_SPANS) <= prof["kf_edges"]


def test_pin_counters_equal_kf_stats(runs):
    for system in runs[:2]:
        counts = system.rec.counts
        pins = {k[len("pins."):]: v for k, v in counts.items()
                if k.startswith("pins.")}
        assert pins == {k: v for k, v in system.backend.kf_stats.items()
                        if v}
        # pins reach every gate on this stretch but the last
        assert pins.get("score", 0) > 0 and pins.get("bound", 0) > 0


def test_refine_tally_counts_every_launch(runs):
    on, off, calls = runs
    made = collections.Counter(n for ns in calls.values() for n in ns)
    tallied = collections.Counter()
    for system in (on, off):
        tally = system.rec.tallies("refine.n")
        assert {c for c, _ in tally} <= {"pin", "closure", "chain", "map"}
        assert all(n % 256 == 0 for _, n in tally)
        for (_, n), k in tally.items():
            tallied[n] += k
    assert tallied == made
    tally = on.rec.tallies("refine.n")
    assert tally == off.rec.tallies("refine.n")
    # the refined pins are the ones that passed the score gate
    assert sum(k for (c, _), k in tally.items() if c == "pin") == len(
        on.rec.closed("slam.backend.pin_refine")) > 0
    assert {"pin", "closure", "chain"} <= {c for c, _ in tally}


def test_outputs_bit_identical_on_and_off(runs):
    on, off = runs[:2]
    np.testing.assert_array_equal(on.frontend.estimates(),
                                  off.frontend.estimates())
    np.testing.assert_array_equal(on.backend.pose_estimates(),
                                  off.backend.pose_estimates())
    assert [(c.kind, c.i, c.j, c.active) for c in on.backend.closures] == [
        (c.kind, c.i, c.j, c.active) for c in off.backend.closures]
    for a, b in zip(on.backend.closures, off.backend.closures):
        np.testing.assert_array_equal(a.meas, b.meas)
        np.testing.assert_array_equal(a.info, b.info)
    assert on.rec.counts == off.rec.counts and off.rec.spans == []


def test_runner_profile_prints_refine_tally(tmp_path, capsys):
    """76 frames: the first chain edge (frame 75's tick) refines."""
    d = tmp_path / "so"
    shutil.copytree(OFFICE, d)
    with open(d / "sim-office.log") as f:
        lines = f.readlines()[:76]
    with open(d / "sim-office.log", "w") as f:
        f.writelines(lines)
    runner.main(["--dataset-dir", str(d), "--dataset-name", "sim-office",
                 "--device", "cpu", "--profile", str(tmp_path / "trace")])
    text = capsys.readouterr().out.splitlines()
    line = [ln for ln in text if ln.startswith("refine.n ")]
    assert len(line) == 1 and "(chain, 256) x " in line[0], line
    counters = [ln for ln in text if ln.startswith("counters:")]
    assert len(counters) == 1 and "pins.bound" in counters[0]
