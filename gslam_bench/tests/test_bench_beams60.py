"""The beams60 configuration, its cell and the per-layer metrics it
reports, on synthetic inputs (no card, no run)."""
import json
import os

import pytest
import torch

from gslam_bench import roofline, run
from gslam_bench.compare import CHECKS, load_cell_file

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
PIN_READERS = {"pin_window_ms": "pin_window", "pin_refine_ms": "pin_refine",
               "match_apply_ms": "match_apply"}


class _Event:
    """Stands in for a CUDA event: elapsed_time in ms to the other."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _launch(n, steps, ms, want_cov=True):
    return ((n, torch.tensor([steps], dtype=torch.int32), want_cov),
            _Event(0.0), _Event(ms))


@pytest.mark.parametrize("name", sorted(PIN_READERS))
def test_span_readers(name):
    key = PIN_READERS[name]
    prof = {key: 0.6, "kf_edges": 2.0}
    assert run.read_metric(name, {"prof": prof, "backend_ticks": 24}) == (
        pytest.approx(25.0))
    # no such span (the parent's program), no time, no tick: nothing
    for ctx in ({"prof": {"kf_edges": 2.0}, "backend_ticks": 24},
                {"prof": {key: 0.0}, "backend_ticks": 24},
                {"prof": {key: 0.6}, "backend_ticks": 0},
                {"prof": {}, "backend_ticks": 0}):
        assert run.read_metric(name, ctx) is None


def test_refine_wide_roofline_reads_only_wide_launches():
    peak = roofline.peaks(H100)
    wide = [_launch(512, [3, 2], 0.05), _launch(4096, [4, 0], 0.2, False)]
    narrow = [_launch(256, [2, 2], 0.01)]
    least = sum(roofline.bound_s(*roofline.refine_work(n, s.tolist()[0], c),
                                 peak)
                for (n, s, c), _, _ in wide)
    want = 100.0 * least / 0.25e-3
    ctx = {"device_kind": H100, "launches": {"refine_pose": wide + narrow}}
    got = run.read_metric("refine_wide_roofline", ctx)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got < 100
    # all N counted, as refine_pose_roofline reads them, differs
    assert run.read_metric("refine_pose_roofline", ctx) != pytest.approx(got)
    for ctx in ({"device_kind": H100, "launches": {"refine_pose": narrow}},
                {"device_kind": H100, "launches": {"refine_pose": []}},
                {"device_kind": "cpu", "launches": {"refine_pose": wide}}):
        assert run.read_metric("refine_wide_roofline", ctx) is None


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_beams60_is_beams11_at_60_beams():
    a, b = _config("beams11"), _config("beams60")
    assert a["line_extractor"] == b["line_extractor"]
    assert a["deployment"] == b["deployment"] and b["reduced"] == []
    diff = {k for k in a["slam"].keys() | b["slam"].keys()
            if a["slam"].get(k) != b["slam"].get(k)}
    assert diff == {"scan_size", "multicloud_size"}
    assert (b["slam"]["scan_size"], b["slam"]["multicloud_size"]) == (60, 960)
    # the same 16 scans a multicloud window
    assert (a["slam"]["multicloud_size"] // a["slam"]["scan_size"]
            == b["slam"]["multicloud_size"] // b["slam"]["scan_size"])


EXACT = ("closures", "refine_gap")
CONTROLS = ("upper", "upper_at_trace_end")


@pytest.mark.parametrize("check", CHECKS)
def test_cell_limits_between_their_readings(check):
    cell = load_cell_file("beams60.office")
    limit = cell["limits"][check]
    lower = cell["readings"]["lower"][check]
    uppers = [v for key in CONTROLS for v in cell["readings"][key][check]]
    if check in EXACT:
        # an exact comparison: nothing to set but 0, which the control
        # passes only where it has not yet moved the number
        assert limit == lower == 0 and max(uppers) > 0
    else:
        # room on both sides
        assert lower < limit < min(uppers)


def test_control_fails_every_reading():
    """Each control reading fails the cell by at least one limit."""
    cell = load_cell_file("beams60.office")
    limits = cell["limits"]
    for key in CONTROLS:
        reading = cell["readings"][key]
        for i in range(len(reading["lm_pose_gap"])):
            assert any(reading[k][i] > limits[k] for k in CHECKS), (key, i)
    a, b = cell["trace_frames"]
    assert b - a == 27
