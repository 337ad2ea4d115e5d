"""End-to-end arithmetic over synthetic tick lists, and the roofline
copies against chip_smoke.py's values."""
import numpy as np
import pytest
import torch

from gslam_bench import roofline, run


def _read(name, ft, bt):
    return run.read_metric(name, {"frontend_times": ft, "backend_times": bt})


def test_rate_percentile_mean():
    ft = [0.030] * 95 + [0.200] * 5
    bt = [0.100, 0.300]
    out = run.end_to_end(done=120, window_s=6.0, setup_s=12.5)
    assert out == {"frames_per_s": (20.0, "frames/s"), "setup_s": (12.5, "s")}
    assert _read("backend_ms_mean.host", ft, bt) == pytest.approx(200.0)
    assert _read("frontend_ms_p95.host", ft, bt) == pytest.approx(
        float(np.percentile(ft, 95)) * 1e3)
    assert _read("frontend_ms_p95.host", [], []) is None
    assert _read("backend_ms_mean.host", ft, []) is None


def test_window_with_one_stall():
    """One 3 s stall in the window: the rate takes all the window's time,
    the p95 tail and the backend mean count the stalled tick."""
    ft = [0.040] * 199 + [3.0]
    bt = [0.150] * 9 + [3.0]
    calm = run.end_to_end(done=240, window_s=9.0, setup_s=1.0)
    out = run.end_to_end(done=240, window_s=12.0, setup_s=1.0)
    assert out["frames_per_s"][0] == pytest.approx(20.0)
    assert calm["frames_per_s"][0] > out["frames_per_s"][0]
    assert _read("frontend_ms_p95.host", ft, bt) == pytest.approx(
        float(np.percentile(ft, 95)) * 1e3)
    assert _read("backend_ms_mean.host", ft, bt) == pytest.approx(
        (9 * 150.0 + 3000.0) / 10)
    assert _read("backend_ms_mean.host", ft, bt) > 2 * _read(
        "backend_ms_mean.host", ft, bt[:-1])


def test_insertion_work_matches_chip_smoke():
    """chip_smoke.insertion_bound on this case (computed on the CPU):
    33696 bytes, 12433 operations, bound by bytes, 1.0058507462686566e-05
    ms."""
    g = torch.Generator().manual_seed(5)
    S, B, size = 6, 16, 64
    probs = torch.zeros(size, size)
    org = torch.tensor([-3.2, -3.2])
    origins = torch.rand(S, 2, generator=g) - 0.5
    pts = (torch.rand(S, B, 2, generator=g) - 0.5) * 7.0
    kind = torch.randint(0, 3, (S, B), generator=g).to(torch.int8)
    hm = torch.tensor([0.55, 0.49])
    args = (probs, org, origins, pts, kind, hm, 0.1, 12, size)
    nbytes, ops = roofline.insertion_work(args)
    assert (nbytes, ops) == (33696, 12433)
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert roofline.bound_s(nbytes, ops, peak) * 1e3 == pytest.approx(
        1.0058507462686566e-05, rel=1e-12)


@pytest.mark.parametrize("n,steps,want_cov,cells,ref", [
    # chip_smoke.refine_bound_parts(stages, n, cells, 10, want_cov):
    # (bytes ms, operations ms)
    (256, [10, 10], True, 1000, (2.2113432835820894e-06,
                                 3.9296597014925375e-05)),
    (1024, [10, 0], False, 0, (2.7617910447761194e-06,
                               7.491701492537314e-05)),
])
def test_refine_work_matches_chip_smoke(n, steps, want_cov, cells, ref):
    """The copy counts the same operations for all ten steps of each
    stage; its bytes leave out the `cells` grid cells that chip_smoke
    counts from a tap recorder."""
    nbytes, ops = roofline.refine_work(n, steps, want_cov)
    assert (nbytes + 4 * cells) / 3.35e12 * 1e3 == pytest.approx(
        ref[0], rel=1e-12)
    assert ops / 67e12 * 1e3 == pytest.approx(ref[1], rel=1e-12)


def test_refine_work_counts_steps_run():
    full = roofline.refine_work(512, [10, 10])[1]
    early = roofline.refine_work(512, [3, 2])[1]
    assert early < full


def test_unknown_card_has_no_peak():
    assert roofline.peaks("cpu") is None
