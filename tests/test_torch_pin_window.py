"""The host pins' window correlation on the card (ops/pin_window_cuda.py,
csrc/pin_window.cu) against its numpy version: the JAX package's
correlate_window_host (sparse_gslam_tpu/ops/matching.py) and the port's
copy of it (ops/matching.py).

- On the CPU the kernel's loop, built for the host with g++
  (csrc/pin_window_host.cpp, the kernel's header csrc/pin_window.cuh), is
  bit-equal to the JAX package's correlate_window_host, and so is the
  port's, over N = 12, 100, 511, 512 query points, R = 33, 65 rotations
  and 320^2, 576^2 grids, with the query in the grid, across its edge and
  wholly outside it; matching.correlate_window on a CPU grid returns
  those bits and counts pin_window.host; and chip_smoke.py's count of the
  grid cells a window reads (its bound's bytes) is the cells' own count.
- On the card (gpu marker; jax-free, `pytest --noconftest -m gpu`): the
  kernel through matching.correlate_window is bit-equal to the port's
  correlate_window_host on the same cases (which the CPU cases hold equal
  to the JAX package's), on the default stream and on a side stream; and
  two stretches of sim-office on the card score every pin window with the
  kernel, each bit-equal to correlate_window_host, each _kf_edges_host
  call giving the same kf_stats and closures as the same call with the
  windows on the host: 11 beams from the committed frame-330 checkpoint
  through frame 350's tick (tests/test_torch_pin_trace.py's stretch; its
  pins all fail their bound or score), and 60 beams from the log's start
  through frame 325's tick, which accepts 10 pins.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
from sparse_gslam_tpu_torch.ops import matching, pin_window_cuda
from sparse_gslam_tpu_torch.ops.grid import PMIN
from sparse_gslam_tpu_torch.utils.trace import Recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFICE = os.path.join(ROOT, "datasets", "sim-office")
DATA = os.path.join(ROOT, "sparse_gslam_tpu_torch", "data")
RES = 0.1
N_LINEAR = 8  # search_spec(0.8, ...) at 0.1 m: a 17 x 17 window
# where the query's centre sits along x, in grid widths from the grid's
# corner: in the middle, on the edge (part of the points and of the window
# leave the grid) and a width outside (every cell clipped)
PLACES = {"inside": 0.5, "edge": 0.0, "outside": -1.0}
CASES = [(n, r, s) for n in (12, 100, 511, 512) for r in (33, 65)
         for s in (320, 576)]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these cases run only on a GPU")


def window_case(n, rotations, size, place, seed):
    """(float32 score grid (size, size), origin, points (n, 2), thetas)
    of a pin window: a grid of dilated scores in [PMIN, 0.9] with PMIN
    where unknown, a query of radius up to 6 m around the seed."""
    rng = np.random.default_rng([n, rotations, size, seed])
    grid = rng.uniform(PMIN, 0.9, (size, size)).astype(np.float32)
    grid[rng.random((size, size)) < 0.5] = np.float32(PMIN)
    pts = rng.normal(0.0, 2.0, (n, 2)).clip(-6.0, 6.0)
    width = size * RES
    origin = -width * np.array([PLACES[place], 0.5]) + rng.normal(
        0.0, 0.05, 2)
    n_ang = (rotations - 1) // 2
    thetas = rng.uniform(-np.pi, np.pi) + np.arange(-n_ang, n_ang + 1) * (
        0.2 / n_ang)
    return grid, origin, pts, thetas


def host_volume(grid, origin, pts, thetas):
    return matching.correlate_window_host(grid.astype(np.float64), origin,
                                          RES, pts, thetas, N_LINEAR)


def jax_volume(grid, origin, pts, thetas):
    """The JAX package's correlate_window_host (numpy) on the same
    inputs; imported here, since the card's tests run without JAX."""
    from sparse_gslam_tpu.ops import matching as jm

    return jm.correlate_window_host(grid.astype(np.float64), origin, RES,
                                    pts, thetas, N_LINEAR)


def out_of_grid_share(grid, origin, pts, thetas):
    cx, cy = matching._window_cells(origin, RES, pts, thetas)
    S = grid.shape[0]
    inside = (cx >= 0) & (cx < S) & (cy >= 0) & (cy < S)
    return 1.0 - inside.mean()


@pytest.mark.parametrize("n,rotations,size", CASES)
def test_host_build_bit_equal_to_numpy(n, rotations, size):
    for seed, place in enumerate(PLACES):
        grid, origin, pts, thetas = window_case(n, rotations, size, place,
                                                seed)
        share = out_of_grid_share(grid, origin, pts, thetas)
        assert {"inside": share == 0.0, "edge": 0.0 < share < 1.0,
                "outside": share == 1.0}[place], (place, share)
        cells = matching._packed_cells(origin, RES, pts, thetas, N_LINEAR,
                                       size)
        assert cells.shape == (2, rotations, n) and cells.dtype == np.int32
        want = jax_volume(grid, origin, pts, thetas)
        got = pin_window_cuda.pin_window_host(grid, cells, N_LINEAR, PMIN)
        assert want.shape == (rotations, 2 * N_LINEAR + 1,
                              2 * N_LINEAR + 1)
        assert np.array_equal(got, want), (place, np.abs(got - want).max())
        assert np.array_equal(host_volume(grid, origin, pts, thetas), want)


@pytest.mark.parametrize("place", list(PLACES))
def test_bound_counts_the_grid_cells_read(place):
    import chip_smoke

    for k, (n, rotations, size) in enumerate(CASES[:4]):
        grid, origin, pts, thetas = window_case(n, rotations, size, place,
                                                k)
        cells = matching._packed_cells(origin, RES, pts, thetas, N_LINEAR,
                                       size)
        read = {(x + dx, y + dy)
                for x, y in set(zip(cells[0].ravel(), cells[1].ravel()))
                for dx in range(-N_LINEAR, N_LINEAR + 1)
                for dy in range(-N_LINEAR, N_LINEAR + 1)
                if 0 <= x + dx < size and 0 <= y + dy < size}
        assert chip_smoke.window_grid_cells(cells, size, N_LINEAR) == len(
            read)


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_correlate_window_on_cpu_is_numpy(kind):
    grid, origin, pts, thetas = window_case(512, 65, 320, "edge", 7)
    rec = Recorder()
    g = torch.from_numpy(grid) if kind == "tensor" else grid
    got = matching.correlate_window(g, origin, RES, pts, thetas, N_LINEAR,
                                    rec)
    want = jax_volume(grid, origin, pts, thetas)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert rec.counts == {"pin_window.host": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("stream", ["default", "side"])
def test_kernel_bit_equal_to_numpy(stream):
    need_card()
    pin_window_cuda.load()
    dev = torch.device("cuda")
    rec = Recorder()
    before = pin_window_cuda.pin_window_cuda.launches
    side = torch.cuda.Stream(dev) if stream == "side" else None
    scored = 0
    for n, rotations, size in CASES:
        for seed, place in enumerate(PLACES):
            grid, origin, pts, thetas = window_case(n, rotations, size,
                                                    place, seed)
            g = torch.from_numpy(grid).to(dev)
            if side is not None:
                side.wait_stream(torch.cuda.current_stream(dev))
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                got = matching.correlate_window(g, origin, RES, pts, thetas,
                                                N_LINEAR, rec)
            want = host_volume(grid, origin, pts, thetas)
            assert np.array_equal(got, want), (
                n, rotations, size, place, np.abs(got - want).max())
            scored += 1
    assert rec.counts == {"pin_window.device": scored}
    assert pin_window_cuda.pin_window_cuda.launches == before + scored


def office_stretch(stretch):
    """A SlamSystem on the card and the frames to run: `ckpt330` resumes
    the committed frame-330 checkpoint (11 beams) up to frame 350's tick;
    `beams60` starts the 60-beam office (the `beams60` configuration's
    scan_size and multicloud_size) and runs through frame 325's tick."""
    import dataclasses

    from sparse_gslam_tpu_torch.io.providers import create_data_provider
    from sparse_gslam_tpu_torch.models.slam import SlamSystem
    from sparse_gslam_tpu_torch.utils.checkpoint import load_checkpoint
    from sparse_gslam_tpu_torch.utils.config import load_dataset_config

    frames = list(create_data_provider(
        "carmen", os.path.join(OFFICE, "sim-office.log")).frames())
    slam, extractor = load_dataset_config(OFFICE)
    if stretch == "beams60":
        slam = dataclasses.replace(slam, scan_size=60, multicloud_size=960)
        system = SlamSystem(slam, extractor, enable_backend=True,
                            device="cuda")
        return system, frames[:326]
    system = SlamSystem(slam, extractor, enable_backend=True, device="cuda")
    load_checkpoint(os.path.join(DATA, "sim-office-ckpt330.npz"), system)
    with np.load(os.path.join(DATA, "sim-office-ckpt330-run.npz")) as z:
        system.frame_idx = int(z["frame_idx"])
        system.deltas = list(z["deltas"])
        system.zero_pose = z["zero_pose"].copy()
        system.last_pose = z["last_pose"].copy()
        system.mc._cloud_odom = z["cloud_odom"].copy()
        cut = int(z["cut"])
    return system, frames[cut:351]


@pytest.mark.gpu
@pytest.mark.parametrize("stretch", ["ckpt330", "beams60"])
def test_office_pins_on_card(monkeypatch, stretch):
    """Each _kf_edges_host call of the stretch runs twice from the same
    state: first with its windows scored on the host (the grid handed
    over as a CPU tensor), then as it runs, on the card; the second keeps
    its results and must book the same kf_stats and closures."""
    need_card()
    cw, kf = matching.correlate_window, SubmapLoopCloser._kf_edges_host
    on_host = [False]
    windows, calls, compared = [0], [0], [0]

    def correlate_window(score_grid, *args):
        if on_host[0]:
            return cw(score_grid.cpu(), *args)
        got = cw(score_grid, *args)
        want = matching.correlate_window_host(
            score_grid.cpu().numpy().astype(np.float64), *args[:-1])
        assert np.array_equal(got, want), np.abs(got - want).max()
        windows[0] += 1
        return got

    def kf_edges_host(self, pending):
        n0, stats0 = len(self.closures), dict(self.kf_stats)
        on_host[0] = True
        try:
            made_host = kf(self, pending)
        finally:
            on_host[0] = False
        closures_host = self.closures[n0:]
        stats_host = dict(self.kf_stats)
        del self.closures[n0:]
        self.kf_stats.update(stats0)
        made = kf(self, pending)
        assert made == made_host and self.kf_stats == stats_host
        got = self.closures[n0:]
        assert [(c.kind, c.i, c.j) for c in got] == [
            (c.kind, c.i, c.j) for c in closures_host]
        for a, b in zip(got, closures_host):
            assert np.array_equal(a.meas, b.meas)
            assert np.array_equal(a.info, b.info)
            compared[0] += 1
        calls[0] += 1
        return made

    monkeypatch.setattr(matching, "correlate_window", correlate_window)
    monkeypatch.setattr(SubmapLoopCloser, "_kf_edges_host", kf_edges_host)
    system, frames = office_stretch(stretch)
    for fr in frames:
        system.process_frame(fr)
    counts = system.rec.counts
    stats = system.backend.kf_stats
    assert calls[0] > 0 and windows[0] > 0
    assert counts["pin_window.device"] == windows[0]
    assert counts["pin_window.host"] == windows[0]
    assert stats["score"] > 0
    if stretch == "beams60":
        # the tick at frame 325 pins keyframes 128-137 to submap 56's
        assert stats["accepted"] == compared[0] == 10
