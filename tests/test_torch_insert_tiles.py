"""The tiled algorithm of the CUDA insertion kernel (csrc/insert_rays.cu),
run on the CPU through its host build (csrc/insert_rays_host.cpp, which
shares csrc/insert_rays_tile.cuh with the kernel), against the port's
plain insertion and the JAX package's XLA insertion. Tolerance:
bit-exact. Also: the ray-to-tile clip never drops a sample that lands in
the tile, and the kernel's build hash covers the headers it includes.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sparse_gslam_tpu.models.range_data import RangeData2D as JRangeData2D
from sparse_gslam_tpu.ops import grid as jgrid
from sparse_gslam_tpu_torch.models.range_data import RangeData2D
from sparse_gslam_tpu_torch.ops import grid, grid_cuda
from test_torch_grid import CASES, args_of, make_range_data, rays_case

CSRC = os.path.dirname(grid_cuda.SOURCE)
TILES = grid_cuda.TILES


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the tiled insertion "
                    "needs a C++ compiler")
    out = str(tmp_path_factory.mktemp("insert_tiles") /
              "libinsert_rays_host.so")
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", out, os.path.join(CSRC, "insert_rays_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(out)
    lib.insert_rays_tiled_host.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.insert_rays_tiled_host.restype = ctypes.c_int
    lib.ray_tile_steps_host.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.ray_tile_steps_host.restype = None
    return lib


def tiled_host(lib, args, tile, listed=None):
    """The host build of the tiled kernel on insert_rays' arguments;
    `listed`, an int32 array of one entry per tile, receives the number
    of scans each tile's screen kept."""
    probs, origin, s_org, s_pts, s_kind, hm, res, n_steps, size = (
        np.ascontiguousarray(a.numpy()) if isinstance(a, torch.Tensor)
        else a for a in args)
    out = np.full_like(probs, np.nan)
    S, B = s_kind.shape
    ptr = [a.ctypes.data for a in (out, probs, origin, s_org, s_pts,
                                   s_kind, hm)]
    assert lib.insert_rays_tiled_host(
        *ptr, res, S, B, n_steps, size, tile,
        None if listed is None else listed.ctypes.data) == 0
    return out


def submap_case():
    """The build_submap_grid path: a box room seen from a wandering
    path, packed and centred by submap_insert_args."""
    spec = grid.GridSpec(size=256, resolution=0.0957)
    return grid.submap_insert_args(make_range_data(RangeData2D), spec,
                                   device="cpu")


# more scans than one screening window (512) and more listed scans than
# one chunk (32) in most tiles
WINDOWS_CASE = rays_case(12, 600, 640, 8, 96, 24, 0.5, 9.0, 3.0)


@pytest.fixture(scope="module")
def references():
    """Per case: the port's plain insertion and the JAX insertion."""
    refs = {}
    for name, c in [*CASES.items(), ("windows_s600", WINDOWS_CASE)]:
        a = args_of(c, "torch")
        refs[name] = (a, grid.insert_rays_plain(*a).numpy(),
                      np.asarray(jgrid.insert_rays(*args_of(c, "jax"))))
    a = submap_case()
    jspec = jgrid.GridSpec(size=256, resolution=0.0957)
    refs["build_submap_grid"] = (
        a, grid.insert_rays_plain(*a).numpy(),
        np.asarray(jgrid.build_submap_grid(make_range_data(JRangeData2D),
                                           jspec).probs))
    return refs


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", [*CASES, "windows_s600",
                                  "build_submap_grid"])
def test_tiled_host_matches_plain_and_jax(host_lib, references, case, tile):
    args, plain, ref = references[case]
    out = tiled_host(host_lib, args, tile)
    assert (out > 0).sum() > 0
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_array_equal(out, ref)


def wall_case(seed=14, S=300, S_pad=320, B=8, G=96, res=0.1):
    """Scans from seeded origins whose beams all end on the same B cells
    of a wall, most of them hits: the wall cells take hundreds of hits
    and the floor before them hundreds of misses."""
    rng = np.random.default_rng(seed)
    origins = np.zeros((S_pad, 2), np.float32)
    origins[:S] = rng.uniform(1.0, 5.0, (S, 2))
    wall = np.stack([np.full(B, 8.05), 1.05 + 0.9 * np.arange(B)], 1)
    pts = np.zeros((S_pad, B, 2), np.float32)
    pts[:S] = wall
    kind = np.zeros((S_pad, B), np.int8)
    kind[:S] = np.where(rng.random((S, B)) < 0.8, 1, 2)
    return dict(origins=origins, pts=pts, kind=kind, res=res, n_steps=96,
                G=G)


@pytest.mark.parametrize("tile", TILES)
def test_tiled_host_at_the_clamp_bounds(host_lib, tile):
    """Cells seen by many scans, hundreds of events each over many
    chunks, reach the clamp bounds 0.1 (misses) and 0.9 (hits) and stay
    there as the plain version's do."""
    a = args_of(wall_case(), "torch")
    plain = grid.insert_rays_plain(*a).numpy()
    out = tiled_host(host_lib, a, tile)
    assert (out == np.float32(0.1)).sum() > 100
    assert (out == np.float32(0.9)).sum() >= 4
    np.testing.assert_array_equal(out, plain)


@pytest.mark.parametrize("tile", TILES)
def test_tiled_host_on_a_known_grid_leaves_probs(host_lib, tile):
    """A second insertion onto a grid the first one filled: known cells
    update in scan order across chunks, and `probs` is only read."""
    c = CASES["s40_pad64_b16_g128"]
    a = args_of(c, "torch")
    prior = grid.insert_rays_plain(*a)
    a2 = (prior, *a[1:3], torch.flip(a[3], (0,)), torch.flip(a[4], (0,)),
          *a[5:])
    kept = prior.clone()
    out = tiled_host(host_lib, a2, tile)
    np.testing.assert_array_equal(out, grid.insert_rays_plain(*a2).numpy())
    assert torch.equal(prior, kept)


def test_screen_skips_scans_far_from_the_tile(host_lib):
    """Scans of short beams in one corner of the grid: tiles out of
    their reach list none of them, the tile under them lists them all,
    and the result is still the plain version's."""
    c = rays_case(13, 70, 96, 8, 128, 96, 0.3, 1.2, 0.5)
    a = args_of(c, "torch")
    n = 128 // 16
    listed = np.full(n * n, -1, np.int32)
    out = tiled_host(host_lib, a, 16, listed)
    np.testing.assert_array_equal(out, grid.insert_rays_plain(*a).numpy())
    listed = listed.reshape(n, n)
    assert listed[0, 0] == 70
    # beams reach 1.7 m = 17 cells from the origin; with the screen's
    # one-cell margin no tile from 20 cells on can list a scan
    assert (listed[2:, :] == 0).all() and (listed[:, 2:] == 0).all()


def random_rays(rng, n, G, res):
    """Rays inside and around a G-cell grid at origin 0; half of the
    starts and ends snapped to cell borders, a quarter of those to tile
    borders of 16 cells; a tenth of the rays parallel to an axis and a
    tenth within 10^-4 cells of parallel, where a rounding error in a
    sample's position is a large error in its t."""
    p = rng.uniform(-0.2 * G * res, 1.2 * G * res, (n, 4)).astype(np.float32)
    cells = np.round(p / res)
    snap = rng.random((n, 4)) < 0.5
    tiles = rng.random((n, 4)) < 0.25
    cells = np.where(tiles, np.round(cells / 16) * 16, cells)
    p = np.where(snap, (cells * res).astype(np.float32), p)
    axis = rng.integers(0, 2, n)
    flat = rng.random(n) < 0.1
    p[flat, 2 + axis[flat]] = p[flat, axis[flat]]
    near = ~flat & (rng.random(n) < 0.11)
    tilt = rng.uniform(-1e-4, 1e-4, n) * res
    p[near, 2 + axis[near]] = p[near, axis[near]] + tilt[near]
    return np.ascontiguousarray(p, np.float32)


@pytest.mark.parametrize("tile", TILES)
def test_clip_keeps_every_sample_in_the_tile(host_lib, tile):
    """On 10^5 seeded rays the clip's step range holds every sample
    whose cell, computed as the kernel computes it, lies in the tile."""
    rng = np.random.default_rng(100 + tile)
    G, n_steps = 256, 96
    origin = np.zeros(2, np.float32)
    checked = 0
    for res in (0.125, 0.0957) * 5:  # 10 batches of 10^4 rays
        segs = random_rays(rng, 10_000, G, res)
        s = torch.from_numpy(segs[:, :2])
        e = torch.from_numpy(segs[:, 2:])
        ts = ((torch.arange(n_steps, dtype=torch.float64) + 0.5)
              / n_steps).float()
        pts = grid._fma_f32((e - s)[:, None, :], ts[None, :, None],
                            s[:, None, :].expand(-1, n_steps, 2))
        cells = grid.cell_index(pts, torch.from_numpy(origin), res).numpy()
        ray, k = np.nonzero(((cells >= 0) & (cells < G)).all(-1))
        tx, ty = cells[ray, k, 0] // tile, cells[ray, k, 1] // tile
        # one query per (ray, tile) pair: the first and last step in it
        key = (ray * (G // tile) + tx) * (G // tile) + ty
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        k_lo = np.full(len(uniq), n_steps)
        k_hi = np.full(len(uniq), -1)
        np.minimum.at(k_lo, inv, k)
        np.maximum.at(k_hi, inv, k)
        r, x0, y0 = ray[first], tx[first] * tile, ty[first] * tile
        box = np.ascontiguousarray(np.stack(
            [x0, np.minimum(x0 + tile, G), y0, np.minimum(y0 + tile, G)],
            1).astype(np.int32))
        qseg = np.ascontiguousarray(segs[r])
        kr = np.zeros((len(uniq), 2), np.int32)
        host_lib.ray_tile_steps_host(len(uniq), qseg.ctypes.data,
                                     box.ctypes.data, origin.ctypes.data,
                                     res, n_steps, kr.ctypes.data)
        assert (kr[:, 0] <= k_lo).all() and (k_hi <= kr[:, 1]).all()
        checked += len(uniq)
    assert checked > 10_000


def test_pick_tile_keeps_two_blocks_per_sm():
    """The wrapper's tile on a 132-SM card at the grids the port builds:
    the largest tile with at least 264 blocks, else the smallest."""
    assert [grid_cuda.pick_tile(G, 132) for G in (2048, 1024, 576, 320,
                                                  100)] == [64, 32, 32, 16,
                                                            16]
    assert grid_cuda.pick_tile(2048, 1024) == 32


def test_build_hash_covers_included_headers(tmp_path):
    """The kernel library's cache key reads every header the source
    includes, so an edit to the header rebuilds it."""
    files = grid_cuda.source_files()
    assert files[0] == os.path.abspath(grid_cuda.SOURCE)
    assert os.path.join(CSRC, "insert_rays_tile.cuh") in files
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n#include <x.h>\n')
    (tmp_path / "b.cuh").write_text('#include "sub/c.cuh"\n')
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "c.cuh").write_text("// leaf\n")
    assert [os.path.relpath(f, tmp_path) for f in
            grid_cuda.source_files(str(tmp_path / "a.cu"))] == [
        "a.cu", "b.cuh", os.path.join("sub", "c.cuh")]
