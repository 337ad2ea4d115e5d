"""The port's occupancy-grid insertion (sparse_gslam_tpu_torch.ops.grid)
against the JAX package's XLA insertion and its Pallas kernel (interpret
mode), bit for bit, and the CUDA kernel against the plain twin on a card.
"""
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.models.range_data import RangeData2D as JRangeData2D
from sparse_gslam_tpu.ops import grid as jgrid
from sparse_gslam_tpu.ops.grid_pallas import insert_rays_pallas
from sparse_gslam_tpu_torch.interop import grid_from_numpy
from sparse_gslam_tpu_torch.eval.maps import map_image, write_png
from sparse_gslam_tpu_torch.models.range_data import RangeData2D
from sparse_gslam_tpu_torch.ops import grid


def rays_case(seed, S, S_pad, B, G, n_steps, lo, hi, reach, res=0.1):
    """Seeded scans: origins uniform in [lo, hi]^2, endpoints within
    `reach` of them, kinds 0/1/2; scans S..S_pad are padding."""
    rng = np.random.default_rng(seed)
    origins = np.zeros((S_pad, 2), np.float32)
    origins[:S] = rng.uniform(lo, hi, (S, 2))
    pts = np.zeros((S_pad, B, 2), np.float32)
    pts[:S] = origins[:S, None, :] + rng.uniform(-reach, reach, (S, B, 2))
    kind = np.zeros((S_pad, B), np.int8)
    kind[:S] = rng.integers(0, 3, (S, B))
    return dict(origins=origins, pts=pts, kind=kind, res=res,
                n_steps=n_steps, G=G)


def tile_edge_case(seed, S, S_pad, B, G, n_steps, res=0.125, tile=16):
    """Seeded scans on the borders of the CUDA kernel's tiles: with a
    power-of-two resolution every border is exact in float32. Origins lie
    on tile corners or cell corners, endpoints at whole-cell offsets from
    them, a third of the offsets a whole number of tiles and a third of
    the rays parallel to an axis (so whole rays run along a border)."""
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
    return dict(origins=origins, pts=pts, kind=kind, res=res,
                n_steps=n_steps, G=G)


CASES = {
    # the Pallas parity case of tests/test_grid_matching.py
    "s8_b8_g64": rays_case(3, 8, 8, 8, 64, 24, 1.5, 4.5, 1.6),
    # S=40 bucketed to S_pad=64, the map path's B and n_steps
    "s40_pad64_b16_g128": rays_case(4, 40, 64, 16, 128, 96, 2.0, 10.0, 3.0,
                                    res=0.0957),
    # rays leaving the grid on every side
    "leaving_grid": rays_case(5, 16, 32, 8, 64, 96, 0.5, 6.0, 9.0),
    # origins and endpoints on tile and cell borders
    "tile_edges": tile_edge_case(6, 40, 64, 8, 128, 96),
    # a grid edge that no tile of the CUDA kernel divides
    "ragged_g100": rays_case(7, 24, 32, 8, 100, 96, 1.0, 9.0, 6.0),
}


def args_of(c, lib):
    G = c["G"]
    if lib == "jax":
        arr = jnp.asarray
        z, hm = jnp.zeros((G, G), jnp.float32), jnp.asarray([0.7, 0.4],
                                                            jnp.float32)
        o = jnp.zeros(2, jnp.float32)
    else:
        arr = torch.from_numpy
        z, hm = torch.zeros((G, G)), torch.tensor([0.7, 0.4])
        o = torch.zeros(2)
    return (z, o, arr(c["origins"]), arr(c["pts"]), arr(c["kind"]), hm,
            c["res"], c["n_steps"], G)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_insert_matches_jax_and_pallas(case):
    c = CASES[case]
    port = grid.insert_rays(*args_of(c, "torch")).numpy()
    ref = np.asarray(jgrid.insert_rays(*args_of(c, "jax")))
    pal = np.asarray(insert_rays_pallas(*args_of(c, "jax"), interpret=True))
    assert (port > 0).sum() > 0
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, pal)


def test_cpu_dispatch_is_plain_and_other_devices_raise():
    c = CASES["s8_b8_g64"]
    a = args_of(c, "torch")
    np.testing.assert_array_equal(grid.insert_rays(*a).numpy(),
                                  grid.insert_rays_plain(*a).numpy())
    meta = tuple(x.to("meta") if isinstance(x, torch.Tensor) else x
                 for x in a)
    with pytest.raises(ValueError, match="no ray insertion"):
        grid.insert_rays(*meta)


def make_range_data(cls, seed=9, n_scans=40, beams=11, range_max=10.0):
    """Scans of a box room from a wandering path, with max-range misses."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-np.pi / 2, np.pi / 2, beams)
    table = np.stack([np.cos(ang), np.sin(ang)], 1)
    rd = cls()
    for i in range(n_scans):
        pose = np.array([0.3 * i, rng.uniform(-1, 1), rng.uniform(-3, 3)])
        r = rng.uniform(0.5, 12.0, beams)
        r[rng.random(beams) < 0.1] = np.inf
        rd.insert_scan(np.minimum(r, range_max) if i % 2 else r, table,
                       range_max, pose=pose)
    return rd


def test_build_submap_grid_matches_jax():
    spec_t = grid.GridSpec(size=256, resolution=0.0957)
    jspec = jgrid.GridSpec(size=256, resolution=0.0957)
    port = grid.build_submap_grid(make_range_data(RangeData2D), spec_t,
                                  device="cpu")
    ref = jgrid.build_submap_grid(make_range_data(JRangeData2D), jspec)
    np.testing.assert_array_equal(port.origin.numpy(), np.asarray(ref.origin))
    np.testing.assert_array_equal(port.probs.numpy(), np.asarray(ref.probs))
    assert port.probs.dtype == torch.float32


@pytest.mark.parametrize("n_scans,beams,S_pad,B",
                         [(1, 3, 32, 4), (40, 11, 64, 16), (33, 5, 64, 8)])
def test_pack_scans_buckets(n_scans, beams, S_pad, B):
    origins_pad, pts, kind, origins = grid.pack_scans(
        make_range_data(RangeData2D, n_scans=n_scans, beams=beams))
    assert origins_pad.shape == (S_pad, 2) and pts.shape == (S_pad, B, 2)
    assert kind.shape == (S_pad, B) and len(origins) == n_scans
    assert not kind[n_scans:].any()


def test_grid_from_numpy():
    rng = np.random.default_rng(1)
    probs = rng.uniform(0, 1, (8, 8))
    g = grid_from_numpy(probs, [1.5, -2.0], 0.05, "cpu")
    assert g.probs.dtype == torch.float32 and g.origin.dtype == torch.float32
    np.testing.assert_array_equal(g.probs.numpy(), probs.astype(np.float32))
    assert g.resolution == 0.05


def read_png(path):
    """Decode an 8-bit RGB PNG with filter 0 rows (what write_png makes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = hdr[0], hdr[1]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def test_map_png_roundtrip(tmp_path):
    probs = np.zeros((6, 4), np.float32)  # x 6 cells, y 4 cells
    probs[5, 0] = 0.9  # occupied at max x, min y
    probs[0, 3] = 0.1  # free at min x, max y
    img = map_image(probs, np.array([[0.05, 0.05, 0.0], [0.25, 0.05, 0.0]]),
                    origin=np.zeros(2), resolution=0.1)
    path = tmp_path / "m.png"
    write_png(str(path), img)
    back = read_png(path)
    assert back.shape == (4, 6, 3)
    np.testing.assert_array_equal(back, img)
    # rows run from max y down; unknown is grey; trajectory is red
    assert (back[3, 5] < 40).all() and (back[0, 0] > 215).all()
    assert tuple(back[1, 3]) == (128, 128, 128)
    assert tuple(back[3, 0]) == (255, 0, 0) and tuple(back[3, 2]) == (
        255, 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain(case):
    """Needs a CUDA card: the kernel against its plain twin, bit for bit,
    one launch per call, at every tile size; `probs` is left as it was."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the insertion kernel runs only on a GPU")
    from sparse_gslam_tpu_torch.ops.grid_cuda import TILES, insert_rays_cuda

    a = tuple(x.cuda() if isinstance(x, torch.Tensor) else x
              for x in args_of(CASES[case], "torch"))
    ref = grid.insert_rays_plain(*a)
    probs = a[0].clone()
    before = insert_rays_cuda.launches
    out = grid.insert_rays(*a)
    torch.cuda.synchronize()
    assert insert_rays_cuda.launches == before + 1
    assert torch.equal(out, ref)
    for tile in TILES:
        before = insert_rays_cuda.launches
        out = insert_rays_cuda(*a, tile=tile)
        torch.cuda.synchronize()
        assert insert_rays_cuda.launches == before + 1
        assert torch.equal(out, ref), tile
    assert torch.equal(a[0], probs)
