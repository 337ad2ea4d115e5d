"""The port's incremental keyframe insertion and grid dump
(sparse_gslam_tpu_torch/ops/grid.py insert_range_data, grid_to_png)
against the JAX package's on the same seeded inputs (CPU).

insert_range_data runs the port's insert_rays: on a CPU grid its plain
version, which the CUDA kernel equals bit for bit (tests/test_torch_gpu.py
holds the kernel on the card over the same sequence). Tolerances:
  - insert_range_data against the JAX function: bit-equal
    (np.array_equal), over successive keyframes into one grid that
    already holds odds, with `pose` set and None, at S below and above 8
    scans a keyframe (S_pad 8 and 16);
  - the incremental sequence against the batch build
    (build_submap_grid of the same scans at the same poses): atol 1e-6,
    as tests/test_grid_matching.py holds the JAX pair, and bit-equal in
    fact (the same per-scan updates in the same order);
  - grid_to_png: the decoded pixels equal to the JAX package's
    matplotlib image (its RGB channels; its alpha is 255 everywhere).
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sparse_gslam_tpu.models.range_data import RangeData2D as JRangeData2D
from sparse_gslam_tpu.ops import grid as jg
from sparse_gslam_tpu_torch.models.range_data import RangeData2D
from sparse_gslam_tpu_torch.ops import grid as tg

SPEC = (128, 0.1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def keyframes(seed, n_kf, n_scans, beams=11):
    """n_kf keyframe stores of n_scans scans each (both packages'
    RangeData2D, same contents) with their poses: each store holds its
    scans at small offsets in its own frame, some at max range."""
    rng = np.random.default_rng(seed)
    a = np.linspace(-1.2, 1.2, beams)
    table = np.stack([np.cos(a), np.sin(a)], 1)
    out = []
    for k in range(n_kf):
        j, t = JRangeData2D(), RangeData2D()
        for _ in range(n_scans):
            ranges = rng.uniform(1.0, 4.5, beams)
            ranges[rng.random(beams) < 0.2] = 10.0  # max-range misses
            sp = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2),
                           rng.uniform(-0.1, 0.1)])
            j.insert_scan(ranges, table, 5.0, pose=sp)
            t.insert_scan(ranges, table, 5.0, pose=sp)
        pose = np.array([0.55 * k, 0.1 * k, 0.1 * k])
        out.append((j, t, pose))
    return out


@pytest.mark.parametrize("n_scans", [3, 11])
@pytest.mark.parametrize("with_pose", [True, False])
def test_insert_range_data_matches_jax(n_scans, with_pose):
    kfs = keyframes(5 + n_scans, 4, n_scans)
    spec_j, spec_t = jg.GridSpec(*SPEC), tg.GridSpec(*SPEC)
    origin = np.array([-5.3, -6.1], np.float32)
    pj = jnp.zeros((SPEC[0], SPEC[0]), jnp.float32)
    pt = torch.zeros((SPEC[0], SPEC[0]), dtype=torch.float32)
    for j, t, pose in kfs:
        p = pose if with_pose else None
        pj = jg.insert_range_data(pj, jnp.asarray(origin), j, p, spec_j)
        pt = tg.insert_range_data(pt, torch.from_numpy(origin), t, p, spec_t)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    got = pt.numpy()
    assert (got > 0).sum() > 200
    assert ((got > 0.5) & (got < 0.9)).sum() > 5  # repeated hits


def test_insert_range_data_matches_batch_build():
    """tests/test_grid_matching.py TestIncrementalInsert on the port: the
    incremental sequence reproduces the batch submap build of the same
    scans at the same poses."""
    rng = np.random.default_rng(5)
    spec = tg.GridSpec(size=128, resolution=0.1)
    table = np.stack([np.cos(np.linspace(-1.2, 1.2, 11)),
                      np.sin(np.linspace(-1.2, 1.2, 11))], 1)
    stores = []
    batch = RangeData2D()
    poses = [np.array([0.0, 0.0, 0.0]), np.array([0.6, 0.1, 0.1]),
             np.array([1.1, 0.3, 0.2])]
    for pose in poses:
        rd = RangeData2D()
        ranges = rng.uniform(1.0, 4.5, 11)
        ranges[rng.random(11) < 0.2] = 10.0
        rd.insert_scan(ranges, table, 5.0)
        stores.append(rd)
        rd.transform_into(pose, batch)
    g_batch = tg.build_submap_grid(batch, spec, device="cpu")
    probs = torch.zeros((spec.size, spec.size), dtype=torch.float32)
    for rd, pose in zip(stores, poses):
        probs = tg.insert_range_data(probs, g_batch.origin, rd, pose, spec)
    np.testing.assert_allclose(probs.numpy(), g_batch.probs.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(probs.numpy(), g_batch.probs.numpy())


def test_insert_range_data_empty_store_returns_grid():
    probs = torch.full((16, 16), 0.3)
    out = tg.insert_range_data(probs, np.zeros(2), RangeData2D(), None,
                               tg.GridSpec(16, 0.1))
    assert out is probs


def test_grid_to_png_matches_jax(tmp_path):
    kfs = keyframes(3, 3, 4)
    spec = tg.GridSpec(*SPEC)
    probs = torch.zeros((SPEC[0], SPEC[0]), dtype=torch.float32)
    for _, t, pose in kfs:
        probs = tg.insert_range_data(probs, np.array([-5.3, -6.1]), t, pose,
                                     spec)
    arr = probs.numpy()
    # every level the port writes: all grid values, and 0.5 (unknown)
    assert len(np.unique(arr)) > 5
    pj, pt = tmp_path / "jax.png", tmp_path / "port.png"
    jg.grid_to_png(jnp.asarray(arr), str(pj))
    tg.grid_to_png(probs, str(pt))
    ref = np.asarray(Image.open(io.BytesIO(pj.read_bytes())))
    got = np.asarray(Image.open(io.BytesIO(pt.read_bytes())))
    assert got.shape == (SPEC[0], SPEC[0], 3)
    assert ref.shape == (SPEC[0], SPEC[0], 4)
    np.testing.assert_array_equal(ref[..., 3], 255)
    np.testing.assert_array_equal(got, ref[..., :3])
    # a float ramp across every gray level, through both
    ramp = np.linspace(0.1, 0.9, 128 * 128, dtype=np.float32).reshape(128, 128)
    jg.grid_to_png(jnp.asarray(ramp), str(pj))
    tg.grid_to_png(ramp, str(pt))
    ref = np.asarray(Image.open(io.BytesIO(pj.read_bytes())))
    got = np.asarray(Image.open(io.BytesIO(pt.read_bytes())))
    np.testing.assert_array_equal(got, ref[..., :3])
