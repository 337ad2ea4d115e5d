"""The device pin batches' refinement against the JAX program's, bit for
bit.

The JAX package's pin_eval_batch (sparse_gslam_tpu/ops/matching.py)
refines its batch of pins under jax.vmap with the resolution a static
constant, and XLA compiles that program otherwise than the unbatched
refine_pose_cov every other caller runs: the division by the resolution
is a multiply by its reciprocal, fused into the weights' offset, and the
Jacobian's tangents carry the reciprocal (ops/refine_exact.py docstring).
The port copies it: refine_exact.refine(..., vmapped=True) on the host,
the kernel's batched mode (csrc/refine_pose.cu refine_pins_launch) on
the card.

- pin_eval_batch's rows (refined pose, Censi covariance, overlap) of the
  port against the JAX package's at B = 8 and N = 256 and 512, on seeded
  pins; and at the backend's own sizes (N = 512 against the 576-cell
  0.05 m grid);
- the batched plain version's poses, covariances and per-point
  probabilities against the JAX vmapped refinement alone
  (jit(vmap(refine_pose_cov)) with the resolution static);
- the kernel header's batched block program (built with g++ through
  csrc/refine_pose_host.cpp) against the plain version;
- on the CPU refine_pins takes the plain version, and the kernel's
  wrapper refuses tensors that are not on the card.

np.array_equal throughout. JAX runs as the package's own tests run it
(conftest.py: the CPU, x64, 8 virtual devices).
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.ops import matching as jm
from sparse_gslam_tpu_torch.interop import (
    grids_from_numpy,
    pin_batch_from_numpy,
    spectra_from_numpy,
)
from sparse_gslam_tpu_torch.ops import matching as tm
from sparse_gslam_tpu_torch.ops import refine_cuda
from sparse_gslam_tpu_torch.ops import refine_exact as rx

F32 = np.float32
HIGH_RES = 0.05
N_LINEAR = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pin_case(seed, N, size=64, high=128, B=8, R=17, n_live=6, res=0.1):
    """Two submaps (a score grid and its 0.05 m twin) and B pin queries,
    the first n_live live, drawn from their walls around seeds."""
    rng = np.random.default_rng(seed)
    grids, highs = [], []
    m = min(size, high // 2)
    for _ in range(2):
        g = np.full((size, size), 0.15, F32)
        for _ in range(4 + size // 32):
            x0, y0 = rng.integers(8, m - 8, 2)
            ln = int(rng.integers(16, 40))
            if rng.random() < 0.5:
                g[x0:min(x0 + ln, m - 1), y0] = 0.9
            else:
                g[x0, y0:min(y0 + ln, m - 1)] = 0.9
        hi = np.full((high, high), 0.15, F32)
        hi[:2 * m:2, :2 * m:2] = g[:m, :m]
        hi = np.maximum(hi, np.roll(hi, 1, 0))
        hi = np.maximum(hi, np.roll(hi, 1, 1))
        grids.append(g)
        highs.append(hi)
    origin = np.array([-size * res / 2] * 2)
    pts = np.zeros((B, N, 2), F32)
    val = np.zeros((B, N), bool)
    orgs = np.zeros((B, 2), F32)
    seeds = np.zeros((B, 3), F32)
    ths = np.zeros((B, R), F32)
    ids = rng.integers(0, 2, B).astype(np.int32)
    live = np.arange(B) < n_live
    for k in range(n_live):
        occ = np.argwhere(grids[ids[k]][:m, :m] > 0.7)
        n = int(rng.integers(40, N))
        sel = rng.choice(len(occ), size=n, replace=True)
        p = origin + (occ[sel] + 0.5) * res
        pts[k, :n] = p + rng.normal(0, 0.01, p.shape)
        val[k, :n] = True
        seeds[k] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                    rng.uniform(-0.05, 0.05)]
        orgs[k] = origin - seeds[k, :2]
        ths[k] = seeds[k, 2] + (np.arange(R) - R // 2) * 0.01
    return dict(grids=np.stack(grids), highs=np.stack(highs),
                high_origins=np.tile(origin.astype(F32), (2, 1)),
                ids=ids, orgs=orgs, seeds=seeds, pts=pts, val=val, ths=ths,
                live=live, size=size, res=res)


def rows(c):
    """(JAX rows, port rows) of pin_eval_batch, each (B, 26) float64."""
    size, res = c["size"], c["res"]
    fft = size + 64
    spectra = jm.grid_spectrum(jnp.asarray(c["grids"]), fft, size)
    keys = ("ids", "orgs", "seeds", "pts", "val", "ths", "live")
    j = np.asarray(jm.pin_eval_batch(
        spectra, jnp.asarray(c["highs"]), jnp.asarray(c["high_origins"]),
        *(jnp.asarray(c[k]) for k in keys), resolution=res,
        n_linear=N_LINEAR, size=size, fft_size=fft, high_res=HIGH_RES),
        np.float64)
    t = pin_batch_from_numpy(c, "cpu")
    p = tm.pin_eval_batch(
        spectra_from_numpy(spectra, "cpu"),
        torch.stack(grids_from_numpy(c["highs"], "cpu")),
        torch.stack(grids_from_numpy(c["high_origins"], "cpu")),
        *(t[k] for k in keys), resolution=res, n_linear=N_LINEAR,
        size=size, fft_size=fft, high_res=HIGH_RES).numpy()
    return j, p


@pytest.mark.parametrize("seed,N", [(21, 256), (22, 256), (23, 512),
                                    (24, 512)])
def test_pin_rows_equal_jax(seed, N):
    c = pin_case(seed, N)
    j, p = rows(c)
    live = c["live"]
    np.testing.assert_array_equal(p[live, 1:4], j[live, 1:4])
    np.testing.assert_array_equal(p[live, 13:26], j[live, 13:26])
    np.testing.assert_array_equal(p[~live], 0.0)


def test_pin_rows_equal_jax_at_backend_sizes():
    """The backend's sizes: 512-point queries, the 320-cell score grid,
    the 576-cell 0.05 m grid (the sizes XLA's program was read at)."""
    c = pin_case(25, 512, size=320, high=576)
    j, p = rows(c)
    live = c["live"]
    np.testing.assert_array_equal(p[live, 13:26], j[live, 13:26])


@jax.jit
def _jax_vmapped(grids, origins, pts, val, init):
    return jax.vmap(lambda g, o, p, v, x: jm.refine_pose_cov(
        g, o, HIGH_RES, p, v, x))(grids, origins, pts, val, init)


def pins_from(c):
    """The live pins' refinement inputs, each starting off the true pose."""
    rng = np.random.default_rng(int(c["ids"].sum()) + len(c["pts"][0]))
    lv = np.nonzero(c["live"])[0]
    init = np.concatenate([rng.uniform(-0.02, 0.02, (len(lv), 2)),
                           rng.uniform(-0.01, 0.01, (len(lv), 1))], 1)
    return (c["ids"][lv], c["pts"][lv], c["val"][lv], init.astype(F32))


@pytest.mark.parametrize("seed,N", [(31, 256), (32, 512)])
def test_batched_plain_equals_jax_vmapped_refinement(seed, N):
    c = pin_case(seed, N)
    ids, pts, val, init = pins_from(c)
    jp, jc, jprobs = (np.asarray(a) for a in _jax_vmapped(
        jnp.asarray(c["highs"][ids]), jnp.asarray(c["high_origins"][ids]),
        jnp.asarray(pts), jnp.asarray(val), jnp.asarray(init)))
    pose, cov, probs = tm.refine_pins(
        torch.from_numpy(c["highs"]), torch.from_numpy(c["high_origins"]),
        torch.from_numpy(ids), HIGH_RES, torch.from_numpy(pts),
        torch.from_numpy(val), torch.from_numpy(init))
    np.testing.assert_array_equal(pose.numpy(), jp)
    np.testing.assert_array_equal(cov.numpy(), jc)
    np.testing.assert_array_equal(probs.numpy(), jprobs)


@pytest.mark.parametrize("seed,N", [(41, 256), (42, 512), (43, 1024)])
def test_header_batched_block_program_equals_plain(seed, N):
    """csrc/refine_pose_exact.cuh's block program in its vmapped mode
    (refine_pins_host, the kernel's batched launch on the host) against
    the batched plain version, one problem per pin."""
    c = pin_case(seed, N, n_live=8)
    ids, pts, val, init = pins_from(c)
    B = len(ids)
    lib = refine_cuda.host_library()
    pose = np.zeros((B, 3), F32)
    cov = np.zeros((B, 3, 3), F32)
    probs = np.zeros((B, N), F32)
    steps = np.zeros((B, 2), np.int32)
    grids = np.ascontiguousarray(c["highs"])
    origins = np.ascontiguousarray(c["high_origins"])
    ids32 = np.ascontiguousarray(ids, np.int32)
    val8 = np.ascontiguousarray(val, np.uint8)
    y0 = rx.rsqrtss_table()

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    assert lib.refine_pins_host(
        ptr(grids), grids.shape[1], ptr(origins), ptr(ids32),
        ctypes.c_float(HIGH_RES), ptr(pts), ptr(val8), ptr(init), ptr(y0),
        B, N, 10, ptr(pose), ptr(cov), ptr(probs), ptr(steps)) == 0
    want = tm.refine_pins_plain(
        torch.from_numpy(grids), torch.from_numpy(origins),
        torch.from_numpy(ids), HIGH_RES, torch.from_numpy(pts),
        torch.from_numpy(val), torch.from_numpy(init))
    np.testing.assert_array_equal(pose, want[0].numpy())
    np.testing.assert_array_equal(cov, want[1].numpy())
    np.testing.assert_array_equal(probs, want[2].numpy())
    assert (steps[:, 0] >= 1).all() and (steps[:, 1] == 0).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    c = pin_case(51, 256)
    ids, pts, val, init = pins_from(c)
    with pytest.raises(ValueError, match="CUDA tensors"):
        refine_cuda.refine_pins_cuda(
            torch.from_numpy(c["highs"]),
            torch.from_numpy(c["high_origins"]),
            torch.from_numpy(ids.astype(np.int32)), HIGH_RES,
            torch.from_numpy(pts), torch.from_numpy(val),
            torch.from_numpy(init))
    with pytest.raises(ValueError, match="padded points"):
        refine_cuda.refine_pins_cuda(
            torch.from_numpy(c["highs"]),
            torch.from_numpy(c["high_origins"]),
            torch.from_numpy(ids.astype(np.int32)), HIGH_RES,
            torch.from_numpy(pts[:, :100]), torch.from_numpy(val[:, :100]),
            torch.from_numpy(init))
