"""The port's device pin batches (sparse_gslam_tpu_torch/ops/matching.py
pin_eval_batch, models/backend.py _pin_accept_packed) against the JAX
package's, which it runs on an accelerator, on the CPU on the same
seeded inputs.

Tolerances, and why:
  - the argmax pose pose0 and the gates' decisions: equal;
  - the window score: atol 1e-5 (SCORE_ATOL; FFT and matmul rounding,
    ~1e-7);
  - the volume covariance: atol 5e-6 (WCOV_ATOL, on entries whose
    floor is 2.5e-3 to 6.25e-2). The JAX program takes its moments in
    float32, and around a sharp peak (a handful of weights above the
    1e-9 floor) they cancel ~5e4-fold, so the order of the float32 sums
    sets them to a few 1e-6: the port's torch sums land up to 2.6e-6
    from XLA's, whose own jit and eager evaluations are 1.5e-7 apart;
  - the refinement (refined pose, Censi covariance, overlap): equal. The
    JAX program refines the batch under jax.vmap with the resolution a
    static constant, which XLA compiles otherwise than the unbatched
    refine_pose_cov (up to 5.4e-5 apart on these seeds); the port copies
    that program (ops/refine_exact.refine(..., vmapped=True), the
    kernel's batched mode on the card).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sparse_gslam_tpu.models.backend import SubmapLoopCloser as JCloser
from sparse_gslam_tpu.models.frontend import Frontend as JFrontend
from sparse_gslam_tpu.ops import matching as jm
from sparse_gslam_tpu.utils.config import SlamConfig as JSlamConfig
from sparse_gslam_tpu_torch.interop import (
    grids_from_numpy,
    pin_batch_from_numpy,
    spectra_from_numpy,
)
from sparse_gslam_tpu_torch.models.backend import SubmapLoopCloser
from sparse_gslam_tpu_torch.models.frontend import Frontend
from sparse_gslam_tpu_torch.ops import matching as tm
from sparse_gslam_tpu_torch.utils.config import SlamConfig

SCORE_ATOL = 1e-5
WCOV_ATOL = 5e-6

RES, SIZE, FFT_SIZE = 0.1, 64, 128
HIGH_RES, HIGH_SIZE = 0.05, 128
N_LINEAR = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pin_case(seed, B=8, N=256, R=17, n_live=6):
    """Two submaps (score grid, its 0.05 m twin) and B pin queries, the
    first n_live live, drawn from their walls around seeds."""
    rng = np.random.default_rng(seed)
    grids, highs = [], []
    for _ in range(2):
        g = np.full((SIZE, SIZE), 0.15, np.float32)
        for _ in range(4):
            x0, y0 = rng.integers(8, SIZE - 8, 2)
            ln = int(rng.integers(16, 40))
            if rng.random() < 0.5:
                g[x0:min(x0 + ln, SIZE - 1), y0] = 0.9
            else:
                g[x0, y0:min(y0 + ln, SIZE - 1)] = 0.9
        hi = np.full((HIGH_SIZE, HIGH_SIZE), 0.15, np.float32)
        hi[::2, ::2] = g
        hi = np.maximum(hi, np.roll(hi, 1, 0))
        hi = np.maximum(hi, np.roll(hi, 1, 1))
        grids.append(g)
        highs.append(hi)
    origin = np.array([-SIZE * RES / 2] * 2)
    pts = np.zeros((B, N, 2), np.float32)
    val = np.zeros((B, N), bool)
    orgs = np.zeros((B, 2), np.float32)
    seeds = np.zeros((B, 3), np.float32)
    ths = np.zeros((B, R), np.float32)
    ids = rng.integers(0, 2, B).astype(np.int32)
    live = np.arange(B) < n_live
    for k in range(n_live):
        occ = np.argwhere(grids[ids[k]] > 0.7)
        n = int(rng.integers(40, N))
        sel = rng.choice(len(occ), size=n, replace=True)
        p = origin + (occ[sel] + 0.5) * RES
        pts[k, :n] = p + rng.normal(0, 0.01, p.shape)
        val[k, :n] = True
        seeds[k] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                    rng.uniform(-0.05, 0.05)]
        orgs[k] = origin - seeds[k, :2]
        ths[k] = seeds[k, 2] + (np.arange(R) - R // 2) * 0.01
    return dict(grids=np.stack(grids), highs=np.stack(highs),
                high_origins=np.tile(origin.astype(np.float32), (2, 1)),
                ids=ids, orgs=orgs, seeds=seeds, pts=pts, val=val,
                ths=ths, live=live)


def rows(c):
    """(JAX rows, port rows), each (B, 26) float64."""
    spectra = jm.grid_spectrum(jnp.asarray(c["grids"]), FFT_SIZE, SIZE)
    keys = ("ids", "orgs", "seeds", "pts", "val", "ths", "live")
    j = np.asarray(jm.pin_eval_batch(
        spectra, jnp.asarray(c["highs"]), jnp.asarray(c["high_origins"]),
        *(jnp.asarray(c[k]) for k in keys), resolution=RES,
        n_linear=N_LINEAR, size=SIZE, fft_size=FFT_SIZE,
        high_res=HIGH_RES), np.float64)
    # the port reads the JAX package's spectra and inputs (interop)
    t = pin_batch_from_numpy(c, "cpu")
    p = tm.pin_eval_batch(
        spectra_from_numpy(spectra, "cpu"),
        torch.stack(grids_from_numpy(c["highs"], "cpu")),
        torch.stack(grids_from_numpy(c["high_origins"], "cpu")),
        *(t[k] for k in keys), resolution=RES, n_linear=N_LINEAR,
        size=SIZE, fft_size=FFT_SIZE, high_res=HIGH_RES).numpy()
    return j, p


@pytest.fixture(scope="module", params=[11, 12, 13])
def pins(request):
    c = pin_case(request.param)
    return c, *rows(c)


def test_rows_match_jax(pins):
    c, j, p = pins
    assert p.shape == j.shape == (8, 26)
    live = c["live"]
    np.testing.assert_array_equal(p[~live], 0.0)
    np.testing.assert_array_equal(j[~live], 0.0)
    np.testing.assert_allclose(p[live, 0], j[live, 0], atol=SCORE_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(p[live, 1:4], j[live, 1:4])
    np.testing.assert_allclose(p[live, 4:13], j[live, 4:13], rtol=0,
                               atol=WCOV_ATOL)
    np.testing.assert_array_equal(p[live, 13:26], j[live, 13:26])


def test_refinement_is_the_unbatched_jax_programs(pins):
    """Each live pin's refined pose, Censi covariance and overlap equal
    the JAX program's (its vmapped refinement, pin_eval_batch's row), and
    the port's unbatched refine_pose_cov, which every other caller takes,
    on that pin from the row's pose0 equals the JAX package's
    refine_pose_cov called alone."""
    c, j, p = pins
    for k in np.nonzero(c["live"])[0]:
        np.testing.assert_array_equal(p[k, 13:26], j[k, 13:26])
        i = c["ids"][k]
        args = (c["highs"][i], c["high_origins"][i])
        init = p[k, 1:4].astype(np.float32)
        refined, censi, probs = jm.refine_pose_cov(
            *(jnp.asarray(a) for a in args), HIGH_RES,
            jnp.asarray(c["pts"][k]), jnp.asarray(c["val"][k]),
            jnp.asarray(init))
        t_ref, t_censi, t_probs = tm.refine_pose_cov(
            *(torch.from_numpy(a) for a in args), HIGH_RES,
            torch.from_numpy(c["pts"][k]), torch.from_numpy(c["val"][k]),
            torch.from_numpy(init))
        np.testing.assert_array_equal(t_ref.numpy(), np.asarray(refined))
        np.testing.assert_array_equal(t_censi.numpy(), np.asarray(censi))
        np.testing.assert_array_equal(t_probs.numpy(), np.asarray(probs))


def closers():
    """(port, JAX) SubmapLoopClosers over empty frontends: the gates
    read only the config."""
    tc, jc = SlamConfig(), JSlamConfig()
    return (SubmapLoopCloser(tc, Frontend(tc, device="cpu"), device="cpu"),
            JCloser(jc, JFrontend(jc)))


def gate_rows(j):
    """The rows' gates exercised: as computed, a score below the floor,
    an overlap below it, a refinement out of the correlative basin."""
    live = j[np.abs(j).sum(1) > 0]
    low = live[:1].copy()
    low[0, 0] = 0.1
    thin = live[:1].copy()
    thin[0, 25] = 0.05
    far = live[:1].copy()
    far[0, 13] += 0.5
    turned = live[:1].copy()
    turned[0, 15] += 0.2
    return np.concatenate([live, low, thin, far, turned])


def test_pin_accept_packed_matches_jax(pins):
    """Every row through both backends' gates: the same decisions, the
    same measurement and covariance; the port's own rows decide as the
    JAX rows do."""
    c, j, p = pins
    tcl, jcl = closers()
    spec = jm.search_spec(0.8, 0.2, 10.0, RES)
    args = (0.55, 0.3, 0.02, 0.01)
    reasons = set()
    for row in gate_rows(j):
        a = jcl._pin_accept_packed(row, spec, *args)
        b = tcl._pin_accept_packed(row, tm.SearchSpec(*spec), *args)
        assert a[3] == b[3]
        reasons.add(b[3])
        if a[0] is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_allclose(b[1], a[1], rtol=1e-12)
            assert a[2] == b[2]
    assert {None, "score", "corr"} <= reasons
    for k in np.nonzero(c["live"])[0]:
        a = jcl._pin_accept_packed(j[k], spec, *args)
        b = tcl._pin_accept_packed(p[k], tm.SearchSpec(*spec), *args)
        assert a[3] == b[3]
