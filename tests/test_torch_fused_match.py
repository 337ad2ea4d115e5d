"""The port's fused one-call matcher (sparse_gslam_tpu_torch/ops/
matching.py: fused_match, match_candidates_fused and their helpers)
against the JAX package's, which it runs on an accelerator, on the CPU
on the same seeded inputs. The cases of tests/test_fused_match.py run
through both packages, plus the helpers one by one.

Tolerances, and why:
  - cell indices, histograms, the top-K order, the match's candidate
    and pose: equal. The port rounds the cells as XLA's CPU program
    (the C library's cosf/sinf, FMA contractions, the float32
    reciprocal of the static resolution); histograms count integers;
    poses are cell offsets and table angles;
  - coarse bounds: rtol 1e-6 (BOUND_RTOL). Their einsum sums float32
    products in another order than XLA's dot (~1 ulp), so where two
    bounds an ulp apart sit at the K-th place or at the floor the
    fused_match calls made (pages) can differ: equal at K = 4 and 32,
    within one over two chunks at K = 16, not compared at K = 2;
  - exact scores: atol 1e-5 (SCORE_ATOL). FFTs and matmuls round
    otherwise than XLA's (~1e-7 on scores <= 1);
  - the score-moment covariance: rtol 1e-3, atol 1e-5 (COV_RTOL,
    COV_ATOL; the JAX package's own between its two exact stages in
    tests/test_fused_match.py): its moments cancel, so the scores'
    1e-7 grows to ~1e-4 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.ops import matching as jm
from sparse_gslam_tpu.ops.grid import precompute_pyramid as j_pyramid
from sparse_gslam_tpu_torch.interop import grids_from_numpy, spectra_from_numpy
from sparse_gslam_tpu_torch.ops import matching as tm
from sparse_gslam_tpu_torch.ops.grid import precompute_pyramid

BOUND_RTOL = 1e-6
SCORE_ATOL = 1e-5
COV_RTOL = 1e-3
COV_ATOL = 1e-5

RES = 0.1
SIZE = 64
MARGIN = 64  # F = SIZE + MARGIN = 128
DEPTH = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def walls(rng, size, n_walls=4):
    """A score-like probability grid: 0.15 with a few 0.9 walls."""
    g = np.full((size, size), 0.15, np.float32)
    for _ in range(n_walls):
        x0, y0 = rng.integers(8, size - 8, 2)
        ln = int(rng.integers(size // 4, size // 2))
        if rng.random() < 0.5:
            g[x0:min(x0 + ln, size - 1), y0] = 0.9
        else:
            g[x0, y0:min(y0 + ln, size - 1)] = 0.9
    return g


def make_case(n_cands=3, n_points=96, seed=3, size=SIZE, shift=(0.3, -0.2),
              th=0.05, linear=1.0, angular=0.13, bucket=8, depth=DEPTH):
    """Candidate grids (dilated level 0, pooled level depth-1) and a
    query drawn from the last candidate's walls, moved by (shift, th):
    numpy inputs for both packages (the pyramids: the JAX package's,
    which the port's equals)."""
    rng = np.random.default_rng(seed)
    grids = np.stack([walls(rng, size) for _ in range(n_cands)])
    origin = np.array([-size * RES / 2] * 2)
    occ = np.argwhere(grids[-1] > 0.7)
    sel = rng.choice(len(occ), size=n_points, replace=True)
    pts_map = origin + (occ[sel] + 0.5) * RES
    c, s = np.cos(-th), np.sin(-th)
    pts = ((pts_map - np.asarray(shift)) @ np.array([[c, -s], [s, c]]).T
           ).astype(np.float32)
    pyr = np.stack([np.asarray(j_pyramid(jnp.asarray(g), depth))
                    for g in grids])
    spec = jm.search_spec(linear, angular, 6.0, RES, angular_bucket=bucket)
    th0 = list(np.linspace(-0.05, 0.05, n_cands))
    return dict(sg=pyr[:, 0], pooled=pyr[:, depth - 1],
                origins=np.tile(origin.astype(np.float32), (n_cands, 1)),
                th0=th0, pts=pts, spec=spec, stride=1 << (depth - 1))


def run_jax(case, min_score, K, **kw):
    return jm.match_candidates_fused(
        [jnp.asarray(g) for g in case["sg"]],
        [jnp.asarray(g) for g in case["pooled"]],
        [jnp.asarray(o) for o in case["origins"]], case["th0"],
        case["pts"], case["spec"], min_score, case["stride"],
        fft_margin_bucket=MARGIN, K=K, **kw)


def run_port(case, min_score, K, **kw):
    return tm.match_candidates_fused(
        grids_from_numpy(case["sg"], "cpu"),
        grids_from_numpy(case["pooled"], "cpu"),
        grids_from_numpy(case["origins"], "cpu"),
        case["th0"], case["pts"], tm.SearchSpec(*case["spec"]), min_score,
        case["stride"], fft_margin_bucket=MARGIN, K=K, **kw)


def calls(fn, pkg):
    """fn()'s result and the fused_match calls it made in `pkg`."""
    n = pkg.FUSED_CALLS
    out = fn()
    return out, pkg.FUSED_CALLS - n


def assert_same_match(a, b):
    """JAX result a, port result b: (cand, score, pose, cov)."""
    assert a[0] == b[0]
    if a[0] is None:
        return
    assert abs(a[1] - b[1]) < SCORE_ATOL
    np.testing.assert_array_equal(np.asarray(a[2], np.float32),
                                  np.asarray(b[2], np.float32))
    np.testing.assert_allclose(b[3], a[3], rtol=COV_RTOL, atol=COV_ATOL)


@pytest.fixture(scope="module")
def case():
    return make_case()


def test_pyramids_match_jax():
    """The port's pyramid of a case grid equals the JAX one that both
    packages take as input here."""
    g = walls(np.random.default_rng(3), SIZE)
    ours = precompute_pyramid(torch.from_numpy(g), DEPTH).numpy()
    np.testing.assert_array_equal(ours, np.asarray(
        j_pyramid(jnp.asarray(g), DEPTH)))


# the cases of tests/test_fused_match.py, through both packages:
# (min_score, K, SLAM_MATCH_EXACT, cached spectra)
CASES = {
    "pruned_equivalence": (0.6, 32, "nudft", False),
    "nudft_cached_spectra": (0.6, 32, "nudft", True),
    "fft_exact_stage": (0.6, 32, "fft", False),
    "miss_below_min_score": (0.999, 32, "nudft", True),
    "tiny_k_pages_until_exact": (0.6, 4, "nudft", True),
    "bounds_really_bound": (0.0, 2, "nudft", True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_match_candidates_fused_matches_jax(case, name, monkeypatch):
    min_score, K, exact, cached = CASES[name]
    monkeypatch.setenv("SLAM_MATCH_EXACT", exact)
    kw_j, kw_t = {}, {}
    if cached:
        F = SIZE + MARGIN
        kw_j["spectra_list"] = [
            jm.grid_spectrum(jnp.asarray(g)[None], F, SIZE)[0]
            for g in case["sg"]]
        # the JAX package's cached spectra, read by the port (interop)
        kw_t["spectra_list"] = list(spectra_from_numpy(
            np.stack([np.asarray(x) for x in kw_j["spectra_list"]]), "cpu"))
    a, na = calls(lambda: run_jax(case, min_score, K, **kw_j), jm)
    b, nb = calls(lambda: run_port(case, min_score, K, **kw_t), tm)
    assert_same_match(a, b)
    if K > 2:
        # at K = 2 the K-th bound is compared with the floor plane by
        # plane, and bounds an ulp apart page once more or less (7 calls
        # in the JAX package, 8 here)
        assert na == nb
    if name == "miss_below_min_score":
        assert b[0] is None
    if name == "tiny_k_pages_until_exact":
        assert nb > 2  # paged, and re-scored the band
    if name == "bounds_really_bound":
        # the exhaustive pruned matcher's candidate and radius
        ref = tm.match_candidates_pruned(
            [torch.from_numpy(g.copy()) for g in case["sg"]],
            [torch.from_numpy(g.copy()) for g in case["pooled"]],
            [torch.from_numpy(o.copy()) for o in case["origins"]],
            case["th0"], case["pts"], tm.SearchSpec(*case["spec"]), 0.0,
            case["stride"], fft_margin_bucket=MARGIN)
        assert ref[0] == b[0]
        assert abs(ref[1] - b[1]) < tm.SCORE_NOISE_BAND + 1e-5


def test_single_candidate_matches_jax():
    c = make_case(n_cands=1, seed=4)
    assert_same_match(run_jax(c, 0.6, 32), run_port(c, 0.6, 32))


def test_chunks_of_more_than_16_candidates_match_jax():
    """18 candidates: two chunks of 16, the running best of the first
    the floor of the second."""
    c = make_case(n_cands=18, n_points=64, seed=6)
    a, na = calls(lambda: run_jax(c, 0.5, 16), jm)
    b, nb = calls(lambda: run_port(c, 0.5, 16), tm)
    assert_same_match(a, b)
    # both chunks called, and paged alike within one page (the ulp-apart
    # bounds at the K-th place: 9 calls in the JAX package, 10 here)
    assert na >= 2 and nb >= 2 and abs(na - nb) <= 1


def test_boundary_offset_stride16_matches_jax():
    """The best match near the window edge at stride 16 (the coarse
    block shift one past floor(L/stride))."""
    c = make_case(n_cands=1, n_points=80, seed=7, size=128,
                  shift=(2.4, -2.4), th=0.0, linear=2.5, angular=0.1,
                  depth=5)
    a = run_jax(c, 0.3, 16)
    b = run_port(c, 0.3, 16)
    assert_same_match(a, b)
    assert abs(b[2][0] - 2.4) < 0.3 and abs(b[2][1] + 2.4) < 0.3


def jax_fused(case, K, spectra):
    """The JAX fused_match on the case's first chunk, and its inputs."""
    spec = case["spec"]
    C = len(case["sg"])
    R = 2 * spec.n_angular + 1
    ks = np.arange(R) - spec.n_angular
    thetas = np.stack([(t + ks * spec.angular_step).astype(np.float32)
                       for t in case["th0"]])
    pts = np.zeros((256, 2), np.float32)
    pts[:len(case["pts"])] = case["pts"]
    valid = np.arange(256) < len(case["pts"])
    args = dict(sg=case["sg"], pooled=case["pooled"],
                origins=case["origins"], thetas=thetas,
                live=np.ones(C, bool), pts=pts, valid=valid,
                th0=np.asarray(case["th0"], np.float32))
    F = SIZE + MARGIN
    js = jm.grid_spectrum(jnp.asarray(case["sg"]), F, SIZE) if spectra \
        else None
    out = jm.fused_match(
        *(jnp.asarray(v) for v in args.values()),
        jnp.float32(spec.angular_step), jnp.float32(0.6), RES,
        int(spec.n_linear), SIZE, F, case["stride"], K, spectra=js)
    return [np.asarray(o) for o in out], args


@pytest.mark.parametrize("spectra", [True, False])
def test_fused_match_outputs_match_jax(case, spectra):
    """One fused_match call: score, pose, covariance, candidate, K-th
    bound, the scored planes and every plane's bound."""
    K = 32
    j, args = jax_fused(case, K, spectra)
    F = SIZE + MARGIN
    t = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in args.items()}
    ts = tm.grid_spectrum(t["sg"], F, SIZE) if spectra else None
    spec = case["spec"]
    out = tm.fused_match(
        t["sg"], t["pooled"], t["origins"], t["thetas"], t["live"],
        t["pts"], t["valid"], t["th0"], np.float32(spec.angular_step),
        np.float32(0.6), RES, int(spec.n_linear), SIZE, F, case["stride"],
        K, spectra=ts)
    score, pose, cov, cand, kth, top_idx, bounds = out
    assert abs(float(score) - float(j[0])) < SCORE_ATOL
    np.testing.assert_array_equal(pose.numpy(), j[1])
    np.testing.assert_allclose(cov.numpy(), j[2], rtol=COV_RTOL,
                               atol=COV_ATOL)
    assert int(cand) == int(j[3])
    np.testing.assert_allclose(float(kth), float(j[4]), rtol=BOUND_RTOL)
    np.testing.assert_allclose(bounds.numpy(), j[6], rtol=BOUND_RTOL)
    # the same planes scored, but where two bounds an ulp apart swap
    same = np.isin(top_idx.numpy(), j[5])
    near = np.isclose(bounds.numpy().ravel()[top_idx.numpy()[~same]],
                      float(j[4]), rtol=BOUND_RTOL)
    assert same.all() or near.all()


@functools.lru_cache(maxsize=None)
def jitted(fn, static):
    return jax.jit(fn, static_argnames=static)


def cells_case(K=64, N=256, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6, 6, (N, 2)).astype(np.float32)
    th = rng.uniform(-3.2, 3.2, K).astype(np.float32)
    org = rng.uniform(-4, -2, (K, 2)).astype(np.float32)
    return pts, th, org


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_cells_match_jax(seed):
    """Cells of many points and rotations, knife edges included (as
    the fused program computes them: static resolution)."""
    pts, th, org = cells_case(K=256, N=512, seed=seed)
    jx, jy = jitted(jm._plane_cells, ("resolution",))(
        jnp.asarray(pts), jnp.asarray(th), jnp.asarray(org), resolution=RES)
    tx, ty = tm._plane_cells(torch.from_numpy(pts), torch.from_numpy(th),
                             torch.from_numpy(org), RES)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("masked", [False, True])
def test_histograms_match_jax(masked):
    """_hist_onehot (one mask) and _hist_onehot_masked (a mask per
    plane): counts and n_in equal."""
    rng = np.random.default_rng(2)
    K, N, size, out = 8, 128, 40, 48
    cx = rng.integers(-4, size + 4, (K, N)).astype(np.int32)
    cy = rng.integers(-4, size + 4, (K, N)).astype(np.int32)
    if masked:
        valid = rng.random((K, N)) < 0.8
        jh, jn = jitted(jm._hist_onehot_masked, ("size", "out_size"))(
            cx, cy, valid, size=size, out_size=out)
        th, tn = tm._hist_onehot_masked(
            torch.from_numpy(cx).long(), torch.from_numpy(cy).long(),
            torch.from_numpy(valid), size, out)
    else:
        valid = rng.random(N) < 0.8
        jh, jn = jitted(jm._hist_onehot, ("size", "out_size"))(
            cx, cy, valid, size=size, out_size=out)
        th, tn = tm._hist_onehot(
            torch.from_numpy(cx).long(), torch.from_numpy(cy).long(),
            torch.from_numpy(valid), size, out)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def planes_case(K=6, N=128, seed=5):
    """K planes' cells against K grids' spectra (F = 128)."""
    rng = np.random.default_rng(seed)
    grids = np.stack([walls(rng, SIZE) for _ in range(K)])
    cx = rng.integers(-3, SIZE + 3, (K, N)).astype(np.int32)
    cy = rng.integers(-3, SIZE + 3, (K, N)).astype(np.int32)
    valid = np.arange(N) < N - 9
    return grids, cx, cy, valid


def test_grid_spectrum_matches_jax():
    grids = planes_case()[0]
    F = SIZE + MARGIN
    j = np.asarray(jm.grid_spectrum(jnp.asarray(grids), F, SIZE))
    t = tm.grid_spectrum(torch.from_numpy(grids), F, SIZE).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-5)


def pin_window_scores(Fg, cx, cy, valid, n_valid, n_linear, size,
                      fft_size):
    """pin_eval_batch's window scores as its program computes them
    (its inline copy of _corr_planes_hist, with a count per plane)."""
    hist, n_in = jm._hist_onehot_masked(cx, cy, valid, size, fft_size)
    S = jnp.conj(jm._rfft2_chunked(hist)) * Fg
    corr = jm._partial_idft(jnp.real(S).astype(jnp.float32),
                            jnp.imag(S).astype(jnp.float32), n_linear,
                            fft_size)
    corr = corr + (n_valid - n_in)[:, None, None] * jm.PMIN
    return corr / n_valid[:, None, None]


@pytest.mark.parametrize("stage", ["nudft", "fft", "hist"])
def test_exact_scores_match_jax(stage):
    """The three exact stages on the same planes: (K, W, W) scores
    within SCORE_ATOL of the JAX program's."""
    grids, cx, cy, valid = planes_case()
    F, L = SIZE + MARGIN, 10
    K = len(grids)
    jFg = jm.grid_spectrum(jnp.asarray(grids), F, SIZE)
    tFg = tm.grid_spectrum(torch.from_numpy(grids), F, SIZE)
    nv = np.float32(valid.sum())
    tcx, tcy = torch.from_numpy(cx).long(), torch.from_numpy(cy).long()
    if stage == "nudft":
        j = jitted(jm._corr_planes_nudft, ("n_linear", "size",
                                            "fft_size"))(
            jFg, cx, cy, valid, nv, n_linear=L, size=SIZE, fft_size=F)
        t = tm._corr_planes_nudft(tFg, tcx, tcy, torch.from_numpy(valid),
                                  torch.tensor(nv), L, SIZE, F)
    elif stage == "fft":
        def jfn(cx, cy, valid, Fg, nv, n_linear, size, fft_size):
            hist, n_in = jm._hist_onehot(cx, cy, valid, size, fft_size)
            return jm._corr_planes(hist, Fg, n_in, nv, n_linear, fft_size)
        j = jitted(jfn, ("n_linear", "size", "fft_size"))(
            cx, cy, valid, jFg, nv, n_linear=L, size=SIZE, fft_size=F)
        hist, n_in = tm._hist_onehot(tcx, tcy, torch.from_numpy(valid),
                                     SIZE, F)
        t = tm._corr_planes(hist, tFg, n_in, torch.tensor(nv), L, F)
    else:
        vk = np.repeat(valid[None], K, 0)
        vk[::2, :20] = False  # a mask per plane
        nvk = np.maximum(vk.sum(1), 1).astype(np.float32)
        j = jitted(pin_window_scores, ("n_linear", "size", "fft_size"))(
            jFg, cx, cy, vk, nvk, n_linear=L, size=SIZE, fft_size=F)
        t = tm._corr_planes_hist(tFg, tcx, tcy, torch.from_numpy(vk),
                                 torch.from_numpy(nvk), L, SIZE, F)
    assert t.shape == (K, 2 * L + 1, 2 * L + 1)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=SCORE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("F,L", [(128, 10), (384, 8)])
def test_partial_idft_matches_jax(F, L):
    """The window-only inverse DFT of the half spectra of real images:
    the port sums the hermitian half with the same U (one complex
    contraction over u), the JAX program in eight real einsums; both
    are the inverse FFT on the window, within float32 rounding."""
    rng = np.random.default_rng(F)
    img = rng.uniform(0, 1, (3, F, F)).astype(np.float32)
    S = np.fft.rfft2(img).astype(np.complex64)
    j = jitted(jm._partial_idft, ("n_linear", "fft_size"))(
        np.ascontiguousarray(S.real), np.ascontiguousarray(S.imag),
        n_linear=L, fft_size=F)
    t = tm._partial_idft(torch.from_numpy(S), L, F).numpy()
    ref = np.roll(img, (L, L), axis=(1, 2))[:, :2 * L + 1, :2 * L + 1]
    np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t, ref, atol=1e-5, rtol=0)


def test_phase_tables_are_the_jax_programs_cos_sin():
    """Every phase the programs evaluate is (integer mod F) * w: the
    F-entry tables equal jnp.cos/jnp.sin of those phases in a jit."""
    for F in (128, 384):
        w = jnp.float32(2.0 * np.pi / F)

        def ph(j):
            p = (j % F).astype(jnp.float32) * w
            return jnp.cos(p), jnp.sin(p)

        jc, js = jax.jit(ph)(jnp.arange(3 * F, dtype=jnp.int32))
        tc, ts = tm._phase_tables(F, "cpu")
        idx = np.arange(3 * F) % F
        np.testing.assert_array_equal(tc.numpy()[idx], np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy()[idx], np.asarray(js))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_orders_ties_as_lax_top_k(seed):
    """Bounds that tie (equal values, -inf padding planes) come out in
    lax.top_k's order: ascending index among equals."""
    rng = np.random.default_rng(seed)
    x = rng.choice(np.float32([0.3, 0.5, 0.5, 0.7, -np.inf]), 200)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 64)
    tv, ti = tm._top_k(torch.from_numpy(x), 64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
