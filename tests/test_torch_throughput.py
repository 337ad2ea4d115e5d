"""The port's throughput measurement of the fused matcher
(sparse_gslam_tpu_torch/ops/matching.py match_candidates_fused_throughput)
against the JAX package's, on the CPU, at the JAX bench's matcher case
(bench.py make_matcher_case) reduced to 4 candidates on 256-cell grids
(the bench: 16 on 384).

- It returns `reps` positive wall times, one per round of `depth` calls.
- Its reference call's score equals the JAX package's within
  tests/test_torch_fused_match.py's SCORE_ATOL (FFTs and matmuls round
  otherwise than XLA's, ~1e-7 on scores <= 1).
- On 128-cell grids the best planes' coarse bounds sit an ulp apart
  (0.9 and 0.90000004 in the port; tests/test_torch_fused_match.py's
  BOUND_RTOL), and the centred tie-break, which takes the first of the
  in-band cells of one radius in top-K order, picks another rotation at
  the same translation (scores 0.8816 and 0.8875, both packages' exact
  scores of all 132 planes within 7e-7 of each other): held to the JAX
  package's own contract for such ties, the same candidate and
  translation and the score within SCORE_NOISE_BAND.
- A repeat whose score moves trips its assertion.
"""
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.ops import matching as jm
from sparse_gslam_tpu.ops.grid import precompute_pyramid as j_pyramid
from sparse_gslam_tpu_torch.interop import grids_from_numpy
from sparse_gslam_tpu_torch.ops import matching as tm

SCORE_ATOL = 1e-5  # as tests/test_torch_fused_match.py
N_CANDS, N_POINTS, DEPTH = 4, 128, 3


def _bench():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    spec = importlib.util.spec_from_file_location("_jax_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def make_case(size):
    grids, origin, res, pts = _bench().make_matcher_case(
        n_cands=N_CANDS, size=size, n_points=N_POINTS)
    pyr = np.stack([np.asarray(j_pyramid(jnp.asarray(g), DEPTH))
                    for g in grids])
    return dict(sg=pyr[:, 0], pooled=pyr[:, DEPTH - 1],
                origins=np.tile(origin.astype(np.float32), (N_CANDS, 1)),
                th0=[0.0] * N_CANDS, pts=pts.astype(np.float32),
                spec=jm.search_spec(2.0, 0.15, 10.0, res),
                stride=1 << (DEPTH - 1))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recorded(monkeypatch, pkg, change=None):
    """Every fused_match call of `pkg` kept in the returned list; with
    `change`, the calls after the first return its score plus `change`."""
    seen = []
    orig = pkg.fused_match

    def fused_match(*a, **k):
        out = orig(*a, **k)
        if change is not None and seen:
            out = (out[0] + change,) + tuple(out[1:])
        seen.append(out)
        return out

    monkeypatch.setattr(pkg, "fused_match", fused_match)
    return seen


def run_jax(case):
    return jm.match_candidates_fused_throughput(
        [jnp.asarray(g) for g in case["sg"]],
        [jnp.asarray(g) for g in case["pooled"]],
        [jnp.asarray(o) for o in case["origins"]], case["th0"], case["pts"],
        case["spec"], 0.6, case["stride"], depth=1, reps=1)


def run_port(case, depth, reps):
    return tm.match_candidates_fused_throughput(
        grids_from_numpy(case["sg"], "cpu"),
        grids_from_numpy(case["pooled"], "cpu"),
        grids_from_numpy(case["origins"], "cpu"), case["th0"], case["pts"],
        tm.SearchSpec(*case["spec"]), 0.6, case["stride"], depth=depth,
        reps=reps)


def test_throughput_times_and_reference_match_jax(monkeypatch):
    case = make_case(256)
    port = recorded(monkeypatch, tm)
    times = run_port(case, depth=2, reps=2)
    assert len(times) == 2
    assert all(isinstance(t, float) and t > 0 for t in times)
    assert len(port) == 1 + 2 * 2
    ref = recorded(monkeypatch, jm)
    run_jax(case)
    assert abs(float(port[0][0]) - float(ref[0][0])) < SCORE_ATOL
    assert float(port[0][0]) > 0.6  # the query lies on the last grid


def test_throughput_reference_within_the_band_at_bound_ties(monkeypatch):
    case = make_case(128)
    port = recorded(monkeypatch, tm)
    run_port(case, depth=1, reps=1)
    ref = recorded(monkeypatch, jm)
    run_jax(case)
    (ps, pp, _, pc), (js, jp, _, jc) = port[0][:4], ref[0][:4]
    assert int(pc) == int(jc)
    np.testing.assert_array_equal(pp.numpy()[:2], np.asarray(jp)[:2])
    assert abs(float(ps) - float(js)) < tm.SCORE_NOISE_BAND


def test_throughput_asserts_every_repeat(monkeypatch):
    recorded(monkeypatch, tm, change=1e-3)
    with pytest.raises(AssertionError):
        run_port(make_case(128), depth=2, reps=1)
