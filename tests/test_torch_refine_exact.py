"""The port's scan refinement against the JAX package's, bit for bit.

- The plain version (sparse_gslam_tpu_torch/ops/refine_exact.py, behind
  ops/matching.py refine_pose / refine_pose_cov /
  refine_pose_cov_two_stage on the CPU) against the JAX package's
  compiled programs on 72 seeded cases: a room and a corridor (whose
  J^T J is near-singular along the corridor), grids at 0.1 m and
  0.05 m, padded point counts from N = 256 to 65536 (the callers pad to
  every 256 * 2^k; the kernel's rows leave shared memory above 8192),
  one stage, the two-stage variants (dilated score grid, then the raw
  grid or the 0.05 m high-res grid) and refine_pose alone.
  np.array_equal on pose, covariance and probabilities. XLA's J^T J and
  J^T r on their own against the plain version's chains at K = N + 3.
- The 3x3 LAPACK transcriptions (sgetrf, the two strsm, ssyevd) against
  SciPy's LAPACK, which jaxlib calls: the numpy ones on 3000 matrices,
  the CUDA kernel's header (csrc/refine_pose_exact.cuh, built with g++
  through csrc/refine_pose_host.cpp) on 10^5. Singular factors give NaN
  in both; NaN counts as equal to NaN.
- The header's whole block program (the kernel's algorithm, threads run
  in turn) against the plain version at N = 256 to 32768 (above 8192
  its staged variant, whose reductions take the rows chunk by chunk), on
  cases that end their stage at the first GN step (its trial rejected)
  and that run all ten (the plain version always runs ten), and its
  sinf/cosf against the C library on a dense sample of |theta| <= 4 pi.
- The rsqrtss rule (a table on [1, 4), scaled by the exponent) against
  the CPU's own instruction (x86), and the refusal of other point
  counts.
"""
import ctypes
import platform
import shutil
import struct
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg.blas as sblas
import scipy.linalg.lapack as slapack
import torch

from sparse_gslam_tpu.models.range_data import RangeData2D
from sparse_gslam_tpu.ops import matching as jm
from sparse_gslam_tpu.ops.grid import (
    GridSpec,
    build_submap_grid,
    precompute_pyramid,
)
from sparse_gslam_tpu_torch.ops import matching as tm
from sparse_gslam_tpu_torch.ops import refine_cuda
from sparse_gslam_tpu_torch.ops import refine_exact as rx

F32 = np.float32
WALLS = {
    # (point on the wall, direction): a 7 x 6 m room, a 2 m wide corridor
    "room": [((4.0, 0.0), (0.0, 1.0)), ((-3.0, 0.0), (0.0, 1.0)),
             ((0.0, -1.0), (1.0, 0.0)), ((0.0, 5.0), (1.0, 0.0))],
    "corridor": [((0.0, -1.0), (1.0, 0.0)), ((0.0, 1.0), (1.0, 0.0))],
}
PATH = [(0.0, 0.3 * i, 0.4 * i) for i in range(12)]  # the room's scans


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cast(pose, angles, walls, max_range=8.0):
    """Ranges from `pose` to the nearest of `walls` along beam angles
    (inf beyond max_range)."""
    x, y, th = pose
    a = th + angles
    cx, cy = np.cos(a), np.sin(a)
    best = np.full(len(angles), np.inf)
    for (px, py), (dx, dy) in walls:
        den = cx * dy - cy * dx
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((px - x) * dy - (py - y) * dx) / den
        best = np.minimum(best, np.where((np.abs(den) > 1e-9) & (t > 0), t,
                                         np.inf))
    return np.where(best <= max_range, best, np.inf)


def scan_points(world, pose, n_beams, rng):
    angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    r = cast(pose, angles, WALLS[world])
    ok = np.isfinite(r)
    r = r[ok] + rng.normal(0, 0.01, ok.sum())
    a = angles[ok]
    return np.stack([r * np.cos(a), r * np.sin(a)], 1)


def corridor_grid(res, size):
    """The corridor's walls as a grid uniform along x: a 3-cell band of
    0.9 at y = +-1, 0.2 between them, unknown outside."""
    origin = np.full(2, -size * res / 2, F32)
    ys = origin[1] + (np.arange(size) + 0.5) * res
    d = np.abs(np.abs(ys) - 1.0)
    col = np.where(d < 1.5 * res, 0.9, np.where(np.abs(ys) < 1.0, 0.2, 0.0))
    return np.repeat(col[None, :], size, 0).astype(F32), origin


@pytest.fixture(scope="module")
def worlds():
    """Per world: the grids at 0.1 m (probs and the dilated score grid
    of the JAX package's precompute_pyramid, G=160) and 0.05 m (probs,
    G=320), as numpy. The room's come from the JAX package's
    build_submap_grid; the corridor's are uniform along it, so that nothing
    pins the pose along x."""
    out = {}
    table_angles = np.linspace(-np.pi, np.pi, 90, endpoint=False)
    table = np.stack([np.cos(table_angles), np.sin(table_angles)], 1)
    for world in WALLS:
        grids = {}
        for res, size in ((0.1, 160), (0.05, 320)):
            if world == "corridor":
                grids[res] = corridor_grid(res, size)
            else:
                rd = RangeData2D()
                for pose in PATH:
                    r = cast(pose, table_angles, WALLS[world])
                    rd.insert_scan(np.minimum(r, 8.0), table, 8.0,
                                   pose=np.array(pose))
                sm = build_submap_grid(rd, GridSpec(size=size,
                                                    resolution=res))
                grids[res] = (np.asarray(sm.probs),
                              np.asarray(sm.origin, F32))
            if res == 0.1:
                grids["score"] = (np.asarray(precompute_pyramid(
                    jnp.asarray(grids[res][0]), 5))[0], grids[res][1])
        out[world] = grids
    return out


def query(world, n_pad, seed):
    """A scan taken at a seeded pose, in its own frame, padded to
    n_pad; the initial pose off by a few cm and a degree or two. 720
    beams up to N = 512, twice N beams above, so that most padded
    points are valid."""
    rng = np.random.default_rng(seed)
    gt = np.array([rng.uniform(-0.5, 0.5), rng.uniform(0.0, 0.8),
                   rng.uniform(-0.4, 0.4)])
    pts = scan_points(world, gt, 720 if n_pad <= 512 else 2 * n_pad, rng)
    keep = rng.permutation(len(pts))[: min(len(pts), n_pad - 40)]
    pts = pts[np.sort(keep)]
    padded = np.zeros((n_pad, 2), F32)
    padded[: len(pts)] = pts
    valid = np.arange(n_pad) < len(pts)
    init = (gt + np.array([rng.uniform(-0.06, 0.06), rng.uniform(-0.06, 0.06),
                           rng.uniform(-0.03, 0.03)])).astype(F32)
    return padded, valid, init


# (program, world, grid keys of the stages, N, seed): 40 cases at the
# sim worlds' N, 30 at the larger ones (more beams, e.g. 60 or 180), and
# one each at 32768 and 65536
CASES = (
    [("cov", w, (res,), n, s) for w in WALLS for res in (0.1, 0.05)
     for n in (256, 512) for s in range(3)]
    + [("two", w, ("score", 0.05), n, s) for w in WALLS for n in (256, 512)
       for s in range(2)]
    + [("two", w, ("score", 0.1), 256, s) for w in WALLS for s in range(2)]
    + [("pose", w, (0.1,), 256, s) for w in WALLS for s in range(2)]
    + [(prog, w, keys, n, s) for n in (1024, 2048, 4096, 8192, 16384)
       for prog, w, keys, s in (
           ("cov", "room", (0.1,), 0), ("cov", "corridor", (0.05,), 1),
           ("two", "room", ("score", 0.05), 2),
           ("two", "corridor", ("score", 0.1), 3),
           ("pose", "room", (0.1,), 4), ("pose", "corridor", (0.05,), 5))]
    + [("cov", "corridor", (0.05,), 32768, 1),
       ("pose", "room", (0.1,), 65536, 4)]
)


def _stages(worlds, world, keys):
    out = []
    for key in keys:
        grid, origin = worlds[world][key]
        out.append((grid, origin, 0.1 if key == "score" else key))
    return out


def jax_refine(program, stages, pts, valid, init):
    args = (jnp.asarray(pts), jnp.asarray(valid),
            jnp.asarray(init, dtype=jnp.float32))
    if program == "pose":
        return [np.asarray(jm.refine_pose(*stages[0], *args))]
    if program == "cov":
        return [np.asarray(a) for a in jm.refine_pose_cov(*stages[0], *args)]
    return [np.asarray(a) for a in jm.refine_pose_cov_two_stage(
        *stages[0], *stages[1], *args)]


def port_refine(program, stages, pts, valid, init):
    tstages = [(torch.tensor(g), torch.tensor(o), r) for g, o, r in stages]
    args = (torch.from_numpy(pts), torch.from_numpy(valid),
            torch.from_numpy(init))
    if program == "pose":
        return [tm.refine_pose(*tstages[0], *args).numpy()]
    if program == "cov":
        return [a.numpy() for a in tm.refine_pose_cov(*tstages[0], *args)]
    return [a.numpy() for a in tm.refine_pose_cov_two_stage(
        *tstages[0], *tstages[1], *args)]


@pytest.mark.parametrize("program,world,keys,n,seed", CASES)
def test_plain_refinement_bit_equal_to_jax(worlds, program, world, keys, n,
                                           seed):
    stages = _stages(worlds, world, keys)
    pts, valid, init = query(world, n, seed)
    ref = jax_refine(program, stages, pts, valid, init)
    got = port_refine(program, stages, pts, valid, init)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, r)


def test_corridor_is_near_singular(worlds):
    """The corridor cases exercise what they are for: J^T J has no
    information along the corridor, so the covariance's pseudo-inverse
    gives that direction the 1e6 fill and it dwarfs the others."""
    stages = _stages(worlds, "corridor", (0.05,))
    pts, valid, init = query("corridor", 256, 0)
    _, cov, _ = port_refine("cov", stages, pts, valid, init)
    w = np.linalg.eigvalsh(cov.astype(np.float64))
    assert w[-1] > 1e6 * w[0] > 0


def lapack_matrices(rng, count):
    """J^T J of random Jacobians, near-singular corridor-like SPD
    matrices, general matrices (pivoting) and nearly diagonal ones."""
    out = np.empty((count, 3, 3), F32)
    for q in range(count):
        kind = q % 4
        if kind == 0:
            J = rng.standard_normal((rng.integers(3, 40), 3)) * np.exp(
                rng.uniform(-2, 4, 3))
            H = J.T @ J
        elif kind == 1:
            Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            ev = np.exp(rng.uniform(2, 12, 3))
            ev[rng.integers(3)] *= 10.0 ** rng.uniform(-14, -5)
            H = (Q * ev) @ Q.T
        elif kind == 2:
            H = rng.standard_normal((3, 3)) * np.exp(
                rng.uniform(-3, 3, (3, 3)))
        else:
            H = np.diag(np.exp(rng.uniform(0, 10, 3))) + rng.standard_normal(
                (3, 3)) * 10.0 ** rng.uniform(-8, 0)
        out[q] = H.astype(F32)
    return out


def scipy_lapack(A, b):
    """SciPy's sgetrf, strsm (lower unit, upper) of the factor on b,
    and ssyevd('V', 'L') of the symmetrized A."""
    lu, piv, _ = slapack.sgetrf(A)
    lo = sblas.strsm(1.0, lu, b.reshape(3, 1), lower=1, diag=1)[:, 0]
    up = sblas.strsm(1.0, lu, b.reshape(3, 1), lower=0, diag=0)[:, 0]
    S = (A + A.T) * F32(0.5)
    w, z, info = slapack.ssyevd(S, compute_v=1, lower=1)
    return lu, piv, lo, up, w, z, info


def test_numpy_lapack_bit_equal_to_scipy():
    rng = np.random.default_rng(11)
    A = lapack_matrices(rng, 3000)
    # beyond ssyevd's safe range, so that its scaling runs as well
    A[::50] *= F32(1e-18)
    A[1::50] *= F32(1e18)
    for q in range(len(A)):
        b = (rng.standard_normal(3) * 100).astype(F32)
        lu, piv, lo, up, w, z, info = scipy_lapack(A[q], b)
        a = [[F32(v) for v in row] for row in A[q]]
        got_piv = rx.sgetrf3(a)
        np.testing.assert_array_equal(np.array(a, F32), lu)
        assert got_piv == list(piv)
        c = [F32(v) for v in b]
        rx.strsm_lower_unit(a, c)
        np.testing.assert_array_equal(np.array(c, F32), lo)
        c = [F32(v) for v in b]
        rx.strsm_upper(a, c)
        np.testing.assert_array_equal(np.array(c, F32), up)
        gw, gz, ginfo = rx.ssyevd3((A[q] + A[q].T) * F32(0.5))
        np.testing.assert_array_equal(gw, w)
        np.testing.assert_array_equal(gz, z)
        assert ginfo == info


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the refinement "
                    "kernel needs a C++ compiler")
    return refine_cuda.host_library()


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_header_lapack_bit_equal_to_scipy(host_lib):
    rng = np.random.default_rng(12)
    N = 100_000
    A = lapack_matrices(rng, N)
    b = (rng.standard_normal((N, 3)) * 100).astype(F32)
    S = np.ascontiguousarray((A + A.transpose(0, 2, 1)) * F32(0.5))
    lu = np.empty_like(A)
    piv = np.empty((N, 3), np.int32)
    host_lib.rpx_sgetrf3(_ptr(A), N, _ptr(lu), _ptr(piv))
    lo, up = b.copy(), b.copy()
    host_lib.rpx_strsm3(_ptr(lu), _ptr(lo), N, 0)
    host_lib.rpx_strsm3(_ptr(lu), _ptr(up), N, 1)
    w = np.empty((N, 3), F32)
    z = np.empty((N, 3, 3), F32)
    info = np.empty(N, np.int32)
    host_lib.rpx_ssyevd3(_ptr(S), N, _ptr(w), _ptr(z), _ptr(info))
    bad = []
    for q in range(N):
        r = scipy_lapack(A[q], b[q])
        got = (lu[q], piv[q], lo[q], up[q], w[q], z[q], info[q])
        if not all(np.array_equal(g, e, equal_nan=True)
                   for g, e in zip(got, r)):
            bad.append(q)
    assert not bad, f"{len(bad)} of {N} differ, first {bad[:5]}"


def header_refine(lib, stages, pts, valid, init, want_cov=True, rc=0):
    """The header's block program (host build) on one problem: [pose,
    cov, probs] and the GN steps each stage ran."""
    (g0, o0, r0), (g1, o1, r1) = stages[0], stages[-1]
    g0, g1 = np.ascontiguousarray(g0, F32), np.ascontiguousarray(g1, F32)
    n = len(pts)
    pose, cov, probs = (np.zeros(3, F32), np.zeros(9, F32),
                        np.zeros(n, F32))
    steps = np.zeros(2, np.int32)
    y0 = rx.rsqrtss_table()
    valid8 = np.ascontiguousarray(valid, np.uint8)
    assert lib.refine_pose_host(
        _ptr(g0), g0.shape[0], _ptr(o0), r0, _ptr(g1), g1.shape[0],
        _ptr(o1), r1, len(stages), _ptr(pts), _ptr(valid8), _ptr(init),
        _ptr(y0), 1, n, 10, int(want_cov), _ptr(pose), _ptr(cov),
        _ptr(probs), _ptr(steps)) == rc
    return [pose, cov.reshape(3, 3), probs], steps


@pytest.mark.parametrize("program,world,keys,n,seed", [
    ("cov", "room", (0.1,), 256, 0),
    ("cov", "corridor", (0.05,), 512, 1),
    ("two", "room", ("score", 0.05), 512, 2),
    ("two", "corridor", ("score", 0.1), 256, 3),
    ("pose", "corridor", (0.05,), 512, 5),
    ("cov", "room", (0.1,), 1024, 0),
    ("two", "corridor", ("score", 0.1), 1024, 3),
    ("pose", "room", (0.05,), 1024, 6),
    ("cov", "corridor", (0.05,), 2048, 1),
    ("pose", "room", (0.1,), 2048, 4),
    ("two", "room", ("score", 0.1), 2048, 7),
    ("two", "room", ("score", 0.05), 4096, 2),
    ("cov", "corridor", (0.05,), 4096, 1),
    ("two", "corridor", ("score", 0.1), 8192, 3),
    ("cov", "room", (0.05,), 8192, 0),
    ("two", "room", ("score", 0.05), 16384, 2),
    ("cov", "corridor", (0.05,), 32768, 1),
])
def test_header_block_program_bit_equal_to_plain(worlds, host_lib, program,
                                                 world, keys, n, seed):
    stages = _stages(worlds, world, keys)
    pts, valid, init = query(world, n, seed)
    got, _ = header_refine(host_lib, stages, pts, valid, init,
                           want_cov=program != "pose")
    ref = port_refine(program, stages, pts, valid, init)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def stop_query(world, n, seed, scale):
    """query's scan with the initial pose moved further off, by up to
    `scale` times 5 cm and 0.05 rad (seeded)."""
    pts, valid, init = query(world, n, seed)
    rng = np.random.default_rng(1000 + seed)
    off = rng.uniform(-0.05, 0.05, 3) * scale
    return pts, valid, (init + off).astype(F32)


def first_step_costs(stage, pts, valid, init):
    """The JAX loop's first GN step in the plain version's arithmetic:
    (cost at the trial, cost at init)."""
    grid, origin, res = stage
    sg = np.where(grid > 0, grid, rx.PMIN).astype(F32)
    origin, res = np.asarray(origin, F32), F32(res)
    w_occ = rx.occupied_weight(int(valid.sum()))
    wv = valid.astype(F32)
    c, s = tm._cos_sin(init[2])
    p, jo = rx.evaluate(sg, origin, res, pts, init, c, s, True)
    r = rx._residuals(p, init, init, w_occ, wv)
    J = np.concatenate([(-jo * w_occ) * wv[:, None],
                        np.diag(np.array([10, 10, 1], F32))])
    trial = rx.gn_solve(rx._gram(J), rx._gemv(J, r), init)
    c, s = tm._cos_sin(trial[2])
    p2, _ = rx.evaluate(sg, origin, res, pts, trial, c, s, False)
    return (rx._sum_sq(rx._residuals(p2, trial, init, w_occ, wv)),
            rx._sum_sq(r))


# (world, grid key, N, seed, scale, GN steps the stage runs): the first
# trial raises the cost, or every step is kept and moves the pose
# (chosen so by a search over seeds)
STOP_CASES = [
    ("corridor", 0.05, 256, 28, 1, 1), ("room", 0.1, 1024, 3, 6, 1),
    ("corridor", 0.05, 1024, 0, 6, 1), ("room", 0.1, 4096, 22, 6, 1),
    ("room", 0.1, 256, 4, 6, 10), ("corridor", 0.05, 256, 5, 6, 10),
    ("room", 0.1, 4096, 1, 6, 10), ("corridor", 0.05, 4096, 1, 6, 10),
    ("room", 0.1, 16384, 3, 3, 1), ("room", 0.1, 16384, 1, 6, 10),
    ("corridor", 0.05, 32768, 27, 3, 1), ("corridor", 0.05, 32768, 1, 6, 10),
]


@pytest.mark.parametrize("world,key,n,seed,scale,steps", STOP_CASES)
def test_header_early_stop_bit_equal_to_all_steps(worlds, host_lib, world,
                                                  key, n, seed, scale,
                                                  steps):
    """The block program ends a stage at the first step that every later
    step would repeat; the plain version runs all ten. A stage whose
    first trial is rejected stops after one step with the initial pose;
    one that keeps moving runs all ten. Both give the plain bits."""
    stages = _stages(worlds, world, (key,))
    pts, valid, init = stop_query(world, n, seed, scale)
    got, ran = header_refine(host_lib, stages, pts, valid, init)
    assert list(ran) == [steps, 0]
    ref = port_refine("cov", stages, pts, valid, init)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if steps == 1:
        trial_cost, cost = first_step_costs(stages[0], pts, valid, init)
        assert trial_cost > cost
        np.testing.assert_array_equal(got[0], init)


@pytest.mark.parametrize("n", [32, 128, 224, 288, 384, 5000, 12288])
def test_kernel_refuses_other_point_counts(worlds, host_lib, n):
    """The launcher, its host build and the wrapper take the counts the
    callers pad to, 256 * 2^k (up to the int32 offsets' N_LIMIT; the
    tests above run them to 65536), and no other."""
    stages = _stages(worlds, "room", (0.1,))
    pts = np.zeros((n, 2), F32)
    header_refine(host_lib, stages, pts, np.ones(n, bool),
                  np.zeros(3, F32), rc=1)
    assert not refine_cuda.takes_points(n)
    assert all(refine_cuda.takes_points(256 << k) for k in range(19))
    big = 2 * refine_cuda.N_LIMIT  # refused before any array is read
    assert not refine_cuda.takes_points(big)
    grid = (None, 0, None, 0.0)
    assert host_lib.refine_pose_host(*grid, *grid, 1, *[None] * 4, 1, big,
                                     10, 1, *[None] * 4) == 1
    with pytest.raises(ValueError, match=f"N={n} padded points"):
        refine_cuda.refine_cuda(
            [(torch.tensor(g), torch.tensor(o), r) for g, o, r in stages],
            torch.zeros(1, n, 2), torch.ones(1, n, dtype=torch.bool),
            torch.zeros(1, 3))


def test_header_sincosf_matches_libm(host_lib):
    """Every 37th float32 of |theta| <= 4 pi (both signs; 6e7 values)
    and every 9973rd from there to 1e30."""
    end = struct.unpack("<I", struct.pack("<f", 4 * np.pi))[0] + 1
    assert host_lib.rpx_libm_mismatches(0, end, 37, None, None) == 0
    big = struct.unpack("<I", struct.pack("<f", 1e30))[0]
    assert host_lib.rpx_libm_mismatches(end, big, 9973, None, None) == 0


def test_rsqrtss_table_is_the_cpus(tmp_path):
    """rsqrtss(x) is the table's entry for x scaled into [1, 4), times
    the scale's square root: checked against x86 rsqrtss of every n <=
    2^17 and of every 61st float32 in [1, 4) (where the CPU is one); and
    occupied_weight refines it as XLA does."""
    table = rx.rsqrtss_table()
    assert table.shape == (2048,) and table.dtype == np.float32
    n = np.arange(1, 2**17 + 1)
    got = rx.rsqrtss(n.astype(F32))
    rel = np.abs(got * np.sqrt(n) - 1)
    assert rel.max() < 1.5 * 2.0**-12
    gcc = shutil.which("gcc")
    if platform.machine() not in ("x86_64", "AMD64") or gcc is None:
        pytest.skip("rsqrtss is an x86 instruction")
    lo, hi = (int(np.float32(v).view(np.uint32)) for v in (1.0, 4.0))
    src = tmp_path / "rsq.c"
    src.write_text(
        "#include <immintrin.h>\n#include <stdio.h>\n#include <string.h>\n"
        "static unsigned r(float x){float y=_mm_cvtss_f32(_mm_rsqrt_ss("
        "_mm_set_ss(x)));unsigned u;memcpy(&u,&y,4);return u;}\n"
        "int main(void){for(int n=1;n<=131072;n++)"
        "printf(\"%u\\n\",r((float)n));"
        f"for(unsigned u={lo}u;u<{hi}u;u+=61u){{float x;memcpy(&x,&u,4);"
        "printf(\"%u\\n\",r(x));}return 0;}\n")
    exe = tmp_path / "rsq"
    subprocess.run([gcc, "-O2", "-o", str(exe), str(src)], check=True)
    out = np.array(subprocess.run([str(exe)], check=True, capture_output=True,
                                  text=True).stdout.split(), np.uint32)
    np.testing.assert_array_equal(got.view(np.uint32), out[:len(n)])
    floats = np.arange(lo, hi, 61, dtype=np.uint32).view(np.float32)
    dense = rx.rsqrtss(floats)
    np.testing.assert_array_equal(dense.view(np.uint32), out[len(n):])
    assert rx.occupied_weight(0) == rx.occupied_weight(1) == F32(20)


@pytest.mark.parametrize("K", [259, 515, 1027, 2051, 4099, 8195, 16387,
                               32771])
def test_gram_and_gemv_bit_equal_to_xla(K):
    """XLA's J^T J and J^T r with J^T laid out (3, K) as in the compiled
    refinement, K = N + 3 rows, against the plain version's chains: one
    FMA chain per entry, and the eight-lane gemv."""
    rng = np.random.default_rng(K)
    gram = jax.jit(lambda jt: jt @ jt.T)
    gemv = jax.jit(lambda jt, r: jt @ r)
    for _ in range(4):
        J = (rng.standard_normal((K, 3))
             * np.exp(rng.uniform(-3, 3, (K, 1)))).astype(F32)
        r = rng.standard_normal(K).astype(F32)
        jt = np.ascontiguousarray(J.T)
        np.testing.assert_array_equal(np.asarray(gram(jt)), rx._gram(J))
        np.testing.assert_array_equal(np.asarray(gemv(jt, r)),
                                      rx._gemv(J, r))


def test_fma32_rounds_once():
    """The numpy fma32 against the C library's fmaf, on random float32
    triples and on sums the float64 path would round twice (an exact
    float32 midpoint plus a tiny remainder); and the Gram and gemv
    chains' float64 fast path against fma32 chains."""
    import ctypes.util

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.fmaf.restype = ctypes.c_float
    libm.fmaf.argtypes = [ctypes.c_float] * 3
    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal(4000) * np.exp(rng.uniform(-20, 20, 4000))
               for _ in range(3))
    a, b, c = (v.astype(F32) for v in (a, b, c))
    h = F32(1 + 2.0**-12)
    tiny = np.array([2.0**-70, -2.0**-70, 2.0**-40, 0.0], F32)
    a = np.concatenate([a, np.full(4, h), np.full(4, -h)])
    b = np.concatenate([b, np.full(8, h)])
    c = np.concatenate([c, tiny, -tiny])
    ref = np.array([libm.fmaf(x, y, z) for x, y, z in zip(a, b, c)], F32)
    np.testing.assert_array_equal(rx.fma32(a, b, c), ref)
    J = rng.standard_normal((259, 3)).astype(F32)
    J[5] = (h, h, h)
    J[6] = (2.0**-35, 2.0**-35, 2.0**-35)
    chain = np.zeros(6, F32)
    for row in J:
        chain = rx.fma32(row[rx._IU], row[rx._JU], chain)
    np.testing.assert_array_equal(rx._gram(J)[rx._IU, rx._JU], chain)
    r = rng.standard_normal(259).astype(F32)
    lanes = np.zeros((3, 8), F32)
    for k in range(0, 256, 8):
        lanes = rx.fma32(J[k:k + 8].T, r[None, k:k + 8], lanes)
    tail = np.zeros(3, F32)
    for k in range(256, 259):
        tail = rx.fma32(J[k], r[k], tail)
    h4 = lanes[:, 0:4] + lanes[:, 4:8]
    h2 = h4[:, 0:2] + h4[:, 2:4]
    np.testing.assert_array_equal(rx._gemv(J, r), (h2[:, 0] + h2[:, 1]) + tail)
