"""The scan refinement's plain version: XLA's CPU arithmetic in numpy.

The JAX package's refinement (sparse_gslam_tpu/ops/matching.py
refine_pose, refine_pose_cov, refine_pose_cov_two_stage) is float32
Gauss-Newton on a bicubic grid, and its long runs amplify any change of
rounding. This module computes what XLA's CPU backend compiles those
programs into (jax 0.9 on an x86-64 CPU with AVX-512, where the
package's reference runs were made), bit for bit. The rules, read from
the compiled programs (optimized HLO, LLVM IR and object code, as
`scripts/pair_run.py --hlo-dump DIR` writes them) and held against the
JAX package by tests/test_torch_refine_exact.py:

- cos/sin of the pose angle: glibc's cosf/sinf, called from the host;
- the moved point: fma(c, x, -(s*y)) + p0 and fma(s, x, c*y) + p1, less
  the origin, then a true division by the float32 resolution;
- the Catmull-Rom weights and their forward-mode tangents: the FMAs of
  `weights` / `dweights` below (XLA contracts each fusion on its own);
- the interpolation einsum("na,nab,nb->n"): a column-major gemv (first
  product, then an FMA per tap) and a row gemv that rounds each product
  and adds them in order; the Jacobian's two JVP terms are FMA chains
  from 0, each plus 0, summed;
- 20/sqrt(n) is 20 * rsqrt(n): the x86 rsqrtss approximation (`rsqrtss`:
  a table of 2 x 1024 entries, data/rsqrtss.hex, scaled by the exponent)
  and two Newton steps with FMAs;
- J^T J: one FMA per term from 0, rows in order; J^T r: eight lane
  accumulators over the rows below a multiple of 8, a horizontal sum,
  then the remainder's FMA chain; sums of squares: windows of 32 over
  the array padded by half the missing length in front, again over the
  windows' sums while more than 32 remain (N >= 1024; a third level from
  N = 32768, as the dumped programs at N = 32768 and 65536 show), then in
  order;
- jnp.linalg.solve and eigh: LAPACK sgetrf, strsm (twice) and ssyevd,
  which jaxlib takes from SciPy (OpenBLAS 0.3.30, SkylakeX kernels),
  transcribed here as scalar float32 code with the FMAs and orders of
  those kernels (its Fortran LAPACK is compiled without FMA).

Frozen copy of the port's unbatched program; the vmapped one of the
device pin batches (the accelerator branch) is left out.

csrc/refine_pose_exact.cuh holds the same arithmetic for the CUDA
kernel (ops/refine_cuda.py) and its host build. Everything here runs on
the host in numpy, whatever the device of the caller's tensors.
"""
from __future__ import annotations

import functools
import os

import numpy as np

F32 = np.float32
PMIN = F32(0.1)

# x86 rsqrtss on [1, 4) (bits >> 11, five hex digits each; the
# approximation has 12 significant bits): entry 1024 p + m is that of the
# float with exponent p (0: [1, 2), 1: [2, 4)) and top 10 mantissa bits
# m, the rest 0. On the x86 CPUs the package's reference runs were made on
# (Intel, AVX-512), rsqrtss(x) depends on nothing else of x in [1, 4), and
# rsqrtss(4 x) = rsqrtss(x) / 2 exactly (scripts/make_rsqrtss_table.py
# writes the file; tests/test_torch_refine_exact.py holds the rule to the
# instruction)
_Y0_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                        "rsqrtss.hex")


@functools.lru_cache(maxsize=None)
def rsqrtss_table() -> np.ndarray:
    """(2048,) float32: the x86 rsqrtss approximation on [1, 4), indexed
    by exponent parity and the top 10 mantissa bits (`rsqrtss`)."""
    with open(_Y0_FILE) as fh:
        s = "".join(fh.read().split())
    bits = np.array([int(s[i:i + 5], 16) for i in range(0, len(s), 5)],
                    np.uint32) << np.uint32(11)
    return bits.view(np.float32)


def rsqrtss(x):
    """x86 rsqrtss of float32 x >= 2^-126 (normal; elementwise): the
    table's entry for x scaled into [1, 4) by 4^-k, times 2^-k."""
    u = np.asarray(x, F32).view(np.uint32).astype(np.int64)
    e = (u >> 23 & 0xFF) - 127
    p = e & 1
    scale = np.exp2(-((e - p) // 2)).astype(F32)
    return (rsqrtss_table()[1024 * p + (u >> 13 & 1023)] * scale)[()]


def _double_rounding_risk(s):
    """Where rounding the float64 s to float32 may differ from rounding
    the exact value it approximates: s lies on a float32 midpoint (its
    low 29 significand bits are 1000...), or in float32's subnormal
    range."""
    low = s.view(np.int64) & 0x1FFFFFFF
    return (low == 0x10000000) | ((np.abs(s) < 2.0**-125) & (s != 0))


def fma32(a, b, c):
    """float32 a * b + c rounded once (numpy, elementwise). The float64
    product is exact, and rounding the float64 sum to float32 is correct
    unless the sum was rounded onto a float32 midpoint; there (rarely)
    the sum is rounded to odd instead (TwoSum error, last bit forced to
    1 when inexact), after which rounding to float32 is correct."""
    a = np.asarray(a, F32)
    b = np.asarray(b, F32)
    c = np.asarray(c, F32)
    with np.errstate(over="ignore", invalid="ignore"):
        p = a.astype(np.float64) * b.astype(np.float64)
        c64 = c.astype(np.float64)
        s = np.asarray(p + c64)
        if not _double_rounding_risk(s).any():
            return s.astype(F32)
        bp = s - p
        err = (p - (s - bp)) + (c64 - bp)
        fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
        s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                     s)
        return s.astype(F32)


def occupied_weight(n: int) -> np.float32:
    """20 / sqrt(max(n, 1)) as XLA computes it: rsqrtss, two Newton
    steps."""
    x = F32(max(n, 1))
    y0 = rsqrtss(x)
    e = fma32(y0, x * y0, F32(-1))
    y1 = fma32(F32(-0.5) * y0, e, y0)
    e = fma32(y1, x * y1, F32(-1))
    y2 = fma32(F32(-0.5) * y1, e, y1)
    return F32(y2 * F32(20))


def _weights(t0):
    """Catmull-Rom weights of the fractional offset t of t0 = u - 0.5,
    with floor(t0), t and t^2."""
    fl = np.floor(t0)
    t = t0 - fl
    t2 = t * t
    t3 = t2 * t
    w = np.stack([
        fma32(F32(-0.5), t, fma32(F32(-0.5), t3, t2)),
        fma32(F32(1.5), t3, t2 * F32(-2.5)) + F32(1),
        fma32(F32(0.5), t, fma32(F32(2), t2, t3 * F32(-1.5))),
        fma32(F32(0.5), t3, -(F32(0.5) * t2)),
    ], -1)
    return w, fl, t, t2


def _dweights(dt, t, t2):
    m = t * dt
    d2 = m + m
    d3 = fma32(dt, t2, d2 * t)
    return np.stack([
        fma32(F32(-0.5), dt, fma32(F32(-0.5), d3, d2)),
        fma32(F32(1.5), d3, d2 * F32(-2.5)),
        fma32(F32(0.5), dt, fma32(F32(2), d2, -(F32(1.5) * d3))),
        fma32(F32(0.5), d3, -(F32(0.5) * d2)),
    ], -1)


def _taps(fl, size):
    """The four clamped taps from each floor: float -> int32 as
    cvttss2si (out of range -> INT_MIN)."""
    f = np.where(np.abs(fl) < 2.0**31, fl, -2.0**31).astype(np.int64)
    return np.clip(f[:, None] + np.arange(-1, 3)[None, :], 0, size - 1)


def _offsets(origin, pts, pose, c, s):
    """The points moved by the pose (cos c, sin s of its angle), less
    the origin (metres)."""
    x, y = pts[:, 0], pts[:, 1]
    return (((fma32(c, x, -(s * y)) + pose[0]) - origin[0]),
            ((fma32(s, x, c * y) + pose[1]) - origin[1]))


def evaluate(grid, origin, res, pts, pose, c, s, jac: bool):
    """Interpolated values p (N,) of the PMIN-filled grid at the points
    moved by the pose (cos c, sin s of its angle), and with `jac` their
    derivatives (N, 3) along (x, y, theta)."""
    x, y = pts[:, 0], pts[:, 1]
    du0, dv0 = _offsets(origin, pts, pose, c, s)
    wu, flu, tu, tu2 = _weights(du0 / res + F32(-0.5))
    wv, flv, tv, tv2 = _weights(dv0 / res + F32(-0.5))
    iu, iv = _taps(flu, grid.shape[0]), _taps(flv, grid.shape[0])
    vals = grid[iu[:, :, None], iv[:, None, :]]  # (N, 4 u taps, 4 v taps)
    t = wu[:, 0, None] * vals[:, 0, :]
    for a in range(1, 4):
        t = fma32(vals[:, a, :], wu[:, a, None], t)
    p = wv[:, 0] * t[:, 0]
    for b in range(1, 4):
        p = p + wv[:, b] * t[:, b]
    if not jac:
        return p, None
    # the three tangents (x, y, theta) at once, leading axis k
    n = len(x)
    one = np.full(n, F32(1) / res)
    zero = np.zeros(n, F32)
    du = np.stack([one, zero, (fma32(-s, x, -(c * y)) + F32(0)) / res])
    dv = np.stack([zero, one, (fma32(c, x, -(s * y)) + F32(0)) / res])
    dwu = _dweights(du, tu, tu2)  # (3, N, 4)
    dwv = _dweights(dv, tv, tv2)
    d11 = dwu[..., 0, None] * vals[None, :, 0, :]
    for a in range(1, 4):
        d11 = fma32(dwu[..., a, None], vals[None, :, a, :], d11)
    d10 = np.zeros((3, n), F32)
    d45 = np.zeros((3, n), F32)
    for b in range(4):
        d10 = fma32(dwv[..., b], t[None, :, b], d10)
        d45 = fma32(d11[..., b], wv[None, :, b], d45)
    return p, ((d10 + F32(0)) + (d45 + F32(0))).T


_IU = np.array([0, 0, 0, 1, 1, 2])
_JU = np.array([0, 1, 2, 1, 2, 2])


def _gram(J):
    """J^T J ((K, 3) -> (3, 3)): one FMA per term from 0, rows in order.
    The chain runs on the exact float64 products, each sum rounded to
    float32; if any sum could have been rounded twice
    (_double_rounding_risk), it runs again through fma32."""
    P = J[:, _IU].astype(np.float64) * J[:, _JU].astype(np.float64)
    acc = np.zeros(6)
    sums = np.empty_like(P)
    for k in range(len(P)):
        sums[k] = P[k] + acc
        acc = sums[k].astype(F32).astype(np.float64)
    acc = acc.astype(F32)
    if _double_rounding_risk(sums).any():
        acc = np.zeros(6, F32)
        for row in J:
            acc = fma32(row[_IU], row[_JU], acc)
    H = np.empty((3, 3), F32)
    H[_IU, _JU] = acc
    H[_JU, _IU] = acc
    return H


def _gemv(J, r):
    """J^T r as XLA's row gemv: 8 lanes, horizontal sum, remainder."""
    K = len(r)
    K8 = K // 8 * 8
    # the lanes' chains on the exact float64 products (as in _gram)
    P = (J[:K8].astype(np.float64) * r[:K8, None].astype(np.float64)
         ).reshape(K8 // 8, 8, 3).transpose(0, 2, 1)
    acc = np.zeros((3, 8))
    sums = np.empty_like(P)
    for k in range(len(P)):
        sums[k] = P[k] + acc
        acc = sums[k].astype(F32).astype(np.float64)
    acc = acc.astype(F32)
    if _double_rounding_risk(sums).any():
        acc = np.zeros((3, 8), F32)
        for k in range(0, K8, 8):
            acc = fma32(J[k:k + 8].T, r[None, k:k + 8], acc)
    tail = np.zeros(3, F32)
    for k in range(K8, K):
        tail = fma32(J[k], r[k], tail)
    h = acc[:, 0:4] + acc[:, 4:8]
    h = h[:, 0:2] + h[:, 2:4]
    return (h[:, 0] + h[:, 1]) + tail


def _seq_sum(x):
    acc = F32(0)
    for v in x:
        acc = F32(acc + v)
    return acc


def _window_sums(x):
    """One level of XLA's split of a long sum: windows of 32 over x
    padded by half the missing length in front (the rest behind), each
    summed in order from 0."""
    n = len(x)
    m = -(-n // 32) * 32
    lo = (m - n) // 2
    xp = np.concatenate([np.zeros(lo, F32), x, np.zeros(m - n - lo, F32)])
    parts = np.zeros(m // 32, F32)
    for q in range(32):
        parts = parts + xp[q::32]
    return parts


def _sum_sq(x):
    """sum(x * x) in XLA's order: windows of 32 while more than 32
    values remain (the squares, then the windows' sums), then in order."""
    x = x * x
    while len(x) > 32:
        x = _window_sums(x)
    return _seq_sum(x)


# ---------------------------------------------------------------------------
# 3x3 LAPACK as SciPy's OpenBLAS computes it (float32 scalars, a[i][j])
# ---------------------------------------------------------------------------

SAFMIN = F32(np.finfo(np.float32).tiny)  # slamch('S')
EPS = F32(2.0**-24)  # slamch('E')
_ONE, _ZERO = F32(1), F32(0)


def _f(x):
    return F32(x)


def _fma(a, b, c):
    return F32(fma32(a, b, c))


def _sign(a, b):  # Fortran SIGN(a, b)
    return -abs(a) if np.signbit(b) else abs(a)


def sgetrf3(a):
    """OpenBLAS getf2 on a 3x3 list of lists (in place); returns the
    0-based pivot rows."""
    piv = [0, 0, 0]
    for j in range(3):
        b = [a[i][j] for i in range(3)]
        for i in range(j):
            p = piv[i]
            if p != i:
                b[i], b[p] = b[p], b[i]
        for i in range(1, j):
            d = _f(a[i][0] * b[0])
            for k in range(1, i):
                d = _fma(a[i][k], b[k], d)
            b[i] = _f(b[i] - d)
        for i in range(j, 3 if j else 0):
            t = _f(a[i][0] * b[0])
            for k in range(1, j):
                t = _fma(a[i][k], b[k], t)
            b[i] = _f(b[i] - t)
        jp = j
        for i in range(j + 1, 3):
            if abs(b[i]) > abs(b[jp]):
                jp = i
        piv[j] = jp
        for i in range(3):
            a[i][j] = b[i]
        if a[jp][j] != 0:
            if jp != j:
                for k in range(j + 1):
                    a[j][k], a[jp][k] = a[jp][k], a[j][k]
            r = _f(_ONE / a[j][j])
            for i in range(j + 1, 3):
                a[i][j] = _f(a[i][j] * r)
    return piv


def strsm_lower_unit(a, c):
    c[1] = _fma(-c[0], a[1][0], c[1])
    c[2] = _f(c[2] - _fma(a[2][1], c[1], _f(a[2][0] * c[0])))


@np.errstate(divide="ignore", invalid="ignore")  # a singular factor: inf
def strsm_upper(a, c):
    inv = [_f(_ONE / a[i][i]) for i in range(3)]
    x2 = _f(c[2] * inv[2])
    c0 = _f(c[0] - _f(a[0][2] * x2))
    x1 = _f(_f(c[1] - _f(a[1][2] * x2)) * inv[1])
    c0 = _fma(-x1, a[0][1], c0)
    c[0], c[1], c[2] = _f(c0 * inv[0]), x1, x2


def gn_solve(H, g, pose):
    """pose + jnp.linalg.solve(H + 1e-9 I, -g)."""
    a = [[_f(H[i][j] + (F32(1e-9) if i == j else _ZERO)) for j in range(3)]
         for i in range(3)]
    piv = sgetrf3(a)
    perm = [0, 1, 2]
    for i in range(3):
        perm[i], perm[piv[i]] = perm[piv[i]], perm[i]
    c = [_f(-g[perm[i]]) for i in range(3)]
    strsm_lower_unit(a, c)
    strsm_upper(a, c)
    return np.array([_f(pose[i] + c[i]) for i in range(3)], F32)


def _sqrt(x):
    return F32(np.sqrt(F32(x)))


def slapy2(x, y):
    xa, ya = abs(x), abs(y)
    w, z = max(xa, ya), min(xa, ya)
    if z == 0 or w > np.finfo(np.float32).max:
        return w
    q = _f(z / w)
    return _f(w * _sqrt(_f(_ONE + _f(q * q))))


def slartg(f, g):
    safmax = _f(_ONE / SAFMIN)
    rtmin, rtmax = _sqrt(SAFMIN), _sqrt(_f(safmax / F32(2)))
    f1, g1 = abs(f), abs(g)
    if g == 0:
        return _ONE, _ZERO, f
    if f == 0:
        return _ZERO, _sign(_ONE, g), g1
    if rtmin < f1 < rtmax and rtmin < g1 < rtmax:
        d = _sqrt(_f(_f(f * f) + _f(g * g)))
        r = _sign(d, f)
        return _f(f1 / d), _f(g / r), r
    u = min(safmax, max(SAFMIN, f1, g1))
    fs, gs = _f(f / u), _f(g / u)
    d = _sqrt(_f(_f(fs * fs) + _f(gs * gs)))
    r = _sign(d, f)
    return _f(abs(fs) / d), _f(gs / r), _f(r * u)


def slaev2(a, b, c):
    sm, df = _f(a + c), _f(a - c)
    adf, tb = abs(df), _f(b + b)
    ab = abs(tb)
    acmx, acmn = (a, c) if abs(a) > abs(c) else (c, a)
    if adf > ab:
        q = _f(ab / adf)
        rt = _f(adf * _sqrt(_f(_ONE + _f(q * q))))
    elif adf < ab:
        q = _f(adf / ab)
        rt = _f(ab * _sqrt(_f(_ONE + _f(q * q))))
    else:
        rt = _f(ab * _sqrt(F32(2)))
    if sm < 0:
        rt1, sgn1 = _f(F32(0.5) * _f(sm - rt)), -1
        rt2 = _f(_f(_f(acmx / rt1) * acmn) - _f(_f(b / rt1) * b))
    elif sm > 0:
        rt1, sgn1 = _f(F32(0.5) * _f(sm + rt)), 1
        rt2 = _f(_f(_f(acmx / rt1) * acmn) - _f(_f(b / rt1) * b))
    else:
        rt1, rt2, sgn1 = _f(F32(0.5) * rt), _f(F32(-0.5) * rt), 1
    if df >= 0:
        cs, sgn2 = _f(df + rt), 1
    else:
        cs, sgn2 = _f(df - rt), -1
    if abs(cs) > ab:
        ct = _f(-tb / cs)
        sn1 = _f(_ONE / _sqrt(_f(_ONE + _f(ct * ct))))
        cs1 = _f(ct * sn1)
    elif ab == 0:
        cs1, sn1 = _ONE, _ZERO
    else:
        tn = _f(-cs / tb)
        cs1 = _f(_ONE / _sqrt(_f(_ONE + _f(tn * tn))))
        sn1 = _f(tn * cs1)
    if sgn1 == sgn2:
        cs1, sn1 = _f(-sn1), cs1
    return rt1, rt2, cs1, sn1


def _slasr(z, c, s, col0, mm, forward):
    js = range(mm - 1) if forward else range(mm - 2, -1, -1)
    for j in js:
        ct, st = c[j], s[j]
        if ct != _ONE or st != _ZERO:
            for i in range(3):
                temp = z[i][col0 + j + 1]
                z[i][col0 + j + 1] = _f(_f(ct * temp) - _f(st * z[i][col0 + j]))
                z[i][col0 + j] = _f(_f(st * temp) + _f(ct * z[i][col0 + j]))


def slascl(cfrom, cto, x):
    """LAPACK slascl('G') on the list x, in place."""
    smlnum, bignum = SAFMIN, _f(_ONE / SAFMIN)
    cfromc, ctoc = cfrom, cto
    done = False
    while not done:
        cfrom1 = _f(cfromc * smlnum)
        if cfrom1 == cfromc:
            mul, done = _f(ctoc / cfromc), True
        else:
            cto1 = _f(ctoc / bignum)
            if cto1 == ctoc:
                mul, done, cfromc = ctoc, True, _ONE
            elif abs(cfrom1) > abs(ctoc) and ctoc != 0:
                mul, cfromc = smlnum, cfrom1
            elif abs(cto1) > abs(cfromc):
                mul, ctoc = bignum, cto1
            else:
                mul, done = _f(ctoc / cfromc), True
                if mul == _ONE:
                    return
        for i in range(len(x)):
            x[i] = _f(x[i] * mul)


def _scaled(d, e, l, lend, cfrom, cto):
    dd, ee = d[l:lend + 1], e[l:lend]
    slascl(cfrom, cto, dd)
    slascl(cfrom, cto, ee)
    d[l:lend + 1], e[l:lend] = dd, ee


def ssteqr3(d, e, z):
    """LAPACK ssteqr('I') on the tridiagonal (d, e) (lists, in place), z
    the identity on entry; returns info."""
    n, nmaxit = 3, 90
    eps2 = _f(EPS * EPS)
    ssfmax = _f(_sqrt(_f(_ONE / SAFMIN)) / F32(3))
    ssfmin = _f(_sqrt(SAFMIN) / eps2)
    work = [_ZERO] * 4  # c[0..1], s[0..1]
    jtot, l1 = 0, 0
    while l1 <= n - 1:
        if l1 > 0:
            e[l1 - 1] = _ZERO
        m = n - 1
        for q in range(l1, n - 1):
            tst = abs(e[q])
            if tst == 0:
                m = q
                break
            if tst <= _f(_f(_sqrt(abs(d[q])) * _sqrt(abs(d[q + 1]))) * EPS):
                e[q] = _ZERO
                m = q
                break
        l = lsv = l1
        lend = lendsv = m
        l1 = m + 1
        if lend == l:
            continue
        anorm = max([abs(v) for v in d[l:lend + 1]] +
                    [abs(v) for v in e[l:lend]])
        if anorm == 0:
            continue
        iscale = 0
        if anorm > ssfmax:
            iscale = 1
            _scaled(d, e, l, lend, anorm, ssfmax)
        elif anorm < ssfmin:
            iscale = 2
            _scaled(d, e, l, lend, anorm, ssfmin)
        if abs(d[lend]) < abs(d[l]):
            lend, l = lsv, lendsv
        if lend > l:  # QL iteration
            while True:
                m = lend
                for q in range(l, lend):
                    tst = _f(abs(e[q]) * abs(e[q]))
                    if tst <= _f(_f(_f(eps2 * abs(d[q])) * abs(d[q + 1]))
                                 + SAFMIN):
                        m = q
                        break
                if m < lend:
                    e[m] = _ZERO
                p = d[l]
                if m == l:
                    d[l] = p
                    l += 1
                    if l <= lend:
                        continue
                    break
                if m == l + 1:
                    rt1, rt2, c, s = slaev2(d[l], e[l], d[l + 1])
                    _slasr(z, [c], [s], l, 2, False)
                    d[l], d[l + 1], e[l] = rt1, rt2, _ZERO
                    l += 2
                    if l <= lend:
                        continue
                    break
                if jtot == nmaxit:
                    break
                jtot += 1
                g = _f(_f(d[l + 1] - p) / _f(F32(2) * e[l]))
                r = slapy2(g, _ONE)
                g = _f(_f(d[m] - p) + _f(e[l] / _f(g + _sign(r, g))))
                s, c, p = _ONE, _ONE, _ZERO
                for i in range(m - 1, l - 1, -1):
                    f, b = _f(s * e[i]), _f(c * e[i])
                    c, s, r = slartg(g, f)
                    if i != m - 1:
                        e[i + 1] = r
                    g = _f(d[i + 1] - p)
                    r = _f(_f(_f(d[i] - g) * s) + _f(_f(F32(2) * c) * b))
                    p = _f(s * r)
                    d[i + 1] = _f(g + p)
                    g = _f(_f(c * r) - b)
                    work[i], work[2 + i] = c, _f(-s)
                _slasr(z, work[l:], work[2 + l:], l, m - l + 1, False)
                d[l] = _f(d[l] - p)
                e[l] = g
        else:  # QR iteration
            while True:
                m = lend
                for q in range(l, lend, -1):
                    tst = _f(abs(e[q - 1]) * abs(e[q - 1]))
                    if tst <= _f(_f(_f(eps2 * abs(d[q])) * abs(d[q - 1]))
                                 + SAFMIN):
                        m = q
                        break
                if m > lend:
                    e[m - 1] = _ZERO
                p = d[l]
                if m == l:
                    d[l] = p
                    l -= 1
                    if l >= lend:
                        continue
                    break
                if m == l - 1:
                    rt1, rt2, c, s = slaev2(d[l - 1], e[l - 1], d[l])
                    _slasr(z, [c], [s], l - 1, 2, True)
                    d[l - 1], d[l], e[l - 1] = rt1, rt2, _ZERO
                    l -= 2
                    if l >= lend:
                        continue
                    break
                if jtot == nmaxit:
                    break
                jtot += 1
                g = _f(_f(d[l - 1] - p) / _f(F32(2) * e[l - 1]))
                r = slapy2(g, _ONE)
                g = _f(_f(d[m] - p) + _f(e[l - 1] / _f(g + _sign(r, g))))
                s, c, p = _ONE, _ONE, _ZERO
                for i in range(m, l):
                    f, b = _f(s * e[i]), _f(c * e[i])
                    c, s, r = slartg(g, f)
                    if i != m:
                        e[i - 1] = r
                    g = _f(d[i] - p)
                    r = _f(_f(_f(d[i + 1] - g) * s) + _f(_f(F32(2) * c) * b))
                    p = _f(s * r)
                    d[i] = _f(g + p)
                    g = _f(_f(c * r) - b)
                    work[i], work[2 + i] = c, s
                _slasr(z, work[m:], work[2 + m:], m, l - m + 1, True)
                d[l] = _f(d[l] - p)
                e[l - 1] = g
        if iscale == 1:
            _scaled(d, e, lsv, lendsv, ssfmax, anorm)
        elif iscale == 2:
            _scaled(d, e, lsv, lendsv, ssfmin, anorm)
        if jtot >= nmaxit:
            return sum(v != 0 for v in e)
    for ii in range(1, n):  # selection sort, ascending
        i = k = ii - 1
        p = d[i]
        for j in range(ii, n):
            if d[j] < p:
                k, p = j, d[j]
        if k != i:
            d[k], d[i] = d[i], p
            for q in range(3):
                z[q][i], z[q][k] = z[q][k], z[q][i]
    return 0


def ssyevd3(h):
    """LAPACK ssyevd('V', 'L') of a symmetric 3x3: (w ascending (3,),
    z (3, 3) with eigenvector j in column j, info)."""
    a = [[F32(h[i][j]) for j in range(3)] for i in range(3)]
    anrm = max(abs(a[i][j]) for j in range(3) for i in range(j, 3))
    smlnum = _f(SAFMIN / (F32(2) * EPS))  # slamch('P') = 2 * slamch('E')
    rmin, rmax = _sqrt(smlnum), _sqrt(_f(_ONE / smlnum))
    sigma = None
    if 0 < anrm < rmin:
        sigma = _f(rmin / anrm)
    elif anrm > rmax:
        sigma = _f(rmax / anrm)
    if sigma is not None:
        low = [a[0][0], a[1][0], a[2][0], a[1][1], a[2][1], a[2][2]]
        slascl(_ONE, sigma, low)
        a[0][0], a[1][0], a[2][0], a[1][1], a[2][1], a[2][2] = low
    # ssytd2 (lower), column 0: the reflector of (a[1][0], a[2][0])
    alpha, x = a[1][0], a[2][0]
    tau, e0 = _ZERO, alpha
    if x != 0:
        beta = -_sign(slapy2(alpha, abs(x)), alpha)
        safmn = _f(SAFMIN / EPS)
        knt = 0
        if abs(beta) < safmn:
            rsafmn = _f(_ONE / safmn)
            while True:
                knt += 1
                x, beta, alpha = (_f(x * rsafmn), _f(beta * rsafmn),
                                  _f(alpha * rsafmn))
                if not (abs(beta) < safmn and knt < 20):
                    break
            beta = -_sign(slapy2(alpha, abs(x)), alpha)
        tau = _f(_f(beta - alpha) / beta)
        x = _f(x * _f(_ONE / _f(alpha - beta)))
        for _ in range(knt):
            beta = _f(beta * safmn)
        e0 = beta
        a[2][0] = x
    if tau != 0:
        v = (_ONE, x)
        A00, A10, A11 = a[1][1], a[2][1], a[2][2]
        # ssymv (lower): y = tau * A22 v
        t1 = _f(tau * v[0])
        y0 = _fma(t1, A00, _ZERO)
        y1 = _fma(t1, A10, _ZERO)
        y0 = _fma(tau, _fma(A10, v[1], _ZERO), y0)
        y1 = _fma(_f(tau * v[1]), A11, y1)
        y1 = _fma(tau, _ZERO, y1)
        # y += -(tau / 2) (y . v) v
        al = _f(-_f(_f(F32(0.5) * tau) * _f(_f(y0 * v[0]) + _f(y1 * v[1]))))
        y = (_fma(al, v[0], y0), _fma(al, v[1], y1))
        # ssyr2 (lower): A22 -= v y^T + y v^T, the v_j term first
        B = [[A00, _ZERO], [A10, A11]]
        for j in range(2):
            for i in range(j, 2):
                B[i][j] = _fma(-v[j], y[i], B[i][j])
                B[i][j] = _fma(-y[j], v[i], B[i][j])
        a[1][1], a[2][1], a[2][2] = B[0][0], B[1][0], B[1][1]
    d = [a[0][0], a[1][1], a[2][2]]
    e = [e0, a[2][1]]
    z = [[_ONE if i == j else _ZERO for j in range(3)] for i in range(3)]
    info = ssteqr3(d, e, z)
    if tau != 0:  # sormtr -> sorm2r -> slarf on rows 1..2
        v = (_ONE, a[2][0])
        lastv = 2 if v[1] != 0 else 1
        lastc = max([j + 1 for j in range(3)
                     if any(z[1 + i][j] != 0 for i in range(lastv))],
                    default=0)
        for j in range(lastc):
            wj = (_f(_f(z[1][j] * v[0]) + _f(z[2][j] * v[1])) if lastv == 2
                  else _f(z[1][j] * v[0]))
            aw = _f(-tau * wj)
            for i in range(lastv):
                z[1 + i][j] = _fma(aw, v[i], z[1 + i][j])
    w = np.array(d, F32)
    if sigma is not None:
        w = w * _f(_ONE / sigma)
    return w, np.array(z, F32), info


def censi_cov(H, sigma2):
    """sigma2 * V diag(sel(w)) V^T from the symmetrized H (ssyevd)."""
    hs = (H + H.T) * F32(0.5)
    w, V, info = ssyevd3(hs)
    inv = F32(1) / np.maximum(w, F32(1e-6))
    sel = np.where(w > F32(1e-6), inv, F32(1e6))
    M = V * (sigma2 * sel)[None, :]
    cov = np.zeros((3, 3), F32)
    for k in range(3):
        cov = fma32(M[:, k, None], V[None, :, k], cov)
    return cov if info == 0 else np.full((3, 3), np.nan, F32)


# ---------------------------------------------------------------------------
# the refinement
# ---------------------------------------------------------------------------


def _residuals(p, pose, anchor, w_occ, wv):
    n = len(p)
    r = np.empty(n + 3, F32)
    r[:n] = ((F32(1) - p) * w_occ) * wv
    r[n:n + 2] = (pose[:2] - anchor[:2]) * F32(10)
    r[n + 2] = pose[2] - anchor[2]
    return r


def refine(grids, points, valid, init, iterations: int = 10,
           want_cov: bool = True, cos_sin=None):
    """One refinement, one stage per entry of `grids` ((grid, origin,
    resolution) each, float32 numpy; the last stage starts from the
    previous one's pose). points (N, 2) float32, valid (N,) bool, init
    (3,) float32. Returns (pose (3,), cov (3, 3), probs (N,)): the last
    stage's pose and Censi covariance, the first stage's per-point
    probabilities (cov and probs None without want_cov). `cos_sin(theta)`
    gives glibc's float32 cos and sin."""
    pts = np.asarray(points, F32)
    valid = np.asarray(valid, bool)
    n_valid = int(valid.sum())
    w_occ = occupied_weight(n_valid)
    wv = valid.astype(F32)
    n = len(pts)
    anchor_rows = np.zeros((3, 3), F32)
    anchor_rows[[0, 1, 2], [0, 1, 2]] = (10, 10, 1)
    pose = np.asarray(init, F32).copy()
    cov = probs = None
    for stage, (grid, origin, res) in enumerate(grids):
        sg = np.where(grid > 0, grid, PMIN).astype(F32)
        origin = np.asarray(origin, F32)
        res = F32(res)
        anchor = pose.copy()
        for _ in range(iterations):
            c, s = cos_sin(pose[2])
            p, Jo = evaluate(sg, origin, res, pts, pose, c, s, True)
            r = _residuals(p, pose, anchor, w_occ, wv)
            J = np.concatenate([(-Jo * w_occ) * wv[:, None], anchor_rows])
            trial = gn_solve(_gram(J), _gemv(J, r), pose)
            c, s = cos_sin(trial[2])
            p2, _ = evaluate(sg, origin, res, pts, trial, c, s, False)
            if (_sum_sq(_residuals(p2, trial, anchor, w_occ, wv))
                    <= _sum_sq(r)):
                pose = trial
        if not want_cov:
            continue
        last = stage == len(grids) - 1
        c, s = cos_sin(pose[2])
        p, Jo = evaluate(sg, origin, res, pts, pose, c, s, last)
        if stage == 0:
            probs = p
        if last:
            J = (-Jo) * wv[:, None]
            ssum = _sum_sq(np.where(valid, F32(1) - p, F32(0)))
            sigma2 = ssum / np.maximum(F32(max(n_valid, 1)) + F32(-3), F32(1))
            cov = censi_cov(_gram(J), sigma2)
    return pose, cov, probs
