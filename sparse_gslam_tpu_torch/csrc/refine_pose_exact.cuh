// The float32 arithmetic of the scan refinement (ops/matching.py
// refine_pose / refine_pose_cov / refine_pose_cov_two_stage), operation
// for operation as XLA's CPU backend compiles the JAX package's
// sparse_gslam_tpu/ops/matching.py:refine_pose_cov on an x86-64 CPU
// with AVX-512 (jax 0.9): which products and sums it fuses into FMAs,
// the order of every reduction, glibc's sinf/cosf, and the 3x3 LAPACK
// calls as SciPy's OpenBLAS 0.3.30 (SkylakeX kernels) computes them.
// ops/refine_exact.py is the same arithmetic in numpy, and the module
// docstring there says where each rule was read.
//
// Shared by the CUDA kernel (refine_pose.cu, built with --fmad=false so
// that nvcc fuses nothing; every FMA here is an explicit fmaf) and its
// host build (refine_pose_host.cpp, g++ -ffp-contract=off). Division
// and sqrt are the correctly rounded IEEE operations on both.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define RPX_HD __host__ __device__ __forceinline__
#define RPX_UNROLL _Pragma("unroll")
#else
#define RPX_HD inline
#define RPX_UNROLL
#endif

namespace rpx {

// the largest padded point count the header's int32 offsets hold: one
// problem's rows and window sums, 16 (N + 4) + 4 ceil((N + 3) / 32)
// bytes, stay below 2^31 (ops/refine_cuda.N_LIMIT)
constexpr int N_LIMIT = 1 << 26;
// padded points a refinement takes: the sizes the callers pad to,
// 256 * 2^k (the JAX backend's _bucket(n, 256) has no cap)
RPX_HD bool takes_points(int n) {
  return n >= 256 && n <= N_LIMIT && (n & (n - 1)) == 0;
}
// the rows of the GN system live in the block's shared memory up to this
// N (131 KB at 8192; a block has at most 227 KB), above it in a global
// scratch buffer that a ring of shared-memory slots stages
// (reduce_rows_staged)
constexpr int SMEM_ROWS_MAX = 8192;
RPX_HD bool staged_rows(int n) { return n > SMEM_ROWS_MAX; }
// threads of the block, whatever N is (scripts/refine_ablation.py timed
// 128, 256 and 512; PERF.md); the reductions' roles need four warps
// (reduce_rows)
constexpr int THREADS = 512;
static_assert(THREADS >= 128 && THREADS % 32 == 0, "reduce_rows' roles");
// the rows of the GN system in shared memory: J's three columns and r,
// K = N + 3 floats each, every column from a multiple of four floats
// (16 bytes: the reductions load four at a time)
RPX_HD int column_stride(int n) { return (n + 3 + 3) / 4 * 4; }
RPX_HD int rows_bytes(int n) { return 4 * column_stride(n) * (int)sizeof(float); }
constexpr float PMIN = 0.1f;    // ops/grid.py PMIN: unknown cells

RPX_HD float fma32(float a, float b, float c) { return fmaf(a, b, c); }

RPX_HD uint32_t f2u(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

// ---------------------------------------------------------------------
// glibc's sinf / cosf (sysdeps/ieee754/flt-32 s_sinf.c, s_cosf.c with
// sincosf.h, as built for x86-64 with FMA): double-precision range
// reduction and polynomials, with the products-and-sums that GCC fuses
// there written as fma.
// ---------------------------------------------------------------------

RPX_HD uint32_t abstop12(float x) { return (f2u(x) >> 20) & 0x7ff; }

RPX_HD float sincos_poly(double x, double x2, int n, bool negate_cos) {
  const double s1 = -0x1.555545995a603p-3, s2 = 0x1.1107605230bc4p-7,
               s3 = -0x1.994eb3774cf24p-13;
  double c0 = 0x1p0, c1 = -0x1.ffffffd0c621cp-2, c2 = 0x1.55553e1068f19p-5,
         c3 = -0x1.6c087e89a359dp-10, c4 = 0x1.99343027bf8c3p-16;
  if (negate_cos) {
    c0 = -c0;
    c1 = -c1;
    c2 = -c2;
    c3 = -c3;
    c4 = -c4;
  }
  if ((n & 1) == 0) {
    const double x3 = x * x2;
    const double ss1 = fma(x2, s3, s2);
    const double x7 = x3 * x2;
    const double s = fma(x3, s1, x);
    return (float)fma(x7, ss1, s);
  }
  const double x4 = x2 * x2;
  const double cc2 = fma(x2, c4, c3);
  const double cc1 = fma(x2, c1, c0);
  const double x6 = x4 * x2;
  const double c = fma(x4, c2, cc1);
  return (float)fma(x6, cc2, c);
}

RPX_HD double reduce_fast(double x, int* np) {
  const double r = x * 0x1.45F306DC9C883p+23;
  const int n = ((int32_t)r + 0x800000) >> 24;
  *np = n;
  return fma(-(double)n, 0x1.921FB54442D18p0, x);
}

RPX_HD uint32_t inv_pio4(int i) {
  switch (i) {
    case 0: return 0xa2; case 1: return 0xa2f9; case 2: return 0xa2f983;
    case 3: return 0xa2f9836e; case 4: return 0xf9836e4e;
    case 5: return 0x836e4e44; case 6: return 0x6e4e4415;
    case 7: return 0x4e441529; case 8: return 0x441529fc;
    case 9: return 0x1529fc27; case 10: return 0x29fc2757;
    case 11: return 0xfc2757d1; case 12: return 0x2757d1f5;
    case 13: return 0x57d1f534; case 14: return 0xd1f534dd;
    case 15: return 0xf534ddc0; case 16: return 0x34ddc0db;
    case 17: return 0xddc0db62; case 18: return 0xc0db6295;
    case 19: return 0xdb629599; case 20: return 0x6295993c;
    case 21: return 0x95993c43; case 22: return 0x993c4390;
    default: return 0x3c439041;
  }
}

RPX_HD double reduce_large(uint32_t xi, int* np) {
  const int base = (xi >> 26) & 15;
  const int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = (uint64_t)(uint32_t)(xi * inv_pio4(base));
  const uint64_t res1 = (uint64_t)xi * inv_pio4(base + 4);
  const uint64_t res2 = (uint64_t)xi * inv_pio4(base + 8);
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = (int)n;
  return (double)(int64_t)res0 * 0x1.921FB54442D18p-62;
}

RPX_HD double quadrant_sign(int q) { return (q & 3) == 1 || (q & 3) == 2 ? -1.0 : 1.0; }

// which = 0: sinf(y), 1: cosf(y)
RPX_HD float glibc_sincosf(float y, int which) {
  double x = y;
  int n;
  const uint32_t t = abstop12(y);
  if (t < 0x3f4) {  // |y| < pi/4 (by the top 12 bits)
    if (t < 0x398) return which ? 1.0f : y;
    return sincos_poly(x, x * x, which, false);
  }
  if (t < 0x42f) {  // |y| < 120
    x = reduce_fast(x, &n);
    const double s = quadrant_sign(n);
    return sincos_poly(x * s, x * x, n ^ which, (n & 2) != 0);
  }
  if (t < 0x7f8) {
    const uint32_t xi = f2u(y);
    const int sign = xi >> 31;
    x = reduce_large(xi, &n);
    const double s = quadrant_sign(n + sign);
    return sincos_poly(x * s, x * x, n ^ which, ((n + sign) & 2) != 0);
  }
  return (y - y) / (y - y);
}

// ---------------------------------------------------------------------
// One query point: bicubic interpolation of the grid and, on request,
// its derivative along (x, y, theta) of the pose.
// ---------------------------------------------------------------------

struct GridRef {
  const float* g;  // (size, size) probability grid, 0 = unknown
  int size;
  float o0, o1;  // origin
  float res;     // resolution, rounded to float32
  // the device pin batches' program (jax.vmap with the resolution a
  // static constant): the division by res is a multiply by its float32
  // reciprocal inv, and the tangents carry inv (eval_point)
  int vmapped = 0;
  float inv = 0.0f;
};

// where(grid > 0, grid, PMIN)
RPX_HD float grid_at(const GridRef& G, int i, int j) {
  const float v = G.g[i * G.size + j];
  return v > 0.0f ? v : PMIN;
}

RPX_HD int clamp_tap(int v, int size) {
  return v < 0 ? 0 : (v > size - 1 ? size - 1 : v);
}

// The first of a point's four taps along one axis, floor(t0) - 1 with
// t0's floor fl taken to int32 as x86's cvttss2si does (out of range
// and NaN give INT_MIN), then held to [-3, size - 1]: the four clamped
// taps are those of the unheld value, in int32 arithmetic
RPX_HD int first_tap(float fl, int size) {
  const int64_t v = (fabsf(fl) < 2147483648.0f ? (int64_t)fl
                                                 : -2147483648LL) - 1;
  return (int)(v < -3 ? -3 : (v > size - 1 ? size - 1 : v));
}

// first_tap as the vmapped program converts: clamped to int32, NaN to 0
RPX_HD int first_tap_saturating(float fl, int size) {
  const int64_t f = fl != fl ? 0
                    : (fl <= -2147483648.0f ? -2147483648LL
                       : (fl >= 2147483648.0f ? 2147483647LL : (int64_t)fl));
  const int64_t v = f - 1;
  return (int)(v < -3 ? -3 : (v > size - 1 ? size - 1 : v));
}

// Catmull-Rom weights of the fractional offset t of t0 = u - 0.5, and
// t, t^2 and floor(t0) that the tangent and the taps use
RPX_HD void weights(float t0, float w[4], float* fl, float* t_out,
                    float* t2_out) {
  *fl = floorf(t0);
  const float t = t0 - *fl;
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = fma32(-0.5f, t, fma32(-0.5f, t3, t2));
  w[1] = fma32(1.5f, t3, t2 * -2.5f) + 1.0f;
  w[2] = fma32(0.5f, t, fma32(2.0f, t2, t3 * -1.5f));
  w[3] = fma32(0.5f, t3, -(0.5f * t2));
  *t_out = t;
  *t2_out = t2;
}

// forward-mode tangent of the weights for a tangent dt of t
RPX_HD void dweights(float dt, float t, float t2, float dw[4]) {
  const float m = t * dt;
  const float d2 = m + m;
  const float d3 = fma32(dt, t2, d2 * t);
  dw[0] = fma32(-0.5f, dt, fma32(-0.5f, d3, d2));
  dw[1] = fma32(1.5f, d3, d2 * -2.5f);
  dw[2] = fma32(0.5f, dt, fma32(2.0f, d2, -(1.5f * d3)));
  dw[3] = fma32(0.5f, d3, -(0.5f * d2));
}

// The vmapped program's tangent of the weights: num the tangent's
// numerator (the moved point's derivative in metres), dt = num * inv
// reassociated onto t (d2 = 2 num (t inv)) and onto the constants
// (0.5 dt = num (0.5 inv))
RPX_HD void dweights_vmapped(float num, float t, float t2, float inv,
                             float dw[4]) {
  const float ti = t * inv, t2i = t2 * inv, half = 0.5f * inv;
  const float m = num * ti;
  const float d2 = m + m;
  const float d3 = fma32(num, t2i, t * d2);
  dw[0] = fma32(-num, half, fma32(-d3, 0.5f, d2));
  dw[1] = fma32(d3, 1.5f, -(d2 * 2.5f));
  dw[2] = fma32(num, half, fma32(d2, 2.0f, -(d3 * 1.5f)));
  dw[3] = fma32(d3, 0.5f, -(d2 * 0.5f));
}

// Interpolated grid value at the query point (px, py) moved by the pose
// (p0, p1, angle with cos c, sin s); with J != nullptr also its
// derivative (d/dx, d/dy, d/dtheta), before the residual's sign and
// weights.
RPX_HD float eval_point(const GridRef& G, float px, float py, float p0,
                        float p1, float c, float s, float* J) {
  const float du0 = (fma32(c, px, -(s * py)) + p0) - G.o0;
  const float dv0 = (fma32(s, px, c * py) + p1) - G.o1;
  float wu[4], wv[4], flu, flv, tu, tu2, tv, tv2;
  if (G.vmapped) {
    weights(fma32(du0, G.inv, -0.5f), wu, &flu, &tu, &tu2);
    weights(fma32(dv0, G.inv, -0.5f), wv, &flv, &tv, &tv2);
  } else {
    weights(du0 / G.res + -0.5f, wu, &flu, &tu, &tu2);
    weights(dv0 / G.res + -0.5f, wv, &flv, &tv, &tv2);
  }
  const int bu = G.vmapped ? first_tap_saturating(flu, G.size)
                           : first_tap(flu, G.size);
  const int bv = G.vmapped ? first_tap_saturating(flv, G.size)
                           : first_tap(flv, G.size);
  float vals[4][4];
  for (int a = 0; a < 4; ++a) {
    const int iu = clamp_tap(bu + a, G.size);
    for (int b = 0; b < 4; ++b)
      vals[a][b] = grid_at(G, iu, clamp_tap(bv + b, G.size));
  }
  float t[4];
  for (int b = 0; b < 4; ++b) {
    t[b] = wu[0] * vals[0][b];
    for (int a = 1; a < 4; ++a) t[b] = fma32(vals[a][b], wu[a], t[b]);
  }
  float p = wv[0] * t[0];
  for (int b = 1; b < 4; ++b) p = p + wv[b] * t[b];
  if (J != nullptr) {
    const float one = 1.0f / G.res;
    const float du[3] = {one, 0.0f, (fma32(-s, px, -(c * py)) + 0.0f) / G.res};
    const float dv[3] = {0.0f, one, (fma32(c, px, -(s * py)) + 0.0f) / G.res};
    // the vmapped program's numerators: the theta tangent as one FMA
    // of two products (the one its object code fuses)
    const float nu[3] = {1.0f, 0.0f, fma32(px, -s, -(py * c)) + 0.0f};
    const float nv[3] = {0.0f, 1.0f, fma32(py, -s, px * c) + 0.0f};
    RPX_UNROLL  // (keeps du, dv and J in registers on the card)
    for (int k = 0; k < 3; ++k) {
      float dwu[4], dwv[4], d11[4];
      if (G.vmapped) {
        dweights_vmapped(nu[k], tu, tu2, G.inv, dwu);
        dweights_vmapped(nv[k], tv, tv2, G.inv, dwv);
      } else {
        dweights(du[k], tu, tu2, dwu);
        dweights(dv[k], tv, tv2, dwv);
      }
      for (int b = 0; b < 4; ++b) {
        d11[b] = dwu[0] * vals[0][b];
        for (int a = 1; a < 4; ++a) d11[b] = fma32(dwu[a], vals[a][b], d11[b]);
      }
      float d10 = 0.0f, d45 = 0.0f;
      for (int b = 0; b < 4; ++b) {
        d10 = fma32(dwv[b], t[b], d10);
        d45 = fma32(d11[b], wv[b], d45);
      }
      J[k] = (d10 + 0.0f) + (d45 + 0.0f);
    }
  }
  return p;
}

// ---------------------------------------------------------------------
// Reductions, in XLA's CPU order.
// ---------------------------------------------------------------------

// four floats from a 16-byte aligned address: one 128-bit shared-memory
// load on the card
struct F4 {
  float v[4];
};
RPX_HD F4 load4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
#else
  return {{p[0], p[1], p[2], p[3]}};
#endif
}

// 16 terms of two 16-byte aligned arrays, as four 128-bit loads each on
// the card
RPX_HD void load16(const float* a, const float* b, F4 x[4], F4 y[4]) {
  RPX_UNROLL
  for (int q = 0; q < 4; ++q) {
    x[q] = load4(a + 4 * q);
    y[q] = load4(b + 4 * q);
  }
}

RPX_HD void fma16(const F4 x[4], const F4 y[4], float* acc) {
  RPX_UNROLL
  for (int q = 0; q < 16; ++q)
    *acc = fma32(x[q / 4].v[q % 4], y[q / 4].v[q % 4], *acc);
}

// sum_k a[k] b[k] over k < count (a, b 16-byte aligned): one FMA per
// term from 0, k in order (the elemental dot loop). Its terms load in
// blocks of 16 into two sets of registers, each block while the one
// before it runs its FMAs, so that on the card neither the loads'
// latency nor their instruction count but the chain's FMA latency (4
// cycles a term; 5.5 measured on an H100) sets its pace.
// (`acc` carries a chain on from an earlier part of the arrays)
RPX_HD float dot_chain(const float* a, const float* b, int count,
                       float acc = 0.0f) {
  int k = 0;
  if (count >= 16) {
    F4 xa[4], ya[4], xb[4], yb[4];
    load16(a, b, xa, ya);
    // xa, ya hold terms [k, k + 16) from here on
    for (; k + 48 <= count; k += 32) {
      load16(a + k + 16, b + k + 16, xb, yb);
      fma16(xa, ya, &acc);
      load16(a + k + 32, b + k + 32, xa, ya);
      fma16(xb, yb, &acc);
    }
    if (k + 32 <= count) {
      load16(a + k + 16, b + k + 16, xb, yb);
      fma16(xa, ya, &acc);
      fma16(xb, yb, &acc);
      k += 32;
    } else {
      fma16(xa, ya, &acc);
      k += 16;
    }
  }
  for (; k < count; ++k) acc = fma32(a[k], b[k], acc);
  return acc;
}

// Rows [0, len) of XLA's 8-wide row gemv for one column a of J: rows
// below len8 (a multiple of 8) into the lanes' FMA chains acc[l] (row k
// to lane k % 8), the others into the remainder's chain *tail (a, r
// 16-byte aligned; the chains carry on from earlier rows)
RPX_HD void gemv_part(const float* a, const float* r, int len, int len8,
                      float acc[8], float* tail) {
#if defined(__CUDACC__)
#pragma unroll 4
#endif
  for (int k = 0; k < len8; k += 8) {
    const F4 a0 = load4(a + k), a1 = load4(a + k + 4);
    const F4 r0 = load4(r + k), r1 = load4(r + k + 4);
    for (int q = 0; q < 4; ++q) {
      acc[q] = fma32(a0.v[q], r0.v[q], acc[q]);
      acc[4 + q] = fma32(a1.v[q], r1.v[q], acc[4 + q]);
    }
  }
  float t = *tail;
  for (int k = len8; k < len; ++k) t = fma32(a[k], r[k], t);
  *tail = t;
}

// (J^T r)[i] for one column a of J as XLA's 8-wide row gemv: lane l's
// FMA chain over rows l, l + 8, ... below K8 = K rounded down to 8, and
// the remainder's chain over K8 <= k < K
RPX_HD void gemv_column(const float* a, const float* r, int K,
                        float lanes[8], float* tail) {
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float t = 0.0f;
  gemv_part(a, r, K, K / 8 * 8, acc, &t);
  for (int l = 0; l < 8; ++l) lanes[l] = acc[l];
  *tail = t;
}

// the gemv's horizontal sum of its 8 lanes, then the remainder
RPX_HD float gemv_combine(const float* lanes, float tail) {
  const float h0 = lanes[0] + lanes[4], h1 = lanes[1] + lanes[5];
  const float h2 = lanes[2] + lanes[6], h3 = lanes[3] + lanes[7];
  return ((h0 + h2) + (h1 + h3)) + tail;
}

// XLA splits a sum over n > 32 values into windows of 32 over the
// values padded by (32 * ceil(n / 32) - n) / 2 zeros in front (the rest
// behind), each summed in order from 0; it splits the windows' sums the
// same way while more than 32 remain, and sums the last ones in order.
// (For n <= 32 the one window is the sum in order.)
RPX_HD int n_windows(int n) { return (n + 31) / 32; }
RPX_HD int window_pad(int n) { return (n_windows(n) * 32 - n) / 2; }
// the first-level window sums a refinement of N points keeps (those of
// the K = N + 3 rows), rounded up to four floats
RPX_HD int window_floats(int n) { return (n_windows(n + 3) + 3) / 4 * 4; }
// the dynamic shared memory of a refinement with its rows there
RPX_HD int shared_rows_bytes(int n) {
  return rows_bytes(n) + window_floats(n) * (int)sizeof(float);
}
// the global scratch of one problem with staged rows: its rows, then its
// window sums (a multiple of four floats: each problem's rows start 16
// bytes aligned)
RPX_HD int scratch_floats(int n) {
  return 4 * column_stride(n) + window_floats(n);
}

// window w's sum of x[i]^2 (each square rounded) or of x[i]
RPX_HD float window_sum(const float* x, int n, int w, bool square) {
  const int lo = window_pad(n);
  float acc = 0.0f;
  for (int q = 0; q < 32; ++q) {
    const int i = w * 32 + q - lo;
    if (i >= 0 && i < n) acc = acc + (square ? x[i] * x[i] : x[i]);
  }
  return acc;
}

// The total of a sum over n values from its first level's n_windows(n)
// window sums w[] (overwritten: each further level in place, window v's
// sum replacing w[v], which no later window reads)
RPX_HD float windows_total(float* w, int n) {
  int m = n_windows(n);
  while (m > 32) {
    const int next = n_windows(m);
    for (int v = 0; v < next; ++v) w[v] = window_sum(w, m, v, false);
    m = next;
  }
  float acc = 0.0f;
  for (int v = 0; v < m; ++v) acc = acc + w[v];
  return acc;
}

// x86 rsqrtss of a normal float32 x from the table y0 of its values on
// [1, 4) (ops/refine_exact.rsqrtss_table: entry 1024 p + m for exponent
// parity p and top 10 mantissa bits m): rsqrtss(4^k y) = 2^-k rsqrtss(y)
RPX_HD float rsqrtss_approx(float x, const float* y0) {
  const uint32_t u = f2u(x);
  const int e = (int)((u >> 23) & 0xff) - 127;
  const int p = e & 1;
  const int k = (e - p) / 2;
  const uint32_t scale_bits = (uint32_t)(127 - k) << 23;
  float scale;
  memcpy(&scale, &scale_bits, 4);
  return y0[1024 * p + ((u >> 13) & 1023)] * scale;
}

// 20 / sqrt(n) as XLA computes it: the x86 rsqrtss approximation y0
// (rsqrtss_approx) refined by two Newton steps
RPX_HD float occupied_weight(float n, float y0) {
  float e = fma32(y0, n * y0, -1.0f);
  const float y1 = fma32(-0.5f * y0, e, y0);
  e = fma32(y1, n * y1, -1.0f);
  const float y2 = fma32(-0.5f * y1, e, y1);
  return y2 * 20.0f;
}

// ---------------------------------------------------------------------
// 3x3 LAPACK as SciPy's OpenBLAS 0.3.30 computes it (SkylakeX kernels;
// its LAPACK Fortran compiled without FMA). Matrices are a[i][j].
// ---------------------------------------------------------------------

constexpr float SAFMIN = 1.17549435e-38f;  // slamch('S')
constexpr float EPS = 5.96046448e-08f;     // slamch('E') = 2^-24

// sgetrf (OpenBLAS getf2: left-looking, pivot by first max |.|, the
// column below the pivot times the float reciprocal of the pivot);
// piv[j] is the 0-based row swapped with row j. Returns LAPACK's info.
RPX_HD int sgetrf3(float a[3][3], int piv[3]) {
  int info = 0;
  for (int j = 0; j < 3; ++j) {
    float b[3] = {a[0][j], a[1][j], a[2][j]};
    for (int i = 0; i < j; ++i) {
      const int p = piv[i];
      if (p != i) {
        const float tmp = b[i];
        b[i] = b[p];
        b[p] = tmp;
      }
    }
    for (int i = 1; i < j; ++i) {  // b[i] -= dot(L[i][:i], b[:i])
      float d = a[i][0] * b[0];
      for (int k = 1; k < i; ++k) d = fma32(a[i][k], b[k], d);
      b[i] = b[i] - d;
    }
    for (int i = j; i < 3 && j > 0; ++i) {  // gemv: b[j:] -= A[j:, :j] b
      float t = a[i][0] * b[0];
      for (int k = 1; k < j; ++k) t = fma32(a[i][k], b[k], t);
      b[i] = b[i] - t;
    }
    int jp = j;
    for (int i = j + 1; i < 3; ++i)
      if (fabsf(b[i]) > fabsf(b[jp])) jp = i;
    piv[j] = jp;
    for (int i = 0; i < 3; ++i) a[i][j] = b[i];
    if (a[jp][j] != 0.0f) {
      if (jp != j)
        for (int k = 0; k <= j; ++k) {
          const float tmp = a[j][k];
          a[j][k] = a[jp][k];
          a[jp][k] = tmp;
        }
      const float r = 1.0f / a[j][j];
      for (int i = j + 1; i < 3; ++i) a[i][j] = a[i][j] * r;
    } else if (info == 0) {
      info = j + 1;
    }
  }
  return info;
}

// strsm, left, lower, no transpose, unit diagonal, one right-hand side
// (OpenBLAS trsm_kernel_LT: rows {0, 1} solved, then row 2 by a gemm
// update)
RPX_HD void strsm_lower_unit(const float a[3][3], float c[3]) {
  c[1] = fma32(-c[0], a[1][0], c[1]);
  const float acc = fma32(a[2][1], c[1], a[2][0] * c[0]);
  c[2] = c[2] - acc;
}

// strsm, left, upper, no transpose, non-unit (trsm_kernel_LN: row 2,
// then rows {1, 0}; the packed diagonal holds 1 / a[i][i])
RPX_HD void strsm_upper(const float a[3][3], float c[3]) {
  const float i0 = 1.0f / a[0][0], i1 = 1.0f / a[1][1], i2 = 1.0f / a[2][2];
  const float x2 = c[2] * i2;
  float c0 = c[0] - a[0][2] * x2;
  const float c1 = c[1] - a[1][2] * x2;
  const float x1 = c1 * i1;
  c0 = fma32(-x1, a[0][1], c0);
  c[0] = c0 * i0;
  c[1] = x1;
  c[2] = x2;
}

RPX_HD float sign_of(float a, float b) {  // Fortran SIGN(a, b)
  return (f2u(b) >> 31) ? -fabsf(a) : fabsf(a);
}

RPX_HD float slapy2(float x, float y) {
  const float xa = fabsf(x), ya = fabsf(y);
  const float w = xa > ya ? xa : ya, z = xa > ya ? ya : xa;
  if (z == 0.0f || w > 3.40282347e+38f) return w;
  const float q = z / w;
  return w * sqrtf(1.0f + q * q);
}

// LAPACK 3.10+ slartg (la_xlartg)
RPX_HD void slartg(float f, float g, float* c, float* s, float* r) {
  const float safmax = 1.0f / SAFMIN;
  const float rtmin = sqrtf(SAFMIN), rtmax = sqrtf(safmax / 2.0f);
  const float f1 = fabsf(f), g1 = fabsf(g);
  if (g == 0.0f) {
    *c = 1.0f;
    *s = 0.0f;
    *r = f;
  } else if (f == 0.0f) {
    *c = 0.0f;
    *s = sign_of(1.0f, g);
    *r = g1;
  } else if (f1 > rtmin && f1 < rtmax && g1 > rtmin && g1 < rtmax) {
    const float d = sqrtf(f * f + g * g);
    *c = f1 / d;
    *r = sign_of(d, f);
    *s = g / *r;
  } else {
    float u = f1 > g1 ? f1 : g1;
    u = u > SAFMIN ? u : SAFMIN;
    u = u < safmax ? u : safmax;
    const float fs = f / u, gs = g / u;
    const float d = sqrtf(fs * fs + gs * gs);
    *c = fabsf(fs) / d;
    *r = sign_of(d, f);
    *s = gs / *r;
    *r = *r * u;
  }
}

RPX_HD void slaev2(float a, float b, float c, float* rt1, float* rt2,
                   float* cs1, float* sn1) {
  const float sm = a + c, df = a - c, adf = fabsf(df), tb = b + b,
              ab = fabsf(tb);
  const float acmx = fabsf(a) > fabsf(c) ? a : c;
  const float acmn = fabsf(a) > fabsf(c) ? c : a;
  float rt;
  if (adf > ab) {
    const float q = ab / adf;
    rt = adf * sqrtf(1.0f + q * q);
  } else if (adf < ab) {
    const float q = adf / ab;
    rt = ab * sqrtf(1.0f + q * q);
  } else {
    rt = ab * sqrtf(2.0f);
  }
  int sgn1;
  if (sm < 0.0f) {
    *rt1 = 0.5f * (sm - rt);
    sgn1 = -1;
    *rt2 = (acmx / *rt1) * acmn - (b / *rt1) * b;
  } else if (sm > 0.0f) {
    *rt1 = 0.5f * (sm + rt);
    sgn1 = 1;
    *rt2 = (acmx / *rt1) * acmn - (b / *rt1) * b;
  } else {
    *rt1 = 0.5f * rt;
    *rt2 = -0.5f * rt;
    sgn1 = 1;
  }
  int sgn2;
  float cs;
  if (df >= 0.0f) {
    cs = df + rt;
    sgn2 = 1;
  } else {
    cs = df - rt;
    sgn2 = -1;
  }
  if (fabsf(cs) > ab) {
    const float ct = -tb / cs;
    *sn1 = 1.0f / sqrtf(1.0f + ct * ct);
    *cs1 = ct * *sn1;
  } else if (ab == 0.0f) {
    *cs1 = 1.0f;
    *sn1 = 0.0f;
  } else {
    const float tn = -cs / tb;
    *cs1 = 1.0f / sqrtf(1.0f + tn * tn);
    *sn1 = tn * *cs1;
  }
  if (sgn1 == sgn2) {
    const float tn = *cs1;
    *cs1 = -*sn1;
    *sn1 = tn;
  }
}

// slasr('R', 'V', 'F' or 'B') on columns col0 .. col0 + mm - 1 of z
RPX_HD void slasr_rv(float z[3][3], const float* c, const float* s,
                     int col0, int mm, bool forward) {
  for (int q = 0; q < mm - 1; ++q) {
    const int j = forward ? q : mm - 2 - q;
    const float ct = c[j], st = s[j];
    if (ct != 1.0f || st != 0.0f) {
      for (int i = 0; i < 3; ++i) {
        const float temp = z[i][col0 + j + 1];
        z[i][col0 + j + 1] = ct * temp - st * z[i][col0 + j];
        z[i][col0 + j] = st * temp + ct * z[i][col0 + j];
      }
    }
  }
}

// slascl('G'): x[0..n) times cto / cfrom without over- or underflow
RPX_HD void slascl(float cfrom, float cto, float* x, int n) {
  const float smlnum = SAFMIN, bignum = 1.0f / SAFMIN;
  float cfromc = cfrom, ctoc = cto;
  bool done = false;
  while (!done) {
    const float cfrom1 = cfromc * smlnum;
    float mul;
    if (cfrom1 == cfromc) {
      mul = ctoc / cfromc;
      done = true;
    } else {
      const float cto1 = ctoc / bignum;
      if (cto1 == ctoc) {
        mul = ctoc;
        done = true;
        cfromc = 1.0f;
      } else if (fabsf(cfrom1) > fabsf(ctoc) && ctoc != 0.0f) {
        mul = smlnum;
        cfromc = cfrom1;
      } else if (fabsf(cto1) > fabsf(cfromc)) {
        mul = bignum;
        ctoc = cto1;
      } else {
        mul = ctoc / cfromc;
        done = true;
        if (mul == 1.0f) return;
      }
    }
    for (int i = 0; i < n; ++i) x[i] = x[i] * mul;
  }
}

// ssteqr('I') on the tridiagonal (d, e), z = I on entry. Returns info.
RPX_HD int ssteqr3(float d[3], float e[2], float z[3][3]) {
  const int n = 3, nmaxit = 3 * 30;
  const float eps2 = EPS * EPS;
  const float safmax = 1.0f / SAFMIN;
  const float ssfmax = sqrtf(safmax) / 3.0f;
  const float ssfmin = sqrtf(SAFMIN) / eps2;
  float work[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // c[0..1], s[0..1]
  int jtot = 0, l1 = 0;
  while (l1 <= n - 1) {
    if (l1 > 0) e[l1 - 1] = 0.0f;
    int m = n - 1;
    for (int q = l1; q < n - 1; ++q) {
      const float tst = fabsf(e[q]);
      if (tst == 0.0f) {
        m = q;
        break;
      }
      if (tst <= (sqrtf(fabsf(d[q])) * sqrtf(fabsf(d[q + 1]))) * EPS) {
        e[q] = 0.0f;
        m = q;
        break;
      }
    }
    int l = l1;
    const int lsv = l;
    int lend = m;
    const int lendsv = lend;
    l1 = m + 1;
    if (lend == l) continue;
    float anorm = 0.0f;
    for (int i = l; i <= lend; ++i) anorm = fmaxf(anorm, fabsf(d[i]));
    for (int i = l; i < lend; ++i) anorm = fmaxf(anorm, fabsf(e[i]));
    if (anorm == 0.0f) continue;
    int iscale = 0;
    if (anorm > ssfmax) {
      iscale = 1;
      slascl(anorm, ssfmax, d + l, lend - l + 1);
      slascl(anorm, ssfmax, e + l, lend - l);
    } else if (anorm < ssfmin) {
      iscale = 2;
      slascl(anorm, ssfmin, d + l, lend - l + 1);
      slascl(anorm, ssfmin, e + l, lend - l);
    }
    if (fabsf(d[lend]) < fabsf(d[l])) {
      lend = lsv;
      l = lendsv;
    }
    if (lend > l) {  // QL iteration
      while (true) {
        int mm = lend;
        for (int q = l; q < lend; ++q) {
          const float tst = fabsf(e[q]) * fabsf(e[q]);
          if (tst <= (eps2 * fabsf(d[q])) * fabsf(d[q + 1]) + SAFMIN) {
            mm = q;
            break;
          }
        }
        m = mm;
        if (m < lend) e[m] = 0.0f;
        float p = d[l];
        if (m == l) {
          d[l] = p;
          l += 1;
          if (l <= lend) continue;
          break;
        }
        if (m == l + 1) {
          float rt1, rt2, c, s;
          slaev2(d[l], e[l], d[l + 1], &rt1, &rt2, &c, &s);
          slasr_rv(z, &c, &s, l, 2, false);
          d[l] = rt1;
          d[l + 1] = rt2;
          e[l] = 0.0f;
          l += 2;
          if (l <= lend) continue;
          break;
        }
        if (jtot == nmaxit) break;
        jtot += 1;
        float g = (d[l + 1] - p) / (2.0f * e[l]);
        float r = slapy2(g, 1.0f);
        g = (d[m] - p) + (e[l] / (g + sign_of(r, g)));
        float s = 1.0f, c = 1.0f;
        p = 0.0f;
        for (int i = m - 1; i >= l; --i) {
          const float f = s * e[i], b = c * e[i];
          slartg(g, f, &c, &s, &r);
          if (i != m - 1) e[i + 1] = r;
          g = d[i + 1] - p;
          r = (d[i] - g) * s + (2.0f * c) * b;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - b;
          work[i] = c;
          work[2 + i] = -s;
        }
        slasr_rv(z, work + l, work + 2 + l, l, m - l + 1, false);
        d[l] = d[l] - p;
        e[l] = g;
      }
    } else {  // QR iteration
      while (true) {
        int mm = lend;
        for (int q = l; q > lend; --q) {
          const float tst = fabsf(e[q - 1]) * fabsf(e[q - 1]);
          if (tst <= (eps2 * fabsf(d[q])) * fabsf(d[q - 1]) + SAFMIN) {
            mm = q;
            break;
          }
        }
        m = mm;
        if (m > lend) e[m - 1] = 0.0f;
        float p = d[l];
        if (m == l) {
          d[l] = p;
          l -= 1;
          if (l >= lend) continue;
          break;
        }
        if (m == l - 1) {
          float rt1, rt2, c, s;
          slaev2(d[l - 1], e[l - 1], d[l], &rt1, &rt2, &c, &s);
          slasr_rv(z, &c, &s, l - 1, 2, true);
          d[l - 1] = rt1;
          d[l] = rt2;
          e[l - 1] = 0.0f;
          l -= 2;
          if (l >= lend) continue;
          break;
        }
        if (jtot == nmaxit) break;
        jtot += 1;
        float g = (d[l - 1] - p) / (2.0f * e[l - 1]);
        float r = slapy2(g, 1.0f);
        g = (d[m] - p) + (e[l - 1] / (g + sign_of(r, g)));
        float s = 1.0f, c = 1.0f;
        p = 0.0f;
        for (int i = m; i < l; ++i) {
          const float f = s * e[i], b = c * e[i];
          slartg(g, f, &c, &s, &r);
          if (i != m) e[i - 1] = r;
          g = d[i] - p;
          r = (d[i + 1] - g) * s + (2.0f * c) * b;
          p = s * r;
          d[i] = g + p;
          g = c * r - b;
          work[i] = c;
          work[2 + i] = s;
        }
        slasr_rv(z, work + m, work + 2 + m, m, l - m + 1, true);
        d[l] = d[l] - p;
        e[l - 1] = g;
      }
    }
    if (iscale == 1) {
      slascl(ssfmax, anorm, d + lsv, lendsv - lsv + 1);
      slascl(ssfmax, anorm, e + lsv, lendsv - lsv);
    } else if (iscale == 2) {
      slascl(ssfmin, anorm, d + lsv, lendsv - lsv + 1);
      slascl(ssfmin, anorm, e + lsv, lendsv - lsv);
    }
    if (jtot >= nmaxit) {
      int info = 0;
      for (int i = 0; i < n - 1; ++i) info += e[i] != 0.0f;
      return info;
    }
  }
  for (int ii = 1; ii < n; ++ii) {  // selection sort, ascending
    const int i = ii - 1;
    int k = i;
    float p = d[i];
    for (int j = ii; j < n; ++j)
      if (d[j] < p) {
        k = j;
        p = d[j];
      }
    if (k != i) {
      d[k] = d[i];
      d[i] = p;
      for (int q = 0; q < 3; ++q) {
        const float tmp = z[q][i];
        z[q][i] = z[q][k];
        z[q][k] = tmp;
      }
    }
  }
  return 0;
}

// ssyevd('V', 'L') of the symmetric a: eigenvalues w ascending, z[i][j]
// the i-th entry of eigenvector j. Returns LAPACK's info.
RPX_HD int ssyevd3(const float a_in[3][3], float w[3], float z[3][3]) {
  float a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) a[i][j] = a_in[i][j];
  float anrm = 0.0f;
  for (int j = 0; j < 3; ++j)
    for (int i = j; i < 3; ++i) anrm = fmaxf(anrm, fabsf(a[i][j]));
  // slamch('P') = 2 * slamch('E')
  const float smlnum = SAFMIN / (2.0f * EPS), bignum = 1.0f / smlnum;
  const float rmin = sqrtf(smlnum), rmax = sqrtf(bignum);
  float sigma = 1.0f;
  bool iscale = false;
  if (anrm > 0.0f && anrm < rmin) {
    iscale = true;
    sigma = rmin / anrm;
  } else if (anrm > rmax) {
    iscale = true;
    sigma = rmax / anrm;
  }
  if (iscale) {
    float low[6] = {a[0][0], a[1][0], a[2][0], a[1][1], a[2][1], a[2][2]};
    slascl(1.0f, sigma, low, 6);
    a[0][0] = low[0];
    a[1][0] = low[1];
    a[2][0] = low[2];
    a[1][1] = low[3];
    a[2][1] = low[4];
    a[2][2] = low[5];
  }
  // ssytd2 (lower), column 0: slarfg on (a[1][0], a[2][0])
  float alpha = a[1][0], x = a[2][0], tau = 0.0f, e0 = alpha;
  if (x != 0.0f) {
    float beta = -sign_of(slapy2(alpha, fabsf(x)), alpha);
    const float safmn = SAFMIN / EPS;
    int knt = 0;
    if (fabsf(beta) < safmn) {
      const float rsafmn = 1.0f / safmn;
      do {
        knt += 1;
        x = x * rsafmn;
        beta = beta * rsafmn;
        alpha = alpha * rsafmn;
      } while (fabsf(beta) < safmn && knt < 20);
      beta = -sign_of(slapy2(alpha, fabsf(x)), alpha);
    }
    tau = (beta - alpha) / beta;
    x = x * (1.0f / (alpha - beta));
    for (int q = 0; q < knt; ++q) beta = beta * safmn;
    e0 = beta;
    a[2][0] = x;
  }
  if (tau != 0.0f) {
    // y = tau * A22 v (ssymv, lower), v = (1, x)
    const float v[2] = {1.0f, x};
    const float A00 = a[1][1], A10 = a[2][1], A11 = a[2][2];
    float y[2] = {0.0f, 0.0f};
    float t1 = tau * v[0], t2 = 0.0f;
    y[0] = fma32(t1, A00, y[0]);
    y[1] = fma32(t1, A10, y[1]);
    t2 = fma32(A10, v[1], t2);
    y[0] = fma32(tau, t2, y[0]);
    t1 = tau * v[1];
    y[1] = fma32(t1, A11, y[1]);
    y[1] = fma32(tau, 0.0f, y[1]);
    // alpha = -(tau / 2) (y . v); y += alpha v
    const float dt = y[0] * v[0] + y[1] * v[1];
    const float al = -((0.5f * tau) * dt);
    y[0] = fma32(al, v[0], y[0]);
    y[1] = fma32(al, v[1], y[1]);
    // A22 -= v y^T + y v^T (ssyr2, lower; per column: the v_j term,
    // then the y_j term)
    float B[2][2] = {{A00, 0.0f}, {A10, A11}};
    for (int j = 0; j < 2; ++j)
      for (int i = j; i < 2; ++i) {
        B[i][j] = fma32(-v[j], y[i], B[i][j]);
        B[i][j] = fma32(-y[j], v[i], B[i][j]);
      }
    a[1][1] = B[0][0];
    a[2][1] = B[1][0];
    a[2][2] = B[1][1];
  }
  float d[3] = {a[0][0], a[1][1], a[2][2]};
  float e[2] = {e0, a[2][1]};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) z[i][j] = i == j ? 1.0f : 0.0f;
  const int info = ssteqr3(d, e, z);
  // sormtr -> sorm2r: rows 1..2 of z times H = I - tau v v^T
  if (tau != 0.0f) {
    const float v[2] = {1.0f, a[2][0]};
    const int lastv = v[1] != 0.0f ? 2 : 1;
    int lastc = 0;
    for (int j = 0; j < 3; ++j)
      for (int i = 0; i < lastv; ++i)
        if (z[1 + i][j] != 0.0f) lastc = j + 1;
    float wv[3];
    for (int j = 0; j < lastc; ++j)
      wv[j] = lastv == 2 ? z[1][j] * v[0] + z[2][j] * v[1] : z[1][j] * v[0];
    for (int j = 0; j < lastc; ++j) {
      const float aw = -tau * wv[j];
      for (int i = 0; i < lastv; ++i) z[1 + i][j] = fma32(aw, v[i], z[1 + i][j]);
    }
  }
  for (int i = 0; i < 3; ++i) w[i] = d[i];
  if (iscale) {
    const float inv = 1.0f / sigma;
    for (int i = 0; i < 3; ++i) w[i] = w[i] * inv;
  }
  return info;
}

// ---------------------------------------------------------------------
// The steps of one refinement that one thread (or thread 0) takes.
// ---------------------------------------------------------------------

// H + 1e-9 I, solved for -g as jnp.linalg.solve does (sgetrf, the
// permutation, strsm lower unit, strsm upper); returns pose + dp
RPX_HD void gn_solve(const float H[3][3], const float g[3],
                     const float pose[3], float out[3]) {
  float a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      a[i][j] = H[i][j] + (i == j ? 1e-9f : 0.0f);
  int piv[3];
  sgetrf3(a, piv);
  int perm[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i) {
    const int t = perm[i];
    perm[i] = perm[piv[i]];
    perm[piv[i]] = t;
  }
  float c[3] = {-g[perm[0]], -g[perm[1]], -g[perm[2]]};
  strsm_lower_unit(a, c);
  strsm_upper(a, c);
  for (int i = 0; i < 3; ++i) out[i] = pose[i] + c[i];
}

// The Censi covariance sigma2 * V diag(sel(w)) V^T from J^T J and
// sigma2 (ssyevd of the symmetrized H). NaN where eigh fails.
RPX_HD void censi_cov(const float H[3][3], float sigma2, float cov[9]) {
  float hs[3][3], w[3], v[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) hs[i][j] = (H[i][j] + H[j][i]) * 0.5f;
  const int info = ssyevd3(hs, w, v);
  float m[3][3];
  for (int j = 0; j < 3; ++j) {
    const float inv = 1.0f / fmaxf(w[j], 1e-6f);
    const float sel = w[j] > 1e-6f ? inv : 1e6f;
    const float f = sigma2 * sel;
    for (int i = 0; i < 3; ++i) m[i][j] = v[i][j] * f;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < 3; ++k) acc = fma32(m[i][k], v[j][k], acc);
      cov[3 * i + j] = info == 0 ? acc : NAN;
    }
}

// ---------------------------------------------------------------------
// Rows beyond shared memory (N > SMEM_ROWS_MAX). The rows live in a
// per-problem global scratch buffer (16 (N + 4) bytes, 1 MB at N =
// 65536: it stays in the 50 MB L2). One producer thread stages them,
// RING_CHUNK rows of the four columns at a time, into a ring of
// RING_SLOTS shared-memory slots with Hopper's bulk asynchronous copies
// (cp.async.bulk, completion counted in bytes on the slot's `full`
// mbarrier); the J^T J chains and the J^T r gemv read each chunk from
// its slot with their 128-bit shared loads, in order, and release it on
// the slot's `empty` mbarrier, which the producer waits for before it
// refills the slot. The chunks continue the same chains: the rows' home
// changes no sum. The host build reads each chunk where it lies.
// ---------------------------------------------------------------------

constexpr int RING_SLOTS = 4;
constexpr int RING_CHUNK = 1024;  // rows a slot holds: 4 columns x 4 KB
// the readers that release each slot: the six chain threads and the
// three gemv threads (reduce_rows_staged)
constexpr int RING_READERS = 9;
// the producer (a warp of its own) and the first window thread
constexpr int RING_PRODUCER = 64, STAGED_WINDOWS = 96;
static_assert(THREADS > STAGED_WINDOWS, "reduce_rows_staged's roles");
// false: the readers load each chunk from the scratch buffer themselves
// (plain global loads; scripts/refine_ablation.py --staging times both)
constexpr bool STAGE_ROWS = true;
RPX_HD int ring_bytes() {
  return RING_SLOTS * 4 * RING_CHUNK * (int)sizeof(float);
}
RPX_HD int ring_chunks(int count) {
  return (count + RING_CHUNK - 1) / RING_CHUNK;
}

struct Ring {
  float* slots = nullptr;     // (shared) column q of slot s at
                              // (4 s + q) RING_CHUNK
  uint64_t* full = nullptr;   // (shared) per slot: its chunk has landed
  uint64_t* empty = nullptr;  // (shared) per slot: its readers are done
};

#ifdef __CUDA_ARCH__
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}
// the mbarriers' initialisation made visible to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)), "r"(bytes)
      : "memory");
}
// wait until the phase of parity `parity` of the mbarrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), counted on `bar` as they land
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
#endif

// the rows a thread wrote to global memory made visible to the bulk
// copies (the async proxy) that read them after the next barrier
RPX_HD void rows_written_fence() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.proxy.async.global;" ::: "memory");
#endif
}

// ---------------------------------------------------------------------
// One whole refinement as a block program: `ex.each(f)` runs f(tid) for
// each of the block's THREADS threads, `ex.sync()` is the barrier
// between steps. The kernel runs it with a block of THREADS threads
// whatever N is, the host build with the threads one after another.
// Thread tid owns points tid, tid + T, ... (T = THREADS).
//
// The JAX loop is a pure map of the pose (the anchor fixed for the
// stage): each GN step evaluates the rows and Jacobian at the pose,
// solves, evaluates the trial, and keeps it if its cost is not higher.
// The rows at the trial are the next step's rows at the pose when the
// trial is kept (the interpolation is the same with or without the
// Jacobian), so each step here evaluates once, with the Jacobian, at
// the trial. A rejected trial, or a kept one whose bits equal the
// pose's, leaves every later step of the stage to repeat the same
// computation on the same inputs: the stage ends there, with the same
// bits as all `iterations` steps.
// ---------------------------------------------------------------------

struct Problem {
  GridRef grid[2];      // stage grids (coarse, fine); grid[0] alone for 1 stage
  int stages;           // 1 or 2
  int n;                // padded points N (takes_points)
  const float* pts;     // (N, 2)
  const uint8_t* valid; // (N,)
  const float* init;    // (3,)
  const float* y0;      // (2048,) rsqrtss on [1, 4) (rsqrtss_approx)
  int iterations;
  bool want_cov;        // false: the pose alone (refine_pose)
  float* pose_out;      // (3,)
  float* cov_out;       // (9,) when want_cov
  float* probs_out;     // (N,) when want_cov: the first stage's
  int* iters_out;       // (2,) GN steps each stage ran (0: not run)
  float* win;           // (window_floats(N),) first-level window sums
                        // of sum(r^2): beside the rows
};

// The block's scalars. The rows (4 (N + 3) floats) and the window sums
// are in dynamic shared memory on the card, or with staged rows in the
// problem's global scratch.
struct Shared {
  float H[6];               // J^T J: (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
  float lanes[24];          // J^T r: eight lanes per entry
  float tails[3];           // and the rows past the last multiple of 8
  float pose[3], anchor[3], trial[3];
  float c, s;               // cos, sin of trial[2] (of pose[2] for cov)
  float cost;               // sum(r^2) of the rows at pose
  float w_occ;
  int n_valid;
  int done;                 // the stage's later steps would repeat
};

// The GN system's rows from `base` (shared memory on the card, or the
// problem's global scratch), structure of arrays: J's three columns,
// then r, `stride` floats apart (column_stride)
struct Rows {
  float* base;
  int stride;
  RPX_HD float* J(int k) const { return base + k * stride; }
  RPX_HD float* r() const { return base + 3 * stride; }
};

// where thread 0 of a step adds its count: the block's other threads
// add theirs at the same time on the card
RPX_HD void shared_add(int* p, int v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

// J^T J's entry (i, j) in Shared::H
RPX_HD int gram_slot(int i, int j) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i == 0 ? j : (i == 1 ? 2 + j : 5);
}

// Thread tid's rows of the GN system at sh.trial (cos sh.c, sin sh.s):
// the residuals and Jacobian rows of its points and, for tid < 3, the
// anchor row N + tid
RPX_HD void gn_rows(int tid, int T, const Problem& P, const GridRef& G,
                    const Shared& sh, const Rows& R) {
  const int n = P.n;
  for (int i = tid; i < n; i += T) {
    const float wv = P.valid[i] ? 1.0f : 0.0f;
    float jo[3];
    const float p = eval_point(G, P.pts[2 * i], P.pts[2 * i + 1],
                               sh.trial[0], sh.trial[1], sh.c, sh.s, jo);
    R.r()[i] = ((1.0f - p) * sh.w_occ) * wv;
    for (int k = 0; k < 3; ++k) R.J(k)[i] = (-jo[k] * sh.w_occ) * wv;
  }
  if (tid < 3) {
    R.r()[n + tid] = tid < 2 ? (sh.trial[tid] - sh.anchor[tid]) * 10.0f
                           : sh.trial[2] - sh.anchor[2];
    for (int q = 0; q < 3; ++q)
      R.J(q)[n + tid] = q == tid ? (tid < 2 ? 10.0f : 1.0f) : 0.0f;
  }
}

// J^T J's entry tid < 6 as its (row, column) of J
RPX_HD int chain_i(int tid) { return tid < 3 ? 0 : (tid < 5 ? 1 : 2); }
RPX_HD int chain_j(int tid) { return tid < 3 ? tid : (tid < 5 ? tid - 2 : 2); }

// Thread tid's part of the reductions over the first K rows, each in
// XLA's order: threads 0-5 (warp 0) the six J^T J chains of K FMAs (the
// kernel's critical path), with `gemv` threads 32-34 (warp 1) J^T r's
// three entries (eight lanes each, and the rows past the last multiple
// of 8), threads from 64 on the first-level windows of sum(r^2) into
// win.
RPX_HD void reduce_rows(int tid, int T, const Rows& R, int K, bool gemv,
                        Shared& sh, float* win) {
  if (tid < 6) {
    sh.H[tid] = dot_chain(R.J(chain_i(tid)), R.J(chain_j(tid)), K);
  } else if (tid >= 32 && tid < 35) {
    const int i = tid - 32;
    if (gemv) gemv_column(R.J(i), R.r(), K, sh.lanes + 8 * i, sh.tails + i);
  } else if (tid >= 64) {
    for (int w = tid - 64; w < n_windows(K); w += T - 64)
      win[w] = window_sum(R.r(), K, w, true);
  }
}

// Chunk `c` of a pass whose first chunk is the ring's `seq`-th: the
// chunk's four columns from *col0, `*stride` floats apart. On the card
// with the ring, from its slot once it has landed; else in place.
RPX_HD const float* ring_acquire(const Ring& ring, const Rows& R,
                                 unsigned seq, int c, int* stride) {
#ifdef __CUDA_ARCH__
  if (ring.slots != nullptr) {
    const unsigned q = seq + c, s = q % RING_SLOTS;
    mbar_wait(ring.full + s, (q / RING_SLOTS) & 1);
    *stride = RING_CHUNK;
    return ring.slots + 4 * s * RING_CHUNK;
  }
#endif
  *stride = R.stride;
  return R.base + c * RING_CHUNK;
}

RPX_HD void ring_release(const Ring& ring, unsigned seq, int c) {
#ifdef __CUDA_ARCH__
  if (ring.slots != nullptr) mbar_arrive(ring.empty + (seq + c) % RING_SLOTS);
#endif
}

// The producer: the pass's `chunks` chunks of the first `count` rows
// into the ring, each slot once its readers have released its last
// chunk (the card only)
RPX_HD void ring_fill(const Ring& ring, const Rows& R, unsigned seq,
                      int count) {
#ifdef __CUDA_ARCH__
  if (ring.slots == nullptr) return;
  const int filled = (count + 3) / 4 * 4;  // whole 16-byte groups
  for (int c = 0; c < ring_chunks(count); ++c) {
    const unsigned q = seq + c, s = q % RING_SLOTS, f = q / RING_SLOTS;
    if (f > 0) mbar_wait(ring.empty + s, (f - 1) & 1);
    const int lo = c * RING_CHUNK;
    const int len = filled - lo < RING_CHUNK ? filled - lo : RING_CHUNK;
    const uint32_t bytes = (uint32_t)len * (uint32_t)sizeof(float);
    mbar_arrive_expect_tx(ring.full + s, 4 * bytes);
    for (int col = 0; col < 4; ++col)
      bulk_copy(ring.slots + (4 * s + col) * RING_CHUNK,
                R.base + col * R.stride + lo, bytes, ring.full + s);
  }
#endif
}

// reduce_rows over rows in global memory, in the same orders: the six
// chains and the three gemv threads take the rows chunk by chunk
// (ring_acquire; the gemv threads without `gemv` release them unread),
// thread RING_PRODUCER fills the ring, the threads from STAGED_WINDOWS
// on sum the windows of sum(r^2) from the rows where they lie.
RPX_HD void reduce_rows_staged(int tid, int T, const Rows& R, int K,
                               bool gemv, Shared& sh, float* win,
                               const Ring& ring, unsigned seq) {
  const bool chain = tid < 6, gemv_thread = tid >= 32 && tid < 35;
  if (chain || gemv_thread) {
    const int i = chain ? chain_i(tid) : tid - 32;
    const int j = chain ? chain_j(tid) : 3;  // column 3: r
    const int K8 = K / 8 * 8;
    float acc = 0.0f, tail = 0.0f;
    float lanes[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < ring_chunks(K); ++c) {
      const int lo = c * RING_CHUNK;
      const int len = K - lo < RING_CHUNK ? K - lo : RING_CHUNK;
      int stride;
      const float* cols = ring_acquire(ring, R, seq, c, &stride);
      const float* a = cols + i * stride;
      const float* b = cols + j * stride;
      if (chain) {
        acc = dot_chain(a, b, len, acc);
      } else if (gemv) {
        const int len8 = K8 - lo < 0 ? 0 : (K8 - lo < len ? K8 - lo : len);
        gemv_part(a, b, len, len8, lanes, &tail);
      }
      ring_release(ring, seq, c);
    }
    if (chain) {
      sh.H[tid] = acc;
    } else if (gemv) {
      for (int l = 0; l < 8; ++l) sh.lanes[8 * i + l] = lanes[l];
      sh.tails[i] = tail;
    }
  } else if (tid == RING_PRODUCER) {
    ring_fill(ring, R, seq, K);
  } else if (tid >= STAGED_WINDOWS) {
    for (int w = tid - STAGED_WINDOWS; w < n_windows(K);
         w += T - STAGED_WINDOWS)
      win[w] = window_sum(R.r(), K, w, true);
  }
}

// Thread 0: the GN step from the reductions of the rows at sh.pose, into
// sh.trial with its cos and sin
RPX_HD void gn_step(Shared& sh) {
  float g[3], H[3][3];
  for (int i = 0; i < 3; ++i) {
    g[i] = gemv_combine(sh.lanes + 8 * i, sh.tails[i]);
    for (int j = 0; j < 3; ++j) H[i][j] = sh.H[gram_slot(i, j)];
  }
  gn_solve(H, g, sh.pose, sh.trial);
  sh.c = glibc_sincosf(sh.trial[2], 1);
  sh.s = glibc_sincosf(sh.trial[2], 0);
}

// kStaged: the rows in global memory (staged_rows(N)), reduced through
// `ring` (reduce_rows_staged); else in shared memory (`rows`)
template <bool kStaged, class Exec>
RPX_HD void refine_block(Exec& ex, const Problem& P, Shared& sh,
                         float* rows, const Ring& ring = Ring{}) {
  const int n = P.n, K = n + 3, T = THREADS;
  const Rows R{rows, column_stride(n)};
  // the ring's chunks before the current pass (every thread counts them)
  unsigned seq = 0;
  // the reductions of the first `count` rows into sh and P.win
  auto reduce = [&](int count, bool gemv) {
    ex.each([&](int tid) {
      if (kStaged)
        reduce_rows_staged(tid, T, R, count, gemv, sh, P.win, ring, seq);
      else
        reduce_rows(tid, T, R, count, gemv, sh, P.win);
    });
    ex.sync();
    if (kStaged) seq += ring_chunks(count);
  };
  ex.each([&](int tid) {
    if (tid == 0) {
      sh.n_valid = 0;
      for (int k = 0; k < 3; ++k) sh.pose[k] = P.init[k];
      P.iters_out[0] = P.iters_out[1] = 0;
    }
  });
  ex.sync();
  ex.each([&](int tid) {
    int cnt = 0;
    for (int i = tid; i < n; i += T) cnt += P.valid[i] != 0;
    shared_add(&sh.n_valid, cnt);
  });
  ex.sync();
  for (int stage = 0; stage < P.stages; ++stage) {
    // (a copy chosen without indexing: P stays in registers on the card)
    const GridRef G = stage == 0 ? P.grid[0] : P.grid[1];
    ex.each([&](int tid) {
      if (tid == 0) {
        const int nn = sh.n_valid > 1 ? sh.n_valid : 1;
        sh.w_occ = occupied_weight((float)nn,
                                   rsqrtss_approx((float)nn, P.y0));
        for (int k = 0; k < 3; ++k) sh.anchor[k] = sh.trial[k] = sh.pose[k];
        sh.c = glibc_sincosf(sh.pose[2], 1);
        sh.s = glibc_sincosf(sh.pose[2], 0);
        sh.done = 0;
      }
    });
    ex.sync();
    if (P.iterations > 0) {  // the rows at the stage's first pose
      ex.each([&](int tid) {
        gn_rows(tid, T, P, G, sh, R);
        if (kStaged) rows_written_fence();
      });
      ex.sync();
      reduce(K, true);
      ex.each([&](int tid) {
        if (tid == 0) {
          sh.cost = windows_total(P.win, K);
          gn_step(sh);
        }
      });
      ex.sync();
    }
    for (int it = 0; it < P.iterations; ++it) {
      ex.each([&](int tid) {
        gn_rows(tid, T, P, G, sh, R);
        if (kStaged) rows_written_fence();
      });
      ex.sync();
      reduce(K, true);
      ex.each([&](int tid) {
        if (tid == 0) {
          const float cost = windows_total(P.win, K);
          P.iters_out[stage] = it + 1;
          if (cost <= sh.cost) {  // keep the trial
            bool same = true;
            for (int k = 0; k < 3; ++k) {
              same = same && f2u(sh.trial[k]) == f2u(sh.pose[k]);
              sh.pose[k] = sh.trial[k];
            }
            sh.cost = cost;
            sh.done = same;
          } else {
            sh.done = 1;
          }
          if (!sh.done && it + 1 < P.iterations) gn_step(sh);
        }
      });
      ex.sync();
      if (sh.done) break;
    }
    if (!P.want_cov) continue;
    // the covariance's rows at the stage's pose: J, the masked residual
    // (in r) and the probabilities
    const bool last = stage == P.stages - 1;
    ex.each([&](int tid) {
      if (tid == 0) {
        sh.c = glibc_sincosf(sh.pose[2], 1);
        sh.s = glibc_sincosf(sh.pose[2], 0);
      }
    });
    ex.sync();
    ex.each([&](int tid) {
      for (int i = tid; i < n; i += T) {
        float jo[3];
        const float p = eval_point(G, P.pts[2 * i], P.pts[2 * i + 1],
                                   sh.pose[0], sh.pose[1], sh.c, sh.s,
                                   last ? jo : nullptr);
        if (stage == 0) P.probs_out[i] = p;
        if (last) {
          const float vf = P.valid[i] ? 1.0f : 0.0f;
          for (int k = 0; k < 3; ++k) R.J(k)[i] = -jo[k] * vf;
          R.r()[i] = P.valid[i] ? 1.0f - p : 0.0f;
        }
      }
      if (kStaged) rows_written_fence();
    });
    ex.sync();
    if (!last) continue;
    reduce(n, false);
    ex.each([&](int tid) {
      if (tid == 0) {
        const float ssum = windows_total(P.win, n);
        const int nn = sh.n_valid > 1 ? sh.n_valid : 1;
        const float sigma2 = ssum / fmaxf((float)nn + -3.0f, 1.0f);
        float H[3][3];
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j) H[i][j] = sh.H[gram_slot(i, j)];
        censi_cov(H, sigma2, P.cov_out);
      }
    });
    ex.sync();
  }
  ex.each([&](int tid) {
    if (tid < 3) P.pose_out[tid] = sh.pose[tid];
  });
  ex.sync();
}

}  // namespace rpx
