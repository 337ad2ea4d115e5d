// The block program of refine_pose.cu on the host: the same header, the
// block's threads run one after another between its barriers. The CPU
// tests (tests/test_torch_refine_exact.py) hold it against the plain
// version in ops/refine_exact.py, and the header's LAPACK and sincosf
// against SciPy and the C library, without a card. Build with
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o librefine_pose_host.so refine_pose_host.cpp
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

#include "refine_pose_exact.cuh"

namespace {

struct HostExec {
  template <class F>
  void each(F&& f) {
    for (int tid = 0; tid < rpx::THREADS; ++tid) f(tid);
  }
  void sync() {}
};

}  // namespace

// Same arguments as refine_pose_launch, on host memory. Returns 0, or 1
// for arguments the kernel does not take.
extern "C" int refine_pose_host(
    const float* g0, int size0, const float* origin0, float res0,
    const float* g1, int size1, const float* origin1, float res1,
    int stages, const float* pts, const uint8_t* valid, const float* init,
    const float* y0, int batch, int n, int iterations, int want_cov,
    float* pose, float* cov, float* probs, int* iters) {
  if (!rpx::takes_points(n) || batch < 1 ||
      (stages != 1 && stages != 2) || iterations < 0)
    return 1;
  rpx::Shared sh;
  std::vector<float> rows(rpx::rows_bytes(n) / sizeof(float));
  for (int b = 0; b < batch; ++b) {
    rpx::Problem P;
    P.grid[0] = {g0, size0, origin0[0], origin0[1], res0};
    P.grid[1] = {g1, size1, origin1[0], origin1[1], res1};
    P.stages = stages;
    P.n = n;
    P.pts = pts + (size_t)b * n * 2;
    P.valid = valid + (size_t)b * n;
    P.init = init + 3 * b;
    P.y0 = y0;
    P.iterations = iterations;
    P.want_cov = want_cov != 0;
    P.pose_out = pose + 3 * b;
    P.cov_out = cov + 9 * b;
    P.probs_out = probs + (size_t)b * n;
    P.iters_out = iters + 2 * b;
    HostExec ex;
    rpx::refine_block(ex, P, sh, rows.data());
  }
  return 0;
}

// Same arguments as refine_pins_launch, on host memory. Returns 0, or 1
// for arguments the kernel does not take.
extern "C" int refine_pins_host(
    const float* grids, int size, const float* origins, const int* ids,
    float res, const float* pts, const uint8_t* valid, const float* init,
    const float* y0, int batch, int n, int iterations, float* pose,
    float* cov, float* probs, int* iters) {
  if (!rpx::takes_points(n) || batch < 1 || iterations < 0) return 1;
  rpx::Shared sh;
  std::vector<float> rows(rpx::rows_bytes(n) / sizeof(float));
  for (int b = 0; b < batch; ++b) {
    const int id = ids[b];
    rpx::Problem P;
    P.grid[0] = {grids + (size_t)id * size * size, size, origins[2 * id],
                 origins[2 * id + 1], res, 1, 1.0f / res};
    P.grid[1] = P.grid[0];
    P.stages = 1;
    P.n = n;
    P.pts = pts + (size_t)b * n * 2;
    P.valid = valid + (size_t)b * n;
    P.init = init + 3 * b;
    P.y0 = y0;
    P.iterations = iterations;
    P.want_cov = true;
    P.pose_out = pose + 3 * b;
    P.cov_out = cov + 9 * b;
    P.probs_out = probs + (size_t)b * n;
    P.iters_out = iters + 2 * b;
    HostExec ex;
    rpx::refine_block(ex, P, sh, rows.data());
  }
  return 0;
}

// The header's pieces, for the tests: sinf (which = 0) or cosf (1) of
// each of x[0..count)
extern "C" void rpx_sincosf(const float* x, int count, int which,
                            float* out) {
  for (int i = 0; i < count; ++i) out[i] = rpx::glibc_sincosf(x[i], which);
}

// jnp.linalg.solve(h + 1e-9 I, -g) + pose for count problems
// ((count, 3, 3) row-major h, (count, 3) g and pose)
extern "C" void rpx_gn_solve(const float* h, const float* g,
                             const float* pose, int count, float* out) {
  for (int q = 0; q < count; ++q) {
    float H[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) H[i][j] = h[9 * q + 3 * i + j];
    rpx::gn_solve(H, g + 3 * q, pose + 3 * q, out + 3 * q);
  }
}

// sgetrf of count 3x3 matrices: lu (row-major) and 0-based pivots
extern "C" void rpx_sgetrf3(const float* a, int count, float* lu, int* piv) {
  for (int q = 0; q < count; ++q) {
    float A[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) A[i][j] = a[9 * q + 3 * i + j];
    rpx::sgetrf3(A, piv + 3 * q);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) lu[9 * q + 3 * i + j] = A[i][j];
  }
}

// strsm lower-unit (which = 0) or upper (1) with count factors and
// right-hand sides (overwritten)
extern "C" void rpx_strsm3(const float* a, float* c, int count, int which) {
  for (int q = 0; q < count; ++q) {
    float A[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) A[i][j] = a[9 * q + 3 * i + j];
    if (which == 0)
      rpx::strsm_lower_unit(A, c + 3 * q);
    else
      rpx::strsm_upper(A, c + 3 * q);
  }
}

// ssyevd('V', 'L') of count symmetric matrices: w ascending, z[i][j]
// (row-major) the i-th entry of eigenvector j; info per matrix
extern "C" void rpx_ssyevd3(const float* a, int count, float* w, float* z,
                            int* info) {
  for (int q = 0; q < count; ++q) {
    float A[3][3], Z[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) A[i][j] = a[9 * q + 3 * i + j];
    info[q] = rpx::ssyevd3(A, w + 3 * q, Z);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) z[9 * q + 3 * i + j] = Z[i][j];
  }
}

// How many of the float32 bit patterns start, start + step, ... below
// end (each with both signs) the C library's sinf/cosf map to other
// bits than `values` (sin_v, cos_v indexed by (bits - start) / step for
// the positive pattern, then the count of positive patterns on for the
// negative ones) or, when values are null, than the header's
// glibc_sincosf. Runs on every core.
extern "C" long long rpx_libm_mismatches(uint32_t start, uint32_t end,
                                         uint32_t step, const float* sin_v,
                                         const float* cos_v) {
  const uint64_t n = end > start ? ((uint64_t)end - start + step - 1) / step : 0;
  const unsigned workers = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<long long> bad{0};
  std::vector<std::thread> pool;
  for (unsigned w = 0; w < workers; ++w)
    pool.emplace_back([&, w] {
      long long mine = 0;
      for (uint64_t k = w; k < n; k += workers)
        for (int neg = 0; neg < 2; ++neg) {
          const uint32_t bits = (start + (uint32_t)(k * step)) |
                                (neg ? 0x80000000u : 0u);
          float y;
          memcpy(&y, &bits, 4);
          const uint64_t at = k + (neg ? n : 0);
          const float s = sin_v ? sin_v[at] : rpx::glibc_sincosf(y, 0);
          const float c = cos_v ? cos_v[at] : rpx::glibc_sincosf(y, 1);
          mine += rpx::f2u(s) != rpx::f2u(sinf(y));
          mine += rpx::f2u(c) != rpx::f2u(cosf(y));
        }
      bad += mine;
    });
  for (auto& t : pool) t.join();
  return bad.load();
}
