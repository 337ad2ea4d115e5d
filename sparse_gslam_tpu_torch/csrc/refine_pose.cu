// Gauss-Newton scan refinement (refine_pose, refine_pose_cov,
// refine_pose_cov_two_stage of ops/matching.py), one launch per call,
// rounding as XLA's CPU backend rounds the JAX package's program.
//
// Replaces: no Pallas kernel. It takes the place of the XLA programs
// jit(refine_pose_cov) and jit(refine_pose_cov_two_stage) of
// sparse_gslam_tpu/ops/matching.py:545-747, which the port ran as ~100
// eager torch launches per Gauss-Newton iteration.
//
// Design: one block per refinement problem, one thread per padded query
// point (N = 256 or 512). Each thread computes its residual and its
// three Jacobian entries (16 bicubic taps read from the float32 grid in
// device memory) into shared memory; the reductions then run in exactly
// the order of XLA's CPU code: one thread per entry of J^T J walking
// the N + 3 rows as one FMA chain, 24 threads for the eight lanes of
// the J^T r gemv, one thread per 32-element window of the sum of
// squares. Thread 0 runs the 3x3 sgetrf/strsm solve, the accept test
// and, at the end, the ssyevd of the covariance. All of it is the block
// program in refine_pose_exact.cuh, which the host build runs as well.
// Built with --fmad=false: nvcc contracts nothing, and every FMA of
// XLA's program is an explicit fmaf in the header.
//
// Bound: latency. Per call ~22 evaluations of N points x 16 taps (a few
// MB of L2 reads), but 10 sequential iterations per stage, each a chain
// of N + 3 dependent FMAs through shared memory and a serial 3x3 solve;
// the card is idle but for one block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "refine_pose_exact.cuh"

namespace {

struct DeviceExec {
  template <class F>
  __host__ __device__ void each(F&& f) {
#ifdef __CUDA_ARCH__
    f((int)threadIdx.x);
#endif
  }
  __host__ __device__ void sync() {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

__global__ void __launch_bounds__(rpx::NMAX)
    refine_pose_kernel(const float* g0, int size0, const float* origin0,
                       float res0, const float* g1, int size1,
                       const float* origin1, float res1, int stages,
                       const float* pts, const uint8_t* valid,
                       const float* init, const float* y0, int n,
                       int iterations, int want_cov, float* pose,
                       float* cov, float* probs) {
  __shared__ rpx::Shared sh;
  const int b = blockIdx.x;
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
  DeviceExec ex;
  rpx::refine_block(ex, P, sh);
}

__global__ void sincosf_kernel(uint32_t start, uint32_t step, uint64_t n,
                               float* sin_out, float* cos_out) {
  const uint64_t k = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * n) return;
  const uint32_t bits = (start + (uint32_t)((k % n) * step)) |
                        (k >= n ? 0x80000000u : 0u);
  float y;
  memcpy(&y, &bits, 4);
  sin_out[k] = rpx::glibc_sincosf(y, 0);
  cos_out[k] = rpx::glibc_sincosf(y, 1);
}

}  // namespace

// The header's sinf/cosf on the card for the float32 bit patterns
// start, start + step, ... below end, positive then negative (the
// layout rpx_libm_mismatches of the host build reads), into
// 2 * ceil((end - start) / step) floats each.
extern "C" int rpx_sincosf_launch(uint32_t start, uint32_t end,
                                  uint32_t step, float* sin_out,
                                  float* cos_out, void* stream) {
  if (end <= start || step == 0) return (int)cudaErrorInvalidValue;
  const uint64_t n = ((uint64_t)end - start + step - 1) / step;
  const unsigned blocks = (unsigned)((2 * n + 255) / 256);
  sincosf_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      start, step, n, sin_out, cos_out);
  return (int)cudaGetLastError();
}

// One launch of `batch` blocks on `stream`. Returns 0 or a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int refine_pose_launch(
    const float* g0, int size0, const float* origin0, float res0,
    const float* g1, int size1, const float* origin1, float res1,
    int stages, const float* pts, const uint8_t* valid, const float* init,
    const float* y0, int batch, int n, int iterations, int want_cov,
    float* pose, float* cov, float* probs, void* stream) {
  if (!rpx::takes_points(n) || batch < 1 ||
      (stages != 1 && stages != 2) || iterations < 0)
    return (int)cudaErrorInvalidValue;
  refine_pose_kernel<<<batch, n, 0, (cudaStream_t)stream>>>(
      g0, size0, origin0, res0, g1, size1, origin1, res1, stages, pts,
      valid, init, y0, n, iterations, want_cov, pose, cov, probs);
  return (int)cudaGetLastError();
}
