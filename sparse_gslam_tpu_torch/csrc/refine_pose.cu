// Gauss-Newton scan refinement (refine_pose, refine_pose_cov,
// refine_pose_cov_two_stage of ops/matching.py), one launch per call,
// rounding as XLA's CPU backend rounds the JAX package's program.
//
// Replaces: no Pallas kernel. It takes the place of the XLA programs
// jit(refine_pose_cov) and jit(refine_pose_cov_two_stage) of
// sparse_gslam_tpu/ops/matching.py:545-747, which the port ran as ~100
// eager torch launches per Gauss-Newton iteration.
//
// refine_pins_launch is the batched mode for the device pin batches
// (ops/matching.py pin_eval_batch; the JAX program refines them under
// jax.vmap, sparse_gslam_tpu/ops/matching.py:834-868): one launch per
// batch, one block per pin, each against its own grid of a stack, in
// the vmapped program's arithmetic (the header's GridRef::vmapped).
//
// Design: one block per refinement problem, a fixed block of T = 512
// threads (rpx::THREADS) whatever the padded point count (N = 256 * 2^k,
// the sizes the callers pad to, up to rpx::N_LIMIT). Thread tid owns
// points tid, tid + T, ...: reads of points and mask are coalesced. Each
// GN step evaluates the rows and Jacobian once, at the trial pose (16
// bicubic taps per point from the float32 grid in device memory), into
// J's three columns and r, 16 (N + 4) bytes: up to N = 8192 (131 KB) in
// dynamic shared memory; above it (262 KB at 16384, more than a block
// has) in a per-problem global scratch buffer that stays in L2, from
// which one producer thread stages them, 1024 rows at a time, into a
// ring of four 16 KB shared-memory slots with bulk asynchronous copies
// (TMA, cp.async.bulk, counted on mbarriers), so that the readers below
// keep their 128-bit shared loads (refine_pose_exact.cuh,
// reduce_rows_staged). The reductions then run in exactly the order of
// XLA's CPU code: one thread per J^T J entry (six, mirrored) walking the
// N + 3 rows as one FMA chain, one per entry of the J^T r gemv (its
// eight lanes and remainder), the other threads the sum of squares'
// 32-element windows; all read the rows four floats at a time. Thread 0 runs the accept test, the 3x3
// sgetrf/strsm solve with the next trial's sinf/cosf and, at the end,
// the ssyevd of the covariance. A stage ends when a trial is rejected or
// kept unchanged, where every later JAX step repeats itself (the header
// says why). All of it is the block program in refine_pose_exact.cuh,
// which the host build runs as well. Built with --fmad=false: nvcc
// contracts nothing, and every FMA of XLA's program is an explicit fmaf
// in the header.
//
// Bound: latency. XLA's order makes each J^T J entry a chain of N + 3
// dependent FMAs per GN step (4 cycles each), and the solve a serial
// scalar 3x3 factorisation; the bytes (a few thousand grid cells) and
// the operations are microseconds below that. The design keeps the chain
// fed (128-bit loads, 32 terms ahead of its FMAs: scalar loads, two per
// term, cost 11-17 cycles a term on an H100), evaluates once per step
// instead of twice, and stops at the first step that repeats; one block
// per problem leaves the card idle but for one SM. The staged rows add
// the scratch's writes and the ring's copies, both in L2 and both off
// the chain's path once the ring runs ahead of it.
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

// Block b's rows and window sums (P.win), and with kStaged its ring:
// the dynamic shared memory `smem` holds the rows and window sums, or
// with kStaged the ring's slots, the rows and window sums then being
// the problem's part of `scratch`
template <bool kStaged>
__device__ float* block_rows(float* smem, float* scratch, int n,
                             uint64_t* bars, rpx::Problem* P,
                             rpx::Ring* ring) {
  float* rows = smem;
  if (kStaged) {
    rows = scratch + (size_t)blockIdx.x * rpx::scratch_floats(n);
#ifdef __CUDA_ARCH__  // (the header's mbarrier helpers are device code)
    if (rpx::STAGE_ROWS) {
      *ring = {smem, bars, bars + rpx::RING_SLOTS};
      if (threadIdx.x == 0) {
        for (int s = 0; s < rpx::RING_SLOTS; ++s) {
          rpx::mbar_init(ring->full + s, 1);
          rpx::mbar_init(ring->empty + s, rpx::RING_READERS);
        }
        rpx::mbar_fence_init();
      }
      __syncthreads();
    }
#endif
  }
  P->win = rows + 4 * rpx::column_stride(n);
  return rows;
}

template <bool kStaged>
__global__ void __launch_bounds__(rpx::THREADS)
    refine_pose_kernel(const float* g0, int size0, const float* origin0,
                       float res0, const float* g1, int size1,
                       const float* origin1, float res1, int stages,
                       const float* pts, const uint8_t* valid,
                       const float* init, const float* y0, int n,
                       int iterations, int want_cov, float* pose,
                       float* cov, float* probs, int* iters,
                       float* scratch) {
  extern __shared__ float4 smem4[];  // 16-byte aligned: rpx::load4, TMA
  __shared__ rpx::Shared sh;
  __shared__ uint64_t bars[2 * rpx::RING_SLOTS];
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
  P.iters_out = iters + 2 * b;
  rpx::Ring ring;
  float* rows = block_rows<kStaged>(reinterpret_cast<float*>(smem4),
                                    scratch, n, bars, &P, &ring);
  DeviceExec ex;
  rpx::refine_block<kStaged>(ex, P, sh, rows, ring);
}

// The device pin batches (matching.pin_eval_batch): block b refines pin
// b against grid ids[b] of the (M, size, size) stack, one stage with
// its covariance, in the vmapped program's arithmetic (GridRef::vmapped)
template <bool kStaged>
__global__ void __launch_bounds__(rpx::THREADS)
    refine_pins_kernel(const float* grids, int size, const float* origins,
                       const int* ids, float res, const float* pts,
                       const uint8_t* valid, const float* init,
                       const float* y0, int n, int iterations, float* pose,
                       float* cov, float* probs, int* iters,
                       float* scratch) {
  extern __shared__ float4 smem4[];  // 16-byte aligned: rpx::load4, TMA
  __shared__ rpx::Shared sh;
  __shared__ uint64_t bars[2 * rpx::RING_SLOTS];
  const int b = blockIdx.x;
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
  rpx::Ring ring;
  float* rows = block_rows<kStaged>(reinterpret_cast<float*>(smem4),
                                    scratch, n, bars, &P, &ring);
  DeviceExec ex;
  rpx::refine_block<kStaged>(ex, P, sh, rows, ring);
}

// The dynamic shared memory of a launch at n points: the rows and window
// sums, or the ring for staged rows
int launch_smem(int n) {
  return rpx::staged_rows(n) ? rpx::ring_bytes() : rpx::shared_rows_bytes(n);
}

// Sets the kernel's dynamic shared memory to `smem` bytes and launches it
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), int batch, int smem, void* stream,
           Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, rpx::THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
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

// One launch of `batch` blocks of rpx::THREADS threads on `stream`; iters
// receives the GN steps each problem's stages ran ((batch, 2) ints).
// Above rpx::SMEM_ROWS_MAX points `scratch` holds batch *
// refine_pose_scratch_floats(n) floats (16-byte aligned), the problems'
// rows. Returns 0 or a cudaError_t (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int refine_pose_launch(
    const float* g0, int size0, const float* origin0, float res0,
    const float* g1, int size1, const float* origin1, float res1,
    int stages, const float* pts, const uint8_t* valid, const float* init,
    const float* y0, int batch, int n, int iterations, int want_cov,
    float* pose, float* cov, float* probs, int* iters, float* scratch,
    void* stream) {
  if (!rpx::takes_points(n) || batch < 1 ||
      (stages != 1 && stages != 2) || iterations < 0 ||
      (rpx::staged_rows(n) && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch(rpx::staged_rows(n) ? refine_pose_kernel<true>
                                    : refine_pose_kernel<false>,
                batch, launch_smem(n), stream, g0, size0, origin0, res0, g1,
                size1, origin1, res1, stages, pts, valid, init, y0, n,
                iterations, want_cov, pose, cov, probs, iters, scratch);
}

// The floats of scratch one problem of n points takes (0: its rows are
// in shared memory), or -1 for an n the kernel does not take
extern "C" long long refine_pose_scratch_floats(int n) {
  if (!rpx::takes_points(n)) return -1;
  return rpx::staged_rows(n) ? rpx::scratch_floats(n) : 0;
}

// One launch for a batch of pins: `batch` blocks of rpx::THREADS threads
// on `stream`, block b refining pin b (points, mask and initial pose
// (batch, n, 2), (batch, n), (batch, 3)) against grid ids[b] of the
// (M, size, size) stack with origins (M, 2), as refine_pins_kernel; the
// scratch as refine_pose_launch's. Returns 0 or a cudaError_t.
extern "C" int refine_pins_launch(
    const float* grids, int size, const float* origins, const int* ids,
    float res, const float* pts, const uint8_t* valid, const float* init,
    const float* y0, int batch, int n, int iterations, float* pose,
    float* cov, float* probs, int* iters, float* scratch, void* stream) {
  if (!rpx::takes_points(n) || batch < 1 || iterations < 0 ||
      (rpx::staged_rows(n) && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch(rpx::staged_rows(n) ? refine_pins_kernel<true>
                                    : refine_pins_kernel<false>,
                batch, launch_smem(n), stream, grids, size, origins, ids,
                res, pts, valid, init, y0, n, iterations, pose, cov, probs,
                iters, scratch);
}
