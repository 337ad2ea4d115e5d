// The host pins' window correlation (ops/matching.py correlate_window,
// called by models/backend.py _pin_match_grid and refine_map): the
// (rotation x offset) score volume of one query against one submap's
// float32 score grid on the card, bit-equal to correlate_window_host's
// numpy gathers.
//
// Replaces: no Pallas kernel. The JAX package scores these windows with
// numpy on the host (sparse_gslam_tpu/ops/matching.py
// correlate_window_host), and so did the port: ~10 M float64 gathers a
// pin, ~0.1 s of the host's time.
//
// Design: block (r, b) takes rotation r and the outputs o = b * blockDim
// + threadIdx of the W x W window, o = i * W + j, so that consecutive
// threads own consecutive y offsets and a warp reads runs of contiguous
// grid cells (the grid is [x, y] with y contiguous). The rotation's query
// cells, computed on the host (int32 cx, cy), are staged in shared memory
// CHUNK points at a time; each thread adds its N gathered values in point
// order into one float64 (pin_window.cuh window_sum) and writes acc / N.
//
// Bound: latency. One thread's N float64 adds are a dependent chain (~N x
// 4 cycles); the loads (N x W^2 x R, ~10 M for N = 512, W = 17, R = 65)
// hit a grid of at most a few MB that stays in L2. Built with
// --fmad=false like the refinement; there is nothing to contract.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pin_window.cuh"

namespace {

constexpr int CHUNK = 1024;  // query points staged in shared memory at once
constexpr int MAX_THREADS = 512;

__global__ void pin_window_kernel(const float* __restrict__ grid, int size,
                                  const int32_t* __restrict__ cells,
                                  int rotations, int n, int w, double pmin,
                                  double* __restrict__ out) {
  __shared__ int32_t sx[CHUNK];
  __shared__ int32_t sy[CHUNK];
  const int r = blockIdx.x;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  const int ww = w * w;
  const int n_linear = (w - 1) / 2;
  const int dx = o / w - n_linear;
  const int dy = o % w - n_linear;
  const int32_t* cx = cells + (int64_t)r * n;
  const int32_t* cy = cells + ((int64_t)rotations + r) * n;
  double acc = 0.0;
  for (int lo = 0; lo < n; lo += CHUNK) {
    const int m = min(CHUNK, n - lo);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      sx[k] = cx[lo + k];
      sy[k] = cy[lo + k];
    }
    __syncthreads();
    if (o < ww) acc = pwx::window_sum(grid, size, sx, sy, m, dx, dy, pmin, acc);
  }
  if (o < ww) out[(int64_t)r * ww + o] = acc / (double)n;
}

}  // namespace

// One launch on `stream`: the (rotations, w, w) float64 volume `out` of
// the (size, size) float32 grid at the (2, rotations, n) int32 cells
// (cx then cy, clipped to [-n_linear - 1, size + n_linear]). Returns 0 or
// a cudaError_t (cudaErrorInvalidValue for sizes it does not take).
extern "C" int pin_window_launch(const float* grid, int size,
                                 const int32_t* cells, int rotations, int n,
                                 int w, double pmin, double* out,
                                 void* stream) {
  if (!pwx::takes(size, rotations, n, w)) return (int)cudaErrorInvalidValue;
  const int ww = w * w;
  const int threads = min(MAX_THREADS, (ww + 31) / 32 * 32);
  const dim3 blocks(rotations, (ww + threads - 1) / threads);
  pin_window_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      grid, size, cells, rotations, n, w, pmin, out);
  return (int)cudaGetLastError();
}
