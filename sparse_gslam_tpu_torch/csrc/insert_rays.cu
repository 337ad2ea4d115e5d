// Occupancy-grid ray insertion for Hopper (sm_90a).
//
// Replaces the TPU kernel sparse_gslam_tpu/ops/grid_pallas.py:
// insert_rays_pallas (body _insert_kernel). Computes exactly what
// sparse_gslam_tpu/ops/grid.py:insert_rays computes, bit for bit:
// S scans of B beams are inserted into one (G, G) float32 probability
// grid, scans in order. Per scan:
//   - a hit (kind 1) odds-updates its endpoint cell with hit_p;
//   - every valid beam (kind 1 or 2) samples n_steps points at
//     t = (k + 0.5) / n_steps from the scan origin; each sampled cell
//     gets a miss_p update, except a hit's own endpoint cell;
//   - each cell is updated at most once per scan, and a hit beats a
//     miss;
//   - an unknown cell (0) takes p_obs, a known one becomes
//     clip(odds^-1(odds(p_obs) * odds(p)), 0.1, 0.9).
//
// Design. One block of threads loops over the scans in order (the
// TPU's sequential grid dimension becomes this loop). Within a scan the
// threads split the B hits, then the B * n_steps miss samples. Cells
// are claimed through an int32 stamp plane (zeroed by the caller): the
// hit phase raises a cell's stamp to 2s+2 with atomicMax and the one
// thread that raised it applies the hit; after __syncthreads() the miss
// phase does the same with 2s+1, so a cell hit in this scan is never
// updated as a miss, and a cell sampled by many rays is updated once.
// A cell's new value depends only on its old value and p_obs, so the
// result does not depend on which thread wins the claim.
//
// Arithmetic follows the reference maps bit for bit, as XLA's CPU
// backend computes sparse_gslam_tpu/ops/grid.py:insert_rays: the
// division by the resolution becomes a product with its float32
// reciprocal, t = (k + 0.5) / n_steps is rounded to float, the ray
// point s + (e - s) * t is one fused multiply-add, and the odds update
// is not contracted. Every operation is an explicit round-to-nearest
// intrinsic so nvcc neither fuses nor reorders anything else; the
// plain twin (ops/grid.py:insert_rays_plain) does the same on the CPU.
// Build without --use_fast_math.
//
// What bounds it on the card: the sequential dependence between scans,
// not bytes or operations. It runs on one SM; the (G, G) grid plus the
// stamp plane is 0.8 MB at G = 320 and 32 MB at G = 2048, resident in
// the 50 MB L2. Spreading one scan over many blocks with a grid-wide
// barrier is the next step for speed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ int cell_of(float x, float o, float inv_res) {
  return (int)floorf(__fmul_rn(__fsub_rn(x, o), inv_res));
}

__device__ __forceinline__ void odds_update(float* p_cell, float p_obs) {
  const float p = *p_cell;
  float out = p_obs;
  if (p > 0.0f) {
    const float o = __fmul_rn(__fdiv_rn(p_obs, __fsub_rn(1.0f, p_obs)),
                              __fdiv_rn(p, __fsub_rn(1.0f, p)));
    const float np = __fdiv_rn(o, __fadd_rn(1.0f, o));
    out = fminf(0.9f, fmaxf(0.1f, np));
  }
  *p_cell = out;
}

__global__ void __launch_bounds__(kThreads)
insert_rays_kernel(float* __restrict__ probs, int* __restrict__ stamp,
                   const float* __restrict__ origin,
                   const float* __restrict__ scan_origins,
                   const float* __restrict__ scan_points,
                   const int8_t* __restrict__ scan_kind,
                   const float* __restrict__ hit_miss_p, float res,
                   int n_scans, int n_beams, int n_steps, int size) {
  const float ox = origin[0];
  const float oy = origin[1];
  const float hit_p = hit_miss_p[0];
  const float miss_p = hit_miss_p[1];
  const float inv_res = __fdiv_rn(1.0f, res);
  const float steps = (float)n_steps;

  for (int s = 0; s < n_scans; ++s) {
    const float* pts = scan_points + (size_t)s * n_beams * 2;
    const int8_t* kind = scan_kind + (size_t)s * n_beams;
    const int hit_stamp = 2 * s + 2;
    const int miss_stamp = 2 * s + 1;

    // phase 1: hit endpoints
    for (int b = threadIdx.x; b < n_beams; b += blockDim.x) {
      if (kind[b] != 1) continue;
      const int cx = cell_of(pts[2 * b], ox, inv_res);
      const int cy = cell_of(pts[2 * b + 1], oy, inv_res);
      if (cx < 0 || cx >= size || cy < 0 || cy >= size) continue;
      const int c = cx * size + cy;
      if (atomicMax(&stamp[c], hit_stamp) < hit_stamp)
        odds_update(&probs[c], hit_p);
    }
    __syncthreads();

    // phase 2: miss samples along every valid ray
    const float sx = scan_origins[2 * s];
    const float sy = scan_origins[2 * s + 1];
    const int n_samples = n_beams * n_steps;
    for (int i = threadIdx.x; i < n_samples; i += blockDim.x) {
      const int b = i / n_steps;
      const int k = i - b * n_steps;
      const int kb = kind[b];
      if (kb == 0) continue;
      const float ex = pts[2 * b];
      const float ey = pts[2 * b + 1];
      const float t = __fdiv_rn((float)k + 0.5f, steps);
      const float px = __fmaf_rn(__fsub_rn(ex, sx), t, sx);
      const float py = __fmaf_rn(__fsub_rn(ey, sy), t, sy);
      const int cx = cell_of(px, ox, inv_res);
      const int cy = cell_of(py, oy, inv_res);
      if (kb == 1 && cx == cell_of(ex, ox, inv_res) &&
          cy == cell_of(ey, oy, inv_res))
        continue;  // a hit's own endpoint cell
      if (cx < 0 || cx >= size || cy < 0 || cy >= size) continue;
      const int c = cx * size + cy;
      if (atomicMax(&stamp[c], miss_stamp) < miss_stamp)
        odds_update(&probs[c], miss_p);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int insert_rays_launch(void* probs, void* stamp, const void* origin,
                                  const void* scan_origins,
                                  const void* scan_points,
                                  const void* scan_kind,
                                  const void* hit_miss_p, float res,
                                  int n_scans, int n_beams, int n_steps,
                                  int size, void* stream) {
  insert_rays_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)probs, (int*)stamp, (const float*)origin,
      (const float*)scan_origins, (const float*)scan_points,
      (const int8_t*)scan_kind, (const float*)hit_miss_p, res, n_scans,
      n_beams, n_steps, size);
  return (int)cudaGetLastError();
}
