// The pin window correlation's arithmetic (ops/matching.py
// correlate_window_host), shared by the CUDA kernel (pin_window.cu) and
// its host build (pin_window_host.cpp).
//
// One output of the (R, W, W) volume is the mean of the score grid at the
// query's cells shifted by (dx, dy) = (i - n_linear, j - n_linear), PMIN
// where a shifted cell leaves the grid. numpy's mean over the point axis
// of the (R, N, W, W) gather adds the N values one after another in
// float64, from the first, then divides by N: window_sum adds them in that
// order from 0.0 (0.0 + v is v for the grid's values, all >= 0), so the
// volume is numpy's bit for bit. Nothing here multiplies, so
// no contraction can change a bit; both builds still turn contraction off.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define PWX_HD __host__ __device__ __forceinline__
#else
#define PWX_HD inline
#endif

namespace pwx {

// acc plus the grid values at the cells (cx[k] + dx, cy[k] + dy), k = 0 ..
// n - 1, added in order in float64; the (size, size) float32 grid is
// indexed [x, y] with y contiguous
PWX_HD double window_sum(const float* grid, int size, const int32_t* cx,
                         const int32_t* cy, int n, int dx, int dy,
                         double pmin, double acc) {
  for (int k = 0; k < n; ++k) {
    const int gx = cx[k] + dx;
    const int gy = cy[k] + dy;
    const bool in = gx >= 0 && gx < size && gy >= 0 && gy < size;
    acc += in ? (double)grid[(int64_t)gx * size + gy] : pmin;
  }
  return acc;
}

// Whether the entry points take these sizes: cells stay within
// [-n_linear - 1, size + n_linear] (the caller clips them there), so no
// shifted index overflows an int
PWX_HD bool takes(int size, int rotations, int n, int w) {
  return size >= 1 && size <= (1 << 20) && rotations >= 1 && n >= 1 &&
         w >= 1 && (w & 1) == 1 && w <= 1025;
}

}  // namespace pwx
