// pin_window.cu's arithmetic on the host: the same header, one output
// after another. The CPU tests (tests/test_torch_pin_window.py) hold it
// bit-equal to ops/matching.py correlate_window_host without a card.
// Build with
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libpin_window_host.so pin_window_host.cpp
#include <stdint.h>

#include "pin_window.cuh"

// pin_window_launch's arguments on host memory; returns 0, or 1 for sizes
// the kernel does not take
extern "C" int pin_window_host(const float* grid, int size,
                               const int32_t* cells, int rotations, int n,
                               int w, double pmin, double* out) {
  if (!pwx::takes(size, rotations, n, w)) return 1;
  const int n_linear = (w - 1) / 2;
  for (int r = 0; r < rotations; ++r) {
    const int32_t* cx = cells + (int64_t)r * n;
    const int32_t* cy = cells + ((int64_t)rotations + r) * n;
    for (int o = 0; o < w * w; ++o) {
      const double acc = pwx::window_sum(grid, size, cx, cy, n,
                                         o / w - n_linear, o % w - n_linear,
                                         pmin, 0.0);
      out[(int64_t)r * w * w + o] = acc / (double)n;
    }
  }
  return 0;
}
