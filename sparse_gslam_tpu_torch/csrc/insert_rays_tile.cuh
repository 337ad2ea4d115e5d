// The per-cell arithmetic, the per-beam event rule and the ray-to-tile
// clip of the tiled occupancy-grid insertion (insert_rays.cu), written
// once for the card and the host. nvcc compiles it into the kernel; g++
// compiles it into the host shim (insert_rays_host.cpp) that runs the
// same tiled algorithm on the CPU.
//
// Every float operation is rounded once to nearest: on the card through
// the __*_rn intrinsics, which nvcc neither fuses nor reorders; on the
// host as plain IEEE float arithmetic and std::fmaf, built with
// -ffp-contract=off. Either way the result equals
// ops/grid.py:insert_rays_plain bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>

#include <cmath>

#ifdef __CUDACC__
#define SG_HD __host__ __device__ __forceinline__
#else
#define SG_HD inline
#endif

namespace sg {

// Scans whose events one pass of a tile gathers: one bit per scan in a
// uint32 event word.
constexpr int kScansPerChunk = 32;
// Scans a tile screens at a time (one per thread of a block) for the
// list of those that can touch it.
constexpr int kScansPerWindow = 512;

SG_HD float f_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

SG_HD float f_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

SG_HD float f_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

SG_HD float f_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// a * b + c, rounded once
SG_HD float f_fma(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return std::fmaf(a, b, c);
#endif
}

SG_HD void or_bit(uint32_t* word, uint32_t bit) {
#ifdef __CUDA_ARCH__
  atomicOr(word, bit);
#else
  *word |= bit;
#endif
}

// floor((x - o) / res) as XLA's CPU backend computes it: times the
// float32 reciprocal of the resolution
SG_HD int cell_of(float x, float o, float inv_res) {
  return (int)floorf(f_mul(f_sub(x, o), inv_res));
}

// t of sample k of n_steps along a ray: (k + 0.5) / n_steps
SG_HD float sample_t(int k, float steps) {
  return f_div(f_add((float)k, 0.5f), steps);
}

// The odds update of one cell by an observation p_obs, whose odds
// p_obs / (1 - p_obs) are odds_obs: an unknown cell (0) takes p_obs, a
// known one odds^-1(odds_obs * odds(p)) clamped to [0.1, 0.9].
SG_HD float odds_update(float p, float p_obs, float odds_obs) {
  if (!(p > 0.0f)) return p_obs;
  const float o = f_mul(odds_obs, f_div(p, f_sub(1.0f, p)));
  return fminf(0.9f, fmaxf(0.1f, f_div(o, f_add(1.0f, o))));
}

// What every tile of one insertion shares.
struct Params {
  float ox, oy;      // world position of cell (0, 0)'s corner
  float inv_res;     // float32 reciprocal of the resolution
  float steps;       // n_steps as a float
  int n_steps;
  float hit_p, odds_hit, miss_p, odds_miss;
};

SG_HD Params make_params(const float* origin, const float* hit_miss_p,
                         float res, int n_steps) {
  Params q;
  q.ox = origin[0];
  q.oy = origin[1];
  q.inv_res = f_div(1.0f, res);
  q.steps = (float)n_steps;
  q.n_steps = n_steps;
  q.hit_p = hit_miss_p[0];
  q.miss_p = hit_miss_p[1];
  q.odds_hit = f_div(q.hit_p, f_sub(1.0f, q.hit_p));
  q.odds_miss = f_div(q.miss_p, f_sub(1.0f, q.miss_p));
  return q;
}

// Cells [cx0, cx1) x [cy0, cy1) of the grid; cell (cx, cy) has the
// local index (cx - cx0) * stride + (cy - cy0).
struct Tile {
  int cx0, cx1, cy0, cy1, stride;

  SG_HD bool holds(int cx, int cy) const {
    return cx >= cx0 && cx < cx1 && cy >= cy0 && cy < cy1;
  }
  SG_HD int local(int cx, int cy) const {
    return (cx - cx0) * stride + (cy - cy0);
  }
};

// Narrows [*tlo, *thi] to the t where u0 + du * t lies in [lo, hi].
SG_HD void clip_axis(double u0, double du, double lo, double hi,
                     double* tlo, double* thi) {
  if (du == 0.0) {
    if (u0 < lo || u0 > hi) {
      *tlo = 1.0;
      *thi = 0.0;
    }
    return;
  }
  double ta = (lo - u0) / du;
  double tb = (hi - u0) / du;
  if (ta > tb) {
    const double x = ta;
    ta = tb;
    tb = x;
  }
  if (ta > *tlo) *tlo = ta;
  if (tb < *thi) *thi = tb;
}

// Whether the bounding box of the segment from s along d = e - s, in
// float32 cell coordinates, comes within one cell of the tile. Most
// beams fail this cheaply; ray_tile_steps finds no sample for one that
// does.
SG_HD bool segment_near_tile(const Params& q, const Tile& tile, float sx,
                             float sy, float dx, float dy) {
  const float ux0 = f_mul(f_sub(sx, q.ox), q.inv_res);
  const float ux1 = f_mul(f_sub(f_add(sx, dx), q.ox), q.inv_res);
  const float uy0 = f_mul(f_sub(sy, q.oy), q.inv_res);
  const float uy1 = f_mul(f_sub(f_add(sy, dy), q.oy), q.inv_res);
  return !(fmaxf(ux0, ux1) < tile.cx0 - 1.0f ||
           fminf(ux0, ux1) > tile.cx1 + 1.0f ||
           fmaxf(uy0, uy1) < tile.cy0 - 1.0f ||
           fminf(uy0, uy1) > tile.cy1 + 1.0f);
}

// A range [*k0, *k1] of sample steps that holds every k whose sample
// s + d * t_k (d = e - s in float) falls in a cell of the tile; false
// when no sample can. Conservative: the segment is clipped in float64
// cell coordinates against the tile widened by one cell on every side,
// which covers the float32 rounding of the sample and of its cell
// (a small fraction of a cell while coordinates stay far below 2^22
// cells), and the range is widened by one step at each end, which
// covers the rounding of t_k.
SG_HD bool ray_tile_steps(const Params& q, const Tile& tile, float sx,
                          float sy, float dx, float dy, int* k0, int* k1) {
  if (!segment_near_tile(q, tile, sx, sy, dx, dy)) return false;
  double tlo = 0.0, thi = 1.0;
  clip_axis(((double)sx - q.ox) * q.inv_res, (double)dx * q.inv_res,
            tile.cx0 - 1.0, tile.cx1 + 1.0, &tlo, &thi);
  clip_axis(((double)sy - q.oy) * q.inv_res, (double)dy * q.inv_res,
            tile.cy0 - 1.0, tile.cy1 + 1.0, &tlo, &thi);
  if (!(tlo <= thi)) return false;
  const int a = (int)floor(tlo * q.n_steps - 0.5) - 1;
  const int b = (int)ceil(thi * q.n_steps - 0.5) + 1;
  *k0 = a < 0 ? 0 : a;
  *k1 = b > q.n_steps - 1 ? q.n_steps - 1 : b;
  return *k0 <= *k1;
}

// Sample t of the first kMaxTable steps, looked up rather than divided.
constexpr int kMaxTable = 256;

SG_HD int fill_table(const Params& q, float* ts, int first, int stride) {
  const int n = q.n_steps < kMaxTable ? q.n_steps : kMaxTable;
  for (int k = first; k < n; k += stride) ts[k] = sample_t(k, q.steps);
  return n;
}

// One valid beam as a tile sees it: the segment from (sx, sy) along
// (dx, dy), the endpoint cell (hx, hy) of a hit, (-1, -1) for a miss (no
// tile holds a negative cell), and its candidate sample steps [k0, k1].
struct Ray {
  float sx, sy, dx, dy;
  int hx, hy, k0, k1;
};

// Starts one beam of one scan in the tile: a hit (kind 1) marks its
// endpoint cell as bit `bit` of hit_words. Returns the number of
// candidate samples, k1 - k0 + 1, of a valid beam (kind 1 or 2) near the
// tile, and 0 for any other beam.
SG_HD int beam_start(const Params& q, const Tile& tile, uint32_t bit,
                     float sx, float sy, float ex, float ey, int kind,
                     uint32_t* hit_words, Ray* r) {
  if (kind <= 0) return 0;
  const bool hit = kind == 1;
  const int hx = cell_of(ex, q.ox, q.inv_res);
  const int hy = cell_of(ey, q.oy, q.inv_res);
  if (hit && tile.holds(hx, hy)) or_bit(&hit_words[tile.local(hx, hy)], bit);
  r->sx = sx;
  r->sy = sy;
  r->dx = f_sub(ex, sx);
  r->dy = f_sub(ey, sy);
  r->hx = hit ? hx : -1;
  r->hy = hit ? hy : -1;
  if (!ray_tile_steps(q, tile, sx, sy, r->dx, r->dy, &r->k0, &r->k1))
    return 0;
  return r->k1 - r->k0 + 1;
}

// The miss event of sample k of ray r: its cell, computed as the plain
// version computes it, is marked as bit `bit` of miss_words if the tile
// holds it and it is not the hit's endpoint cell. ts[k] holds
// sample_t(k) for k < n_ts.
SG_HD void sample_event(const Params& q, const Tile& tile, const Ray& r,
                        int k, uint32_t bit, const float* ts, int n_ts,
                        uint32_t* miss_words) {
  const float t = k < n_ts ? ts[k] : sample_t(k, q.steps);
  const int cx = cell_of(f_fma(r.dx, t, r.sx), q.ox, q.inv_res);
  const int cy = cell_of(f_fma(r.dy, t, r.sy), q.oy, q.inv_res);
  if (tile.holds(cx, cy) && !(cx == r.hx && cy == r.hy))
    or_bit(&miss_words[tile.local(cx, cy)], bit);
}

// Whether a beam can raise an event in the tile: a hit (kind 1) in a
// cell of the tile, or a valid beam whose segment comes near it.
// beam_start finds no event for a beam that fails this.
SG_HD bool beam_may_touch(const Params& q, const Tile& tile, float sx,
                          float sy, float ex, float ey, int kind) {
  if (kind <= 0) return false;
  if (kind == 1 && tile.holds(cell_of(ex, q.ox, q.inv_res),
                              cell_of(ey, q.oy, q.inv_res)))
    return true;
  return segment_near_tile(q, tile, sx, sy, f_sub(ex, sx), f_sub(ey, sy));
}

// One cell's updates from the events of one chunk of scans, in scan
// order (low bit first): once per scan, and a hit beats a miss.
SG_HD float apply_events(const Params& q, float p, uint32_t hits,
                         uint32_t misses) {
  for (uint32_t ev = hits | misses; ev != 0u; ev &= ev - 1u) {
    p = (hits & ev & (0u - ev)) ? odds_update(p, q.hit_p, q.odds_hit)
                                : odds_update(p, q.miss_p, q.odds_miss);
  }
  return p;
}

}  // namespace sg
