// The tiled insertion of insert_rays.cu on the host: the same tiles,
// windows of screened scans, chunks of listed scans, event words and
// replay, with the block's threads run one after another. It exists so
// that the CPU tests (tests/test_torch_insert_tiles.py) can hold the
// tiled algorithm and the ray-to-tile clip against the plain version
// without a card. Build with
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libinsert_rays_host.so insert_rays_host.cpp
#include <stdint.h>

#include <algorithm>
#include <vector>

#include "insert_rays_tile.cuh"

namespace {

// The events that one beam of one scan raises in the tile, as bit `bit`
// of the tile's event words: a hit (kind 1) marks its endpoint cell in
// hit_words; a valid beam (kind 1 or 2) marks in miss_words the cell of
// each of its samples, except a hit's own endpoint cell.
void beam_events(const sg::Params& q, const sg::Tile& tile, uint32_t bit,
                 float sx, float sy, float ex, float ey, int kind,
                 const float* ts, int n_ts, uint32_t* hit_words,
                 uint32_t* miss_words) {
  sg::Ray r;
  const int n =
      sg::beam_start(q, tile, bit, sx, sy, ex, ey, kind, hit_words, &r);
  for (int k = r.k0; k < r.k0 + n; ++k)
    sg::sample_event(q, tile, r, k, bit, ts, n_ts, miss_words);
}

// Whether scan s can raise an event in the tile: one of its beams may
// touch it. A tile may skip a scan that fails this.
bool scan_may_touch(const sg::Params& q, const sg::Tile& tile,
                    const float* scan_origins, const float* scan_points,
                    const int8_t* scan_kind, int s, int n_beams) {
  for (int b = 0; b < n_beams; ++b) {
    const size_t sb = (size_t)s * n_beams + b;
    if (sg::beam_may_touch(q, tile, scan_origins[2 * s],
                           scan_origins[2 * s + 1], scan_points[2 * sb],
                           scan_points[2 * sb + 1], scan_kind[sb]))
      return true;
  }
  return false;
}

}  // namespace

// Same arguments and result as insert_rays_launch, on host memory.
// `listed`, when not null, receives per tile (row-major over the
// ceil(size / tile)^2 tiles) the number of scans its screen kept.
// Returns 0, or 1 for arguments the kernel does not take.
extern "C" int insert_rays_tiled_host(float* out, const float* probs,
                                      const float* origin,
                                      const float* scan_origins,
                                      const float* scan_points,
                                      const int8_t* scan_kind,
                                      const float* hit_miss_p, float res,
                                      int n_scans, int n_beams, int n_steps,
                                      int size, int tile, int* listed) {
  if (tile < 1 || size < 1 || n_steps < 1) return 1;
  const sg::Params q = sg::make_params(origin, hit_miss_p, res, n_steps);
  float ts[sg::kMaxTable];
  const int n_ts = sg::fill_table(q, ts, 0, 1);
  const int cells = tile * tile;
  std::vector<float> p(cells);
  std::vector<uint32_t> hit_words(cells), miss_words(cells);
  std::vector<int> list;
  int n_tile = 0;
  for (int cx0 = 0; cx0 < size; cx0 += tile) {
    for (int cy0 = 0; cy0 < size; cy0 += tile) {
      const sg::Tile t = {cx0, std::min(cx0 + tile, size), cy0,
                          std::min(cy0 + tile, size), tile};
      for (int cx = t.cx0; cx < t.cx1; ++cx)
        for (int cy = t.cy0; cy < t.cy1; ++cy)
          p[t.local(cx, cy)] = probs[(size_t)cx * size + cy];
      if (listed) listed[n_tile] = 0;
      for (int w0 = 0; w0 < n_scans; w0 += sg::kScansPerWindow) {
        list.clear();
        for (int s = w0; s < std::min(w0 + sg::kScansPerWindow, n_scans);
             ++s)
          if (scan_may_touch(q, t, scan_origins, scan_points, scan_kind, s,
                             n_beams))
            list.push_back(s);
        const int n_listed = (int)list.size();
        if (listed) listed[n_tile] += n_listed;
        for (int c0 = 0; c0 < n_listed; c0 += sg::kScansPerChunk) {
          std::fill(hit_words.begin(), hit_words.end(), 0u);
          std::fill(miss_words.begin(), miss_words.end(), 0u);
          const int m = std::min(sg::kScansPerChunk, n_listed - c0);
          for (int j = 0; j < m; ++j) {
            const int s = list[c0 + j];
            for (int b = 0; b < n_beams; ++b) {
              const size_t sb = (size_t)s * n_beams + b;
              beam_events(q, t, 1u << j, scan_origins[2 * s],
                          scan_origins[2 * s + 1], scan_points[2 * sb],
                          scan_points[2 * sb + 1], scan_kind[sb], ts, n_ts,
                          hit_words.data(), miss_words.data());
            }
          }
          for (int l = 0; l < cells; ++l)
            p[l] = sg::apply_events(q, p[l], hit_words[l], miss_words[l]);
        }
      }
      for (int cx = t.cx0; cx < t.cx1; ++cx)
        for (int cy = t.cy0; cy < t.cy1; ++cy)
          out[(size_t)cx * size + cy] = p[t.local(cx, cy)];
      ++n_tile;
    }
  }
  return 0;
}

// The clip of n rays against n tiles: for ray i, s = seg[4i..4i+1],
// e = seg[4i+2..4i+3], and tile cells [box[4i], box[4i+1]) x
// [box[4i+2], box[4i+3]); writes the step range to k[2i], k[2i+1]
// (k[2i] > k[2i+1] when no sample can fall in the tile).
extern "C" void ray_tile_steps_host(int n, const float* seg, const int* box,
                                    const float* origin, float res,
                                    int n_steps, int* k) {
  const float hit_miss_p[2] = {0.5f, 0.5f};
  const sg::Params q = sg::make_params(origin, hit_miss_p, res, n_steps);
  for (int i = 0; i < n; ++i) {
    const sg::Tile t = {box[4 * i], box[4 * i + 1], box[4 * i + 2],
                        box[4 * i + 3], 1};
    const float sx = seg[4 * i], sy = seg[4 * i + 1];
    int k0 = 1, k1 = 0;
    sg::ray_tile_steps(q, t, sx, sy, sg::f_sub(seg[4 * i + 2], sx),
                       sg::f_sub(seg[4 * i + 3], sy), &k0, &k1);
    k[2 * i] = k0;
    k[2 * i + 1] = k1;
  }
}
