// Occupancy-grid ray insertion for Hopper (sm_90a), one block per tile.
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
// The arithmetic (insert_rays_tile.cuh) copies how XLA's CPU backend
// computes the reference: a product with the float32 reciprocal of the
// resolution, one fused multiply-add for the ray point, an odds update
// that is not contracted. Build without --use_fast_math.
//
// What bounds it on this card. About ten float operations per ray
// sample, so the least time is the bytes: the grid read and written
// once, 0.8 MB at G = 320 (0.25 us at 3.35 TB/s, less than one launch)
// and 33.5 MB at G = 2048 (10 us). The obstacle is order: a cell's
// updates depend on the order of the scans that touch it. Kept for the
// whole grid at once, that order makes every scan a chain of dependent
// steps and barriers on one of 132 SMs. Here it holds only inside a
// tile: at large G the tiles spread the grid's bytes over every SM,
// and at small G each tile's chain is only the scans that touch it,
// 32 to a barrier.
//
// Design. A cell's sequence of updates depends only on the scans that
// touch it, in scan order, so cells in different tiles are independent.
// One block takes one T x T tile (T = 16, 32 or 64): ceil(G/T)^2 blocks,
// each reading its tile of the grid once and writing it once to a
// separate output, untouched cells included, so the caller allocates
// the output and nothing else, and `probs` stays as it was.
//   - Each thread keeps its cells of the tile in registers.
//   - Screen. The block takes the scans 512 at a time; neighbouring
//     threads test neighbouring beams (coalesced reads) and flag the
//     scans with a beam that hits the tile or whose bounding box comes
//     within a cell of it. A ballot and a popcount rank list the flagged
//     scans in scan order (three barriers per window). A scan that
//     cannot touch the tile costs its beams' reads and a few compares.
//   - Gather. The block walks the listed scans in chunks of 32: the
//     threads split a chunk's (scan, beam) pairs and mark events in
//     shared memory: bit j of a cell's hit word (miss word) says that
//     listed scan j hits (misses) the cell. A beam marks its endpoint
//     cell and clips its ray against the tile widened by one cell to a
//     conservative range [k0, k1] of sample steps; a warp then takes
//     its 32 beams one by one and spreads each one's candidate samples
//     over its lanes, so it pays for their sum and not 32 times the
//     longest. Each
//     candidate's cell is computed exactly as the plain version does
//     and kept only if it lies in the tile, so the set of
//     (scan, cell, hit/miss) events is the plain version's.
//   - Replay. One barrier; then each thread applies its cells' events,
//     low bit first: once per scan, a hit before a miss. The event
//     words are double-buffered, so one barrier per chunk orders
//     everything. Two blocks fit on an SM (at most 64 registers).
// What remains. A block's time is its chain of chunks, one barrier and
// one replay per 32 scans that touch its tile. At large G every block
// still reads all S * B beams (from L2) to screen them:
// (G/T)^2 * S * B beam tests.

#include <cuda_runtime.h>
#include <stdint.h>

#include "insert_rays_tile.cuh"

namespace {

constexpr int kThreads = 512;
static_assert(kThreads == sg::kScansPerWindow,
              "a window keeps one scan's flag per thread");

constexpr uint32_t kFullWarp = 0xffffffffu;

// The candidate samples of the warp's rays, n of them on lane's ray r
// (bit `bit`): the warp takes the rays one after another and spreads
// each one's samples over its 32 lanes, so a ray's fields are fetched
// once and a warp pays for the sum of its rays' samples, not 32 times
// the longest.
__device__ __forceinline__ void warp_samples(const sg::Params& q,
                                             const sg::Tile& tile,
                                             const sg::Ray& r, int n,
                                             uint32_t bit, const float* ts,
                                             int n_ts, uint32_t* miss_words,
                                             int lane) {
  for (uint32_t todo = __ballot_sync(kFullWarp, n > 0); todo != 0u;
       todo &= todo - 1u) {
    const int src = __ffs(todo) - 1;
    sg::Ray rs;
    rs.sx = __shfl_sync(kFullWarp, r.sx, src);
    rs.sy = __shfl_sync(kFullWarp, r.sy, src);
    rs.dx = __shfl_sync(kFullWarp, r.dx, src);
    rs.dy = __shfl_sync(kFullWarp, r.dy, src);
    rs.hx = __shfl_sync(kFullWarp, r.hx, src);
    rs.hy = __shfl_sync(kFullWarp, r.hy, src);
    const int k0 = __shfl_sync(kFullWarp, r.k0, src);
    const int k_end = k0 + __shfl_sync(kFullWarp, n, src);
    const uint32_t b = __shfl_sync(kFullWarp, bit, src);
    for (int k = k0 + lane; k < k_end; k += 32)
      sg::sample_event(q, tile, rs, k, b, ts, n_ts, miss_words);
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads, 2)
insert_rays_tiled(float* __restrict__ out, const float* __restrict__ probs,
                  const float* __restrict__ origin,
                  const float* __restrict__ scan_origins,
                  const float* __restrict__ scan_points,
                  const int8_t* __restrict__ scan_kind,
                  const float* __restrict__ hit_miss_p, float res,
                  int n_scans, int n_beams, int n_steps, int size) {
  constexpr int kCells = T * T;
  constexpr int kPerThread = (kCells + kThreads - 1) / kThreads;
  // [2 buffers][hit words, miss words][T * T]
  extern __shared__ uint32_t words[];

  const sg::Params q = sg::make_params(origin, hit_miss_p, res, n_steps);
  sg::Tile tile;
  tile.cx0 = blockIdx.x * T;
  tile.cy0 = blockIdx.y * T;
  tile.cx1 = min(tile.cx0 + T, size);
  tile.cy1 = min(tile.cy0 + T, size);
  tile.stride = T;

  float p[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = threadIdx.x + j * kThreads;
    const int cx = tile.cx0 + l / T;
    const int cy = tile.cy0 + l % T;
    p[j] = (l < kCells && tile.holds(cx, cy))
               ? probs[(size_t)cx * size + cy]
               : 0.0f;
  }
  for (int i = threadIdx.x; i < 4 * kCells; i += kThreads) words[i] = 0u;
  __shared__ float ts[sg::kMaxTable];
  __shared__ uint32_t flags[kThreads / 32];
  __shared__ int list[kThreads];
  __shared__ uint8_t scan_near[kThreads];
  scan_near[threadIdx.x] = 0;
  const int n_ts = sg::fill_table(q, ts, threadIdx.x, kThreads);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  __syncthreads();

  int buf = 0;
  for (int w0 = 0; w0 < n_scans; w0 += kThreads) {
    // screen one window of scans, neighbouring threads on neighbouring
    // beams, and list those that can touch the tile in scan order
    const int n_window = min(kThreads, n_scans - w0) * n_beams;
#pragma unroll 4
    for (int i = threadIdx.x; i < n_window; i += kThreads) {
      const int s = w0 + i / n_beams;
      const size_t sb = (size_t)w0 * n_beams + i;
      if (sg::beam_may_touch(q, tile, scan_origins[2 * s],
                             scan_origins[2 * s + 1], scan_points[2 * sb],
                             scan_points[2 * sb + 1], scan_kind[sb]))
        scan_near[i / n_beams] = 1;
    }
    __syncthreads();
    const bool touches = scan_near[threadIdx.x] != 0;
    scan_near[threadIdx.x] = 0;
    const uint32_t ballot = __ballot_sync(kFullWarp, touches);
    if (lane == 0) flags[warp] = ballot;
    __syncthreads();
    int n_listed = 0, rank = __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = __popc(flags[w]);
      n_listed += c;
      if (w < warp) rank += c;
    }
    if (touches) list[rank] = w0 + threadIdx.x;
    __syncthreads();

    for (int c0 = 0; c0 < n_listed; c0 += sg::kScansPerChunk, buf ^= 1) {
      uint32_t* hit_words = words + buf * 2 * kCells;
      uint32_t* miss_words = hit_words + kCells;
      // bit j of the event words is listed scan c0 + j; neighbouring
      // threads take different scans
      const int m = min(sg::kScansPerChunk, n_listed - c0);
      const int n_pairs = m * n_beams;
      for (int base = warp * 32; base < n_pairs; base += kThreads) {
        const int i = base + lane;
        sg::Ray r = {};
        uint32_t bit = 0u;
        int n = 0;
        if (i < n_pairs) {
          const int j = i % m;
          const int s = list[c0 + j];
          const size_t sb = (size_t)s * n_beams + i / m;
          bit = 1u << j;
          n = sg::beam_start(q, tile, bit, scan_origins[2 * s],
                             scan_origins[2 * s + 1], scan_points[2 * sb],
                             scan_points[2 * sb + 1], scan_kind[sb],
                             hit_words, &r);
        }
        warp_samples(q, tile, r, n, bit, ts, n_ts, miss_words, lane);
      }
      __syncthreads();
      // the other buffer was cleared before this barrier, so the next
      // chunk's events may go there while these are replayed
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int l = threadIdx.x + j * kThreads;
        if (l >= kCells) continue;
        const uint32_t h = hit_words[l];
        const uint32_t mw = miss_words[l];
        if ((h | mw) == 0u) continue;
        p[j] = sg::apply_events(q, p[j], h, mw);
        hit_words[l] = 0u;
        miss_words[l] = 0u;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = threadIdx.x + j * kThreads;
    const int cx = tile.cx0 + l / T;
    const int cy = tile.cy0 + l % T;
    if (l < kCells && tile.holds(cx, cy)) out[(size_t)cx * size + cy] = p[j];
  }
}

template <int T>
int launch(float* out, const float* probs, const float* origin,
           const float* scan_origins, const float* scan_points,
           const int8_t* scan_kind, const float* hit_miss_p, float res,
           int n_scans, int n_beams, int n_steps, int size,
           cudaStream_t stream) {
  const int smem = 4 * T * T * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      insert_rays_tiled<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int n = (size + T - 1) / T;
  insert_rays_tiled<T><<<dim3(n, n), kThreads, smem, stream>>>(
      out, probs, origin, scan_origins, scan_points, scan_kind, hit_miss_p,
      res, n_scans, n_beams, n_steps, size);
  return (int)cudaGetLastError();
}

}  // namespace

// Writes the updated (size, size) grid to `out`; `probs` is only read.
// tile is 16, 32 or 64; the launch has ceil(size / tile)^2 blocks.
extern "C" int insert_rays_launch(void* out, const void* probs,
                                  const void* origin,
                                  const void* scan_origins,
                                  const void* scan_points,
                                  const void* scan_kind,
                                  const void* hit_miss_p, float res,
                                  int n_scans, int n_beams, int n_steps,
                                  int size, int tile, void* stream) {
#define SG_LAUNCH(T)                                                       \
  launch<T>((float*)out, (const float*)probs, (const float*)origin,        \
            (const float*)scan_origins, (const float*)scan_points,         \
            (const int8_t*)scan_kind, (const float*)hit_miss_p, res,       \
            n_scans, n_beams, n_steps, size, (cudaStream_t)stream)
  switch (tile) {
    case 16: return SG_LAUNCH(16);
    case 32: return SG_LAUNCH(32);
    case 64: return SG_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SG_LAUNCH
}
