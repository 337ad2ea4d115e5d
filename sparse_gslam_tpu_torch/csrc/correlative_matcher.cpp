// Native CPU baseline: multi-resolution branch-and-bound correlative
// scan matcher, the algorithm of the reference backend's hot loop
// (reference: src/sparse_gslam/src/cartographer_bindings/
// fast_correlative_scan_matcher_2d.cc:368-688 -- PrecomputationGrid2D
// max-pool stack, ComputeLowestResolutionCandidates, recursive DFS
// BranchAndBound). The host baseline beside the port's FFT matchers
// on the GPU (ops/matching.py), and an independent oracle that the
// exhaustive FFT argmax equals the B&B optimum on identical inputs.
//
// Input contract matches ops/grid.py precompute_pyramid semantics:
// level i holds at (x, y) the max of the level-0 score over the
// forward-looking (2^i + 1)-wide window; level 0 itself is the 2x2
// dilated score grid (unknown cells = PMIN = 0.1). This file builds
// the stack itself from the raw probability grid with the same
// widths, using O(n) sliding-window maxima (SlidingWindowMaximum,
// fast_correlative_scan_matcher_2d.cc:41-74).
//
// Dependency-free C++17. A copy of native/correlative_matcher.cpp, so
// the port builds it from its own sources: built at first use into
// sparse_gslam_tpu_torch/_build/ and called through ctypes
// (sparse_gslam_tpu_torch/io/native.py correlative_match_native,
// correlative_match_many_native).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>

namespace {

constexpr float kPMin = 0.1f;

struct Pyramid {
    int size = 0;
    int depth = 0;
    // levels[h][x * size + y], h in [0, depth)
    std::vector<std::vector<float>> levels;
};

// O(n) forward-looking sliding max over one axis.
static void sliding_max_axis0(const std::vector<float>& in,
                              std::vector<float>& out, int size, int w) {
    std::deque<std::pair<int, float>> dq;  // (index, value), decreasing
    for (int y = 0; y < size; y++) {
        dq.clear();
        for (int x = size - 1; x >= 0; x--) {
            float v = in[(size_t)x * size + y];
            while (!dq.empty() && dq.back().second <= v) dq.pop_back();
            dq.emplace_back(x, v);
            while (dq.front().first > x + w - 1) dq.pop_front();
            out[(size_t)x * size + y] = dq.front().second;
        }
    }
}

static void sliding_max_axis1(const std::vector<float>& in,
                              std::vector<float>& out, int size, int w) {
    std::deque<std::pair<int, float>> dq;
    for (int x = 0; x < size; x++) {
        const float* row = &in[(size_t)x * size];
        float* orow = &out[(size_t)x * size];
        dq.clear();
        for (int y = size - 1; y >= 0; y--) {
            float v = row[y];
            while (!dq.empty() && dq.back().second <= v) dq.pop_back();
            dq.emplace_back(y, v);
            while (dq.front().first > y + w - 1) dq.pop_front();
            orow[y] = dq.front().second;
        }
    }
}

static Pyramid build_pyramid(const float* probs, int size, int depth) {
    Pyramid p;
    p.size = size;
    p.depth = depth;
    p.levels.resize(depth);
    std::vector<float> score0((size_t)size * size);
    for (size_t i = 0; i < score0.size(); i++)
        score0[i] = probs[i] > 0.0f ? probs[i] : kPMin;
    std::vector<float> tmp((size_t)size * size);
    for (int h = 0; h < depth; h++) {
        int w = (1 << h) + 1;
        p.levels[h].resize((size_t)size * size);
        sliding_max_axis0(score0, tmp, size, w);
        sliding_max_axis1(tmp, p.levels[h], size, w);
    }
    return p;
}

struct Candidate {
    int r;        // rotation index
    int ox, oy;   // offset in cells
    int level;    // pyramid level of `score`
    float score;  // upper bound (exact at level 0)
    bool operator<(const Candidate& o) const { return score < o.score; }
};

struct RotatedScan {
    std::vector<int> cx, cy;  // discretized cells per point
};

// Mean pooled-grid lookup over the scan at (ox, oy); out-of-bounds
// points score kPMin (ops/matching.py correlate_rotations semantics).
static float score_at(const Pyramid& p, int level, const RotatedScan& s,
                      int ox, int oy) {
    const std::vector<float>& g = p.levels[level];
    const int size = p.size;
    float acc = 0.0f;
    const int n = (int)s.cx.size();
    for (int i = 0; i < n; i++) {
        int x = s.cx[i] + ox, y = s.cy[i] + oy;
        acc += (x >= 0 && x < size && y >= 0 && y < size)
                   ? g[(size_t)x * size + y]
                   : kPMin;
    }
    return acc / (float)n;
}

struct Matcher {
    Pyramid pyr;
    double origin_x, origin_y, resolution;
    int n_linear;
    std::vector<RotatedScan> scans;  // one per rotation
    std::vector<double> thetas;

    float best_score = -1.0f;
    Candidate best{};

    void branch_and_bound(const Candidate& c) {
        if (c.score <= best_score) return;
        if (c.level == 0) {
            best_score = c.score;
            best = c;
            return;
        }
        // expand 2x2 children at half stride, score, visit best-first
        int half = 1 << (c.level - 1);
        Candidate kids[4];
        int nk = 0;
        for (int dx = 0; dx < 2; dx++)
            for (int dy = 0; dy < 2; dy++) {
                int ox = c.ox + dx * half, oy = c.oy + dy * half;
                if (ox > n_linear || oy > n_linear) continue;
                Candidate k{c.r, ox, oy, c.level - 1,
                            score_at(pyr, c.level - 1, scans[c.r], ox, oy)};
                kids[nk++] = k;
            }
        std::sort(kids, kids + nk,
                  [](const Candidate& a, const Candidate& b) {
                      return a.score > b.score;
                  });
        for (int i = 0; i < nk; i++) branch_and_bound(kids[i]);
    }
};

}  // namespace

extern "C" {

// Returns 1 when a match >= min_score was found (fills out[4] =
// {score, x, y, theta}; pose in grid/anchor frame), else 0.
int correlative_match(
    const float* probs, int size, double origin_x, double origin_y,
    double resolution, const double* points, int n_points,
    double init_theta, double angular_step, int n_angular, int n_linear,
    int depth, double min_score, double* out) {
    Matcher m;
    m.pyr = build_pyramid(probs, size, depth);
    m.origin_x = origin_x;
    m.origin_y = origin_y;
    m.resolution = resolution;
    m.n_linear = n_linear;

    const int R = 2 * n_angular + 1;
    m.scans.resize(R);
    m.thetas.resize(R);
    for (int r = 0; r < R; r++) {
        double th = init_theta + (r - n_angular) * angular_step;
        m.thetas[r] = th;
        double c = std::cos(th), s = std::sin(th);
        RotatedScan& sc = m.scans[r];
        sc.cx.resize(n_points);
        sc.cy.resize(n_points);
        for (int i = 0; i < n_points; i++) {
            double px = c * points[2 * i] - s * points[2 * i + 1];
            double py = s * points[2 * i] + c * points[2 * i + 1];
            sc.cx[i] = (int)std::floor((px - origin_x) / resolution);
            sc.cy[i] = (int)std::floor((py - origin_y) / resolution);
        }
    }

    // lowest-resolution candidates over the strided lattice
    // (ComputeLowestResolutionCandidates)
    const int top = depth - 1;
    const int stride = 1 << top;
    std::vector<Candidate> cands;
    for (int r = 0; r < R; r++)
        for (int ox = -n_linear; ox <= n_linear; ox += stride)
            for (int oy = -n_linear; oy <= n_linear; oy += stride)
                cands.push_back(
                    {r, ox, oy, top, score_at(m.pyr, top, m.scans[r], ox, oy)});
    std::sort(cands.begin(), cands.end(),
              [](const Candidate& a, const Candidate& b) {
                  return a.score > b.score;
              });

    m.best_score = (float)min_score;  // floor, like the reference's
                                      // min_score-seeded best
    bool found = false;
    Candidate seed_best{};
    for (const Candidate& c : cands) {
        if (c.score <= m.best_score) break;  // sorted: all rest pruned
        float before = m.best_score;
        m.branch_and_bound(c);
        if (m.best_score > before) {
            found = true;
            seed_best = m.best;
        }
    }
    if (!found) return 0;
    out[0] = m.best_score;
    out[1] = seed_best.ox * resolution;
    out[2] = seed_best.oy * resolution;
    out[3] = m.thetas[seed_best.r];
    return 1;
}

// Fan candidate submaps over a thread pool (the reference's ctpl
// loop_closing_threads fan-out, submap_loop_closer.cpp:158-171) and
// reduce to the best score. grids: n_cands stacked (size*size) grids.
// Returns best candidate index or -1; fills out[4].
int correlative_match_many(
    const float* grids, int n_cands, int size, const double* origins,
    double resolution, const double* points, int n_points,
    const double* init_thetas, double angular_step, int n_angular,
    int n_linear, int depth, double min_score, int n_threads,
    double* out) {
    std::vector<double> results(4 * (size_t)n_cands);
    std::vector<int> ok(n_cands, 0);
    std::vector<std::thread> pool;
    std::vector<int> next_idx{0};
    int stride_sz = size * size;
    auto worker = [&](int tid) {
        for (int k = tid; k < n_cands; k += n_threads) {
            ok[k] = correlative_match(
                grids + (size_t)k * stride_sz, size, origins[2 * k],
                origins[2 * k + 1], resolution, points, n_points,
                init_thetas[k], angular_step, n_angular, n_linear, depth,
                min_score, &results[4 * (size_t)k]);
        }
    };
    if (n_threads <= 1) {
        worker(0);
    } else {
        for (int t = 0; t < n_threads; t++) pool.emplace_back(worker, t);
        for (auto& th : pool) th.join();
    }
    int best = -1;
    for (int k = 0; k < n_cands; k++)
        if (ok[k] && (best < 0 || results[4 * k] > results[4 * best]))
            best = k;
    if (best < 0) return -1;
    std::memcpy(out, &results[4 * (size_t)best], 4 * sizeof(double));
    return best;
}

}  // extern "C"
