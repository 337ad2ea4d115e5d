// Fast CARMEN/Radish FLASER log parser: the native data-loader layer.
//
// Replaces the reference's CarmenLogDataProvider (data_provider.cpp:
// 14-58) parse loop with a single-pass C scanner. One call returns
// packed arrays (ranges flattened + per-frame offsets, odom poses,
// timestamps), stably sorted by timestamp like the reference. A copy
// of native/carmen_parser.cpp, so the port builds it from its own
// sources: built at first use into sparse_gslam_tpu_torch/_build/ and
// called through ctypes (sparse_gslam_tpu_torch/io/native.py
// parse_carmen_native).
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC \
//            -o libcarmen.so carmen_parser.cpp
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

namespace {

struct Parsed {
    std::vector<double> ranges;   // flattened
    std::vector<long long> offsets;  // frame i ranges at [off[i], off[i+1])
    std::vector<double> poses;    // (n, 3) odometry
    std::vector<double> times;    // (n,)
};

Parsed* parse(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf(sz, '\0');
    if (std::fread(buf.data(), 1, sz, f) != (size_t)sz) {
        std::fclose(f);
        return nullptr;
    }
    std::fclose(f);

    auto* out = new Parsed();
    out->offsets.push_back(0);
    const char* p = buf.c_str();
    const char* end = p + sz;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        if (strncmp(p, "FLASER ", 7) == 0) {
            char* q = const_cast<char*>(p) + 7;
            long n = strtol(q, &q, 10);
            if (n > 0 && n < 100000) {
                size_t base = out->ranges.size();
                out->ranges.resize(base + n);
                bool ok = true;
                for (long i = 0; i < n; i++) {
                    out->ranges[base + i] = strtod(q, &q);
                    if (q >= line_end) { ok = false; break; }
                }
                double vals[7];
                for (int i = 0; ok && i < 7; i++) {
                    vals[i] = strtod(q, &q);
                }
                if (ok) {
                    // vals: x y theta odom_x odom_y odom_theta time
                    out->poses.push_back(vals[3]);
                    out->poses.push_back(vals[4]);
                    out->poses.push_back(vals[5]);
                    out->times.push_back(vals[6]);
                    out->offsets.push_back((long long)out->ranges.size());
                } else {
                    out->ranges.resize(base);
                }
            }
        }
        p = line_end + 1;
    }
    // stable sort frames by time (data_provider.cpp:44)
    size_t n = out->times.size();
    std::vector<size_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
        return out->times[a] < out->times[b];
    });
    Parsed* s = new Parsed();
    s->offsets.push_back(0);
    s->ranges.reserve(out->ranges.size());
    for (size_t k : order) {
        long long o0 = out->offsets[k], o1 = out->offsets[k + 1];
        s->ranges.insert(s->ranges.end(), out->ranges.begin() + o0,
                         out->ranges.begin() + o1);
        s->offsets.push_back((long long)s->ranges.size());
        for (int i = 0; i < 3; i++)
            s->poses.push_back(out->poses[3 * k + i]);
        s->times.push_back(out->times[k]);
    }
    delete out;
    return s;
}

}  // namespace

extern "C" {

void* carmen_parse(const char* path) { return parse(path); }

long long carmen_num_frames(void* h) {
    return (long long)((Parsed*)h)->times.size();
}
long long carmen_num_ranges(void* h) {
    return (long long)((Parsed*)h)->ranges.size();
}
void carmen_copy(void* h, double* ranges, long long* offsets,
                 double* poses, double* times) {
    auto* p = (Parsed*)h;
    std::memcpy(ranges, p->ranges.data(),
                p->ranges.size() * sizeof(double));
    std::memcpy(offsets, p->offsets.data(),
                p->offsets.size() * sizeof(long long));
    std::memcpy(poses, p->poses.data(), p->poses.size() * sizeof(double));
    std::memcpy(times, p->times.data(), p->times.size() * sizeof(double));
}
void carmen_free(void* h) { delete (Parsed*)h; }

}  // extern "C"
