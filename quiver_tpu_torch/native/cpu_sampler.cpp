// Native host-side neighbour sampling engine of the PyTorch port (its own
// copy of quiver_tpu/native/cpu_sampler.cpp, the same draws bit for bit).
//
// The counterpart of the reference's CPU sampling engine quiver<T,CPU>:
// per-seed uniform sampling without replacement over a CSR graph, the
// weighted draw with replacement, and the first-occurrence reindex of one
// hop. It feeds GraphSageSampler(mode="CPU") and the host side of
// MixedGraphSageSampler while the card samples other batches. Plain C
// interface, loaded with ctypes (quiver_tpu_torch/native/__init__.py),
// which releases the GIL for the call; built with g++ at first use.
//
// Design: plain std::thread (no libtorch); a partial Fisher-Yates with an
// O(k) write log instead of std::sample (no per-row O(deg) scratch);
// splitmix64 keyed by (seed, row) so a draw does not depend on the thread
// count. The plain numpy version beside the loader repeats this
// arithmetic step for step.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t &state) {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

void sample_range(const int64_t *indptr, const int32_t *indices,
                  const int32_t *seeds, int64_t lo, int64_t hi, int32_t k,
                  uint64_t seed, int32_t *out_nbrs, int32_t *out_counts,
                  int64_t *out_slots) {
    // out_slots (nullable): each pick's flat CSR slot (-1 fill), the
    // input of edge-id lookups.
    std::vector<int64_t> pos(k), val(k);
    for (int64_t i = lo; i < hi; ++i) {
        int32_t *out = out_nbrs + i * k;
        int64_t *slots = out_slots ? out_slots + i * k : nullptr;
        const int32_t v = seeds[i];
        if (v < 0) {
            out_counts[i] = 0;
            std::fill(out, out + k, -1);
            if (slots) std::fill(slots, slots + k, (int64_t)-1);
            continue;
        }
        const int64_t row_start = indptr[v];
        const int64_t deg = indptr[v + 1] - row_start;
        const int64_t c = std::min<int64_t>(deg, k);
        out_counts[i] = static_cast<int32_t>(c);
        if (deg <= k) {
            for (int64_t t = 0; t < deg; ++t) out[t] = indices[row_start + t];
            std::fill(out + deg, out + k, -1);
            if (slots) {
                for (int64_t t = 0; t < deg; ++t) slots[t] = row_start + t;
                std::fill(slots + deg, slots + k, (int64_t)-1);
            }
            continue;
        }
        uint64_t state = seed ^ (0xD1B54A32D192ED03ULL * (uint64_t)(v + 1));
        int written = 0;
        for (int32_t t = 0; t < k; ++t) {
            const int64_t j =
                t + (int64_t)(splitmix64(state) % (uint64_t)(deg - t));
            int64_t a_j = j, a_t = t;
            for (int w = written - 1; w >= 0; --w)
                if (pos[w] == j) { a_j = val[w]; break; }
            for (int w = written - 1; w >= 0; --w)
                if (pos[w] == t) { a_t = val[w]; break; }
            out[t] = indices[row_start + a_j];
            if (slots) slots[t] = row_start + a_j;
            pos[written] = j;
            val[written] = a_t;
            ++written;
        }
    }
}

void sample_range_weighted(const int64_t *indptr, const int32_t *indices,
                           const float *weights, const int32_t *seeds,
                           int64_t lo, int64_t hi, int32_t k,
                           int32_t row_cap, uint64_t seed,
                           int32_t *out_nbrs, int32_t *out_counts,
                           int64_t *out_slots) {
    // k draws WITH replacement proportional to edge weight, among the
    // first min(deg, row_cap) neighbours: the device pool draw's contract
    // (ops/weighted.py). row_cap matches the device default, so host and
    // device batches of the mixed sampler share one distribution.
    std::vector<double> cdf(row_cap);
    for (int64_t i = lo; i < hi; ++i) {
        int32_t *out = out_nbrs + i * k;
        const int32_t v = seeds[i];
        if (v < 0) {
            out_counts[i] = 0;
            std::fill(out, out + k, -1);
            if (out_slots)
                std::fill(out_slots + i * k, out_slots + (i + 1) * k,
                          (int64_t)-1);
            continue;
        }
        const int64_t row_start = indptr[v];
        const int64_t deg = indptr[v + 1] - row_start;
        const int64_t pool = std::min<int64_t>(deg, row_cap);
        double total = 0.0;
        for (int64_t t = 0; t < pool; ++t) {
            const float w = weights[row_start + t];
            total += w > 0.0f ? (double)w : 0.0;
            cdf[t] = total;
        }
        if (total <= 0.0) {
            // zero-mass row: fully masked and counts = 0, as the device
            // draw gives (ops/weighted.py)
            out_counts[i] = 0;
            std::fill(out, out + k, -1);
            if (out_slots)
                std::fill(out_slots + i * k, out_slots + (i + 1) * k,
                          (int64_t)-1);
            continue;
        }
        out_counts[i] = static_cast<int32_t>(std::min<int64_t>(deg, k));
        uint64_t state = seed ^ (0xD1B54A32D192ED03ULL * (uint64_t)(v + 1));
        for (int32_t t = 0; t < k; ++t) {
            if (t >= out_counts[i]) {
                out[t] = -1;
                if (out_slots) out_slots[i * k + t] = -1;
                continue;
            }
            const double u =
                (double)(splitmix64(state) >> 11) * (1.0 / 9007199254740992.0)
                * total;               // 53-bit uniform in [0, total)
            const int64_t p =
                std::upper_bound(cdf.begin(), cdf.begin() + pool, u) -
                cdf.begin();
            const int64_t slot = row_start + std::min<int64_t>(p, pool - 1);
            out[t] = indices[slot];
            if (out_slots) out_slots[i * k + t] = slot;
        }
    }
}

}  // namespace

extern "C" {

// ABI version marker, the JAX engine's: the loader requires this symbol
// (the v2 signatures carry out_slots).
void qt_abi_v2(void) {}

// Weighted (attention) draw: k picks with replacement ~ edge weight per
// seed, pool truncated at row_cap. out_nbrs [num_seeds * k] (-1 fill),
// out_counts [num_seeds] = min(deg, k), or 0 for zero-mass rows
// (nbrs all -1), as ops/weighted.py gives.
void qt_sample_layer_weighted(const int64_t *indptr, const int32_t *indices,
                              const float *weights, const int32_t *seeds,
                              int64_t num_seeds, int32_t k, int32_t row_cap,
                              uint64_t seed, int32_t *out_nbrs,
                              int32_t *out_counts, int64_t *out_slots,
                              int32_t num_threads) {
    if (num_seeds == 0) return;
    if (row_cap < 1) row_cap = 1;
    int32_t nt = num_threads > 0
                     ? num_threads
                     : (int32_t)std::thread::hardware_concurrency();
    nt = std::max(1, std::min<int32_t>(nt, (int32_t)num_seeds));
    if (nt == 1) {
        sample_range_weighted(indptr, indices, weights, seeds, 0, num_seeds,
                              k, row_cap, seed, out_nbrs, out_counts,
                              out_slots);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (num_seeds + nt - 1) / nt;
    for (int32_t t = 0; t < nt; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min(num_seeds, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(sample_range_weighted, indptr, indices, weights,
                             seeds, lo, hi, k, row_cap, seed, out_nbrs,
                             out_counts, out_slots);
    }
    for (auto &th : threads) th.join();
}

// Sample up to k neighbors (uniform, without replacement) per seed.
// out_nbrs: [num_seeds * k] (-1 fill), out_counts: [num_seeds].
// out_slots (nullable): each pick's flat CSR slot, [num_seeds * k].
void qt_sample_layer(const int64_t *indptr, const int32_t *indices,
                     const int32_t *seeds, int64_t num_seeds, int32_t k,
                     uint64_t seed, int32_t *out_nbrs, int32_t *out_counts,
                     int64_t *out_slots, int32_t num_threads) {
    if (num_seeds == 0) return;
    int32_t nt = num_threads > 0
                     ? num_threads
                     : (int32_t)std::thread::hardware_concurrency();
    nt = std::max(1, std::min<int32_t>(nt, (int32_t)num_seeds));
    if (nt == 1) {
        sample_range(indptr, indices, seeds, 0, num_seeds, k, seed, out_nbrs,
                     out_counts, out_slots);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (num_seeds + nt - 1) / nt;
    for (int32_t t = 0; t < nt; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min(num_seeds, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(sample_range, indptr, indices, seeds, lo, hi, k,
                             seed, out_nbrs, out_counts, out_slots);
    }
    for (auto &th : threads) th.join();
}

// The threads a call with num_threads <= 0 starts (before the cap at the
// seed count): std::thread::hardware_concurrency(), at least 1.
int32_t qt_hardware_threads(void) {
    return std::max<int32_t>(1, (int32_t)std::thread::hardware_concurrency());
}

}  // extern "C"

extern "C" {

// First-occurrence reindex of one sampled hop, the host counterpart of the
// device layer compaction (the reference's CPU path reindexes with an
// unordered_map). Open addressing instead: one flat probe array, no
// per-node allocations.
//
// seeds [s] (-1 fill allowed), nbrs [s*k] (-1 fill).
// out_n_id [s + s*k]: unique ids, first-occurrence order (valid seeds
// first, packed), -1 fill. out_row/out_col [s*k]: local-id COO (-1 fill).
// Returns the number of valid unique ids.
int64_t qt_reindex(const int32_t *seeds, int64_t s, const int32_t *nbrs,
                   int32_t k, int32_t *out_n_id, int32_t *out_row,
                   int32_t *out_col) {
    const int64_t cap = s + s * (int64_t)k;
    uint64_t table_size = 16;
    while (table_size < (uint64_t)(2 * cap)) table_size <<= 1;
    std::vector<int32_t> keys(table_size, -1);
    std::vector<int32_t> vals(table_size, -1);
    const uint64_t mask = table_size - 1;

    int64_t count = 0;
    auto lookup_or_insert = [&](int32_t id) -> int32_t {
        uint64_t h = (uint64_t)(uint32_t)id * 0x9E3779B97F4A7C15ULL;
        uint64_t slot = (h >> 17) & mask;
        for (;;) {
            if (keys[slot] == id) return vals[slot];
            if (keys[slot] == -1) {
                keys[slot] = id;
                vals[slot] = (int32_t)count;
                out_n_id[count++] = id;
                return vals[slot];
            }
            slot = (slot + 1) & mask;
        }
    };

    std::vector<int32_t> seed_local(s);
    for (int64_t i = 0; i < s; ++i)
        seed_local[i] = seeds[i] < 0 ? -1 : lookup_or_insert(seeds[i]);
    for (int64_t i = 0; i < s; ++i) {
        for (int32_t t = 0; t < k; ++t) {
            const int64_t e = i * k + t;
            const int32_t nb = nbrs[e];
            if (nb < 0 || seed_local[i] < 0) {
                out_row[e] = -1;
                out_col[e] = -1;
            } else {
                out_row[e] = seed_local[i];
                out_col[e] = lookup_or_insert(nb);
            }
        }
    }
    std::fill(out_n_id + count, out_n_id + cap, -1);
    return count;
}

}  // extern "C"
