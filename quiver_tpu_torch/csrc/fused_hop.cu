// Fused neighbour-sampling hop and fused sample+gather leaf hop for Hopper.
// The sampling itself, shared with sample_kernel.cu, is in
// sample_common.cuh.
//
// Replaces the two Pallas TPU kernels of quiver_tpu/ops/pallas/fused.py:
//   qt_fused_sample_hop  <- _fused_sample_hop (_make_fused_kernel,
//                           with_gather=False; pallas_call at fused.py:513)
//   qt_fused_hot_hop     <- _fused_hot_hop (_make_fused_kernel,
//                           with_gather=True; pallas_call at fused.py:411)
//
// What they compute, seed by seed: read the seed's indptr pair (seed
// clipped to [0, n-1]; a -1 seed has degree 0 at start 0), draw
// min(deg, k) distinct positions in [0, min(deg, row_cap)) by a partial
// Fisher-Yates with a k-entry write log, and emit the neighbours there
// (-1 past the count). The random bits are the JAX package's portable
// counter hash (_dma.make_rand_bits "hash"), so the picks equal the TPU
// kernel's bit for bit. The hot hop then gathers the feature rows of
// every seed and every pick (feature_order translation, hot_rows bound,
// int8 code*scale + zero as a rounded multiply then a rounded add,
// invalid rows multiplied by 0.0).
//
// Bound on an H100: both are bound by bytes. A sample hop moves 12 B of
// seed + indptr pair and 4 B of neighbour index per pick and writes
// 4*(k+1) B per seed, so at the walk's sizes it is bound by latency: the
// design keeps the dependent chain short (seed, indptr pair, one round of
// neighbour reads) and spreads each seed over a group of lanes
// (sample_common.cuh), so hop 0's 1,024 seeds are 1,024 groups, not 8
// blocks of serial threads. The hot hop writes one D*4 B fp32 row per
// seed and per pick, which dominates; its gather keeps many rows in flight
// per SM: the block's (row, 4-value word) pairs are spread flat over its
// 256 threads, each thread issuing the loads of 4 words (4 int8 codes or
// 16 B of fp32 each) before its 16-byte stores, with each row's storage
// row and int8 sidecars looked up once into shared memory. Neighbouring
// threads take neighbouring words, so a warp's loads and stores are
// contiguous runs (giving a thread several words of one row instead
// measured slower). Where the width is not a multiple of 4 or a base
// pointer is not aligned, a word is one value.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "sample_common.cuh"

namespace {

using qt::kBlock;

constexpr int kThreads = 256;   // sample hop: threads per block
constexpr int kHotThreads = 256;  // hot hop: threads per block of kBlock seeds
constexpr int kSkip = INT32_MIN;  // a gather row that is not written
constexpr int kShared48K = 48 * 1024;

static_assert(kHotThreads >= kBlock, "phase A1 gives each seed a thread");
static_assert(kHotThreads % 32 == 0, "groups are aligned in warps");

__device__ __forceinline__ void read_row(const int* __restrict__ indptr,
                                         int n_nodes, int s, int& start,
                                         int& deg) {
  start = 0;
  deg = 0;
  if (s >= 0 && n_nodes > 0) {
    const int p = min(s, n_nodes - 1);
    start = indptr[p];
    deg = indptr[p + 1] - start;
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
fused_sample_hop_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ indices,
                        const int* __restrict__ seeds, int bs, int n_nodes,
                        int k, int row_cap, int seed, int* __restrict__ nbrs,
                        int* __restrict__ counts) {
  const int shift = qt::group_shift(k);
  const int64_t g =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> shift;
  const bool live = g < bs;
  int start = 0, deg = 0;
  if (live) read_row(indptr, n_nodes, seeds[g], start, deg);
  qt::sample_group<S>(indices, start, deg, k, row_cap, seed, g, 1 << shift,
                      threadIdx.x & ((1 << shift) - 1), live, nbrs, counts);
}

// -- the hot hop's gather words ----------------------------------------------

// What one thread loads for one word: 4 int8 codes or 16 B of fp32, or
// one value on the scalar path.
template <bool kQuant, int kVec>
using Word = typename std::conditional<
    kQuant, typename std::conditional<kVec == 4, uint32_t, int8_t>::type,
    typename std::conditional<kVec == 4, float4, float>::type>::type;

// rounded multiply, then rounded add: never one fused multiply-add; then
// the multiply-mask, which keeps -0.0 as the plain version does
__device__ __forceinline__ float deq(float code, float sc, float z, float m) {
  return __fmul_rn(__fadd_rn(__fmul_rn(code, sc), z), m);
}

__device__ __forceinline__ float code_at(uint32_t w, int b) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * b)));
}

__device__ __forceinline__ void put(float* out, uint32_t w, float sc, float z,
                                    float m) {
  *reinterpret_cast<float4*>(out) =
      make_float4(deq(code_at(w, 0), sc, z, m), deq(code_at(w, 1), sc, z, m),
                  deq(code_at(w, 2), sc, z, m), deq(code_at(w, 3), sc, z, m));
}

__device__ __forceinline__ void put(float* out, int8_t w, float sc, float z,
                                    float m) {
  *out = deq(static_cast<float>(w), sc, z, m);
}

__device__ __forceinline__ void put(float* out, float4 w, float, float,
                                    float m) {
  *reinterpret_cast<float4*>(out) = make_float4(
      __fmul_rn(w.x, m), __fmul_rn(w.y, m), __fmul_rn(w.z, m),
      __fmul_rn(w.w, m));
}

__device__ __forceinline__ void put(float* out, float w, float, float,
                                    float m) {
  *out = __fmul_rn(w, m);
}

// Phase by phase, for the block's kBlock seeds:
//   A1  each seed's id and indptr pair, into shared memory;
//   A2  the Fisher-Yates positions, one group of lanes per seed;
//   A3  the picks' neighbour ids (nbrs written, picks kept in shared
//       memory for the gather);
//   A4  each gathered row's storage row, with its multiply-mask in the
//       sign, and its int8 scale and zero;
//   B   the rows, seeds first and then the picks row-major, as a flat
//       range of (row, word) pairs over the block's threads.
// With seeds_valid_only the rows of -1 seeds are not written, so that a
// destination's slots there keep what they hold.
template <bool kQuant, int kVec, int S>
__global__ void __launch_bounds__(kHotThreads)
fused_hot_hop_kernel(const int* __restrict__ indptr,
                     const int* __restrict__ indices,
                     const int* __restrict__ seeds, int bs, int n_nodes, int k,
                     int row_cap, int seed, const void* __restrict__ data,
                     const float* __restrict__ scale,
                     const float* __restrict__ zero, int tier_n, int dim,
                     const int* __restrict__ forder, int n_order, int hot_rows,
                     int* __restrict__ nbrs, int* __restrict__ counts,
                     float* __restrict__ seed_rows, int64_t seed_stride,
                     int seeds_valid_only, float* __restrict__ pick_rows) {
  constexpr int kUnrollA = 4;
  constexpr int kUnrollB = 4;
  using W = Word<kQuant, kVec>;
  extern __shared__ int smem[];
  const int n_rows = kBlock * (1 + k);
  const int n_picks = kBlock * k;
  int* rows = smem;                 // [n_rows] ids, then encoded storage rows
  int* starts = rows + n_rows;      // [kBlock]
  int* degs = starts + kBlock;      // [kBlock]
  float* sc = reinterpret_cast<float*>(degs + kBlock);  // [n_rows], int8
  float* zr = sc + n_rows;                               // [n_rows], int8
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlock;

  // A1
  if (tid < kBlock) {
    int sid = -1, start = 0, deg = 0;
    if (first + tid < bs) {
      sid = seeds[first + tid];
      read_row(indptr, n_nodes, sid, start, deg);
    }
    rows[tid] = sid;
    starts[tid] = start;
    degs[tid] = deg;
  }
  __syncthreads();

  // A2: the block is hash block blockIdx.x, its seed sl hash lane sl
  {
    const int shift = qt::group_shift(k);
    const int G = 1 << shift;
    const int r = tid & (G - 1);
    const uint32_t base = qt::block_base(seed, blockIdx.x);
    for (int sl = tid >> shift; sl < kBlock; sl += kHotThreads >> shift) {
      int pos[S];
      qt::fy_group<S>(degs[sl], k, row_cap, base, sl, G, r, pos);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int i = r + q * G;
        if (i < k) rows[kBlock + sl * k + i] = pos[q] >= 0 ? starts[sl] + pos[q]
                                                          : -1;
      }
    }
  }
  __syncthreads();

  // A3
  const int64_t pick0 = first * k;
  const int64_t picks_end = static_cast<int64_t>(bs) * k;
  for (int p0 = tid; p0 < n_picks; p0 += kHotThreads * kUnrollA) {
    int v[kUnrollA];
#pragma unroll
    for (int u = 0; u < kUnrollA; ++u) {
      const int p = p0 + u * kHotThreads;
      v[u] = -1;
      if (p < n_picks) {
        const int at = rows[kBlock + p];
        if (at >= 0) v[u] = indices[at];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollA; ++u) {
      const int p = p0 + u * kHotThreads;
      if (p < n_picks) {
        rows[kBlock + p] = v[u];
        if (pick0 + p < picks_end) nbrs[pick0 + p] = v[u];
      }
    }
  }
  if (tid < kBlock && first + tid < bs) counts[first + tid] = min(degs[tid], k);
  __syncthreads();

  // A4: ~srow marks an invalid or cold row (multiplied by 0.0)
  for (int r0 = tid; r0 < n_rows; r0 += kHotThreads * kUnrollA) {
    int id[kUnrollA], t[kUnrollA];
#pragma unroll
    for (int u = 0; u < kUnrollA; ++u) {
      const int r = r0 + u * kHotThreads;
      id[u] = r < n_rows ? rows[r] : -1;
      t[u] = id[u];
      if (forder != nullptr && r < n_rows)
        t[u] = forder[min(max(id[u], 0), n_order - 1)];
    }
#pragma unroll
    for (int u = 0; u < kUnrollA; ++u) {
      const int r = r0 + u * kHotThreads;
      if (r >= n_rows) continue;
      const bool live = r < kBlock
          ? first + r < bs && (!seeds_valid_only || id[u] >= 0)
          : pick0 + (r - kBlock) < picks_end;
      const bool valid =
          id[u] >= 0 && (forder == nullptr || t[u] < hot_rows);
      const int srow = min(max(t[u], 0), tier_n - 1);
      if (kQuant && live) {
        sc[r] = scale[srow];
        zr[r] = zero[srow];
      }
      rows[r] = live ? (valid ? srow : ~srow) : kSkip;
    }
  }
  __syncthreads();

  // B
  if (dim == 0) return;
  const int words = dim / kVec;
  const int dr = kHotThreads / words, dc = kHotThreads % words;
  int r = tid / words, c = tid % words;
  while (r < n_rows) {
    int rr[kUnrollB], cc[kUnrollB], e[kUnrollB];
    W w[kUnrollB];
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      rr[u] = r;
      cc[u] = c;
      c += dc;
      r += dr;
      if (c >= words) {
        c -= words;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      e[u] = rr[u] < n_rows ? rows[rr[u]] : kSkip;
      if (e[u] != kSkip) {
        const int64_t srow = e[u] >= 0 ? e[u] : ~e[u];
        const W* row = reinterpret_cast<const W*>(
            static_cast<const char*>(data) +
            srow * dim * (kQuant ? 1 : static_cast<int>(sizeof(float))));
        w[u] = row[cc[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollB; ++u) {
      if (e[u] == kSkip) continue;
      const int x = rr[u];
      float* out = x < kBlock
          ? seed_rows + (first + x) * seed_stride
          : pick_rows + (pick0 + (x - kBlock)) * dim;
      put(out + cc[u] * kVec, w[u], kQuant ? sc[x] : 0.0f,
          kQuant ? zr[x] : 0.0f, e[u] >= 0 ? 1.0f : 0.0f);
    }
  }
}

size_t hot_hop_smem(int k, bool quantized) {
  const size_t n_rows = static_cast<size_t>(kBlock) * (1 + k);
  return sizeof(int) * (n_rows * (quantized ? 3 : 1) + 2 * kBlock);
}

template <bool kQuant, int kVec>
int launch_hot_hop(const void* indptr, const void* indices, const void* seeds,
                   int bs, int n_nodes, int k, int row_cap, int seed,
                   const void* data, const void* scale, const void* zero,
                   int tier_n, int dim, const void* forder, int n_order,
                   int hot_rows, void* nbrs, void* counts, void* seed_rows,
                   int64_t seed_stride, int seeds_valid_only, void* pick_rows,
                   cudaStream_t stream) {
  const size_t smem = hot_hop_smem(k, kQuant);
  return qt::with_steps(k, [&](auto steps) {
    auto kernel = fused_hot_hop_kernel<kQuant, kVec, decltype(steps)::value>;
    if (smem > kShared48K) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<(bs + kBlock - 1) / kBlock, kHotThreads, smem, stream>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const int*>(seeds), bs, n_nodes, k, row_cap, seed, data,
        static_cast<const float*>(scale), static_cast<const float*>(zero),
        tier_n, dim, static_cast<const int*>(forder), n_order, hot_rows,
        static_cast<int*>(nbrs), static_cast<int*>(counts),
        static_cast<float*>(seed_rows), seed_stride, seeds_valid_only,
        static_cast<float*>(pick_rows));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

int qt_max_k() { return qt::kMaxK; }

int qt_fused_sample_hop(const void* indptr, const void* indices,
                        const void* seeds, int bs, int n_nodes, int k,
                        int row_cap, int seed, void* nbrs, void* counts,
                        void* stream) {
  return qt::with_steps(k, [&](auto steps) {
    fused_sample_hop_kernel<decltype(steps)::value>
        <<<qt::grid_for(bs, k, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(indptr), static_cast<const int*>(indices),
            static_cast<const int*>(seeds), bs, n_nodes, k, row_cap, seed,
            static_cast<int*>(nbrs), static_cast<int*>(counts));
    return static_cast<int>(cudaGetLastError());
  });
}

// The values one thread moves per gather word for this table and these
// outputs: 4 (one 4-byte load of int8 codes or one 16-byte fp32 load, one
// 16-byte store) where the width, the seed rows' stride and every base
// pointer allow it, else 1.
int qt_hot_hop_vec(const void* data, int quantized, int dim,
                   const void* seed_rows, long long seed_stride,
                   const void* pick_rows) {
  const uintptr_t out = reinterpret_cast<uintptr_t>(seed_rows) |
                        reinterpret_cast<uintptr_t>(pick_rows);
  const uintptr_t in = reinterpret_cast<uintptr_t>(data);
  const bool ok = dim % 4 == 0 && seed_stride % 4 == 0 && out % 16 == 0 &&
                  in % (quantized ? 4 : 16) == 0;
  return ok ? 4 : 1;
}

int qt_fused_hot_hop(const void* indptr, const void* indices,
                     const void* seeds, int bs, int n_nodes, int k,
                     int row_cap, int seed, const void* data,
                     const void* scale, const void* zero, int quantized,
                     int tier_n, int dim, const void* forder, int n_order,
                     int hot_rows, void* nbrs, void* counts, void* seed_rows,
                     long long seed_stride, int seeds_valid_only,
                     void* pick_rows, void* stream) {
  const bool vec = qt_hot_hop_vec(data, quantized, dim, seed_rows,
                                  seed_stride, pick_rows) == 4;
  using Launch = decltype(&launch_hot_hop<true, 4>);
  const Launch launch = quantized ? (vec ? &launch_hot_hop<true, 4>
                                         : &launch_hot_hop<true, 1>)
                                  : (vec ? &launch_hot_hop<false, 4>
                                         : &launch_hot_hop<false, 1>);
  return launch(indptr, indices, seeds, bs, n_nodes, k, row_cap, seed, data,
                scale, zero, tier_n, dim, forder, n_order, hot_rows, nbrs,
                counts, seed_rows, seed_stride, seeds_valid_only, pick_rows,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
