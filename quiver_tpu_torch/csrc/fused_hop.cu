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
// kernel's bit for bit: seed s draws as lane s % 128 of block s / 128,
// one draw per Fisher-Yates step. The hot hop then gathers the feature
// rows of the block's 128 seeds and 128*k picks (feature_order
// translation, hot_rows bound, int8 code*scale + zero as a rounded
// multiply then a rounded add, invalid rows multiplied by 0.0).
//
// Bound on an H100: both are bound by bytes. A sample hop moves 12 B of
// seed + indptr pair and 4 B of neighbour index per pick and writes
// 4*(k+1) B per seed; the hot hop adds one stored row read (D int8 + 8 B
// of sidecars) and one D*4 B fp32 row written per seed and per pick, so
// its fp32 writes dominate. The design is the simple one: one thread per
// seed (blockDim 128, so blockIdx/threadIdx are the hash's block/lane),
// the write log in registers, direct reads of indices[start + pos] (no
// 128-aligned windows, no index padding: those were Mosaic DMA rules),
// then one warp per gathered row. Staging rows through shared memory
// with cp.async/TMA is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "sample_common.cuh"

namespace {

using qt::block_base;
using qt::kBlock;
using qt::kMaxK;

// Reads one seed's indptr pair (seed clipped to [0, n-1]; a -1 seed has
// degree 0 at start 0), then samples it (sample_common.cuh).
__device__ int sample_one(const int* __restrict__ indptr,
                          const int* __restrict__ indices, int n_nodes,
                          int s, int k, int row_cap, uint32_t base,
                          uint32_t lane, int* __restrict__ nbrs_row,
                          int* picks_row) {
  int start = 0, deg = 0;
  if (s >= 0 && n_nodes > 0) {
    const int p = min(s, n_nodes - 1);
    start = indptr[p];
    deg = indptr[p + 1] - start;
  }
  return qt::sample_from(indices, start, deg, k, row_cap, base, lane,
                         nbrs_row, picks_row);
}

__global__ void __launch_bounds__(kBlock)
fused_sample_hop_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ indices,
                        const int* __restrict__ seeds, int bs, int n_nodes,
                        int k, int row_cap, int seed, int* __restrict__ nbrs,
                        int* __restrict__ counts) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  if (g >= bs) return;
  const uint32_t base = block_base(seed, blockIdx.x);
  counts[g] = sample_one(indptr, indices, n_nodes, seeds[g], k, row_cap, base,
                         threadIdx.x, nbrs + static_cast<int64_t>(g) * k,
                         nullptr);
}

template <bool kQuant>
__global__ void __launch_bounds__(kBlock)
fused_hot_hop_kernel(const int* __restrict__ indptr,
                     const int* __restrict__ indices,
                     const int* __restrict__ seeds, int bs, int n_nodes, int k,
                     int row_cap, int seed, const void* __restrict__ data,
                     const float* __restrict__ scale,
                     const float* __restrict__ zero, int tier_n, int dim,
                     const int* __restrict__ forder, int n_order, int hot_rows,
                     int* __restrict__ nbrs, int* __restrict__ counts,
                     float* __restrict__ seed_rows,
                     float* __restrict__ pick_rows) {
  extern __shared__ int smem[];
  int* picks = smem;               // [kBlock * k], row-major per seed
  int* sids = smem + kBlock * k;   // [kBlock]
  const int lane = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlock;
  const int64_t g = first + lane;

  // phase A: sample, picks kept in shared memory for the gather
  int sid = -1;
  if (g < bs) {
    sid = seeds[g];
    const uint32_t base = block_base(seed, blockIdx.x);
    counts[g] = sample_one(indptr, indices, n_nodes, sid, k, row_cap, base,
                           lane, nbrs + g * k, picks + lane * k);
  } else {
    for (int i = 0; i < k; ++i) picks[lane * k + i] = -1;
  }
  sids[lane] = sid;
  __syncthreads();

  // phase B: one warp per row, seeds first, then the picks row-major
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
  const int n_rows = kBlock * (1 + k);
  for (int r = warp; r < n_rows; r += kBlock / 32) {
    int id;
    float* out;
    if (r < kBlock) {
      if (first + r >= bs) continue;
      id = sids[r];
      out = seed_rows + (first + r) * dim;
    } else {
      const int p = r - kBlock;
      if (first + p / k >= bs) continue;
      id = picks[p];
      out = pick_rows + (first * k + p) * dim;
    }
    bool valid;
    int srow;
    if (forder != nullptr) {
      const int t = forder[min(max(id, 0), n_order - 1)];
      valid = (id >= 0) && (t < hot_rows);
      srow = min(max(t, 0), tier_n - 1);
    } else {
      valid = id >= 0;
      srow = min(max(id, 0), tier_n - 1);
    }
    const float m = valid ? 1.0f : 0.0f;  // multiply-mask keeps -0.0
    if (kQuant) {
      const int8_t* row =
          static_cast<const int8_t*>(data) + static_cast<int64_t>(srow) * dim;
      const float sc = scale[srow];
      const float z = zero[srow];
      for (int c = wl; c < dim; c += 32) {
        // rounded multiply, then rounded add: never one fused multiply-add
        const float v = __fadd_rn(__fmul_rn(static_cast<float>(row[c]), sc), z);
        out[c] = __fmul_rn(v, m);
      }
    } else {
      const float* row =
          static_cast<const float*>(data) + static_cast<int64_t>(srow) * dim;
      for (int c = wl; c < dim; c += 32) out[c] = __fmul_rn(row[c], m);
    }
  }
}

inline int grid_for(int bs) { return (bs + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

int qt_max_k() { return kMaxK; }

int qt_fused_sample_hop(const void* indptr, const void* indices,
                        const void* seeds, int bs, int n_nodes, int k,
                        int row_cap, int seed, void* nbrs, void* counts,
                        void* stream) {
  fused_sample_hop_kernel<<<grid_for(bs), kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const int*>(seeds), bs, n_nodes, k, row_cap, seed,
      static_cast<int*>(nbrs), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

int qt_fused_hot_hop(const void* indptr, const void* indices,
                     const void* seeds, int bs, int n_nodes, int k,
                     int row_cap, int seed, const void* data,
                     const void* scale, const void* zero, int quantized,
                     int tier_n, int dim, const void* forder, int n_order,
                     int hot_rows, void* nbrs, void* counts, void* seed_rows,
                     void* pick_rows, void* stream) {
  const size_t smem = sizeof(int) * kBlock * (k + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    fused_hot_hop_kernel<true><<<grid_for(bs), kBlock, smem, s>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const int*>(seeds), bs, n_nodes, k, row_cap, seed, data,
        static_cast<const float*>(scale), static_cast<const float*>(zero),
        tier_n, dim, static_cast<const int*>(forder), n_order, hot_rows,
        static_cast<int*>(nbrs), static_cast<int*>(counts),
        static_cast<float*>(seed_rows), static_cast<float*>(pick_rows));
  } else {
    fused_hot_hop_kernel<false><<<grid_for(bs), kBlock, smem, s>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const int*>(seeds), bs, n_nodes, k, row_cap, seed, data,
        nullptr, nullptr, tier_n, dim, static_cast<const int*>(forder),
        n_order, hot_rows, static_cast<int*>(nbrs),
        static_cast<int*>(counts), static_cast<float*>(seed_rows),
        static_cast<float*>(pick_rows));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
