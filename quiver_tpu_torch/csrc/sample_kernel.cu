// Neighbour-sampling layer for Hopper: the sampler of the split walk.
//
// Replaces the Pallas TPU kernel of quiver_tpu/ops/pallas/sample_kernel.py:
//   qt_sample_layer  <- sample_layer_pallas (_make_kernel; pallas_call at
//                       sample_kernel.py:174)
//
// What it computes, seed by seed: given the seed's CSR start and degree,
// draw min(deg, k) distinct positions in [0, min(deg, row_cap)) and emit
// the neighbours there (-1 past the count); the selection and the random
// stream are those of the fused kernels (sample_common.cuh), so its picks
// equal fused_sample_hop's for the same seeds and seed. As in the JAX
// package, the starts and degrees are read by the wrapper, outside the
// kernel, and come in through device memory: that round trip is what
// makes this the split walk's sampler, and it is kept.
//
// Bound on an H100: bytes. Per seed it reads 12 B (the seed, by the
// wrapper; the start and the degree, here) and 4 B of neighbour index per
// pick, and writes 4*(k+1) B. The design is the simple one: one thread per
// seed, blockDim 128 so blockIdx/threadIdx are the hash's block/lane (a
// ragged last block keeps that numbering: no padding of the seeds), the
// write log in registers, direct reads of indices[start + pos] (no
// 128-aligned windows, no index padding: those were Mosaic DMA rules).

#include <cstdint>
#include <cuda_runtime.h>

#include "sample_common.cuh"

namespace {

using qt::kBlock;

__global__ void __launch_bounds__(kBlock)
sample_layer_kernel(const int* __restrict__ indices,
                    const int* __restrict__ starts,
                    const int* __restrict__ degs, int bs, int k, int row_cap,
                    int seed, int* __restrict__ nbrs,
                    int* __restrict__ counts) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (g >= bs) return;
  const uint32_t base = qt::block_base(seed, blockIdx.x);
  counts[g] = qt::sample_from(indices, starts[g], degs[g], k, row_cap, base,
                              threadIdx.x, nbrs + g * k, nullptr);
}

}  // namespace

extern "C" {

int qt_max_k() { return qt::kMaxK; }

int qt_sample_layer(const void* indices, const void* starts, const void* degs,
                    int bs, int k, int row_cap, int seed, void* nbrs,
                    void* counts, void* stream) {
  sample_layer_kernel<<<(bs + kBlock - 1) / kBlock, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indices), static_cast<const int*>(starts),
      static_cast<const int*>(degs), bs, k, row_cap, seed,
      static_cast<int*>(nbrs), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
