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
// pick, and writes 4*(k+1) B. At the walk's sizes that is latency: each
// seed runs on a group of lanes (sample_common.cuh), its draws at once
// and its log resolved in registers, then one round of neighbour reads.
// The seed index, not the launch, numbers the hash's block and lane, so a
// ragged last block needs no padding of the seeds.

#include <cstdint>
#include <cuda_runtime.h>

#include "sample_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int S>
__global__ void __launch_bounds__(kThreads)
sample_layer_kernel(const int* __restrict__ indices,
                    const int* __restrict__ starts,
                    const int* __restrict__ degs, int bs, int k, int row_cap,
                    int seed, int* __restrict__ nbrs,
                    int* __restrict__ counts) {
  const int shift = qt::group_shift(k);
  const int64_t g =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> shift;
  const bool live = g < bs;
  qt::sample_group<S>(indices, live ? starts[g] : 0, live ? degs[g] : 0, k,
                      row_cap, seed, g, 1 << shift,
                      threadIdx.x & ((1 << shift) - 1), live, nbrs, counts);
}

}  // namespace

extern "C" {

int qt_max_k() { return qt::kMaxK; }

int qt_sample_layer(const void* indices, const void* starts, const void* degs,
                    int bs, int k, int row_cap, int seed, void* nbrs,
                    void* counts, void* stream) {
  return qt::with_steps(k, [&](auto steps) {
    sample_layer_kernel<decltype(steps)::value>
        <<<qt::grid_for(bs, k, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(indices), static_cast<const int*>(starts),
            static_cast<const int*>(degs), bs, k, row_cap, seed,
            static_cast<int*>(nbrs), static_cast<int*>(counts));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
