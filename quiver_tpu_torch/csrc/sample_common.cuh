// Device code shared by the port's three sampling kernels (fused_hop.cu:
// the fused sample hop and the fused hot hop; sample_kernel.cu: the split
// walk's sampling layer), so that all three run one Fisher-Yates on one
// random stream.
//
// The random bits are the JAX package's portable counter hash
// (quiver_tpu/ops/pallas/_dma.py: make_rand_bits "hash", _mix_u32): seed s
// of a launch draws as lane s % 128 of block s / 128, one draw per
// Fisher-Yates step, so a launch of kBlock threads per block makes
// blockIdx.x and threadIdx.x that block and lane. The selection is
// quiver_tpu/ops/pallas/sample_kernel.py: _fy_positions, a partial
// Fisher-Yates with a k-entry write log.

#pragma once

#include <cstdint>

namespace qt {

constexpr int kBlock = 128;  // seeds per block = the hash's lane count
constexpr int kMaxK = 64;    // register/local write-log bound

__device__ __forceinline__ uint32_t mix_u32(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  x = x ^ (x >> 15);
  return x;
}

__device__ __forceinline__ uint32_t block_base(int seed, uint32_t blk) {
  return mix_u32(static_cast<uint32_t>(seed) ^ (0x9E3779B9u * (blk + 1u)));
}

__device__ __forceinline__ uint32_t draw(uint32_t base, uint32_t lane,
                                         uint32_t step) {
  return mix_u32(mix_u32(base ^ (lane * 0x85EBCA6Bu) ^ (step * 0x9E3779B9u)));
}

// Samples one seed whose CSR row starts at indices[start] and holds deg
// entries: min(deg, k) distinct positions in [0, min(deg, row_cap)).
// Writes k entries to nbrs_row (and to picks_row when given), -1 past the
// count, and returns the count. Draw i depends only on (base, lane, i),
// so a lane that stops early shifts no other lane's stream.
__device__ inline int sample_from(const int* __restrict__ indices, int start,
                                  int deg, int k, int row_cap, uint32_t base,
                                  uint32_t lane, int* __restrict__ nbrs_row,
                                  int* picks_row) {
  const int pool = min(deg, row_cap);
  const int count = min(deg, k);
  int pos_log[kMaxK];
  int val_log[kMaxK];
  for (int i = 0; i < k; ++i) {
    int v = -1;
    if (i < count) {
      const uint32_t bits = draw(base, lane, static_cast<uint32_t>(i));
      const uint32_t span = static_cast<uint32_t>(max(pool - i, 1));
      const int j = i + static_cast<int>(bits % span);
      int a_j = j, a_i = i;
      for (int t = 0; t < i; ++t) {  // last write wins, as in the log
        if (pos_log[t] == j) a_j = val_log[t];
        if (pos_log[t] == i) a_i = val_log[t];
      }
      pos_log[i] = j;
      val_log[i] = a_i;
      v = indices[static_cast<int64_t>(start) + a_j];
    }
    nbrs_row[i] = v;
    if (picks_row != nullptr) picks_row[i] = v;
  }
  return count;
}

}  // namespace qt
