// Device code shared by the port's three sampling kernels (fused_hop.cu:
// the fused sample hop and the fused hot hop; sample_kernel.cu: the split
// walk's sampling layer), so that all three run one Fisher-Yates on one
// random stream.
//
// The random bits are the JAX package's portable counter hash
// (quiver_tpu/ops/pallas/_dma.py: make_rand_bits "hash", _mix_u32): seed g
// of a launch draws as lane g % 128 of block g / 128, one draw per
// Fisher-Yates step, whatever blockIdx and threadIdx run it. The selection
// is quiver_tpu/ops/pallas/sample_kernel.py: _fy_positions, a partial
// Fisher-Yates with a k-entry write log in which the last write wins.
//
// One seed runs on a group of G lanes of a warp (G = 1 << group_shift(k)):
// lane r owns step r, and step r + G too where k > 32 (S = 2 steps per
// lane). Each step's draw and its position j_i depend on nothing but the
// hash, so every lane computes its own at once; the log is then resolved
// in registers by broadcasting the steps in order with __shfl_sync (k
// shuffles of two ints per seed, no local memory), and the k neighbour
// reads are issued together.

#pragma once

#include <cstdint>
#include <type_traits>

namespace qt {

constexpr int kBlock = 128;  // seeds per hash block = the hash's lane count
constexpr int kMaxK = 64;    // two steps per lane of a 32-lane group
constexpr unsigned kFullMask = 0xffffffffu;

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

// log2 of the lanes per seed: 8, 16 or 32 lanes, one step each up to
// k = 32, two steps each above.
__host__ __device__ constexpr int group_shift(int k) {
  return k <= 8 ? 3 : (k <= 16 ? 4 : 5);
}

// Blocks of `threads` threads that give each of bs seeds its group.
inline unsigned grid_for(int64_t bs, int k, int threads) {
  return static_cast<unsigned>(((bs << group_shift(k)) + threads - 1) /
                               threads);
}

// Runs f(std::integral_constant<int, S>{}) with the steps per lane S
// that k needs (k <= kMaxK), and returns what f returns.
template <typename F>
int with_steps(int k, F f) {
  return k > 32 ? f(std::integral_constant<int, 2>{})
                : f(std::integral_constant<int, 1>{});
}

// The partial Fisher-Yates of one seed with deg CSR entries, on its
// group of G lanes (aligned in its warp; G * S >= k); r is the lane's
// place in the group, hlane the seed's hash lane. Leaves in pos[q] the
// position picked at step r + q*G, in [0, min(deg, row_cap)), or -1 from
// step min(deg, k) on. Every lane of the warp calls it together with the
// same k and G (the shuffles span the warp); a lane without a seed
// passes deg 0.
template <int S>
__device__ __forceinline__ void fy_group(int deg, int k, int row_cap,
                                         uint32_t base, uint32_t hlane, int G,
                                         int r, int (&pos)[S]) {
  const int pool = min(deg, row_cap);
  const int count = min(deg, k);
  int j[S];  // pos_log of the lane's steps: what each step swaps with
  int v[S];  // val_log: the value at position i just before step i
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int i = r + q * G;
    j[q] = -1;
    if (i < count) {  // then i < pool, as k <= row_cap
      const uint32_t bits = draw(base, hlane, static_cast<uint32_t>(i));
      j[q] = i + static_cast<int>(bits % static_cast<uint32_t>(pool - i));
    }
    v[q] = i;
    pos[q] = j[q];
  }
  // Step s wrote position j_s with v_s. v_s is final once every earlier
  // step has been applied, so the steps are broadcast in order; a later
  // step overwrites, as the last write wins in the log. j_s >= s, so a
  // step only ever reads positions written by earlier steps.
#pragma unroll
  for (int q = 0; q < S; ++q) {
    for (int sl = 0; sl < G; ++sl) {
      const int s = q * G + sl;
      if (s >= k) break;
      const int js = __shfl_sync(kFullMask, j[q], sl, G);
      const int vs = __shfl_sync(kFullMask, v[q], sl, G);
      if (s < count) {
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int i = r + t * G;
          if (i > s) {
            if (js == i) v[t] = vs;
            if (js == j[t]) pos[t] = vs;
          }
        }
      }
    }
  }
}

// One seed of a sampling launch: seed g (on group lane r of G) whose CSR
// row starts at indices[start] and holds deg entries. Writes the seed's k
// outputs (the neighbour, -1 past min(deg, k)) and its count; a lane with
// live false (past the launch's seeds) only takes part in the shuffles.
template <int S>
__device__ __forceinline__ void sample_group(const int* __restrict__ indices,
                                             int start, int deg, int k,
                                             int row_cap, int seed, int64_t g,
                                             int G, int r, bool live,
                                             int* __restrict__ nbrs,
                                             int* __restrict__ counts) {
  int pos[S];
  fy_group<S>(live ? deg : 0, k, row_cap,
              block_base(seed, static_cast<uint32_t>(g / kBlock)),
              static_cast<uint32_t>(g % kBlock), G, r, pos);
  if (!live) return;
  int out[S];
#pragma unroll
  for (int q = 0; q < S; ++q)  // the reads in flight before the stores
    out[q] = pos[q] >= 0 ? indices[static_cast<int64_t>(start) + pos[q]] : -1;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int i = r + q * G;
    if (i < k) nbrs[g * k + i] = out[q];
  }
  if (r == 0) counts[g] = min(deg, k);
}

}  // namespace qt
