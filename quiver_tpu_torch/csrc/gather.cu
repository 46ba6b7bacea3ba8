// Row gather for Hopper: out[i] = feat[ids[i]], from a table in device
// memory or in pinned host memory.
//
// Replaces the Pallas TPU kernel of quiver_tpu/ops/pallas/gather.py:
//   qt_gather_rows         <- gather_rows (_gather_kernel; pallas_call at
//                             gather.py:92)
//   qt_gather_rows_packed  <- the same gather over a packed int8 tier, the
//                             cold tier's host layout (ops/quant.py: pack):
//                             row r of one byte buffer holds its codes,
//                             then its fp32 scale and zero at byte `side`,
//                             then padding up to the row stride; dequant
//                             fused (the JAX package's quant.gather_rows
//                             over a tier)
//   qt_gather_rows_q8      <- the same over int8 codes with separate
//                             scale and zero arrays (a device table)
//   qt_gather_elems        <- the same gather over a 1-D table of 4- or
//                             8-byte elements: the sampler's reads of a
//                             topology in pinned host memory (indptr,
//                             indices, an edge-id map); its int32 rows
//                             views go through qt_gather_rows
//   qt_gather_segments     <- the same 1-D gather over each seed's span of
//                             consecutive elements (the sampler's indptr
//                             heads, the weighted pool's weights), read
//                             from the span's start and length with no id
//                             array (the span design, below)
//   qt_gather_rows_sharded <- the same gather over a table cut into row
//                             blocks that lie on several cards or in
//                             pinned host memory (the clique store's hot
//                             tier, a ShardTensor's groups): JAX's
//                             quant.gather_rows over a row-sharded array,
//                             which XLA partitions (quiver_tpu/feature.py:
//                             383-387), and the reference's
//                             quiver_tensor_gather (quiver_feature.cu,
//                             shard_tensor.cu.hpp)
//
// What bounds it. From device memory, bytes: 4 + 2 * row bytes per id at
// 3.35 TB/s. From pinned host memory, the rows cross PCIe, at best at the
// pinned-to-device copy rate; but a read of host memory from the SMs is
// held back first by the count of read requests in flight, not by bytes.
// A 100-wide int8 row whose codes lie at id * 100 and whose scale and zero
// lie in two other arrays costs three or more small requests for 108 bytes
// (that layout reached 18% of the bound).
//
// What the host design of the packed kernel (gather_rows_packed_kernel,
// a table in pinned host memory) does about it:
// - Id scan. A warp loads 32 ids in one coalesced read, takes
//   __ballot_sync of those it must read and ranks them into shared memory,
//   then serves only those rows. An all -1 launch (a branch of the tiered
//   lookup that is not taken) reads 4 bytes per id and nothing else.
// - Groups of 8 lanes. A group reads a row as 16-byte words, lane j the
//   words j, j + 8, ...: a packed row of at most 128 bytes that starts on a
//   128-byte line is one aligned request. Each group keeps 8 rows in
//   flight, so a warp reads all the live rows of its 32 ids at once.
// - Packed int8 rows. The lane whose word holds the scale and zero
//   broadcasts them to its group by __shfl_sync (that word is read first);
//   the group decodes each code as __fadd_rn(__fmul_rn(code, scale), zero),
//   a rounded multiply then a rounded add and never one FMA, as
//   fused_hop.cu's leaf gather and the plain version round it, and writes
//   float4s where the width and the output allow, else single floats.
//
// Packed int8 rows in device memory (the HBM design: a packed table on
// the card, the exchange's received block, a sharded table whose every
// block lies on a card; gather_rows_packed_hbm_kernel and
// gather_rows_sharded_packed_hbm_kernel). Bytes bound it at 3.35 TB/s:
// the ids, then a live row's data read (108 bytes of a 112- or 128-byte
// row for width 100) and its 400 fp32 bytes written; the stores carry
// about 80% of the bytes. On HBM the host design reached 34-41% of that
// bound (NVIDIA H100 80GB HBM3, 700 W): its lane j of a group wrote the 16
// codes of word j as 4 float4s at a 64-byte stride (one store instruction
// touched 4 rows in 16-byte pieces), a warp held one chunk of 32 ids at a
// time, and 8 rows in flight a lane took 104-118 registers (nvcc -Xptxas
// -v), so 2 blocks an SM. The HBM design gives a thread one unit of the
// output instead (4 codes into one float4, or 1 code into a float):
// neighbouring lanes write neighbouring 16 bytes, a block's tile of
// consecutive output rows goes out as one contiguous run, each thread
// keeps kHbmUnroll units' loads in flight before it stores, no barrier or
// shared scan stands between tiles, and 32 registers leave room for 64
// warps an SM. A row's lanes share its id, scale and zero loads (one
// request each). It reached 59-75% of the bound at the clique's and the
// exchange's shapes (NVIDIA H100 80GB HBM3, 700 W; kernel_ab.py
// --old-packed-device).
//
// Raw rows (every other table: fp32, bf16, fp16, int8 or int32 rows
// copied as bytes) take one of two designs, which the wrapper picks
// (gather.py: raw_design) and passes in with the word width.
// - Rows in device memory: bytes bound them, the ids read, each row read
//   and written once at 3.35 TB/s. The loop design (one row a warp,
//   lane j the words j, j + 32, ...) left lanes idle wherever a row has
//   fewer than 32 words: a 128-byte row in 16-byte words kept 8 of 32
//   lanes busy (the exchange's owner read at 50% of its bound), and a
//   200-byte bf16 row, not a multiple of 16 bytes, fell to 4-byte words
//   (49-59%). The tile design (gather_rows_tile_kernel,
//   gather_rows_sharded_tile_kernel) gives a thread words of the output
//   instead: a block's tile of consecutive output rows, as many lanes to
//   a row as it has words, 8-byte words where 16 do not divide the row,
//   kTileUnroll words loaded before any is stored, and two 8-byte words
//   stored as one 16-byte word. The owner read went to 93% of its bound
//   and bf16 to 68-72% (NVIDIA H100 80GB HBM3, 700 W; kernel_ab.py
//   --old-raw).
// - Rows in pinned host memory: the host's rate of read requests bounds
//   them (about 200-240M 128-byte lines a second, half the copy engine's
//   rate), so the fewest lines a row wins. The loop design reads a whole
//   row of up to 512 bytes in one instruction, which touches each of its
//   lines once; the tile design splits a 400-byte row across warps and
//   was 3-15% slower there. Hopper's bulk copy (cp.async.bulk, a row in
//   one TMA instruction) reads mapped pinned memory, but at no more
//   lines a second at 512-, 1,024- and 3,072-byte rows, and at a third of
//   the rate at 400-byte rows; it was not kept (PERF.md). Pinned
//   rows, flat or sharded, take the loop design.
// Offsets are int64; neither the width nor the id count is padded (the
// Pallas kernel's 128-lane and 256-row padding were Mosaic rules, and its
// 4 row DMAs in flight per block become a warp's 32 rows in flight).
//
// Ids: with skip_negative = 0 every id must lie in [0, n_rows); one that
// does not is clamped into the table, so the kernel never reads outside
// it. With skip_negative = 1 (the wrappers' out= form) a negative id
// leaves its output row as it is and reads nothing: the tiered lookup
// predicates each branch's reads this way instead of waiting for the host
// to pick a branch.
//
// Elements: one id a thread, int32 or int64 ids; a negative id gives -1
// and reads nothing (a read the sampler does not take), an id past the
// table is clamped into it. From pinned host memory each live id is one
// read request over PCIe, so the request rate, not bytes, bounds it.
//
// Spans (gather_segments_kernel; it replaces the same Pallas kernel,
// quiver_tpu/ops/pallas/gather.py:92, as the flat form does). Two callers
// read consecutive elements of one seed: the sampler's indptr heads
// (indptr[s] and indptr[s + 1]) and the weighted pool (a seed's first
// min(deg, row_cap) weights). Through the flat form each built an id
// array: the heads as [2, bs], the two words of one seed bs lanes apart
// and so two host read requests where one sector holds both; the pool as
// an int64 [bs, 2048] array (2.95 GB at a 180,224-seed hop), 98% of it
// -1, whose 12 bytes a slot (the id read, the word written) were the
// flat kernel's whole bound. The span design reads a seed's start and
// length instead (12 bytes a seed) and gives each seed a power-of-two
// group of lanes (see the kernel). What bounds it: the device bytes, 12 a
// seed read and width * elem bytes a seed written, at 3.35 TB/s, or the
// live host bytes at the pinned copy rate, whichever is longer; and, from
// pinned memory, the host's rate of 128-byte line requests, which moves
// with the machine (about 215M or 500-700M lines a second on the same
// card model, PERF.md) whatever a request's size: the design asks for
// each line a seed's span covers once (one for a head pair that does not
// straddle a line; the heads asked for 149k lines where the flat form
// asked for 288k). chip_smoke.py states the bytes bound and the 32-byte
// sectors asked for, kernel_ab.py --old-elems the 128-byte lines.
//
// Sharded tables: each id finds its block by a binary search of the int64
// row offsets (kept in shared memory with the blocks' pointers up to 64
// blocks, read from global memory past that), then reads the row from that
// block's pointer: a local block, one on a peer card (peer access enabled
// by qt_enable_peer_access) or one in pinned host memory. The bytes bound
// it as they bound the gather of one device table; the search costs a few
// shared-memory reads a row. Raw rows take the tile design when every
// block lies on a card and the loop design when a block lies in pinned
// host memory, each row's address taken from its block; packed int8 rows
// go through the HBM design above when every block lies on a card, else
// through the host design (id scan, 8 rows in flight a group, the
// sidecars broadcast).
//
// Host tables: with table_on_host = 1 the table pointers are pinned host
// memory (cudaHostAlloc, as torch's pin_memory allocates it), mapped into
// the device's address space with cudaHostGetDevicePointer; the loads then
// cross PCIe (the reference's UVA gather, quiver_feature.cu).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                      // lanes that read one row
constexpr int kGroups = 32 / kGroup;           // rows per load instruction
constexpr int kRowsPerGroup = 32 / kGroups;    // a warp's 32 ids at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t clamp_id(int64_t id, int64_t n_rows) {
  return id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
}

// The ids [base, base + 32) of the calling warp, loaded in one read: keeps
// those the gather reads (all, clamped; with skip_negative, those >= 0)
// and ranks them, row[k] the table row and at[k] the lane (output row
// base + at[k]) of the k-th kept id. Returns the count, the same in every
// lane.
__device__ __forceinline__ int scan_ids(const int* __restrict__ ids,
                                        int64_t base, int64_t n_ids,
                                        int64_t n_rows, int skip_negative,
                                        int* row, int* at) {
  const int lane = threadIdx.x & 31;
  const int64_t i = base + lane;
  const int64_t id = i < n_ids ? ids[i] : -1;
  const bool keep = i < n_ids && !(skip_negative && id < 0);
  const unsigned mask = __ballot_sync(kFull, keep);
  if (keep) {
    const int k = __popc(mask & ((1u << lane) - 1u));
    row[k] = static_cast<int>(clamp_id(id, n_rows));
    at[k] = lane;
  }
  __syncwarp();
  return __popc(mask);
}

// Where the rows of a gather lie: one table, row `id` at base + id * stride.
struct FlatRows {
  const char* base;
  int64_t stride;
  __device__ __forceinline__ const char* operator()(int64_t id) const {
    return base + id * stride;
  }
};

// Raw rows, the loop design: one row a warp, lane j the words j,
// j + 32, ... of it, so that one load instruction reads a whole row of up
// to 512 bytes in 16-byte words and touches the fewest 128-byte lines.
template <typename V, typename Rows>
__device__ __forceinline__ void raw_rows_loop(const Rows& rows,
                                              const int* __restrict__ ids,
                                              int64_t n_ids, int64_t n_rows,
                                              int64_t row_vecs,
                                              int skip_negative,
                                              V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       r < n_ids; r += stride) {
    const int64_t id = ids[r];
    if (skip_negative && id < 0) continue;  // warp-uniform: one row a warp
    const V* src = reinterpret_cast<const V*>(rows(clamp_id(id, n_rows)));
    V* dst = out + r * row_vecs;
    for (int64_t c = lane; c < row_vecs; c += 32) dst[c] = src[c];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const char* __restrict__ feat,
                   const int* __restrict__ ids, int64_t n_ids,
                   int64_t n_rows, int64_t stride, int64_t row_vecs,
                   int skip_negative, V* __restrict__ out) {
  raw_rows_loop<V>(FlatRows{feat, stride}, ids, n_ids, n_rows, row_vecs,
                   skip_negative, out);
}

// Words a thread of the tile design loads before it stores any.
constexpr int kTileUnroll = 4;

// Stores kPer consecutive words V of the output as one wider word: two
// 8-byte words as one 16-byte store.
template <typename V, int kPer>
__device__ __forceinline__ void store_words(V* dst, const V* v) {
  if constexpr (kPer == 2)
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0].x, v[0].y, v[1].x,
                                                v[1].y);
  else
    *dst = v[0];
}

// Raw rows, the tile design: a block walks tiles of tile_rows consecutive
// output rows; in a tile, thread t owns the kPer words from kPer * t on,
// then those kThreads * kPer words further, and so on: the lanes of a row
// are as many as its words (8 for a 128-byte row in 16-byte words: 4 rows
// a warp), neighbouring lanes read neighbouring words of a row and write
// neighbouring words of the output, and a tile's rows go out as one
// contiguous run (the lookup form) or as runs broken only by skipped
// rows (skip_negative). Each thread loads its kTileUnroll words of a pass
// before it stores any. With kPer = 2 (8-byte words, an output aligned to
// 16 bytes) a thread stores its two words as one 16-byte word, which may
// hold the end of one row and the start of the next; tile_rows then
// makes a tile an even number of words. A row's lanes share its id load
// (one request).
template <typename V, int kPer, typename Rows>
__device__ __forceinline__ void raw_rows_tile(const Rows& rows,
                                              const int* __restrict__ ids,
                                              int64_t n_ids, int64_t n_rows,
                                              int words, int tile_rows,
                                              int skip_negative,
                                              V* __restrict__ out) {
  constexpr int kUnits = kTileUnroll / kPer;  // wide stores a pass
  constexpr int kStep = kThreads * kPer;      // words between them
  // a thread's first word in every tile, and the step to its next unit
  const int row0 = threadIdx.x * kPer / words,
            col0 = threadIdx.x * kPer % words;
  const int drow = kStep / words, dcol = kStep % words;
  const int64_t tiles = (n_ids + tile_rows - 1) / tile_rows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t first = t * tile_rows;
    const int here = static_cast<int>(
        n_ids - first < tile_rows ? n_ids - first : tile_rows);
    V* dst = out + first * words + threadIdx.x * kPer;
    int r = row0, c = col0;
    for (int w = 0; r < here; w += kStep * kUnits) {
      const V* src[kUnits][kPer];
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        int rr = r, cc = c;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          src[u][p] = nullptr;
          if (rr < here) {
            const int64_t id = ids[first + rr];
            if (!(skip_negative && id < 0))
              src[u][p] = reinterpret_cast<const V*>(
                              rows(clamp_id(id, n_rows))) + cc;
          }
          if (++cc == words) {
            cc = 0;
            ++rr;
          }
        }
        r += drow;
        c += dcol;
        if (c >= words) {
          c -= words;
          ++r;
        }
      }
      V v[kUnits][kPer];
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
#pragma unroll
        for (int p = 0; p < kPer; ++p)
          if (src[u][p] != nullptr) v[u][p] = *src[u][p];
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        V* d = dst + w + u * kStep;
        bool all = true;
#pragma unroll
        for (int p = 0; p < kPer; ++p) all = all && src[u][p] != nullptr;
        if (all) {
          store_words<V, kPer>(d, v[u]);
        } else if (kPer > 1) {
#pragma unroll
          for (int p = 0; p < kPer; ++p)
            if (src[u][p] != nullptr) d[p] = v[u][p];
        }
      }
    }
  }
}

// The rows a tile of the tile design holds: one pass of the block's
// threads, at least one; an even count of words when kPer = 2.
int tile_rows_for(int64_t words, int per) {
  int64_t rows = static_cast<int64_t>(kThreads) * kTileUnroll / words;
  if (rows < 1) rows = 1;
  if (per == 2 && rows * words % 2 != 0) rows = rows > 1 ? rows - 1 : 2;
  return static_cast<int>(rows);
}

template <typename V, int kPer>
__global__ void __launch_bounds__(kThreads)
gather_rows_tile_kernel(const char* __restrict__ feat,
                        const int* __restrict__ ids, int64_t n_ids,
                        int64_t n_rows, int64_t stride, int words,
                        int tile_rows, int skip_negative,
                        V* __restrict__ out) {
  raw_rows_tile<V, kPer>(FlatRows{feat, stride}, ids, n_ids, n_rows, words,
                         tile_rows, skip_negative, out);
}

__device__ __forceinline__ float deq(int8_t code, float sc, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(code), sc), z);
}

__device__ __forceinline__ float deq_byte(uint32_t word, int b, float sc,
                                          float z) {
  return deq(static_cast<int8_t>(word >> (8 * b)), sc, z);
}

__device__ __forceinline__ uint32_t word_at(const uint4& v, int w) {
  return w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
}

// Decodes the codes of one 16-byte word, codes [first, first + 16) of the
// row, into dst[first...], writing only those below dim.
template <bool kVec4>
__device__ __forceinline__ void put_codes(const uint4& v, int64_t first,
                                          int64_t dim, float sc, float z,
                                          float* __restrict__ dst) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t word = word_at(v, w);
    const int64_t c = first + 4 * w;
    if (kVec4) {  // dim % 4 == 0: a word's 4 codes are all in or all out
      if (c < dim)
        *reinterpret_cast<float4*>(dst + c) = make_float4(
            deq_byte(word, 0, sc, z), deq_byte(word, 1, sc, z),
            deq_byte(word, 2, sc, z), deq_byte(word, 3, sc, z));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (c + b < dim) dst[c + b] = deq_byte(word, b, sc, z);
    }
  }
}

// The packed gather's body over `rows` (FlatRows, or ShardedRows below):
// the warp's id scan, then each group's 8 rows in flight, the sidecars'
// word first and broadcast, then the codes decoded.
template <bool kVec4, typename Rows>
__device__ __forceinline__ void packed_rows(const Rows& rows,
                                            const int* __restrict__ ids,
                                            int64_t n_ids, int64_t n_rows,
                                            int64_t dim, int side,
                                            int skip_negative,
                                            float* __restrict__ out) {
  __shared__ int s_row[kWarps][32], s_at[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / kGroup, j = lane % kGroup;
  int* row = s_row[warp];
  int* at = s_at[warp];
  // the 16-byte words that hold codes or sidecars (the rest is padding);
  // the one holding scale and zero, its lane in the group, its step and
  // the two 4-byte slots in it
  const int words = (side + 8 + 15) / 16;
  const int steps = (words + kGroup - 1) / kGroup;
  const int side_word = side / 16;
  const int side_lane = side_word % kGroup, side_step = side_word / kGroup;
  const int side_slot = (side % 16) / 4;
  const int64_t chunks = (n_ids + 31) / 32;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       c < chunks; c += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int n = scan_ids(ids, c * 32, n_ids, n_rows, skip_negative, row,
                           at);
    if (n == 0) continue;
    const uint4* src[kRowsPerGroup];
#pragma unroll
    for (int u = 0; u < kRowsPerGroup; ++u) {
      const int k = g + kGroups * u;
      src[u] = k < n ? reinterpret_cast<const uint4*>(rows(row[k]))
                     : nullptr;
    }
    float sc[kRowsPerGroup], z[kRowsPerGroup];
    for (int s = 0; s < steps; ++s) {
      // the sidecars' step first, then the others in order
      const int step = s == 0 ? side_step : (s <= side_step ? s - 1 : s);
      const int q = step * kGroup + j;
      uint4 v[kRowsPerGroup];
#pragma unroll
      for (int u = 0; u < kRowsPerGroup; ++u) {
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (src[u] != nullptr && q < words) v[u] = src[u][q];
      }
      if (s == 0) {
#pragma unroll
        for (int u = 0; u < kRowsPerGroup; ++u) {
          sc[u] = __uint_as_float(__shfl_sync(
              kFull, word_at(v[u], side_slot), side_lane, kGroup));
          z[u] = __uint_as_float(__shfl_sync(
              kFull, word_at(v[u], side_slot + 1), side_lane, kGroup));
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerGroup; ++u) {
        const int k = g + kGroups * u;
        if (k < n && 16 * q < dim)
          put_codes<kVec4>(v[u], 16 * q, dim, sc[u], z[u],
                           out + (c * 32 + at[k]) * dim);
      }
    }
    __syncwarp();  // the next chunk's scan overwrites row and at
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
gather_rows_packed_kernel(const uint4* __restrict__ rows,
                          const int* __restrict__ ids, int64_t n_ids,
                          int64_t n_rows, int64_t row_words, int64_t dim,
                          int side, int skip_negative,
                          float* __restrict__ out) {
  packed_rows<kVec4>(
      FlatRows{reinterpret_cast<const char*>(rows), row_words * 16}, ids,
      n_ids, n_rows, dim, side, skip_negative, out);
}

// Units of output a thread loads before it stores any, with no barrier
// between one tile and the next. 2 keeps a thread at 32 registers (4 took
// 40), so an SM holds its full 64 warps; more units a thread and an id
// prefetch across tiles were no faster (NVIDIA H100 80GB HBM3, 700 W).
constexpr int kHbmUnroll = 2;

// The packed gather's body over rows in device memory (the HBM design):
// one thread a unit of the output, a unit being one 4-code word decoded
// into one float4 (kVec4) or one code into one float. A block walks tiles
// of tile_rows consecutive output rows (at most kThreads * kHbmUnroll
// units, so one pass of its threads); in a tile, thread t owns units t,
// t + kThreads, ..., so neighbouring lanes write neighbouring 16 bytes and
// a tile's rows go out as one contiguous run (the lookup form) or as runs
// broken only by skipped rows (skip_negative). Each unit loads its row's
// id (the lanes of one row share it, one request), then its code word and
// the row's scale and zero (one 128-byte line with the codes), then
// decodes and stores. Few registers a thread, so the card holds many warps
// and their loads at once.
template <bool kVec4, typename Rows>
__device__ __forceinline__ void packed_rows_hbm(const Rows& rows,
                                                const int* __restrict__ ids,
                                                int64_t n_ids, int64_t n_rows,
                                                int dim, int side,
                                                int tile_rows,
                                                int skip_negative,
                                                float* __restrict__ out) {
  const int units = kVec4 ? dim / 4 : dim;  // output units a row
  // a thread's first unit in every tile, and the step to its next one
  const int row0 = threadIdx.x / units, col0 = threadIdx.x % units;
  const int drow = kThreads / units, dcol = kThreads % units;
  const int64_t tiles = (n_ids + tile_rows - 1) / tile_rows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t first = t * tile_rows;
    const int here = static_cast<int>(
        n_ids - first < tile_rows ? n_ids - first : tile_rows);
    int r = row0, c = col0;
    while (r < here) {
      const char* src[kHbmUnroll];
      int64_t at[kHbmUnroll];
      int col[kHbmUnroll];
#pragma unroll
      for (int u = 0; u < kHbmUnroll; ++u) {
        src[u] = nullptr;
        at[u] = 0;
        col[u] = c;
        if (r < here) {
          const int64_t i = first + r;
          const int64_t id = ids[i];
          if (!(skip_negative && id < 0)) src[u] = rows(clamp_id(id, n_rows));
          at[u] = i * units + c;
        }
        r += drow;
        c += dcol;
        if (c >= units) {
          c -= units;
          ++r;
        }
      }
      uint32_t code[kHbmUnroll];
      float sc[kHbmUnroll], z[kHbmUnroll];
#pragma unroll
      for (int u = 0; u < kHbmUnroll; ++u) {
        code[u] = 0u;
        sc[u] = z[u] = 0.0f;
        if (src[u] != nullptr) {
          code[u] = kVec4 ? __ldg(reinterpret_cast<const unsigned int*>(
                                      src[u]) + col[u])
                          : static_cast<uint8_t>(__ldg(src[u] + col[u]));
          sc[u] = __ldg(reinterpret_cast<const float*>(src[u] + side));
          z[u] = __ldg(reinterpret_cast<const float*>(src[u] + side + 4));
        }
      }
#pragma unroll
      for (int u = 0; u < kHbmUnroll; ++u) {
        if (src[u] == nullptr) continue;
        if (kVec4)
          reinterpret_cast<float4*>(out)[at[u]] = make_float4(
              deq_byte(code[u], 0, sc[u], z[u]),
              deq_byte(code[u], 1, sc[u], z[u]),
              deq_byte(code[u], 2, sc[u], z[u]),
              deq_byte(code[u], 3, sc[u], z[u]));
        else
          out[at[u]] = deq_byte(code[u], 0, sc[u], z[u]);
      }
    }
  }
}

// The rows a tile of the HBM design holds: as many as one pass of the
// block's threads covers, at least one.
int hbm_tile_rows(int64_t dim, bool vec4) {
  const int64_t units = vec4 ? dim / 4 : dim;
  const int64_t rows = static_cast<int64_t>(kThreads) * kHbmUnroll / units;
  return rows > 0 ? static_cast<int>(rows) : 1;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
gather_rows_packed_hbm_kernel(const char* __restrict__ rows,
                              const int* __restrict__ ids, int64_t n_ids,
                              int64_t n_rows, int64_t stride, int dim,
                              int side, int tile_rows, int skip_negative,
                              float* __restrict__ out) {
  packed_rows_hbm<kVec4>(FlatRows{rows, stride}, ids, n_ids, n_rows, dim,
                         side, tile_rows, skip_negative, out);
}

// Int8 codes with separate sidecar arrays (a device table): one row a
// warp, its scale and zero loaded apart from its codes.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
gather_rows_q8_kernel(const int8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      const float* __restrict__ zero,
                      const int* __restrict__ ids, int64_t n_ids,
                      int64_t n_rows, int64_t dim, int skip_negative,
                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       r < n_ids; r += stride) {
    int64_t id = ids[r];
    if (skip_negative && id < 0) continue;
    id = clamp_id(id, n_rows);
    const float sc = scale[id];
    const float z = zero[id];
    const int8_t* src = codes + id * dim;
    float* dst = out + r * dim;
    if (kVec4) {
      const char4* s4 = reinterpret_cast<const char4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int64_t c = lane; c < dim / 4; c += 32) {
        const char4 w = s4[c];
        d4[c] = make_float4(deq(w.x, sc, z), deq(w.y, sc, z),
                            deq(w.z, sc, z), deq(w.w, sc, z));
      }
    } else {
      for (int64_t c = lane; c < dim; c += 32) dst[c] = deq(src[c], sc, z);
    }
  }
}

// 1-D gather, one id a thread: out[i] = table[ids[i]], -1 where
// ids[i] < 0.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
gather_elems_kernel(const T* __restrict__ table, const I* __restrict__ ids,
                    int64_t n_ids, int64_t n_rows, T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_ids; i += stride) {
    const int64_t id = ids[i];
    out[i] = id < 0 ? static_cast<T>(-1) : table[clamp_id(id, n_rows)];
  }
}

// Words a lane of the span gather loads before it stores any.
constexpr int kSpanUnroll = 4;

// The span gather (gather_segments_kernel): out[i, j] = table[start[i] + j]
// for j < count[i], -1 for count[i] <= j < width and where start[i] + j
// is negative; an index past the table is clamped into it. That is the
// flat gather over the ids where(j < count, start + j, -1), with no id
// array: each seed's words are one consecutive span of the table.
// 2^lanes_log2 lanes a seed (the least power of two >= width, at most
// 32). At width 2 (the indptr heads) a lane pair a seed, 16 seeds a
// warp, so one load instruction asks for both words of a seed in the
// same sector. At width >= 17 (the weighted pool: 2048) a warp a seed,
// whose lanes read the span in 32-word runs aligned to 32 words of the
// table, so each load instruction asks for one aligned 128-byte line (of
// 4-byte words) and no line twice: reading from the span's own start, a
// run straddles two lines, and the pool asked for 35% more lines (0.72
// against 0.64-0.71 ms own, NVIDIA H100 80GB HBM3, 700 W; kernel_ab.py
// --old-elems). Past count a lane loads nothing and stores -1; stores go
// out in consecutive words of the row-major output. The lanes of a seed
// share its start and count loads (one request each).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_segments_kernel(const T* __restrict__ table,
                       const int64_t* __restrict__ start,
                       const int* __restrict__ count, int64_t n_seeds,
                       int64_t n_rows, int width, int lanes_log2,
                       T* __restrict__ out) {
  const int lanes = 1 << lanes_log2;
  const int g = threadIdx.x & (lanes - 1);
  const int64_t step =
      (static_cast<int64_t>(gridDim.x) * kThreads) >> lanes_log2;
  for (int64_t i =
           (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >>
           lanes_log2;
       i < n_seeds; i += step) {
    const int64_t s0 = start[i];
    const int c = count[i];
    const int n = c < 0 ? 0 : (c < width ? c : width);
    T* dst = out + i * width;
    // a warp a seed: the words of the span's first aligned run before it
    const int lead = lanes < 32 ? 0 : static_cast<int>(
        (reinterpret_cast<uintptr_t>(table) / sizeof(T) +
         static_cast<uint64_t>(s0)) & 31);
    for (int j0 = g - lead; j0 < n; j0 += lanes * kSpanUnroll) {
      T v[kSpanUnroll];
#pragma unroll
      for (int u = 0; u < kSpanUnroll; ++u) {
        const int j = j0 + u * lanes;
        const int64_t id = s0 + j;
        v[u] = static_cast<T>(-1);
        if (j >= 0 && j < n && id >= 0)
          v[u] = table[id < n_rows ? id : n_rows - 1];
      }
#pragma unroll
      for (int u = 0; u < kSpanUnroll; ++u) {
        const int j = j0 + u * lanes;
        if (j >= 0 && j < n) dst[j] = v[u];
      }
    }
    for (int j0 = n + g; j0 < width; j0 += lanes * kSpanUnroll) {
#pragma unroll
      for (int u = 0; u < kSpanUnroll; ++u) {
        const int j = j0 + u * lanes;
        if (j < width) dst[j] = static_cast<T>(-1);
      }
    }
  }
}

// The lanes a seed of the span gather takes, as a power of two: the
// least 2^l >= width, at most 32.
int span_lanes_log2(int width) {
  int l = 0;
  while (l < 5 && (1 << l) < width) ++l;
  return l;
}

constexpr int kMaxShards = 64;        // blocks whose table fits in shared

// The block that holds row `id` of a sharded table: the last s with
// off[s] <= id (an empty block is never the answer for an id below
// off[n]).
__device__ __forceinline__ int find_shard(const int64_t* off, int n,
                                          int64_t id) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= id)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Where the rows of a sharded table lie: its blocks' addresses and row
// offsets (in shared memory, or in global memory past kMaxShards blocks).
struct ShardedRows {
  const int64_t* ptr;
  const int64_t* off;
  int n;
  int64_t stride;
  // The address of row `id`, which lies in [0, off[n]).
  __device__ __forceinline__ const char* operator()(int64_t id) const {
    const int s = find_shard(off, n, id);
    return reinterpret_cast<const char*>(ptr[s]) + (id - off[s]) * stride;
  }
  __device__ __forceinline__ int64_t rows() const { return off[n]; }
};

// The table of a sharded gather: copied into the block's shared memory
// when it has at most kMaxShards blocks (the same count in every thread,
// so the barrier is uniform), else read where it lies.
__device__ __forceinline__ ShardedRows
shard_table(const int64_t* __restrict__ ptrs,
            const int64_t* __restrict__ offs, int n_shards, int64_t stride,
            int64_t* s_ptr, int64_t* s_off) {
  if (n_shards > kMaxShards) return ShardedRows{ptrs, offs, n_shards, stride};
  for (int i = threadIdx.x; i <= n_shards; i += blockDim.x) {
    s_off[i] = offs[i];
    if (i < n_shards) s_ptr[i] = ptrs[i];
  }
  __syncthreads();
  return ShardedRows{s_ptr, s_off, n_shards, stride};
}

// Raw rows of a sharded table, the loop design: each row's address found
// through the table.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_sharded_kernel(const int64_t* __restrict__ ptrs,
                           const int64_t* __restrict__ offs, int n_shards,
                           const int* __restrict__ ids, int64_t n_ids,
                           int64_t stride, int64_t row_vecs,
                           int skip_negative, V* __restrict__ out) {
  __shared__ int64_t s_ptr[kMaxShards], s_off[kMaxShards + 1];
  const ShardedRows rows =
      shard_table(ptrs, offs, n_shards, stride, s_ptr, s_off);
  raw_rows_loop<V>(rows, ids, n_ids, rows.rows(), row_vecs, skip_negative,
                   out);
}

// Raw rows of a sharded table, the tile design: each word's row found
// through the table.
template <typename V, int kPer>
__global__ void __launch_bounds__(kThreads)
gather_rows_sharded_tile_kernel(const int64_t* __restrict__ ptrs,
                                const int64_t* __restrict__ offs,
                                int n_shards, const int* __restrict__ ids,
                                int64_t n_ids, int64_t stride, int words,
                                int tile_rows, int skip_negative,
                                V* __restrict__ out) {
  __shared__ int64_t s_ptr[kMaxShards], s_off[kMaxShards + 1];
  const ShardedRows rows =
      shard_table(ptrs, offs, n_shards, stride, s_ptr, s_off);
  raw_rows_tile<V, kPer>(rows, ids, n_ids, rows.rows(), words, tile_rows,
                         skip_negative, out);
}

// Packed int8 rows of a sharded table (quant.pack's layout in every
// block), decoded to fp32: the packed gather's design, each group's rows
// found through the table.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
gather_rows_sharded_packed_kernel(const int64_t* __restrict__ ptrs,
                                  const int64_t* __restrict__ offs,
                                  int n_shards, const int* __restrict__ ids,
                                  int64_t n_ids, int64_t stride, int64_t dim,
                                  int side, int skip_negative,
                                  float* __restrict__ out) {
  __shared__ int64_t s_ptr[kMaxShards], s_off[kMaxShards + 1];
  const ShardedRows rows =
      shard_table(ptrs, offs, n_shards, stride, s_ptr, s_off);
  packed_rows<kVec4>(rows, ids, n_ids, rows.rows(), dim, side,
                     skip_negative, out);
}

// The same over a sharded table whose every block lies in device memory
// (this card's or a peer's): the HBM design, each unit's row found
// through the table.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
gather_rows_sharded_packed_hbm_kernel(const int64_t* __restrict__ ptrs,
                                      const int64_t* __restrict__ offs,
                                      int n_shards,
                                      const int* __restrict__ ids,
                                      int64_t n_ids, int64_t stride, int dim,
                                      int side, int tile_rows,
                                      int skip_negative,
                                      float* __restrict__ out) {
  __shared__ int64_t s_ptr[kMaxShards], s_off[kMaxShards + 1];
  const ShardedRows rows =
      shard_table(ptrs, offs, n_shards, stride, s_ptr, s_off);
  packed_rows_hbm<kVec4>(rows, ids, n_ids, rows.rows(), dim, side,
                         tile_rows, skip_negative, out);
}

// Blocks for `warps` warps of work, at most as many as the card holds at
// once for `kernel` (a grid-stride loop takes the rest).
template <typename K>
int grid_for(K kernel, int64_t warps, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (warps + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(want < most ? want : most);
  return 0;
}

// The device's address of a table pointer: itself in device memory, its
// mapping when it lies in pinned host memory.
cudaError_t device_address(const void* p, int on_host, const void** out) {
  *out = p;
  if (!on_host) return cudaSuccess;
  void* mapped = nullptr;
  const cudaError_t err =
      cudaHostGetDevicePointer(&mapped, const_cast<void*>(p), 0);
  if (err == cudaSuccess) *out = mapped;
  return err;
}

// The raw-row designs, numbered as the wrapper passes them (gather.py:
// RAW_DESIGNS).
enum RawDesign { kLoop = 0, kTile = 1 };

// A raw-row gather: a flat table (n_shards = 0: table, n_rows) or a
// sharded one (ptrs, offs, n_shards), its ids, row stride and bytes, and
// the output.
struct RawArgs {
  const void* table;
  int64_t n_rows;
  const void* ptrs;
  const void* offs;
  int n_shards;
  const void* ids;
  int64_t n_ids;
  int64_t stride;
  int64_t row_bytes;
  void* out;
  int skip_negative;
  cudaStream_t stream;
};

// The loop design in words V.
template <typename V>
int launch_loop(const RawArgs& a) {
  const int* ids = static_cast<const int*>(a.ids);
  const int64_t words = a.row_bytes / static_cast<int64_t>(sizeof(V));
  V* out = static_cast<V*>(a.out);
  int grid = 0, err = 0;
  if (a.n_shards == 0) {
    err = grid_for(gather_rows_kernel<V>, a.n_ids, &grid);
    if (err == 0)
      gather_rows_kernel<V><<<grid, kThreads, 0, a.stream>>>(
          static_cast<const char*>(a.table), ids, a.n_ids, a.n_rows,
          a.stride, words, a.skip_negative, out);
  } else {
    err = grid_for(gather_rows_sharded_kernel<V>, a.n_ids, &grid);
    if (err == 0)
      gather_rows_sharded_kernel<V><<<grid, kThreads, 0, a.stream>>>(
          static_cast<const int64_t*>(a.ptrs),
          static_cast<const int64_t*>(a.offs), a.n_shards, ids, a.n_ids,
          a.stride, words, a.skip_negative, out);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// The tile design in words V, kPer of them a store.
template <typename V, int kPer>
int launch_tile(const RawArgs& a) {
  const int* ids = static_cast<const int*>(a.ids);
  const int64_t words = a.row_bytes / static_cast<int64_t>(sizeof(V));
  const int tile_rows = tile_rows_for(words, kPer);
  const int64_t warps = (a.n_ids + tile_rows - 1) / tile_rows * kWarps;
  V* out = static_cast<V*>(a.out);
  int grid = 0, err = 0;
  if (a.n_shards == 0) {
    err = grid_for(gather_rows_tile_kernel<V, kPer>, warps, &grid);
    if (err == 0)
      gather_rows_tile_kernel<V, kPer><<<grid, kThreads, 0, a.stream>>>(
          static_cast<const char*>(a.table), ids, a.n_ids, a.n_rows,
          a.stride, static_cast<int>(words), tile_rows, a.skip_negative,
          out);
  } else {
    err = grid_for(gather_rows_sharded_tile_kernel<V, kPer>, warps, &grid);
    if (err == 0)
      gather_rows_sharded_tile_kernel<V, kPer>
          <<<grid, kThreads, 0, a.stream>>>(
              static_cast<const int64_t*>(a.ptrs),
              static_cast<const int64_t*>(a.offs), a.n_shards, ids, a.n_ids,
              a.stride, static_cast<int>(words), tile_rows, a.skip_negative,
              out);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// Whether `design` copies in words of `word` bytes, and those words
// divide the row and every address (`bits`: the OR of the table's or
// blocks' addresses, the row stride and the output's address).
bool raw_words_ok(int design, int word, uintptr_t bits, int64_t row_bytes) {
  const bool known =
      (design == kLoop && (word == 16 || word == 4 || word == 2 ||
                           word == 1)) ||
      (design == kTile && (word == 16 || word == 8 || word == 4 ||
                           word == 2 || word == 1));
  return known && row_bytes % word == 0 && bits % word == 0;
}

int launch_raw(const RawArgs& a, int design, int word, uintptr_t bits) {
  if (!raw_words_ok(design, word, bits, a.row_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (design == kLoop) {
    switch (word) {
      case 16:
        return launch_loop<uint4>(a);
      case 4:
        return launch_loop<uint32_t>(a);
      case 2:
        return launch_loop<uint16_t>(a);
      default:
        return launch_loop<uint8_t>(a);
    }
  }
  switch (word) {
    case 16:
      return launch_tile<uint4, 1>(a);
    case 8:  // two words a 16-byte store where the output allows
      return reinterpret_cast<uintptr_t>(a.out) % 16 == 0
                 ? launch_tile<uint2, 2>(a)
                 : launch_tile<uint2, 1>(a);
    case 4:
      return launch_tile<uint32_t, 1>(a);
    case 2:
      return launch_tile<uint16_t, 1>(a);
    default:
      return launch_tile<uint8_t, 1>(a);
  }
}

template <bool kVec4>
int launch_packed(const void* rows, const void* ids, int64_t n_ids,
                  int64_t n_rows, int64_t stride, int64_t dim, int side,
                  void* out, int skip_negative, cudaStream_t stream) {
  int grid = 0;
  const int err = grid_for(gather_rows_packed_kernel<kVec4>,
                           (n_ids + 31) / 32, &grid);
  if (err != 0) return err;
  gather_rows_packed_kernel<kVec4><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(rows), static_cast<const int*>(ids), n_ids,
      n_rows, stride / 16, dim, side, skip_negative,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec4>
int launch_packed_hbm(const void* rows, const void* ids, int64_t n_ids,
                      int64_t n_rows, int64_t stride, int64_t dim, int side,
                      void* out, int skip_negative, cudaStream_t stream) {
  const int tile_rows = hbm_tile_rows(dim, kVec4);
  int grid = 0;
  const int err = grid_for(gather_rows_packed_hbm_kernel<kVec4>,
                           (n_ids + tile_rows - 1) / tile_rows * kWarps,
                           &grid);
  if (err != 0) return err;
  gather_rows_packed_hbm_kernel<kVec4><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(rows), static_cast<const int*>(ids), n_ids,
      n_rows, stride, static_cast<int>(dim), side, tile_rows, skip_negative,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec4>
int launch_q8(const void* codes, const void* scale, const void* zero,
              const void* ids, int64_t n_ids, int64_t n_rows, int64_t dim,
              void* out, int skip_negative, cudaStream_t stream) {
  int grid = 0;
  const int err = grid_for(gather_rows_q8_kernel<kVec4>, n_ids, &grid);
  if (err != 0) return err;
  gather_rows_q8_kernel<kVec4><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
      static_cast<const float*>(zero), static_cast<const int*>(ids), n_ids,
      n_rows, dim, skip_negative, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int launch_elems(const void* table, const void* ids, int64_t n_ids,
                 int64_t n_rows, void* out, cudaStream_t stream) {
  int grid = 0;
  const int err = grid_for(gather_elems_kernel<T, I>, (n_ids + 31) / 32,
                           &grid);
  if (err != 0) return err;
  gather_elems_kernel<T, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const I*>(ids), n_ids, n_rows,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_segments(const void* table, const void* start, const void* count,
                    int64_t n_seeds, int64_t n_rows, int width, void* out,
                    cudaStream_t stream) {
  const int l = span_lanes_log2(width);
  int grid = 0;
  const int err = grid_for(gather_segments_kernel<T>,
                           ((n_seeds << l) + 31) / 32, &grid);
  if (err != 0) return err;
  gather_segments_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int64_t*>(start),
      static_cast<const int*>(count), n_seeds, n_rows, width, l,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec4>
int launch_sharded_packed(const void* ptrs, const void* offs, int n_shards,
                          const void* ids, int64_t n_ids, int64_t stride,
                          int64_t dim, int side, void* out,
                          int skip_negative, cudaStream_t stream) {
  int grid = 0;
  const int err = grid_for(gather_rows_sharded_packed_kernel<kVec4>,
                           (n_ids + 31) / 32, &grid);
  if (err != 0) return err;
  gather_rows_sharded_packed_kernel<kVec4><<<grid, kThreads, 0, stream>>>(
      static_cast<const int64_t*>(ptrs), static_cast<const int64_t*>(offs),
      n_shards, static_cast<const int*>(ids), n_ids, stride, dim, side,
      skip_negative, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec4>
int launch_sharded_packed_hbm(const void* ptrs, const void* offs,
                              int n_shards, const void* ids, int64_t n_ids,
                              int64_t stride, int64_t dim, int side,
                              void* out, int skip_negative,
                              cudaStream_t stream) {
  const int tile_rows = hbm_tile_rows(dim, kVec4);
  int grid = 0;
  const int err = grid_for(gather_rows_sharded_packed_hbm_kernel<kVec4>,
                           (n_ids + tile_rows - 1) / tile_rows * kWarps,
                           &grid);
  if (err != 0) return err;
  gather_rows_sharded_packed_hbm_kernel<kVec4>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const int64_t*>(ptrs),
          static_cast<const int64_t*>(offs), n_shards,
          static_cast<const int*>(ids), n_ids, stride,
          static_cast<int>(dim), side, tile_rows, skip_negative,
          static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool q8_vec4(const void* codes, const void* out, long long dim) {
  return dim % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

bool out_vec4(const void* out, long long dim) {
  return dim % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace

extern "C" {

// The values a lane of the separate-sidecar int8 gather decodes per word:
// 4 or 1.
int qt_gather_q8_vec(const void* codes, const void* out, long long dim) {
  return q8_vec4(codes, out, dim) ? 4 : 1;
}

// design: the raw-row design (0 the loop, 1 the tile design; gather.py:
// RAW_DESIGNS); word: the bytes a lane loads at once, which must divide
// row_bytes and the table's and out's addresses (the loop design 16, 4, 2
// or 1; the tile design 16, 8, 4, 2 or 1). Anything else is refused with
// cudaErrorInvalidValue.
int qt_gather_rows(const void* feat, int feat_on_host, const void* ids,
                   long long n_ids, long long n_rows, long long row_bytes,
                   void* out, int skip_negative, int design, int word,
                   void* stream) {
  const void* table = nullptr;
  const cudaError_t err = device_address(feat, feat_on_host, &table);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RawArgs a{table, n_rows, nullptr, nullptr, 0, ids, n_ids,
                  row_bytes, row_bytes, out, skip_negative,
                  static_cast<cudaStream_t>(stream)};
  const uintptr_t bits = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out);
  return launch_raw(a, design, word, bits);
}

// rows: the packed tier's base, 16-byte aligned; stride: its row stride
// in bytes, a multiple of 16; side: the scale's byte offset in a row, a
// multiple of 4 with scale and zero in one 16-byte word, at or past dim
// and with both sidecars inside the row.
int qt_gather_rows_packed(const void* rows, int table_on_host,
                          const void* ids, long long n_ids, long long n_rows,
                          long long stride, long long dim, long long side,
                          void* out, int skip_negative, void* stream) {
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0 || stride % 16 != 0 ||
      side % 4 != 0 || side % 16 > 8 || side < dim || side + 8 > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* table = nullptr;
  const cudaError_t err = device_address(rows, table_on_host, &table);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sd = static_cast<int>(side);
  const bool vec4 = out_vec4(out, dim);
  if (!table_on_host)
    return vec4 ? launch_packed_hbm<true>(table, ids, n_ids, n_rows, stride,
                                          dim, sd, out, skip_negative, s)
                : launch_packed_hbm<false>(table, ids, n_ids, n_rows, stride,
                                           dim, sd, out, skip_negative, s);
  if (vec4)
    return launch_packed<true>(table, ids, n_ids, n_rows, stride, dim, sd,
                               out, skip_negative, s);
  return launch_packed<false>(table, ids, n_ids, n_rows, stride, dim, sd,
                              out, skip_negative, s);
}

int qt_gather_rows_q8(const void* codes, const void* scale, const void* zero,
                      int table_on_host, const void* ids, long long n_ids,
                      long long n_rows, long long dim, void* out,
                      int skip_negative, void* stream) {
  const void *c = nullptr, *sc = nullptr, *z = nullptr;
  cudaError_t err = device_address(codes, table_on_host, &c);
  if (err == cudaSuccess) err = device_address(scale, table_on_host, &sc);
  if (err == cudaSuccess) err = device_address(zero, table_on_host, &z);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q8_vec4(c, out, dim))
    return launch_q8<true>(c, sc, z, ids, n_ids, n_rows, dim, out,
                           skip_negative, s);
  return launch_q8<false>(c, sc, z, ids, n_ids, n_rows, dim, out,
                          skip_negative, s);
}

// table: n_rows elements of elem_bytes (4 or 8) bytes, on the device or
// in pinned host memory; ids: n_ids ids of id_bytes (4 or 8) bytes on the
// device; out: n_ids elements on the device.
int qt_gather_elems(const void* table, int table_on_host, int elem_bytes,
                    const void* ids, int id_bytes, long long n_ids,
                    long long n_rows, void* out, void* stream) {
  if ((elem_bytes != 4 && elem_bytes != 8) || (id_bytes != 4 && id_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* t = nullptr;
  const cudaError_t err = device_address(table, table_on_host, &t);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return id_bytes == 4
               ? launch_elems<int32_t, int32_t>(t, ids, n_ids, n_rows, out, s)
               : launch_elems<int32_t, int64_t>(t, ids, n_ids, n_rows, out, s);
  return id_bytes == 4
             ? launch_elems<int64_t, int32_t>(t, ids, n_ids, n_rows, out, s)
             : launch_elems<int64_t, int64_t>(t, ids, n_ids, n_rows, out, s);
}

// table: n_rows elements of elem_bytes (4 or 8) bytes, on the device or
// in pinned host memory; start: n_seeds int64 and count: n_seeds int32 on
// the device; out: [n_seeds, width] elements on the device (width >= 1),
// out[i, j] = table[start[i] + j] for j < count[i], else -1.
int qt_gather_segments(const void* table, int table_on_host, int elem_bytes,
                       const void* start, const void* count,
                       long long n_seeds, long long n_rows, long long width,
                       void* out, void* stream) {
  if ((elem_bytes != 4 && elem_bytes != 8) || width < 1 || width > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* t = nullptr;
  const cudaError_t err = device_address(table, table_on_host, &t);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(width);
  return elem_bytes == 4
             ? launch_segments<int32_t>(t, start, count, n_seeds, n_rows, w,
                                        out, s)
             : launch_segments<int64_t>(t, start, count, n_seeds, n_rows, w,
                                        out, s);
}

// ptrs, offs: device int64 arrays of the n_shards (at least 1) block
// addresses, as the device sees them (qt_device_address), and of the
// n_shards + 1 row offsets; ptr_bits: the OR of the block addresses and
// the stride; any_on_host: 1 when a block
// lies in pinned host memory (packed rows then take the host design, else
// the HBM design); stride: the rows' stride in bytes in every block; side:
// -1 for raw rows of row_bytes bytes, else the scale's byte offset in a
// packed int8 row of dim codes (stride and every block base a multiple of
// 16, as qt_gather_rows_packed takes); design, word: for raw rows, as
// qt_gather_rows takes them.
int qt_gather_rows_sharded(const void* ptrs, const void* offs, int n_shards,
                           long long ptr_bits, int any_on_host,
                           const void* ids, long long n_ids, long long stride,
                           long long row_bytes, long long dim,
                           long long side, void* out, int skip_negative,
                           int design, int word, void* stream) {
  if (n_shards < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (side >= 0) {
    if (ptr_bits % 16 != 0 || side % 4 != 0 || side % 16 > 8 || side < dim ||
        side + 8 > stride)
      return static_cast<int>(cudaErrorInvalidValue);
    const int sd = static_cast<int>(side);
    if (!any_on_host)
      return out_vec4(out, dim)
                 ? launch_sharded_packed_hbm<true>(ptrs, offs, n_shards, ids,
                                                   n_ids, stride, dim, sd,
                                                   out, skip_negative, s)
                 : launch_sharded_packed_hbm<false>(ptrs, offs, n_shards,
                                                    ids, n_ids, stride, dim,
                                                    sd, out, skip_negative,
                                                    s);
    if (out_vec4(out, dim))
      return launch_sharded_packed<true>(ptrs, offs, n_shards, ids, n_ids,
                                         stride, dim, sd, out, skip_negative,
                                         s);
    return launch_sharded_packed<false>(ptrs, offs, n_shards, ids, n_ids,
                                        stride, dim, sd, out, skip_negative,
                                        s);
  }
  const RawArgs a{nullptr, 0, ptrs, offs, n_shards, ids, n_ids, stride,
                  row_bytes, out, skip_negative, s};
  const uintptr_t bits = static_cast<uintptr_t>(ptr_bits) |
                         reinterpret_cast<uintptr_t>(out);
  return launch_raw(a, design, word, bits);
}

// The address the device reads `p` at: `p` itself for device memory, its
// mapping for pinned host memory (on_host = 1).
int qt_device_address(const void* p, int on_host, void** out) {
  const void* addr = nullptr;
  const cudaError_t err = device_address(p, on_host, &addr);
  *out = const_cast<void*>(addr);
  return static_cast<int>(err);
}

// Lets `device` read and write the memory of `peer` (both CUDA ordinals,
// different cards). Access already enabled counts as success. The current
// device is restored.
int qt_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // take the error back off the thread
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

}  // extern "C"
