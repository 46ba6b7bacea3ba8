// Row gather for Hopper: out[i] = feat[ids[i]].
//
// Replaces the Pallas TPU kernel of quiver_tpu/ops/pallas/gather.py:
//   qt_gather_rows  <- gather_rows (_gather_kernel; pallas_call at
//                      gather.py:92)
//
// Rows are copied as bytes, so one kernel serves every dtype (fp32, bf16,
// fp16, int8). One warp per output row, with a grid-stride loop over the
// rows (the shape of the reference's quiver_tensor_gather): a lane copies
// 16-byte vectors when the row's byte width is a multiple of 16 and both
// base pointers are 16-byte aligned, else 4-, 2- or 1-byte words.
// Offsets are int64. Neither the width nor the id count is padded (the
// Pallas kernel's 128-lane and 256-row padding were Mosaic rules). Ids
// must lie in [0, n_rows); one that does not is clamped into the table,
// so the kernel never reads outside it.
//
// Bound on an H100: bytes, 4 + 2 * row_bytes per id (the id, the row
// read, the row written). The grid is a few blocks per SM, each warp
// keeping one row's loads in flight; staging rows with cp.async or TMA to
// keep more bytes in flight is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ feat, const int* __restrict__ ids,
                   int64_t n_ids, int64_t n_rows, int64_t row_vecs,
                   V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       r < n_ids; r += stride) {
    int64_t id = ids[r];
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    const V* src = feat + id * row_vecs;
    V* dst = out + r * row_vecs;
    for (int64_t c = lane; c < row_vecs; c += 32) dst[c] = src[c];
  }
}

template <typename V>
int launch(const void* feat, const void* ids, int64_t n_ids, int64_t n_rows,
           int64_t row_bytes, void* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (n_ids + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int grid = static_cast<int>(want < most ? want : most);
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(feat), static_cast<const int*>(ids), n_ids,
      n_rows, row_bytes / static_cast<int64_t>(sizeof(V)),
      static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The width in bytes of the words a lane copies for this table and output.
int qt_gather_word_bytes(const void* feat, const void* out,
                         long long row_bytes) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(feat) |
                       reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && at % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && at % 4 == 0) return 4;
  if (row_bytes % 2 == 0 && at % 2 == 0) return 2;
  return 1;
}

int qt_gather_rows(const void* feat, const void* ids, long long n_ids,
                   long long n_rows, long long row_bytes, void* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qt_gather_word_bytes(feat, out, row_bytes)) {
    case 16:
      return launch<uint4>(feat, ids, n_ids, n_rows, row_bytes, out, s);
    case 4:
      return launch<uint32_t>(feat, ids, n_ids, n_rows, row_bytes, out, s);
    case 2:
      return launch<uint16_t>(feat, ids, n_ids, n_rows, row_bytes, out, s);
    default:
      return launch<uint8_t>(feat, ids, n_ids, n_rows, row_bytes, out, s);
  }
}

}  // extern "C"
