// Row gather for Hopper: out[i] = feat[ids[i]], from a table in device
// memory or in pinned host memory.
//
// Replaces the Pallas TPU kernel of quiver_tpu/ops/pallas/gather.py:
//   qt_gather_rows     <- gather_rows (_gather_kernel; pallas_call at
//                         gather.py:92)
//   qt_gather_rows_q8  <- the same gather over an int8 table with its
//                         per-row scale and zero, dequant fused (the JAX
//                         package's quant.gather_rows over a tier)
//
// Rows are copied as bytes, so qt_gather_rows serves every dtype (fp32,
// bf16, fp16, int8). One warp per output row, with a grid-stride loop over
// the rows (the shape of the reference's quiver_tensor_gather): a lane
// copies 16-byte vectors when the row's byte width is a multiple of 16 and
// both base pointers are 16-byte aligned, else 4-, 2- or 1-byte words.
// qt_gather_rows_q8 reads 4 codes a lane (char4) and writes 4 fp32 values
// (float4) when the width is a multiple of 4 and the bases allow, else one
// value; each value is __fadd_rn(__fmul_rn(code, scale), zero), a rounded
// multiply then a rounded add and never one FMA, as fused_hop.cu's leaf
// gather and the plain version round it. Offsets are int64; neither the
// width nor the id count is padded (the Pallas kernel's 128-lane and
// 256-row padding were Mosaic rules).
//
// Ids: with skip_negative = 0 every id must lie in [0, n_rows); one that
// does not is clamped into the table, so the kernel never reads outside
// it. With skip_negative = 1 (the wrappers' out= form) a negative id
// leaves its output row as it is and reads nothing: the tiered lookup
// predicates each branch's reads this way instead of waiting for the host
// to pick a branch.
//
// Host tables: with table_on_host = 1 the table pointers are pinned host
// memory (cudaHostAlloc, as torch's pin_memory allocates it), mapped into
// the device's address space with cudaHostGetDevicePointer; each warp's
// loads then cross PCIe (the reference's UVA gather, quiver_feature.cu).
//
// Bound on an H100: bytes. From device memory, 4 + 2 * row_bytes per id
// (the id, the row read, the row written) at 3.35 TB/s; from host memory,
// the rows read over PCIe at the pinned-to-device copy rate. The grid is a
// few blocks per SM, each warp keeping one row's loads in flight; staging
// rows with cp.async or TMA to keep more bytes in flight is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM

__device__ __forceinline__ int64_t clamp_id(int64_t id, int64_t n_rows) {
  return id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ feat, const int* __restrict__ ids,
                   int64_t n_ids, int64_t n_rows, int64_t row_vecs,
                   int skip_negative, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       r < n_ids; r += stride) {
    int64_t id = ids[r];
    if (skip_negative && id < 0) continue;  // warp-uniform: one row a warp
    id = clamp_id(id, n_rows);
    const V* src = feat + id * row_vecs;
    V* dst = out + r * row_vecs;
    for (int64_t c = lane; c < row_vecs; c += 32) dst[c] = src[c];
  }
}

__device__ __forceinline__ float deq(int8_t code, float sc, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(code), sc), z);
}

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

int grid_for(int64_t n_ids, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (n_ids + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
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

template <typename V>
int launch(const void* feat, const void* ids, int64_t n_ids, int64_t n_rows,
           int64_t row_bytes, void* out, int skip_negative,
           cudaStream_t stream) {
  int grid = 0;
  const int err = grid_for(n_ids, &grid);
  if (err != 0) return err;
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(feat), static_cast<const int*>(ids), n_ids,
      n_rows, row_bytes / static_cast<int64_t>(sizeof(V)), skip_negative,
      static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

int word_bytes(const void* feat, const void* out, long long row_bytes) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(feat) |
                       reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && at % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && at % 4 == 0) return 4;
  if (row_bytes % 2 == 0 && at % 2 == 0) return 2;
  return 1;
}

bool q8_vec4(const void* codes, const void* out, long long dim) {
  return dim % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace

extern "C" {

// The width in bytes of the words a lane copies for this table and output.
int qt_gather_word_bytes(const void* feat, const void* out,
                         long long row_bytes) {
  return word_bytes(feat, out, row_bytes);
}

// The values a lane of the int8 gather decodes per word: 4 or 1.
int qt_gather_q8_vec(const void* codes, const void* out, long long dim) {
  return q8_vec4(codes, out, dim) ? 4 : 1;
}

int qt_gather_rows(const void* feat, int feat_on_host, const void* ids,
                   long long n_ids, long long n_rows, long long row_bytes,
                   void* out, int skip_negative, void* stream) {
  const void* table = nullptr;
  const cudaError_t err = device_address(feat, feat_on_host, &table);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes(table, out, row_bytes)) {
    case 16:
      return launch<uint4>(table, ids, n_ids, n_rows, row_bytes, out,
                           skip_negative, s);
    case 4:
      return launch<uint32_t>(table, ids, n_ids, n_rows, row_bytes, out,
                              skip_negative, s);
    case 2:
      return launch<uint16_t>(table, ids, n_ids, n_rows, row_bytes, out,
                              skip_negative, s);
    default:
      return launch<uint8_t>(table, ids, n_ids, n_rows, row_bytes, out,
                             skip_negative, s);
  }
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
  int grid = 0;
  const int gerr = grid_for(n_ids, &grid);
  if (gerr != 0) return gerr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c8 = static_cast<const int8_t*>(c);
  const auto* sf = static_cast<const float*>(sc);
  const auto* zf = static_cast<const float*>(z);
  const auto* id = static_cast<const int*>(ids);
  auto* o = static_cast<float*>(out);
  if (q8_vec4(c, out, dim))
    gather_rows_q8_kernel<true><<<grid, kThreads, 0, s>>>(
        c8, sf, zf, id, n_ids, n_rows, dim, skip_negative, o);
  else
    gather_rows_q8_kernel<false><<<grid, kThreads, 0, s>>>(
        c8, sf, zf, id, n_ids, n_rows, dim, skip_negative, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
