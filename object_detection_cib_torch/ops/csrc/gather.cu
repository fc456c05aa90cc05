// Corpus row gather, out[k] = src[idx[k]], for Hopper (sm_90a).
//
// Replaces two TPU kernels of object_detection_cib_tpu/ops/pallas_gather.py:
// `gather_rows_planar` (whole (H, W) planes of a planar (N, C, H, W) corpus)
// and `gather_rows_flat` (rows of the tile-aligned (N, 8, D/8) byte view).
// Both copy whole rows of bytes, and row-major order makes a planar image
// one contiguous row of C*H*W bytes, so one kernel serves both: a row is
// `row_bytes` contiguous bytes, whatever shape the caller gives it.
//
// What bounds it on this card: bytes. Each gathered row is read once and
// written once (2 x 256 x 519,168 B per training step at 416, about 0.08 ms
// at 3.35 TB/s); there is no arithmetic.
//
// What the design does about it:
//  * 16-byte vector loads and stores where the row size and both base
//    pointers allow it (a 416 plane is 173,056 B = 10,816 x 16 B), bytes
//    otherwise;
//  * a 2-D grid, rows on y and a row's chunks on x, so one row is copied by
//    many blocks at once and a few rows already fill the card;
//  * each block reads its own row index; an index outside [0, n_src) makes
//    the row come out as zeros instead of reading out of bounds (the
//    wrapper's callers validate indices on the host).
// Nothing is allocated here; the launch goes on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 64;  // blocks per row at most

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ src, const int32_t* __restrict__ idx,
                   V* __restrict__ dst, long long n_src, long long row_len) {
  const long long k = blockIdx.y;
  long long r = idx[k];
  const bool ok = r >= 0 && r < n_src;
  if (!ok) r = 0;
  const V* s = src + r * row_len;
  V* d = dst + k * row_len;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < row_len;
       i += step) {
    V v = {};
    if (ok) v = s[i];
    d[i] = v;
  }
}

template <typename V>
cudaError_t launch(const void* src, const void* idx, void* dst, long long n_src,
                   int K, long long row_len, cudaStream_t stream) {
  long long chunks = (row_len + 4LL * kThreads - 1) / (4LL * kThreads);
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)chunks, (unsigned)K);
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<const int32_t*>(idx),
      static_cast<V*>(dst), n_src, row_len);
  return cudaGetLastError();
}

}  // namespace

// src: n_src rows of row_bytes each; idx: K int32 on the device; dst: K rows.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int odcib_gather_rows(const void* src, const void* idx, void* dst,
                                 long long n_src, int K, long long row_bytes,
                                 void* stream) {
  if (K <= 0 || row_bytes <= 0) return 0;
  if (K > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  const bool vec = row_bytes % 16 == 0 && (uintptr_t)src % 16 == 0 &&
                   (uintptr_t)dst % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) return (int)launch<uint4>(src, idx, dst, n_src, K, row_bytes / 16, s);
  return (int)launch<uint8_t>(src, idx, dst, n_src, K, row_bytes, s);
}
