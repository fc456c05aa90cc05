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
// The design: a vector copy with the widest element (16, 8, 4, 2 or 1
// bytes) that the row size and both base pointers allow, on a grid of
// (chunks of a row) x (rows), striding over rows so any K is taken. Each
// thread issues kUnroll loads before its first store, so every thread keeps
// kUnroll 16-byte loads in flight at 416 and 640. An index outside
// [0, n_src) gives a zero row (the wrapper's callers validate indices on
// the host). A persistent grid of TMA 1-D bulk copies through a
// shared-memory ring was measured slower than this copy on the training
// step's shape and was dropped (PERF.md, PR 3).
// Nothing is allocated here; the launch goes on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // loads in flight per thread
constexpr int kMaxChunks = 64;  // blocks per row

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ src, const int32_t* __restrict__ idx,
                   V* __restrict__ dst, long long n_src, long long row_len, int K) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long k = blockIdx.y; k < K; k += gridDim.y) {
    long long r = idx[k];
    const bool ok = r >= 0 && r < n_src;
    if (!ok) r = 0;
    const V* s = src + r * row_len;
    V* d = dst + k * row_len;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < row_len;
         i += kUnroll * step) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = V{};
        if (ok && i + u * step < row_len) v[u] = s[i + u * step];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i + u * step < row_len) d[i + u * step] = v[u];
    }
  }
}

template <typename V>
cudaError_t launch(const void* src, const void* idx, void* dst, long long n_src, int K,
                   long long row_bytes, cudaStream_t stream) {
  const long long row_len = row_bytes / (long long)sizeof(V);
  long long chunks = (row_len + kUnroll * kThreads - 1) / (kUnroll * kThreads);
  chunks = chunks < 1 ? 1 : (chunks > kMaxChunks ? kMaxChunks : chunks);
  dim3 grid((unsigned)chunks, (unsigned)(K < 65535 ? K : 65535));
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<const int32_t*>(idx), static_cast<V*>(dst),
      n_src, row_len, K);
  return cudaGetLastError();
}

}  // namespace

// src: n_src rows of row_bytes each; idx: K int32 on the device; dst: K rows.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int odcib_gather_rows(const void* src, const void* idx, void* dst,
                                 long long n_src, int K, long long row_bytes,
                                 void* stream) {
  if (K <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t both = (uintptr_t)src | (uintptr_t)dst | (uintptr_t)row_bytes;
  if (both % 16 == 0) return (int)launch<uint4>(src, idx, dst, n_src, K, row_bytes, s);
  if (both % 8 == 0) return (int)launch<uint2>(src, idx, dst, n_src, K, row_bytes, s);
  if (both % 4 == 0) return (int)launch<uint32_t>(src, idx, dst, n_src, K, row_bytes, s);
  if (both % 2 == 0) return (int)launch<uint16_t>(src, idx, dst, n_src, K, row_bytes, s);
  return (int)launch<uint8_t>(src, idx, dst, n_src, K, row_bytes, s);
}
