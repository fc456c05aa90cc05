// Fused mosaic + axis-aligned affine warp, for Hopper (sm_90a).
//
// Replaces the TPU kernel object_detection_cib_tpu/ops/pallas_warp.py
// `warp_quadrants` (body `_kernel`). For each mosaic group g and output
// pixel (y, x), summed over the four source quadrants q:
//
//   out[g, c, y, x] = rint(114 + sum_q sum_{h,w} Wy[g,q][y,h]
//                           * (img[g,q,c,h,w] - 114) * Ax[g,q][x,w])
//
// where Wy and Ax are bilinear tap matrices with at most two non-zeros per
// row: row y of Wy has weight wy0 at h = jy0 and wy1 at h = jy0 + 1, row x
// of Ax has wx0 at w = jx0 and wx1 at w = jx0 + 1; a tap whose index lies
// outside [0, S) weighs nothing. The TPU kernel built Wy in registers but
// took Ax as a dense (G, 4, S, S) bf16 matrix (88.6 MB per step at 416) and
// multiplied mostly zeros on the matrix unit. Here both matrices stay as
// their tap scalars, (G, 4, S) each, and every output pixel is computed from
// at most 4 source pixels per quadrant and channel.
//
// Rounding follows the Pallas body step by step (bf16 operands, f32 sums,
// built with --fmad=false so nothing contracts):
//   ybl = bf16(bf16(wy0) * (img[jy0, w] - 114) + bf16(wy1) * (img[jy0+1, w] - 114))
//   res = bf16(wx0) * ybl[jx0] + bf16(wx1) * ybl[jx0 + 1]
//   acc = ((res_q0 + res_q1) + res_q2) + res_q3,  out = rint(acc + 114)
// Each product is exact in f32 (8-bit by 8-bit significands), and a dense
// dot whose only non-zero terms are two products sums to the same f32 value
// in any order, so the result is bit for bit the TPU kernel's and the plain
// version's (ops/warp.py `warp_quadrants_plain`). A quadrant whose two
// y-weights are zero for this row adds exact zeros and is skipped, as the
// TPU kernel skips its dead (row block, quadrant) steps.
//
// What bounds it on this card: bytes. The u8 source quadrants are read
// (64 x 4 x 3 x 416 x 416 B = 133 MB per step) and the bf16 output written
// (66 MB); ~40 operations per output pixel and channel are far below the
// f32 rate. One thread per output pixel position, neighbouring threads on
// neighbouring x, so the source reads of a warp fall on a few neighbouring
// cache lines of a row; each thread handles the three channels. Nothing is
// allocated here; the launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kFill = 114.0f;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_quadrants_kernel(const uint8_t* __restrict__ imgs,
                      const int32_t* __restrict__ jx0, const float* __restrict__ wx0,
                      const float* __restrict__ wx1, const int32_t* __restrict__ jy0,
                      const float* __restrict__ wy0, const float* __restrict__ wy1,
                      T* __restrict__ out, int S, int So) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= So * So) return;
  const int g = blockIdx.y;
  const int y = p / So;
  const int x = p - y * So;
  const long long plane = (long long)S * S;

  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int q = 0; q < 4; ++q) {
    const long long t = ((long long)g * 4 + q) * So;
    const int jy = jy0[t + y];
    const float ty0 = (jy >= 0 && jy < S) ? bf16r(wy0[t + y]) : 0.0f;
    const float ty1 = (jy + 1 >= 0 && jy + 1 < S) ? bf16r(wy1[t + y]) : 0.0f;
    if (ty0 == 0.0f && ty1 == 0.0f) continue;  // adds exact zeros
    const int jx = jx0[t + x];
    const float tx[2] = {(jx >= 0 && jx < S) ? bf16r(wx0[t + x]) : 0.0f,
                         (jx + 1 >= 0 && jx + 1 < S) ? bf16r(wx1[t + x]) : 0.0f};
    const uint8_t* src = imgs + ((long long)g * 4 + q) * 3 * plane;
    for (int c = 0; c < 3; ++c) {
      const uint8_t* pl = src + c * plane;
      float ybl[2] = {0.0f, 0.0f};
      for (int k = 0; k < 2; ++k) {
        if (tx[k] == 0.0f) continue;  // product with a zero weight
        const int col = jx + k;
        const float a = ty0 != 0.0f ? ty0 * ((float)pl[(long long)jy * S + col] - kFill) : 0.0f;
        const float b = ty1 != 0.0f ? ty1 * ((float)pl[(long long)(jy + 1) * S + col] - kFill) : 0.0f;
        ybl[k] = bf16r(a + b);
      }
      const float res = tx[0] * ybl[0] + tx[1] * ybl[1];
      acc[c] = acc[c] + res;
    }
  }
  T* o = out + (long long)g * 3 * So * So + p;
  for (int c = 0; c < 3; ++c) o[(long long)c * So * So] = from_f32<T>(rintf(acc[c] + kFill));
}

template <typename T>
int launch(const void* imgs, const void* jx0, const void* wx0, const void* wx1,
           const void* jy0, const void* wy0, const void* wy1, void* out, int G,
           int S, int So, void* stream) {
  if (G <= 0 || So <= 0) return 0;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((So * So + kThreads - 1) / kThreads), (unsigned)G);
  warp_quadrants_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(imgs), static_cast<const int32_t*>(jx0),
      static_cast<const float*>(wx0), static_cast<const float*>(wx1),
      static_cast<const int32_t*>(jy0), static_cast<const float*>(wy0),
      static_cast<const float*>(wy1), static_cast<T*>(out), S, So);
  return (int)cudaGetLastError();
}

}  // namespace

// imgs: (G, 4, 3, S, S) u8; tap arrays (G, 4, So) (j int32, w f32);
// out: (G, 3, So, So). Returns the cudaError_t of the launch (0 = success).
extern "C" int odcib_warp_quadrants_bf16(const void* imgs, const void* jx0,
                                         const void* wx0, const void* wx1,
                                         const void* jy0, const void* wy0,
                                         const void* wy1, void* out, int G,
                                         int S, int So, void* stream) {
  return launch<__nv_bfloat16>(imgs, jx0, wx0, wx1, jy0, wy0, wy1, out, G, S, So, stream);
}

extern "C" int odcib_warp_quadrants_f32(const void* imgs, const void* jx0,
                                        const void* wx0, const void* wx1,
                                        const void* jy0, const void* wy0,
                                        const void* wy1, void* out, int G,
                                        int S, int So, void* stream) {
  return launch<float>(imgs, jx0, wx0, wx1, jy0, wy0, wy1, out, G, S, So, stream);
}
