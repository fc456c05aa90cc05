// HSV jitter of planar images, cv2-exact, for Hopper (sm_90a).
//
// Replaces the TPU kernel object_detection_cib_tpu/ops/pallas_hsv.py
// `hsv_planar` (body `_kernel`), which equals ops/augment.py `hsv_batch`
// with channel_axis=1. Per pixel, on the three planes of one image:
//   1. round (half to even) and clip to [0, 255]; channels (b, g, r) are
//      planes (0, 1, 2);
//   2. cv2's 8-bit BGR->HSV in integer fixed point (hsv_shift 12) with the
//      tables sdiv[v] = round(1044480 / v), hdiv[d] = round(122880 / d),
//      computed as floor((2a + i) / (2i)) (never a tie for 1 <= i <= 255);
//   3. the jitter: h' = floor((h * r0) mod 180) by two conditional
//      subtracts, s' = floor(clip(s * r1)), v' = floor(clip(v * r2));
//   4. cv2's 8-bit HSV->BGR in f32 sector math and floor(x * 255).
// Every f32 operation rounds on its own (built with --fmad=false), integer
// division is exact C++ `/` on positive operands, and `>>` of a negative
// int is arithmetic, so the result is bit for bit the plain version's
// (ops/hsv.py `hsv_planar_plain`).
//
// What bounds it on this card: bytes. One read and one write of each pixel
// (64 x 3 x 416 x 416 x 2 B each way in bf16, about 0.04 ms at 3.35 TB/s)
// against ~60 integer and f32 operations per pixel (~2 G operations, 0.03 ms
// at the card's f32 rate).
//
// What the design does about it: one thread per pixel position, reading the
// three planes (coalesced along the row) and writing the three results; the
// per-image gains are three scalars read per thread from a (B, 3) array.
// Nothing is allocated here; the launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int quantize(float x) {
  // jnp.clip(jnp.round(x), 0, 255).astype(int32)
  return (int)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

__device__ __forceinline__ float floor_clip255(float x) {
  return floorf(fminf(fmaxf(x, 0.0f), 255.0f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hsv_planar_kernel(const T* __restrict__ img, const float* __restrict__ r,
                  T* __restrict__ out, long long plane) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= plane) return;
  const long long base = (long long)blockIdx.y * 3 * plane + p;
  const int bch = quantize(to_f32(img[base]));
  const int gch = quantize(to_f32(img[base + plane]));
  const int rch = quantize(to_f32(img[base + 2 * plane]));

  const int v = max(max(bch, gch), rch);
  const int vmin = min(min(bch, gch), rch);
  const int diff = v - vmin;
  const int sdiv_v = v > 0 ? (2 * 1044480 + v) / (2 * v) : 0;
  const int hdiv_d = diff > 0 ? (2 * 122880 + diff) / (2 * diff) : 0;
  int s = (diff * sdiv_v + 2048) >> 12;
  const int h_num = v == rch ? gch - bch
                  : (v == gch ? bch - rch + 2 * diff : rch - gch + 4 * diff);
  int h = (h_num * hdiv_d + 2048) >> 12;
  if (h < 0) h += 180;

  const float r0 = r[blockIdx.y * 3 + 0];
  const float r1 = r[blockIdx.y * 3 + 1];
  const float r2 = r[blockIdx.y * 3 + 2];
  float hx = (float)h * r0;
  if (hx >= 360.0f) hx = hx - 360.0f;
  if (hx >= 180.0f) hx = hx - 180.0f;
  h = (int)floorf(hx);
  s = (int)floor_clip255((float)s * r1);
  const int vv = (int)floor_clip255((float)v * r2);

  const float hf = (float)h * (float)(6.0 / 180.0);
  const float sf = (float)s * (float)(1.0 / 255.0);
  const float vf = (float)vv * (float)(1.0 / 255.0);
  const float sector_f = floorf(hf);
  const float ff = hf - sector_f;
  const int sector = min((int)sector_f, 5);
  const float tab0 = vf;
  const float tab1 = vf * (1.0f - sf);
  const float tab2 = vf * (1.0f - sf * ff);
  const float tab3 = vf * (1.0f - sf * (1.0f - ff));
  const float b_out = sector < 2 ? tab1 : (sector == 2 ? tab3 : (sector < 5 ? tab0 : tab2));
  const float g_out = sector == 0 ? tab3 : (sector < 3 ? tab0 : (sector == 3 ? tab2 : tab1));
  const float r_out = sector == 1 ? tab2
                    : ((sector == 2 || sector == 3) ? tab1 : (sector == 4 ? tab3 : tab0));
  out[base] = from_f32<T>(floor_clip255(b_out * 255.0f));
  out[base + plane] = from_f32<T>(floor_clip255(g_out * 255.0f));
  out[base + 2 * plane] = from_f32<T>(floor_clip255(r_out * 255.0f));
}

template <typename T>
int launch(const void* img, const void* r, void* out, int B, long long plane,
           void* stream) {
  if (B <= 0 || plane <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((plane + kThreads - 1) / kThreads), (unsigned)B);
  hsv_planar_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(r),
      static_cast<T*>(out), plane);
  return (int)cudaGetLastError();
}

}  // namespace

// img/out: (B, 3, H, W) contiguous, plane = H * W; r: (B, 3) f32 gains.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int odcib_hsv_planar_bf16(const void* img, const void* r, void* out,
                                     int B, long long plane, void* stream) {
  return launch<__nv_bfloat16>(img, r, out, B, plane, stream);
}

extern "C" int odcib_hsv_planar_f32(const void* img, const void* r, void* out,
                                    int B, long long plane, void* stream) {
  return launch<float>(img, r, out, B, plane, stream);
}
