// HSV jitter of planar images, cv2-exact, for Hopper (sm_90a).
//
// Replaces the TPU kernel object_detection_cib_tpu/ops/pallas_hsv.py
// `hsv_planar` (body `_kernel`), which equals ops/augment.py `hsv_batch`
// with channel_axis=1. Per pixel, on the three planes of one image:
//   1. round (half to even) and clip to [0, 255]; channels (b, g, r) are
//      planes (0, 1, 2);
//   2. cv2's 8-bit BGR->HSV in integer fixed point (hsv_shift 12) with the
//      tables sdiv[v] = round(1044480 / v), hdiv[d] = round(122880 / d),
//      computed as floor((2a + i) / (2i)) (never a tie for 1 <= i <= 255),
//      entry 0 = 0;
//   3. the jitter: h' = floor((h * r0) mod 180) by two conditional
//      subtracts, s' = floor(clip(s * r1)), v' = floor(clip(v * r2));
//   4. cv2's 8-bit HSV->BGR in f32 sector math and floor(x * 255).
// Every f32 operation rounds on its own (built with --fmad=false) and keeps
// the plain version's order, the tables are filled by exact C++ `/` on
// positive operands, and `>>` of a negative int is arithmetic, so the result
// is bit for bit the plain version's (ops/hsv.py `hsv_planar_plain`).
//
// What bounds it on this card: bytes on paper (one read and one write of
// each pixel: 64 x 3 x 416 x 416 x 2 B each way in bf16, about 0.04 ms at
// 3.35 TB/s), but the ~75 integer and f32 operations per pixel position sit
// close behind (11 M positions x 75 over 132 SMs x 128 lanes at ~1.7 GHz is
// about 0.03 ms, and conversions, compares and integer multiplies run at
// half that rate), so both the width of the memory accesses and the
// instruction count matter.
//
// What the design does about it:
//  * each thread takes a run of kVec = 8 consecutive positions of one image
//    and moves each plane's run with 16-byte loads and stores (one for bf16,
//    two for f32); all of a thread's loads are under way before its arithmetic
//    starts (3 or 6 loads of 16 bytes in flight per thread, 35 registers for
//    bf16, so six blocks of 256 threads fit an SM; two runs per thread
//    measured 4% slower, streaming loads or stores no different);
//  * the two divisions per position are look-ups in cv2's 256-entry tables,
//    filled once per block into shared memory with the exact integer formula
//    (one entry of each per thread); neighbouring lanes read different
//    entries, which shared memory serves from its banks (a `__constant__`
//    table would serialise them);
//  * the image's three gains are read once per block (grid y = image);
//  * s' and v' stay in f32 between the clip and the sector math (floor of a
//    value in [0, 255] is the same number as its int32 round trip);
//  * index arithmetic is 32-bit inside an image; the image's base is one
//    64-bit product per thread.
// The 16-byte path needs the base pointers 16-byte aligned and the plane a
// multiple of 8 elements (416 x 416 and 640 x 640 are). Any other input runs
// the kVec = 1 instance of the same kernel (one position per thread,
// coalesced element loads), never the plain version.
// Nothing is allocated here; the launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecWide = 8;  // positions per thread on the 16-byte path

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kVec elements of T as they travel: 16-byte pieces, or one element.
template <typename T, int kVec> struct Packet {
  static constexpr int kPieces = (int)sizeof(T) * kVec / 16;
  uint4 q[kPieces];
};
template <typename T> struct Packet<T, 1> { T q; };

template <typename T, int kVec>
__device__ __forceinline__ Packet<T, kVec> load_packet(const T* __restrict__ p) {
  Packet<T, kVec> pk;
  if constexpr (kVec == 1) {
    pk.q = *p;
  } else {
#pragma unroll
    for (int i = 0; i < Packet<T, kVec>::kPieces; ++i) {
      pk.q[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    }
  }
  return pk;
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : (i == 1 ? q.y : (i == 2 ? q.z : q.w));
}

// Element k (a compile-time constant once the caller's loop is unrolled).
template <typename T, int kVec>
__device__ __forceinline__ float get(const Packet<T, kVec>& pk, int k) {
  if constexpr (kVec == 1) {
    return to_f32(pk.q);
  } else if constexpr (sizeof(T) == 2) {
    // bf16 is the upper half of an f32: element 2i in the low half-word
    const uint32_t w = word_of(pk.q[k / 8], (k % 8) / 2);
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float(word_of(pk.q[k / 4], k % 4));
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_packet(T* __restrict__ p, const float (&x)[kVec]) {
  if constexpr (kVec == 1) {
    *p = from_f32<T>(x[0]);
  } else if constexpr (sizeof(T) == 2) {
    uint32_t w[kVec / 2];
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
#pragma unroll
    for (int i = 0; i < kVec / 8; ++i) {
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    }
  }
}

__device__ __forceinline__ int quantize(float x) {
  // jnp.clip(jnp.round(x), 0, 255).astype(int32)
  return (int)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

__device__ __forceinline__ float floor_clip255(float x) {
  return floorf(fminf(fmaxf(x, 0.0f), 255.0f));
}

// One pixel position: (b, g, r) in, jittered (b, g, r) out.
__device__ __forceinline__ void hsv_pixel(float b_in, float g_in, float r_in,
                                          const int* __restrict__ sdiv,
                                          const int* __restrict__ hdiv,
                                          float r0, float r1, float r2,
                                          float& b_out, float& g_out, float& r_out) {
  const int bch = quantize(b_in);
  const int gch = quantize(g_in);
  const int rch = quantize(r_in);

  const int v = max(max(bch, gch), rch);
  const int vmin = min(min(bch, gch), rch);
  const int diff = v - vmin;
  const int s = (diff * sdiv[v] + 2048) >> 12;
  const int h_num = v == rch ? gch - bch
                  : (v == gch ? bch - rch + 2 * diff : rch - gch + 4 * diff);
  int h = (h_num * hdiv[diff] + 2048) >> 12;
  if (h < 0) h += 180;

  float hx = (float)h * r0;
  if (hx >= 360.0f) hx = hx - 360.0f;
  if (hx >= 180.0f) hx = hx - 180.0f;
  h = (int)floorf(hx);
  // floor(clip(.)) is an integer in [0, 255]: its int32 round trip is itself
  const float s_new = floor_clip255((float)s * r1);
  const float v_new = floor_clip255((float)v * r2);

  const float hf = (float)h * (float)(6.0 / 180.0);
  const float sf = s_new * (float)(1.0 / 255.0);
  const float vf = v_new * (float)(1.0 / 255.0);
  const float sector_f = floorf(hf);
  const float ff = hf - sector_f;
  const int sector = min((int)sector_f, 5);
  const float tab0 = vf;
  const float tab1 = vf * (1.0f - sf);
  const float tab2 = vf * (1.0f - sf * ff);
  const float tab3 = vf * (1.0f - sf * (1.0f - ff));
  const float bo = sector < 2 ? tab1 : (sector == 2 ? tab3 : (sector < 5 ? tab0 : tab2));
  const float go = sector == 0 ? tab3 : (sector < 3 ? tab0 : (sector == 3 ? tab2 : tab1));
  const float ro = sector == 1 ? tab2
                 : ((sector == 2 || sector == 3) ? tab1 : (sector == 4 ? tab3 : tab0));
  b_out = floor_clip255(bo * 255.0f);
  g_out = floor_clip255(go * 255.0f);
  r_out = floor_clip255(ro * 255.0f);
}

// Block (x, y): positions [x * kThreads * kVec, ...) of image y, kVec in a
// row per thread, so a warp's accesses are contiguous. `plane` is a multiple
// of kVec.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
hsv_planar_kernel(const T* __restrict__ img, const float* __restrict__ r,
                  T* __restrict__ out, int plane) {
  __shared__ int sdiv[256];
  __shared__ int hdiv[256];
  __shared__ float gain[3];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    sdiv[i] = i > 0 ? (2 * 1044480 + i) / (2 * i) : 0;
    hdiv[i] = i > 0 ? (2 * 122880 + i) / (2 * i) : 0;
  }
  if (threadIdx.x < 3) gain[threadIdx.x] = r[blockIdx.y * 3 + threadIdx.x];

  const size_t image = (size_t)blockIdx.y * 3 * (size_t)plane;
  img += image;
  out += image;
  const int p = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  const bool inside = p < plane;

  Packet<T, kVec> in[3];
  if (inside) {
#pragma unroll
    for (int c = 0; c < 3; ++c) in[c] = load_packet<T, kVec>(img + c * plane + p);
  }
  __syncthreads();
  if (!inside) return;
  const float r0 = gain[0], r1 = gain[1], r2 = gain[2];

  float b_out[kVec], g_out[kVec], r_out[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    hsv_pixel(get<T, kVec>(in[0], k), get<T, kVec>(in[1], k), get<T, kVec>(in[2], k),
              sdiv, hdiv, r0, r1, r2, b_out[k], g_out[k], r_out[k]);
  }
  store_packet<T, kVec>(out + p, b_out);
  store_packet<T, kVec>(out + plane + p, g_out);
  store_packet<T, kVec>(out + 2 * plane + p, r_out);
}

template <typename T>
int launch(const void* img, const void* r, void* out, int B, long long plane,
           void* stream) {
  if (B <= 0 || plane <= 0) return 0;
  // 32-bit offsets inside an image: 3 * plane + one block's span must fit
  if (B > 65535 || plane > (1LL << 29)) return (int)cudaErrorInvalidValue;
  const bool wide = plane % kVecWide == 0 &&
                    reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_block = (long long)kThreads * (wide ? kVecWide : 1);
  const dim3 grid((unsigned)((plane + per_block - 1) / per_block), (unsigned)B);
  const T* src = static_cast<const T*>(img);
  const float* gains = static_cast<const float*>(r);
  T* dst = static_cast<T*>(out);
  if (wide) {
    hsv_planar_kernel<T, kVecWide><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, gains, dst, (int)plane);
  } else {
    hsv_planar_kernel<T, 1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, gains, dst, (int)plane);
  }
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
