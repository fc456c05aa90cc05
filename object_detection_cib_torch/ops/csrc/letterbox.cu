// Letterbox of decoded RGB images into uint8 rows of a planar batch, for
// Hopper (sm_90a).
//
// The port's own kernel: it replaces no TPU kernel (the JAX package has no
// Pallas counterpart; its letterbox runs on the host). It ports the resize
// and pack of native/loader.cpp:75-118 (`resize_bilinear`,
// `resize_into_canvas`): image i, (h, w) RGB bytes at `offsets[i]` of one
// blob, is resized to longest side S (nh = lround(h * S / max(h, w)) in
// f32, at least 1, at most S), bilinear with the pixel-centre convention
// and both source taps clamped at the edges, and written at the top-left
// (or, with `center`, at ((S - nh) / 2, (S - nw) / 2)) of an S x S canvas
// filled with 114; (nh, nw) goes to `sizes`. An image with h or w 0 (a
// file that failed to decode) gives a canvas of 114 and sizes (0, 0).
//
// Bitwise the library: native/Makefile builds loader.cpp with -O3
// -march=native, and the compiler contracts five multiply-adds into fused
// ones: fy = fma(y + 0.5, sy, -0.5), the same for fx, and each of the three
// lerps a * (1 - w) + b * w as fma(a, 1 - w, b * w). This file is built
// with --fmad=false (ops/build.py), so exactly those five are spelled
// `__fmaf_rn` and every other operation rounds on its own; `lroundf` rounds
// half away from zero as std::lround does.
//
// What bounds it on this card: bytes. Each source byte is read about once
// and each output byte written once (256 images of 640 x 640 into 416 x 416
// rows: 447 MB, 0.13 ms at 3.35 TB/s); about 50 operations a pixel are far
// below the card's rate. The design is the simple one: a thread an output
// pixel, its 12 source bytes read through L1, its three channel bytes
// written to three planes, so a warp's stores are 32 neighbouring bytes of
// each plane. The output is addressed by strides, so one kernel fills
// planar rows (the corpus, a host-fed group) and NHWC rows (the validation
// cache). Nothing is allocated here; the launch goes on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint8_t kFill = 114;

// loader.cpp:109-113: lround(n * scale), at least 1, at most S.
__device__ __forceinline__ int content_len(int n, float scale, int S) {
  const int r = (int)lroundf(__fmul_rn((float)n, scale));
  return min(max(r, 1), S);
}

__global__ void __launch_bounds__(kThreads)
letterbox_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ offsets,
                 const int* __restrict__ hw, int S, int center, uint8_t* __restrict__ out,
                 long long s_img, long long s_ch, long long s_row, long long s_col,
                 int* __restrict__ sizes) {
  const int i = blockIdx.y;
  const int h = hw[2 * i], w = hw[2 * i + 1];
  int nh = 0, nw = 0;
  float sy = 0.f, sx = 0.f;
  if (h > 0 && w > 0) {
    const float scale = __fdiv_rn((float)S, (float)max(h, w));
    nh = content_len(h, scale, S);
    nw = content_len(w, scale, S);
    sy = __fdiv_rn((float)h, (float)nh);
    sx = __fdiv_rn((float)w, (float)nw);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sizes[2 * i] = nh;
    sizes[2 * i + 1] = nw;
  }
  const int top = center ? (S - nh) / 2 : 0;
  const int left = center ? (S - nw) / 2 : 0;
  const uint8_t* img = src + offsets[i];
  uint8_t* o = out + i * s_img;
  const long long plane = (long long)S * S;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < plane;
       p += (long long)gridDim.x * blockDim.x) {
    const int yy = (int)(p / S), xx = (int)(p % S);
    const int y = yy - top, x = xx - left;
    uint8_t v[3] = {kFill, kFill, kFill};
    if (y >= 0 && y < nh && x >= 0 && x < nw) {
      const float fy = __fmaf_rn(__fadd_rn((float)y, 0.5f), sy, -0.5f);
      const int y0 = (int)floorf(fy);
      const float wy = __fsub_rn(fy, (float)y0);
      const int y0c = min(max(y0, 0), h - 1), y1c = min(max(y0 + 1, 0), h - 1);
      const float fx = __fmaf_rn(__fadd_rn((float)x, 0.5f), sx, -0.5f);
      const int x0 = (int)floorf(fx);
      const float wx = __fsub_rn(fx, (float)x0);
      const int x0c = min(max(x0, 0), w - 1), x1c = min(max(x0 + 1, 0), w - 1);
      const uint8_t* r0 = img + (long long)y0c * w * 3;
      const uint8_t* r1 = img + (long long)y1c * w * 3;
      const float omx = __fsub_rn(1.f, wx), omy = __fsub_rn(1.f, wy);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t = __fmaf_rn((float)r0[x0c * 3 + c], omx, __fmul_rn((float)r0[x1c * 3 + c], wx));
        const float b = __fmaf_rn((float)r1[x0c * 3 + c], omx, __fmul_rn((float)r1[x1c * 3 + c], wx));
        const float val = __fmaf_rn(t, omy, __fmul_rn(b, wy));
        v[c] = (uint8_t)lroundf(fminf(fmaxf(val, 0.f), 255.f));
      }
    }
    uint8_t* q = o + yy * s_row + xx * s_col;
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c * s_ch] = v[c];
  }
}

}  // namespace

// n images (n <= 65535) of a blob into out, element strides s_img, s_ch,
// s_row, s_col of an (n, 3, S, S) view; sizes (n, 2) int32. offsets (n,)
// int64 and hw (n, 2) int32 on the device. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int odcib_letterbox(const void* src, const void* offsets, const void* hw, int n, int S,
                               int center, void* out, long long s_img, long long s_ch,
                               long long s_row, long long s_col, void* sizes, void* stream) {
  if (n <= 0 || S <= 0) return 0;
  const long long plane = (long long)S * S;
  long long blocks = (plane + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  dim3 grid((unsigned)blocks, (unsigned)n);
  letterbox_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(src), static_cast<const long long*>(offsets),
      static_cast<const int*>(hw), S, center, static_cast<uint8_t*>(out), s_img, s_ch, s_row,
      s_col, static_cast<int*>(sizes));
  return (int)cudaGetLastError();
}
