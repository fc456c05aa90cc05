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
// their tap scalars, (G, 4, So) each, and every output pixel is computed
// from at most 4 source pixels per quadrant and channel.
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
// y-weights are zero for a row, or whose x-taps are all zero, adds exact
// zeros and is skipped, as the TPU kernel skips its dead (row block,
// quadrant) steps.
//
// What bounds it on this card: bytes. The source pixels the taps reach
// (~36 MB of the 133 MB of u8 quadrants per step at 416), the taps (2.6 MB)
// and the bf16 output (66.5 MB); the ~12 operations per live (quadrant,
// row), pixel and channel are far below the f32 rate. What a design must
// avoid is load instructions: one thread per output pixel issues up to 48
// single-byte global loads and two y-passes per pixel, and an x-pass per
// channel reads every tap three times.
//
// The design: one block per (group g, band of kBand output rows). The block
// stages the four quadrants' x-taps in shared memory once (both indices
// and the bf16-rounded, range-masked weights packed in 8 bytes), the band's
// y-taps, and each quadrant's x-window (the source columns its live x-taps
// reach). Then every warp works on its own output rows with no block
// barrier. A lane holds kIters output columns (x = lane + 32 i) of all three
// channels in registers, and the live quadrants of the row accumulate into
// them in order:
//  * per live quadrant (a "step"), the source rows jy0 and jy0 + 1 of the
//    three channels over the x-window are copied into the warp's shared
//    memory with `cp.async` (16 bytes a copy where S is a multiple of 16),
//    and the copy of the next step is in flight while this step computes;
//  * the y-pass `ybl` is computed once per source column of the window and
//    channel, 4 columns a lane, and kept in shared memory as bf16 (exact:
//    it is rounded to bf16 anyway);
//  * the x-pass reads each tap once for the three channels and `ybl` as
//    16-bit words; consecutive lanes on consecutive output columns read
//    neighbouring words, so the reads are free of bank conflicts;
//  * after the row's last step, every lane stores its columns: a warp
//    writes 64 (bf16) or 128 (f32) contiguous bytes at once;
//  * whether a quadrant is live is a property of the row, the same for the
//    whole warp: the skip does not diverge.
// Any tap values are taken (random, non-monotone, out of range). Source
// rows are not reused between output rows in shared memory: that reuse is
// left to L2, which holds the whole step's live source. A row wider than
// 32 kIters columns takes several passes, each with its own y-passes.
// Nothing is allocated here; the launch goes on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block, each on its own rows
constexpr int kThreads = 32 * kWarps;
constexpr int kBand = 32;  // output rows per block
constexpr int kRaw = 2;    // source-row buffers per warp: copies run one step ahead
constexpr int kIters = 13;  // output columns per lane and pass
// blocks per SM that the register allocation leaves room for: 3 caps a
// thread at 85 registers, and 3 blocks of 74,816 B fit the shared memory
// at S = So = 416
constexpr int kMinBlocks = 3;
constexpr int kCols = 32 * kIters;  // output columns per pass
constexpr float kFill = 114.0f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ constexpr int up(int n) { return (n + 15) / 16 * 16; }

// Shared-memory layout of one block, in bytes (every part 16-aligned).
struct Layout {
  int tap, jy, ty0, ty1, win, warp, per_warp, total;
  __host__ __device__ Layout(int S, int So) {
    tap = 0;                         // uint2 [4 q][So]: {j0 | j1 << 16, bf16 wx0 | bf16 wx1 << 16}
    jy = tap + up(4 * So * 8);       // int32 [kBand][4]
    ty0 = jy + up(kBand * 4 * 4);    // f32 [kBand][4]
    ty1 = ty0 + up(kBand * 4 * 4);   // f32 [kBand][4]
    win = ty1 + up(kBand * 4 * 4);   // int32 [4][4]: x-window [lo, hi], live output columns [lo, hi]
    warp = win + up(4 * 4 * 4);      // per warp: u8 raw [kRaw][3 c][2 rows][S], bf16 ybl [3 c][S]
    per_warp = up(kRaw * 6 * S) + up(3 * S * 2);
    total = warp + kWarps * per_warp;
  }
};

// SEG: bytes per source-row copy (16 where S is a multiple of 16, 4 where it
// is a multiple of 4, else 1, copied without cp.async).
template <typename T, int SEG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
warp_quadrants_kernel(const uint8_t* __restrict__ imgs,
                      const int32_t* __restrict__ jx0, const float* __restrict__ wx0,
                      const float* __restrict__ wx1, const int32_t* __restrict__ jy0,
                      const float* __restrict__ wy0, const float* __restrict__ wy1,
                      T* __restrict__ out, int S, int So) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(S, So);
  uint2* s_tap = reinterpret_cast<uint2*>(smem + L.tap);
  int* s_jy = reinterpret_cast<int*>(smem + L.jy);
  float* s_ty0 = reinterpret_cast<float*>(smem + L.ty0);
  float* s_ty1 = reinterpret_cast<float*>(smem + L.ty1);
  int* s_win = reinterpret_cast<int*>(smem + L.win);

  const int g = blockIdx.y;
  const int y0 = blockIdx.x * kBand;
  const int rows = min(kBand, So - y0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tap0 = (long long)g * 4 * So;
  const long long plane = (long long)S * S;

  // ---- stage the taps, then the x-windows (block-wide, once)
  for (int i = tid; i < 4 * rows; i += kThreads) {
    const int r = i >> 2, q = i & 3;
    const long long t = tap0 + (long long)q * So + y0 + r;
    const int jy = jy0[t];
    s_jy[i] = jy;
    s_ty0[i] = (jy >= 0 && jy < S) ? bf16r(wy0[t]) : 0.0f;
    s_ty1[i] = (jy + 1 >= 0 && jy + 1 < S) ? bf16r(wy1[t]) : 0.0f;
  }
#pragma unroll 4
  for (int i = tid; i < 4 * So; i += kThreads) {
    const int jx = jx0[tap0 + i];
    const __nv_bfloat16 a = __float2bfloat16_rn((jx >= 0 && jx < S) ? wx0[tap0 + i] : 0.0f);
    const __nv_bfloat16 b = __float2bfloat16_rn((jx + 1 >= 0 && jx + 1 < S) ? wx1[tap0 + i] : 0.0f);
    s_tap[i] = make_uint2((uint32_t)jx, (uint32_t)__bfloat16_as_ushort(a) |
                                            ((uint32_t)__bfloat16_as_ushort(b) << 16));  // jx fixed below
  }
  if (tid < 4) {
    s_win[4 * tid] = s_win[4 * tid + 2] = S << 16;  // lo
    s_win[4 * tid + 1] = s_win[4 * tid + 3] = -1;   // hi
  }
  __syncthreads();
  {
    // per quadrant, what this thread's live taps reach: the x-window [lo, hi]
    // and the live output columns [xlo, xhi]
    int lo[4], hi[4], xlo[4], xhi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) lo[q] = xlo[q] = S << 16, hi[q] = xhi[q] = -1;
    for (int x = tid; x < So; x += kThreads) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint2 t = s_tap[q * So + x];
        const int jx = (int)t.x;
        if (lo_bf16(t.y) != 0.0f) lo[q] = min(lo[q], jx), hi[q] = max(hi[q], jx);
        if (hi_bf16(t.y) != 0.0f) lo[q] = min(lo[q], jx + 1), hi[q] = max(hi[q], jx + 1);
        if ((t.y & 0x7fff7fffu) != 0u) xlo[q] = min(xlo[q], x), xhi[q] = max(xhi[q], x);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo[q] = __reduce_min_sync(0xffffffffu, lo[q]);
      hi[q] = __reduce_max_sync(0xffffffffu, hi[q]);
      xlo[q] = __reduce_min_sync(0xffffffffu, xlo[q]);
      xhi[q] = __reduce_max_sync(0xffffffffu, xhi[q]);
      if (lane == 0 && lo[q] <= hi[q]) {
        atomicMin(&s_win[4 * q], lo[q]);
        atomicMax(&s_win[4 * q + 1], hi[q]);
        atomicMin(&s_win[4 * q + 2], xlo[q]);
        atomicMax(&s_win[4 * q + 3], xhi[q]);
      }
    }
  }
  __syncthreads();
  // the taps' two indices, each inside its quadrant's window (an index whose
  // weight is zero points at the window's first column, so no read of ybl
  // needs a guard: a zero weight times a finite ybl changes no output bit)
  for (int i = tid; i < 4 * So; i += kThreads) {
    const uint2 t = s_tap[i];
    const int jx = (int)t.x, lo = s_win[4 * (i / So)];
    const int j0 = lo_bf16(t.y) != 0.0f ? jx : lo;
    const int j1 = hi_bf16(t.y) != 0.0f ? jx + 1 : lo;
    s_tap[i].x = (uint32_t)j0 | ((uint32_t)j1 << 16);
  }
  __syncthreads();

  // ---- each warp on its own rows
  uint8_t* w_raw = smem + L.warp + warp * L.per_warp;  // [kRaw][3][2][S]
  __nv_bfloat16* w_ybl = reinterpret_cast<__nv_bfloat16*>(w_raw + up(kRaw * 6 * S));  // [3][S]
  const unsigned short* yb16 = reinterpret_cast<const unsigned short*>(w_ybl);
  const uint8_t* src_g = imgs + (long long)g * 4 * 3 * plane;

  // quadrants that add anything to row r
  auto row_mask = [&](int r) {
    unsigned mask = 0;
    for (int q = 0; q < 4; ++q)
      if ((s_ty0[r * 4 + q] != 0.0f || s_ty1[r * 4 + q] != 0.0f) && s_win[4 * q] <= s_win[4 * q + 1])
        mask |= 1u << q;
    return mask;
  };
  // The warp's steps, in order: its rows r = warp, warp + kWarps, ..., each
  // row's passes, each pass's live quadrants. A step's source rows (2 rows x
  // 3 channels over the x-window) are copied into buffer (step % kRaw),
  // kRaw - 1 steps ahead of its y-pass, across row ends too. The copy walker
  // is at row cr, pass cxb, with the quadrants cm of that pass still to copy.
  int cr = warp, cxb = 0, copied = 0;
  unsigned cm = warp < rows ? row_mask(warp) : 0u;
  auto copy_next = [&]() {
    while (cm == 0 && cr < rows) {
      cxb += kCols;
      if (cxb >= So) cxb = 0, cr += kWarps;
      if (cr < rows) cm = row_mask(cr);
    }
    if (cm != 0) {
      const int q = __ffs(cm) - 1;
      cm &= cm - 1;
      const float t0 = s_ty0[cr * 4 + q], t1 = s_ty1[cr * 4 + q];
      const int s0 = s_win[4 * q] / SEG;
      const int n = s_win[4 * q + 1] / SEG + 1 - s0;
      const uint8_t* from = src_g + q * 3 * plane + (long long)s_jy[cr * 4 + q] * S + s0 * SEG;
      uint8_t* to = w_raw + (copied % kRaw) * 6 * S + s0 * SEG;
      ++copied;
#pragma unroll
      for (int ck = 0; ck < 6; ++ck) {  // channel ck / 2, row jy0 + ck % 2
        if ((ck & 1 ? t1 : t0) == 0.0f) continue;  // the row weighs nothing (and may lie outside [0, S))
        const uint8_t* f = from + (ck >> 1) * plane + (ck & 1) * S;
        uint8_t* d = to + ck * S;
        for (int u = lane; u < n; u += 32) {
          if constexpr (SEG == 16)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         ::"r"(smem_addr(d + u * 16)), "l"(f + u * 16) : "memory");
          else if constexpr (SEG == 4)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                         ::"r"(smem_addr(d + u * 4)), "l"(f + u * 4) : "memory");
          else
            d[u] = f[u];
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // empty past the last step
  };

  for (int k = 0; k < kRaw - 1; ++k) copy_next();
  int done = 0;  // steps computed
  for (int r = warp; r < rows; r += kWarps) {
    const int y = y0 + r;
    const unsigned mask = row_mask(r);
    for (int xb = 0; xb < So; xb += kCols) {  // one pass at So <= kCols
      float acc[kIters][3];
#pragma unroll
      for (int i = 0; i < kIters; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.0f;

      for (unsigned m = mask; m; m &= m - 1) {
        const int q = __ffs(m) - 1;
        copy_next();
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kRaw - 1) : "memory");
        __syncwarp();  // this step's source rows are in, and the last x-pass has read ybl

        // y-pass: ybl over the x-window, 4 columns a lane where S allows, 3 channels
        const float t0 = s_ty0[r * 4 + q], t1 = s_ty1[r * 4 + q];
        const uint8_t* raw = w_raw + (done % kRaw) * 6 * S;
        ++done;
        constexpr int V = SEG == 1 ? 1 : 4;
        const int lo = s_win[4 * q] / V * V, hi = s_win[4 * q + 1];
        for (int w = lo + lane * V; w <= hi; w += 32 * V) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const uint8_t* r0 = raw + 2 * c * S;
            const uint8_t* r1 = r0 + S;
            __nv_bfloat16* yb = w_ybl + c * S;
            if constexpr (V == 4) {
              const uint32_t p0 = t0 != 0.0f ? *reinterpret_cast<const uint32_t*>(r0 + w) : 0u;
              const uint32_t p1 = t1 != 0.0f ? *reinterpret_cast<const uint32_t*>(r1 + w) : 0u;
              __align__(8) __nv_bfloat16 v[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float a = t0 != 0.0f ? t0 * ((float)((p0 >> (8 * i)) & 0xff) - kFill) : 0.0f;
                const float b = t1 != 0.0f ? t1 * ((float)((p1 >> (8 * i)) & 0xff) - kFill) : 0.0f;
                v[i] = __float2bfloat16_rn(a + b);
              }
              *reinterpret_cast<uint2*>(yb + w) = *reinterpret_cast<const uint2*>(v);
            } else {
              const float a = t0 != 0.0f ? t0 * ((float)r0[w] - kFill) : 0.0f;
              const float b = t1 != 0.0f ? t1 * ((float)r1[w] - kFill) : 0.0f;
              yb[w] = __float2bfloat16_rn(a + b);
            }
          }
        }
        __syncwarp();  // ybl is in; the raw buffer may be refilled

        // x-pass: one tap read for the three channels, added in quadrant order
        const int xlo = s_win[4 * q + 2], xhi = s_win[4 * q + 3];
        const uint2* tq = s_tap + q * So;
#pragma unroll
        for (int i = 0; i < kIters; ++i) {
          const int x = xb + 32 * i + lane;
          if (x < So && x >= xlo && x <= xhi) {  // elsewhere the quadrant adds exact zeros
            const uint2 tap = tq[x];
            const int j0 = (int)(tap.x & 0xffffu), j1 = (int)(tap.x >> 16);
            const float w0 = lo_bf16(tap.y), w1 = hi_bf16(tap.y);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float v0 = __uint_as_float((uint32_t)yb16[c * S + j0] << 16);
              const float v1 = __uint_as_float((uint32_t)yb16[c * S + j1] << 16);
              const float res = w0 * v0 + w1 * v1;
              acc[i][c] = acc[i][c] + res;
            }
          }
        }
      }

      T* o = out + ((long long)g * 3 * So + y) * So;
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const int x = xb + 32 * i + lane;
        if (x >= So) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          o[(long long)c * So * So + x] = from_f32<T>(rintf(acc[i][c] + kFill));
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int SEG>
cudaError_t launch_seg(const void* imgs, const void* jx0, const void* wx0, const void* wx1,
                       const void* jy0, const void* wy0, const void* wy1, void* out, int G,
                       int S, int So, cudaStream_t stream) {
  const int smem = Layout(S, So).total;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static int smem_set[kMaxDevices] = {};  // the largest size allowed so far
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(warp_quadrants_kernel<T, SEG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  dim3 grid((unsigned)((So + kBand - 1) / kBand), (unsigned)G);
  warp_quadrants_kernel<T, SEG><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(imgs), static_cast<const int32_t*>(jx0),
      static_cast<const float*>(wx0), static_cast<const float*>(wx1),
      static_cast<const int32_t*>(jy0), static_cast<const float*>(wy0),
      static_cast<const float*>(wy1), static_cast<T*>(out), S, So);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* imgs, const void* jx0, const void* wx0, const void* wx1,
           const void* jy0, const void* wy0, const void* wy1, void* out, int G,
           int S, int So, void* stream) {
  if (G <= 0 || So <= 0) return 0;
  // grid.y; tap indices are kept in 16 bits
  if (G > 65535 || S > 32767) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (S % 16 == 0)
    return (int)launch_seg<T, 16>(imgs, jx0, wx0, wx1, jy0, wy0, wy1, out, G, S, So, st);
  if (S % 4 == 0)
    return (int)launch_seg<T, 4>(imgs, jx0, wx0, wx1, jy0, wy0, wy1, out, G, S, So, st);
  return (int)launch_seg<T, 1>(imgs, jx0, wx0, wx1, jy0, wy0, wy1, out, G, S, So, st);
}

}  // namespace

// Dynamic shared memory of one block at source size S and output size So.
extern "C" int odcib_warp_smem_bytes(int S, int So) { return Layout(S, So).total; }

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
