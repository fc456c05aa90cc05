// Training BatchNorm + SiLU of a ConvBnAct layer, forward and backward, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm and SiLU to XLA,
// which fuses them into its own passes. The port's plain path
// (models/layers.py: BatchNorm.forward, then F.silu) runs them as ~10 ATen
// passes over the activation in f32, forward and backward. These kernels
// compute the same function (ops/bn_silu.py `bn_silu_train_plain` and
// `bn_silu_grad_plain`):
//   forward   mean, var = the biased batch statistics of x over N, H, W (f32),
//             invstd = rsqrt(var + eps),
//             z = round_bf16((x - mean) * (invstd * w) + b),
//             y = round_bf16(z / (1 + exp(-z)));
//             running = running * (1 - m) + m * batch (flax's rule, biased var);
//   backward  dz = dy * s * (1 + z * (1 - s)), s = 1 / (1 + exp(-z)), in f32
//             (exp and the division by the fast intrinsics),
//             x_hat = (x - mean) * invstd,
//             db = sum dz, dw = sum dz * x_hat,
//             dx = round_bf16((dz - db / M - x_hat * dw / M) * (invstd * w)).
// x is the bf16 conv output in channels_last memory: an (M = N*H*W, C)
// row-major matrix. Every f32 operation rounds on its own (--fmad=false), in
// the plain path's order: given the same statistics, y is bitwise the plain
// path's.
//
// What bounds it on this card: bytes. The work needs x read and y written
// forward, x and dy read and dx written backward: 10 B an element, with a
// handful of f32 operations and one exp an element on each side (far below
// the card's 295 operations a byte). The plain path moves ~130 B an element.
//
// What the design does about it:
//  * four passes, each reading each input once with 16-byte loads: forward
//    statistics (x), apply (x -> y); backward sums (x, dy), dx (x, dy -> dx):
//    16 B an element, the least for statistics that have to be known before
//    any element is normalised; nothing of f32 is stored or saved (the
//    backward recomputes z from x and the C floats of mean and invstd);
//  * a thread owns 8 channels (one 16-byte vector of a row); a block's 256
//    threads cover `slots` rows of `lanes` vectors at once, so a warp reads
//    whole rows end to end; a block strides over the rows, so each thread
//    keeps its channels' constants in registers; a grid of one wave of
//    resident blocks (the card's SM count x the kernel's occupancy) covers
//    every layer shape from (2.77 M rows, 32 channels) to (10,816, 1024);
//  * the variance comes from deviations, never from E[x^2] - E[x]^2: a
//    thread loads 8 of its rows at once, takes their mean and the sum of
//    squared deviations from it, and merges that into its running (count,
//    mean, M2) by Chan's formula; threads, then blocks, merge the same way;
//  * every merge and every sum across threads and blocks runs in a fixed
//    order (a tree in shared memory over a block's slots; a merge kernel that
//    walks the blocks' partials in 32 fixed strides, 8 loads at once, and a
//    tree), with no float atomics, so a run gives the same bits every time;
//  * the small merge kernels also finish each channel: forward the mean,
//    variance, invstd and the running statistics (moved in place); backward
//    the weight's and bias's gradients.
// Needs C a multiple of 8, the base pointers 16-byte aligned and the row
// strides multiples of 8 elements; the wrapper checks. The partials'
// workspace is allocated by the wrapper (`odcib_bn_silu_blocks` sizes it);
// the launches go on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;     // channels a thread owns: one 16-byte vector of bf16
constexpr int kGroup = 8;   // rows a thread loads at once in the statistics pass
constexpr int kUnroll = 4;  // rows a thread loads at once in the other passes
constexpr int kMergeCols = 32;  // channels a merge block finishes
constexpr int kMergeSlots = 32;  // partials a merge block walks at once for each channel
constexpr int kMergeBatch = 8;  // partials a merge thread loads at once

// How a block covers rows: `lanes` 8-channel vectors of a row side by side,
// `slots` rows at once; grid y walks the row in pieces of `lanes` vectors.
struct Geometry {
  int lanes, slots;
};

__host__ __device__ inline Geometry geometry(int C) {
  const int vecs = C / kVec;
  const int lanes = vecs < kThreads ? vecs : kThreads;
  return {lanes, kThreads / lanes};
}

__host__ __device__ inline int chunks(int C) {
  const Geometry g = geometry(C);
  return (C / kVec + g.lanes - 1) / g.lanes;
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4& q, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return q;
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The BatchNorm output as the plain path rounds it before the SiLU.
__device__ __forceinline__ float bn_out(float xv, float mean, float scale, float bias) {
  return round_bf16((xv - mean) * scale + bias);
}

// SiLU's gradient times dy, in ATen's order: dy * s * (1 + z * (1 - s)).
// s by the fast exp and division (a few f32 units off; the plain path then
// rounds dz to bf16, 2^16 times coarser): the backward's passes would
// otherwise spend more time on these two than on their bytes.
__device__ __forceinline__ float silu_grad(float z, float dy) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-z));
  return dy * s * (1.0f + z * (1.0f - s));
}

// (count, mean, M2) of a merged with (nb, mean_b, m2_b), nb > 0 (Chan et al.).
__device__ __forceinline__ void chan_merge(float& mean, float& m2, long long na, float mean_b, float m2_b,
                                           long long nb) {
  const float f = (float)nb / (float)(na + nb);
  const float d = mean_b - mean;
  mean = mean + d * f;
  m2 = m2 + m2_b + d * d * ((float)na * f);
}

// Per-channel (mean, M2) of each block's rows: part_mean/part_m2 (G, C),
// part_n (G) rows.
__global__ void __launch_bounds__(kThreads, 2)
bn_silu_stats_kernel(const __nv_bfloat16* __restrict__ x, long long ldx, long long M, int C,
                     float* __restrict__ part_mean, float* __restrict__ part_m2, int* __restrict__ part_n) {
  __shared__ float s_mean[kThreads * kVec];
  __shared__ float s_m2[kThreads * kVec];
  __shared__ int s_n[kThreads];
  const Geometry g = geometry(C);
  const int tid = threadIdx.x;
  const int slot = tid / g.lanes, lane = tid - slot * g.lanes;
  const int vec = blockIdx.y * g.lanes + lane;
  const bool active = slot < g.slots && vec < C / kVec;
  const long long stride = (long long)gridDim.x * g.slots;
  float mean[kVec], m2[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) mean[c] = m2[c] = 0.0f;
  long long n = 0;
  if (active) {
    const __nv_bfloat16* base = x + (long long)vec * kVec;
    for (long long i0 = (long long)blockIdx.x * g.slots + slot; i0 < M; i0 += kGroup * stride) {
      const long long left = (M - i0 + stride - 1) / stride;
      const int k = left < kGroup ? (int)left : kGroup;  // rows of this group: a prefix of the 8
      uint4 q[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (j < k) q[j] = load16(base + (i0 + j * stride) * ldx);
      float gm[kVec], gm2[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) gm[c] = gm2[c] = 0.0f;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < k) {
          float f[kVec];
          unpack(q[j], f);
#pragma unroll
          for (int c = 0; c < kVec; ++c) gm[c] += f[c];
        }
      }
#pragma unroll
      for (int c = 0; c < kVec; ++c) gm[c] = gm[c] / (float)k;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < k) {
          float f[kVec];
          unpack(q[j], f);
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            const float d = f[c] - gm[c];
            gm2[c] += d * d;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kVec; ++c) chan_merge(mean[c], m2[c], n, gm[c], gm2[c], k);
      n += k;
    }
  }
  // the block's slots merged in a fixed tree: slot r takes slot r + step
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    s_mean[tid * kVec + c] = mean[c];
    s_m2[tid * kVec + c] = m2[c];
  }
  s_n[tid] = (int)n;
  for (int step = 1; step < g.slots; step <<= 1) {
    __syncthreads();
    if (active && slot % (2 * step) == 0 && slot + step < g.slots) {
      const int other = tid + step * g.lanes;
      const int nb = s_n[other];
      if (nb > 0) {
#pragma unroll
        for (int c = 0; c < kVec; ++c)
          chan_merge(mean[c], m2[c], n, s_mean[other * kVec + c], s_m2[other * kVec + c], nb);
        n += nb;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          s_mean[tid * kVec + c] = mean[c];
          s_m2[tid * kVec + c] = m2[c];
        }
        s_n[tid] = (int)n;
      }
    }
  }
  if (active && slot == 0) {
    float* pm = part_mean + (long long)blockIdx.x * C + vec * kVec;
    float* pv = part_m2 + (long long)blockIdx.x * C + vec * kVec;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      pm[c] = mean[c];
      pv[c] = m2[c];
    }
    if (vec == 0) part_n[blockIdx.x] = (int)n;
  }
}

// The G blocks' partials merged per channel in a fixed order; then the
// channel's mean, biased variance and invstd, and its running statistics
// moved in place: running = running * keep + momentum * batch.
__global__ void __launch_bounds__(kMergeCols * kMergeSlots)
bn_silu_stats_merge_kernel(const float* __restrict__ part_mean, const float* __restrict__ part_m2,
                           const int* __restrict__ part_n, int G, int C, float keep, float momentum, float eps,
                           float* __restrict__ mean_out, float* __restrict__ var_out,
                           float* __restrict__ invstd_out, float* __restrict__ running_mean,
                           float* __restrict__ running_var) {
  __shared__ float s_mean[kMergeSlots][kMergeCols];
  __shared__ float s_m2[kMergeSlots][kMergeCols];
  __shared__ long long s_n[kMergeSlots][kMergeCols];
  const int col = threadIdx.x, s = threadIdx.y;
  const int c = blockIdx.x * kMergeCols + col;
  float mean = 0.0f, m2 = 0.0f;
  long long n = 0;
  if (c < C) {
    // kMergeBatch partials loaded at once, then merged in order: the loads
    // overlap instead of each merge waiting on its own
    for (int b0 = s; b0 < G; b0 += kMergeBatch * kMergeSlots) {
      float pm[kMergeBatch], pv[kMergeBatch];
      int pn[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int b = b0 + j * kMergeSlots;
        pn[j] = b < G ? part_n[b] : 0;
        pm[j] = b < G ? part_mean[(long long)b * C + c] : 0.0f;
        pv[j] = b < G ? part_m2[(long long)b * C + c] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        if (pn[j] > 0) {
          chan_merge(mean, m2, n, pm[j], pv[j], pn[j]);
          n += pn[j];
        }
      }
    }
  }
  s_mean[s][col] = mean;
  s_m2[s][col] = m2;
  s_n[s][col] = n;
#pragma unroll
  for (int step = 1; step < kMergeSlots; step <<= 1) {
    __syncthreads();
    if (s % (2 * step) == 0) {
      const long long nb = s_n[s + step][col];
      if (nb > 0) {
        chan_merge(mean, m2, n, s_mean[s + step][col], s_m2[s + step][col], nb);
        n += nb;
        s_mean[s][col] = mean;
        s_m2[s][col] = m2;
        s_n[s][col] = n;
      }
    }
  }
  if (s == 0 && c < C) {
    const float var = m2 / (float)n;
    mean_out[c] = mean;
    var_out[c] = var;
    invstd_out[c] = rsqrtf(var + eps);
    running_mean[c] = running_mean[c] * keep + momentum * mean;
    running_var[c] = running_var[c] * keep + momentum * var;
  }
}

// y = silu(round_bf16((x - mean) * (invstd * w) + b)), rounded to bf16; y is
// (M, C) contiguous.
__global__ void __launch_bounds__(kThreads, 2)
bn_silu_apply_kernel(const __nv_bfloat16* __restrict__ x, long long ldx, long long M, int C,
                     const float* __restrict__ mean, const float* __restrict__ invstd,
                     const float* __restrict__ weight, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y) {
  const Geometry g = geometry(C);
  const int tid = threadIdx.x;
  const int slot = tid / g.lanes, lane = tid - slot * g.lanes;
  const int vec = blockIdx.y * g.lanes + lane;
  if (slot >= g.slots || vec >= C / kVec) return;
  float mu[kVec], sc[kVec], bb[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const int ch = vec * kVec + c;
    mu[c] = mean[ch];
    sc[c] = invstd[ch] * weight[ch];
    bb[c] = bias[ch];
  }
  const long long stride = (long long)gridDim.x * g.slots;
  const __nv_bfloat16* xb = x + (long long)vec * kVec;
  __nv_bfloat16* yb = y + (long long)vec * kVec;
  for (long long i0 = (long long)blockIdx.x * g.slots + slot; i0 < M; i0 += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (i0 + j * stride < M) q[j] = load16(xb + (i0 + j * stride) * ldx);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = i0 + j * stride;
      if (i < M) {
        float f[kVec];
        unpack(q[j], f);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float z = bn_out(f[c], mu[c], sc[c], bb[c]);
          f[c] = z / (1.0f + expf(-z));
        }
        *reinterpret_cast<uint4*>(yb + i * C) = pack(f);
      }
    }
  }
}

// Per-channel sums of dz and dz * x_hat over each block's rows: part_dz,
// part_dzx (G, C).
__global__ void __launch_bounds__(kThreads, 2)
bn_silu_grad_reduce_kernel(const __nv_bfloat16* __restrict__ x, long long ldx, const __nv_bfloat16* __restrict__ dy,
                           long long lddy, long long M, int C, const float* __restrict__ mean,
                           const float* __restrict__ invstd, const float* __restrict__ weight,
                           const float* __restrict__ bias, float* __restrict__ part_dz,
                           float* __restrict__ part_dzx) {
  __shared__ float s_dz[kThreads * kVec];
  __shared__ float s_dzx[kThreads * kVec];
  const Geometry g = geometry(C);
  const int tid = threadIdx.x;
  const int slot = tid / g.lanes, lane = tid - slot * g.lanes;
  const int vec = blockIdx.y * g.lanes + lane;
  const bool active = slot < g.slots && vec < C / kVec;
  float sdz[kVec], sdzx[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) sdz[c] = sdzx[c] = 0.0f;
  if (active) {
    float mu[kVec], is[kVec], sc[kVec], bb[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const int ch = vec * kVec + c;
      mu[c] = mean[ch];
      is[c] = invstd[ch];
      sc[c] = is[c] * weight[ch];
      bb[c] = bias[ch];
    }
    const long long stride = (long long)gridDim.x * g.slots;
    const __nv_bfloat16* xb = x + (long long)vec * kVec;
    const __nv_bfloat16* db = dy + (long long)vec * kVec;
    for (long long i0 = (long long)blockIdx.x * g.slots + slot; i0 < M; i0 += kUnroll * stride) {
      uint4 qx[kUnroll], qd[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = i0 + j * stride;
        if (i < M) {
          qx[j] = load16(xb + i * ldx);
          qd[j] = load16(db + i * lddy);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (i0 + j * stride < M) {
          float fx[kVec], fd[kVec];
          unpack(qx[j], fx);
          unpack(qd[j], fd);
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            const float d = fx[c] - mu[c];
            const float z = round_bf16(d * sc[c] + bb[c]);
            const float dz = silu_grad(z, fd[c]);
            sdz[c] += dz;
            sdzx[c] += dz * (d * is[c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    s_dz[tid * kVec + c] = sdz[c];
    s_dzx[tid * kVec + c] = sdzx[c];
  }
  for (int step = 1; step < g.slots; step <<= 1) {
    __syncthreads();
    if (active && slot % (2 * step) == 0 && slot + step < g.slots) {
      const int other = tid + step * g.lanes;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        sdz[c] += s_dz[other * kVec + c];
        sdzx[c] += s_dzx[other * kVec + c];
        s_dz[tid * kVec + c] = sdz[c];
        s_dzx[tid * kVec + c] = sdzx[c];
      }
    }
  }
  if (active && slot == 0) {
    float* pa = part_dz + (long long)blockIdx.x * C + vec * kVec;
    float* pb = part_dzx + (long long)blockIdx.x * C + vec * kVec;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      pa[c] = sdz[c];
      pb[c] = sdzx[c];
    }
  }
}

// The G blocks' sums added per channel in a fixed order: the bias's gradient
// (sum dz) and the weight's (sum dz * x_hat).
__global__ void __launch_bounds__(kMergeCols * kMergeSlots)
bn_silu_grad_merge_kernel(const float* __restrict__ part_dz, const float* __restrict__ part_dzx, int G, int C,
                          float* __restrict__ dweight, float* __restrict__ dbias) {
  __shared__ float s_dz[kMergeSlots][kMergeCols];
  __shared__ float s_dzx[kMergeSlots][kMergeCols];
  const int col = threadIdx.x, s = threadIdx.y;
  const int c = blockIdx.x * kMergeCols + col;
  float a = 0.0f, b = 0.0f;
  if (c < C) {
    for (int k0 = s; k0 < G; k0 += kMergeBatch * kMergeSlots) {
      float pa[kMergeBatch], pb[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int k = k0 + j * kMergeSlots;
        pa[j] = k < G ? part_dz[(long long)k * C + c] : 0.0f;
        pb[j] = k < G ? part_dzx[(long long)k * C + c] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        a += pa[j];
        b += pb[j];
      }
    }
  }
  s_dz[s][col] = a;
  s_dzx[s][col] = b;
#pragma unroll
  for (int step = 1; step < kMergeSlots; step <<= 1) {
    __syncthreads();
    if (s % (2 * step) == 0) {
      a += s_dz[s + step][col];
      b += s_dzx[s + step][col];
      s_dz[s][col] = a;
      s_dzx[s][col] = b;
    }
  }
  if (s == 0 && c < C) {
    dbias[c] = a;
    dweight[c] = b;
  }
}

// dx = round_bf16((dz - db / M - x_hat * dw / M) * (invstd * w)); dx is (M, C)
// contiguous.
__global__ void __launch_bounds__(kThreads, 2)
bn_silu_grad_input_kernel(const __nv_bfloat16* __restrict__ x, long long ldx, const __nv_bfloat16* __restrict__ dy,
                          long long lddy, long long M, int C, const float* __restrict__ mean,
                          const float* __restrict__ invstd, const float* __restrict__ weight,
                          const float* __restrict__ bias, const float* __restrict__ dweight,
                          const float* __restrict__ dbias, __nv_bfloat16* __restrict__ dx) {
  const Geometry g = geometry(C);
  const int tid = threadIdx.x;
  const int slot = tid / g.lanes, lane = tid - slot * g.lanes;
  const int vec = blockIdx.y * g.lanes + lane;
  if (slot >= g.slots || vec >= C / kVec) return;
  float mu[kVec], is[kVec], sc[kVec], bb[kVec], ma[kVec], mb[kVec];
  const float count = (float)M;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const int ch = vec * kVec + c;
    mu[c] = mean[ch];
    is[c] = invstd[ch];
    sc[c] = is[c] * weight[ch];
    bb[c] = bias[ch];
    ma[c] = dbias[ch] / count;
    mb[c] = dweight[ch] / count;
  }
  const long long stride = (long long)gridDim.x * g.slots;
  const __nv_bfloat16* xb = x + (long long)vec * kVec;
  const __nv_bfloat16* db = dy + (long long)vec * kVec;
  __nv_bfloat16* ob = dx + (long long)vec * kVec;
  for (long long i0 = (long long)blockIdx.x * g.slots + slot; i0 < M; i0 += kUnroll * stride) {
    uint4 qx[kUnroll], qd[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = i0 + j * stride;
      if (i < M) {
        qx[j] = load16(xb + i * ldx);
        qd[j] = load16(db + i * lddy);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = i0 + j * stride;
      if (i < M) {
        float fx[kVec], fd[kVec];
        unpack(qx[j], fx);
        unpack(qd[j], fd);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float d = fx[c] - mu[c];
          const float z = round_bf16(d * sc[c] + bb[c]);
          const float dz = silu_grad(z, fd[c]);
          fx[c] = (dz - ma[c] - (d * is[c]) * mb[c]) * sc[c];
        }
        *reinterpret_cast<uint4*>(ob + i * C) = pack(fx);
      }
    }
  }
}

// Blocks of `kernel` resident on one SM at kThreads threads, found once.
template <typename K>
int resident(K kernel, int* cached) {
  if (*cached == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) != cudaSuccess || n < 1) n = 1;
    *cached = n;
  }
  return *cached;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms < 1)
    return 1;
  return sms;
}

// One wave of resident blocks, or fewer where the rows run out first
// (each thread takes at least `rows` rows).
int wave(long long M, int C, int per_sm, int rows) {
  const Geometry g = geometry(C);
  const long long want = (M + (long long)g.slots * rows - 1) / ((long long)g.slots * rows);
  long long fit = (long long)sm_count() * per_sm / chunks(C);
  if (fit < 1) fit = 1;
  return (int)(want < fit ? want : fit);
}

int stats_per_sm() {
  static int stats = 0, grad = 0;
  const int a = resident(bn_silu_stats_kernel, &stats), b = resident(bn_silu_grad_reduce_kernel, &grad);
  return a < b ? a : b;
}

bool bad_shape(long long M, int C, long long ld) { return M < 1 || C < kVec || C % kVec != 0 || ld < C || ld % kVec != 0; }

}  // namespace

// The number of blocks G of the two reduction passes for (M, C): the
// workspace of both is 2 * G * C floats followed by G int32 counts.
extern "C" int odcib_bn_silu_blocks(long long M, int C) {
  if (bad_shape(M, C, C)) return 0;
  return wave(M, C, stats_per_sm(), kGroup);
}

// Forward: statistics, running statistics, y. x (M, C) bf16 rows of stride
// ldx; weight, bias, running_mean, running_var (C) f32; stats (3, C) f32 out:
// mean, biased var, invstd; y (M, C) bf16 out, contiguous; work from
// odcib_bn_silu_blocks(M, C) = blocks. Returns the cudaError_t of the launches.
extern "C" int odcib_bn_silu_forward(const void* x, long long ldx, long long M, int C, int blocks, void* work,
                                     const void* weight, const void* bias, void* running_mean, void* running_var,
                                     float keep, float momentum, float eps, void* stats, void* y, void* stream) {
  if (bad_shape(M, C, ldx) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xs = static_cast<const __nv_bfloat16*>(x);
  float* part = static_cast<float*>(work);
  int* part_n = reinterpret_cast<int*>(part + 2LL * blocks * C);
  float* out = static_cast<float*>(stats);
  bn_silu_stats_kernel<<<dim3(blocks, chunks(C)), kThreads, 0, st>>>(xs, ldx, M, C, part, part + (long long)blocks * C,
                                                                      part_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_silu_stats_merge_kernel<<<(C + kMergeCols - 1) / kMergeCols, dim3(kMergeCols, kMergeSlots), 0, st>>>(
      part, part + (long long)blocks * C, part_n, blocks, C, keep, momentum, eps, out, out + C, out + 2 * C,
      static_cast<float*>(running_mean), static_cast<float*>(running_var));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static int apply_cached = 0;
  const int grid = wave(M, C, resident(bn_silu_apply_kernel, &apply_cached), kUnroll);
  bn_silu_apply_kernel<<<dim3(grid, chunks(C)), kThreads, 0, st>>>(
      xs, ldx, M, C, out, out + 2 * C, static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y));
  return (int)cudaGetLastError();
}

// Backward: x (M, C) bf16 rows of stride ldx, dy of stride lddy; weight,
// bias (C) f32; stats as the forward wrote them (mean, var, invstd);
// dweight, dbias (C) f32 out; dx (M, C) bf16 out, contiguous; work as the
// forward's. Returns the cudaError_t of the launches.
extern "C" int odcib_bn_silu_backward(const void* x, long long ldx, const void* dy, long long lddy, long long M, int C,
                                      int blocks, void* work, const void* weight, const void* bias, const void* stats,
                                      void* dweight, void* dbias, void* dx, void* stream) {
  if (bad_shape(M, C, ldx) || bad_shape(M, C, lddy) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xs = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* ds = static_cast<const __nv_bfloat16*>(dy);
  const float* s = static_cast<const float*>(stats);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  float* part = static_cast<float*>(work);
  float* dw = static_cast<float*>(dweight);
  float* dbs = static_cast<float*>(dbias);
  bn_silu_grad_reduce_kernel<<<dim3(blocks, chunks(C)), kThreads, 0, st>>>(xs, ldx, ds, lddy, M, C, s, s + 2 * C, w, b,
                                                                            part, part + (long long)blocks * C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_silu_grad_merge_kernel<<<(C + kMergeCols - 1) / kMergeCols, dim3(kMergeCols, kMergeSlots), 0, st>>>(
      part, part + (long long)blocks * C, blocks, C, dw, dbs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static int input_cached = 0;
  const int grid = wave(M, C, resident(bn_silu_grad_input_kernel, &input_cached), kUnroll);
  bn_silu_grad_input_kernel<<<dim3(grid, chunks(C)), kThreads, 0, st>>>(xs, ldx, ds, lddy, M, C, s, s + 2 * C, w, b,
                                                                         dw, dbs, static_cast<__nv_bfloat16*>(dx));
  return (int)cudaGetLastError();
}
