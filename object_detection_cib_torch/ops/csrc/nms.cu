// Exact greedy NMS keep mask, one thread block per image, for Hopper (sm_90a).
//
// Replaces the TPU kernel object_detection_cib_tpu/ops/pallas_nms.py
// `pallas_greedy_nms_mask` (kernel body `_make_tile_kernel`). Same function:
// boxes (B, K, 4) f32 xyxy in descending-score order with the per-class
// offset already applied, live (B, K) u8 -> keep (B, K) u8, where
//   keep[i] = live[i] and no j < i has keep[j] and IoU(j, i) > thr,
//   IoU(j, i) = inter / (union + 1e-7), union = area_j + area_i - inter,
// all in f32. Built with --fmad=false so no multiply-add is contracted and
// every pair test rounds exactly as the reference (core/nms.py
// `_greedy_nms_mask`, and the plain version in ops/nms.py) does; the
// division is IEEE-rounded (nvcc's default -prec-div=true).
//
// What bounds it on this card: not bytes (18 B per box in and out, about
// 1.2 MB for a batch of 32 at K=2048) and not arithmetic (~14 f32 operations
// per pair test, at most K^2/2 tests per image). The limit is the serial
// dependency chain of greedy NMS: whether box i survives depends on the
// final state of every earlier box.
//
// What the design does about it:
//  * Targets are processed in tiles of kTile boxes, left to right, one
//    target per thread. When a tile starts, every earlier box is final, so
//    its cross-tile suppressors are tested fully in parallel (each thread
//    walks the list of boxes kept so far and stops at the first one that
//    suppresses it).
//  * Kept boxes are appended to a compact list in shared memory, so the
//    cross-tile walk touches only kept boxes, never suppressed or dead ones.
//    The append order (atomicAdd) varies from run to run; the result does
//    not, because a target is suppressed iff ANY kept earlier box overlaps it.
//  * Inside a tile the chain is resolved by a sequential sweep in index
//    order: for each row jj still kept, all later targets of the tile test
//    it at once, then one barrier. Rows that are not kept cost no barrier.
//  * One block per image: the image count sets how much of the card is
//    busy (32 of 132 SMs at the serving batch of 32).
// Nothing is allocated here; the wrapper owns every buffer, and the launch
// goes on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 256;    // targets per tile == threads per block
constexpr int kMaxK = 8192;   // 20 B of shared memory per box -> 166 KB
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float box_area(float4 b) {
  return (b.z - b.x) * (b.w - b.y);
}

// IoU(j, i) > thr, with j the higher-scored (suppressing) box.
__device__ __forceinline__ bool suppresses(float4 j, float aj, float4 i,
                                           float ai, float thr) {
  const float iw = fmaxf(fminf(j.z, i.z) - fmaxf(j.x, i.x), 0.0f);
  const float ih = fmaxf(fminf(j.w, i.w) - fmaxf(j.y, i.y), 0.0f);
  const float inter = iw * ih;
  const float uni = aj + ai - inter;
  return inter / (uni + kEps) > thr;
}

size_t smem_bytes(int K) {
  // tile_box[kTile] f32x4 | kept_box[K] f32x4 | tile_area[kTile] f32 |
  // kept_area[K] f32 | tile_keep[kTile] i32
  return (size_t)(kTile + K) * sizeof(float4) +
         (size_t)(kTile + K) * sizeof(float) + (size_t)kTile * sizeof(int);
}

__global__ void __launch_bounds__(kTile)
greedy_nms_kernel(const float4* __restrict__ boxes,
                  const uint8_t* __restrict__ live,
                  uint8_t* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* tile_box = reinterpret_cast<float4*>(smem);
  float4* kept_box = tile_box + kTile;
  float* tile_area = reinterpret_cast<float*>(kept_box + K);
  float* kept_area = tile_area + kTile;
  int* tile_keep = reinterpret_cast<int*>(kept_area + K);
  __shared__ int n_kept;

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * K;
  boxes += base;
  live += base;
  keep += base;

  if (tid == 0) n_kept = 0;
  __syncthreads();

  for (int s = 0; s < K; s += kTile) {
    const int i = s + tid;
    float4 bi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float ai = 0.0f;
    bool alive = false;
    if (i < K) {
      bi = boxes[i];
      ai = box_area(bi);
      alive = live[i] != 0;
    }

    // 1. cross-tile: every box before s is final; test the kept ones
    const int nk = n_kept;
    for (int j = 0; alive && j < nk; ++j) {
      if (suppresses(kept_box[j], kept_area[j], bi, ai, thr)) alive = false;
    }
    tile_box[tid] = bi;
    tile_area[tid] = ai;
    tile_keep[tid] = alive;
    __syncthreads();

    // 2. within the tile: sweep rows in index order. tile_keep[jj] is final
    //    when row jj is reached (rows < jj were swept behind a barrier), and
    //    the branch is uniform across the block, so the barrier is legal.
    const int n_t = min(kTile, K - s);
    for (int jj = 0; jj < n_t - 1; ++jj) {
      if (tile_keep[jj]) {
        if (alive && tid > jj &&
            suppresses(tile_box[jj], tile_area[jj], bi, ai, thr)) {
          alive = false;
          tile_keep[tid] = 0;
        }
        __syncthreads();
      }
    }

    // 3. publish the tile: its keep mask, and its kept boxes onto the list
    if (i < K) keep[i] = alive ? 1 : 0;
    if (alive) {
      const int p = atomicAdd(&n_kept, 1);
      kept_box[p] = bi;
      kept_area[p] = ai;
    }
    __syncthreads();
  }
}

// Raises the kernel's dynamic shared-memory limit to what kMaxK needs, once
// per device: the setting covers every K, so later launches make no extra
// driver call. Two threads racing here both set the same value.
cudaError_t allow_max_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(greedy_nms_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxK));
  if (err == cudaSuccess && cached) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

extern "C" int odcib_nms_max_k() { return kMaxK; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int odcib_greedy_nms_mask(const void* boxes, const void* live,
                                     void* keep, int B, int K, float thr,
                                     void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return (int)err;
  greedy_nms_kernel<<<B, kTile, smem_bytes(K), (cudaStream_t)stream>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(live),
      static_cast<uint8_t*>(keep), K, thr);
  return (int)cudaGetLastError();
}
