// Exact greedy NMS keep mask for Hopper (sm_90a): pair tests over the whole
// card into 64-bit suppression words, then a word-wide scan per image.
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
// What the design does about it: everything that does not depend on the
// chain runs first, over the whole card, and the chain itself touches only
// bits.
//  1. `pair_kernel`, grid (column blocks, row blocks, images), 64 threads, the
//     blocks left of the diagonal leaving at once: thread j of a block owns
//     row j of a 64-box row block and writes, for one 64-box column block,
//     the word whose bit i says "row j suppresses column i" (IoU > thr). IoU
//     is symmetric bit for bit, so in the diagonal block the word is written
//     the other way round: bit i < j says "box i of this block suppresses box
//     j", what the scan's vote on box j needs. The words go to a workspace
//     the wrapper owns, (image, row, word), which stays in L2 at the serving
//     shapes. A pair whose intersection is 0 needs no division (0 / x > thr
//     is false for thr >= 0; with a negative or NaN thr every pair takes the
//     full test), so a thread first collects the columns that may overlap its
//     row as bits, by four compares a pair, and runs the full test (min, max,
//     IEEE division) only for those. Dead rows write 0; a row block with no
//     live box writes nothing (the scan never reads it).
//  2. `scan_kernel`, one block of 128 threads per image, walks the 64-box
//     blocks in order, with nothing on the chain but bit operations on
//     shared memory and registers:
//     * block b's own words (word b of its 64 rows) and the next block's
//       (word b + 1) are copied by cp.async two blocks ahead: their
//       addresses are known long before their block comes up;
//     * the 64 x 64 diagonal block is resolved in registers by every warp
//       alike: lane l holds the words of boxes l and l + 32, and
//       keep[i] = candidate[i] and no kept box suppresses i is iterated to
//       its fixpoint with two warp votes a sweep (the block's dependency
//       depth plus one or two sweeps; no division, no barrier);
//     * what the kept rows remove of block b + 1 is one warp-wide OR of the
//       words beside the diagonal's;
//     * only the kept rows' later words (b + 2 on) are fetched, by cp.async
//       when the block is resolved, and ORed into the running "removed"
//       words one iteration later, when they have landed. There the threads
//       tile the block as (slice of rows, word) and read every row of their
//       slice, masked by its kept bit, so that no load waits for a branch:
//       a lone warp pays each dependent instruction's full latency, so the
//       OR costs a slice's length, not the kept count; the slices' partial
//       words meet in shared memory when their block comes up.
//     Two block barriers per 64 boxes, and no division on the chain.
// Ragged K goes through unpadded: a column past K is a zero box and a row
// past K is neither written nor read. Nothing is allocated here; both
// kernels go on the caller's stream.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;                  // boxes per suppression word
constexpr int kMaxK = 8192;
constexpr int kMaxWords = kMaxK / kBlock;   // words per row at kMaxK
constexpr int kScanThreads = 128;           // (slice of rows, word) tiles of a block
constexpr int kMaxSlices = 4;               // kScanThreads / 32
constexpr int kNearStages = 3;              // blocks whose near words are in shared memory
constexpr int kNearStride = 6;              // words between rows there (4 held, 2 to spread banks)
constexpr int kFarStages = 2;               // blocks whose kept rows' later words are there
constexpr int kMaxGridZ = 65535;
constexpr float kEps = 1e-7f;

static_assert(kScanThreads >= kMaxWords, "one thread per word of a row");

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

// False only where the intersection of j and i is certainly 0: iw > 0 needs
// min(j.z, i.z) > max(j.x, i.x), so both j.z > i.x and i.z > j.x, and the
// same in y. Four compares, each true when unordered, so a NaN coordinate
// never rules a pair out.
__device__ __forceinline__ bool may_overlap(float4 j, float4 i) {
  return !(j.z <= i.x) && !(i.z <= j.x) && !(j.w <= i.y) && !(i.w <= j.y);
}

// The columns of `c[0..32)` that row `me` suppresses, among those in `cand`.
__device__ __forceinline__ uint32_t test_candidates(uint32_t cand, float4 me, float my_area,
                                                    const float4* c, float thr) {
  uint32_t word = 0;
  while (cand) {
    const int i = __ffs((int)cand) - 1;
    cand &= cand - 1;
    if (suppresses(me, my_area, c[i], box_area(c[i]), thr)) word |= 1u << i;
  }
  return word;
}

// Words per row (one bit per column), rounded up to an even count so that
// every row of the workspace starts on a 16-byte boundary.
__host__ __device__ inline int words_of(int K) { return (K + kBlock - 1) / kBlock; }
__host__ __device__ inline int padded_words(int W) { return (W + 1) & ~1; }

__global__ void __launch_bounds__(kBlock)
pair_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ live,
            u64* __restrict__ words, int K, int Wp, float thr) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  if (cb < rb) return;  // left of the diagonal
  __shared__ float4 col[kBlock];

  const int tid = threadIdx.x;
  boxes += (size_t)blockIdx.z * K;
  live += (size_t)blockIdx.z * K;
  words += (size_t)blockIdx.z * K * Wp;

  const int i = cb * kBlock + tid;
  col[tid] = i < K ? boxes[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int row = rb * kBlock + tid;
  const bool row_live = row < K && live[row] != 0;
  // the barrier that publishes `col`, and the vote in one
  if (!__syncthreads_or(row_live)) return;
  if (row >= K) return;

  u64 word = 0;
  if (row_live) {
    const float4 me = cb == rb ? col[tid] : boxes[row];
    const float my_area = box_area(me);
    uint32_t lo = 0xffffffffu, hi = 0xffffffffu;
    if (thr >= 0.0f) {
      lo = hi = 0;
#pragma unroll
      for (int c = 0; c < 32; ++c) lo |= (uint32_t)may_overlap(me, col[c]) << c;
#pragma unroll
      for (int c = 0; c < 32; ++c) hi |= (uint32_t)may_overlap(me, col[32 + c]) << c;
    }
    if (cb == rb) {  // on the diagonal: the boxes before this row's, see above
      const u64 earlier = (1ull << tid) - 1;
      lo &= (uint32_t)earlier;
      hi &= (uint32_t)(earlier >> 32);
    }
    lo = test_candidates(lo, me, my_area, col, thr);
    hi = test_candidates(hi, me, my_area, col + 32, thr);
    word = (u64)hi << 32 | lo;
  }
  words[(size_t)row * Wp + cb] = word;
}

__host__ __device__ inline size_t far_ring_words(int Wp) {
  // a row of the ring is two words longer than a row of the workspace, so
  // that one column of consecutive rows is spread over the banks
  return (size_t)kFarStages * kBlock * (Wp + 2);
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const u64* __restrict__ words, const uint8_t* __restrict__ live,
            uint8_t* __restrict__ keep, int K, int W, int Wp) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* far_ring = reinterpret_cast<u64*>(smem);
  __shared__ __align__(16) u64 near_ring[kNearStages][kBlock * kNearStride];
  __shared__ u64 live_words[kMaxWords];
  __shared__ u64 removed_part[2][kMaxSlices];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int S = Wp + 2;
  live += (size_t)blockIdx.x * K;
  keep += (size_t)blockIdx.x * K;
  words += (size_t)blockIdx.x * K * Wp;

  for (int b = tid >> 5; b < W; b += kScanThreads / 32) {
    const int i0 = b * kBlock + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, i0 < K && live[i0] != 0);
    const unsigned hi = __ballot_sync(0xffffffffu, i1 < K && live[i1] != 0);
    if (lane == 0) live_words[b] = (u64)hi << 32 | lo;
  }
  if (tid < 2 * kMaxSlices) (&removed_part[0][0])[tid] = 0;
  __syncthreads();

  // The threads tile a 64-row block as (slice of rows, word): thread
  // (q, w) ORs word w of the kept rows of slice q into its own register,
  // so that the OR of a block costs a slice's length, not its kept count.
  const int slice_threads = W <= 32 ? 32 : (W <= 64 ? 64 : 128);
  const int slice_rows = kBlock / (kScanThreads / slice_threads);
  const int w = tid & (slice_threads - 1);
  const int q = tid / slice_threads;

  // Near copy of block b: the two 16-byte pieces of each row from the one
  // that holds word b on (words b and b + 1 are among them), one piece per
  // thread, into near stage b % kNearStages. A block with no live box is
  // never read.
  const int pieces = Wp >> 1;
  auto copy_near = [&](int b) {
    if (b >= W || live_words[b] == 0) return;
    const int r = tid >> 1;
    const int p = (b >> 1) + (tid & 1);
    if (b * kBlock + r < K && p < pieces) {
      __pipeline_memcpy_async(near_ring[b % kNearStages] + r * kNearStride + 2 * (tid & 1),
                              words + (size_t)(b * kBlock + r) * Wp + 2 * p, 16);
    }
  };
  // Far copy of block b: words b + 2 on of its kept rows, into far stage
  // b % kFarStages. Two threads share a row and take every other piece.
  auto copy_far = [&](int b, u64 kept) {
    const int r = tid >> 1;
    if (b + 2 >= W || !((kept >> r) & 1)) return;
    u64* dst = far_ring + ((size_t)(b % kFarStages) * kBlock + r) * S;
    const u64* src = words + (size_t)(b * kBlock + r) * Wp;
    for (int p = ((b + 2) >> 1) + (tid & 1); p < pieces; p += 2) {
      __pipeline_memcpy_async(dst + 2 * p, src + 2 * p, 16);
    }
  };

  copy_near(0);
  __pipeline_commit();
  copy_near(1);
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();

  const uint32_t lane_bit = 1u << lane;
  u64 removed = 0;       // word w of what slice q's kept rows removed, blocks before the last
  u64 near_removed = 0;  // block b's word of what block b - 1's kept rows removed
  u64 kept_before = 0;   // block b - 1's kept boxes
  for (int b = 0; b < W; ++b) {
    // 1. block b's candidates, then its own 64 x 64 words to their fixpoint:
    //    lane l holds the words of boxes l and l + 32 (the earlier boxes of
    //    the block that suppress them) and votes whether each is kept
    const u64* part = removed_part[b & 1];
    const u64 cand = live_words[b] & ~(part[0] | part[1] | part[2] | part[3] | near_removed);
    const u64* near = near_ring[b % kNearStages] + (b & 1);
    u64 kept = cand;
    near_removed = 0;
    if (cand) {
      const u64 s0 = near[lane * kNearStride];
      const u64 s1 = near[(lane + 32) * kNearStride];
      const uint32_t s0_lo = (uint32_t)s0;  // box l < 32 has no suppressor past 31
      const uint32_t s1_lo = (uint32_t)s1, s1_hi = (uint32_t)(s1 >> 32);
      const bool cand0 = (uint32_t)cand & lane_bit, cand1 = (uint32_t)(cand >> 32) & lane_bit;
      uint32_t kept_lo = (uint32_t)cand, kept_hi = (uint32_t)(cand >> 32);
      // two sweeps between checks: a branch costs a lone warp as much as a sweep
      for (;;) {
        const uint32_t mid_lo = __ballot_sync(0xffffffffu, cand0 && !(s0_lo & kept_lo));
        const uint32_t mid_hi = __ballot_sync(
            0xffffffffu, cand1 && !((s1_lo & kept_lo) | (s1_hi & kept_hi)));
        const uint32_t next_lo = __ballot_sync(0xffffffffu, cand0 && !(s0_lo & mid_lo));
        const uint32_t next_hi = __ballot_sync(
            0xffffffffu, cand1 && !((s1_lo & mid_lo) | (s1_hi & mid_hi)));
        kept_lo = next_lo;
        kept_hi = next_hi;
        if (next_lo == mid_lo && next_hi == mid_hi) break;
      }
      kept = (u64)kept_hi << 32 | kept_lo;
      // 2. what the kept rows remove of block b + 1: word b + 1 lies beside
      if (b + 1 < W) {
        const u64 mine = ((kept_lo & lane_bit) ? near[lane * kNearStride + 1] : 0ull) |
                         ((kept_hi & lane_bit) ? near[(lane + 32) * kNearStride + 1] : 0ull);
        near_removed = (u64)__reduce_or_sync(0xffffffffu, (uint32_t)(mine >> 32)) << 32 |
                       __reduce_or_sync(0xffffffffu, (uint32_t)mine);
      }
    }
    if (tid < kBlock && b * kBlock + tid < K) {
      keep[b * kBlock + tid] = (uint8_t)((kept >> tid) & 1);
    }
    // 3. start the copies: the kept rows' later words, and block b + 2's near words
    copy_far(b, kept);
    copy_near(b + 2);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of the last iteration have landed
    __syncthreads();           // everyone's have
    // 4. OR the later words of block b - 1's kept rows, copied an iteration ago
    //    (every row is read and masked, so that no load waits for a branch;
    //    a row that was not kept holds stale or unwritten words)
    if (w > b && w < W && kept_before) {
      const u64 bits = kept_before >> (q * slice_rows);
      const u64* src = far_ring + (size_t)((b - 1) % kFarStages) * kBlock * S +
                       (size_t)q * slice_rows * S + w;
      u64 even = 0, odd = 0;
#pragma unroll 8
      for (int r = 0; r < slice_rows; r += 2) {
        even |= src[r * S] & (0ull - ((bits >> r) & 1));
        odd |= src[(r + 1) * S] & (0ull - ((bits >> (r + 1)) & 1));
      }
      removed |= even | odd;
    }
    kept_before = kept;
    if (w == b + 1) removed_part[(b + 1) & 1][q] = removed;
    __syncthreads();
  }
}

// Raises the scan's dynamic shared-memory limit to what kMaxK needs, once
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
  err = cudaFuncSetAttribute(scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(far_ring_words(kMaxWords) * sizeof(u64)));
  if (err == cudaSuccess && cached) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

extern "C" int odcib_nms_max_k() { return kMaxK; }

// Bytes of workspace one image needs at this K: K rows of suppression words.
extern "C" long long odcib_nms_workspace_bytes(int K) {
  return (long long)K * padded_words(words_of(K)) * (long long)sizeof(u64);
}

// Dynamic shared memory of one scan block at this K (the ring of kept rows).
extern "C" long long odcib_nms_scan_smem_bytes(int K) {
  return (long long)(far_ring_words(padded_words(words_of(K))) * sizeof(u64));
}

// `workspace` holds `ws_images` (>= 1) images' words, 16-byte aligned; the
// batch is taken in chunks of that many images, one after the other on
// `stream`, so the workspace is reused in stream order. Returns the
// cudaError_t of the first launch that failed (0 = success).
extern "C" int odcib_greedy_nms_mask(const void* boxes, const void* live,
                                     void* keep, void* workspace, int ws_images,
                                     int B, int K, float thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK || ws_images < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_max_smem();
  if (err != cudaSuccess) return (int)err;
  const int W = words_of(K);
  const int Wp = padded_words(W);
  const size_t smem = (size_t)odcib_nms_scan_smem_bytes(K);
  const int chunk = ws_images < kMaxGridZ ? ws_images : kMaxGridZ;
  const float4* box = static_cast<const float4*>(boxes);
  const uint8_t* alive = static_cast<const uint8_t*>(live);
  uint8_t* out = static_cast<uint8_t*>(keep);
  u64* words = static_cast<u64*>(workspace);
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int n = B - b0 < chunk ? B - b0 : chunk;
    const size_t at = (size_t)b0 * K;
    const dim3 grid((unsigned)W, (unsigned)W, (unsigned)n);
    pair_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(box + at, alive + at, words, K, Wp, thr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_kernel<<<n, kScanThreads, smem, (cudaStream_t)stream>>>(words, alive + at, out + at, K, W,
                                                                 Wp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
