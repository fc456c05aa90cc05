// Stage marks on the card's clock, for Hopper (sm_90a).
//
// A mark is a one-thread kernel that writes the card's global timer
// (`%globaltimer`, nanoseconds) into one cell of an int64 stamp matrix
// (marks, steps): the row of its stage, the column of the step counter that
// the fused epoch keeps on the device. Launched on the current stream, it
// stamps when the work enqueued before it on that stream has run; captured
// in a CUDA graph, it is a node of the graph and stamps at every replay.
//
// Each stage has its own `__global__` function, so a device trace tells the
// marks apart by name (`mark_forward_end_kernel`, ...). No name contains the
// name of another of the port's kernels. A column outside [0, steps) writes
// nothing. Nothing is allocated here; the launch goes on the caller's stream.
// The rows are those of `ops/marks.py:MARKS`, in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void stamp(long long* stamps, const long long* step, long long steps, int row) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long c = *step;
  if (c >= 0 && c < steps) stamps[row * steps + c] = (long long)t;
}

#define ODCIB_MARK(stage, row)                                                                 \
  __global__ void mark_##stage##_kernel(long long* stamps, const long long* step, long long steps) { \
    stamp(stamps, step, steps, row);                                                           \
  }

ODCIB_MARK(augment_begin, 0)
ODCIB_MARK(augment_end, 1)
ODCIB_MARK(forward_begin, 2)
ODCIB_MARK(forward_end, 3)
ODCIB_MARK(loss_end, 4)
ODCIB_MARK(backward_end, 5)
ODCIB_MARK(allreduce_end, 6)
ODCIB_MARK(optimizer_end, 7)

#undef ODCIB_MARK

}  // namespace

// The number of rows (stages) the kernels know.
extern "C" int odcib_mark_rows() { return 8; }

// Stamp row `row` of `stamps` (int64, rows x steps, row-major) at the column
// `*step` (an int64 on the device). Returns the cudaError_t of the launch.
extern "C" int odcib_mark(int row, void* stamps, const void* step, long long steps, void* stream) {
  long long* s = static_cast<long long*>(stamps);
  const long long* c = static_cast<const long long*>(step);
  cudaStream_t st = (cudaStream_t)stream;
  switch (row) {
    case 0: mark_augment_begin_kernel<<<1, 1, 0, st>>>(s, c, steps); break;
    case 1: mark_augment_end_kernel<<<1, 1, 0, st>>>(s, c, steps); break;
    case 2: mark_forward_begin_kernel<<<1, 1, 0, st>>>(s, c, steps); break;
    case 3: mark_forward_end_kernel<<<1, 1, 0, st>>>(s, c, steps); break;
    case 4: mark_loss_end_kernel<<<1, 1, 0, st>>>(s, c, steps); break;
    case 5: mark_backward_end_kernel<<<1, 1, 0, st>>>(s, c, steps); break;
    case 6: mark_allreduce_end_kernel<<<1, 1, 0, st>>>(s, c, steps); break;
    case 7: mark_optimizer_end_kernel<<<1, 1, 0, st>>>(s, c, steps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
