// expand_many: fused multi-payload RLE expansion, hand-written for sm_90a.
//
// Replaces src/repro/kernels/expand_fused.py::_expand_many_kernel (the Pallas
// TPU kernel behind expand_gather_many).  It computes the same function:
//
//   out[q, t] = payloads[q, r]   where  bounds[r-1] <= t < bounds[r]
//
// for q < K and t < total, with bounds the inclusive prefix sums of the run
// lengths.  The TPU kernel recovers r with a [512, 1024] comparison matrix
// because TPU Pallas has no VMEM gather; Hopper gathers from any address, so
// each thread runs an upper-bound binary search instead (side="right", which
// skips zero-length runs: a run with bounds[r-1] == bounds[r] owns no t).
//
// Bound on the H100: HBM bytes.  The function must read K*runs payload words
// and runs bound words and write K*total output words, (K*total + K*runs +
// runs) * 4 bytes over 3.35 TB/s; it does no arithmetic worth counting.  The
// design keeps the writes coalesced: consecutive threads own consecutive t,
// so each of the K stores of a warp is one contiguous 128-byte segment, and
// the run search is done once per t and reused for all K payload rows (the
// fusion the TPU kernel exists for).  Neighbouring threads walk nearly the
// same search path, so the bounds reads mostly hit L1/L2.  A per-tile
// shared-memory bounds window would cut the search's cache traffic further;
// this first version stays simple.
//
// Indexing: total and runs are at most 2^31 - 1 (the caller's int32
// envelope), but K * total is not, so output offsets are 64-bit.
//
// Plain C interface for ctypes: the launch goes on the caller's stream, the
// kernel allocates nothing, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;  // grid-stride beyond this

__global__ void __launch_bounds__(kThreads)
expand_many_kernel(const int32_t* __restrict__ payloads,
                   const int32_t* __restrict__ bounds,
                   int32_t runs, long long total, int32_t k,
                   int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int32_t tt = (int32_t)t;
    // first r with bounds[r] > t
    int32_t lo = 0, hi = runs;
    while (lo < hi) {
      const int32_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(bounds + mid) <= tt) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // t < bounds[runs-1] by contract; clamp as the reference oracle does
    // so a caller's total past the last bound never reads out of range
    const int32_t r = lo < runs ? lo : runs - 1;
    for (int32_t q = 0; q < k; ++q) {
      out[(long long)q * total + t] = __ldg(payloads + (long long)q * runs + r);
    }
  }
}

}  // namespace

extern "C" int expand_many_launch(const void* payloads, const void* bounds,
                                  long long runs, long long total, int k,
                                  void* out, void* stream) {
  if (total <= 0 || runs <= 0 || k <= 0) {
    return 0;
  }
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  expand_many_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)payloads, (const int32_t*)bounds, (int32_t)runs, total,
      (int32_t)k, (int32_t*)out);
  return (int)cudaGetLastError();
}
