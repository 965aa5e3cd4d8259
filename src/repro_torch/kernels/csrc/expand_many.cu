// expand_many: fused multi-payload RLE expansion, hand-written for sm_90a.
//
// Replaces src/repro/kernels/expand_fused.py::_expand_many_kernel (the Pallas
// TPU kernel behind expand_gather_many), and with K = 1 (expand_gather_launch,
// at the end) src/repro/kernels/expand.py::_expand_kernel.  It computes the
// same function:
//
//   out[q, t] = payloads[q, r]   where  bounds[r-1] <= t < bounds[r]
//
// for q < K and t < total, with bounds the inclusive prefix sums of the run
// lengths.  The TPU kernel recovers r with a [512, 1024] comparison matrix
// over a two-block window of runs because TPU Pallas has no VMEM gather;
// Hopper gathers from any address, so the run search is a scan instead.
//
// Bound on the H100: HBM bytes.  The function must read K*runs payload words
// and runs bound words and write K*total output words, (K*total + K*runs +
// runs) * 4 bytes over 3.35 TB/s; it does no arithmetic worth counting.
//
// Design: a per-tile run window.  A block of 256 threads owns a tile of
// kTile = 2048 consecutive outputs, 8 a thread (of tiles of 1024, 2048 and
// 4096, 2048 took the least time summed over the main path's launch shapes
// on the H100).  Per tile:
//
//   1. two warps find the tile's run window [r0, r1], the runs that own its
//      first and last output, each with a 32-way search of global bounds
//      (one ballot per step, ~4 dependent loads for a million runs): two
//      searches per tile instead of a binary search per output;
//   2. the block zeroes a shared idx[kTile], then reads the window's bounds
//      256 runs at a time, coalesced, and writes r - r0 at the tile position
//      where run r begins, bounds[r-1] - t0.  Only the last run of a group
//      that begins at one position writes: the one of nonzero length, or the
//      last run of all (the clamp below).  So zero-length runs are skipped
//      as the upper-bound search skipped them, each position has at most one
//      writer, and no shared capacity depends on how many runs the window
//      holds: 100,000 zero-length runs in one tile cost reads, not space;
//   3. a block-wide inclusive max-scan of idx gives every output its run
//      (runs are monotone in t, so the max fills forward);
//   4. for each of the K payload rows, every thread gathers
//      payloads[q, r0 + idx[j]] through __ldg (neighbouring outputs share a
//      run, so these are L1 hits) and writes four outputs as one 16-byte
//      streaming store; a warp's stores are one contiguous 512-byte span.
//      Row q starts at word q * total, so its 16-byte boundaries fall at a
//      position that depends on q * total and the output pointer: up to
//      three outputs before the first boundary and three after the last
//      whole vector take scalar stores.
//
// The run window is read once per tile for all K rows (the fusion the TPU
// kernel exists for).  The grid is one block per tile, with no grid-stride
// cap: every tile pays its own window search, so a block looping over tiles
// would save only block launches, and ceil(total / kTile) <= 2^21 blocks
// stays far inside gridDim.x.
//
// A total past the last bound (outside the callers' contract) is clamped as
// the reference oracle clamps it: those outputs take the last run's payload.
// Indexing: total and runs are at most 2^31 - 1 (the caller's int32
// envelope), but K * total is not, so row offsets are 64-bit.
//
// Plain C interface for ctypes: the launch goes on the caller's stream, the
// kernel allocates nothing, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // outputs a thread owns
constexpr int kTile = kThreads * kItems;   // outputs a block owns
constexpr int kVecs = kItems / 4;          // 4-output vectors a thread stores
constexpr unsigned kAll = 0xffffffffu;

// First r in [0, n) with b[r] > t, or n: one warp probes 32 evenly spaced
// runs per step and keeps the span between the last probe <= t and the
// first > t.  Every lane returns the answer.
__device__ __forceinline__ int32_t warp_upper_bound(
    const int32_t* __restrict__ b, int32_t n, int32_t t, int lane) {
  int32_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long span = hi - lo;
    const int32_t p = lo + (int32_t)((span * (lane + 1) + 31) / 32) - 1;
    const unsigned gt = __ballot_sync(kAll, __ldg(b + p) > t);
    if (gt == 0u) {
      return hi;  // every probe, hi - 1 included, is <= t
    }
    const int f = __ffs(gt) - 1;
    const int32_t pf = __shfl_sync(kAll, p, f);
    const int32_t pp = __shfl_sync(kAll, p, f > 0 ? f - 1 : 0);
    lo = f > 0 ? pp + 1 : lo;
    hi = pf;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand_many_kernel(const int32_t* __restrict__ payloads,
                   const int32_t* __restrict__ bounds,
                   int32_t runs, long long total, int32_t k,
                   int32_t* __restrict__ out) {
  __shared__ int4 idx4[kTile / 4];
  __shared__ int32_t window[2];
  __shared__ int32_t warp_max[kWarps];
  int32_t* idx = reinterpret_cast<int32_t*>(idx4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * kTile;
  const int32_t len = (int32_t)min((long long)kTile, total - t0);

  // 1. the run window: the runs of the tile's first and last output,
  // clamped to the last run
  if (warp < 2) {
    const int32_t t = (int32_t)(t0 + (warp == 0 ? 0 : len - 1));
    const int32_t r = warp_upper_bound(bounds, runs, t, lane);
    if (lane == 0) {
      window[warp] = min(r, runs - 1);
    }
  }
  for (int j = tid; j < kTile / 4; j += kThreads) {
    idx4[j] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  const int32_t r0 = window[0], r1 = window[1];

  // 2. where each run of the window begins: bounds[r-1] lies in
  // (t0, t0 + len) for every r in (r0, r1]
  for (long long r = (long long)r0 + 1 + tid; r <= r1; r += kThreads) {
    const int32_t start = __ldg(bounds + r - 1);
    if (r == runs - 1 || __ldg(bounds + r) > start) {
      idx[start - t0] = (int32_t)(r - r0);
    }
  }
  __syncthreads();

  // 3. inclusive max-scan; each thread owns kItems consecutive positions
  int32_t v[kItems];
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
    const int4 x = idx4[tid * kVecs + c];
    v[4 * c] = x.x;
    v[4 * c + 1] = x.y;
    v[4 * c + 2] = x.z;
    v[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int i = 1; i < kItems; ++i) {
    v[i] = max(v[i], v[i - 1]);
  }
  int32_t upto = v[kItems - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(kAll, upto, d);
    if (lane >= d) {
      upto = max(upto, o);
    }
  }
  if (lane == 31) {
    warp_max[warp] = upto;
  }
  int32_t before = __shfl_up_sync(kAll, upto, 1);
  if (lane == 0) {
    before = 0;
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    before = max(before, warp_max[w]);
  }
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
    idx4[tid * kVecs + c] = make_int4(
        max(v[4 * c], before), max(v[4 * c + 1], before),
        max(v[4 * c + 2], before), max(v[4 * c + 3], before));
  }
  __syncthreads();

  // 4. gather and store each payload row
  for (int32_t q = 0; q < k; ++q) {
    const int32_t* pay = payloads + (long long)q * runs + r0;
    int32_t* row = out + (long long)q * total + t0;
    // outputs before the row's first 16-byte boundary in this tile
    const int head = (int)((0 - ((uintptr_t)row >> 2)) & 3);
    const int nvec = len > head ? (len - head) >> 2 : 0;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = tid + i * kThreads;
      if (c < nvec) {
        const int4 a = idx4[c];
        int4 s = a;
        if (head != 0) {
          // positions head + 4c .. head + 4c + 3 straddle two vectors;
          // c + 1 < kTile / 4 since nvec < kTile / 4 when head != 0
          const int4 b = idx4[c + 1];
          if (head == 1) {
            s = make_int4(a.y, a.z, a.w, b.x);
          } else if (head == 2) {
            s = make_int4(a.z, a.w, b.x, b.y);
          } else {
            s = make_int4(a.w, b.x, b.y, b.z);
          }
        }
        const int4 o = make_int4(__ldg(pay + s.x), __ldg(pay + s.y),
                                 __ldg(pay + s.z), __ldg(pay + s.w));
        __stcs(reinterpret_cast<int4*>(row + head + 4 * c), o);
      }
    }
    // the ragged head [0, head) and tail [head + 4 * nvec, len)
    if (tid < 8) {
      const int j = tid < 4 ? tid : head + 4 * nvec + (tid - 4);
      const bool mine = tid < 4 ? j < min(head, len) : j < len;
      if (mine) {
        row[j] = __ldg(pay + idx[j]);
      }
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
  const long long blocks = (total + kTile - 1) / kTile;
  expand_many_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)payloads, (const int32_t*)bounds, (int32_t)runs,
      total, (int32_t)k, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The single-payload expansion (the port of src/repro/kernels/expand.py::
// _expand_kernel) is the K = 1 case of the same function; the TPU needed a
// second kernel only because a Pallas BlockSpec fixes K.  A float32 payload
// is expanded as its bit pattern: the kernel copies 4-byte words.
extern "C" int expand_gather_launch(const void* payload, const void* bounds,
                                    long long runs, long long total,
                                    void* out, void* stream) {
  return expand_many_launch(payload, bounds, runs, total, 1, out, stream);
}
