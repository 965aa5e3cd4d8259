// mul_segsum: fused multiply + segmented sum, hand-written for sm_90a.
//
// Replaces src/repro/kernels/segsum.py::_mul_segsum_kernel (the Pallas TPU
// kernel behind mul_segsum).  It computes the same function:
//
//   out[s] = sum over { i : seg[i] == s } of x[i] * y[i]
//
// over segment ids sorted ascending, with out zeroed by the caller (so an
// empty segment reads 0).  The TPU kernel sums each 512-entry tile with a
// one-hot [512, 512] f32 matmul on the MXU, so it is exact only below 2^24.
// Hopper needs no matrix unit for a segmented sum: this kernel accumulates
// integers in int64 and floats in f64, exact wherever the reference's exact
// int64 XLA path is.
//
// Design.  One block of 256 threads per tile of 2048 entries.  The block
// stages its tile in shared memory with coalesced loads (the products are
// formed there), then each thread reduces 8 consecutive entries serially
// and a block-wide segmented scan of (run-starts-here, trailing-run sum)
// pairs, in warp shuffles, hands each thread the part of its first run
// that began in earlier threads.  A run is written by the thread where it
// ends.  A segment that lies inside the tile is complete there and is
// stored straight into out.  The tile's first and last segment may continue
// in a neighbouring tile, so their tile-local sums go to a carry list,
// [tiles, 2] pairs of (segment, partial) that is itself sorted by segment;
// the next pass reduces that list in the same way, until one tile is left,
// which stores every segment.  A 38M-entry input takes three passes
// (38M -> 37k carries -> 38 -> done).  No atomics: the order of every float
// addition is fixed, so float sums are the same from run to run.  A tile
// inside one long segment (one segment over all n) sends its whole sum to
// the carry list, and so on up, with no serial walk over tiles.
//
// Bound on the H100: HBM bytes.  The function reads n int32 ids and 2n
// 8-byte values and writes num_segments 8-byte sums, (12n + 8 * S) bytes
// over 3.35 TB/s; one multiply-add per entry is far below the card's
// arithmetic rate.  The carry passes move 2 * ceil(n / 2048) pairs, under
// 1% of the first pass.
//
// Plain C interface for ctypes: launches go on the caller's stream, the
// kernel allocates nothing (the caller passes the carry scratch, sized by
// the same tiling: mul_segsum_tile() reports the tile), and the return
// value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive warp scan of (f, v) pairs under the segmented-sum operator
//   a (+) b = (a.f | b.f, b.f ? b.v : a.v + b.v)     (a before b)
template <typename T>
__device__ __forceinline__ void warp_seg_scan(int& f, T& v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int fo = __shfl_up_sync(kFull, f, d);
    const T vo = __shfl_up_sync(kFull, v, d);
    if (lane >= d) {
      if (!f) {
        v = vo + v;
      }
      f |= fo;
    }
  }
}

// Exclusive block scan of one (f, v) pair per thread; (0, 0) for thread 0.
template <typename T>
__device__ __forceinline__ void block_seg_scan(int f, T v, int* s_f, T* s_v,
                                               int& ef, T& ev) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_seg_scan<T>(f, v, lane);
  int fe = __shfl_up_sync(kFull, f, 1);
  T ve = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) {
    fe = 0;
    ve = T(0);
  }
  if (lane == 31) {
    s_f[warp] = f;
    s_v[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    int fw = lane < kWarps ? s_f[lane] : 0;
    T vw = lane < kWarps ? s_v[lane] : T(0);
    warp_seg_scan<T>(fw, vw, lane);
    int fx = __shfl_up_sync(kFull, fw, 1);
    T vx = __shfl_up_sync(kFull, vw, 1);
    if (lane == 0) {
      fx = 0;
      vx = T(0);
    }
    if (lane < kWarps) {
      s_f[lane] = fx;
      s_v[lane] = vx;
    }
  }
  __syncthreads();
  const int pf = s_f[warp];
  const T pv = s_v[warp];
  ef = pf | fe;
  ev = fe ? ve : pv + ve;
}

// One pass over n sorted (seg, value) entries.  kMul: value = x[i] * y[i]
// (the first pass); else value = x[i] (a carry pass).  carry_seg == nullptr
// marks the last pass (one tile), which stores every segment into out.
template <typename T, bool kMul>
__global__ void __launch_bounds__(kThreads)
segsum_pass(const int32_t* __restrict__ seg, const T* __restrict__ x,
            const T* __restrict__ y, long long n, T* __restrict__ out,
            long long num_segments, int32_t* __restrict__ carry_seg,
            T* __restrict__ carry_val) {
  __shared__ int32_t s_seg[kTile];
  __shared__ T s_val[kTile];
  __shared__ int s_f[kWarps];
  __shared__ T s_v[kWarps];

  const long long lo = (long long)blockIdx.x * kTile;
  const int cnt = (int)(n - lo < kTile ? n - lo : kTile);
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    s_seg[i] = __ldg(seg + lo + i);
    T v = __ldg(x + lo + i);
    if (kMul) {
      v *= __ldg(y + lo + i);
    }
    s_val[i] = v;
  }
  __syncthreads();
  // a ragged last tile: extend its last run with zeros
  const int32_t last_seg = s_seg[cnt - 1];
  for (int i = cnt + threadIdx.x; i < kTile; i += kThreads) {
    s_seg[i] = last_seg;
    s_val[i] = T(0);
  }
  __syncthreads();
  const int32_t first_seg = s_seg[0];
  const bool to_carry = carry_seg != nullptr;
  const long long c0 = 2LL * blockIdx.x;
  if (to_carry && threadIdx.x == 0 && first_seg == last_seg) {
    carry_seg[c0 + 1] = last_seg;  // one segment: its sum goes in slot 0
    carry_val[c0 + 1] = T(0);
  }
  // Sorted ids: each segment is one run of the tile, written once.
  auto emit = [&](int32_t s, T v) {
    if (to_carry && s == first_seg) {
      carry_seg[c0] = s;
      carry_val[c0] = v;
    } else if (to_carry && s == last_seg) {
      carry_seg[c0 + 1] = s;
      carry_val[c0 + 1] = v;
    } else if (s >= 0 && s < num_segments) {
      out[s] = v;
    }
  };

  const int base = threadIdx.x * kItems;
  int32_t cur = s_seg[base];
  T acc = s_val[base];
  const bool head = base == 0 || s_seg[base - 1] != cur;
  const int32_t first_id = cur;
  bool first_closed = false;
  T first_sum = T(0);
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    const int32_t s = s_seg[base + k];
    const T v = s_val[base + k];
    if (s != cur) {
      if (first_closed) {
        emit(cur, acc);  // began and ended in this thread
      } else {
        first_sum = acc;
        first_closed = true;
      }
      cur = s;
      acc = v;
    } else {
      acc += v;
    }
  }
  // the trailing run starts here if the thread closed a run or began one
  int ef;
  T ev;
  block_seg_scan<T>((first_closed || head) ? 1 : 0, acc, s_f, s_v, ef, ev);
  const T carry_in = head ? T(0) : ev;
  if (first_closed) {
    emit(first_id, carry_in + first_sum);
  }
  const bool tail_ends = base + kItems == kTile || s_seg[base + kItems] != cur;
  if (tail_ends) {
    emit(cur, first_closed ? acc : carry_in + acc);
  }
}

template <typename T>
int run_passes(const int32_t* seg, const T* x, const T* y, long long n,
               T* out, long long num_segments, int32_t* carry_seg,
               T* carry_val, long long carry_cap, cudaStream_t stream) {
  long long off = 0;
  bool first = true;
  for (;;) {
    const long long tiles = (n + kTile - 1) / kTile;
    int32_t* cs = nullptr;
    T* cv = nullptr;
    if (tiles > 1) {
      if (off + 2 * tiles > carry_cap) {
        return (int)cudaErrorInvalidValue;
      }
      cs = carry_seg + off;
      cv = carry_val + off;
    }
    if (first) {
      segsum_pass<T, true><<<(unsigned)tiles, kThreads, 0, stream>>>(
          seg, x, y, n, out, num_segments, cs, cv);
    } else {
      segsum_pass<T, false><<<(unsigned)tiles, kThreads, 0, stream>>>(
          seg, x, nullptr, n, out, num_segments, cs, cv);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || tiles == 1) {
      return (int)err;
    }
    seg = cs;
    x = cv;
    n = 2 * tiles;
    off += 2 * tiles;
    first = false;
  }
}

}  // namespace

extern "C" int mul_segsum_tile() { return kTile; }

extern "C" int mul_segsum_launch(const void* seg, const void* x,
                                 const void* y, long long n, int is_float,
                                 void* out, long long num_segments,
                                 void* carry_seg, void* carry_val,
                                 long long carry_cap, void* stream) {
  if (n <= 0) {
    return 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_float) {
    return run_passes<double>((const int32_t*)seg, (const double*)x,
                              (const double*)y, n, (double*)out, num_segments,
                              (int32_t*)carry_seg, (double*)carry_val,
                              carry_cap, s);
  }
  return run_passes<long long>(
      (const int32_t*)seg, (const long long*)x, (const long long*)y, n,
      (long long*)out, num_segments, (int32_t*)carry_seg,
      (long long*)carry_val, carry_cap, s);
}
