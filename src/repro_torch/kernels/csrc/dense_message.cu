// dense_message: the sum-product message of a dense potential, hand-written
// for sm_90a.
//
// Replaces src/repro/kernels/dense_contract.py::_dense_message_kernel (the
// Pallas TPU kernel behind dense_message).  It computes the same function:
//
//   out[p, k] = sum over v of phi[p, v] * m[v, k]      (p < P, k < K)
//
// a matrix product in the counting semiring, (+, x) over the integers.  One
// source, two instantiations:
//
//   counts  int32 phi and m, each product widened to 64 bits (mul.wide.s32)
//           and summed in int64; int64 out.  Integer addition mod 2^64 is
//           associative, so the result equals numpy's int64 route
//           (Factor.multiply, then marginalize_out) bit for bit on every
//           input, even where int64 wraps.  The TPU kernel sums in f32 on
//           the MXU and is exact only below 2^24.
//   float   float32 phi and m, IEEE fmaf on the CUDA cores; float32 out (the
//           reference's contract).  No TF32 anywhere: Hopper's tensor cores
//           have no IEEE-f32 mode, and TF32 gets counts above 2^11 wrong.
//
// Bound on the H100: operations at wide K, HBM bytes at thin K.  The
// function reads (P*V + V*K) inputs and writes P*K outputs once, and does
// P*V*K multiply-adds: FP32 at 67 TFLOP/s (two operations each), int32
// multiply-adds at the CUDA C++ Programming Guide's rate for compute
// capability 9.0 (64 per clock per SM) over the SASS instructions each takes.
// At K = 1 (a matrix-vector message, the only width any path launches) the
// bytes of phi bound it: 14.3 MB for Last.fm's 1,892 x 1,892 potential,
// 0.0043 ms at 3.35 TB/s.  Two kernels, picked by the wrapper on K:
//
// Thin K (K <= THIN_K in dense_message.py, set from chip_smoke.py's K
// sweep): rows over warps.  Each warp owns one row p and keeps K sums in
// registers (KP of them, K rounded up to a power of two, the rest zeros).
// Its lanes stream the row as 16-byte vectors, 2-4 independent loads in
// flight each before any is used, so the card has ~1,900 rows x 512 B of
// loads in flight instead of one synchronised 16-deep step per block; a
// warp shuffle sums the lanes at the end and lane 0 writes out[p, 0..K).
// The block's 8 warps share m, staged once per block in shared memory in
// chunks of at most 48 KB (zero-padded to KP columns) and read back as
// vectors.  A vector load needs a 16-byte-aligned address, which a row has
// only when V % 4 == 0 and phi's pointer is aligned (an offset view such as
// phi_full[1:] is contiguous and is not): each row reads a scalar head up to
// its first aligned element, then vectors, then a scalar tail, and takes m
// as scalars where the shared vector would straddle.  Where P rows cannot
// fill the card (P below 8 warps per SM), the wrapper cuts V into splits
// over grid.y; each block writes its partial sums to [splits, P, K]
// scratch, and a second kernel sums the splits, one warp per output, in a
// fixed order.  No atomics: float sums are the same from run to run.
//
// Wide K: a block owns a 64 x 64 output tile (P rows by K columns) and walks
// V in steps of 16, staging a 64 x 16 tile of phi and a 16 x 64 tile of m in
// shared memory; each of its 256 threads keeps a 4 x 4 micro-tile of sums in
// registers.  Tiles are loaded with bounds checks (zeros past the edge), so
// P, V and K take any size; the TPU kernel padded them to multiples of 256 x
// 256 x 128 on the host instead.  The phi tile is stored transposed with one
// word of padding per row, so neither its stores nor the micro-tile's reads
// conflict on the shared-memory banks.  Thread (ty, tx) owns rows ty + 16 i
// and columns tx + 16 j, so a warp's stores of one output row are
// contiguous.  (FP64 DMMA, exact to 2^53, or integer MMA on the tensor cores
// would lift its operation bound; no path launches it today.)
//
// Offsets are 64-bit: P * V may pass 2^31.  The tiled grid is (ceil(P / 64),
// ceil(K / 64)); the caller keeps ceil(K / 64) within gridDim.y's 65,535.
// The thin grid is (ceil(P / 8), splits), with splits <= 65,535.
//
// Plain C interface for ctypes: the launches go on the caller's stream, the
// kernels allocate nothing (the wrapper passes the split scratch), and the
// return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                   // output tile, rows and columns
constexpr int kDepth = 16;                  // V staged per step
constexpr int kMicro = 4;                   // micro-tile per thread, each way
constexpr int kGroups = kTile / kMicro;     // 16 row and 16 column groups
constexpr int kThreads = kGroups * kGroups; // 256

struct Counts {
  using In = int32_t;
  using In4 = int4;
  using Acc = long long;
  static __device__ __forceinline__ Acc mac(Acc acc, In a, In b) {
    return acc + (long long)a * (long long)b;   // mul.wide.s32, 64-bit add
  }
};

struct Float {
  using In = float;
  using In4 = float4;
  using Acc = float;
  static __device__ __forceinline__ Acc mac(Acc acc, In a, In b) {
    return fmaf(a, b, acc);                     // IEEE f32, CUDA cores
  }
};

template <class T>
__global__ void __launch_bounds__(kThreads)
dense_message_kernel(const typename T::In* __restrict__ phi,
                     const typename T::In* __restrict__ m,
                     long long P, long long V, long long K,
                     typename T::Acc* __restrict__ out) {
  using In = typename T::In;
  using Acc = typename T::Acc;
  __shared__ In a_s[kDepth][kTile + 1];   // phi tile, transposed: [v][p]
  __shared__ In b_s[kDepth][kTile];       // m tile: [v][k]
  const int tx = threadIdx.x % kGroups;
  const int ty = threadIdx.x / kGroups;
  const long long p0 = (long long)blockIdx.x * kTile;
  const long long k0 = (long long)blockIdx.y * kTile;

  Acc acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      acc[i][j] = Acc(0);
    }
  }

  for (long long v0 = 0; v0 < V; v0 += kDepth) {
#pragma unroll
    for (int s = 0; s < kTile * kDepth / kThreads; ++s) {
      const int e = threadIdx.x + s * kThreads;
      // phi: 64 rows of 16, consecutive threads on consecutive v
      const int r = e / kDepth, c = e % kDepth;
      const long long p = p0 + r, v = v0 + c;
      a_s[c][r] = (p < P && v < V) ? __ldg(phi + p * V + v) : In(0);
      // m: 16 rows of 64, consecutive threads on consecutive k
      const int rb = e / kTile, cb = e % kTile;
      const long long vb = v0 + rb, kb = k0 + cb;
      b_s[rb][cb] = (vb < V && kb < K) ? __ldg(m + vb * K + kb) : In(0);
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      In a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        a[i] = a_s[d][ty + i * kGroups];
        b[i] = b_s[d][tx + i * kGroups];
      }
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          acc[i][j] = T::mac(acc[i][j], a[i], b[j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const long long p = p0 + ty + i * kGroups;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const long long k = k0 + tx + j * kGroups;
      if (p < P && k < K) {
        out[p * K + k] = acc[i][j];
      }
    }
  }
}

template <class T>
int launch(const void* phi, const void* m, long long P, long long V,
           long long K, void* out, void* stream) {
  if (P <= 0 || V <= 0 || K <= 0) {
    return 0;
  }
  const dim3 grid((unsigned)((P + kTile - 1) / kTile),
                  (unsigned)((K + kTile - 1) / kTile));
  dense_message_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const typename T::In*)phi, (const typename T::In*)m, P, V, K,
      (typename T::Acc*)out);
  return (int)cudaGetLastError();
}

// -- thin K ------------------------------------------------------------------

constexpr int kThinWarps = 8;                     // rows per block
constexpr int kThinThreads = kThinWarps * 32;
constexpr long long kStageWords = 12288;          // m staged per chunk: 48 KB
constexpr unsigned kAll = 0xffffffffu;

// acc[k] += x[e] * m[v + e, k] for the 4 rows v..v+3 of m staged at ms
// (4 * KP consecutive words): as KP 16-byte vectors where ms is aligned,
// else word by word.
template <class T, int KP>
__device__ __forceinline__ void mac4(typename T::Acc (&acc)[KP],
                                     const typename T::In4& x,
                                     const typename T::In* ms, bool vec) {
  using In = typename T::In;
  using In4 = typename T::In4;
  const In xs[4] = {x.x, x.y, x.z, x.w};
  if (vec) {
    const In4* m4 = reinterpret_cast<const In4*>(ms);
#pragma unroll
    for (int w = 0; w < KP; ++w) {
      const In4 mv = m4[w];
      const In mm[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = (4 * w + c) / KP, k = (4 * w + c) % KP;
        acc[k] = T::mac(acc[k], xs[e], mm[c]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * KP; ++i) {
      acc[i % KP] = T::mac(acc[i % KP], xs[i / KP], ms[i]);
    }
  }
}

// Warp w of block (bx, s) sums row p = 8 bx + w over V's split s,
// [s * vstep, min(V, (s + 1) * vstep)), into out[s, p, 0..K).
template <class T, int KP>
__global__ void __launch_bounds__(kThinThreads)
dense_thin_kernel(const typename T::In* __restrict__ phi,
                  const typename T::In* __restrict__ m,
                  long long P, long long V, long long K, long long vstep,
                  typename T::Acc* __restrict__ out) {
  using In = typename T::In;
  using In4 = typename T::In4;
  using Acc = typename T::Acc;
  constexpr int U = KP <= 8 ? 4 : 2;              // vectors in flight a lane
  constexpr long long kChunk = kStageWords / KP;  // rows of m per chunk
  extern __shared__ __align__(16) unsigned char smem[];
  In* m_s = reinterpret_cast<In*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * kThinWarps + warp;
  const long long vlo = (long long)blockIdx.y * vstep;
  const long long vhi = min(V, vlo + vstep);
  const In* row = phi + p * V;

  Acc acc[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    acc[k] = Acc(0);
  }

  for (long long c0 = vlo; c0 < vhi; c0 += kChunk) {
    const long long c1 = min(vhi, c0 + kChunk);
    const int n = (int)((c1 - c0) * KP);
    __syncthreads();                              // the last chunk is read
    for (int e = threadIdx.x; e < n; e += kThinThreads) {
      const int kk = e % KP;
      m_s[e] = kk < K ? __ldg(m + (c0 + e / KP) * K + kk) : In(0);
    }
    __syncthreads();
    if (p < P) {
      // the row's first 16-byte boundary at or after c0
      const long long va =
          min(c1, c0 + (long long)((0 - ((uintptr_t)(row + c0) >> 2)) & 3));
      const long long nvec = (c1 - va) >> 2;
      const long long vt = va + 4 * nvec;
      // scalar head [c0, va) and tail [vt, c1), at most 3 each
      if (lane < 8) {
        const long long v = lane < 4 ? c0 + lane : vt + (lane - 4);
        if (lane < 4 ? v < va : v < c1) {
          const In x = __ldg(row + v);
          const In* ms = m_s + (v - c0) * KP;
#pragma unroll
          for (int k = 0; k < KP; ++k) {
            acc[k] = T::mac(acc[k], x, ms[k]);
          }
        }
      }
      const In4* rv = reinterpret_cast<const In4*>(row + va);
      const In* mv = m_s + (va - c0) * KP;
      const bool vec = KP >= 4 || ((va - c0) & 3) == 0;
      for (long long i = lane; i < nvec; i += 32 * U) {
        In4 x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long j = i + 32 * u;
          if (j < nvec) {
            x[u] = __ldg(rv + j);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long j = i + 32 * u;
          if (j < nvec) {
            mac4<T, KP>(acc, x[u], mv + 4 * j * KP, vec);
          }
        }
      }
    }
  }

  if (p < P) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        acc[k] += __shfl_down_sync(kAll, acc[k], d);
      }
    }
    if (lane == 0) {
      Acc* o = out + ((long long)blockIdx.y * P + p) * K;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k < K) {
          o[k] = acc[k];
        }
      }
    }
  }
}

// out[o] = sum over s of part[s, o], one warp per output, lanes over s and
// then a shuffle tree: the same order on every run.
template <class Acc>
__global__ void __launch_bounds__(256)
dense_split_sum_kernel(const Acc* __restrict__ part, long long splits,
                       long long n, Acc* __restrict__ out) {
  const long long o = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (o >= n) {
    return;                                       // the whole warp
  }
  Acc sum = Acc(0);
  for (long long s = lane; s < splits; s += 32) {
    sum += part[s * n + o];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sum += __shfl_down_sync(kAll, sum, d);
  }
  if (lane == 0) {
    out[o] = sum;
  }
}

struct ThinArgs {
  const void* phi;
  const void* m;
  long long P, V, K, splits, vstep;
  void* part;
  void* out;
  cudaStream_t stream;
};

template <class T, int KP>
int launch_thin(const ThinArgs& a) {
  using In = typename T::In;
  using Acc = typename T::Acc;
  const long long rows =
      a.vstep < kStageWords / KP ? a.vstep : kStageWords / KP;
  const dim3 grid((unsigned)((a.P + kThinWarps - 1) / kThinWarps),
                  (unsigned)a.splits);
  dense_thin_kernel<T, KP><<<grid, kThinThreads, rows * KP * sizeof(In),
                             a.stream>>>(
      (const In*)a.phi, (const In*)a.m, a.P, a.V, a.K, a.vstep,
      (Acc*)(a.splits > 1 ? a.part : a.out));
  if (a.splits > 1) {
    const long long n = a.P * a.K;
    dense_split_sum_kernel<Acc><<<(unsigned)((n * 32 + 255) / 256), 256, 0,
                                  a.stream>>>((const Acc*)a.part, a.splits,
                                              n, (Acc*)a.out);
  }
  return (int)cudaGetLastError();
}

// K rounded up to a power of two picks the instantiation
template <class T>
int thin(const ThinArgs& a) {
  if (a.P <= 0 || a.V <= 0 || a.K <= 0) {
    return 0;
  }
  if (a.K <= 1) return launch_thin<T, 1>(a);
  if (a.K <= 2) return launch_thin<T, 2>(a);
  if (a.K <= 4) return launch_thin<T, 4>(a);
  if (a.K <= 8) return launch_thin<T, 8>(a);
  if (a.K <= 16) return launch_thin<T, 16>(a);
  if (a.K <= 32) return launch_thin<T, 32>(a);
  if (a.K <= 64) return launch_thin<T, 64>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dense_message_counts_launch(const void* phi, const void* m,
                                           long long P, long long V,
                                           long long K, void* out,
                                           void* stream) {
  return launch<Counts>(phi, m, P, V, K, out, stream);
}

extern "C" int dense_message_float_launch(const void* phi, const void* m,
                                          long long P, long long V,
                                          long long K, void* out,
                                          void* stream) {
  return launch<Float>(phi, m, P, V, K, out, stream);
}

// Thin K (K <= 64): splits >= 1 cuts V into steps of vstep (a multiple of 4
// where splits > 1); part is [splits, P, K] scratch of the output type when
// splits > 1, else unused.
extern "C" int dense_message_thin_counts_launch(
    const void* phi, const void* m, long long P, long long V, long long K,
    long long splits, long long vstep, void* part, void* out, void* stream) {
  return thin<Counts>(
      {phi, m, P, V, K, splits, vstep, part, out, (cudaStream_t)stream});
}

extern "C" int dense_message_thin_float_launch(
    const void* phi, const void* m, long long P, long long V, long long K,
    long long splits, long long vstep, void* part, void* out, void* stream) {
  return thin<Float>(
      {phi, m, P, V, K, splits, vstep, part, out, (cudaStream_t)stream});
}
