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
// Bound on the H100: operations, for all but the thinnest products.  The
// function reads (P*V + V*K) inputs and writes P*K outputs once, and does
// P*V*K multiply-adds: FP32 at 67 TFLOP/s (two operations each), int32
// multiply-adds at the CUDA C++ Programming Guide's rate for compute
// capability 9.0 (64 per clock per SM) over the SASS instructions each takes.
// At K = 1 (a matrix-vector message) the HBM bytes bound it instead.
//
// Design, simple first: a block owns a 64 x 64 output tile (P rows by K
// columns) and walks V in steps of 16, staging a 64 x 16 tile of phi and a
// 16 x 64 tile of m in shared memory; each of its 256 threads keeps a 4 x 4
// micro-tile of sums in registers.  Tiles are loaded with bounds checks
// (zeros past the edge), so P, V and K take any size; the TPU kernel padded
// them to multiples of 256 x 256 x 128 on the host instead.  The phi tile is
// stored transposed with one word of padding per row, so neither its stores
// nor the micro-tile's reads conflict on the shared-memory banks.  Thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j, so a warp's stores of
// one output row are contiguous.  At K = 1 a tile wastes 63 of its 64
// columns: a redesign (FP64 DMMA, exact to 2^53, or integer MMA on the
// tensor cores; a thin-K path) is later work.
//
// Offsets are 64-bit: P * V may pass 2^31.  The grid is (ceil(P / 64),
// ceil(K / 64)); the caller keeps ceil(K / 64) within gridDim.y's 65,535.
//
// Plain C interface for ctypes: the launch goes on the caller's stream, the
// kernel allocates nothing, and the return value is cudaGetLastError().

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
  using Acc = long long;
  static __device__ __forceinline__ Acc mac(Acc acc, In a, In b) {
    return acc + (long long)a * (long long)b;   // mul.wide.s32, 64-bit add
  }
};

struct Float {
  using In = float;
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
