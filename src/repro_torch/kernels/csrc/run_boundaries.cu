// run_boundaries: run-start flags over sorted keys, hand-written for sm_90a.
//
// Replaces src/repro/kernels/boundaries.py::_boundaries_kernel (the Pallas
// TPU kernel behind run_boundaries).  It computes the same function:
//
//   flags[i] = 1  if i == 0 or keys[i] != keys[i-1],  else 0
//
// over sorted keys, int32 as in the reference, or int64 (the packed ranks of
// a device GROUP BY sort, which the reference compares in plain XLA).
//
// The TPU kernel maps the previous block a second time to get a one-element
// halo, because a Pallas block sees only its own VMEM window.  Hopper reads
// any address, so each thread loads keys[i-1] itself: the neighbour's word
// is in the same or the previous 128-byte line, which L1/L2 already holds.
// No padding and no halo block.
//
// Bound on the H100: HBM bytes.  The function reads n keys and writes n
// int32 flags, n * (key bytes + 4) over 3.35 TB/s, with one compare per
// element.  One thread per position, consecutive threads on consecutive
// positions, so every load and store of a warp is one contiguous segment.
//
// Plain C interface for ctypes: the launch goes on the caller's stream, the
// kernel allocates nothing, and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;  // grid-stride beyond this

template <typename K>
__global__ void __launch_bounds__(kThreads)
boundaries_kernel(const K* __restrict__ keys, long long n,
                  int32_t* __restrict__ flags) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    flags[i] = (i == 0 || __ldg(keys + i) != __ldg(keys + i - 1)) ? 1 : 0;
  }
}

}  // namespace

extern "C" int run_boundaries_launch(const void* keys, long long n,
                                     int key_bytes, void* flags,
                                     void* stream) {
  if (n <= 0) {
    return 0;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (key_bytes == 4) {
    boundaries_kernel<int32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int32_t*)keys, n, (int32_t*)flags);
  } else if (key_bytes == 8) {
    boundaries_kernel<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const long long*)keys, n, (int32_t*)flags);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
