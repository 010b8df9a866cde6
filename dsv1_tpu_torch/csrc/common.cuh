// Shared helpers of the DSV1 CUDA kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dsv1 {

constexpr int kThreads = 256;             // threads per block, all kernels
constexpr int kWarps = kThreads / 32;
constexpr int kIntMax = 0x7fffffff;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

// Sums v[0..N) over the thread block; every thread receives the totals.
// red: __shared__ scratch of at least N * kWarps ints. All threads of
// the block must call it (it synchronises).
template <int N>
__device__ __forceinline__ void block_sum(int (&v)[N], int* red) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[k * kWarps + wid] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[k * kWarps + i];
    v[k] = s;
  }
}

}  // namespace dsv1
