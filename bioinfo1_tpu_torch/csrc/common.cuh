// Shared helpers for the port's kernels: block-wide max reductions, and
// two per-thread helpers of the register DP kernels (K2 / K4, K3).
//
// Every reduction must be called by ALL threads of the block (blockDim.x a
// multiple of 32, at most 1024): it uses full-warp shuffles and
// __syncthreads.  `scratch` needs one slot per warp (32 slots).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace bioinfo1 {

// v[k] for a k known only at run time, by selects: indexing a register
// array with it would move the array to local memory.
template <int N>
__device__ __forceinline__ int pick(const int (&v)[N], int k) {
  int r = v[0];
#pragma unroll
  for (int x = 1; x < N; ++x) r = k == x ? v[x] : r;
  return r;
}

// Goal candidates (cost c, cell (i, j)) are ordered by cost, then smaller
// i, then smaller j.
__device__ __forceinline__ bool goal_better(int c2, int i2, int j2, int c,
                                            int i, int j) {
  return c2 > c || (c2 == c && (i2 < i || (i2 == i && j2 < j)));
}

// T is unsigned or long long (the types __shfl_xor_sync takes here).
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// Block max; every thread receives the result.  `identity` is the max of
// an empty set (the smallest value the caller uses).
template <typename T>
__device__ __forceinline__ T block_max(T v, T* scratch, T identity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = lane < nwarps ? scratch[lane] : identity;
  r = warp_max(r);
  __syncthreads();  // scratch may be reused right after
  return r;
}

// Opt a kernel into dynamic shared memory before a launch that asks for
// `bytes` of it.  Set whenever any is used: the 48 KB default limit also
// counts the kernel's static buffers, so a request of exactly 48 KB already
// needs the opt-in.  The attribute is set to the most the kernel may have
// (the device's opt-in limit less its static buffers), never to `bytes`:
// the attribute is per kernel and the mapper launches from several host
// threads, so a thread that set a small value between another thread's
// opt-in and its launch would make that launch fail (invalid argument).
// Every caller writing the same value makes the order irrelevant.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes == 0) return cudaSuccess;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  int device = 0, optin = 0;
  e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return e;
  const size_t most = static_cast<size_t>(optin) - fa.sharedSizeBytes;
  if (bytes > most) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(most));
}

}  // namespace bioinfo1
