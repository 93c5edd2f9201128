// Shared helpers for the port's kernels: block-wide max reductions.
//
// Every helper must be called by ALL threads of the block (blockDim.x a
// multiple of 32, at most 1024): it uses full-warp shuffles and
// __syncthreads.  `scratch` needs one slot per warp (32 slots).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace bioinfo1 {

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

// Opt a kernel into `bytes` of dynamic shared memory.  Set whenever any is
// used: the 48 KB default limit also counts the kernel's static buffers,
// so a request of exactly 48 KB already needs the opt-in.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace bioinfo1
