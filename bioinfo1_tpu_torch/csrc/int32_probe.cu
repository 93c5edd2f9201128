// K6 - int32 add/max throughput probe: the rate that sets the DP roofline.
//
// Replaces the Pallas microkernel bench.py `measure_sol.kern` (the
// pl.pallas_call in `run_vpu`).  Per element x it runs kIlp = 4 independent
// chains, chain c starting at x + c + 1; loop trip i (0 <= i < n_iter)
// applies a = max(a + i, a) kUnroll = 32 times to every chain; the output
// is the max over the chains.  Additions wrap in 32 bits, as the TPU
// kernel's (and PyTorch's) int32 additions do.
//
// Laid out for the card, not tile by tile: one element per thread, its
// four chains in registers, 256 threads per CTA, so the (256, 1024) probe
// shape is 1,024 CTAs - one wave over 132 SMs at 8 CTAs each (64 warps
// per SM, 4 independent dependency chains per thread).
//
// What bounds it: integer-pipe issue.  One trip reads nothing and writes
// nothing; the kernel moves 8 bytes per element in total.  The probe is
// only worth its number if the instruction stream is the one written
// here, so nothing may be folded:
//   * the add is done in unsigned arithmetic (defined wrap-around), so the
//     compiler may not assume a + i >= a and drop the max;
//   * the per-trip increment is inc_i = i * step with `step` a kernel
//     argument (1 in every call), opaque at compile time;
//   * the trip loop is not unrolled (#pragma unroll 1), its body fully, so
//     the body holds kIlp * kUnroll = 128 add/max steps.
// On sm_90a one step may issue as one fused VIADDMNMX instead of an IADD3
// and a VIMNMX; the bench counts the body's instructions in the SASS and
// reports both source operations (2 per step) and issued instructions.

#include <cuda_runtime.h>

namespace {

constexpr int kIlp = 4;
constexpr int kUnroll = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(kThreads)
    int32_probe_kernel(const int* __restrict__ x, int* __restrict__ out,
                       long long n, int n_iter, int step) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int v = x[idx];
  int a[kIlp];
#pragma unroll
  for (int c = 0; c < kIlp; ++c) a[c] = wrap_add(v, c + 1);
  int inc = 0;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kIlp; ++c) a[c] = max(wrap_add(a[c], inc), a[c]);
    }
    inc = wrap_add(inc, step);
  }
  int r = a[0];
#pragma unroll
  for (int c = 1; c < kIlp; ++c) r = max(r, a[c]);
  out[idx] = r;
}

}  // namespace

// K6.  x, out: n int32 each; step: the per-trip growth of the increment
// (callers pass 1).
extern "C" int bioinfo1_int32_probe(const void* x, void* out, long long n,
                                    int n_iter, int step, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  int32_probe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), n, n_iter, step);
  return static_cast<int>(cudaGetLastError());
}
