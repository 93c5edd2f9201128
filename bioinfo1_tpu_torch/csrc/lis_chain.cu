// K1 - LIS chaining of seed matches, one CTA per match row.
//
// Replaces the Pallas kernel bioinfo1_tpu/ops/pallas_chain.py `_kernel`
// (reached through `lis_chain` / `lis_chain_sorted`).  Same contract as
// bioinfo1_tpu/ops/chain.py `lis_chain`: j < i is a predecessor of i iff
//   r_j < r_i < r_j + 5000  and  f_j < f_i < f_j + 5000;
// the earliest j among the longest predecessors wins, the chain end is the
// first argmax of lis, and only the chain's endpoints are returned.
//
// State per match is packed as (lis << 16) | (0xFFFF - j) in 32 unsigned
// bits, so one max picks the highest lis and, among ties, the smallest j.
// (Unsigned, so lis may reach 65535: the wrapper requires N <= 65535.)
//
// What bounds it on the card: the serial loop over i (a true dependency)
// with one block-wide max per i, i.e. two __syncthreads per match, plus
// the O(N^2 / 2) pair tests, which are cheap integer compares out of shared
// memory.  Rows are independent CTAs, so the TPU's row sort by count
// (lis_chain_sorted, which made tiles homogeneous) is not needed: a short
// row simply finishes early and frees its SM slot.  f, r and the packed
// state sit in shared memory when 12*N bytes fit; beyond that (boosted
// budgets, N up to 32768) the wrapper passes a global scratch and the
// kernel reads f and r straight from the inputs.  prev is always a global
// scratch row: it is written once per match and read only by the final
// pointer chase.

#include "common.cuh"

namespace {

constexpr int kGapCap = 5000;
constexpr unsigned kJMask = 0xFFFFu;

__global__ void lis_chain_kernel(const int* __restrict__ f_pos,
                                 const int* __restrict__ r_pos,
                                 const int* __restrict__ count, int R, int N,
                                 unsigned* __restrict__ packed_g,
                                 int* __restrict__ prev_g,
                                 int* __restrict__ out, int use_smem) {
  extern __shared__ int smem[];
  __shared__ unsigned red[32];
  const int row = blockIdx.x;
  const int cnt = min(max(count[row], 0), N);
  const int* fg = f_pos + static_cast<size_t>(row) * N;
  const int* rg = r_pos + static_cast<size_t>(row) * N;
  int* prev = prev_g + static_cast<size_t>(row) * N;

  const int* f = fg;
  const int* r = rg;
  unsigned* packed = packed_g + static_cast<size_t>(row) * N;
  if (use_smem) {
    int* fs = smem;
    int* rs = smem + N;
    for (int j = threadIdx.x; j < max(cnt, 1); j += blockDim.x) {
      fs[j] = fg[j];
      rs[j] = rg[j];
    }
    f = fs;
    r = rs;
    packed = reinterpret_cast<unsigned*>(smem + 2 * N);
  }
  for (int j = threadIdx.x; j < cnt; j += blockDim.x)
    packed[j] = (1u << 16) | (kJMask - j);
  if (threadIdx.x == 0) prev[0] = -1;
  __syncthreads();

  for (int i = 1; i < cnt; ++i) {
    const int fi = f[i], ri = r[i];
    unsigned best = 0;
    for (int j = threadIdx.x; j < i; j += blockDim.x) {
      const int fj = f[j], rj = r[j];
      if (rj < ri && ri - rj < kGapCap && fj < fi && fi - fj < kGapCap) {
        const unsigned p = packed[j];
        best = p > best ? p : best;
      }
    }
    best = bioinfo1::block_max(best, red, 0u);
    if (threadIdx.x == 0) {
      const bool has = best > 0;
      packed[i] = ((has ? (best >> 16) + 1u : 1u) << 16) | (kJMask - i);
      prev[i] = has ? static_cast<int>(kJMask - (best & kJMask)) : -1;
    }
    __syncthreads();
  }

  unsigned pmax = 0;
  for (int j = threadIdx.x; j < cnt; j += blockDim.x)
    pmax = packed[j] > pmax ? packed[j] : pmax;
  pmax = bioinfo1::block_max(pmax, red, 0u);
  if (threadIdx.x == 0) {
    // count == 0: length 0 and endpoints read from lane 0, as lis_chain.
    int length = 0, end = 0, root = 0;
    if (pmax > 0) {
      length = static_cast<int>(pmax >> 16);
      end = static_cast<int>(kJMask - (pmax & kJMask));
      root = end;
      while (prev[root] >= 0) root = prev[root];
    }
    out[0 * R + row] = length;
    out[1 * R + row] = f[root];
    out[2 * R + row] = f[end];
    out[3 * R + row] = r[root];
    out[4 * R + row] = r[end];
  }
}

}  // namespace

// f, r: (R, N) int32; count: (R,) int32; packed_scratch: (R, N) uint32,
// used when use_smem == 0; prev_scratch: (R, N) int32; out: (5, R) int32
// rows length, q_start, q_end, t_start, t_end.
extern "C" int bioinfo1_lis_chain(const void* f, const void* r,
                                  const void* count, int R, int N,
                                  void* packed_scratch, void* prev_scratch,
                                  void* out, int use_smem, void* stream) {
  const size_t smem = use_smem ? static_cast<size_t>(12) * N : 0;
  cudaError_t e = bioinfo1::allow_smem(lis_chain_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lis_chain_kernel<<<R, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(f), static_cast<const int*>(r),
      static_cast<const int*>(count), R, N,
      static_cast<unsigned*>(packed_scratch), static_cast<int*>(prev_scratch),
      static_cast<int*>(out), use_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bioinfo1_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
