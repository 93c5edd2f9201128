// K5 - traceback walk over K4's packed parents, one thread per read, in
// all three modes.
//
// Replaces the Pallas kernel bioinfo1_tpu/ops/trace.py
// `walk_parents_pallas` (global and semiGlobal) and, for local mode, the
// XLA walk `trace.walk_parents` that the JAX package keeps there.  The
// output is the XLA walk's, packed: step-indexed op codes (0 M, 1 I, 2 D,
// 3 done) 4 per byte, step s at row s >> 2, bit 2 * (s & 3), shape
// (S4 + 1, B) - the layout of trace.pack_codes(trace.walk_parents(...)).
//
// Each step, exactly as the XLA walk takes it:
//   * d = i + j; the parent byte sits at row clip(d - 2, 0, 4*S4 - 1) >> 2,
//     lane clip((j - i + W - (d & 1)) >> 1, 0, W - 1), bit 2 * ((d-2) & 3);
//   * global / semiGlobal: active while i > 0 or j > 0; i == 0 takes I,
//     j == 0 takes D, else the parent;
//   * local: active while cost > 0, starting from the score; the parent is
//     taken as it is, and cost -= its edge (match / mismatch on the bytes
//     q[i-1], t[j-1], clipped to the row; a gap is free against '-');
//   * M steps (i-1, j-1), I steps j-1, D steps i-1; a parent of 3 (bytes
//     the band never wrote, only on reads the strict certificate rejects)
//     emits 3 and stays.
// An inactive read stays inactive, so the walk stops there: the wrapper
// fills the output with 0xFF (all done) first, and the thread completes
// its last partial byte with 3s.
//
// The Pallas walk streams parent rows through VMEM in descending slabs and
// masks a 256-lane window per diagonal, because gathers are slow on the
// TPU.  On the card one dependent byte load per step is the natural form.
// What bounds it: the latency of that load - the parent tensor (hundreds of
// MB to GB) is far larger than L2, and step s + 1 needs the byte step s
// chose.  A read of ~8 kb takes ~10^4 such steps; all reads walk at once.

#include <cuda_runtime.h>

namespace {

constexpr unsigned char kDash = 45;

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__global__ void walk_parents_kernel(
    const unsigned char* __restrict__ par, int S4, int B, int W,
    const int* __restrict__ goal_i, const int* __restrict__ goal_j,
    const int* __restrict__ score, const unsigned char* __restrict__ q,
    int qn, const unsigned char* __restrict__ t, int tm, int mode,
    int match, int mismatch, int gap, unsigned char* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const unsigned char* qr = q + static_cast<size_t>(b) * qn;
  const unsigned char* tr = t + static_cast<size_t>(b) * tm;
  int i = goal_i[b], j = goal_j[b], cost = score[b];
  const int steps = 4 * (S4 + 1);
  unsigned acc = 0;
  for (int s = 0; s < steps; ++s) {
    const bool active = mode == 1 ? cost > 0 : (i > 0 || j > 0);
    if (!active) {
      if (s & 3) {
        acc |= 0xFFu << (2 * (s & 3));
        out[static_cast<size_t>(s >> 2) * B + b] =
            static_cast<unsigned char>(acc);
      }
      return;
    }
    const int d = i + j;
    const int row = clip(d - 2, 0, 4 * S4 - 1) >> 2;
    const int lane = clip((j - i + W - (d & 1)) >> 1, 0, W - 1);
    const int p_in =
        (par[(static_cast<size_t>(row) * B + b) * W + lane] >>
         (2 * ((d - 2) & 3))) & 3;
    int p;
    if (mode == 1) {
      p = p_in;
      const int qc = qr[clip(i - 1, 0, qn - 1)];
      const int tc = tr[clip(j - 1, 0, tm - 1)];
      const int edge = p == 0   ? (qc == tc ? match : mismatch)
                       : p == 1 ? (tc == kDash ? 0 : gap)
                                : (qc == kDash ? 0 : gap);
      cost -= edge;
    } else {
      p = i == 0 ? 1 : (j == 0 ? 2 : p_in);
    }
    acc |= static_cast<unsigned>(p) << (2 * (s & 3));
    if ((s & 3) == 3) {
      out[static_cast<size_t>(s >> 2) * B + b] =
          static_cast<unsigned char>(acc);
      acc = 0;
    }
    i -= (p == 0 || p == 2);
    j -= (p == 0 || p == 1);
  }
}

}  // namespace

// par: (S4, B, W) uint8 (K4's layout); goal_i/goal_j/score: (B,) int32;
// q: (B, qn) and t: (B, tm) uint8 (read by local mode only); out:
// (S4 + 1, B) uint8, filled with 0xFF by the caller.
extern "C" int bioinfo1_walk_parents(const void* par, int S4, int B, int W,
                                     const void* goal_i, const void* goal_j,
                                     const void* score, const void* q, int qn,
                                     const void* t, int tm, int mode,
                                     int match, int mismatch, int gap,
                                     void* out, void* stream) {
  // Small blocks spread the latency-bound walkers over many SMs.
  const int threads = 32;
  walk_parents_kernel<<<(B + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(par), S4, B, W,
      static_cast<const int*>(goal_i), static_cast<const int*>(goal_j),
      static_cast<const int*>(score), static_cast<const unsigned char*>(q),
      qn, static_cast<const unsigned char*>(t), tm, mode, match, mismatch,
      gap, static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
