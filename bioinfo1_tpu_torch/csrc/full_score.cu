// K3 - full (unbanded) anti-diagonal alignment score, one CTA per read.
//
// Replaces the Pallas kernel bioinfo1_tpu/ops/pallas_align.py `_kernel`
// (reached through `align_scores`); same contract as
// bioinfo1_tpu/ops/align.py `align_batch` with want_parents=False.
//
// Threads stride the query rows i of anti-diagonal d = i + j.  A cell
// reads (i-1, j-1) from diagonal d-2 and (i-1, j), (i, j-1) from d-1:
//     H = max(diag + sub, up + del(q[i-1]), left + ins(t[j-1]))
// with the reference's literal-'-' free gap (del/ins cost 0 for a '-'
// byte), then the Pallas border writes (row 0 and column 0 = d*init) and
// the local clamp.  Only rows 0..q_len of each read are computed: every
// goal rule reads cells with i <= q_len and j <= t_len, and those depend
// only on cells with smaller i and j, so the rows the TPU sweeps beyond
// q_len (and the cells with j < 0) never reach a result.
//
// What bounds it on the card: one __syncthreads per anti-diagonal, and in
// local mode a block-wide argmax per diagonal; a cell costs ~15 integer
// ops and two byte loads.  The three live diagonals (12*(n+1) bytes) sit
// in shared memory while they fit; beyond that a per-read global scratch
// serves (the TPU's VMEM guard sent such widths to the lax scan instead).

#include "common.cuh"

namespace {

constexpr int kNeg = -2147483647 - 1 + 2;  // pallas_align._NEG
constexpr unsigned char kDash = 45;

__global__ void full_score_kernel(
    const unsigned char* __restrict__ q, int n,
    const unsigned char* __restrict__ t, int m,
    const int* __restrict__ q_len, const int* __restrict__ t_len, int B,
    int mode, int match, int mismatch, int gap, int* __restrict__ scratch,
    int* __restrict__ out, int use_smem) {
  extern __shared__ int smem[];
  __shared__ long long red[32];
  const int b = blockIdx.x;
  const unsigned char* qr = q + static_cast<size_t>(b) * n;
  const unsigned char* tr = t + static_cast<size_t>(b) * m;
  // The pipeline always has q_len <= n and t_len <= m; clamping keeps a
  // malformed call inside its buffers.
  const int ql = min(max(q_len[b], 0), n);
  const int tl = min(max(t_len[b], 0), m);
  const int init = mode == 0 ? gap : 0;
  const int n1 = n + 1;

  int* buf = use_smem ? smem : scratch + static_cast<size_t>(b) * 3 * n1;
  int* h2 = buf;           // diagonal d-2 (d = 0: H(0,0) = 0)
  int* h1 = buf + n1;      // diagonal d-1 (d = 1: (0,1) and (1,0) = init)
  int* h0 = buf + 2 * n1;  // diagonal d
  for (int i = threadIdx.x; i <= ql; i += blockDim.x) {
    h2[i] = 0;
    h1[i] = i <= 1 ? init : 0;
  }
  __syncthreads();

  int score = 0, bc = kNeg, bi = 0, bj = 0, cc = 0, ci = 0, rc = 0, rj = 0;
  const int d_stop = ql + tl;
  for (int d = 2; d <= d_stop; ++d) {
    long long key = LLONG_MIN;  // local: (cost << 32) | ~i
    const int i_hi = min(ql, d);
    for (int i = threadIdx.x; i <= i_hi; i += blockDim.x) {
      const int j = d - i;
      int h;
      if (i == 0 || j == 0) {
        h = d * init;  // cell (0, d) or (d, 0)
      } else {
        const int qb = qr[i - 1];
        const int tb = j <= m ? tr[j - 1] : 0;
        const int diag_v = h2[i - 1] + (qb == tb ? match : mismatch);
        const int up_v = h1[i - 1] + (qb == kDash ? 0 : gap);
        const int left_v = h1[i] + (tb == kDash ? 0 : gap);
        h = max(max(diag_v, left_v), up_v);
      }
      if (mode == 1) h = max(h, 0);
      h0[i] = h;
      if (mode == 1 && i >= 1 && j >= 1 && j <= tl) {
        const long long k = (static_cast<long long>(h) << 32) |
                            (0xffffffffu - static_cast<unsigned>(i));
        key = k > key ? k : key;
      }
    }
    if (mode == 1) {
      // Largest cost, then smallest i (and so smallest j on this diagonal).
      key = bioinfo1::block_max(key, red, LLONG_MIN);
      if (threadIdx.x == 0 && key != LLONG_MIN) {
        const int c = static_cast<int>(key >> 32);
        const int ci_ = static_cast<int>(0xffffffffu -
                                         static_cast<unsigned>(key));
        const int cj_ = d - ci_;
        if (c > bc || (c == bc && (ci_ < bi || (ci_ == bi && cj_ < bj)))) {
          bc = c;
          bi = ci_;
          bj = cj_;
        }
      }
    } else {
      __syncthreads();
      if (threadIdx.x == 0) {
        if (mode == 0) {
          if (d == ql + tl) score = h0[ql];
        } else {
          const int i_col = d - tl;
          if (i_col >= 0 && i_col <= ql && h0[i_col] > cc) {
            cc = h0[i_col];
            ci = i_col;
          }
          const int j_row = d - ql;
          if (j_row >= 0 && j_row <= tl && h0[ql] > rc) {
            rc = h0[ql];
            rj = j_row;
          }
        }
      }
    }
    int* tmp = h2;
    h2 = h1;
    h1 = h0;
    h0 = tmp;
  }

  if (threadIdx.x == 0) {
    int s, gi, gj;
    if (mode == 0) {
      s = score;
      gi = ql;
      gj = tl;
    } else if (mode == 1) {
      const bool hit = bc > kNeg;
      s = hit ? bc : 0;
      gi = hit ? bi : 0;
      gj = hit ? bj : 0;
    } else {
      const bool row_wins = rc > cc;
      s = row_wins ? rc : cc;
      gi = row_wins ? ql : ci;
      gj = row_wins ? rj : tl;
    }
    out[0 * B + b] = s;
    out[1 * B + b] = gi;
    out[2 * B + b] = gj;
  }
}

}  // namespace

// q: (B, n) uint8; t: (B, m) uint8; q_len/t_len: (B,) int32; scratch:
// (B, 3, n+1) int32 when use_smem == 0; out: (3, B) int32 rows score,
// goal_i, goal_j.
extern "C" int bioinfo1_full_score(const void* q, int n, const void* t,
                                   int m, const void* q_len,
                                   const void* t_len, int B, int mode,
                                   int match, int mismatch, int gap,
                                   void* scratch, void* out, int use_smem,
                                   void* stream) {
  const size_t smem = use_smem ? static_cast<size_t>(12) * (n + 1) : 0;
  cudaError_t e = bioinfo1::allow_smem(full_score_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  full_score_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(q), n,
      static_cast<const unsigned char*>(t), m,
      static_cast<const int*>(q_len), static_cast<const int*>(t_len), B,
      mode, match, mismatch, gap, static_cast<int*>(scratch),
      static_cast<int*>(out), use_smem);
  return static_cast<int>(cudaGetLastError());
}
