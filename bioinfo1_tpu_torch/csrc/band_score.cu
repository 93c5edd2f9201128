// K2 - banded anti-diagonal alignment score, one CTA per read.
//
// Replaces the Pallas kernel bioinfo1_tpu/ops/pallas_band.py `_kernel`
// with want_parents=False (reached through `align_scores_banded`).
//
// Coordinates as in the Pallas kernel: anti-diagonal d = i + j; lane l of
// the W-lane band holds offset o = 2l - W + (d & 1), so i = i0 - l with
// i0 = (d + W) / 2 and j = d - i.  The recurrence
//     H_d[l] = max(H_{d-2}[l] + sub, left + gap, up + gap)
// takes up (i-1, j) from lane l on even d and l+1 on odd d, and left
// (i, j-1) from lane l-1 on even d and l on odd d; a neighbour outside
// the band is _NEG.  Then, exactly in the Pallas order: the local clamp,
// row 0 (j*init), column 0 (i*init), and _NEG for i < 0 or j < 0.
//
// The TPU kernel streams query/target bytes through 128-byte staging
// chunks with lane rolls and splits the sweep into border/interior/goal
// phases with pair loops; those are Mosaic constraints and VPU savings.
// Here each lane reads its bytes by index and evaluates every per-cell
// condition directly, so one loop body serves every diagonal.
//
// What bounds it on the card: one __syncthreads per anti-diagonal (the
// true dependency between diagonals), plus in local mode a block-wide
// argmax per diagonal.  A cell costs ~15 integer ops and two byte loads
// that hit L1.  The two previous diagonals and the one being written live
// in shared memory (12*W bytes) while that fits; wider bands (the realign
// pass can reach whole-matrix widths) use a per-read global scratch.

#include "common.cuh"

namespace {

constexpr int kNeg = -(1 << 30);  // pallas_band._NEG
constexpr unsigned char kDash = 45;

__global__ void band_score_kernel(
    const unsigned char* __restrict__ q, int n, int n_pad,
    const unsigned char* __restrict__ t, int m, int m_eff,
    const int* __restrict__ q_len, const int* __restrict__ t_len, int B,
    int W, int n_steps, int mode, int dash_free, int match, int mismatch,
    int gap, int* __restrict__ scratch, int* __restrict__ out,
    int use_smem) {
  extern __shared__ int smem[];
  __shared__ long long red[32];
  const int b = blockIdx.x;
  const unsigned char* qr = q + static_cast<size_t>(b) * n;
  const unsigned char* tr = t + static_cast<size_t>(b) * m;
  const int ql = q_len[b];
  const int tl = min(t_len[b], m_eff);  // the Pallas target-length clamp
  const int init = mode == 0 ? gap : 0;
  const int half = W / 2;
  const int t_have = min(m, m_eff);

  int* buf = use_smem ? smem : scratch + static_cast<size_t>(b) * 3 * W;
  int* h2 = buf;          // diagonal d-2
  int* h1 = buf + W;      // diagonal d-1
  int* h0 = buf + 2 * W;  // diagonal d
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    h2[l] = l == half ? 0 : kNeg;
    h1[l] = (l == half || l == half - 1) ? init : kNeg;
  }
  __syncthreads();

  // Goal trackers (thread 0): global score; local best (cost, i, j);
  // semiGlobal last-column (cost, i) and last-row (cost, j).
  int score = 0, bc = kNeg, bi = 0, bj = 0, cc = 0, ci = 0, rc = 0, rj = 0;
  const int d_stop = min(ql + tl, n_steps + 1);
  for (int d = 2; d <= d_stop; ++d) {
    const int p = d & 1;
    const int i0 = (d + W) >> 1;
    long long key = LLONG_MIN;  // local: (cost << 32) | lane
    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int i = i0 - l;
      const int j = d - i;
      int up, left;
      if (p == 0) {
        up = h1[l];
        left = l == 0 ? kNeg : h1[l - 1];
      } else {
        up = l == W - 1 ? kNeg : h1[l + 1];
        left = h1[l];
      }
      int qb = 0, tb = 0;
      if (i >= 1) {
        const int qi = min(i - 1, n_pad - 1);
        qb = qi < n ? qr[qi] : 0;
      }
      if (j >= 1) {
        const int tj = min(j - 1, m_eff - 1);
        tb = tj < t_have ? tr[tj] : 0;
      }
      const int diag_v = h2[l] + (qb == tb ? match : mismatch);
      int h;
      if (dash_free) {
        h = max(diag_v, max(left, up) + gap);
      } else {
        const int left_v = left + (tb == kDash ? 0 : gap);
        const int up_v = up + (qb == kDash ? 0 : gap);
        h = max(max(diag_v, left_v), up_v);
      }
      if (mode == 1) h = max(h, 0);
      if (i == 0) h = j * init;
      if (j == 0) h = i * init;
      if (i < 0 || j < 0) h = kNeg;
      h0[l] = h;
      if (mode == 1 && i >= 1 && i <= ql && j >= 1 && j <= tl) {
        const long long k =
            (static_cast<long long>(h) << 32) | static_cast<unsigned>(l);
        key = k > key ? k : key;
      }
    }
    if (mode == 1) {
      // Largest cost, then largest lane (= smallest i on this diagonal).
      key = bioinfo1::block_max(key, red, LLONG_MIN);
      if (threadIdx.x == 0 && key != LLONG_MIN) {
        const int c = static_cast<int>(key >> 32);
        const int i_cand = i0 - static_cast<int>(key & 0xffffffffLL);
        if (c > bc || (c == bc && i_cand < bi)) {
          bc = c;
          bi = i_cand;
          bj = d - i_cand;
        }
      }
    } else {
      __syncthreads();
      if (threadIdx.x == 0) {
        if (mode == 0) {
          if (d == ql + tl) {
            const int x = tl - ql + W - p;
            score = (x >= 0 && x / 2 < W) ? h0[x / 2] : 0;
          }
        } else {
          const int i_col = d - tl;
          const int l_col = i0 - i_col;
          if (i_col >= 0 && i_col <= ql && l_col >= 0 && l_col < W &&
              h0[l_col] > cc) {
            cc = h0[l_col];
            ci = i_col;
          }
          const int j_row = d - ql;
          const int l_row = i0 - ql;
          if (j_row >= 0 && j_row <= tl && l_row >= 0 && l_row < W &&
              h0[l_row] > rc) {
            rc = h0[l_row];
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
// (B, 3, W) int32 when use_smem == 0; out: (3, B) int32 rows score,
// goal_i, goal_j.  W is a multiple of 128.
extern "C" int bioinfo1_band_score(const void* q, int n, int n_pad,
                                   const void* t, int m, int m_eff,
                                   const void* q_len, const void* t_len,
                                   int B, int W, int n_steps, int mode,
                                   int dash_free, int match, int mismatch,
                                   int gap, void* scratch, void* out,
                                   int use_smem, void* stream) {
  const size_t smem = use_smem ? static_cast<size_t>(12) * W : 0;
  cudaError_t e = bioinfo1::allow_smem(band_score_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = W < 512 ? W : 512;
  band_score_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(q), n, n_pad,
      static_cast<const unsigned char*>(t), m, m_eff,
      static_cast<const int*>(q_len), static_cast<const int*>(t_len), B, W,
      n_steps, mode, dash_free, match, mismatch, gap,
      static_cast<int*>(scratch), static_cast<int*>(out), use_smem);
  return static_cast<int>(cudaGetLastError());
}
