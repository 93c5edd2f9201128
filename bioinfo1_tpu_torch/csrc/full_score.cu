// K3 - full (unbanded) anti-diagonal alignment score: one warp per read,
// the query rows in registers, the matrix swept in strips of rows.
//
// Replaces the Pallas kernel bioinfo1_tpu/ops/pallas_align.py `_kernel`
// (reached through `align_scores`); same contract as
// bioinfo1_tpu/ops/align.py `align_batch` with want_parents=False.
//
// Lanes as in the Pallas kernel: lane i of anti-diagonal d holds cell
// (i, d - i).  A cell takes left (i, j-1) from its own lane on d - 1, up
// (i-1, j) from lane i - 1 on d - 1 and diag (i-1, j-1) from lane i - 1 on
// d - 2:
//     H = max(diag + sub, up + del(q[i-1]), left + ins(t[j-1]))
// with the reference's literal-'-' free gap (del / ins cost 0 for a '-'
// byte), column 0 = i * init and the local clamp.  Row 0 (j * init) is no
// lane: it is computed where it is read.  Only rows 1..q_len and columns
// 0..t_len are needed: every goal rule reads cells with i <= q_len and
// j <= t_len, and those depend only on cells with smaller i and j, so what
// a lane computes past them (rows past q_len, columns past t_len, columns
// below 0) never reaches a result.
//
// Strips.  A read's warp sweeps its rows in strips of S = 32 * LPT rows,
// top to bottom; thread t owns rows r0 + 1 + t * LPT .. + LPT of the strip
// with top row r0 + 1 and keeps their two newest diagonals in registers
// (a new diagonal overwrites the one two back, the loop body is a pair of
// diagonals so the arrays' roles are static).  Inside a thread every
// neighbour is a register; the thread's first row takes up from the
// previous thread's last row by one __shfl_up_sync a diagonal and diag
// from the value it took one diagonal earlier.  Thread 0 takes both from
// row r0: row 0 computed on strip 0, else a per-read row buffer of m + 1
// ints that the strip above wrote.  The diagonals of a strip run in groups
// of 32, group c holding the strip's first row at columns 32c + 1 ..
// 32c + 32: lane l loads column 32c + 1 + l of row r0 and of the target
// one group ahead, and each diagonal broadcasts its column's values by
// shuffle.  The strip's bottom row (thread 31's last register) is gathered
// one value a diagonal into the lane that loads its column and stored 32
// at a time after each group; the writes trail the reads by S - 1
// columns and a column is always read and written by the same lane, so
// one buffer serves in place.  A group's body has no branch, so the
// compiler interleaves a pair of diagonals and hides the shuffles'
// latency behind the cells.
// Bytes: a row's query byte is fixed, so each thread loads its LPT bytes
// once a strip, packed four to a word, with each row's up cost.  Target
// bytes are a shift register: on d + 1 lane i holds lane i - 1's byte of
// d, so a diagonal moves one byte across each thread edge by shuffle and
// thread 0 takes the new one from the group's chunk (0 past t_len).
// Border and interior: while some row of the strip is at a column <= 0 the
// body writes column 0 (i * init) and, in local mode, tests each cell's
// column against 1..t_len; a group in which every row is past column 0
// (and, in local mode, none past t_len) runs a lean body.
// Goals need no per-diagonal reduction: every rule is a maximum under a
// total order, kept in registers and reduced over the warp once.  Global:
// the owner of row q_len reads its register after diagonal q_len + t_len.
// Local: per row the first strict maximum over columns 1..t_len (along a
// row j grows with d), folded into the thread's best at the end of a strip
// by cost, then smaller i, then smaller j.  SemiGlobal: a thread keeps the
// first strict maximum (from 0) of its rows' column-t_len cells in order
// of i, the owner of row q_len that of the row's cells in order of j; the
// row wins only when strictly greater.
//
// What bounds it on the card: issue.  The interior pair loop holds ~9
// integer instructions a cell at 16 rows a thread (global; SASS for
// sm_90a), and a read is one warp: with fewer reads than the card's 528
// schedulers each warp issues alone, ~0.5 instructions a cycle, its
// shuffles' and the cells' dependent latencies only partly hidden.  No
// block barrier, no shared memory, no per-diagonal reduction; per
// diagonal a warp adds five shuffles (row r0, target byte, up edge, byte
// carry, bottom row) to its LPT cells a thread.

#include "common.cuh"

namespace {

constexpr int kNeg = -2147483647 - 1 + 2;  // pallas_align._NEG
constexpr unsigned kDash = 45u;  // '-'
constexpr unsigned kDashWord = 0x2d2d2d2du;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerCta = 4;  // ops/align.FULL_MAX_WARPS_PER_CTA

struct FullArgs {
  const unsigned char* q;
  int n;
  const unsigned char* t;
  int m;
  const int* q_len;
  const int* t_len;
  int B, match, mismatch, gap;
  int* row;  // (B, m + 1) int32: the strip above's bottom row
  int* out;  // (3, B) int32: score, goal_i, goal_j
};

using bioinfo1::goal_better;
using bioinfo1::pick;

// The warp's best (c, i, j), valid in lane 0.
__device__ __forceinline__ void warp_best(int& c, int& i, int& j) {
  for (int o = 16; o > 0; o >>= 1) {
    const int c2 = __shfl_down_sync(kFull, c, o);
    const int i2 = __shfl_down_sync(kFull, i, o);
    const int j2 = __shfl_down_sync(kFull, j, o);
    if (goal_better(c2, i2, j2, c, i, j)) {
      c = c2;
      i = i2;
      j = j2;
    }
  }
}

// One thread's LPT rows of the current strip, and its goal trackers of
// kMode (0 global, 1 local, 2 semiGlobal).
template <int kMode, int LPT>
struct Rows {
  static constexpr int NW = LPT / 4;
  static constexpr int S = 32 * LPT;  // rows a strip
  int a[LPT], b[LPT];  // newest two diagonals
  int up_cost[LPT];    // gap, or 0 for a '-' query byte
  unsigned qw[NW], tw[NW];
  int best[LPT], best_d[LPT];  // local: first strict maximum per row
  int e_dg;                    // diag of the first row: last diagonal's up
  int top_c;                   // row r0 at the group's columns (lane l:
  unsigned t_c;                // 32c + 1 + l) and their target bytes
  int out_c;                   // the bottom row, gathered for the store
  int lane, r0, ibase, ql, tl, init;
  bool last;
  int match, mismatch, gap;
  const unsigned char* tr;
  int* row;
  int cc, ci, rc, rj;  // semiGlobal: column t_len, row q_len

  // Group c of a strip: its 32 diagonals have the strip's first row at
  // columns base = 32c + 1 .. 32c + 32.  Lane l loads column base + l of
  // row r0 and of the target.
  __device__ __forceinline__ void load_chunk(int base, int& top_v,
                                             unsigned& t_v) const {
    const int c = base + lane;
    top_v = r0 == 0 ? c * init : (c <= tl ? row[c] : 0);
    t_v = c <= tl ? static_cast<unsigned>(tr[c - 1]) : 0u;
  }

  // Diagonal d, the g-th of its group: read the array of d - 1, overwrite
  // the one of d - 2.  No branch: the compiler may interleave diagonals.
  template <bool kBorder, bool kOdd>
  __device__ __forceinline__ void diag(int d, int g) {
    int(&h1)[LPT] = kOdd ? b : a;
    int(&h2)[LPT] = kOdd ? a : b;
    const int top = __shfl_sync(kFull, top_c, g);
    const unsigned t_in = __shfl_sync(kFull, t_c, g);
    unsigned carry = __shfl_up_sync(kFull, tw[NW - 1] >> 24, 1);
    int e_up = __shfl_up_sync(kFull, h1[LPT - 1], 1);
    if (lane == 0) {
      carry = t_in;
      e_up = top;
    }
#pragma unroll
    for (int x = NW - 1; x > 0; --x) tw[x] = (tw[x] << 8) | (tw[x - 1] >> 24);
    tw[0] = (tw[0] << 8) | carry;

    // Last row first, so that h2[k - 1] still holds diagonal d - 2.
#pragma unroll
    for (int x = NW - 1; x >= 0; --x) {
      const unsigned eq = qw[x] ^ tw[x];
      const unsigned td = tw[x] ^ kDashWord;
#pragma unroll
      for (int y = 3; y >= 0; --y) {
        const int k = 4 * x + y;
        const unsigned bm = 0xffu << (8 * y);
        const int up = k == 0 ? e_up : h1[k == 0 ? 0 : k - 1];
        const int dg = k == 0 ? e_dg : h2[k == 0 ? 0 : k - 1];
        const int diag_v = dg + ((eq & bm) == 0 ? match : mismatch);
        const int up_v = up + up_cost[k];
        const int left_v = h1[k] + ((td & bm) == 0 ? 0 : gap);
        int h = max(max(diag_v, left_v), up_v);
        if constexpr (kMode == 1) h = max(h, 0);  // the local clamp
        if constexpr (kBorder) {
          const int i = ibase + k;
          if (d - i <= 0) h = i * init;  // column 0 (below it: unused)
        }
        h2[k] = h;
        if constexpr (kMode == 1) {
          bool valid = true;
          if constexpr (kBorder) {
            valid = static_cast<unsigned>(d - (ibase + k) - 1) <
                    static_cast<unsigned>(tl);
          }
          const bool take = valid && h > best[k];
          best[k] = take ? h : best[k];
          best_d[k] = take ? d : best_d[k];
        }
      }
    }
    e_dg = e_up;

    if constexpr (kMode == 2) {
      const int kc = d - tl - ibase;  // the row at column t_len
      const int vc = pick(h2, kc);
      const bool take_c =
          static_cast<unsigned>(kc) < LPT && d - tl <= ql && vc > cc;
      cc = take_c ? vc : cc;
      ci = take_c ? d - tl : ci;
      const int kq = ql - ibase;  // row q_len, on the last strip
      const int vr = pick(h2, kq);
      const bool take_r =
          last && static_cast<unsigned>(kq) < LPT &&
          static_cast<unsigned>(d - ql - 1) < static_cast<unsigned>(tl) &&
          vr > rc;
      rc = take_r ? vr : rc;
      rj = take_r ? d - ql : rj;
    }

    // The strip's bottom row at column jb = d - r0 - S: lane (jb - 1) & 31
    // keeps it (the lane that loads that column; the group stores them).
    const int v = __shfl_sync(kFull, h2[LPT - 1], 31);
    out_c = lane == ((d - r0 - S - 1) & 31) ? v : out_c;
  }

  // The group of diagonals d0 .. d0 + 2 * npairs - 1 (d0 = r0 + 2 + 32c,
  // npairs <= 16), its chunk of row r0 and target bytes already loaded;
  // then the bottom row's columns of the group go to the row buffer.
  template <bool kBorder>
  __device__ __forceinline__ void group(int d0, int npairs) {
#pragma unroll 1
    for (int p = 0; p < npairs; ++p) {
      diag<kBorder, false>(d0 + 2 * p, 2 * p);
      diag<kBorder, true>(d0 + 2 * p + 1, 2 * p + 1);
    }
    if (!last) {
      // Lane l kept column jb0 + ((l - 1) & 31): (jb0 - 1) & 31 is 1.
      const int jb0 = d0 - r0 - S;
      const int c = jb0 + ((lane - 1) & 31);
      if (c >= 1 && c <= tl && c < jb0 + 2 * npairs) row[c] = out_c;
    }
  }
};

template <int kMode, int LPT>
__global__ void __launch_bounds__(32 * kMaxWarpsPerCta)
    full_score_kernel(FullArgs a) {
  constexpr int NW = LPT / 4;
  constexpr int S = 32 * LPT;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= a.B) return;  // a whole warp: no block sync anywhere
  // The pipeline always has q_len <= n and t_len <= m; clamping keeps a
  // malformed call inside its buffers.
  const int ql = min(max(a.q_len[b], 0), a.n);
  const int tl = min(max(a.t_len[b], 0), a.m);
  const unsigned char* qr = a.q + static_cast<size_t>(b) * a.n;

  Rows<kMode, LPT> s;
  s.lane = lane;
  s.ql = ql;
  s.tl = tl;
  s.init = kMode == 0 ? a.gap : 0;
  s.match = a.match;
  s.mismatch = a.mismatch;
  s.gap = a.gap;
  s.tr = a.t + static_cast<size_t>(b) * a.m;
  s.row = a.row + static_cast<size_t>(b) * (a.m + 1);
  s.cc = s.ci = s.rc = s.rj = 0;
  s.out_c = 0;
  int c = kNeg, gi = 0, gj = 0;  // local: the thread's best
  int score = 0;                 // global: the owner of row q_len's
  // With t_len == 0 no cell with j >= 1 exists and no goal reads a strip.
  const int strips = tl > 0 ? (ql + S - 1) / S : 0;
  for (int st = 0; st < strips; ++st) {
    const int r0 = st * S;
    s.r0 = r0;
    s.ibase = r0 + 1 + lane * LPT;
    s.last = st == strips - 1;
    const int d_lo = r0 + 2;
    const int d_hi = min(r0 + S, ql) + tl;
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      s.qw[x] = 0u;
      s.tw[x] = 0u;  // every row is at a column <= 0 on d_lo - 1
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = s.ibase + 4 * x + y;
        const unsigned qb = i <= ql ? static_cast<unsigned>(qr[i - 1]) : 0u;
        s.qw[x] |= qb << (8 * y);
        s.up_cost[4 * x + y] = qb == kDash ? 0 : a.gap;
      }
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      s.a[k] = s.b[k] = (s.ibase + k) * s.init;  // column <= 0 on d_lo - 1
      s.best[k] = kNeg;
      s.best_d[k] = 0;
    }
    s.e_dg = r0 * s.init;  // H(r0, 0)

    // Groups of 32 diagonals (16 pairs; the last group fewer), the next
    // group's chunk loaded while this one runs.  A group runs the lean body
    // once every row is past column 0 (j0 >= S) and, in local mode, no row
    // is past t_len.  A pair may run one diagonal past d_hi: its cells lie
    // past t_len or q_len, and no goal reads them.
    int top_n;
    unsigned t_n;
    s.load_chunk(1, s.top_c, s.t_c);
    int d = d_lo;
#pragma unroll 1
    for (int base = 1; d <= d_hi; base += 32) {
      s.load_chunk(base + 32, top_n, t_n);
      const int npairs = min(16, (d_hi - d + 2) >> 1);
      const bool lean =
          base >= S && (kMode != 1 || base + 2 * npairs - 1 <= tl);
      if (lean) {
        s.template group<false>(d, npairs);
      } else {
        s.template group<true>(d, npairs);
      }
      d += 2 * npairs;
      s.top_c = top_n;
      s.t_c = t_n;
    }

    if constexpr (kMode == 0) {
      if (s.last) {
        const int kg = ql - s.ibase;
        if (kg >= 0 && kg < LPT)
          score = ((d_hi - d_lo) & 1) ? pick(s.a, kg) : pick(s.b, kg);
      }
    } else if constexpr (kMode == 1) {
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int i = s.ibase + k;
        if (i <= ql && goal_better(s.best[k], i, s.best_d[k] - i, c, gi, gj)) {
          c = s.best[k];
          gi = i;
          gj = s.best_d[k] - i;
        }
      }
    }
    __syncwarp();  // the row buffer's writes before the next strip's reads
  }

  int* out = a.out;
  const int B = a.B;
  if constexpr (kMode == 0) {
    // The owner of row q_len holds H(q_len, t_len); the sweep starts at
    // d = 2, so a goal on diagonal 0 or 1 scores 0.
    const int owner = ql >= 1 ? ((ql - 1) % S) / LPT : 0;
    const int v = __shfl_sync(kFull, score, owner);
    if (lane == 0) {
      int sc;
      if (ql + tl < 2) {
        sc = 0;
      } else if (ql == 0) {
        sc = tl * a.gap;  // row 0
      } else if (tl == 0) {
        sc = ql * a.gap;  // column 0
      } else {
        sc = v;
      }
      out[b] = sc;
      out[B + b] = ql;
      out[2 * B + b] = tl;
    }
  } else if constexpr (kMode == 1) {
    warp_best(c, gi, gj);
    if (lane == 0) {
      const bool hit = c > kNeg;
      out[b] = hit ? c : 0;
      out[B + b] = hit ? gi : 0;
      out[2 * B + b] = hit ? gj : 0;
    }
  } else {
    int cc = s.cc, ci = s.ci, z0 = 0;
    warp_best(cc, ci, z0);
    int rc = s.rc, rj = s.rj, z1 = 0;
    warp_best(rc, rj, z1);
    if (lane == 0) {
      const bool row_wins = rc > cc;
      out[b] = row_wins ? rc : cc;
      out[B + b] = row_wins ? ql : ci;
      out[2 * B + b] = row_wins ? rj : tl;
    }
  }
}

template <int LPT>
int launch_full(const FullArgs& a, int mode, int warps_per_cta,
                cudaStream_t stream) {
  const int grid = (a.B + warps_per_cta - 1) / warps_per_cta;
  const int block = 32 * warps_per_cta;
  if (mode == 0) {
    full_score_kernel<0, LPT><<<grid, block, 0, stream>>>(a);
  } else if (mode == 1) {
    full_score_kernel<1, LPT><<<grid, block, 0, stream>>>(a);
  } else {
    full_score_kernel<2, LPT><<<grid, block, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, n) uint8; t: (B, m) uint8; q_len/t_len: (B,) int32; row: (B, m+1)
// int32 when a read may span more than one strip (n > 32 * lpt), else
// unused; out: (3, B) int32 rows score, goal_i, goal_j.  lpt (rows a
// thread keeps: 8, 16 or 32) and warps_per_cta (1-4, one read a warp) are
// ops/align.full_plan's; anything else is refused.
extern "C" int bioinfo1_full_score(const void* q, int n, const void* t,
                                   int m, const void* q_len,
                                   const void* t_len, int B, int mode,
                                   int match, int mismatch, int gap,
                                   void* row, void* out, int lpt,
                                   int warps_per_cta, void* stream) {
  if (n < 1 || m < 1 || B < 1 || mode < 0 || mode > 2 || warps_per_cta < 1 ||
      warps_per_cta > kMaxWarpsPerCta || (row == nullptr && n > 32 * lpt))
    return static_cast<int>(cudaErrorInvalidValue);
  FullArgs a;
  a.q = static_cast<const unsigned char*>(q);
  a.n = n;
  a.t = static_cast<const unsigned char*>(t);
  a.m = m;
  a.q_len = static_cast<const int*>(q_len);
  a.t_len = static_cast<const int*>(t_len);
  a.B = B;
  a.match = match;
  a.mismatch = mismatch;
  a.gap = gap;
  a.row = static_cast<int*>(row);
  a.out = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lpt == 8) return launch_full<8>(a, mode, warps_per_cta, st);
  if (lpt == 16) return launch_full<16>(a, mode, warps_per_cta, st);
  if (lpt == 32) return launch_full<32>(a, mode, warps_per_cta, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
