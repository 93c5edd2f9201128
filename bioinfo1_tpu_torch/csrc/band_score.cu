// K2 - banded anti-diagonal alignment score, and
// K4 - the same sweep also emitting the traceback parents.
//
// Replaces the Pallas kernel bioinfo1_tpu/ops/pallas_band.py `_kernel`
// (reached through `align_scores_banded`): K2 is its want_parents=False
// instantiation, K4 its want_parents=True one.  One body takes the flag
// as a compile-time parameter, so K2's code is the score-only loop.
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
// A lane never moves, so its neighbours are fixed.  Two kernels share
// the file; ops/band.band_plan picks one from W alone:
//
// Register paths, W <= kRegMaxW (band_reg_kernel).  Thread t of a read's
// group owns LPT consecutive lanes [t*LPT, (t+1)*LPT) and keeps the newest
// even and the newest odd diagonal of those lanes in two register arrays;
// a new diagonal overwrites the one two back in place.  The loop body is
// one even and one odd diagonal, so the parity, the array written and the
// direction of the exchange are static.  Inside a thread every neighbour
// is a register; only the thread's first lane (even d, left) or last lane
// (odd d, up) takes one value from the next thread: __shfl_up_sync /
// __shfl_down_sync within a warp, _NEG at the band's two ends.
//   - "warp" path (W == 32 * LPT): one warp per read, several reads per
//     CTA, no block sync anywhere; a warp whose read index is past B leaves
//     at once.
//   - "warps" path (W / LPT threads, one read per CTA): the first and last
//     lane values of each warp cross warps through small shared arrays,
//     one written on even and one on odd diagonals, so a single
//     __syncthreads per diagonal orders them.  W / LPT need not be a
//     multiple of 32: the last warp runs short and shuffles under its own
//     mask.
// Query and target bytes are shift registers: from an even to an odd
// diagonal every lane's j grows by one and its target byte becomes the old
// byte of lane l + 1; from odd to even its i grows by one and its query
// byte becomes the old byte of lane l - 1.  A thread packs its LPT bytes
// four to a word, shifts a byte every second diagonal (one shuffle at the
// thread edge), and only the band's end lanes read memory, issued at the
// top of the pair that uses them.  The byte of row i (column j) is a
// function of i (j) alone - 0 for i < 1, 0 past n, clamped at n_pad - 1 -
// so the shift keeps every padding rule.
// Border and interior: for d < W + 2 the body applies row 0, column 0 and
// the i < 0 / j < 0 mask; from d = W + 2 on no lane needs them and a lean
// body runs.
// Goals need no per-diagonal reduction: every rule is a maximum under a
// total order, so each thread keeps its own best in registers and the
// group reduces once after the sweep.  Global: the owner of lane
// (tl - ql + W - p) / 2 reads its register after the last diagonal.
// Local: per lane the first strict maximum over valid cells (along a lane
// i and j only grow, so first = smallest i, then smallest j); the order
// over lanes is cost, then smallest i, then smallest j.  SemiGlobal: the
// thread that owns the last column's (last row's) lane on a diagonal keeps
// the first strict maximum in order of d, starting from 0; the row wins
// only when strictly greater.
// K4's parents (pallas_band.py:179-188, 201-255): each cell's 2-bit M>I>D
// choice (first set, strictly greater), taken before the local clamp and
// the border masks; with dash_free only the '-' compares drop out (the
// shared-gap shortcut max(left, up) + gap would lose the I/D choice).
// Step idx = d - 2 sits at byte row idx >> 2, bit 2 * (idx & 3), lane l.
// A thread ORs 4 diagonals into its LPT accumulator bytes (registers) and
// stores them with one vector store at par[idx >> 2][b][t*LPT ...],
// aligned and coalesced across the warp; the read's last diagonal stores
// its partial byte, bits past it are 0.  Rows after a read's last diagonal
// are never written (the walk never reads them).
// What bounds the register paths: the instructions of a cell (issue rate;
// the interior loop's SASS for sm_90a holds about 7 integer instructions
// per cell for K2 and 15 for K4); with few reads also one warp issuing
// alone, about 445 cycles per pair of diagonals at LPT 8 on an H100; the
// "warps" path adds one block sync per diagonal.
//
// Scratch path, W > kRegMaxW (band_scratch_kernel): one CTA per read, the
// three diagonals in shared memory (12*W bytes, plus K4's W accumulator
// bytes) while that fits, else in a per-read global scratch; each lane
// reads its bytes by index and evaluates every border condition; one
// __syncthreads per anti-diagonal plus, in local mode, a block-wide
// argmax.  Bound by that sync and by ~63 (K4: 77) integer instructions per
// lane in its SASS for sm_90a.

#include "common.cuh"

namespace {

constexpr int kNeg = -(1 << 30);  // pallas_band._NEG
constexpr unsigned char kDash = 45;
constexpr unsigned kDashWord = 0x2d2d2d2du;
constexpr int kRegMaxW = 4096;      // widest band of the register paths
constexpr int kMaxReadsPerCta = 4;  // "warp" path

struct BandArgs {
  const unsigned char* q;
  int n, n_pad;
  const unsigned char* t;
  int m, m_eff;
  const int* q_len;
  const int* t_len;
  int B, W, n_steps, mode, match, mismatch, gap;
  int* out;
  unsigned char* par;
};

// One read's byte rows with the Pallas padding rules.
struct ReadBytes {
  const unsigned char* qr;
  const unsigned char* tr;
  int n, n_pad, m_eff, t_have;

  // Query byte of row i: 0 for i < 1, the index clamped to n_pad - 1, 0
  // past n.
  __device__ __forceinline__ unsigned q_at(int i) const {
    if (i < 1) return 0u;
    const int qi = min(i - 1, n_pad - 1);
    return qi < n ? qr[qi] : 0u;
  }
  // Target byte of column j: 0 for j < 1, clamped to m_eff - 1, 0 past m.
  __device__ __forceinline__ unsigned t_at(int j) const {
    if (j < 1) return 0u;
    const int tj = min(j - 1, m_eff - 1);
    return tj < t_have ? tr[tj] : 0u;
  }
};

template <int LPT>
__device__ __forceinline__ int pick(const int (&v)[LPT], int k) {
  int r = v[0];
#pragma unroll
  for (int x = 1; x < LPT; ++x) r = k == x ? v[x] : r;
  return r;
}

// Goal candidates are ordered by cost, then smallest i, then smallest j.
__device__ __forceinline__ bool goal_better(int c2, int i2, int j2, int c,
                                            int i, int j) {
  return c2 > c || (c2 == c && (i2 < i || (i2 == i && j2 < j)));
}

// The best (c, i, j) of a read's group, valid in thread 0 of the group.
// Every thread of the group calls it; `x` holds 3 ints per warp.
template <bool kMulti>
__device__ __forceinline__ void group_best(int& c, int& i, int& j,
                                           unsigned mask, int lane, int cnt,
                                           int warp, int nwarps,
                                           int (*x)[3]) {
  for (int o = 16; o > 0; o >>= 1) {
    const int c2 = __shfl_down_sync(mask, c, o);
    const int i2 = __shfl_down_sync(mask, i, o);
    const int j2 = __shfl_down_sync(mask, j, o);
    if (lane + o < cnt && goal_better(c2, i2, j2, c, i, j)) {
      c = c2;
      i = i2;
      j = j2;
    }
  }
  if constexpr (kMulti) {
    if (lane == 0) {
      x[warp][0] = c;
      x[warp][1] = i;
      x[warp][2] = j;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < nwarps; ++w) {
        if (goal_better(x[w][0], x[w][1], x[w][2], c, i, j)) {
          c = x[w][0];
          i = x[w][1];
          j = x[w][2];
        }
      }
    }
    __syncthreads();  // x may be reused right after
  }
}

// What a thread knows of its place: its read, its warp and its lanes.
struct Place {
  ReadBytes rd;
  unsigned mask;  // the threads of this warp
  int warp, nwarps;
  bool first, last;    // of the read's group: owns lane 0 / lane W - 1
  bool wfirst, wlast;  // of its warp
  int b, B, W, half, base, ql, tl, d_stop;
};

// Warp edges of the "warps" path: the edge scores of the newest odd and
// even diagonal, the edge query and target bytes, and the goal reduction.
struct Edges {
  int od[32], ev[32];
  unsigned q[32], t[32];
  int goal[32][3];
};

// One thread's LPT lanes: the two newest diagonals, the lanes' bytes and
// parent accumulators packed four to a word, and the goal trackers of
// kMode (0 global, 1 local, 2 semiGlobal).
template <bool kParents, bool kDashFree, int kMode, int LPT, bool kMulti>
struct Lanes {
  static constexpr int NW = LPT / 4;
  int ev[LPT], od[LPT];  // newest even / odd diagonal
  unsigned qw[NW], tw[NW], pw[NW];
  int best[LPT], best_d[LPT];  // local: first strict maximum per lane
  int cc, ci, rc, rj;          // semiGlobal: last column, last row
  int match, mismatch, gap, init;

  // Diagonal d into the array two diagonals old.  `edge` is the
  // neighbour thread's value: lane base - 1 of diagonal d - 1 on even d
  // (left), lane base + LPT on odd d (up).
  template <bool kOdd, bool kBorder>
  __device__ __forceinline__ void step(const Place& p, int edge, int d) {
    int(&h1)[LPT] = kOdd ? ev : od;
    int(&h2)[LPT] = kOdd ? od : ev;
    const int i_first = ((d + p.W) >> 1) - p.base;
    const int shift2 = 2 * ((d - 2) & 3);
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      const unsigned eq = qw[x] ^ tw[x];
      const unsigned qd = qw[x] ^ kDashWord, td = tw[x] ^ kDashWord;
      unsigned pword = 0;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int k = 4 * x + y;
        const unsigned bm = 0xffu << (8 * y);
        const int left = kOdd ? h1[k] : (k == 0 ? edge : h1[k == 0 ? 0 : k - 1]);
        const int up =
            kOdd ? (k == LPT - 1 ? edge : h1[k == LPT - 1 ? k : k + 1])
                 : h1[k];
        const int diag_v = h2[k] + ((eq & bm) == 0 ? match : mismatch);
        int h;
        if constexpr (kParents) {
          const int left_v =
              left + (!kDashFree && (td & bm) == 0 ? 0 : gap);
          const int up_v = up + (!kDashFree && (qd & bm) == 0 ? 0 : gap);
          unsigned pa = 0;
          h = diag_v;
          if (left_v > h) {
            h = left_v;
            pa = 1;
          }
          if (up_v > h) {
            h = up_v;
            pa = 2;
          }
          pword |= pa << (8 * y);
        } else if constexpr (kDashFree) {
          h = max(diag_v, max(left, up) + gap);
        } else {
          const int left_v = left + ((td & bm) == 0 ? 0 : gap);
          const int up_v = up + ((qd & bm) == 0 ? 0 : gap);
          h = max(max(diag_v, left_v), up_v);
        }
        if constexpr (kMode == 1) h = max(h, 0);  // the local clamp
        if constexpr (kBorder) {
          const int i = i_first - k, j = d - i;
          if (i == 0) h = j * init;
          if (j == 0) h = i * init;
          if (i < 0 || j < 0) h = kNeg;
        }
        h2[k] = h;
      }
      if constexpr (kParents) pw[x] |= pword << shift2;
    }
  }

  // Goal candidates of diagonal d, just written to `h`.
  __device__ __forceinline__ void track(const Place& p, const int (&h)[LPT],
                                        int d) {
    const int i0 = (d + p.W) >> 1;
    if constexpr (kMode == 1) {
      // Valid lanes (1 <= i <= ql, 1 <= j <= tl) are one interval.
      const int klo = max(i0 - p.ql, i0 - d + 1) - p.base;
      const int khi = min(i0 - 1, p.tl - d + i0) - p.base;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        if (k >= klo && k <= khi && h[k] > best[k]) {
          best[k] = h[k];
          best_d[k] = d;
        }
      }
    } else if constexpr (kMode == 2) {
      const int i_col = d - p.tl;
      const int kc = i0 - i_col - p.base;
      if (i_col >= 0 && i_col <= p.ql && kc >= 0 && kc < LPT) {
        const int v = pick(h, kc);
        if (v > cc) {
          cc = v;
          ci = i_col;
        }
      }
      const int j_row = d - p.ql;
      const int kr = i0 - p.ql - p.base;
      if (j_row >= 0 && j_row <= p.tl && kr >= 0 && kr < LPT) {
        const int v = pick(h, kr);
        if (v > rc) {
          rc = v;
          rj = j_row;
        }
      }
    }
  }

  // K4: the thread's LPT parent bytes of diagonals d - 3 .. d, one store.
  __device__ __forceinline__ void store_parents(const Place& p,
                                                unsigned char* par, int d) {
    unsigned char* dst =
        par + (static_cast<size_t>((d - 2) >> 2) * p.B + p.b) * p.W + p.base;
    if constexpr (LPT == 4) {
      *reinterpret_cast<unsigned*>(dst) = pw[0];
    } else if constexpr (LPT == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(pw[0], pw[1]);
    } else {
      static_assert(LPT == 16, "LPT is 4, 8 or 16");
      *reinterpret_cast<uint4*>(dst) = make_uint4(pw[0], pw[1], pw[2], pw[3]);
    }
#pragma unroll
    for (int x = 0; x < NW; ++x) pw[x] = 0;
  }

  // Even diagonal d: left of the thread's first lane comes from the
  // thread below.
  template <bool kBorder>
  __device__ __forceinline__ void even(const Place& p, Edges& e, int d) {
    int edge = __shfl_up_sync(p.mask, od[LPT - 1], 1);
    if (p.wfirst) edge = (kMulti && p.warp > 0) ? e.od[p.warp - 1] : kNeg;
    step<false, kBorder>(p, edge, d);
    track(p, ev, d);
  }

  // Diagonals d (even) and d + 1, d + 1 <= d_stop, then the query shift
  // for d + 2.
  template <bool kBorder>
  __device__ __forceinline__ void pair(const Place& p, Edges& e,
                                       unsigned char* par, int d) {
    // The band's end lanes fetch the bytes that enter with the next two
    // shifts: column d/2 + W/2 for lane W - 1 on diagonal d + 1, row
    // (d + 2 + W)/2 for lane 0 on diagonal d + 2.
    const unsigned t_in = p.last ? p.rd.t_at((d >> 1) + p.half) : 0u;
    const unsigned q_in = p.first ? p.rd.q_at((d + 2 + p.W) >> 1) : 0u;
    even<kBorder>(p, e, d);
    if constexpr (kMulti) {
      if (p.wfirst) {
        e.ev[p.warp] = ev[0];
        e.t[p.warp] = tw[0] & 0xffu;
      }
      __syncthreads();
    }

    // Target bytes move down one lane for the odd diagonal.
    unsigned carry = __shfl_down_sync(p.mask, tw[0] & 0xffu, 1);
    if (p.wlast)
      carry = (kMulti && p.warp < p.nwarps - 1) ? e.t[p.warp + 1] : t_in;
#pragma unroll
    for (int x = 0; x < NW - 1; ++x) tw[x] = (tw[x] >> 8) | (tw[x + 1] << 24);
    tw[NW - 1] = (tw[NW - 1] >> 8) | (carry << 24);

    // Odd diagonal d + 1: up of the thread's last lane comes from the
    // thread above.
    const int d1 = d + 1;
    int edge = __shfl_down_sync(p.mask, ev[0], 1);
    if (p.wlast)
      edge = (kMulti && p.warp < p.nwarps - 1) ? e.ev[p.warp + 1] : kNeg;
    step<true, kBorder>(p, edge, d1);
    track(p, od, d1);
    if constexpr (kParents) {
      if (((d1 - 2) & 3) == 3 || d1 == p.d_stop) store_parents(p, par, d1);
    }
    if constexpr (kMulti) {
      if (p.wlast) {
        e.od[p.warp] = od[LPT - 1];
        e.q[p.warp] = qw[NW - 1] >> 24;
      }
      __syncthreads();
    }

    // Query bytes move up one lane for the next even diagonal.
    carry = __shfl_up_sync(p.mask, qw[NW - 1] >> 24, 1);
    if (p.wfirst) carry = (kMulti && p.warp > 0) ? e.q[p.warp - 1] : q_in;
#pragma unroll
    for (int x = NW - 1; x > 0; --x) qw[x] = (qw[x] << 8) | (qw[x - 1] >> 24);
    qw[0] = (qw[0] << 8) | carry;
  }
};

// K4 on the "warps" path asks for one resident CTA only: with no stated
// minimum ptxas caps it at 64 registers and spills.
template <bool kParents, bool kDashFree, int kMode, int LPT, bool kMulti>
__global__ void __launch_bounds__(kMulti ? kRegMaxW / LPT
                                         : 32 * kMaxReadsPerCta,
                                  (kParents && kMulti) ? 1 : 0)
band_reg_kernel(BandArgs a) {
  constexpr int NW = LPT / 4;
  __shared__ Edges e;
  const int lane = threadIdx.x & 31;
  Place p;
  p.warp = kMulti ? threadIdx.x >> 5 : 0;
  p.b = kMulti ? blockIdx.x
               : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (!kMulti && p.b >= a.B) return;  // no block sync on this path
  p.W = a.W;
  p.B = a.B;
  const int nthr = p.W / LPT;  // threads of this read
  const int t = kMulti ? threadIdx.x : lane;
  p.nwarps = (nthr + 31) >> 5;
  const int cnt = min(32, nthr - 32 * p.warp);  // threads of this warp
  // One warp per read is always a full warp: a constant mask keeps the
  // compiler from guarding every shuffle against divergence.
  p.mask = (!kMulti || cnt == 32) ? 0xffffffffu : (1u << cnt) - 1u;
  p.first = t == 0;
  p.last = t == nthr - 1;
  p.wfirst = lane == 0;
  p.wlast = lane == cnt - 1;
  p.base = t * LPT;
  p.half = p.W >> 1;
  p.rd.qr = a.q + static_cast<size_t>(p.b) * a.n;
  p.rd.tr = a.t + static_cast<size_t>(p.b) * a.m;
  p.rd.n = a.n;
  p.rd.n_pad = a.n_pad;
  p.rd.m_eff = a.m_eff;
  p.rd.t_have = min(a.m, a.m_eff);
  p.ql = a.q_len[p.b];
  p.tl = min(a.t_len[p.b], a.m_eff);  // the Pallas target-length clamp
  p.d_stop = min(p.ql + p.tl, a.n_steps + 1);
  const int W = p.W, B = p.B, b = p.b, base = p.base;

  Lanes<kParents, kDashFree, kMode, LPT, kMulti> s;
  s.match = a.match;
  s.mismatch = a.mismatch;
  s.gap = a.gap;
  s.init = kMode == 0 ? a.gap : 0;
  s.cc = s.ci = s.rc = s.rj = 0;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int l = base + k;
    s.ev[k] = l == p.half ? 0 : kNeg;                             // diagonal 0
    s.od[k] = (l == p.half || l == p.half - 1) ? s.init : kNeg;  // diagonal 1
    s.best[k] = kNeg;
    s.best_d[k] = 0;
  }
  // The lanes' bytes on diagonal 2: i = half + 1 - l, j = 2 - i.
#pragma unroll
  for (int x = 0; x < NW; ++x) {
    s.qw[x] = s.tw[x] = s.pw[x] = 0;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = p.half + 1 - (base + 4 * x + y);
      s.qw[x] |= p.rd.q_at(i) << (8 * y);
      s.tw[x] |= p.rd.t_at(2 - i) << (8 * y);
    }
  }
  if constexpr (kMulti) {
    if (p.wlast) e.od[p.warp] = s.od[LPT - 1];
    __syncthreads();
  }

  // Every thread of a warp runs every diagonal up to d_stop (uniform over
  // the read's group) and reaches every shuffle and block sync.  Border
  // pairs (d < W + 2), interior pairs, then a last even diagonal alone.
  int d = 2;
#pragma unroll 1
  for (; d < W + 2 && d < p.d_stop; d += 2) s.template pair<true>(p, e, a.par, d);
#pragma unroll 1
  for (; d < p.d_stop; d += 2) s.template pair<false>(p, e, a.par, d);
  if (d == p.d_stop) {
    s.template even<true>(p, e, d);  // the general body serves any d
    if constexpr (kParents) s.store_parents(p, a.par, d);
  }

  int* out = a.out;
  if constexpr (kMode == 0) {
    // The goal cell (ql, tl) lies on diagonal ql + tl, the last one swept
    // unless the sweep was cut: its value is still in a register.
    const int dg = p.ql + p.tl;
    const int x = p.tl - p.ql + W - (dg & 1);
    const bool on = dg >= 2 && dg == p.d_stop && x >= 0 && (x >> 1) < W;
    const int kg = (x >> 1) - base;
    if (on && kg >= 0 && kg < LPT)
      out[b] = (dg & 1) ? pick(s.od, kg) : pick(s.ev, kg);
    if (p.first) {
      if (!on) out[b] = 0;
      out[B + b] = p.ql;
      out[2 * B + b] = p.tl;
    }
  } else if constexpr (kMode == 1) {
    int c = kNeg, gi = 0, gj = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int i = ((s.best_d[k] + W) >> 1) - (base + k);
      const int j = s.best_d[k] - i;
      if (goal_better(s.best[k], i, j, c, gi, gj)) {
        c = s.best[k];
        gi = i;
        gj = j;
      }
    }
    group_best<kMulti>(c, gi, gj, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
    if (p.first) {
      const bool hit = c > kNeg;
      out[b] = hit ? c : 0;
      out[B + b] = hit ? gi : 0;
      out[2 * B + b] = hit ? gj : 0;
    }
  } else {
    int cc = s.cc, ci = s.ci, z0 = 0;
    group_best<kMulti>(cc, ci, z0, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
    int rc = s.rc, rj = s.rj, z1 = 0;
    group_best<kMulti>(rc, rj, z1, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
    if (p.first) {
      const bool row_wins = rc > cc;
      out[b] = row_wins ? rc : cc;
      out[B + b] = row_wins ? p.ql : ci;
      out[2 * B + b] = row_wins ? rj : p.tl;
    }
  }
}

// ---- scratch path ---------------------------------------------------------

// Per-read state in ints: three diagonals, plus W parent-accumulator bytes
// for K4.
__host__ __device__ inline int state_ints(int W, bool parents) {
  return 3 * W + (parents ? W / 4 : 0);
}

template <bool kParents>
__global__ void band_scratch_kernel(
    const unsigned char* __restrict__ q, int n, int n_pad,
    const unsigned char* __restrict__ t, int m, int m_eff,
    const int* __restrict__ q_len, const int* __restrict__ t_len, int B,
    int W, int n_steps, int mode, int dash_free, int match, int mismatch,
    int gap, int* __restrict__ scratch, int* __restrict__ out,
    int use_smem, unsigned char* __restrict__ par) {
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

  int* buf = use_smem ? smem
                      : scratch + static_cast<size_t>(b) *
                                      state_ints(W, kParents);
  int* h2 = buf;          // diagonal d-2
  int* h1 = buf + W;      // diagonal d-1
  int* h0 = buf + 2 * W;  // diagonal d
  // K4: lane l's parent byte in progress.
  unsigned char* pacc = reinterpret_cast<unsigned char*>(buf + 3 * W);
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
    const int sub = (d - 2) & 3;
    const bool store = sub == 3 || d == d_stop;
    unsigned char* prow =
        kParents ? par + (static_cast<size_t>((d - 2) >> 2) * B + b) * W
                 : nullptr;
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
      if constexpr (kParents) {
        const int left_v = left + (!dash_free && tb == kDash ? 0 : gap);
        const int up_v = up + (!dash_free && qb == kDash ? 0 : gap);
        int pa = 0;
        h = diag_v;
        if (left_v > h) {
          h = left_v;
          pa = 1;
        }
        if (up_v > h) {
          h = up_v;
          pa = 2;
        }
        const unsigned acc =
            (sub == 0 ? 0u : pacc[l]) | static_cast<unsigned>(pa << (2 * sub));
        if (store) {
          prow[l] = static_cast<unsigned char>(acc);
        } else {
          pacc[l] = static_cast<unsigned char>(acc);
        }
      } else if (dash_free) {
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

// ---- launch ---------------------------------------------------------------

enum BandPath { kPathWarp = 0, kPathWarps = 1, kPathScratch = 2 };

template <bool kParents, bool kDashFree, int LPT, bool kMulti>
int launch_reg(const BandArgs& a, int reads_per_cta, cudaStream_t stream) {
  const int nthr = a.W / LPT;
  if (a.W % LPT != 0 || a.W > kRegMaxW || a.mode < 0 || a.mode > 2)
    return cudaErrorInvalidValue;
  int grid, block;
  if (kMulti) {
    if (reads_per_cta != 1) return cudaErrorInvalidValue;
    grid = a.B;
    block = nthr;
  } else {
    if (nthr != 32 || reads_per_cta < 1 || reads_per_cta > kMaxReadsPerCta)
      return cudaErrorInvalidValue;
    grid = (a.B + reads_per_cta - 1) / reads_per_cta;
    block = 32 * reads_per_cta;
  }
  if (a.mode == 0) {
    band_reg_kernel<kParents, kDashFree, 0, LPT, kMulti>
        <<<grid, block, 0, stream>>>(a);
  } else if (a.mode == 1) {
    band_reg_kernel<kParents, kDashFree, 1, LPT, kMulti>
        <<<grid, block, 0, stream>>>(a);
  } else {
    band_reg_kernel<kParents, kDashFree, 2, LPT, kMulti>
        <<<grid, block, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan (path, lanes per thread, reads per CTA, shared bytes) comes from
// ops/band.band_plan; a plan no kernel was built for is refused.
template <bool kParents>
int launch_band(const void* q, int n, int n_pad, const void* t, int m,
                int m_eff, const void* q_len, const void* t_len, int B, int W,
                int n_steps, int mode, int dash_free, int match, int mismatch,
                int gap, void* scratch, void* out, int path, int lpt,
                int reads_per_cta, int smem_bytes, void* par, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == kPathScratch) {
    const size_t smem = static_cast<size_t>(smem_bytes);
    cudaError_t e = bioinfo1::allow_smem(band_scratch_kernel<kParents>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int threads = W < 512 ? W : 512;
    band_scratch_kernel<kParents><<<B, threads, smem, st>>>(
        static_cast<const unsigned char*>(q), n, n_pad,
        static_cast<const unsigned char*>(t), m, m_eff,
        static_cast<const int*>(q_len), static_cast<const int*>(t_len), B, W,
        n_steps, mode, dash_free, match, mismatch, gap,
        static_cast<int*>(scratch), static_cast<int*>(out),
        smem_bytes > 0 ? 1 : 0, static_cast<unsigned char*>(par));
    return static_cast<int>(cudaGetLastError());
  }
  BandArgs a;
  a.q = static_cast<const unsigned char*>(q);
  a.n = n;
  a.n_pad = n_pad;
  a.t = static_cast<const unsigned char*>(t);
  a.m = m;
  a.m_eff = m_eff;
  a.q_len = static_cast<const int*>(q_len);
  a.t_len = static_cast<const int*>(t_len);
  a.B = B;
  a.W = W;
  a.n_steps = n_steps;
  a.mode = mode;
  a.match = match;
  a.mismatch = mismatch;
  a.gap = gap;
  a.out = static_cast<int*>(out);
  a.par = static_cast<unsigned char*>(par);
#define BIOINFO1_BAND_CASE(PATH, LPT, MULTI)                                 \
  if (path == PATH && lpt == LPT)                                            \
    return dash_free                                                         \
               ? launch_reg<kParents, true, LPT, MULTI>(a, reads_per_cta, st) \
               : launch_reg<kParents, false, LPT, MULTI>(a, reads_per_cta, st);
  BIOINFO1_BAND_CASE(kPathWarp, 4, false)   // W = 128
  BIOINFO1_BAND_CASE(kPathWarp, 8, false)   // W = 256
  BIOINFO1_BAND_CASE(kPathWarps, 8, true)   // W <= kRegMaxW
#ifdef BIOINFO1_BAND_LPT_TRIAL  // chip_smoke.py --lpt-trial: the other LPTs
  BIOINFO1_BAND_CASE(kPathWarp, 16, false)
  BIOINFO1_BAND_CASE(kPathWarps, 4, true)
  BIOINFO1_BAND_CASE(kPathWarps, 16, true)
#endif
#undef BIOINFO1_BAND_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// K2.  q: (B, n) uint8; t: (B, m) uint8; q_len/t_len: (B,) int32; out:
// (3, B) int32 rows score, goal_i, goal_j.  W is a multiple of 128.  path,
// lpt, reads_per_cta and smem_bytes are ops/band.band_plan's; scratch is
// (B, 3 * W) int32 on the scratch path when smem_bytes == 0, else unused.
extern "C" int bioinfo1_band_score(const void* q, int n, int n_pad,
                                   const void* t, int m, int m_eff,
                                   const void* q_len, const void* t_len,
                                   int B, int W, int n_steps, int mode,
                                   int dash_free, int match, int mismatch,
                                   int gap, void* scratch, void* out,
                                   int path, int lpt, int reads_per_cta,
                                   int smem_bytes, void* stream) {
  return launch_band<false>(q, n, n_pad, t, m, m_eff, q_len, t_len, B, W,
                            n_steps, mode, dash_free, match, mismatch, gap,
                            scratch, out, path, lpt, reads_per_cta,
                            smem_bytes, nullptr, stream);
}

// K4.  As K2, plus par: (steps_pad / 4, B, W) uint8 parents; the scratch
// path's global scratch is (B, 3 * W + W / 4) int32.
extern "C" int bioinfo1_band_parents(const void* q, int n, int n_pad,
                                     const void* t, int m, int m_eff,
                                     const void* q_len, const void* t_len,
                                     int B, int W, int n_steps, int mode,
                                     int dash_free, int match, int mismatch,
                                     int gap, void* scratch, void* out,
                                     int path, int lpt, int reads_per_cta,
                                     int smem_bytes, void* par,
                                     void* stream) {
  return launch_band<true>(q, n, n_pad, t, m, m_eff, q_len, t_len, B, W,
                           n_steps, mode, dash_free, match, mismatch, gap,
                           scratch, out, path, lpt, reads_per_cta, smem_bytes,
                           par, stream);
}
