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
// A lane never moves, so its neighbours are fixed.  Five kernels share
// the file; ops/band.band_plan picks one from W alone (and, past the
// card's w_strip, from whether parents are asked for):
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
//   - "cluster" path (kRegMaxW < W <= kRegMaxW * kMaxCluster): the same
//     threads over the C CTAs of a thread-block cluster, one cluster per
//     read, T = W / (LPT * C) threads each; thread t of the CTA of cluster
//     rank r owns lanes [(r*T + t)*LPT, +LPT).  Each CTA runs the "warps"
//     body; at a CTA boundary the edge values go to the neighbour CTA's
//     arrays by a store into its shared memory (distributed shared memory)
//     before the barrier, and one cluster barrier per diagonal (release /
//     acquire) takes the place of the block sync.  Goals reduce per CTA,
//     then across ranks into rank 0, after the sweep.
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
// "warps" path adds one block sync per diagonal, the "cluster" path one
// cluster barrier per diagonal, which sets its pace: at the 50 kb reads'
// band (7 CTAs of 448 threads) a diagonal takes ~0.9 us on an H100, and
// K4, which issues twice K2's instructions per cell, takes only ~16% more.
//
// Strip path, kRegMaxW * kMaxCluster < W <= the card's w_strip
// (ops/band.StripCard: 540,672 on an H100 SXM; band_strip_kernel, any W
// that is a multiple of 128 when called directly).  A read's lanes split
// into ceil(W / width) strips of `width` owned lanes (1,024-4,096 by
// ops/band.strip_plan, from the card's SMs and this kernel's occupancy),
// one CTA each.  A CTA
// runs the "warps" body over a window of its strip and kStripHalo lanes on
// each side; the band's walls (lane 0's left, lane W - 1's up) take _NEG
// from outside, the window's own edges too, and the window's end lanes
// read the bytes that enter by index on every pair, so every lane's bytes
// are right.  A wrong value at a window edge moves one lane inward per
// pair of diagonals, so a CTA runs kStripEpoch = 2 * kStripHalo diagonals
// alone, then swaps edges with its neighbours through a global buffer: it
// stores its outer kStripHalo owned lanes of both newest diagonals into
// slot (epoch & 1), publishes the epoch with a release store, waits for
// its neighbours' flags with acquire loads and loads their lanes into its
// halo past L1 (__ldcg).  A strip waits on its neighbours, so all of a
// read's CTAs must be resident at once: cooperative launches of
// ops/band.strip_plan's reads_per_launch reads.  Only owned lanes inside
// the band track goals and store parents; each CTA reduces its own, and
// the last CTA of a read to finish (strip 0's ticket) merges the strips'
// under the cluster path's total order.  What bounds it: the "warps"
// body's instructions a cell and its block sync a diagonal, plus one swap
// (a device-memory round trip) an epoch; the halo adds 2 * kStripHalo
// lanes a strip.
//
// Epochs path, K2 with W > the card's w_strip (band_epoch_kernel; any W
// that is a multiple of 128 when called directly): the strip path's
// strips and body without co-residency.  A read's two newest diagonals
// live in global memory in two slots, one for each epoch parity, with the
// owned lanes' goal trackers.  One launch per epoch of 2 * kEpochHalo
// diagonals covers every strip of every read: a CTA loads its window from
// slot k & 1 (its halo from its neighbours' owned lanes), its lanes' bytes
// on the epoch's first diagonal by index, runs the epoch alone and stores
// its owned lanes into slot (k + 1) & 1; the C entry point issues the
// launches one after another on the caller's stream, so stream order is
// the only synchronisation, and a small merge kernel takes the strips'
// goals after the last.  What bounds it: the strip body's instructions
// and block sync a diagonal, plus a launch, a round trip of the window's
// two diagonals (and the trackers) through device memory and the halo's
// 2 * kEpochHalo lanes a strip every epoch.
//
// Scratch path, K4 with W > the card's w_strip (band_scratch_kernel; any W
// when called directly): one CTA per read, the
// three diagonals in shared memory (12*W bytes, plus K4's W accumulator
// bytes) while that fits, else in a per-read global scratch; each lane
// reads its bytes by index and evaluates every border condition; one
// __syncthreads per anti-diagonal plus, in local mode, a block-wide
// argmax.  Bound by that sync and by ~63 (K4: 77) integer instructions per
// lane in its SASS for sm_90a.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kNeg = -(1 << 30);  // pallas_band._NEG
constexpr unsigned char kDash = 45;
constexpr unsigned kDashWord = 0x2d2d2d2du;
constexpr int kRegMaxW = 4096;      // widest band of the register paths
constexpr int kMaxReadsPerCta = 4;  // "warp" path
constexpr int kMaxCluster = 8;      // "cluster" path: the portable size

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

using bioinfo1::goal_better;
using bioinfo1::pick;

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
  int warp, nwarps;    // in this CTA
  int rank, nranks;    // this CTA in the read's cluster ("cluster" path)
  bool first, last;    // of the read's group: owns lane 0 / lane W - 1
                       // (on the "strip" path: of the CTA's window)
  bool wfirst, wlast;  // of its warp
  int b, B, W, half, base, ql, tl, d_stop;
  // The window's end lanes read the bytes that enter: row (d + q_w) / 2
  // for its first lane on even d, column d / 2 + t_off for its last lane
  // on odd d + 1 (q_w = W, t_off = W / 2 where the window is the band).
  int q_w, t_off;
  // "strip" path: owns band lane 0 / lane W - 1 (the band's walls: its
  // neighbour outside the band is _NEG), and owns lanes of the band (not
  // halo, not past W): only these track goals and store parents.
  bool lo_wall, hi_wall, owned;
  // "cluster" path: where this warp's edge values go - the slots of
  // Edges below, in this CTA or, at a CTA boundary, in the neighbour's.
  int* ev_out;
  unsigned* t_out;
  int* od_out;
  unsigned* q_out;
};

// Read p.b's bytes, lengths and last diagonal.
__device__ __forceinline__ void set_read(Place& p, const BandArgs& a) {
  p.rd.qr = a.q + static_cast<size_t>(p.b) * a.n;
  p.rd.tr = a.t + static_cast<size_t>(p.b) * a.m;
  p.rd.n = a.n;
  p.rd.n_pad = a.n_pad;
  p.rd.m_eff = a.m_eff;
  p.rd.t_have = min(a.m, a.m_eff);
  p.ql = a.q_len[p.b];
  p.tl = min(a.t_len[p.b], a.m_eff);  // the Pallas target-length clamp
  p.d_stop = min(p.ql + p.tl, a.n_steps + 1);
}

// Warp edges of the "warps" and "cluster" paths: the edge scores of the
// newest odd and even diagonal, the edge query and target bytes, and the
// goal reductions.  Warp w writes ev[w] and t[w] (its first lane) for warp
// w - 1, and od[w + 1] and q[w + 1] (its last lane) for warp w + 1; slot
// nwarps of ev / t and slot 0 of od / q are the next and the previous
// CTA's on the "cluster" path.  rgoal holds each rank's best in rank 0.
struct Edges {
  int od[33], ev[33];
  unsigned q[33], t[33];
  int goal[32][3];
  int rgoal[2][kMaxCluster][3];
};

// The barrier that orders the edge slots: the block's, or the cluster's
// (barrier.cluster.arrive.release + wait.acquire).
template <bool kCluster>
__device__ __forceinline__ void group_sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// One thread's LPT lanes: the two newest diagonals, the lanes' bytes and
// parent accumulators packed four to a word, and the goal trackers of
// kMode (0 global, 1 local, 2 semiGlobal).
template <bool kParents, bool kDashFree, int kMode, int LPT, bool kMulti,
          bool kCluster, bool kStrip = false>
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

  // Diagonals 0 and 1 of the thread's lanes, their bytes on diagonal 2,
  // and the goal trackers.
  __device__ __forceinline__ void init_lanes(const Place& p,
                                             const BandArgs& a) {
    match = a.match;
    mismatch = a.mismatch;
    gap = a.gap;
    init = kMode == 0 ? a.gap : 0;
    cc = ci = rc = rj = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = p.base + k;
      ev[k] = l == p.half ? 0 : kNeg;                           // diagonal 0
      od[k] = (l == p.half || l == p.half - 1) ? init : kNeg;  // diagonal 1
      best[k] = kNeg;
      best_d[k] = 0;
    }
    // The lanes' bytes on diagonal 2: i = half + 1 - l, j = 2 - i.
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      qw[x] = tw[x] = pw[x] = 0;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = p.half + 1 - (p.base + 4 * x + y);
        qw[x] |= p.rd.q_at(i) << (8 * y);
        tw[x] |= p.rd.t_at(2 - i) << (8 * y);
      }
    }
  }

  // Goal candidates of diagonal d, just written to `h`.
  __device__ __forceinline__ void track(const Place& p, const int (&h)[LPT],
                                        int d) {
    const int i0 = (d + p.W) >> 1;
    if constexpr (kMode == 1) {
      // Valid lanes (1 <= i <= ql, 1 <= j <= tl) are one interval.
      const int klo = max(i0 - p.ql, i0 - d + 1) - p.base;
      int khi = min(i0 - 1, p.tl - d + i0) - p.base;
      if constexpr (kStrip) {
        if (!p.owned) khi = -1;
      }
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
      if (i_col >= 0 && i_col <= p.ql && kc >= 0 && kc < LPT &&
          (!kStrip || p.owned)) {
        const int v = pick(h, kc);
        if (v > cc) {
          cc = v;
          ci = i_col;
        }
      }
      const int j_row = d - p.ql;
      const int kr = i0 - p.ql - p.base;
      if (j_row >= 0 && j_row <= p.tl && kr >= 0 && kr < LPT &&
          (!kStrip || p.owned)) {
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
    if constexpr (kStrip) {
      if (!p.owned) {
#pragma unroll
        for (int x = 0; x < NW; ++x) pw[x] = 0;
        return;
      }
    }
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
    if (p.wfirst) edge = (kMulti && !p.first) ? e.od[p.warp] : kNeg;
    if constexpr (kStrip) {
      if (p.lo_wall) edge = kNeg;
    }
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
    const unsigned t_in = p.last ? p.rd.t_at((d >> 1) + p.t_off) : 0u;
    const unsigned q_in = p.first ? p.rd.q_at((d + 2 + p.q_w) >> 1) : 0u;
    even<kBorder>(p, e, d);
    if constexpr (kMulti) {
      if (p.wfirst) {
        if constexpr (kCluster) {
          *p.ev_out = ev[0];
          *p.t_out = tw[0] & 0xffu;
        } else {
          e.ev[p.warp] = ev[0];
          e.t[p.warp] = tw[0] & 0xffu;
        }
      }
      group_sync<kCluster>();
    }

    // Target bytes move down one lane for the odd diagonal.
    unsigned carry = __shfl_down_sync(p.mask, tw[0] & 0xffu, 1);
    if (p.wlast) carry = (kMulti && !p.last) ? e.t[p.warp + 1] : t_in;
#pragma unroll
    for (int x = 0; x < NW - 1; ++x) tw[x] = (tw[x] >> 8) | (tw[x + 1] << 24);
    tw[NW - 1] = (tw[NW - 1] >> 8) | (carry << 24);

    // Odd diagonal d + 1: up of the thread's last lane comes from the
    // thread above.
    const int d1 = d + 1;
    int edge = __shfl_down_sync(p.mask, ev[0], 1);
    if (p.wlast) edge = (kMulti && !p.last) ? e.ev[p.warp + 1] : kNeg;
    if constexpr (kStrip) {
      if (p.hi_wall) edge = kNeg;
    }
    step<true, kBorder>(p, edge, d1);
    track(p, od, d1);
    if constexpr (kParents) {
      if (((d1 - 2) & 3) == 3 || d1 == p.d_stop) store_parents(p, par, d1);
    }
    if constexpr (kMulti) {
      if (p.wlast) {
        if constexpr (kCluster) {
          *p.od_out = od[LPT - 1];
          *p.q_out = qw[NW - 1] >> 24;
        } else {
          e.od[p.warp + 1] = od[LPT - 1];
          e.q[p.warp + 1] = qw[NW - 1] >> 24;
        }
      }
      group_sync<kCluster>();
    }

    // Query bytes move up one lane for the next even diagonal.
    carry = __shfl_up_sync(p.mask, qw[NW - 1] >> 24, 1);
    if (p.wfirst) carry = (kMulti && !p.first) ? e.q[p.warp] : q_in;
#pragma unroll
    for (int x = NW - 1; x > 0; --x) qw[x] = (qw[x] << 8) | (qw[x - 1] >> 24);
    qw[0] = (qw[0] << 8) | carry;
  }
};

// Rank 0 of a read's cluster takes the best (c, i, j) of every rank from
// slot k of its rgoal (each rank's thread 0 stored there before the
// barrier that precedes this call).
__device__ __forceinline__ void take_rank_best(const Place& p, const Edges& e,
                                               int k, int& c, int& i,
                                               int& j) {
  for (int r = 1; r < p.nranks; ++r) {
    const int* g = e.rgoal[k][r];
    if (goal_better(g[0], g[1], g[2], c, i, j)) {
      c = g[0];
      i = g[1];
      j = g[2];
    }
  }
}

// Thread 0 of a CTA stores its CTA's best into slot k of rank 0's rgoal.
__device__ __forceinline__ void post_rank_best(const Place& p, Edges& e,
                                               int k, int c, int i, int j) {
  if (threadIdx.x == 0) {
    int* g = cg::this_cluster().map_shared_rank(&e.rgoal[k][p.rank][0], 0);
    g[0] = c;
    g[1] = i;
    g[2] = j;
  }
}

// K4 on the "warps" and "cluster" paths asks for one resident CTA only:
// with no stated minimum ptxas caps it at 64 registers and spills.
template <bool kParents, bool kDashFree, int kMode, int LPT, bool kMulti,
          bool kCluster>
__global__ void __launch_bounds__(kMulti ? kRegMaxW / LPT
                                         : 32 * kMaxReadsPerCta,
                                  (kParents && kMulti) ? 1 : 0)
band_reg_kernel(BandArgs a) {
  static_assert(kMulti || !kCluster, "a cluster runs the warps body");
  __shared__ Edges e;
  const int lane = threadIdx.x & 31;
  Place p;
  p.warp = kMulti ? threadIdx.x >> 5 : 0;
  p.rank = 0;
  p.nranks = 1;
  if constexpr (kCluster) {
    p.rank = static_cast<int>(cg::this_cluster().block_rank());
    p.nranks = static_cast<int>(cg::this_cluster().num_blocks());
  }
  p.b = kMulti ? blockIdx.x / p.nranks
               : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (!kMulti && p.b >= a.B) return;  // no block sync on this path
  p.W = a.W;
  p.B = a.B;
  const int nthr = p.W / LPT;  // threads of this read
  const int cta_thr = kMulti ? static_cast<int>(blockDim.x) : 32;
  const int t = kMulti ? p.rank * cta_thr + threadIdx.x : lane;
  p.nwarps = (cta_thr + 31) >> 5;
  const int cnt = min(32, cta_thr - 32 * p.warp);  // threads of this warp
  // One warp per read is always a full warp: a constant mask keeps the
  // compiler from guarding every shuffle against divergence.
  p.mask = (!kMulti || cnt == 32) ? 0xffffffffu : (1u << cnt) - 1u;
  p.first = t == 0;
  p.last = t == nthr - 1;
  p.wfirst = lane == 0;
  p.wlast = lane == cnt - 1;
  p.base = t * LPT;
  if constexpr (kCluster) {
    // A CTA's first thread feeds the previous CTA's last warp, its last
    // thread the next CTA's first warp.
    cg::cluster_group cl = cg::this_cluster();
    p.ev_out = &e.ev[p.warp];
    p.t_out = &e.t[p.warp];
    p.od_out = &e.od[p.warp + 1];
    p.q_out = &e.q[p.warp + 1];
    if (threadIdx.x == 0 && p.rank > 0) {
      p.ev_out = cl.map_shared_rank(&e.ev[p.nwarps], p.rank - 1);
      p.t_out = cl.map_shared_rank(&e.t[p.nwarps], p.rank - 1);
    }
    if (threadIdx.x == cta_thr - 1 && p.rank < p.nranks - 1) {
      p.od_out = cl.map_shared_rank(&e.od[0], p.rank + 1);
      p.q_out = cl.map_shared_rank(&e.q[0], p.rank + 1);
    }
  }
  p.half = p.W >> 1;
  p.q_w = p.W;
  p.t_off = p.half;
  set_read(p, a);
  const int W = p.W, B = p.B, b = p.b, base = p.base;

  Lanes<kParents, kDashFree, kMode, LPT, kMulti, kCluster> s;
  s.init_lanes(p, a);
  if constexpr (kMulti) {
    // No CTA writes into another's shared memory before all have started.
    if constexpr (kCluster) group_sync<true>();
    if (p.wlast) {
      if constexpr (kCluster) {
        *p.od_out = s.od[LPT - 1];
      } else {
        e.od[p.warp + 1] = s.od[LPT - 1];
      }
    }
    group_sync<kCluster>();
  }

  // Every thread of a warp runs every diagonal up to d_stop (uniform over
  // the read's group) and reaches every shuffle, block sync and cluster
  // barrier.  Border pairs (d < W + 2), interior pairs, then a last even
  // diagonal alone.
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
    // Every store into a neighbour's shared memory came before a barrier
    // of the sweep; this last one keeps the rule of the other modes: no
    // CTA leaves while another may still touch its shared memory.
    if constexpr (kCluster) group_sync<true>();
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
    if constexpr (kCluster) {
      post_rank_best(p, e, 0, c, gi, gj);
      group_sync<true>();  // also the last barrier: no remote access after
      if (p.first) take_rank_best(p, e, 0, c, gi, gj);
    }
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
    if constexpr (kCluster) {
      post_rank_best(p, e, 0, cc, ci, z0);
      post_rank_best(p, e, 1, rc, rj, z1);
      group_sync<true>();  // also the last barrier: no remote access after
      if (p.first) {
        take_rank_best(p, e, 0, cc, ci, z0);
        take_rank_best(p, e, 1, rc, rj, z1);
      }
    }
    if (p.first) {
      const bool row_wins = rc > cc;
      out[b] = row_wins ? rc : cc;
      out[B + b] = row_wins ? p.ql : ci;
      out[2 * B + b] = row_wins ? rj : p.tl;
    }
  }
}

// ---- strip path ----------------------------------------------------------

constexpr int kStripHalo = 32;               // H: halo lanes on each side
constexpr int kStripEpoch = 2 * kStripHalo;  // E: diagonals between swaps
constexpr int kStripLpt = 8;
constexpr int kHaloThreads = kStripHalo / kStripLpt;
constexpr int kStripMaxWidth = kRegMaxW;     // owned lanes of a strip
constexpr int kStripMaxThreads =
    kStripMaxWidth / kStripLpt + 2 * kHaloThreads;
// A strip's record in the scratch, in ints: the epochs it has published
// (its flag), strip 0's ticket (strips of the read that have finished),
// two goal triples, and the exchange buffer [slot][side][halo thread]
// [ev, od] (slot = epoch parity; side 0 its first owned lanes, 1 its last).
constexpr int kRecFlag = 0;
constexpr int kRecTicket = 1;
constexpr int kRecGoal = 32;
constexpr int kRecX = 64;
constexpr int kStripRecInts = kRecX + 2 * 2 * kHaloThreads * 2 * kStripLpt;
static_assert(kStripEpoch % 4 == 0, "an epoch ends on a parent byte");

struct StripArgs {
  int* rec;    // (B, strips, kStripRecInts) int32, zeroed by the wrapper
  int width;   // owned lanes of a strip, a multiple of 128
  int strips;  // ceil(W / width)
  int b0;      // first read of this launch
};

// The swap's flags: a release store after a strip's edges, acquire loads
// before it reads its neighbours' (whose edges it loads with __ldcg: L1 is
// not coherent between SMs).
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The swap before epoch k (k >= 1): the strip's first and last
// kHaloThreads owned threads store both newest diagonals into slot k & 1,
// thread 0 publishes k and waits until both neighbours have, then the halo
// threads load the lanes they mirror from the neighbour that owns them.
// Two slots suffice: a neighbour writes slot k & 1 again only at swap
// k + 2, after this strip has published k + 1, i.e. after it read slot
// k & 1.
template <class L>
__device__ __forceinline__ void strip_swap(L& s, int* rec, int strip,
                                           int strips, int k) {
  constexpr int LPT = kStripLpt, HT = kHaloThreads, X = 2 * LPT;
  const int t = threadIdx.x, T = blockDim.x;
  const int slot = k & 1;
  int* mine = rec + strip * kStripRecInts;
  int* dst = nullptr;
  if (t >= HT && t < 2 * HT) {
    dst = mine + kRecX + ((slot * 2 + 0) * HT + t - HT) * X;
  } else if (t >= T - 2 * HT && t < T - HT) {
    dst = mine + kRecX + ((slot * 2 + 1) * HT + t - (T - 2 * HT)) * X;
  }
  if (dst != nullptr) {
    int4* d4 = reinterpret_cast<int4*>(dst);
    d4[0] = make_int4(s.ev[0], s.ev[1], s.ev[2], s.ev[3]);
    d4[1] = make_int4(s.ev[4], s.ev[5], s.ev[6], s.ev[7]);
    d4[2] = make_int4(s.od[0], s.od[1], s.od[2], s.od[3]);
    d4[3] = make_int4(s.od[4], s.od[5], s.od[6], s.od[7]);
  }
  __syncthreads();
  if (t == 0) {
    __threadfence();
    st_release(mine + kRecFlag, k);
    if (strip > 0) {
      while (ld_acquire(mine - kStripRecInts + kRecFlag) < k) {
      }
    }
    if (strip < strips - 1) {
      while (ld_acquire(mine + kStripRecInts + kRecFlag) < k) {
      }
    }
    __threadfence();
  }
  __syncthreads();
  const int* src = nullptr;
  if (t < HT && strip > 0) {
    src = mine - kStripRecInts + kRecX + ((slot * 2 + 1) * HT + t) * X;
  } else if (t >= T - HT && strip < strips - 1) {
    src = mine + kStripRecInts + kRecX + ((slot * 2 + 0) * HT + t - (T - HT)) * X;
  }
  if (src != nullptr) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    const int4 a0 = __ldcg(s4), a1 = __ldcg(s4 + 1);
    const int4 a2 = __ldcg(s4 + 2), a3 = __ldcg(s4 + 3);
    s.ev[0] = a0.x, s.ev[1] = a0.y, s.ev[2] = a0.z, s.ev[3] = a0.w;
    s.ev[4] = a1.x, s.ev[5] = a1.y, s.ev[6] = a1.z, s.ev[7] = a1.w;
    s.od[0] = a2.x, s.od[1] = a2.y, s.od[2] = a2.z, s.od[3] = a2.w;
    s.od[4] = a3.x, s.od[5] = a3.y, s.od[6] = a3.z, s.od[7] = a3.w;
  }
}

// A strip of `width` band lanes [s0, s1) of read b on one CTA of
// width / LPT + 2 * kHaloThreads threads: the window [s0 - H, s1' + H)
// (s1' = s0 + width) runs the "warps" body; its end lanes read their bytes
// by index on every pair (so every lane's bytes are right, the halo's too),
// the band's walls take _NEG from outside, and a CTA swaps its edges with
// its neighbours before every epoch of kStripEpoch diagonals but the
// first.  A wrong value at the window's edge moves one lane inward per
// pair of diagonals, so after an epoch the owned lanes are still exact.
// Goals: each CTA reduces its owned lanes' trackers, the last CTA of the
// read to finish (strip 0's ticket) takes the best of all strips.
template <bool kParents, bool kDashFree, int kMode>
__global__ void __launch_bounds__(kStripMaxThreads, 1)
band_strip_kernel(BandArgs a, StripArgs x) {
  constexpr int LPT = kStripLpt;
  __shared__ Edges e;
  const int tid = static_cast<int>(threadIdx.x);
  const int T = static_cast<int>(blockDim.x);
  const int lane = tid & 31;
  const int strip = static_cast<int>(blockIdx.x) % x.strips;
  Place p;
  p.b = x.b0 + static_cast<int>(blockIdx.x) / x.strips;
  p.W = a.W;
  p.B = a.B;
  p.half = p.W >> 1;
  p.warp = tid >> 5;
  p.nwarps = (T + 31) >> 5;
  p.rank = 0;
  p.nranks = 1;
  const int cnt = min(32, T - 32 * p.warp);  // threads of this warp
  p.mask = cnt == 32 ? 0xffffffffu : (1u << cnt) - 1u;
  p.first = tid == 0;
  p.last = tid == T - 1;
  p.wfirst = lane == 0;
  p.wlast = lane == cnt - 1;
  const int s0 = strip * x.width;
  const int s1 = min(s0 + x.width, p.W);
  const int w0 = s0 - kStripHalo;  // the window's first lane
  p.base = w0 + tid * LPT;
  p.q_w = p.W - 2 * w0;
  p.t_off = 1 - p.half + w0 + T * LPT - 1;
  p.lo_wall = p.base == 0;
  p.hi_wall = p.base + LPT == p.W;
  p.owned = p.base >= s0 && p.base < s1;
  set_read(p, a);

  Lanes<kParents, kDashFree, kMode, LPT, true, false, true> s;
  s.init_lanes(p, a);
  if (p.wlast) e.od[p.warp + 1] = s.od[LPT - 1];
  __syncthreads();

  // Epochs of kStripEpoch diagonals from d = 2; W + 2 starts an epoch
  // (W is a multiple of 128), so an epoch is all border or all interior.
  // d_stop is the read's, so every CTA of the read swaps as often.
  int* rec = x.rec + static_cast<size_t>(p.b) * x.strips * kStripRecInts;
  for (int d0 = 2; d0 <= p.d_stop; d0 += kStripEpoch) {
    if (d0 > 2) strip_swap(s, rec, strip, x.strips, (d0 - 2) / kStripEpoch);
    const int d_end = min(d0 + kStripEpoch, p.d_stop + 1);
    int d = d0;
    if (d0 < p.W + 2) {
#pragma unroll 1
      for (; d + 1 < d_end; d += 2) s.template pair<true>(p, e, a.par, d);
    } else {
#pragma unroll 1
      for (; d + 1 < d_end; d += 2) s.template pair<false>(p, e, a.par, d);
    }
    if (d < d_end) {  // d == d_stop, even: the last diagonal alone
      s.template even<true>(p, e, d);
      if constexpr (kParents) s.store_parents(p, a.par, d);
    }
  }

  int* out = a.out;
  const int W = p.W, B = p.B, b = p.b;
  if constexpr (kMode == 0) {
    const int dg = p.ql + p.tl;
    const int xl = p.tl - p.ql + W - (dg & 1);
    const bool on = dg >= 2 && dg == p.d_stop && xl >= 0 && (xl >> 1) < W;
    const int kg = (xl >> 1) - p.base;
    if (on && p.owned && kg >= 0 && kg < LPT)
      out[b] = (dg & 1) ? pick(s.od, kg) : pick(s.ev, kg);
    if (strip == 0 && tid == 0) {
      if (!on) out[b] = 0;
      out[B + b] = p.ql;
      out[2 * B + b] = p.tl;
    }
    return;
  } else {
    int g[2][3];
    if constexpr (kMode == 1) {
      int c = kNeg, gi = 0, gj = 0;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int i = ((s.best_d[k] + W) >> 1) - (p.base + k);
        const int j = s.best_d[k] - i;
        if (goal_better(s.best[k], i, j, c, gi, gj)) {
          c = s.best[k];
          gi = i;
          gj = j;
        }
      }
      group_best<true>(c, gi, gj, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
      g[0][0] = c, g[0][1] = gi, g[0][2] = gj;
      g[1][0] = g[1][1] = g[1][2] = 0;
    } else {
      int cc = s.cc, ci = s.ci, z0 = 0;
      group_best<true>(cc, ci, z0, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
      int rc = s.rc, rj = s.rj, z1 = 0;
      group_best<true>(rc, rj, z1, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
      g[0][0] = cc, g[0][1] = ci, g[0][2] = z0;
      g[1][0] = rc, g[1][1] = rj, g[1][2] = z1;
    }
    if (tid != 0) return;
    int* mine = rec + strip * kStripRecInts + kRecGoal;
#pragma unroll
    for (int r = 0; r < 6; ++r) mine[r] = g[r / 3][r % 3];
    __threadfence();
    if (atomicAdd(rec + kRecTicket, 1) != x.strips - 1) return;
    // The last strip of the read to finish: every other strip's triples
    // were stored and fenced before its ticket.
    __threadfence();
    for (int r = 0; r < x.strips; ++r) {
      if (r == strip) continue;
      const int* o = rec + r * kStripRecInts + kRecGoal;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c2 = __ldcg(o + 3 * k), i2 = __ldcg(o + 3 * k + 1),
                  j2 = __ldcg(o + 3 * k + 2);
        if (goal_better(c2, i2, j2, g[k][0], g[k][1], g[k][2])) {
          g[k][0] = c2;
          g[k][1] = i2;
          g[k][2] = j2;
        }
      }
    }
    if constexpr (kMode == 1) {
      const bool hit = g[0][0] > kNeg;
      out[b] = hit ? g[0][0] : 0;
      out[B + b] = hit ? g[0][1] : 0;
      out[2 * B + b] = hit ? g[0][2] : 0;
    } else {
      const bool row_wins = g[1][0] > g[0][0];
      out[b] = row_wins ? g[1][0] : g[0][0];
      out[B + b] = row_wins ? p.ql : g[0][1];
      out[2 * B + b] = row_wins ? g[1][1] : p.tl;
    }
  }
}

// ---- epochs path ----------------------------------------------------------

constexpr int kEpochHalo = 64;  // H: halo lanes on each side of a strip
#ifdef BIOINFO1_BAND_EPOCH_TRIAL  // chip_smoke.py --epoch-trial: the other H
constexpr int kEpochTrialHalo = 32;
#endif

struct EpochArgs {
  int* state;  // (B, epoch_state_ints(W, strips)) int32
  int width;   // owned lanes of a strip, a multiple of 128
  int strips;  // ceil(W / width)
  int d0;      // the first diagonal of this launch's epoch (even)
};

// A read's state between two launches, in ints: two slots (slot k & 1
// holds diagonals d0 - 2 and d0 - 1 of every band lane entering epoch k:
// ev at 2W * slot, od at 2W * slot + W), the owned lanes' trackers (local:
// best at 4W + l, best_d at 5W + l; semiGlobal: cc, ci, rc, rj of the
// thread owning lane l at 4W + l / 2), and each strip's goal triples (8
// ints a strip at 6W) for the merge.
__host__ __device__ inline size_t epoch_state_ints(int W, int strips) {
  return 6 * static_cast<size_t>(W) + 8 * static_cast<size_t>(strips);
}

// Epoch k > 0 of a thread's lanes from slot k & 1: its two newest
// diagonals (_NEG past the band's ends: those lanes never reach a band
// lane, the walls see to it), the lanes' bytes on diagonal d0 by index,
// the trackers of an owned thread.
template <int kMode, class L>
__device__ __forceinline__ void epoch_load(L& s, const Place& p,
                                           const BandArgs& a, const int* st,
                                           int d0, int k) {
  constexpr int LPT = kStripLpt, NW = LPT / 4;
  s.match = a.match;
  s.mismatch = a.mismatch;
  s.gap = a.gap;
  s.init = kMode == 0 ? a.gap : 0;
  const size_t W = static_cast<size_t>(p.W);
  if (p.base >= 0 && p.base < p.W) {
    const int4* ev = reinterpret_cast<const int4*>(st + 2 * W * (k & 1) +
                                                   p.base);
    const int4* od = reinterpret_cast<const int4*>(st + 2 * W * (k & 1) + W +
                                                   p.base);
    const int4 a0 = __ldcg(ev), a1 = __ldcg(ev + 1);
    const int4 a2 = __ldcg(od), a3 = __ldcg(od + 1);
    s.ev[0] = a0.x, s.ev[1] = a0.y, s.ev[2] = a0.z, s.ev[3] = a0.w;
    s.ev[4] = a1.x, s.ev[5] = a1.y, s.ev[6] = a1.z, s.ev[7] = a1.w;
    s.od[0] = a2.x, s.od[1] = a2.y, s.od[2] = a2.z, s.od[3] = a2.w;
    s.od[4] = a3.x, s.od[5] = a3.y, s.od[6] = a3.z, s.od[7] = a3.w;
  } else {
#pragma unroll
    for (int x = 0; x < LPT; ++x) s.ev[x] = s.od[x] = kNeg;
  }
  // Lane l holds row i = (d0 + W) / 2 - l and column d0 - i on d0.
  const int i0 = (d0 + p.W) >> 1;
#pragma unroll
  for (int x = 0; x < NW; ++x) {
    s.qw[x] = s.tw[x] = s.pw[x] = 0;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = i0 - (p.base + 4 * x + y);
      s.qw[x] |= p.rd.q_at(i) << (8 * y);
      s.tw[x] |= p.rd.t_at(d0 - i) << (8 * y);
    }
  }
  s.cc = s.ci = s.rc = s.rj = 0;
#pragma unroll
  for (int x = 0; x < LPT; ++x) {
    s.best[x] = kNeg;
    s.best_d[x] = 0;
  }
  if (!p.owned) return;
  if constexpr (kMode == 1) {
    const int4* b = reinterpret_cast<const int4*>(st + 4 * W + p.base);
    const int4* bd = reinterpret_cast<const int4*>(st + 5 * W + p.base);
    const int4 a0 = __ldcg(b), a1 = __ldcg(b + 1);
    const int4 a2 = __ldcg(bd), a3 = __ldcg(bd + 1);
    s.best[0] = a0.x, s.best[1] = a0.y, s.best[2] = a0.z, s.best[3] = a0.w;
    s.best[4] = a1.x, s.best[5] = a1.y, s.best[6] = a1.z, s.best[7] = a1.w;
    s.best_d[0] = a2.x, s.best_d[1] = a2.y, s.best_d[2] = a2.z;
    s.best_d[3] = a2.w, s.best_d[4] = a3.x, s.best_d[5] = a3.y;
    s.best_d[6] = a3.z, s.best_d[7] = a3.w;
  } else if constexpr (kMode == 2) {
    const int4 g = __ldcg(reinterpret_cast<const int4*>(st + 4 * W +
                                                        p.base / 2));
    s.cc = g.x, s.ci = g.y, s.rc = g.z, s.rj = g.w;
  }
}

// The end of epoch k (not a read's last): an owned thread stores its two
// newest diagonals into slot (k + 1) & 1 and its trackers.  Its
// neighbours read slot k & 1 in this launch, never the one written here.
template <int kMode, class L>
__device__ __forceinline__ void epoch_store(const L& s, const Place& p,
                                            int* st, int k) {
  if (!p.owned) return;
  const size_t W = static_cast<size_t>(p.W);
  int4* ev = reinterpret_cast<int4*>(st + 2 * W * ((k + 1) & 1) + p.base);
  int4* od = reinterpret_cast<int4*>(st + 2 * W * ((k + 1) & 1) + W +
                                     p.base);
  ev[0] = make_int4(s.ev[0], s.ev[1], s.ev[2], s.ev[3]);
  ev[1] = make_int4(s.ev[4], s.ev[5], s.ev[6], s.ev[7]);
  od[0] = make_int4(s.od[0], s.od[1], s.od[2], s.od[3]);
  od[1] = make_int4(s.od[4], s.od[5], s.od[6], s.od[7]);
  if constexpr (kMode == 1) {
    int4* b = reinterpret_cast<int4*>(st + 4 * W + p.base);
    int4* bd = reinterpret_cast<int4*>(st + 5 * W + p.base);
    b[0] = make_int4(s.best[0], s.best[1], s.best[2], s.best[3]);
    b[1] = make_int4(s.best[4], s.best[5], s.best[6], s.best[7]);
    bd[0] = make_int4(s.best_d[0], s.best_d[1], s.best_d[2], s.best_d[3]);
    bd[1] = make_int4(s.best_d[4], s.best_d[5], s.best_d[6], s.best_d[7]);
  } else if constexpr (kMode == 2) {
    *reinterpret_cast<int4*>(st + 4 * W + p.base / 2) =
        make_int4(s.cc, s.ci, s.rc, s.rj);
  }
}

// One epoch of K2's "epochs" path: diagonals [d0, d0 + 2H) of strip
// blockIdx.x % strips of read blockIdx.x / strips, on a CTA of width / LPT
// + 2H / LPT threads running the strip path's body over the window
// [s0 - H, s0 + width + H).  It loads the window from slot k & 1 of its
// read's state (its own lanes and its neighbours'), runs E = 2H diagonals
// alone (a wrong value at the window's edge moves one lane inward per pair
// of diagonals, so the owned lanes stay exact) and stores its owned lanes
// into slot (k + 1) & 1.  No CTA waits on another: the launches of the
// epochs follow each other on one stream, and that order is the only
// synchronisation.  A read's last epoch (the one holding d_stop) writes
// the global goal's value, or each strip's goal triples for the merge.
template <bool kDashFree, int kMode, int H>
__global__ void __launch_bounds__(kStripMaxWidth / kStripLpt + 2 * H /
                                                                   kStripLpt,
                                  1)
band_epoch_kernel(BandArgs a, EpochArgs x) {
  constexpr int LPT = kStripLpt, E = 2 * H;
  static_assert(H % LPT == 0 && 128 % E == 0,
                "E divides every W: W + 2 starts an epoch");
  __shared__ Edges e;
  const int tid = static_cast<int>(threadIdx.x);
  const int T = static_cast<int>(blockDim.x);
  const int lane = tid & 31;
  const int strip = static_cast<int>(blockIdx.x) % x.strips;
  Place p;
  p.b = static_cast<int>(blockIdx.x) / x.strips;
  p.W = a.W;
  p.B = a.B;
  set_read(p, a);
  const int d0 = x.d0;
  if (d0 > p.d_stop) return;  // the read is done (uniform over the CTA)
  p.half = p.W >> 1;
  p.warp = tid >> 5;
  p.nwarps = (T + 31) >> 5;
  p.rank = 0;
  p.nranks = 1;
  const int cnt = min(32, T - 32 * p.warp);  // threads of this warp
  p.mask = cnt == 32 ? 0xffffffffu : (1u << cnt) - 1u;
  p.first = tid == 0;
  p.last = tid == T - 1;
  p.wfirst = lane == 0;
  p.wlast = lane == cnt - 1;
  const int s0 = strip * x.width;
  const int s1 = min(s0 + x.width, p.W);
  const int w0 = s0 - H;  // the window's first lane
  p.base = w0 + tid * LPT;
  p.q_w = p.W - 2 * w0;
  p.t_off = 1 - p.half + w0 + T * LPT - 1;
  p.lo_wall = p.base == 0;
  p.hi_wall = p.base + LPT == p.W;
  p.owned = p.base >= s0 && p.base < s1;
  int* st = x.state + static_cast<size_t>(p.b) *
                          epoch_state_ints(p.W, x.strips);
  const int k = (d0 - 2) / E;

  Lanes<false, kDashFree, kMode, LPT, true, false, true> s;
  if (k == 0) {
    s.init_lanes(p, a);
  } else {
    epoch_load<kMode>(s, p, a, st, d0, k);
  }
  if (p.wlast) e.od[p.warp + 1] = s.od[LPT - 1];
  __syncthreads();

  // d_stop is the read's, so every CTA of the read runs as many epochs.
  const int d_end = min(d0 + E, p.d_stop + 1);
  int d = d0;
  if (d0 < p.W + 2) {
#pragma unroll 1
    for (; d + 1 < d_end; d += 2) s.template pair<true>(p, e, nullptr, d);
  } else {
#pragma unroll 1
    for (; d + 1 < d_end; d += 2) s.template pair<false>(p, e, nullptr, d);
  }
  if (d < d_end) s.template even<true>(p, e, d);  // d == d_stop, even
  if (d_end <= p.d_stop) {
    epoch_store<kMode>(s, p, st, k);
    return;
  }

  // The read's last epoch.
  const int W = p.W;
  if constexpr (kMode == 0) {
    // The goal cell's value; band_epoch_merge_kernel writes the rest.
    const int dg = p.ql + p.tl;
    const int xl = p.tl - p.ql + W - (dg & 1);
    const bool on = dg >= 2 && dg == p.d_stop && xl >= 0 && (xl >> 1) < W;
    const int kg = (xl >> 1) - p.base;
    if (on && p.owned && kg >= 0 && kg < LPT)
      a.out[p.b] = (dg & 1) ? pick(s.od, kg) : pick(s.ev, kg);
  } else {
    int g[2][3];
    if constexpr (kMode == 1) {
      int c = kNeg, gi = 0, gj = 0;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int i = ((s.best_d[j] + W) >> 1) - (p.base + j);
        const int jj = s.best_d[j] - i;
        if (goal_better(s.best[j], i, jj, c, gi, gj)) {
          c = s.best[j];
          gi = i;
          gj = jj;
        }
      }
      group_best<true>(c, gi, gj, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
      g[0][0] = c, g[0][1] = gi, g[0][2] = gj;
      g[1][0] = g[1][1] = g[1][2] = 0;
    } else {
      int cc = s.cc, ci = s.ci, z0 = 0;
      group_best<true>(cc, ci, z0, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
      int rc = s.rc, rj = s.rj, z1 = 0;
      group_best<true>(rc, rj, z1, p.mask, lane, cnt, p.warp, p.nwarps,
                       e.goal);
      g[0][0] = cc, g[0][1] = ci, g[0][2] = z0;
      g[1][0] = rc, g[1][1] = rj, g[1][2] = z1;
    }
    if (tid == 0) {
      int* mine = st + 6 * static_cast<size_t>(W) + 8 * strip;
#pragma unroll
      for (int r = 0; r < 6; ++r) mine[r] = g[r / 3][r % 3];
    }
  }
}

// After the last epoch, one thread a read: global mode writes the goal
// cell (its value when the goal is off the sweep or the band, 0); local
// and semiGlobal merge the strips' goal triples under the cluster path's
// total order.  A read with d_stop < 2 ran no epoch: its trackers are
// where they started.
template <int kMode>
__global__ void band_epoch_merge_kernel(BandArgs a, EpochArgs x) {
  const int b = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (b >= a.B) return;
  Place p;
  p.b = b;
  set_read(p, a);
  const int W = a.W, B = a.B;
  int* out = a.out;
  if constexpr (kMode == 0) {
    const int dg = p.ql + p.tl;
    const int xl = p.tl - p.ql + W - (dg & 1);
    const bool on = dg >= 2 && dg == p.d_stop && xl >= 0 && (xl >> 1) < W;
    if (!on) out[b] = 0;
    out[B + b] = p.ql;
    out[2 * B + b] = p.tl;
  } else {
    int g[2][3] = {{kMode == 1 ? kNeg : 0, 0, 0}, {0, 0, 0}};
    if (p.d_stop >= 2) {
      const int* rec = x.state + static_cast<size_t>(b) *
                                     epoch_state_ints(W, x.strips) +
                       6 * static_cast<size_t>(W);
      for (int r = 0; r < x.strips; ++r) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int* o = rec + 8 * r + 3 * k;
          if (goal_better(o[0], o[1], o[2], g[k][0], g[k][1], g[k][2])) {
            g[k][0] = o[0];
            g[k][1] = o[1];
            g[k][2] = o[2];
          }
        }
      }
    }
    if constexpr (kMode == 1) {
      const bool hit = g[0][0] > kNeg;
      out[b] = hit ? g[0][0] : 0;
      out[B + b] = hit ? g[0][1] : 0;
      out[2 * B + b] = hit ? g[0][2] : 0;
    } else {
      const bool row_wins = g[1][0] > g[0][0];
      out[b] = row_wins ? g[1][0] : g[0][0];
      out[B + b] = row_wins ? p.ql : g[0][1];
      out[2 * B + b] = row_wins ? g[1][1] : p.tl;
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

enum BandPath {
  kPathWarp = 0,
  kPathWarps = 1,
  kPathScratch = 2,
  kPathCluster = 3,
  kPathStrip = 4,
  kPathEpochs = 5
};

using RegKernel = void (*)(BandArgs);

template <bool kParents, bool kDashFree, int LPT, bool kMulti, bool kCluster>
RegKernel reg_kernel(int mode) {
  if (mode == 0) return band_reg_kernel<kParents, kDashFree, 0, LPT, kMulti,
                                        kCluster>;
  if (mode == 1) return band_reg_kernel<kParents, kDashFree, 1, LPT, kMulti,
                                        kCluster>;
  return band_reg_kernel<kParents, kDashFree, 2, LPT, kMulti, kCluster>;
}

// The launch of the "cluster" path: B clusters of `cluster` CTAs of
// W / (LPT * cluster) threads.  A cluster the card cannot hold is an error
// (cudaErrorLaunchOutOfResources), never a reason to take another path.
template <int LPT>
cudaError_t cluster_config(const BandArgs& a, int cluster,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  const int nthr = a.W / LPT;
  if (a.W % LPT != 0 || cluster < 2 || cluster > kMaxCluster ||
      nthr % cluster != 0 || nthr / cluster > kRegMaxW / LPT || a.mode < 0 ||
      a.mode > 2)
    return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(a.B * cluster), 1, 1);
  cfg->blockDim = dim3(static_cast<unsigned>(nthr / cluster), 1, 1);
  cfg->dynamicSmemBytes = 0;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <bool kParents, bool kDashFree, int LPT>
int launch_cluster(const BandArgs& a, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config<LPT>(a, cluster, stream, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const RegKernel kern = reg_kernel<kParents, kDashFree, LPT, true, true>(
      a.mode);
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

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
    band_reg_kernel<kParents, kDashFree, 0, LPT, kMulti, false>
        <<<grid, block, 0, stream>>>(a);
  } else if (a.mode == 1) {
    band_reg_kernel<kParents, kDashFree, 1, LPT, kMulti, false>
        <<<grid, block, 0, stream>>>(a);
  } else {
    band_reg_kernel<kParents, kDashFree, 2, LPT, kMulti, false>
        <<<grid, block, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

using StripKernel = void (*)(BandArgs, StripArgs);

template <bool kParents, bool kDashFree>
StripKernel strip_kernel(int mode) {
  if (mode == 0) return band_strip_kernel<kParents, kDashFree, 0>;
  if (mode == 1) return band_strip_kernel<kParents, kDashFree, 1>;
  return band_strip_kernel<kParents, kDashFree, 2>;
}

// The launches of the "strip" path: ceil(W / width) CTAs of width / LPT +
// 2 * kHaloThreads threads per read, reads_per_launch reads a cooperative
// launch (every CTA of a launch is resident at once, so a strip may wait
// on its neighbours); the launches run one after the other on the stream.
// A launch the card cannot hold at once is an error
// (cudaErrorCooperativeLaunchTooLarge), never a reason to take another
// path.
template <bool kParents, bool kDashFree>
int launch_strips(const BandArgs& a, int width, int reads_per_launch,
                  int* rec, cudaStream_t stream) {
  if (width % 128 != 0 || width < 128 || width > kStripMaxWidth ||
      a.W % 128 != 0 || reads_per_launch < 1 || rec == nullptr ||
      a.mode < 0 || a.mode > 2)
    return cudaErrorInvalidValue;
  StripArgs x;
  x.rec = rec;
  x.width = width;
  x.strips = (a.W + width - 1) / width;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(static_cast<unsigned>(width / kStripLpt +
                                            2 * kHaloThreads), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const StripKernel kern = strip_kernel<kParents, kDashFree>(a.mode);
  for (int b0 = 0; b0 < a.B; b0 += reads_per_launch) {
    x.b0 = b0;
    const int nb = min(reads_per_launch, a.B - b0);
    cfg.gridDim = dim3(static_cast<unsigned>(nb * x.strips), 1, 1);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a, x);
    if (e != cudaSuccess) {
      // The runtime also records a refused launch as the last error:
      // take it here, or the next entry point would report it as its own.
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

using EpochKernel = void (*)(BandArgs, EpochArgs);

template <bool kDashFree, int H>
EpochKernel epoch_kernel(int mode) {
  if (mode == 0) return band_epoch_kernel<kDashFree, 0, H>;
  if (mode == 1) return band_epoch_kernel<kDashFree, 1, H>;
  return band_epoch_kernel<kDashFree, 2, H>;
}

// The launches of the "epochs" path (K2 only): one launch of B * strips
// CTAs of width / LPT + 2H / LPT threads per epoch of 2H diagonals, from
// d = 2 to the last diagonal any read may reach (n_steps + 1; a read past
// its own d_stop leaves at once), then the merge; all on `stream`, so each
// epoch starts after the one before has ended.  No cooperative attribute:
// the card runs a launch's CTAs in as many waves as it needs.
template <bool kDashFree, int H>
int launch_epochs_h(const BandArgs& a, EpochArgs x, cudaStream_t stream) {
  const EpochKernel kern = epoch_kernel<kDashFree, H>(a.mode);
  const dim3 grid(static_cast<unsigned>(a.B * x.strips), 1, 1);
  const dim3 block(static_cast<unsigned>(x.width / kStripLpt +
                                         2 * H / kStripLpt), 1, 1);
  for (int d0 = 2; d0 <= a.n_steps + 1; d0 += 2 * H) {
    x.d0 = d0;
    kern<<<grid, block, 0, stream>>>(a, x);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 mgrid(static_cast<unsigned>((a.B + 127) / 128), 1, 1);
  const dim3 mblock(128, 1, 1);
  if (a.mode == 0) {
    band_epoch_merge_kernel<0><<<mgrid, mblock, 0, stream>>>(a, x);
  } else if (a.mode == 1) {
    band_epoch_merge_kernel<1><<<mgrid, mblock, 0, stream>>>(a, x);
  } else {
    band_epoch_merge_kernel<2><<<mgrid, mblock, 0, stream>>>(a, x);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kDashFree>
int launch_epochs(const BandArgs& a, int width, int halo, int* state,
                  cudaStream_t stream) {
  if (width % 128 != 0 || width < 128 || width > kStripMaxWidth ||
      a.W % 128 != 0 || state == nullptr || a.mode < 0 || a.mode > 2)
    return cudaErrorInvalidValue;
  EpochArgs x;
  x.state = state;
  x.width = width;
  x.strips = (a.W + width - 1) / width;
  x.d0 = 2;
  if (halo == kEpochHalo) return launch_epochs_h<kDashFree, kEpochHalo>(
      a, x, stream);
#ifdef BIOINFO1_BAND_EPOCH_TRIAL
  if (halo == kEpochTrialHalo)
    return launch_epochs_h<kDashFree, kEpochTrialHalo>(a, x, stream);
#endif
  return cudaErrorInvalidValue;
}

// The plan (path, lanes per thread, reads per CTA - the cluster size on
// the "cluster" path, the strip width on the "strip" and "epochs" paths -
// and shared bytes - reads per launch on the "strip" path, the halo on the
// "epochs" path) comes from ops/band.band_plan; a plan no kernel was built
// for is refused.
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
  if (path == kPathCluster && lpt == 8)     // W <= kRegMaxW * kMaxCluster
    return dash_free ? launch_cluster<kParents, true, 8>(a, reads_per_cta, st)
                     : launch_cluster<kParents, false, 8>(a, reads_per_cta,
                                                          st);
  if (path == kPathStrip && lpt == kStripLpt) {  // past the cluster path
    int* rec = static_cast<int*>(scratch);
    return dash_free ? launch_strips<kParents, true>(a, reads_per_cta,
                                                     smem_bytes, rec, st)
                     : launch_strips<kParents, false>(a, reads_per_cta,
                                                      smem_bytes, rec, st);
  }
  if (path == kPathEpochs && lpt == kStripLpt && !kParents) {  // K2 only
    int* state = static_cast<int*>(scratch);
    return dash_free ? launch_epochs<true>(a, reads_per_cta, smem_bytes,
                                           state, st)
                     : launch_epochs<false>(a, reads_per_cta, smem_bytes,
                                            state, st);
  }
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
// lpt, reads_per_cta (the cluster size on the "cluster" path, the strip
// width on the "strip" and "epochs" paths) and smem_bytes (reads per
// launch on the "strip" path, the halo on the "epochs" path) are
// ops/band.band_plan's; scratch is (B, 3 * W) int32 on the scratch path
// when smem_bytes == 0, (B, strips * kStripRecInts) int32 of zeros on the
// "strip" path, (B, epoch_state_ints(W, strips)) int32 on the "epochs"
// path, else unused.
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

// How many clusters of the "cluster" path the card holds at once
// (cudaOccupancyMaxActiveClusters) for `cluster` CTAs of `threads` threads,
// K2 (parents 0) or K4, in `mode`, into *out.
extern "C" int bioinfo1_band_cluster_occupancy(int parents, int mode,
                                               int cluster, int threads,
                                               int* out) {
  BandArgs a{};
  a.W = threads * cluster * 8;
  a.B = 1;
  a.mode = mode;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config<8>(a, cluster, nullptr, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (parents) {
    e = cudaOccupancyMaxActiveClusters(
        out, reg_kernel<true, true, 8, true, true>(mode), &cfg);
  } else {
    e = cudaOccupancyMaxActiveClusters(
        out, reg_kernel<false, true, 8, true, true>(mode), &cfg);
  }
  return static_cast<int>(e);
}

// How many CTAs of the "strip" path an SM of the current device holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at `threads`
// threads, K2 (parents 0) or K4, in `mode`, with or without `dash_free`,
// into *out (ops/band.strip_card sizes the cooperative launches by it).
extern "C" int bioinfo1_band_strip_occupancy(int parents, int mode,
                                             int dash_free, int threads,
                                             int* out) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const StripKernel k =
      parents ? (dash_free ? strip_kernel<true, true>(mode)
                           : strip_kernel<true, false>(mode))
              : (dash_free ? strip_kernel<false, true>(mode)
                           : strip_kernel<false, false>(mode));
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, threads, 0));
}

// The ints of one strip's record in the "strip" path's scratch
// (kStripRecInts), into *out: ops/band sizes the scratch by it.
extern "C" int bioinfo1_band_strip_rec_ints(int* out) {
  *out = kStripRecInts;
  return static_cast<int>(cudaSuccess);
}
