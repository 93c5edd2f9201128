// K1 - LIS chaining of seed matches, one CTA per match row, as a two-level
// chunked DP.
//
// Replaces the Pallas kernel bioinfo1_tpu/ops/pallas_chain.py `_kernel`
// (reached through `lis_chain` / `lis_chain_sorted`).  Same contract as
// bioinfo1_tpu/ops/chain.py `lis_chain`: j < i is a predecessor of i iff
//   r_j < r_i < r_j + 5000  and  f_j < f_i < f_j + 5000;
// the earliest j among the longest predecessors wins, the chain end is the
// first argmax of lis, and only the chain's endpoints are returned.
// Positions are match coordinates in [0, 2^31): the window tests subtract
// in 32 unsigned bits.
//
// State per match is packed as (lis << 16) | (0xFFFF - j) in 32 unsigned
// bits, so one max picks the highest lis and, among ties, the smallest j;
// max is associative, so the order survives splitting the predecessors
// over the two phases below.  The predecessor is ~best & 0xFFFF, which is
// 0xFFFF ("none") for best = 0; it is kept as a uint16 (these paths take
// N <= 65535, so j <= 65534).  The wide path (N up to kWideMaxN) packs
// (lis << 32) | (0xFFFFFFFF - j) in 64 bits, in the same order, and keeps
// prev as a uint32 (0xFFFFFFFF: none) and q_lo (below) as an int32.
//
// What bounds it on the card: the DP is a true dependency from match to
// match, so the time is the serial chain, not the pair tests.  The first
// design paid three CTA barriers and two block reductions per match.  This
// one takes the TPU kernel's two levels (pallas_chain.py:13-32) to warps:
//  * chunks of kC = 32 matches, one per lane.  Before the DP, each chunk's
//    f min / max over its valid matches, and from them q_lo[k], the first
//    chunk q < k with fmax[q] > fmin[k] - 5000 and fmin[q] < fmax[k]
//    (pallas_chain.py:104-117).  A predecessor j (chunk q) of i (chunk k)
//    has fmax[q] >= f_j > f_i - 5000 >= fmin[k] - 5000 and fmin[q] <= f_j
//    < f_i <= fmax[k], so no chunk before q_lo[k] holds one: the skip is
//    exact whatever the order of f.
//  * cross phase, every warp: lane c takes column i = 32k + c; the warps
//    split chunks [q_lo[k], k) and test each of their j (one broadcast
//    load of f_j, r_j and the packed state, four j at a time) against
//    their column, keeping the largest qualifying state, into
//    part[warp][c].  They also split the chunk's own pairs: bit s of
//    link_part[warp][c] is set when match c precedes column s.  One
//    __syncthreads.
//  * serial phase, warp 0 alone: lane c folds part[.][c] into ext_c and
//    link_part[.][c] into the columns it precedes; then for each column s
//    in order, the lanes c < s that precede it offer their state, one
//    __reduce_max_sync picks the best, and lane s packs max(best, ext_s).
//    No CTA barrier inside; one __syncthreads after the chunk's states are
//    stored.  Two CTA barriers per 32 matches in all.
//  * warp 0 keeps the running max of the states, the chain end; lane 0
//    chases prev back to the root.
// Rows are independent CTAs, so the TPU's row sort by count
// (lis_chain_sorted) is not needed: a short row finishes early.
//
// Storage, by path (ops/chain.chain_plan; the bytes are computed here too):
//  kShared   f, r, the packed states and prev in shared memory;
//  kState    f and r read from the inputs (__ldg; L1 and L2 serve the
//            rereads), states and prev in shared memory;
//  kScratch  states and prev in global scratch rows of n_pad entries;
//  kWide     64-bit states, 32-bit prev and q_lo as 32-bit chunk indices
//            in global scratch rows (N > 65535: ops/chain.chain_plan); no
//            dynamic shared memory.  The chunk bounds, and their running
//            max, sit in the states' row until the DP overwrites it.  Its
//            serial scan reduces a 32-bit key, (lis << 5) | (31 - lane):
//            lanes are in j order, so one max still picks the highest lis
//            and the smallest j among ties; the chain end is a per-lane max,
//            reduced once at the end.  The key holds lis < 2^27, which sets
//            kWideMaxN.  A row of K chunks would pay ~K^2 / 64 ballots
//            finding q_lo from chunk 0 (74 M on a dense row of 2.2 M
//            matches), so each chunk's scan starts at a 32-way search of
//            the running max of fmax: no chunk before the first one whose
//            running max passes fmin[k] - 5000 qualifies, so q_lo is the
//            same.
// On the three narrow paths q_lo is in shared memory (a uint16 chunk
// index), and so are the chunk bounds on kShared and kState.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kGapCap = 5000;
constexpr int kC = 32;              // matches per chunk: one per lane
constexpr int kMaxWarps = 16;
constexpr unsigned kJMask = 0xFFFFu;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kWideNone = 0xFFFFFFFFu;   // the wide path's "no prev"
// The wide path's largest N: lis <= N must fit the 27 bits its serial
// scan's key leaves it; n_pad, chunk and match indices stay within int32.
constexpr int kWideMaxN = (1 << 27) - 1;
enum Path { kShared = 0, kState = 1, kScratch = 2, kWide = 3 };

// A match's packed state and its stored predecessor, by path.
template <int kPath>
using StateT =
    std::conditional_t<kPath == kWide, unsigned long long, unsigned>;
template <int kPath>
using PrevT = std::conditional_t<kPath == kWide, unsigned, unsigned short>;
// A chunk's q_lo: a uint16 in shared memory, an int32 in global scratch.
template <int kPath>
using QloT = std::conditional_t<kPath == kWide, int, unsigned short>;

__host__ __device__ inline int pad_n(int N) { return (N + kC - 1) / kC * kC; }
// uint16 slots of q_lo, one per chunk: whole 16-byte groups, so what
// follows stays 16-byte aligned.
__host__ __device__ inline int qlo_slots(int N) {
  return (pad_n(N) / kC + 7) / 8 * 8;
}

// Dynamic shared bytes of a path (ops/chain.chain_plan mirrors this): q_lo,
// then f, r, states and prev (kShared), states and prev (kState) or the
// chunk bounds (kScratch; on kShared and kState they sit in the states'
// space until the DP starts); none on kWide, which keeps all of it in
// global scratch.
size_t smem_bytes(int path, int N) {
  const size_t n_pad = pad_n(N), head = 2 * size_t(qlo_slots(N));
  if (path == kShared) return head + 14 * n_pad;
  if (path == kState) return head + 6 * n_pad;
  if (path == kWide) return 0;
  return head + 8 * (n_pad / kC);
}

// Is j (its f and r) a predecessor of a column whose f - 1, r - 1 are
// fi1, ri1?  1 <= f_i - f_j <= 4999 and the same for r.
__device__ __forceinline__ bool qualifies(unsigned fj, unsigned rj,
                                          unsigned fi1, unsigned ri1) {
  return fi1 - fj < kGapCap - 1u && ri1 - rj < kGapCap - 1u;
}

template <int kPath>
__device__ __forceinline__ uint4 load4(const unsigned* p) {
  if (kPath == kShared) return *reinterpret_cast<const uint4*>(p);
  // Input rows start anywhere (N need not be a multiple of 4).
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

#ifdef BIOINFO1_CHAIN_PROFILE
// Measurement build only (chip_smoke.py --chain-profile): thread 0 of
// block 0 adds the SM clocks of each phase here: prologue, cross phase
// with the chunk's links (to the first barrier), partials folded, serial
// scan, stores and the second barrier, end of row; then the total, the
// globaltimer ns and the chunks.
__device__ unsigned long long g_chain_profile[9];
#endif

// prev[j].  On the shared-memory paths by an explicit ld.shared from an
// address formed once: nvcc otherwise forms the shared window's base again
// (S2UR and six uniform operations) in every step of the chase.
template <int kPath>
__device__ __forceinline__ unsigned shared_base(const unsigned short* prev) {
  if (kPath == kScratch) return 0;
  return static_cast<unsigned>(__cvta_generic_to_shared(prev));
}

template <int kPath>
__device__ __forceinline__ unsigned prev_at(const unsigned short* prev,
                                            unsigned base, int j) {
  if (kPath == kScratch) return prev[j];
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(base + 2u * j));
  return v;
}

template <typename S>
__device__ __forceinline__ S take(S best, unsigned fj, unsigned rj, S pj,
                                  unsigned fi1, unsigned ri1) {
  return qualifies(fj, rj, fi1, ri1) && pj > best ? pj : best;
}

template <int kPath>
__global__ void lis_chain_kernel(const int* __restrict__ f_pos,
                                 const int* __restrict__ r_pos,
                                 const int* __restrict__ count, int R, int N,
                                 StateT<kPath>* __restrict__ packed_g,
                                 PrevT<kPath>* __restrict__ prev_g,
                                 int* __restrict__ qlo_g,
                                 int* __restrict__ out) {
  using State = StateT<kPath>;
  using Prev = PrevT<kPath>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ State part[kMaxWarps][kC];
  __shared__ unsigned link_part[kMaxWarps][kC];
  const int row = blockIdx.x;
#ifdef BIOINFO1_CHAIN_PROFILE
  const bool profiled = blockIdx.x == 0 && threadIdx.x == 0;
  const long long t_start = clock64();
  long long t_mark = t_start, spent[6] = {0, 0, 0, 0, 0, 0};
  unsigned long long ns_start;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_start));
#define PROFILE_MARK(n)                  \
  if (profiled) {                        \
    const long long t_now = clock64();   \
    spent[n] += t_now - t_mark;          \
    t_mark = t_now;                      \
  }
#else
#define PROFILE_MARK(n)
#endif
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cnt = min(max(count[row], 0), N);
  const int K = (cnt + kC - 1) / kC;
  const int n_pad = pad_n(N);
  const unsigned* fg =
      reinterpret_cast<const unsigned*>(f_pos) + static_cast<size_t>(row) * N;
  const unsigned* rg =
      reinterpret_cast<const unsigned*>(r_pos) + static_cast<size_t>(row) * N;

  unsigned short* qlo_s = reinterpret_cast<unsigned short*>(smem);
  unsigned* tail = reinterpret_cast<unsigned*>(qlo_s + qlo_slots(N));
  QloT<kPath>* qlo;
  if constexpr (kPath == kWide) {
    qlo = qlo_g + static_cast<size_t>(row) * (n_pad / kC);
  } else {
    qlo = qlo_s;
  }
  const unsigned* f = fg;
  const unsigned* r = rg;
  State* packed;
  if constexpr (kPath == kShared) {
    f = tail;
    r = tail + n_pad;
    packed = tail + 2 * n_pad;
  } else if constexpr (kPath == kState) {
    packed = tail;
  } else {
    packed = packed_g + static_cast<size_t>(row) * n_pad;
  }
  Prev* prev = kPath >= kScratch
                   ? prev_g + static_cast<size_t>(row) * n_pad
                   : reinterpret_cast<Prev*>(packed + n_pad);
  // Chunk f bounds: in the states' space until the DP overwrites it.
  int* fmin = kPath == kScratch ? reinterpret_cast<int*>(tail)
                                : reinterpret_cast<int*>(packed);
  int* fmax = fmin + n_pad / kC;

  // Chunk bounds over the valid matches (f and r staged on kShared).
  for (int k = warp; k < K; k += nwarps) {
    const int j = k * kC + lane;
    const bool v = j < cnt;
    const unsigned fj = v ? __ldg(fg + j) : 0u;
    if (kPath == kShared) {
      tail[j] = fj;
      tail[n_pad + j] = v ? __ldg(rg + j) : 0u;
    }
    const int lo = __reduce_min_sync(kFull, v ? int(fj) : INT_MAX);
    const int hi = __reduce_max_sync(kFull, v ? int(fj) : INT_MIN);
    if (lane == 0) {
      fmin[k] = lo;
      fmax[k] = hi;
    }
  }
  __syncthreads();
  // kWide: the running max of fmax, after the bounds in the states' row;
  // warp 0, 32 chunks a step.
  int* fpm = fmax + n_pad / kC;
  if constexpr (kPath == kWide) {
    if (warp == 0) {
      int carry = INT_MIN;
      for (int base = 0; base < K; base += kC) {
        const int q = base + lane;
        int v = q < K ? fmax[q] : INT_MIN;
#pragma unroll
        for (int o = 1; o < kC; o <<= 1) {
          const int u = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v = max(v, u);
        }
        v = max(v, carry);
        if (q < K) fpm[q] = v;
        carry = __shfl_sync(kFull, v, kC - 1);
      }
    }
    __syncthreads();
  }
  // q_lo[k]: the first qualifying chunk, 32 candidates a ballot.
  for (int k = warp; k < K; k += nwarps) {
    const long long lo_k = static_cast<long long>(fmin[k]) - kGapCap;
    const int hi_k = fmax[k];
    int q_lo = k;
    int start = 0;
    if constexpr (kPath == kWide) {
      // The first q < k whose running max passes lo_k (else k), in [lo,
      // hi]: probes lo + t * step for lanes t, ~32 times narrower a step.
      int lo = 0, hi = k;
      while (hi - lo > kC) {
        const int step = (hi - lo + kC - 1) / kC;
        const int p = lo + lane * step;
        const bool in = p < hi;
        const unsigned hit = __ballot_sync(kFull, in && fpm[p] > lo_k);
        if (hit) {
          const int t = __ffs(hit) - 1;
          hi = lo + t * step;
          if (t) lo += (t - 1) * step + 1;
        } else {
          lo += (31 - __clz(__ballot_sync(kFull, in))) * step + 1;
        }
      }
      const unsigned hit =
          __ballot_sync(kFull, lo + lane < hi && fpm[lo + lane] > lo_k);
      start = hit ? lo + __ffs(hit) - 1 : hi;
    }
    for (int base = start; base < k; base += kC) {
      const int q = base + lane;
      const unsigned hit = __ballot_sync(
          kFull, q < k && fmax[q] > lo_k && fmin[q] < hi_k);
      if (hit) {
        q_lo = base + __ffs(hit) - 1;
        break;
      }
    }
    if (lane == 0) qlo[k] = q_lo;
  }
  __syncthreads();

  State chain_end = 0;  // warp 0: the largest state so far (kWide: a lane's)
  PROFILE_MARK(0);
  for (int k = 0; k < K; ++k) {
    const int i = k * kC + lane;
    const bool vi = i < cnt;
    const int n_cols = min(kC, cnt - k * kC);
    const unsigned fi = vi ? f[i] : 0u, ri = vi ? r[i] : 0u;
    const unsigned fi1 = fi - 1u, ri1 = ri - 1u;

    // Cross phase: predecessors in chunks [q_lo, k), split over the warps
    // in eighths of 4 loads of f, r and states (8 predecessors) each.
    State best = 0;
    for (int u = qlo[k] * 4 + warp; u < k * 4; u += nwarps) {
      const unsigned* fu = f + u * 8;
      const unsigned* ru = r + u * 8;
      const State* pu = packed + u * 8;
#pragma unroll
      for (int jj = 0; jj < 8; jj += 4) {
        const uint4 fj = load4<kPath>(fu + jj);
        const uint4 rj = load4<kPath>(ru + jj);
        if constexpr (kPath == kWide) {
          const ulonglong2 pa = *reinterpret_cast<const ulonglong2*>(pu + jj);
          const ulonglong2 pb =
              *reinterpret_cast<const ulonglong2*>(pu + jj + 2);
          best = take(best, fj.x, rj.x, pa.x, fi1, ri1);
          best = take(best, fj.y, rj.y, pa.y, fi1, ri1);
          best = take(best, fj.z, rj.z, pb.x, fi1, ri1);
          best = take(best, fj.w, rj.w, pb.y, fi1, ri1);
        } else {
          const uint4 pj = *reinterpret_cast<const uint4*>(pu + jj);
          best = take(best, fj.x, rj.x, pj.x, fi1, ri1);
          best = take(best, fj.y, rj.y, pj.y, fi1, ri1);
          best = take(best, fj.z, rj.z, pj.z, fi1, ri1);
          best = take(best, fj.w, rj.w, pj.w, fi1, ri1);
        }
      }
    }
    // The chunk's own links, split over the warps too: bit s of `link` is
    // set when this lane's match is a predecessor of column s.
    unsigned link = 0;
    for (int s = warp; s < n_cols; s += nwarps) {
      const bool ok = lane < s && qualifies(fi, ri, f[k * kC + s] - 1u,
                                            r[k * kC + s] - 1u);
      link |= (ok ? 1u : 0u) << s;
    }
    part[warp][lane] = best;
    link_part[warp][lane] = link;
    __syncthreads();
    PROFILE_MARK(1);

    // Serial phase: warp 0 resolves the chunk's columns in order.
    if (warp == 0) {
      State ext = 0;
      unsigned succ = 0;
      for (int w = 0; w < nwarps; ++w) {
        ext = max(ext, part[w][lane]);
        succ |= link_part[w][lane];
      }
      PROFILE_MARK(2);
      if constexpr (kPath == kWide) {
        // The best offer of a column is the key (lis << 5) | (31 - c) of
        // lane c; its state's low word is lo31 + (31 - c), lo31 that of
        // lane 31's match.  lis <= N < 2^27, so the key fits.
        const unsigned lo31 = kWideNone - (k * kC + kC - 1);
        unsigned key = 0;
        State got = 0;
#pragma unroll 1
        for (int s = 0; s < n_cols; ++s) {
          const unsigned b =
              __reduce_max_sync(kFull, (succ >> s) & 1u ? key : 0u);
          const State v = max(
              b ? (State(b >> 5) << 32) | (lo31 + (b & (kC - 1))) : State(0),
              ext);
          if (lane == s) {
            got = v;
            key = (static_cast<unsigned>(v >> 32) + 1u) << 5 |
                  (kC - 1 - lane);
          }
        }
        PROFILE_MARK(3);
        if (vi) {
          const State mine = State(key >> 5) << 32 | (kWideNone - i);
          packed[i] = mine;
          prev[i] = ~static_cast<unsigned>(got);
          chain_end = max(chain_end, mine);
        }
      } else {
        const unsigned low = 0x10000u + (kJMask - i);  // pack: + lis field
        unsigned mine = 0, got = 0;
#pragma unroll 1
        for (int s = 0; s < n_cols; ++s) {
          const unsigned b =
              __reduce_max_sync(kFull, (succ >> s) & 1u ? mine : 0u);
          const unsigned v = max(b, ext);
          if (lane == s) {
            got = v;
            mine = (v & 0xFFFF0000u) + low;
          }
        }
        PROFILE_MARK(3);
        if (vi) {
          packed[i] = mine;
          prev[i] = static_cast<unsigned short>(~got & kJMask);
        }
        chain_end = max(chain_end, __reduce_max_sync(kFull, mine));
      }
    }
    __syncthreads();
    PROFILE_MARK(4);
  }

  if constexpr (kPath == kWide) {
    if (warp == 0) chain_end = bioinfo1::warp_max(chain_end);
  }
  if (threadIdx.x == 0) {
    // count == 0: length 0 and endpoints read from lane 0, as lis_chain.
    int length = 0, end = 0, root = 0;
    if constexpr (kPath == kWide) {
      if (chain_end > 0) {
        length = static_cast<int>(chain_end >> 32);
        end = static_cast<int>(kWideNone - static_cast<unsigned>(chain_end));
        root = end;
        for (unsigned p = prev[root]; p != kWideNone; p = prev[root]) root = p;
      }
    } else if (chain_end > 0) {
      length = static_cast<int>(chain_end >> 16);
      end = static_cast<int>(kJMask - (chain_end & kJMask));
      root = end;
      const unsigned base = shared_base<kPath>(prev);
      for (unsigned p = prev_at<kPath>(prev, base, root); p != kJMask;
           p = prev_at<kPath>(prev, base, root))
        root = p;
    }
    out[0 * R + row] = length;
    out[1 * R + row] = static_cast<int>(fg[root]);
    out[2 * R + row] = static_cast<int>(fg[end]);
    out[3 * R + row] = static_cast<int>(rg[root]);
    out[4 * R + row] = static_cast<int>(rg[end]);
  }
  PROFILE_MARK(5);
#ifdef BIOINFO1_CHAIN_PROFILE
  if (profiled) {
    for (int n = 0; n < 6; ++n) g_chain_profile[n] += spent[n];
    g_chain_profile[6] += clock64() - t_start;
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_chain_profile[7] += ns - ns_start;
    g_chain_profile[8] += K;
  }
#endif
}

template <int kPath>
int launch(const void* f, const void* r, const void* count, int R, int N,
           void* packed_scratch, void* prev_scratch, void* qlo_scratch,
           void* out, int threads, cudaStream_t stream) {
  const size_t smem = smem_bytes(kPath, N);
  cudaError_t e = bioinfo1::allow_smem(lis_chain_kernel<kPath>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lis_chain_kernel<kPath><<<R, threads, smem, stream>>>(
      static_cast<const int*>(f), static_cast<const int*>(r),
      static_cast<const int*>(count), R, N,
      static_cast<StateT<kPath>*>(packed_scratch),
      static_cast<PrevT<kPath>*>(prev_scratch),
      static_cast<int*>(qlo_scratch), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f, r: (R, N) int32; count: (R,) int32; path: 0 shared, 1 state, 2
// scratch, 3 wide (ops/chain.CHAIN_PATHS); packed_scratch: (R, n_pad) uint32
// and prev_scratch: (R, n_pad) uint16 on the scratch path, (R, n_pad) uint64
// and uint32 on the wide path (n_pad = N rounded up to 32), else unused;
// qlo_scratch: (R, n_pad / 32) int32 on the wide path, else unused; N: at
// most 65535, on the wide path kWideMaxN = 2^27 - 1 (ops/chain._MAX_N);
// threads: 32-512, a multiple of 32; out: (5, R) int32 rows length,
// q_start, q_end, t_start, t_end.
extern "C" int bioinfo1_lis_chain(const void* f, const void* r,
                                  const void* count, int R, int N,
                                  void* packed_scratch, void* prev_scratch,
                                  void* qlo_scratch, void* out, int path,
                                  int threads, void* stream) {
  if (threads % 32 || threads < 32 || threads > 32 * kMaxWarps || N < 1 ||
      N > (path == kWide ? kWideMaxN : 0xFFFF))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (path) {
    case kShared:
      return launch<kShared>(f, r, count, R, N, packed_scratch, prev_scratch,
                             qlo_scratch, out, threads, s);
    case kState:
      return launch<kState>(f, r, count, R, N, packed_scratch, prev_scratch,
                            qlo_scratch, out, threads, s);
    case kScratch:
      return launch<kScratch>(f, r, count, R, N, packed_scratch,
                              prev_scratch, qlo_scratch, out, threads, s);
    case kWide:
      return launch<kWide>(f, r, count, R, N, packed_scratch, prev_scratch,
                           qlo_scratch, out, threads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef BIOINFO1_CHAIN_PROFILE
// Copies g_chain_profile (9 unsigned 64-bit counters) to `host` and clears
// it.
extern "C" int bioinfo1_chain_profile(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_chain_profile,
                                       sizeof(g_chain_profile));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[9] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_chain_profile, zero, sizeof(zero)));
}
#endif

extern "C" const char* bioinfo1_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
