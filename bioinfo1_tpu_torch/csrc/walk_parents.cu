// K5 - traceback walk over K4's packed parents, one warp per read, in all
// three modes.
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
// fills the output with 0xFF (all done) first, and the warp completes its
// last partial byte with 3s.
//
// What bounds it: a chain of dependent loads.  Step s + 1 needs the byte
// step s chose, and the parent tensor (hundreds of MB to GB) is far larger
// than L2, so a walk that loads each step's byte from device memory (this
// kernel's first design: one thread per read) pays a device-memory round
// trip per step.
//
// The design: what a step can reach is known in advance.  A byte row holds
// 4 anti-diagonals, a step goes down 1 diagonal (I, D) or 2 (M), and the
// lane moves by at most one every two diagonals (an M keeps it, an I lowers
// it only from an even diagonal, a D raises it only from an odd one).  So
// from a cell in row R every byte of rows R - 2K + 1 .. R - K that the walk
// can read lies within 4K lanes of the cell's lane, and every q / t byte
// within 8K bytes below i - 1 / j - 1.  One warp walks one read: its 32
// lanes copy slab k + 1 (K parent rows x a window of `win` = 8K + 16 bytes
// round the lane, and in local mode the q / t windows) from device memory
// into a ring of two shared-memory buffers with cp.async, issued when the
// walk enters slab k, and every lane then walks slab k out of shared
// memory (the lanes walk in lockstep, so every load is a broadcast, no
// lane waits on another and no branch diverges; the code byte is stored by
// one store instruction of the warp each step).  A slab's copy pays one
// device-memory latency, hidden behind the walk of the slab before it.
// The slabs are keyed to the row the walk is on, never to the step count:
// a read stuck on a parent of 3 stays in its slab.  Within a slab the walk
// moves its byte's row, lane and bit pair by the step's code alone (no
// division and no row clip on the chain of dependent steps; the lane clip
// is two min / max).  A cell outside the staged slab (a goal past the last
// row, local mode below row 0, a walk that drifted past the window) takes
// a side path that clips as the plain walk does and reads the staged copy,
// or device memory where the clipped cell lies outside the slab.  Global
// and semiGlobal steps at i == 0 or j == 0 use no parent.
//
// The Pallas walk streams descending slabs of R = 8 rows through VMEM and
// masks a 256-lane window per diagonal, in (B, W) tiles; this window is
// per read and follows the drift bound above.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr unsigned char kDash = 45;
constexpr int kWarps = 4;  // reads (warps) per block
// Shared memory before the first ring: a step's load is issued before the
// step is known to lie in the slab, one byte before a buffer at most.
constexpr int kPad = 16;

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A byte of shared memory by its 32-bit shared-space address (the step
// loop's addresses are formed once, off the chain of dependent steps).
__device__ __forceinline__ unsigned lds_u8(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// A staged slab: parent rows top .. top - rows + 1 (rows = min(K, top + 1),
// those >= 0), lanes [lo, lo + width); q bytes [qlo, qhi) and t bytes
// [tlo, thi) (local mode), whose first staged byte is q[qorg] / t[torg];
// `at` is the buffer's offset in shared memory.
struct Slab {
  int top, rows, lo, width, at;
  int qlo, qhi, qorg;
  int tlo, thi, torg;
};

// Stage the bytes of row `bytes` (length len) with indices
// [max(hi - reach, 0), hi), hi = clip(last, 0, len - 1) + 1, into dst as
// the 16-byte aligned chunks that hold them (a chunk that holds a byte of
// the row lies in the same allocation).  At most reach + 16 bytes.
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const unsigned char* bytes,
                                            int len, int last, int reach,
                                            int lane_id, int& lo, int& hi,
                                            int& org) {
  hi = clip(last, 0, len - 1) + 1;
  lo = max(hi - reach, 0);
  const uintptr_t first = reinterpret_cast<uintptr_t>(bytes + lo);
  const uintptr_t a0 = first & ~uintptr_t{15};
  const uintptr_t a1 =
      reinterpret_cast<uintptr_t>(bytes + hi - 1) & ~uintptr_t{15};
  org = lo - static_cast<int>(first & 15);
  const int chunks = static_cast<int>((a1 - a0) >> 4) + 1;
  for (int c = lane_id; c < chunks; c += 32)
    cp_async16(dst + 16 * c, reinterpret_cast<const void*>(a0 + 16 * c));
}

__device__ __forceinline__ int lane_of(int i, int j, int W) {
  return clip((j - i + W - ((i + j) & 1)) >> 1, 0, W - 1);
}

// Issue the copy of the slab whose top row is `top`, centred on the lane
// and (i, j) of the walk now, into the buffer at smem + at; one cp.async
// group.  A row's window is win / 16 <= 32 chunks, so each lane copies one
// chunk of a row per pass, 32 / chunks rows a pass.
template <bool kLocal>
__device__ __forceinline__ Slab stage(unsigned char* smem, int at,
                                      const unsigned char* par, int B, int W,
                                      int b, int top, int i, int j,
                                      const unsigned char* qr, int qn,
                                      const unsigned char* tr, int tm, int K,
                                      int win, int lane_id) {
  Slab sl;
  sl.top = top;
  sl.rows = max(min(K, top + 1), 0);
  sl.lo = max(lane_of(i, j, W) - ((win - 16) >> 1), 0) & ~15;
  sl.width = min(sl.lo + win, W) - sl.lo;
  sl.at = at;
  const int per_row = sl.width >> 4, per_pass = 32 / per_row;
  const int r0 = lane_id / per_row, k = lane_id - r0 * per_row;
  if (r0 < per_pass)
    for (int r = r0; r < sl.rows; r += per_pass)
      cp_async16(smem + at + r * win + 16 * k,
                 par + (static_cast<size_t>(top - r) * B + b) * W + sl.lo +
                     16 * k);
  if (kLocal) {
    stage_bytes(smem + at + K * win, qr, qn, i - 1, win - 16, lane_id, sl.qlo,
                sl.qhi, sl.qorg);
    stage_bytes(smem + at + (K + 1) * win, tr, tm, j - 1, win - 16, lane_id,
                sl.tlo, sl.thi, sl.torg);
  }
  cp_async_commit();
  return sl;
}

template <bool kLocal>
__global__ void __launch_bounds__(32 * kWarps) walk_parents_kernel(
    const unsigned char* __restrict__ par, int S4, int B, int W,
    const int* __restrict__ goal_i, const int* __restrict__ goal_j,
    const int* __restrict__ score, const unsigned char* __restrict__ q,
    int qn, const unsigned char* __restrict__ t, int tm, int match,
    int mismatch, int gap, int K, int win, unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;
  const int slab_bytes = (K + 2) * win;
  const int ring = kPad + warp * 2 * slab_bytes;
  const unsigned char* qr = q + static_cast<size_t>(b) * qn;
  const unsigned char* tr = t + static_cast<size_t>(b) * tm;
  int i = goal_i[b], j = goal_j[b], cost = score[b];
  if (kLocal ? cost <= 0 : (i <= 0 && j <= 0)) return;  // writes nothing
  const int steps = 4 * (S4 + 1);
  const int last4 = 4 * S4 - 1;

  // Slab 0 (the goal's row down) and slab 1, both from the goal.
  const int top0 = clip(i + j - 2, 0, last4) >> 2;
  Slab cur = stage<kLocal>(smem, ring, par, B, W, b, top0, i, j, qr, qn, tr,
                           tm, K, win, lane_id);
  Slab nxt = stage<kLocal>(smem, ring + slab_bytes, par, B, W, b, top0 - K, i,
                           j, qr, qn, tr, tm, K, win, lane_id);
  // The walk's byte without the row clip: e3 = (d - 2) & 3 picks its bit
  // pair, roff = top - ((d - 2) >> 2) its row in the slab and col = lane -
  // lo its lane in the window (d and j - i share their parity, so the
  // lane is (j - i - (d & 1)) / 2 + W / 2 exactly), all moved by the step's
  // code alone.  A cell whose clipped lane or unclipped row lies outside
  // the staged slab leaves the step loop for the side path below.
  int e3 = (i + j - 2) & 3;
  int roff = cur.top - ((i + j - 2) >> 2);
  int col = ((j - i - ((i + j) & 1)) >> 1) + (W >> 1) - cur.lo;
  unsigned acc = 0;

  // One step on parent byte v (and, in local mode, the bytes qc, tc); the
  // step loop passes `border` false (there i > 0 and j > 0).
  unsigned char* op = out + b;  // the code byte of step s: op + (s >> 2) * B
  auto take = [&](unsigned v, int qc, int tc, int s, bool border) {
    int p = (v >> (2 * e3)) & 3;
    if (kLocal) {
      cost -= p == 0   ? (qc == tc ? match : mismatch)
              : p == 1 ? (tc == kDash ? 0 : gap)
                       : (qc == kDash ? 0 : gap);
    } else if (border) {
      p = i == 0 ? 1 : (j == 0 ? 2 : p);
    }
    acc |= static_cast<unsigned>(p) << (2 * (s & 3));
    // Every step stores its code byte, from every lane (one store, no
    // branch); the byte's last store (step 4k + 3, or the completion
    // below) is the one that stays.
    *op = static_cast<unsigned char>(acc);
    if ((s & 3) == 3) {
      acc = 0;
      op += B;
    }
    // M: d - 2 (a row down from bit pairs 0, 1); I: d - 1, j - 1 (a lane
    // down from even d); D: d - 1, i - 1 (a lane up from odd d); I and D
    // go a row down from bit pair 0; a parent of 3 stays.
    roff += p == 0 ? (e3 < 2) : (p == 3 ? 0 : (e3 == 0));
    col += p == 1 ? ((e3 & 1) - 1) : (p == 2 ? (e3 & 1) : 0);
    e3 = (e3 - (p == 0 ? 2 : (p == 3 ? 0 : 1))) & 3;
    i -= (p == 0 || p == 2);
    j -= (p == 0 || p == 1);
  };

  cp_async_wait<1>();
  __syncwarp();
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int s = 0;
  bool active = true;
  for (;;) {
    active = kLocal ? cost > 0 : (i > 0 || j > 0);
    if (!active || s >= steps) break;
    if (!kLocal && (i == 0 || j == 0)) {
      // The rest of a global / semiGlobal walk: i == 0 takes I until
      // j == 0, j == 0 takes D until i == 0.
      const int code = i == 0 ? 1 : 2;
      for (int n = i + j; n > 0 && s < steps; --n, ++s) {
        acc |= static_cast<unsigned>(code) << (2 * (s & 3));
        *op = static_cast<unsigned char>(acc);
        if ((s & 3) == 3) {
          acc = 0;
          op += B;
        }
      }
      i = j = 0;
      continue;
    }
    // Leave the slab below its last row, unless no row is staged below
    // (row 0 is in it: the clipped row stays there).
    const int leave = cur.top - K + 1 > 0 ? K : 0x7fffffff;
    if (roff >= leave) {
      // Entering slab k + 1 (nxt): stage slab k + 2 into slab k's buffer,
      // from where the walk is now, then wait for nxt's copy.
      __syncwarp();
      const Slab ahead = stage<kLocal>(smem, cur.at, par, B, W, b,
                                       nxt.top - K, i, j, qr, qn, tr, tm, K,
                                       win, lane_id);
      cp_async_wait<1>();
      __syncwarp();
      roff -= K;
      col += cur.lo - nxt.lo;
      cur = nxt;
      nxt = ahead;
      continue;
    }
    const unsigned at = sbase + cur.at;
    const unsigned qat = at + K * win - cur.qorg;
    const unsigned tat = at + (K + 1) * win - cur.torg;
    const int clo = -cur.lo, chi = W - 1 - cur.lo;  // the lane clip
    // Does the step at the walk's cell read the slab (parent, q, t bytes)?
    auto in_slab = [&](int c) {
      bool in = static_cast<unsigned>(c) < static_cast<unsigned>(cur.width) &&
                static_cast<unsigned>(roff) < static_cast<unsigned>(cur.rows);
      if (kLocal)
        in = in &&
             static_cast<unsigned>(clip(i - 1, 0, qn - 1) - cur.qlo) <
                 static_cast<unsigned>(cur.qhi - cur.qlo) &&
             static_cast<unsigned>(clip(j - 1, 0, tm - 1) - cur.tlo) <
                 static_cast<unsigned>(cur.thi - cur.tlo);
      return in;
    };
    int c = clip(col, clo, chi);
    if (!in_slab(c)) {
      // The side path: one step on a cell clipped as the plain walk clips
      // it, read from the slab where it lies there, else from device
      // memory.
      const int row = clip(i + j - 2, 0, last4) >> 2;
      const int lane = lane_of(i, j, W);
      const int r = cur.top - row, x = lane - cur.lo;
      const unsigned v =
          static_cast<unsigned>(r) < static_cast<unsigned>(cur.rows) &&
                  static_cast<unsigned>(x) < static_cast<unsigned>(cur.width)
              ? lds_u8(at + r * win + x)
              : par[(static_cast<size_t>(row) * B + b) * W + lane];
      int qc = 0, tc = 0;
      if (kLocal) {
        const int qi = clip(i - 1, 0, qn - 1), ti = clip(j - 1, 0, tm - 1);
        qc = static_cast<unsigned>(qi - cur.qlo) <
                     static_cast<unsigned>(cur.qhi - cur.qlo)
                 ? lds_u8(qat + qi)
                 : qr[qi];
        tc = static_cast<unsigned>(ti - cur.tlo) <
                     static_cast<unsigned>(cur.thi - cur.tlo)
                 ? lds_u8(tat + ti)
                 : tr[ti];
      }
      take(v, qc, tc, s, true);
      ++s;
      continue;
    }
    // The step loop, one step ahead: while step s's byte is in flight the
    // four cells step s + 1 may stand on (after M, I, D or a stay) are
    // formed from the state, the byte's two bits pick one and its load
    // goes out before step s's bookkeeping and step s + 1's checks.  The
    // step s is in the slab, so each candidate lies in the ring (at most
    // one byte before the buffer, a row past its parent rows).
    unsigned v = lds_u8(at + roff * win + c);
#pragma unroll 1
    for (;;) {
      int qc = 0, tc = 0;
      if (kLocal) {
        qc = lds_u8(qat + clip(i - 1, 0, qn - 1));
        tc = lds_u8(tat + clip(j - 1, 0, tm - 1));
      }
      const int odd = e3 & 1;
      const unsigned row_s = at + roff * win;
      const unsigned row_m = row_s + (e3 < 2 ? win : 0);   // after M
      const unsigned row_id = row_s + (e3 == 0 ? win : 0); // after I, D
      const unsigned a_m = row_m + c;
      const unsigned a_i = row_id + clip(col + odd - 1, clo, chi);
      const unsigned a_d = row_id + clip(col + odd, clo, chi);
      const unsigned a_3 = row_s + c;
      const unsigned sv = v >> (2 * e3);
      const unsigned a_next = (sv & 2) ? ((sv & 1) ? a_3 : a_d)
                                       : ((sv & 1) ? a_i : a_m);
      const unsigned v_next = lds_u8(a_next);
      take(v, qc, tc, s, false);
      ++s;
      if (s >= steps || (kLocal ? cost <= 0 : (i <= 0 || j <= 0)) ||
          roff >= leave)
        break;
      c = clip(col, clo, chi);
      if (!in_slab(c)) break;
      v = v_next;
    }
  }
  if (!active && (s & 3))
    *op = static_cast<unsigned char>(acc | 0xFFu << (2 * (s & 3)));
  cp_async_wait<0>();  // no copy outlives the warp
}

}  // namespace

// par: (S4, B, W) uint8 (K4's layout), rows 16-byte aligned (W a multiple
// of 16, par % 16 == 0); goal_i/goal_j/score: (B,) int32; q: (B, qn) and t:
// (B, tm) uint8 (read by local mode only); slab_rows (K) and window (win,
// a multiple of 16, >= 8K + 16): the staging geometry of ops/trace.py;
// out: (S4 + 1, B) uint8, filled with 0xFF by the caller.
extern "C" int bioinfo1_walk_parents(const void* par, int S4, int B, int W,
                                     const void* goal_i, const void* goal_j,
                                     const void* score, const void* q, int qn,
                                     const void* t, int tm, int mode,
                                     int match, int mismatch, int gap,
                                     int slab_rows, int window, void* out,
                                     void* stream) {
  if (slab_rows < 1 || window % 16 || window < 8 * slab_rows + 16 ||
      window > 512 || W < 16 || W % 16 ||
      reinterpret_cast<uintptr_t>(par) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      kPad + static_cast<size_t>(kWarps) * 2 * (slab_rows + 2) * window;
  auto kernel = mode == 1 ? walk_parents_kernel<true>
                          : walk_parents_kernel<false>;
  const cudaError_t e = bioinfo1::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(par), S4, B, W,
      static_cast<const int*>(goal_i), static_cast<const int*>(goal_j),
      static_cast<const int*>(score), static_cast<const unsigned char*>(q),
      qn, static_cast<const unsigned char*>(t), tm, match, mismatch, gap,
      slab_rows, window, static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
