"""LIS chaining of seed matches (port of bioinfo1_tpu/ops/chain.py and ops/pallas_chain.py).

Predecessor rule (reference_model.find_lis, team_mapper.cpp:283-316):
j < i qualifies iff r_j < r_i < r_j + 5000 and f_j < f_i < f_j + 5000.
``prev[i]`` is the smallest qualifying j with maximal lis[j]; the chain end
is the first argmax of lis and the chain length is lis[end].  Only the
endpoints are returned.

``lis_chain`` is the wrapper of kernel K1 (csrc/lis_chain.cu): CUDA tensors
launch the kernel, CPU tensors take ``lis_chain_plain``, the plain PyTorch
version (a Python loop over i in place of the JAX ``fori_loop``).  It counts
its launches on ``lis_chain.launches`` and by path of ``chain_plan`` on
``lis_chain.path_launches``.

K1 is a two-level DP over chunks of ``CHAIN_C`` matches: the predecessors
of chunk k in finished chunks come from chunks [q_lo[k], k) only
(``chunk_q_lo``, the kernel's rule on the host), then one warp scans the
chunk's columns in order.  ``chain_plan`` picks where the kernel keeps a
row's matches and states, and past 65,535 matches its wide state, up to
``_MAX_N`` matches.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from bioinfo1_tpu_torch.kernels import build

_GAP_CAP = 5000
_NARROW_MAX_N = 0xFFFF  # K1's 32-bit state packs the match index in 16 bits
# The wide path's largest budget: its serial scan reduces the 32-bit key
# (lis << 5) | (31 - lane), so lis <= N < 2^27 (csrc/lis_chain.cu kWideMaxN).
# A bucket's base budget is 3/8 of its cap, so this takes the base budget
# of every bucket up to 16,777,216 (reads to 16.8 Mb) and four doublings.
_MAX_N = (1 << 27) - 1
CHAIN_C = 32            # K1's chunk: one match per lane of a warp
CHAIN_THREADS = 512     # threads per CTA (one CTA per row)
# Storage paths of csrc/lis_chain.cu, by their C number: f, r, states and
# prev in shared memory; f and r read from the inputs, states and prev in
# shared memory; states and prev in global scratch rows; 64-bit states,
# 32-bit prev and 32-bit q_lo in global scratch rows (budgets past
# _NARROW_MAX_N).
CHAIN_PATHS = ("shared", "state", "scratch", "wide")


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How K1 runs a row of N matches: ``path`` (one of CHAIN_PATHS),
    ``threads`` per CTA and the dynamic shared bytes of a CTA, as the C
    launcher computes them (csrc/lis_chain.cu smem_bytes)."""

    path: str
    threads: int
    smem_bytes: int


def chain_plan(N: int) -> ChainPlan:
    """K1's storage path for a match budget N: up to 65,535 the first of
    shared (14 bytes a match), state (6) and scratch (the chunk bounds only)
    whose shared bytes fit build.SMEM_LIMIT, each also holding q_lo, 2 bytes
    a chunk in whole 16-byte groups; past it, up to _MAX_N, wide (no
    dynamic shared memory)."""
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"chain_plan: match budget {N} outside [1, {_MAX_N}]")
    n_pad = -(-N // CHAIN_C) * CHAIN_C
    chunks = n_pad // CHAIN_C
    head = 2 * (-(-chunks // 8) * 8)
    if N > _NARROW_MAX_N:
        return ChainPlan("wide", CHAIN_THREADS, 0)
    for path, nbytes in (("shared", head + 14 * n_pad),
                         ("state", head + 6 * n_pad)):
        if nbytes <= build.SMEM_LIMIT:
            return ChainPlan(path, CHAIN_THREADS, nbytes)
    return ChainPlan("scratch", CHAIN_THREADS, head + 8 * chunks)


def chunk_q_lo(f: np.ndarray, count: int) -> np.ndarray:
    """K1's chunk rule for one row of query positions ``f`` with ``count``
    valid: per chunk k of CHAIN_C matches, q_lo[k] = the first chunk q < k
    with fmax[q] > fmin[k] - 5000 and fmin[q] < fmax[k] (f min / max over
    the valid matches of a chunk), else k.  No chunk before q_lo[k] holds a
    predecessor of a match in chunk k, whatever the order of f.  As the
    wide path does, the search for q starts at ``chunk_scan_start``."""
    fmin, fmax = _chunk_bounds(f, count)
    start = chunk_scan_start(fmin, fmax)
    q_lo = np.arange(len(fmin))
    for k in range(len(fmin)):
        ok = np.flatnonzero((fmax[start[k]:k] > fmin[k] - _GAP_CAP)
                            & (fmin[start[k]:k] < fmax[k]))
        if len(ok):
            q_lo[k] = start[k] + ok[0]
    return q_lo


def _chunk_bounds(f: np.ndarray, count: int) -> tuple:
    """(fmin, fmax) over the valid matches of each chunk of CHAIN_C."""
    n = int(count)
    x = np.asarray(f[:n], np.int64)
    pad = -n % CHAIN_C
    lo = np.concatenate([x, np.full(pad, np.iinfo(np.int64).max)])
    hi = np.concatenate([x, np.full(pad, np.iinfo(np.int64).min)])
    return (lo.reshape(-1, CHAIN_C).min(axis=1),
            hi.reshape(-1, CHAIN_C).max(axis=1))


def chunk_scan_start(fmin: np.ndarray, fmax: np.ndarray) -> np.ndarray:
    """Where K1's wide path starts each chunk's q_lo scan: the first chunk
    q < k whose running max of fmax passes fmin[k] - 5000, else k.  No
    chunk before it has fmax[q] > fmin[k] - 5000, so none qualifies."""
    run_max = np.maximum.accumulate(fmax)
    start = np.searchsorted(run_max, fmin - _GAP_CAP, side="right")
    return np.minimum(start, np.arange(len(fmin)))


@dataclasses.dataclass
class ChainResult:
    """Per-row chain summary, (R,) int32 each: length (0 when the row had no
    matches) and the 1-based positions of chain.front() / chain.back() on
    the query (q_start, q_end) and target (t_start, t_end) axes."""

    length: torch.Tensor
    q_start: torch.Tensor
    q_end: torch.Tensor
    t_start: torch.Tensor
    t_end: torch.Tensor


def lis_chain_plain(f_pos: torch.Tensor, r_pos: torch.Tensor,
                    count: torch.Tensor) -> ChainResult:
    """Plain PyTorch LIS over (R, N) match rows with ``count`` valid each."""
    R, N = f_pos.shape
    dev = f_pos.device
    f = f_pos.to(torch.int32)
    r = r_pos.to(torch.int32)
    j_idx = torch.arange(N, device=dev)
    valid = j_idx[None, :] < count.long()[:, None]
    lis = torch.ones((R, N), dtype=torch.int32, device=dev)
    prev = torch.full((R, N), -1, dtype=torch.int64, device=dev)
    # Rows past their count keep lis = 1 / prev = -1 and are masked below,
    # so the loop stops at the largest count.
    n_iter = min(int(count.max()) if R else 0, N)
    for i in range(1, n_iter):
        fi, ri = f[:, i:i + 1], r[:, i:i + 1]
        fj, rj = f[:, :i], r[:, :i]
        mask = (valid[:, :i] & valid[:, i:i + 1]
                & (rj < ri) & (ri - rj < _GAP_CAP)
                & (fj < fi) & (fi - fj < _GAP_CAP))
        cand = torch.where(mask, lis[:, :i], 0)
        best = cand.max(dim=1).values
        has = best > 0
        lis[:, i] = torch.where(has, best + 1, 1)
        first_j = torch.where(mask & (lis[:, :i] == best[:, None]),
                              j_idx[None, :i], N).min(dim=1).values
        prev[:, i] = torch.where(has, first_j, -1)

    masked = torch.where(valid, lis, 0)
    length = masked.max(dim=1).values
    end = torch.where(masked == length[:, None], j_idx[None, :],
                      N).min(dim=1).values            # first argmax
    rows = torch.arange(R, device=dev)
    root = end.clone()
    while True:                                       # chase prev pointers
        nxt = prev[rows, root]
        if not bool((nxt >= 0).any()):
            break
        root = torch.where(nxt >= 0, nxt, root)
    return ChainResult(length=length, q_start=f[rows, root],
                       q_end=f[rows, end], t_start=r[rows, root],
                       t_end=r[rows, end])


def lis_chain(f_pos: torch.Tensor, r_pos: torch.Tensor,
              count: torch.Tensor) -> ChainResult:
    """LIS chain per row: kernel K1 on CUDA tensors, the plain version on
    CPU tensors.  f_pos/r_pos: (R, N) int32; count: (R,) int32."""
    if f_pos.device.type == "cpu":
        return lis_chain_plain(f_pos, r_pos, count)
    R, N = f_pos.shape
    for name, x, shape in (("f_pos", f_pos, (R, N)), ("r_pos", r_pos, (R, N)),
                           ("count", count, (R,))):
        if (x.dtype != torch.int32 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.device != f_pos.device):
            raise ValueError(f"lis_chain: {name} must be a contiguous int32 "
                             f"{shape} tensor on {f_pos.device}")
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"lis_chain: match budget {N} outside K1's range "
                         f"[1, {_MAX_N}]")
    out = torch.empty((5, R), dtype=torch.int32, device=f_pos.device)
    if R:
        plan = chain_plan(N)
        # The scratch and wide paths' state rows, the wide path's q_lo rows.
        packed = prev = q_lo = None
        if plan.path in ("scratch", "wide"):
            n_pad = -(-N // CHAIN_C) * CHAIN_C
            wide = plan.path == "wide"
            packed = torch.empty((R, n_pad), device=f_pos.device,
                                 dtype=torch.int64 if wide else torch.int32)
            prev = torch.empty((R, n_pad), device=f_pos.device,
                               dtype=torch.int32 if wide else torch.int16)
            if wide:
                q_lo = torch.empty((R, n_pad // CHAIN_C), device=f_pos.device,
                                   dtype=torch.int32)
        build.launch(
            lis_chain, "bioinfo1_lis_chain",
            f_pos.data_ptr(), r_pos.data_ptr(), count.data_ptr(), R, N,
            0 if packed is None else packed.data_ptr(),
            0 if prev is None else prev.data_ptr(),
            0 if q_lo is None else q_lo.data_ptr(), out.data_ptr(),
            CHAIN_PATHS.index(plan.path), plan.threads,
            torch.cuda.current_stream(f_pos.device).cuda_stream,
            device=f_pos.device)
        with _path_lock:
            lis_chain.path_launches[plan.path] += 1
    return ChainResult(*out.unbind(0))


lis_chain.launches = 0
# K1 launches by path of chain_plan (the mapper launches from several worker
# threads).
lis_chain.path_launches = dict.fromkeys(CHAIN_PATHS, 0)
_path_lock = threading.Lock()
