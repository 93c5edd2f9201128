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
row's matches and states, and past 65,535 matches its wide state.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from bioinfo1_tpu_torch.kernels import build

_GAP_CAP = 5000
_NARROW_MAX_N = 0xFFFF  # K1's 32-bit state packs the match index in 16 bits
_MAX_N = 1 << 21        # the wide path's q_lo: a 16-bit index of chunks
CHAIN_C = 32            # K1's chunk: one match per lane of a warp
CHAIN_THREADS = 512     # threads per CTA (one CTA per row)
# Storage paths of csrc/lis_chain.cu, by their C number: f, r, states and
# prev in shared memory; f and r read from the inputs, states and prev in
# shared memory; states and prev in global scratch rows; 64-bit states and
# 32-bit prev in global scratch rows (budgets past _NARROW_MAX_N).
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
    whose shared bytes fit build.SMEM_LIMIT; past it wide (no more shared
    bytes).  Every path also holds q_lo, 2 bytes a chunk in whole 16-byte
    groups."""
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"chain_plan: match budget {N} outside [1, {_MAX_N}]")
    n_pad = -(-N // CHAIN_C) * CHAIN_C
    chunks = n_pad // CHAIN_C
    head = 2 * (-(-chunks // 8) * 8)
    if N > _NARROW_MAX_N:
        return ChainPlan("wide", CHAIN_THREADS, head)
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
    predecessor of a match in chunk k, whatever the order of f."""
    n = int(count)
    x = np.asarray(f[:n], np.int64)
    bounds = [(x[q:q + CHAIN_C].min(), x[q:q + CHAIN_C].max())
              for q in range(0, n, CHAIN_C)]
    fmin = np.array([b[0] for b in bounds], np.int64)
    fmax = np.array([b[1] for b in bounds], np.int64)
    q_lo = np.arange(len(bounds))
    for k in range(len(bounds)):
        ok = np.flatnonzero((fmax[:k] > fmin[k] - _GAP_CAP)
                            & (fmin[:k] < fmax[k]))
        if len(ok):
            q_lo[k] = ok[0]
    return q_lo


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
        packed = prev = None        # the scratch and wide paths' state rows
        if plan.path in ("scratch", "wide"):
            n_pad = -(-N // CHAIN_C) * CHAIN_C
            wide = plan.path == "wide"
            packed = torch.empty((R, n_pad), device=f_pos.device,
                                 dtype=torch.int64 if wide else torch.int32)
            prev = torch.empty((R, n_pad), device=f_pos.device,
                               dtype=torch.int32 if wide else torch.int16)
        build.launch(
            lis_chain, "bioinfo1_lis_chain",
            f_pos.data_ptr(), r_pos.data_ptr(), count.data_ptr(), R, N,
            0 if packed is None else packed.data_ptr(),
            0 if prev is None else prev.data_ptr(),
            out.data_ptr(), CHAIN_PATHS.index(plan.path), plan.threads,
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
