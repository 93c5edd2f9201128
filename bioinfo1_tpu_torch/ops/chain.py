"""LIS chaining of seed matches (port of bioinfo1_tpu/ops/chain.py and ops/pallas_chain.py).

Predecessor rule (reference_model.find_lis, team_mapper.cpp:283-316):
j < i qualifies iff r_j < r_i < r_j + 5000 and f_j < f_i < f_j + 5000.
``prev[i]`` is the smallest qualifying j with maximal lis[j]; the chain end
is the first argmax of lis and the chain length is lis[end].  Only the
endpoints are returned.

``lis_chain`` is the wrapper of kernel K1 (csrc/lis_chain.cu): CUDA tensors
launch the kernel, CPU tensors take ``lis_chain_plain``, the plain PyTorch
version (a Python loop over i in place of the JAX ``fori_loop``).
"""

from __future__ import annotations

import dataclasses

import torch

from bioinfo1_tpu_torch.kernels import build

_GAP_CAP = 5000
_MAX_N = 0xFFFF         # K1 packs the match index into 16 bits


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
        raise ValueError(f"lis_chain: match budget {N} outside the kernel's "
                         f"packed-index range [1, {_MAX_N}]")
    out = torch.empty((5, R), dtype=torch.int32, device=f_pos.device)
    if R:
        use_smem = 12 * N <= build.SMEM_LIMIT
        packed = (None if use_smem else
                  torch.empty((R, N), dtype=torch.int32, device=f_pos.device))
        prev = torch.empty((R, N), dtype=torch.int32, device=f_pos.device)
        build.launch(
            lis_chain, "bioinfo1_lis_chain",
            f_pos.data_ptr(), r_pos.data_ptr(), count.data_ptr(), R, N,
            0 if packed is None else packed.data_ptr(), prev.data_ptr(),
            out.data_ptr(), int(use_smem),
            torch.cuda.current_stream(f_pos.device).cuda_stream)
    return ChainResult(*out.unbind(0))


lis_chain.launches = 0
