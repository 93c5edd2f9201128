"""Sequence encoding and rolling k-mer hashes (port of bioinfo1_tpu/ops/encode.py).

The reference's 2-bit alphabet C=0 < A=1 < T=2 < G=3, unknown bytes 0.
Hashes are unsigned 32-bit in the JAX package; torch's uint32 supports few
ops, so the port holds them in int64 with the same values (the order, and
so every sort and comparison, is preserved).  Shifts are masked to 32 bits,
so k > 16 wraps exactly like the reference's ``unsigned int``.
"""

from __future__ import annotations

import torch

INVALID_HASH = 0xFFFFFFFF
INVALID_POS = 0x7FFFFFFF
MASK32 = 0xFFFFFFFF

_COMP = list(range(256))
for _a, _b in [("A", "T"), ("T", "A"), ("C", "G"), ("G", "C")]:
    _COMP[ord(_a)] = ord(_b)


def seq_to_codes(seq_bytes: torch.Tensor) -> torch.Tensor:
    """(..., L) uint8 ASCII -> (..., L) int64 2-bit codes."""
    b = seq_bytes.to(torch.int64)
    x = (b >> 1) & 3
    x = x ^ (x < 2).to(torch.int64)
    is_acgt = ((seq_bytes == ord("A")) | (seq_bytes == ord("C"))
               | (seq_bytes == ord("G")) | (seq_bytes == ord("T")))
    return torch.where(is_acgt, x, 0)


def reverse_complement_bytes(seq_bytes: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """Per-row reverse complement of right-padded (B, L) uint8 rows."""
    table = torch.tensor(_COMP, dtype=torch.uint8, device=seq_bytes.device)
    comp = table[seq_bytes.long()]
    L = seq_bytes.shape[-1]
    idx = (lengths.long()[..., None] - 1
           - torch.arange(L, device=seq_bytes.device))
    return torch.gather(comp, -1, idx.clamp(0, L - 1))


def kmer_hashes(seq_bytes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Rolling 2-bit MSB-first k-mer hashes.

    Returns (hashes, valid): (B, L-k+1) int64 hashes with INVALID_HASH where
    the k-mer starts beyond length-k, and the bool validity mask."""
    B, L = seq_bytes.shape
    if L < k:
        raise ValueError(f"padded length {L} < k={k}")
    nk = L - k + 1
    codes = seq_to_codes(seq_bytes)
    h = torch.zeros((B, nk), dtype=torch.int64, device=seq_bytes.device)
    for j in range(k):
        h = ((h << 2) | codes[:, j:j + nk]) & MASK32
    starts = torch.arange(nk, device=seq_bytes.device)[None, :]
    valid = starts <= (lengths.long()[:, None] - k)
    return torch.where(valid, h, INVALID_HASH), valid
