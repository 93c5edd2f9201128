"""Batched minimizer extraction (port of bioinfo1_tpu/ops/minimizer.py).

Emit-order contract (load-bearing for LIS parity; see
bioinfo1_tpu/ops/minimizer.py:10-18): the slot layout per read is

  [prefix windows s=1..w-1][dense windows start=0..NK-w][suffix windows s=1..w-1]

with 1-based positions and leftmost-minimum tie-breaking.  Duplicate window
winners are kept; ``dedup_keep`` marks the order-preserving first
occurrence of each (hash, pos).  Hashes are int64 holding uint32 values
(ops/encode.py).
"""

from __future__ import annotations

import dataclasses

import torch

from bioinfo1_tpu_torch.ops.encode import (INVALID_HASH, INVALID_POS, MASK32,
                                           kmer_hashes, seq_to_codes)


@dataclasses.dataclass
class Minimizers:
    """hashes: (B, T) int64; pos: (B, T) int32 1-based; valid and
    dedup_keep: (B, T) bool.  T = 2*(w-1) + (L-k+1) - (w-1)."""

    hashes: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor
    dedup_keep: torch.Tensor


def _combine(h1, p1, h2, p2):
    """Leftmost-min combine: the first argument wins ties."""
    take1 = (h1 < h2) | ((h1 == h2) & (p1 <= p2))
    return torch.where(take1, h1, h2), torch.where(take1, p1, p2)


def minimize_batch(seq_bytes: torch.Tensor, lengths: torch.Tensor,
                   k: int, w: int,
                   oob_end_windows: bool = False) -> Minimizers:
    """Reference-exact minimizer sweep over a (B, L) uint8 padded batch.

    ``oob_end_windows`` replicates reference bug #4: the unguarded prefix
    end-windows hash k-mers past the sequence end (the zero padding plays
    the c_str NUL)."""
    B, L = seq_bytes.shape
    if L < k + w - 1:
        raise ValueError(f"padded length {L} must be >= k+w-1={k + w - 1}; "
                         "pad the batch up")
    dev = seq_bytes.device
    h, kvalid = kmer_hashes(seq_bytes, lengths, k)
    nk_max = L - k + 1
    nk = (lengths.long() - k + 1).clamp(min=0)
    base_pos = (torch.arange(nk_max, device=dev, dtype=torch.int32)
                + 1)[None, :].expand(B, nk_max)
    pos = torch.where(kvalid, base_pos, INVALID_POS)

    if oob_end_windows:
        codes = seq_to_codes(seq_bytes)
        oh = torch.zeros((B, nk_max), dtype=torch.int64, device=dev)
        for j in range(k):
            oh = ((oh << 2) | codes[:, j:j + nk_max]) & MASK32
        op = base_pos
        owh, owp = oh, op

    ndense = max(nk_max - w + 1, 0)
    prefix_h, prefix_p, suffix_h, suffix_p = [], [], [], []
    wh, wp = h, pos                      # window minima of the current size
    for s in range(1, w + 1):
        if s > 1:
            wh, wp = _combine(wh[:, :nk_max - s + 1], wp[:, :nk_max - s + 1],
                              h[:, s - 1:], pos[:, s - 1:])
            if oob_end_windows:
                owh, owp = _combine(owh[:, :nk_max - s + 1],
                                    owp[:, :nk_max - s + 1],
                                    oh[:, s - 1:], op[:, s - 1:])
        if s < w:
            src_h, src_p = (owh, owp) if oob_end_windows else (wh, wp)
            prefix_h.append(src_h[:, 0])
            prefix_p.append(src_p[:, 0])
            # Suffix end-window of size s starts at nk - s (per read).
            idx = (nk - s).clamp(0, max(nk_max - s, 0))[:, None]
            suffix_h.append(torch.gather(wh, 1, idx)[:, 0])
            suffix_p.append(torch.gather(wp, 1, idx)[:, 0])

    parts_h, parts_p, parts_v = [], [], []
    if w > 1:
        parts_h.append(torch.stack(prefix_h, dim=1))
        parts_p.append(torch.stack(prefix_p, dim=1))
        parts_v.append((nk >= 1)[:, None].expand(B, w - 1))
    if ndense > 0:
        parts_h.append(wh[:, :ndense])
        parts_p.append(wp[:, :ndense])
        starts = torch.arange(ndense, device=dev)[None, :]
        parts_v.append(starts <= (nk - w)[:, None])
    if w > 1:
        # Suffix window of size s is emitted iff nk >= s.
        parts_h.append(torch.stack(suffix_h, dim=1))
        parts_p.append(torch.stack(suffix_p, dim=1))
        s_idx = torch.arange(1, w, device=dev)[None, :]
        parts_v.append(nk[:, None] >= s_idx)

    valid = torch.cat(parts_v, dim=1)
    hashes = torch.where(valid, torch.cat(parts_h, dim=1), INVALID_HASH)
    positions = torch.where(valid, torch.cat(parts_p, dim=1), INVALID_POS)
    dedup = _first_occurrence_mask(hashes, positions, valid, w)
    return Minimizers(hashes=hashes, pos=positions, valid=valid,
                      dedup_keep=dedup)


def _first_occurrence_mask(hashes, positions, valid, w):
    """Order-preserving first-occurrence mask of (hash, pos) per row.

    Within [prefix][dense] duplicates are provably consecutive (see
    bioinfo1_tpu/ops/minimizer.py:_first_occurrence_mask), so one
    compare-with-previous pass finds them; only the trailing w-1 suffix
    slots are checked against every earlier slot."""
    B, T = hashes.shape
    same_prev = torch.zeros_like(valid)
    same_prev[:, 1:] = ((hashes[:, 1:] == hashes[:, :-1])
                        & (positions[:, 1:] == positions[:, :-1])
                        & valid[:, :-1])
    keep = valid & ~same_prev
    ns = min(w - 1, T - 1)
    if ns <= 0:
        return keep
    lanes = torch.arange(T, device=hashes.device)[None, :]
    for j in range(ns):
        e = T - ns + j
        dup = ((lanes < e) & valid
               & (hashes == hashes[:, e:e + 1])
               & (positions == positions[:, e:e + 1])).any(dim=1)
        keep[:, e] = valid[:, e] & ~dup
    return keep
