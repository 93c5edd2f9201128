"""Seed matching against the combined sorted index (port of bioinfo1_tpu/ops/match.py:68-222).

Order contract (load-bearing for LIS parity, bioinfo1_tpu/ops/match.py:21-24):
matches are emitted in (dedup'd minimizer slot order) x (ascending reference
position).  Output lane j of a read belongs to the slot whose run holds j
(the first slot with inclusive prefix count > j) at offset j - exclusive
prefix count, so

    r_pos[j] = key_pos[start[slot] + j - cumx[slot]],  f_pos[j] = min_pos[slot].

The JAX package builds this with a scatter and a log-step forward fill
(``_fill_from_left``), because element-serial gathers are slow on the TPU;
plain gathers are fine on the GPU, so the port looks the slot up with one
batched ``searchsorted`` - the same lanes, bit for bit.  Hashes are int64
holding uint32 values.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Matches:
    """f_pos / r_pos: (B, N) int32 1-based positions, right-padded with 0;
    count: (B,) int32 valid matches; total: the exact pre-truncation count;
    overflow: (B,) bool, total > N (the read must retry a larger budget)."""

    f_pos: torch.Tensor
    r_pos: torch.Tensor
    count: torch.Tensor
    total: torch.Tensor
    overflow: torch.Tensor


def _compact(cnt: torch.Tensor, start: torch.Tensor, min_pos: torch.Tensor,
             key_pos: torch.Tensor, N: int) -> Matches:
    """Per-slot hit runs (count, table start) -> (B, N) match lists."""
    B, T = cnt.shape
    dev = cnt.device
    cum = torch.cumsum(cnt, dim=1)                       # inclusive, int64
    total = cum[:, -1]
    j = torch.arange(N, device=dev, dtype=torch.int64)
    slot = torch.searchsorted(cum, j[None, :].expand(B, N).contiguous(),
                              right=True).clamp(max=T - 1)
    cumx = (cum - cnt).gather(1, slot)
    valid = j[None, :] < total.clamp(max=N)[:, None]
    take = (start.gather(1, slot) + j[None, :] - cumx).clamp(
        0, key_pos.shape[0] - 1)
    r_pos = torch.where(valid, key_pos[take], 0)
    f_pos = torch.where(valid, min_pos.gather(1, slot), 0)
    count = total.clamp(max=N)
    return Matches(f_pos=f_pos.to(torch.int32), r_pos=r_pos.to(torch.int32),
                   count=count.to(torch.int32), total=total.to(torch.int32),
                   overflow=total > N)


def compact_queries(min_hash: torch.Tensor, min_pos: torch.Tensor,
                    keep: torch.Tensor, keep_cap: int):
    """Pack kept minimizer slots left into (B, keep_cap) arrays,
    order-preserving.  Returns (hash, pos, keep2, overflow); overflow flags
    reads with more than keep_cap kept slots (their tail is dropped)."""
    B, T = min_hash.shape
    Tc = min(keep_cap, T)
    ki = keep.to(torch.int64)
    dst = torch.cumsum(ki, dim=1) - 1
    n_kept = ki.sum(dim=1)
    # Dropped slots all land in the dump lane Tc, which is cut off: the
    # order in which duplicate writes land there never matters.
    dstc = torch.where(keep & (dst < Tc), dst, Tc)
    h = torch.zeros((B, Tc + 1), dtype=min_hash.dtype, device=min_hash.device)
    p = torch.zeros((B, Tc + 1), dtype=min_pos.dtype, device=min_pos.device)
    h.scatter_(1, dstc, min_hash)
    p.scatter_(1, dstc, min_pos)
    lanes = torch.arange(Tc, device=min_hash.device)[None, :]
    keep2 = lanes < n_kept.clamp(max=Tc)[:, None]
    return h[:, :Tc], p[:, :Tc], keep2, n_kept > Tc


def find_matches_combined(min_hash: torch.Tensor, min_pos: torch.Tensor,
                          keep: torch.Tensor, key_hash: torch.Tensor,
                          key_pos: torch.Tensor, cnt_fr: torch.Tensor,
                          cnt_r2: torch.Tensor, bucket_off: torch.Tensor,
                          shift: int, steps: int, max_matches: int,
                          cnt_shift: int = 16):
    """Both strands' matches from ONE combined sorted table.

    Entries are (hash, strand, pos) sorted with fwd before rev in each hash
    run; each run's first entry holds the packed per-strand counts (fwd in
    the low ``cnt_shift`` bits, rev above; ``cnt_shift == 0`` keeps the rev
    counts in ``cnt_r2``).  ``steps == 0`` is direct-address mode
    (``bucket_off`` spans the whole hash space); otherwise a bucket window
    from the top hash bits plus ``steps`` binary-search rounds find the
    run start.  Returns (fwd Matches, rev Matches)."""
    U = key_hash.shape[0]
    q = min_hash
    # Only kept slots are looked up: the JAX package probes every lane and
    # relies on clamped/wrapped gathers for the rest (an invalid hash is
    # int32 -1 in direct mode); masking instead keeps them "not present".
    if steps == 0:
        qi = torch.where(keep, q, 0)
        lo = bucket_off[qi].long()
        present = (bucket_off[qi + 1].long() > lo) & keep
    else:
        b = torch.where(keep, q >> shift, 0)
        lo = bucket_off[b].long()
        hi = lo + (1 << steps) - 1
        for _ in range(steps):
            mid = (lo + hi) // 2
            go = key_hash[mid.clamp(0, U - 1)] < q
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(go, hi, mid)
        present = (key_hash[lo.clamp(0, U - 1)] == q) & keep
    loc = lo.clamp(0, U - 1)
    if cnt_shift:
        both = torch.where(present, cnt_fr[loc], 0)
        cf = both & ((1 << cnt_shift) - 1)
        cr = both >> cnt_shift
    else:
        cf = torch.where(present, cnt_fr[loc], 0)
        cr = torch.where(present, cnt_r2[loc].long(), 0)
    mf = _compact(cf, lo, min_pos, key_pos, max_matches)
    mr = _compact(cr, lo + cf, min_pos, key_pos, max_matches)
    return mf, mr


def hash_present(idx_hash: torch.Tensor, min_hash: torch.Tensor
                 ) -> torch.Tensor:
    """(B, T) bool: is each minimizer hash present in the sorted strand
    index?  Gates the reverse-strand lookups of the FASTA match-nesting
    bug-compat mode on a forward-index hit (team_mapper.cpp:629-638)."""
    if idx_hash.shape[0] == 0:
        return torch.zeros(min_hash.shape, dtype=torch.bool,
                           device=min_hash.device)
    lo = torch.searchsorted(idx_hash, min_hash.contiguous())
    return idx_hash[lo.clamp(max=idx_hash.shape[0] - 1)] == min_hash


def find_matches(min_hash: torch.Tensor, min_pos: torch.Tensor,
                 keep: torch.Tensor, idx_hash: torch.Tensor,
                 idx_pos: torch.Tensor, max_matches: int) -> Matches:
    """Look up every kept minimizer in ONE strand's sorted index (the
    staged host path; port of bioinfo1_tpu/ops/match.py ``find_matches``).

    min_hash / min_pos / keep: (B, T) minimizer sweep output (keep = the
    dedup mask); idx_hash / idx_pos: (U,) the strand index sorted by
    (hash, pos), hashes int64; ``max_matches``: the per-read budget N."""
    B, T = min_hash.shape
    dev = min_hash.device
    if idx_hash.shape[0] == 0 or T == 0:
        z = torch.zeros((B, max_matches), dtype=torch.int32, device=dev)
        zc = torch.zeros((B,), dtype=torch.int32, device=dev)
        return Matches(f_pos=z, r_pos=z.clone(), count=zc, total=zc.clone(),
                       overflow=torch.zeros((B,), dtype=torch.bool,
                                            device=dev))
    q = min_hash.contiguous()
    lo = torch.searchsorted(idx_hash, q)
    hi = torch.searchsorted(idx_hash, q, right=True)
    cnt = torch.where(keep, hi - lo, 0)
    return _compact(cnt, lo, min_pos, idx_pos, max_matches)
