"""Seed matching against the combined sorted index (port of bioinfo1_tpu/ops/match.py:68-332).

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
import threading
from typing import Optional, Sequence

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


def _lanes(cnt: torch.Tensor, start: torch.Tensor, N: int):
    """Per-slot hit runs (count, table start) -> the (B, N) output lanes:
    each lane's slot, its table row (unclamped), whether it holds a match,
    and the exact per-read totals."""
    B, T = cnt.shape
    cum = torch.cumsum(cnt, dim=1)                       # inclusive, int64
    total = cum[:, -1]
    j = torch.arange(N, device=cnt.device, dtype=torch.int64)
    slot = torch.searchsorted(cum, j[None, :].expand(B, N).contiguous(),
                              right=True).clamp(max=T - 1)
    cumx = (cum - cnt).gather(1, slot)
    valid = j[None, :] < total.clamp(max=N)[:, None]
    row = start.gather(1, slot) + j[None, :] - cumx
    return slot, row, valid, total


def _matches(slot, r_pos, valid, total, min_pos, N: int) -> Matches:
    f_pos = torch.where(valid, min_pos.gather(1, slot), 0)
    return Matches(f_pos=f_pos.to(torch.int32), r_pos=r_pos.to(torch.int32),
                   count=total.clamp(max=N).to(torch.int32),
                   total=total.to(torch.int32), overflow=total > N)


def _compact(cnt: torch.Tensor, start: torch.Tensor, min_pos: torch.Tensor,
             key_pos: torch.Tensor, N: int) -> Matches:
    """Per-slot hit runs (count, table start) -> (B, N) match lists."""
    slot, row, valid, total = _lanes(cnt, start, N)
    r_pos = torch.where(valid, key_pos[row.clamp(0, key_pos.shape[0] - 1)],
                        0)
    return _matches(slot, r_pos, valid, total, min_pos, N)


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


_SERVED_LOCK = threading.Lock()


def _on_shards(fn, args: Sequence[torch.Tensor], devices, streams):
    """``fn(d, *args)`` for every shard d, on shard d's device and stream,
    each result copied back to the caller's device.  On CUDA the shard's
    stream first waits for the caller's current stream, and the caller's
    stream then waits for the shard's, by events: no host sync.  Tensors
    that one stream allocated and another reads are recorded on the
    reader (the caching allocator would hand their memory out again
    early); a copy between two cards orders itself against both cards'
    current streams.  Every tensor crosses contiguous: a strided copy
    between two cards is a kernel that writes through a peer mapping, which
    PyTorch enables at its first use, and such copies from several batch
    threads at once met an illegal address on four H100s; a contiguous one
    is a plain peer memcpy."""
    home = args[0].device
    args = [a.contiguous() for a in args]
    if home.type != "cuda":
        return [fn(d, *(a.to(dev) for a in args)).to(home)
                for d, dev in enumerate(devices)]
    caller = torch.cuda.current_stream(home)
    ready = caller.record_event()
    outs = []
    for d, (dev, stream) in enumerate(zip(devices, streams)):
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            stream.wait_event(ready)
            local = [a.to(dev, non_blocking=True) for a in args]
            if dev == home:
                for a in args:
                    a.record_stream(stream)
            out = fn(d, *local).to(home, non_blocking=True)
            done = stream.record_event()
        caller.wait_event(done)
        if dev == home:
            out.record_stream(caller)
        outs.append(out)
    return outs


def find_matches_combined_sharded(
        min_hash: torch.Tensor, min_pos: torch.Tensor, keep: torch.Tensor,
        shards: Sequence, range_size: int, max_matches: int, cnt_shift: int,
        *, streams: Optional[Sequence] = None,
        served: Optional[Sequence[torch.Tensor]] = None):
    """Both strands' matches from a hash-range-SHARDED combined table (port
    of bioinfo1_tpu/ops/match.py ``find_matches_combined_sharded`` and
    ``_compact_sharded``).

    ``shards[d]`` (a pipeline/device_map.DeviceIndex, on any device) holds
    the table rows whose hash lies in [d * range_size, (d + 1) *
    range_size) and a rebased direct-address directory over that range.
    The queries stay on the caller's device.  The JAX package's protocol
    (all_gather the queries, psum the counts, psum_scatter the disjoint
    hit buffers) becomes two round trips, each a fixed exchange with every
    shard:

      (a) each shard probes its directory with the queries of its range
          and returns (lo, cf, cr), its run start and per-strand counts per
          slot, zero outside its range; a hash lives in one shard, so their
          sum is the replicated lookup's;
      (b) the caller lays the lanes out as ``_compact`` does and sends
          every shard the lanes' (row, owner) codes; each shard gathers
          ``key_pos`` at the lanes it owns, zero elsewhere, and the sum is
          the replicated ``r_pos``.

    Results, counts, totals and overflow flags equal
    ``find_matches_combined`` on the replicated table bit for bit.  On
    CUDA, ``streams[d]`` is the stream shard d's side runs on (a lookup
    stream of its card, so that it does not queue behind the card's other
    batches; None: the card's current stream).  ``served[d]``, a tensor
    on shard d's device, gains the number of query slots shard d found."""
    n = len(shards)
    devices = [s.key_pos.device for s in shards]
    if streams is None:
        streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                   for d in devices]

    def probe(d, q, kp):
        sh = shards[d]
        rel = q - d * range_size
        mine = kp & (rel >= 0) & (rel < range_size)
        qi = torch.where(mine, rel, 0)
        lo = sh.bucket_off[qi].long()
        present = (sh.bucket_off[qi + 1].long() > lo) & mine
        loc = lo.clamp(0, sh.key_pos.shape[0] - 1)
        if cnt_shift:
            both = torch.where(present, sh.cnt_fr[loc], 0)
            cf = both & ((1 << cnt_shift) - 1)
            cr = both >> cnt_shift
        else:
            cf = torch.where(present, sh.cnt_fr[loc], 0)
            cr = torch.where(present, sh.cnt_r2[loc].long(), 0)
        if served is not None:
            with _SERVED_LOCK:
                served[d].add_(present.sum())
        return torch.stack([torch.where(present, lo, 0), cf, cr])

    lo, cf, cr = sum(_on_shards(probe, (min_hash, keep), devices, streams))
    # The owner holds every entry of its hashes: at its slots the global
    # forward count is its own, so reverse runs start at lo + cf there.
    owner = min_hash // range_size
    lanes = [_lanes(cf, lo, max_matches), _lanes(cr, lo + cf, max_matches)]
    code = torch.cat([torch.where(valid, row * n + owner.gather(1, slot), -1)
                      for slot, row, valid, _ in lanes], dim=1)

    def gather(d, c):
        kp = shards[d].key_pos
        row = (c // n).clamp(0, kp.shape[0] - 1)
        return torch.where((c >= 0) & (c % n == d), kp[row], 0)

    r_pos = sum(_on_shards(gather, (code,), devices, streams))
    N = max_matches
    return tuple(_matches(slot, r, valid, total, min_pos, N)
                 for (slot, _, valid, total), r in
                 zip(lanes, (r_pos[:, :N], r_pos[:, N:])))


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
