"""Fused map steps on the device (port of bioinfo1_tpu/pipeline/device_map.py).

Reads in, mapping coordinates and scores out, with no host round trip
between the stages: minimizer sweep -> compaction -> fwd/rev lookup in the
combined index -> LIS chain (kernel K1, both strands in one launch) ->
strand select -> region gather, then

  * ``map_step`` (score only): banded score (kernel K2) + certificate, or
    the full-matrix score (kernel K3) when the band is 0;
  * ``map_step_cigar`` (-c): banded score + parents (kernel K4), the strict
    certificate, and the traceback walk (kernel K5); only the packed op
    codes leave the device.

The index is one device's copy (``DeviceIndex``) or the hash-range-sharded
layout (``ShardedIndex``: each shard on its own device, the batch's lookup
exchanged with them).  On CPU tensors every kernel wrapper takes its plain
PyTorch version.  The stages carry spans (utils/tracing.span:
``step.minimize``, ``step.lookup``, ``step.chain``, ``step.regions``,
``step.align``, ``step.walk``) that split the step's host time in a trace
and in the batch's record.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from bioinfo1_tpu_torch.ops import align as al
from bioinfo1_tpu_torch.ops import band as bd
from bioinfo1_tpu_torch.ops import chain as chain_ops
from bioinfo1_tpu_torch.ops import match as match_ops
from bioinfo1_tpu_torch.ops import minimizer as mz
from bioinfo1_tpu_torch.ops import trace as tr
from bioinfo1_tpu_torch.utils import tracing


@dataclasses.dataclass
class DeviceIndex:
    """Device-resident reference index (combined-table layout).

    All (hash, strand, pos) entries of both strand indexes in one sorted
    table (fwd entries first within a hash run); ``cnt_fr`` packs the
    per-strand run sizes at each run's first entry (fwd in the low
    ``cnt_shift`` bits, rev above; ``cnt_shift == 0`` keeps the rev counts
    in ``cnt_r2``).  ``bucket_off[b]`` is the table offset of the first hash
    whose top bits are >= b; ``bsearch_steps == 0`` marks the direct-address
    directory over the whole hash space.  ``ref_bytes`` stacks the forward
    and reverse-complement strands as (2, ref_pad) uint8.

    Hashes and counts are int64 holding the JAX package's uint32 values;
    ``bucket_off`` stays int32 (at k = 15 it has 2^30 + 1 entries, 4 GB).
    ``shard_range`` > 0 marks one shard of the hash-range-sharded layout
    (``sharded_device_index_from_host``).
    """

    key_hash: torch.Tensor     # (U,) int64 sorted, padded with 0xFFFFFFFF
    key_pos: torch.Tensor      # (U,) int32 1-based strand positions
    cnt_fr: torch.Tensor       # (U,) int64 packed counts at run starts
    cnt_r2: torch.Tensor       # (1,) dummy, or (U,) int32 when cnt_shift=0
    bucket_off: torch.Tensor   # (2^bb + 1,) int32
    ref_bytes: torch.Tensor    # (2, ref_pad) uint8
    ref_len: int
    shift: int = 0
    bsearch_steps: int = 21
    cnt_shift: int = 16
    shard_range: int = 0


@dataclasses.dataclass
class ShardedIndex:
    """The hash-range-sharded index as a batch on one device sees it
    (parallel/shard.shard_index): ``shards[d]``, on its own device, holds
    the lookup arrays of hashes [d * S, (d + 1) * S) with S its
    ``shard_range``; ``streams[d]`` is the lookup stream of that shard's
    card (None on the CPU); ``served[d]``, on the shard's device, counts
    the query slots it found.  ``ref_bytes`` is the copy on the batch's
    device."""

    shards: List[DeviceIndex]
    streams: List[Optional[torch.cuda.Stream]]
    served: List[torch.Tensor]
    ref_bytes: torch.Tensor


@dataclasses.dataclass
class MapOut:
    """Per-read mapping summary, (B,) each: mapped/is_fwd/overflow/inexact
    bool, the rest int32.  q/t begin/end are 0-based inclusive region
    bounds in strand coordinates; overflow: match budget exceeded (retry
    bigger); need: the exact per-read match total (max over strands);
    inexact: banded-certificate miss (the score is only a lower bound and
    the host realigns the read)."""

    mapped: torch.Tensor
    is_fwd: torch.Tensor
    q_begin: torch.Tensor
    q_end: torch.Tensor
    t_begin: torch.Tensor
    t_end: torch.Tensor
    score: torch.Tensor
    overflow: torch.Tensor
    need: torch.Tensor
    inexact: torch.Tensor

    def to_numpy(self) -> "MapOut":
        """All fields as numpy arrays, in one device-to-host copy."""
        names = [f.name for f in dataclasses.fields(self)]
        host = torch.stack([getattr(self, k).to(torch.int32)
                            for k in names]).cpu().numpy()
        vals = {k: host[i] for i, k in enumerate(names)}
        for k in ("mapped", "is_fwd", "overflow", "inexact"):
            vals[k] = vals[k].astype(bool)
        return MapOut(**vals)


def _host_combined_table(index):
    """Combined sorted table + packed counts, on the host (numpy).  Lifted
    unchanged from bioinfo1_tpu/pipeline/device_map.py, whose module
    imports JAX."""
    fh = index.fwd.hash_sorted.astype(np.uint32)
    rh = index.rev.hash_sorted.astype(np.uint32)
    fp = index.fwd.pos_sorted.astype(np.int32)
    rp = index.rev.pos_sorted.astype(np.int32)
    U = len(fh) + len(rh)
    rev_slots = np.searchsorted(fh, rh, side="right") + np.arange(
        len(rh), dtype=np.int64)
    is_rev = np.zeros(U, dtype=bool)
    is_rev[rev_slots] = True
    ks = np.empty(U, np.uint32)
    ps = np.empty(U, np.int32)
    ks[rev_slots] = rh
    ps[rev_slots] = rp
    ks[~is_rev] = fh
    ps[~is_rev] = fp
    ss = is_rev.astype(np.uint8)
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]])) \
        if U else np.zeros((0,), np.int64)
    ends = np.append(starts[1:], U)
    cum_s = np.concatenate([[0], np.cumsum(ss, dtype=np.int64)])
    rev_in = (cum_s[ends] - cum_s[starts]).astype(np.int32)
    cnt_f = np.zeros(max(U, 1), np.int64)
    cnt_r = np.zeros(max(U, 1), np.int64)
    cnt_f[starts] = (ends - starts) - rev_in
    cnt_r[starts] = rev_in
    bits_f = max(1, int(cnt_f.max()).bit_length()) if U else 1
    bits_r = max(1, int(cnt_r.max()).bit_length()) if U else 1
    if bits_f + bits_r <= 32:
        cnt_shift = 16 if (bits_f <= 16 and bits_r <= 16) else bits_f
        cnt_fr = (cnt_f | (cnt_r << cnt_shift)).astype(np.uint32)[:U]
        cnt_r2 = np.zeros(1, np.int32)
    else:
        cnt_shift = 0
        cnt_fr = cnt_f.astype(np.uint32)[:U]
        cnt_r2 = cnt_r.astype(np.int32)[:U]
    return ks, ps, cnt_fr, cnt_r2, cnt_shift


def _bucket_directory(key_hash: torch.Tensor, n_real: int, *, bb: int,
                      shift: int) -> torch.Tensor:
    """(2^bb + 1,) int32 offsets: bucket_off[b] = index of the first real
    table entry whose top bb hash bits are >= b.  Counted and summed in
    one int32 buffer (at bb = 30 that buffer is the 4 GB directory itself),
    the prefix sum in segments so no int64 copy of it is ever made."""
    b = key_hash[:n_real] >> shift
    bo = torch.zeros((1 << bb) + 1, dtype=torch.int32,
                     device=key_hash.device)
    bo.index_add_(0, b + 1, torch.ones_like(b, dtype=torch.int32))
    carry = torch.zeros(1, dtype=torch.int32, device=key_hash.device)
    seg_len = 1 << 24
    for s in range(0, bo.shape[0], seg_len):
        seg = bo[s:s + seg_len]
        seg.copy_(torch.cumsum(seg, 0, dtype=torch.int32))
        seg += carry
        carry = seg[-1:].clone()
    return bo


def _ref_bytes(index) -> np.ndarray:
    L = int(index.ref_len)
    cap = 16
    while cap < L:
        cap *= 2
    ref = np.zeros((2, cap), dtype=np.uint8)
    ref[0, :L] = np.frombuffer(index.ref_fwd_seq.encode("latin1"), np.uint8)
    ref[1, :L] = np.frombuffer(index.ref_rev_seq.encode("latin1"), np.uint8)
    return ref


def device_index_from_host(index, device: torch.device) -> DeviceIndex:
    """Pack an index.builder.IndexArrays into the combined device layout.

    Direct-address mode (a directory over the WHOLE hash space, lookups are
    two gathers) is chosen for genome-scale indexes (2k <= 30 and >= 2^20
    entries); ``BIOINFO1_DIRECT_INDEX=0/1`` overrides, as in the JAX
    package."""
    ks, ps, cnt_fr0, cnt_r20, cnt_shift = _host_combined_table(index)
    U = len(ks)
    Up = 8
    while Up < U:
        Up *= 2
    cnt_fr = np.zeros(Up, np.int64)
    cnt_fr[:U] = cnt_fr0
    if cnt_shift == 0:
        cnt_r2 = np.zeros(Up, np.int32)
        cnt_r2[:U] = cnt_r20
    else:
        cnt_r2 = cnt_r20
    # Sentinel pads sort after every real hash; their counts are 0.
    ksp = np.full(Up, 0xFFFFFFFF, np.int64)
    ksp[:U] = ks
    psp = np.zeros(Up, np.int32)
    psp[:U] = ps

    hash_bits = 2 * int(index.k)
    env_direct = os.environ.get("BIOINFO1_DIRECT_INDEX")
    if env_direct is None:
        direct = hash_bits <= 30 and U >= (1 << 20)
    else:
        direct = env_direct not in ("0", "false")
        if direct and hash_bits > 30:
            raise ValueError(
                f"BIOINFO1_DIRECT_INDEX=1 needs 2*k <= 30 hash bits (got "
                f"{hash_bits}): a 2^{hash_bits}-entry directory would not "
                "fit, and int32 bucket indexes would wrap")
    if direct:
        bb, shift, steps = hash_bits, 0, 0
    else:
        bb = max(1, min(24, hash_bits, (max(U, 2) - 1).bit_length() + 4))
        shift = max(0, hash_bits - bb)
        max_bucket = (int(np.bincount(ks >> np.uint32(shift),
                                      minlength=1).max()) if U else 1)
        steps = max(1, int(np.ceil(np.log2(max(max_bucket, 1) + 1))))

    key_hash = torch.from_numpy(ksp).to(device)
    return DeviceIndex(
        key_hash=key_hash, key_pos=torch.from_numpy(psp).to(device),
        cnt_fr=torch.from_numpy(cnt_fr).to(device),
        cnt_r2=torch.from_numpy(cnt_r2).to(device),
        bucket_off=_bucket_directory(key_hash, U, bb=bb, shift=shift),
        ref_bytes=torch.from_numpy(_ref_bytes(index)).to(device),
        ref_len=int(index.ref_len), shift=shift, bsearch_steps=steps,
        cnt_shift=cnt_shift)


def sharded_device_index_from_host(index, n_shards: int,
                                   devices: Sequence[torch.device],
                                   ) -> List[DeviceIndex]:
    """Pack the index with its lookup arrays split by hash range, shard d
    on ``devices[d]`` (port of bioinfo1_tpu/pipeline/device_map.py
    ``sharded_device_index_from_host``, whose arrays carry a leading shard
    axis instead).

    Shard d holds hashes [d*S, (d+1)*S), S = 2^(2k) / n_shards: those rows
    of the combined table, padded with 0xFFFFFFFF / 0 to the largest
    shard, and a rebased direct-address directory over its range, (S + 1,)
    int32.  Always direct-address: the directory (4 bytes per possible
    hash) is what sharding divides.  ``ref_bytes`` is one copy per
    distinct device.  Each directory is counted on its device, as
    ``device_index_from_host`` does (JAX's host bincount would be a
    2^(2k) / n_shards int64 array: 4.3 GB a shard at k = 15 over 2)."""
    hash_bits = 2 * int(index.k)
    if hash_bits > 30:
        raise ValueError(f"sharded index needs 2*k <= 30 bits (k={index.k})")
    if (1 << hash_bits) % n_shards:
        raise ValueError(f"n_shards={n_shards} must divide the hash space")
    ks, ps, cnt_fr, cnt_r2, cnt_shift = _host_combined_table(index)
    S = (1 << hash_bits) // n_shards
    bounds = np.searchsorted(ks, np.arange(n_shards + 1,
                                           dtype=np.uint64) * S)
    cap = max(int(np.diff(bounds).max()), 1)
    ref = _ref_bytes(index)
    ref_on: dict = {}
    shards = []
    for d in range(n_shards):
        dev = torch.device(devices[d])
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        n = hi - lo
        kh = np.full(cap, 0xFFFFFFFF, np.int64)
        kh[:n] = ks[lo:hi]
        kp = np.zeros(cap, np.int32)
        kp[:n] = ps[lo:hi]
        cf = np.zeros(cap, np.int64)
        cf[:n] = cnt_fr[lo:hi]
        c2 = np.zeros(cap if cnt_shift == 0 else 1, np.int32)
        if cnt_shift == 0:
            c2[:n] = cnt_r2[lo:hi]
        if dev not in ref_on:
            ref_on[dev] = torch.from_numpy(ref).to(dev)
        key_hash = torch.from_numpy(kh).to(dev)
        shards.append(DeviceIndex(
            key_hash=key_hash, key_pos=torch.from_numpy(kp).to(dev),
            cnt_fr=torch.from_numpy(cf).to(dev),
            cnt_r2=torch.from_numpy(c2).to(dev),
            bucket_off=_bucket_directory(key_hash[:n] - d * S, n,
                                         bb=S.bit_length() - 1, shift=0),
            ref_bytes=ref_on[dev], ref_len=int(index.ref_len), shift=0,
            bsearch_steps=0, cnt_shift=cnt_shift, shard_range=S))
    return shards


def device_index_from_numpy(arrays: Mapping[str, np.ndarray], shift: int,
                            bsearch_steps: int, cnt_shift: int,
                            device: torch.device) -> DeviceIndex:
    """The port's DeviceIndex from the JAX DeviceIndex's arrays as numpy
    (keys key_hash, key_pos, cnt_fr, cnt_r2, bucket_off, ref_bytes,
    ref_len), so both packages can be fed the identical index."""
    def t(name, dtype):
        return torch.from_numpy(
            np.ascontiguousarray(arrays[name]).astype(dtype)).to(device)

    return DeviceIndex(
        key_hash=t("key_hash", np.int64), key_pos=t("key_pos", np.int32),
        cnt_fr=t("cnt_fr", np.int64), cnt_r2=t("cnt_r2", np.int32),
        bucket_off=t("bucket_off", np.int32),
        ref_bytes=t("ref_bytes", np.uint8),
        ref_len=int(arrays["ref_len"]), shift=shift,
        bsearch_steps=bsearch_steps, cnt_shift=cnt_shift)


def _extract_windows(src: torch.Tensor, begin: torch.Tensor,
                     cap: int) -> torch.Tensor:
    """(B, cap) windows src[b, begin[b] : begin[b] + cap] of a (B, W)
    source; the start is clipped to [0, W] and lanes past the row end read
    zeros (the JAX gather's mode="clip" over a zero-padded source)."""
    B, W = src.shape
    src_p = torch.nn.functional.pad(src, (0, cap))
    idx = (begin.long().clamp(0, W)[:, None]
           + torch.arange(cap, device=src.device)[None, :])
    return src_p.gather(1, idx)


def _extract_flat_windows(src: torch.Tensor, begin: torch.Tensor,
                          cap: int) -> torch.Tensor:
    """(B, cap) windows src[begin[b] : begin[b] + cap] of a 1-D source; a
    window whose end overruns the source reads zeros WITHOUT shifting its
    start."""
    n = src.shape[0]
    src_p = torch.nn.functional.pad(src, (0, cap))
    idx = (begin.long().clamp(0, n)[:, None]
           + torch.arange(cap, device=src.device)[None, :])
    return src_p[idx]


def _map_core(reads, lens, index: DeviceIndex | ShardedIndex, *, k, w,
              budget, region_cap, oob_end_windows):
    """Front half of the fused step: minimize -> match -> chain -> strand
    select -> region extraction.  Returns the per-read coordinates and the
    gathered (q_win, t_win, q_len, t_len) alignment regions.  A
    ``ShardedIndex`` takes the sharded lookup (the JAX package's
    ``shard_axis`` switch); the lookup's exchange with the shards stays
    inside the ``step.lookup`` scope."""
    B, L = reads.shape
    with tracing.span("step.minimize"):
        mres = mz.minimize_batch(reads, lens, k, w,
                                 oob_end_windows=oob_end_windows)
    with tracing.span("step.lookup"):
        # Pack the ~2/(w+1) surviving slots left; the cap follows the
        # expected survivor count (+1 window of slack).  Reads with more
        # kept slots are flagged overflow and retry at a doubled budget.
        expect = -(-2 * L // ((w + 1) * 128)) * 128 + 128
        keep_cap = min(mres.hashes.shape[1], budget,
                       max(expect, budget // 2))
        q_hash, q_pos, q_keep, q_over = match_ops.compact_queries(
            mres.hashes, mres.pos, mres.dedup_keep, keep_cap)
        if isinstance(index, ShardedIndex):
            first = index.shards[0]
            got_f, got_r = match_ops.find_matches_combined_sharded(
                q_hash, q_pos, q_keep, index.shards, first.shard_range,
                budget, first.cnt_shift, streams=index.streams,
                served=index.served)
        else:
            got_f, got_r = match_ops.find_matches_combined(
                q_hash, q_pos, q_keep, index.key_hash, index.key_pos,
                index.cnt_fr, index.cnt_r2, index.bucket_off, index.shift,
                index.bsearch_steps, budget, index.cnt_shift)
    with tracing.span("step.chain"):
        # One chain call over both strands' rows (rows are independent).
        both = chain_ops.lis_chain(
            torch.cat([got_f.f_pos, got_r.f_pos]).contiguous(),
            torch.cat([got_f.r_pos, got_r.r_pos]).contiguous(),
            torch.cat([got_f.count, got_r.count]).contiguous())
    cf = chain_ops.ChainResult(*(getattr(both, f.name)[:B] for f in
                                 dataclasses.fields(both)))
    cr = chain_ops.ChainResult(*(getattr(both, f.name)[B:] for f in
                                 dataclasses.fields(both)))
    with tracing.span("step.regions"):
        use_fwd = cf.length >= cr.length          # ties forward (quirk #8)
        mapped = torch.where(use_fwd, cf.length, cr.length) > 0
        overflow = got_f.overflow | got_r.overflow | q_over
        need = torch.maximum(got_f.total, got_r.total)

        q_begin = torch.where(use_fwd, cf.q_start, cr.q_start) - 1
        q_end = torch.where(use_fwd, cf.q_end, cr.q_end) + k - 2
        t_begin = torch.where(use_fwd, cf.t_start, cr.t_start) - 1
        t_end = torch.where(use_fwd, cf.t_end, cr.t_end) + k - 2

        q_len = torch.where(mapped, q_end - q_begin + 1, 0)
        t_len = torch.where(mapped, t_end - t_begin + 1, 0)
        # Query regions lie within the read (cap L); only target regions,
        # which may span indels, need the larger region_cap.
        overflow = overflow | (t_len > region_cap)
        q_len = q_len.clamp(max=L).to(torch.int32)
        t_len = t_len.clamp(max=region_cap).to(torch.int32)

        q_win = _extract_windows(reads, q_begin.clamp(min=0), L)
        ref_pad = index.ref_bytes.shape[-1]
        t_base = (torch.where(use_fwd, 0, 1) * ref_pad
                  + t_begin.clamp(min=0))
        t_win = _extract_flat_windows(index.ref_bytes.reshape(-1), t_base,
                                      region_cap)
        return (mapped, use_fwd, q_begin, q_end, t_begin, t_end, overflow,
                q_win, t_win, q_len, t_len, need)


def map_step(reads: torch.Tensor, lens: torch.Tensor,
             index: DeviceIndex | ShardedIndex,
             match: int, mismatch: int, gap: int, *, k: int, w: int,
             mode: int, budget: int = 512, region_cap: int = 0,
             oob_end_windows: bool = False, band: int = 0,
             dash_free: bool = False) -> MapOut:
    """Map a (B, L) uint8 read batch end to end on ``reads.device``.

    ``band > 0`` takes the banded score (kernel K2) with its certificate:
    uncertified mapped reads come back ``inexact`` and the host realigns
    them, so emitted scores are always exact.  ``band == 0`` takes the
    full-matrix score (kernel K3).  ``region_cap == 0`` means the read
    width."""
    if region_cap == 0:
        region_cap = reads.shape[1]
    (mapped, use_fwd, q_begin, q_end, t_begin, t_end, overflow,
     q_win, t_win, q_len, t_len, need) = _map_core(
        reads, lens, index, k=k, w=w, budget=budget, region_cap=region_cap,
        oob_end_windows=oob_end_windows)
    inexact = torch.zeros_like(mapped)
    with tracing.span("step.align"):
        if band:
            bout = bd.align_scores_banded(q_win, q_len, t_win, t_len, match,
                                          mismatch, gap, band=band,
                                          mode=mode, dash_free=dash_free)
            certified = bd.certify(bout.score, q_win, q_len, t_win, t_len,
                                   match, mismatch, gap, band, mode=mode)
            score = bout.score
            inexact = mapped & ~certified
        else:
            score = al.align_scores(q_win, q_len, t_win, t_len, mode, match,
                                    mismatch, gap).score
    return MapOut(mapped=mapped & ~overflow, is_fwd=use_fwd,
                  q_begin=q_begin, q_end=q_end, t_begin=t_begin, t_end=t_end,
                  score=score, overflow=overflow, need=need, inexact=inexact)


@dataclasses.dataclass
class CigarOut:
    """map_step_cigar output: MapOut plus the traceback walk.

    codes: (S4 + 1, B) uint8 op codes packed 4 per byte in goal -> origin
    order (ops/trace.py); goal_i / goal_j: the walk's start cells; q_len /
    t_len: the alignment-region lengths (the decoder's semiGlobal corner
    pad needs them); certified: the strict certificate - the CIGAR is the
    full DP's; the host realigns the other mapped reads."""

    base: MapOut
    codes: torch.Tensor
    goal_i: torch.Tensor
    goal_j: torch.Tensor
    q_len: torch.Tensor
    t_len: torch.Tensor
    certified: torch.Tensor

    def to_numpy(self) -> "CigarOut":
        """All fields as numpy arrays (three device-to-host copies)."""
        host = torch.stack([self.goal_i, self.goal_j, self.q_len, self.t_len,
                            self.certified.to(torch.int32)]).cpu().numpy()
        return CigarOut(base=self.base.to_numpy(),
                        codes=self.codes.cpu().numpy(), goal_i=host[0],
                        goal_j=host[1], q_len=host[2], t_len=host[3],
                        certified=host[4].astype(bool))


def map_step_cigar(reads: torch.Tensor, lens: torch.Tensor,
                   index: DeviceIndex | ShardedIndex, match: int,
                   mismatch: int, gap: int,
                   *, k: int, w: int, mode: int, budget: int = 512,
                   region_cap: int = 0, oob_end_windows: bool = False,
                   band: int = 256, dash_free: bool = False) -> CigarOut:
    """The fused -c step: ``map_step``'s front half, then the banded score
    with parents (kernel K4) at ``band``, the strict certificate, and the
    traceback walk (kernel K5), in all three modes.  Local and semiGlobal
    goal cells come from the band's in-band argmax / rim tracking; their
    exactness is the mode-aware certificate's (ops/band.certify).
    ``base.inexact`` is all false: uncertified reads show in
    ``certified``."""
    if region_cap == 0:
        region_cap = reads.shape[1]
    (mapped, use_fwd, q_begin, q_end, t_begin, t_end, overflow,
     q_win, t_win, q_len, t_len, need) = _map_core(
        reads, lens, index, k=k, w=w, budget=budget, region_cap=region_cap,
        oob_end_windows=oob_end_windows)
    with tracing.span("step.align"):
        out = bd.align_scores_banded(q_win, q_len, t_win, t_len, match,
                                     mismatch, gap, band=band, mode=mode,
                                     dash_free=dash_free, want_parents=True)
        certified = bd.certify(out.score, q_win, q_len, t_win, t_len, match,
                               mismatch, gap, band, strict=True, mode=mode)
    with tracing.span("step.walk"):
        codes = tr.walk_parents(out.parents, out.goal_i, out.goal_j,
                                out.score, q_win, t_win, match, mismatch,
                                gap, mode)
    base = MapOut(mapped=mapped & ~overflow, is_fwd=use_fwd,
                  q_begin=q_begin, q_end=q_end, t_begin=t_begin, t_end=t_end,
                  score=out.score, overflow=overflow, need=need,
                  inexact=torch.zeros_like(mapped))
    return CigarOut(base=base, codes=codes, goal_i=out.goal_i,
                    goal_j=out.goal_j, q_len=q_len, t_len=t_len,
                    certified=certified)
