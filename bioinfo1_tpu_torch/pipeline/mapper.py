"""End-to-end batched read mapping (port of bioinfo1_tpu/pipeline/mapper.py).

Read batches move through fixed-shape device stages (pipeline/device_map.py):

    pack -> map_step (minimize, match, chain, region gather, DP score)
         -> [realign pass for certificate misses] -> PAF rows (host)

With ``-c`` the step is ``map_step_cigar`` (banded score + parents, strict
certificate, traceback walk on the device); the host run-length encodes
the packed op codes into the ``cg:Z:`` column, and certificate misses take
the realign pass with parents and the walk.

Shapes are controlled as in the JAX package: reads are length-bucketed on
the 1.5-step ladder, per-read match budgets start at ~3L/8 and overflowing
reads retry at a budget covering their exact need (bucket boosts combine
with per-read multipliers by max, and decay when a clean batch needs less
than half).  Output order is input order.

Reads the fused step cannot finish take the staged host path
(``Mapper._map_bucket``, the JAX package's ``_map_bucket``): per-strand
lookups (``ops/match.find_matches``), chains (K1) and the DP dispatched from
the host - every read when FASTA match nesting is on (``--bug-compat`` on a
FASTA reads file), stragglers after two fused attempts, and certificate
misses no realign pass can settle, which is every read under ``-c`` when no
exactness certificate exists (global mode with gap >= 0, local or
semiGlobal with gap > 0).  There the DP is K4 at a band that covers the
whole matrix - the full DP - walked by K5; the JAX package runs a
full-matrix wavefront with its own parent layout instead, with the same
parents and goal cell.

A batch that raises is isolated as in the JAX package: counted in
``MapperCounters.faults``, reported on stderr with the reference's line,
and retried - on the device at the same budget after an out-of-memory
error (up to 6 attempts), else on the host path - or, when the host path
itself fails, reported unmapped.  A CUDA error that the host path meets
again ends the run (a sticky error poisons the context).

With more than one device (``cfg.devices`` on CUDA: 0 = the largest
power-of-two prefix of the local devices, N = at most N, 1 = one; or an
explicit list) the batches are dealt to the devices in turn
(parallel/shard.py): each batch - fused step, realign pass and host path -
runs wholly on its device against that device's index copy.  The JAX
package splits every batch over its mesh instead; here that would repeat
the step's host dispatch once per slice.  A large index (or
``BIOINFO1_INDEX_SHARD=1``; ``_index_shard_count``) is split by hash range
over the devices instead of copied: a batch's lookup then goes out to
every shard, and the rest of its step stays on its device.  The staged
host path's per-strand tables stay one copy per device, as the JAX
package's ``_map_bucket`` is not sharded either.

The host steps carry ``record_function`` scopes that name them in a trace
(utils/tracing.device_trace): ``map_batch``; ``fused`` with ``fused.pack``,
``.upload``, ``.step``, ``.fetch`` and ``.adapt``; ``realign``,
``band_pass``, ``host_path``, ``decode``; and on the caller's thread
``iter.wait`` (waiting for a batch) and ``format``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from bioinfo1_tpu_torch import native
from bioinfo1_tpu_torch.index import builder
from bioinfo1_tpu_torch.utils import cigar as cg
from bioinfo1_tpu_torch.utils import stats as st
from bioinfo1_tpu_torch.ops import align as al
from bioinfo1_tpu_torch.ops import band as bd
from bioinfo1_tpu_torch.ops import chain as chain_ops
from bioinfo1_tpu_torch.ops import match as match_ops
from bioinfo1_tpu_torch.ops import minimizer as mz
from bioinfo1_tpu_torch.ops import trace as tr
from bioinfo1_tpu_torch.parallel import shard as ps
from bioinfo1_tpu_torch.pipeline import device_map as dm
from bioinfo1_tpu_torch.utils.runtime import resolve_device
from bioinfo1_tpu_torch.utils.tracing import scoped


@dataclasses.dataclass
class MapperConfig:
    """Mirror of the reference CLI knobs (team_mapper.cpp:329-334 defaults)."""

    align_type: str = "global"
    match: int = 1
    mismatch: int = -1
    gap: int = -1
    k: int = 15
    w: int = 5
    f: float = 0.001
    output_cigar: bool = False
    sam_cigar: bool = False          # extension: emit SAM-convention CIGARs
    # bug-compat switches (False = fixed semantics)
    banned_rev_from_fwd: bool = False
    fasta_match_nesting: bool = False
    local_target_begin_end: bool = False
    threshold_from_rev_unique: bool = False
    exact_ties: bool = False
    oob_end_windows: bool = False
    # batching knobs
    batch_size: int = 512
    initial_match_budget: int = 512
    bucket_growth: float = 1.5
    # device parallelism: 0 = all local devices (largest pow-2 prefix),
    # 1 = force single-device, N = deal batches to at most N devices
    devices: int = 0


@dataclasses.dataclass
class MapperCounters:
    """Pipeline observability: DP problem-size cells, certificate hit rate,
    retry counts, and where batch wall time goes (summed over worker
    threads, so these can exceed the run's wall time)."""

    reads: int = 0
    mapped: int = 0
    dp_cells: float = 0.0          # sum of region (n+1)*(m+1) for mapped reads
    batches: int = 0
    cert_total: int = 0            # mapped reads through a certified path
    cert_hits: int = 0
    budget_retries: int = 0        # match-budget overflow reruns
    realign_reroutes: int = 0      # certificate misses sent to a realign pass
    host_fallbacks: int = 0        # reads the fused path handed to the host path
    faults: int = 0                # batches that raised and were isolated
    realign_batches: int = 0       # realign passes run
    realign_chunks: int = 0        # their device dispatches (-c splits them)
    t_fused_s: float = 0.0         # fused step dispatch + fetch
    t_realign_s: float = 0.0       # realign passes
    t_host_s: float = 0.0          # staged host-path batches
    t_decode_s: float = 0.0        # native CIGAR decode
    t_format_s: float = 0.0        # stats + PAF serialization

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.cert_total:
            d["cert_hit_rate"] = round(self.cert_hits / self.cert_total, 4)
        for k in ("t_fused_s", "t_realign_s", "t_host_s", "t_decode_s",
                  "t_format_s"):
            d[k] = round(d[k], 3)
        return d


@dataclasses.dataclass
class ReadMapping:
    """One read's mapping result."""

    mapped: bool
    is_fwd: bool = True
    q_begin: int = 0
    q_end: int = 0            # inclusive
    t_begin: int = 0          # in strand coordinates (RC coords for rev)
    t_end: int = 0            # inclusive
    score: int = 0
    cigar: Optional[str] = None
    target_begin: Optional[int] = None


@dataclasses.dataclass
class BandPass:
    """Host copies of one banded pass over packed region pairs: (rows,)
    arrays, ``codes`` the packed walk codes (None without parents), and the
    number of device dispatches it took."""

    certified: np.ndarray
    score: np.ndarray
    goal_i: np.ndarray
    goal_j: np.ndarray
    codes: Optional[np.ndarray]
    chunks: int


# Ceiling on one dispatch's parent tensor (the -c path's largest device
# buffer): the fused step sizes its band by it, the realign pass its chunks.
_PARENT_BYTES = 4e9


def _pow2_at_least(x: int, floor: int = 8) -> int:
    v = floor
    while v < x:
        v *= 2
    return v


def _bucket_cap(ln: int, floor: int = 16) -> int:
    """Length-bucket cap: powers of two interleaved with 3/4-points above
    512 (..., 1024, 1536, 2048, 3072, 4096, 6144, ...)."""
    p = _pow2_at_least(max(ln, floor), 16)
    if p >= 512 and 3 * p // 4 >= ln:
        return 3 * p // 4
    return p


def _region_cap(cap: int) -> int:
    """Target-region width for a length bucket: ~2x the query cap on the
    same 1.5-step ladder."""
    return _bucket_cap(2 * cap, 16)


def _batch_cap(b: int, floor: int) -> int:
    """Batch size: powers of two interleaved with 64-divisible 3/4-points
    (192, 384, 768, ...)."""
    p = _pow2_at_least(b, floor)
    q = 3 * p // 4
    if q >= b and q % 64 == 0 and q % max(floor, 1) == 0:
        return q
    return p


def _pack_reads(seqs: Sequence[str], min_len: int,
                len_to: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Pack strings into a right-padded (B, L) uint8 batch with canonical
    dims (``len_to`` pins L to the caller's bucket cap; B is at least 8)."""
    L = max(max((len(s) for s in seqs), default=1), min_len)
    L = max(L, len_to) if len_to >= L else _pow2_at_least(L, 16)
    B = _batch_cap(len(seqs), 8)
    arr = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode("latin1"), dtype=np.uint8)
        arr[i, : len(b)] = b
        lens[i] = len(b)
    return arr, lens


def _bucket_indices(lengths: Sequence[int], growth: float,
                    floor: int) -> List[List[int]]:
    """Group read indices by length-bucket cap, smallest cap first."""
    buckets_by_cap: dict = {}
    for i, ln in enumerate(lengths):
        buckets_by_cap.setdefault(_bucket_cap(ln, floor), []).append(i)
    return [buckets_by_cap[c] for c in sorted(buckets_by_cap)]


def _needed_band_arr(ql, tl, score, match: int, mismatch: int, gap: int,
                     mode: int, strict: bool):
    """Per-read minimal band W certifying the banded result, solved from
    ops/band.certify's bounds (``strict`` adds the one-point margin the
    traceback guarantee needs; ties are fine when only the score is
    emitted).  None when no finite band certifies (global with
    gap >= 0)."""
    maxsub = max(match, mismatch, 0)
    diff = tl - ql
    eps = 1 if strict else 0
    if mode == 0:
        if gap >= 0:
            return None
        need2 = (-(-(maxsub * np.minimum(ql, tl) - score + eps) // (-gap))
                 + np.abs(diff))
        # certify's goal_in_band term also needs W >= |tl-ql| + 2.
        return np.maximum(need2 // 2 + 2, np.abs(diff) + 2)
    if maxsub <= 0:
        return np.zeros_like(ql)
    F = (score - eps) // maxsub
    w1 = np.where(ql <= F, 0, tl + 1 - F)
    w2 = np.where(tl <= F, 0, ql + 1 - F)
    return np.maximum(np.maximum(w1, w2), 0)


def _decode_cigars(packed_codes, idxs, goal_i, goal_j, q_len, t_len,
                   cfg: MapperConfig):
    """(cigars, target_begins) of the selected reads, decoded from the
    packed walk codes by native/cigar.cpp; utils.cigar.cigar_from_codes on
    the unpacked codes is its spec and the fallback."""
    idxs = np.asarray(idxs, dtype=np.int32)
    gi = np.asarray(goal_i)[idxs]
    gj = np.asarray(goal_j)[idxs]
    ql = np.asarray(q_len)[idxs]
    tl = np.asarray(t_len)[idxs]
    nat = native.cigar_rle_batch(
        packed_codes, idxs, gi, gj, ql, tl, cfg.align_type,
        sam_convention=cfg.sam_cigar,
        local_target_begin_end=cfg.local_target_begin_end)
    if nat is not None:
        return nat
    codes = tr.unpack_codes(packed_codes)
    cigs, tbs = [], []
    for loc, i in enumerate(idxs):
        c, tb = cg.cigar_from_codes(
            codes[:, i], cfg.align_type, int(gi[loc]), int(gj[loc]),
            int(ql[loc]), int(tl[loc]), sam_convention=cfg.sam_cigar,
            local_target_begin_end=cfg.local_target_begin_end)
        cigs.append(c)
        tbs.append(tb)
    return cigs, tbs


def paf_line(name: str, read_len: int, m: ReadMapping, ref_name: str,
             ref_len: int, output_cigar: bool) -> str:
    """One PAF row (team_mapper.cpp:685-698): 12 tab columns, DP score in
    the residue-matches column, literal mapq 60, and with ``output_cigar``
    a ``cg:Z:`` column; rev-strand target coords flipped back to
    forward."""
    if m.is_fwd:
        t_start_out, t_end_out = m.t_begin, m.t_end + 1
    else:
        t_start_out = ref_len - m.t_end - 1
        t_end_out = ref_len - m.t_begin
    fields = [
        name, str(read_len), str(m.q_begin), str(m.q_end + 1),
        "+" if m.is_fwd else "-", ref_name, str(ref_len),
        str(t_start_out), str(t_end_out),
        str(m.score), str(m.q_end - m.q_begin + 1), "60",
    ]
    if output_cigar:
        fields.append(f"cg:Z:{m.cigar}")
    return "\t".join(fields)


def certificate_possible(cfg: MapperConfig) -> bool:
    """Whether banded results can be certified exact: gap < 0 in global
    mode, gap <= 0 in local and semiGlobal mode (ops/band.certify)."""
    return cfg.gap < 0 if cfg.align_type == "global" else cfg.gap <= 0


def _is_cuda_error(e: Exception) -> bool:
    """A CUDA error: a kernel launch refused or failed
    (``kernels/build.launch``'s message) or one that PyTorch reports."""
    return "CUDA error" in str(e)


def _free_memory_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _index_shard_count(k: int, n_entries: int, n_devices: int) -> int:
    """How many hash-range shards the index of a mapper with ``n_devices``
    entries uses (0 = replicate): the JAX package's ``Mapper.
    _index_shard_count``, with the entry count in place of its mesh size.

    One entry never shards.  BIOINFO1_INDEX_SHARD: 0/false/off replicates,
    1/true/on shards, any other value (auto, the default) shards when the
    replicated lookup structures' estimate - the JAX package's layout, 12
    bytes an entry plus its direct directory - exceeds
    BIOINFO1_INDEX_BUDGET bytes (6e9 by default).  Sharding needs 2k <= 30
    and a shard count that divides the hash space."""
    if n_devices <= 1:
        return 0
    mode = os.environ.get("BIOINFO1_INDEX_SHARD", "auto")
    if mode in ("0", "false", "off"):
        return 0
    hash_bits = 2 * k
    if hash_bits > 30 or (1 << hash_bits) % n_devices:
        return 0
    if mode in ("1", "true", "on"):
        return n_devices
    direct = n_entries >= (1 << 20)
    est = n_entries * 12 + (4 * ((1 << hash_bits) + 1) if direct else 0)
    budget = float(os.environ.get("BIOINFO1_INDEX_BUDGET", 6e9))
    return n_devices if est > budget else 0


class Mapper:
    """Reusable mapping engine bound to one reference index and its devices.

    ``device`` (default: ``resolve_device()``) is the first device; on CUDA
    ``cfg.devices`` adds the local devices after it (``ps.local_devices``).
    ``devices``, an explicit list instead of ``device`` (a device may
    repeat: the tests deal over ``[cpu] * N``), sets them all.  Batches are
    dealt to ``self.devices`` in turn."""

    def __init__(self, reference_records: Sequence[Tuple[str, str]],
                 cfg: MapperConfig, load_index: Optional[str] = None,
                 device: Optional[torch.device] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        self.cfg = cfg
        if devices is None:
            device = device if device is not None else resolve_device()
            devices = ([device] if device.type != "cuda" or cfg.devices == 1
                       else ps.local_devices(device, cfg.devices))
        elif device is not None:
            raise ValueError("Mapper: give device or devices, not both")
        self.devices = ps.DeviceSet(devices)
        self.device = self.devices.devices[0]
        # Only the first reference record is used (quirk #10).
        self.ref_name, reference = reference_records[0]
        if load_index:
            self.index = builder.load_index(load_index)
            self.index.ref_fwd_seq = reference
            self.index.ref_rev_seq = builder.reverse_complement_str(reference)
        else:
            self.index = builder.build_index(
                reference, cfg.k, cfg.w, cfg.f,
                banned_rev_from_fwd=cfg.banned_rev_from_fwd,
                threshold_from_rev_unique=cfg.threshold_from_rev_unique,
                exact_ties=cfg.exact_ties,
                oob_end_windows=cfg.oob_end_windows)
        self.ref_len = len(reference)
        self._mode = al.MODE_BY_NAME[cfg.align_type]
        # Without a certificate a banded pass could never certify, so such
        # score-only configs take the full-matrix score from their first
        # batch on.
        self._cert_possible = certificate_possible(cfg)
        # One genome scan enabling the kernels' dash-free specialization
        # (the literal-'-' free-gap rule); sticky-false once a batch holds
        # a '-' so a stream never alternates variants.
        self._ref_dash_free = ("-" not in self.index.ref_fwd_seq
                               and "-" not in self.index.ref_rev_seq)
        self._dash_free_sticky = True
        self.counters = MapperCounters()
        self._counters_lock = threading.Lock()   # map_batch runs on workers
        self._band_by_key: dict = {}     # (cap, for_cigar) -> band
        self._budget_boost: dict = {}    # cap -> pow-2 budget multiplier
        self._load_band_cache()
        self._device_index: Optional[dict] = None   # device -> its view
        self._strand_tensors: dict = {}             # device -> strands

    def device_index(self) -> dm.DeviceIndex | dm.ShardedIndex:
        """The index as the batch on this thread's device sees it (the
        first device outside a batch), packed at first use: replicated, one
        copy per device, uploaded to the first device and copied from there
        to the others; or, when ``_index_shard_count`` says so, split by
        hash range over the entries (``ps.shard_index``)."""
        # Locked: two first batches racing here would upload it twice.
        with self._counters_lock:
            if self._device_index is None:
                n_entries = (len(self.index.fwd.hash_sorted)
                             + len(self.index.rev.hash_sorted))
                if _index_shard_count(self.cfg.k, n_entries,
                                      len(self.devices.devices)):
                    self._device_index = ps.shard_index(self.index,
                                                        self.devices)
                else:
                    self._device_index = ps.replicate_index(
                        dm.device_index_from_host(self.index, self.device),
                        self.devices)
            return self._device_index[self.devices.current()]

    def _band_cache_path(self):
        """Adaptive-band persistence (perf-only state), keyed by the scoring
        and mode config.  The port keeps its own file so the two packages
        never share adaptation state; BIOINFO1_BAND_CACHE overrides the
        location ('0' disables)."""
        env = os.environ.get("BIOINFO1_BAND_CACHE")
        if env in ("0", "false"):
            return None, None
        path = env or os.path.join(tempfile.gettempdir(),
                                   "bioinfo1_tpu_torch_bands.json")
        cfg = self.cfg
        key = (f"{cfg.align_type},{cfg.match},{cfg.mismatch},{cfg.gap},"
               f"{cfg.k},{cfg.w}")
        return path, key

    def _load_band_cache(self) -> None:
        path, key = self._band_cache_path()
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as fh:
                d = json.load(fh).get(key, {})
            for k, v in d.items():
                if k.startswith("boost,"):
                    self._budget_boost[int(k.split(",")[1])] = int(v)
                    continue
                cap_s, fc_s = k.split(",")
                self._band_by_key[(int(cap_s), fc_s == "1")] = int(v)
        except (OSError, ValueError, AttributeError):
            # A corrupt or foreign cache only costs re-adaptation.
            self._band_by_key.clear()
            self._budget_boost.clear()

    def _save_band_cache(self) -> None:
        path, key = self._band_cache_path()
        if not path or not (self._band_by_key or self._budget_boost):
            return
        try:
            d = {}
            if os.path.exists(path):
                with open(path) as fh:
                    d = json.load(fh)
            d.setdefault(key, {})
            for (cap, fc), band in self._band_by_key.items():
                d[key][f"{cap},{1 if fc else 0}"] = band
            for cap, boost in self._budget_boost.items():
                d[key][f"boost,{cap}"] = boost
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(d, fh)
            os.replace(tmp, path)
        except (OSError, ValueError):
            pass    # perf-only state: a read-only temp dir costs nothing

    def _bucket_band(self, cap: int, for_cigar: bool = False) -> int:
        """Current band for a length bucket (adaptive: _adapt_band_score,
        and the -c persistence in _map_bucket_fused).  -c always bands."""
        key = (cap, for_cigar)
        b = self._band_by_key.get(key)
        if b is None:
            b = 256 if (for_cigar or (cap > 512 and self._cert_possible)) \
                else 0
            self._band_by_key[key] = b
        return b

    def _max_fused_band(self, cap: int, batch: int) -> int:
        """Band ceiling of the fused -c step: its parent tensor is
        ~(3*cap/4)*batch*W bytes (4 steps per byte); keep it under
        _PARENT_BYTES and never wider than the whole-matrix threshold
        (W >= region_cap + 2)."""
        mem_cap = int(_PARENT_BYTES // max(3 * cap * batch // 4, 1))
        return min(_region_cap(cap) + 128,
                   max(256, (mem_cap // 128) * 128))

    @scoped("fused.adapt")
    def _adapt_band_cigar(self, cap: int, cig: dm.CigarOut, n_real: int,
                          band: int, max_band: int) -> None:
        """Persist the -c band for future batches: the largest needed band,
        capped at 2x the 99th percentile so one outlier does not widen every
        later batch's parent stream (it pays the realign pass instead)."""
        out = cig.base
        mapped = out.mapped[:n_real]
        if not mapped.any():
            return
        cfg = self.cfg
        need = _needed_band_arr(
            cig.q_len[:n_real], cig.t_len[:n_real], out.score[:n_real],
            cfg.match, cfg.mismatch, cfg.gap, self._mode, strict=True)
        if need is None:
            persist = band
        else:
            w99 = float(np.percentile(need[mapped], 99))
            w100 = float(need[mapped].max())
            persist = -(-int(max(min(w100, 2 * w99), 256)) // 128) * 128
        self._band_by_key[(cap, True)] = min(max(persist, 256), max_band)

    @scoped("fused.adapt")
    def _adapt_band_score(self, cap: int, out: dm.MapOut,
                          n_real: int) -> None:
        """Retune the bucket's band from the observed scores: the minimal
        certifying band solves directly from certify's bound, sized for the
        99th-percentile mapped read and clamped to cap/2."""
        band = self._band_by_key.get((cap, False), 0)
        cfg = self.cfg
        if not band:
            return
        mode = self._mode
        if not self._cert_possible:
            self._band_by_key[(cap, False)] = 0
            return
        W = -(-band // 128) * 128
        ql = np.minimum(out.q_end - out.q_begin + 1, cap)[:n_real]
        tl = np.minimum(out.t_end - out.t_begin + 1,
                        _region_cap(cap))[:n_real]
        score = out.score[:n_real]
        mapped = out.mapped[:n_real]
        n_mapped = int(mapped.sum())
        if not n_mapped:
            return
        w_need_arr = _needed_band_arr(ql, tl, score, cfg.match, cfg.mismatch,
                                      cfg.gap, mode, strict=False)
        whole = (ql <= W) & (tl <= W - 2)
        cert = whole | (w_need_arr <= W)
        w_need_arr = np.where(mapped, w_need_arr, 0)
        with self._counters_lock:
            self.counters.cert_total += n_mapped
            self.counters.cert_hits += int((mapped & cert).sum())
        if not bool((mapped & ~cert).any()):
            return
        w99 = float(np.percentile(w_need_arr[mapped], 99))
        new = -(-int(max(w99, band)) // 128) * 128
        max_band = max(128, (cap // 2 // 128) * 128)
        self._band_by_key[(cap, False)] = min(new, max_band)

    def _to_device(self, *arrays: np.ndarray):
        """Host arrays on the device of this thread's batch."""
        dev = self.devices.current()
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def _strand_index(self, fwd: bool):
        """One strand's sorted (hash, pos) index on the device of this
        thread's batch, for the staged path's per-strand lookups; uploaded
        there at first use."""
        dev = self.devices.current()
        with self._counters_lock:
            if dev not in self._strand_tensors:
                self._strand_tensors[dev] = tuple(
                    (torch.from_numpy(s.hash_sorted.astype(np.int64))
                     .to(dev),
                     torch.from_numpy(s.pos_sorted.astype(np.int32))
                     .to(dev))
                    for s in (self.index.fwd, self.index.rev))
                if dev.type == "cuda":
                    # Other streams of the card read them.
                    torch.cuda.current_stream(dev).synchronize()
            return self._strand_tensors[dev][0 if fwd else 1]

    def _region_strings(self, seq: str, qb: int, qe: int, tb: int, te: int,
                        fwd: bool) -> Tuple[str, str]:
        """Query and target region of one read.  Chain coordinates past
        either end (oob end windows) read NULs, like the reference's
        pointer arithmetic into a c_str."""
        q = seq[qb: qe + 1]
        q += "\0" * (qe - qb + 1 - len(q))
        src = self.index.ref_fwd_seq if fwd else self.index.ref_rev_seq
        t = src[tb: te + 1]
        t += "\0" * (te - tb + 1 - len(t))
        return q, t

    @scoped("band_pass")
    def _banded_pass(self, qa: np.ndarray, ql: np.ndarray, ta: np.ndarray,
                     tl: np.ndarray, W: int, dash_free: bool,
                     want_parents: bool, strict: bool) -> BandPass:
        """Banded alignment of packed region pairs at band W (K2, or K4
        with ``want_parents``), its certificate and, with parents, the walk
        (K5).  With parents the rows go in chunks whose parent tensor stays
        under _PARENT_BYTES (a read's result does not depend on its
        chunk)."""
        cfg, mode = self.cfg, self._mode
        q_all, ql_all, t_all, tl_all = self._to_device(qa, ql, ta, tl)
        n_rows = qa.shape[0]
        size = n_rows
        if want_parents:
            n_steps = bd.band_shapes(qa.shape[1], ta.shape[1], W)[3]
            size = max(1, int(_PARENT_BYTES
                              // (bd.parent_rows(n_steps) * W)))
        host, packed = [], []
        for lo in range(0, n_rows, size):
            q_d, ql_d, t_d, tl_d = (x[lo:lo + size] for x in
                                    (q_all, ql_all, t_all, tl_all))
            out = bd.align_scores_banded(
                q_d, ql_d, t_d, tl_d, cfg.match, cfg.mismatch, cfg.gap,
                band=W, mode=mode, dash_free=dash_free,
                want_parents=want_parents)
            cert_d = bd.certify(out.score, q_d, ql_d, t_d, tl_d, cfg.match,
                                cfg.mismatch, cfg.gap, W, strict=strict,
                                mode=mode)
            host.append(torch.stack([cert_d.to(torch.int32), out.score,
                                     out.goal_i, out.goal_j]).cpu().numpy())
            if want_parents:
                packed.append(tr.walk_parents(
                    out.parents, out.goal_i, out.goal_j, out.score, q_d, t_d,
                    cfg.match, cfg.mismatch, cfg.gap, mode).cpu().numpy())
                del out     # frees the parents before the next chunk
        h = np.concatenate(host, axis=1)
        codes = np.concatenate(packed, axis=1) if packed else None
        return BandPass(h[0].astype(bool), h[1], h[2], h[3], codes,
                        len(host))

    @scoped("decode")
    def _timed_decode(self, codes, sel, goal_i, goal_j, ql, tl) -> dict:
        """{read: (cigar, target_begin)} of the selected reads."""
        if not len(sel):
            return {}
        t_dec = time.perf_counter()
        cigs, tbs = _decode_cigars(codes, sel, goal_i, goal_j, ql, tl,
                                   self.cfg)
        with self._counters_lock:
            self.counters.t_decode_s += time.perf_counter() - t_dec
        return dict(zip((int(i) for i in sel), zip(cigs, tbs)))

    @scoped("realign")
    def _realign_bucket(self, seqs: Sequence[str], hints: dict,
                        ) -> Tuple[List[ReadMapping], List[int]]:
        """Certificate misses: re-run only the banded alignment at the band
        each read's own fused score (an exact lower bound) proves
        certifiable, reusing the exact chain coordinates from the failed
        pass; under -c with parents, the strict certificate and the walk.
        One pass covers every missed read across length buckets.
        Returns (results, locs that still missed)."""
        cfg = self.cfg
        want_cigar = cfg.output_cigar
        pairs = [self._region_strings(seqs[i], *hints[i][1:6])
                 for i in range(len(seqs))]
        qa, ql = _pack_reads([q for q, _ in pairs], 1)
        ta, tl = _pack_reads([t for _, t in pairs], 1)
        w_whole = max(qa.shape[1], ta.shape[1] + 2)
        W = min(_pow2_at_least(max(max(h[0] for h in hints.values()), 256),
                               256), -(-w_whole // 128) * 128)
        dash_free = bool(self._dash_free_sticky and self._ref_dash_free
                         and not (qa == 45).any() and not (ta == 45).any())
        n_reads = len(seqs)
        # Non-strict for score-only callers: ties are fine when only the
        # score is emitted.
        res = self._banded_pass(qa, ql, ta, tl, W, dash_free, want_cigar,
                                strict=want_cigar)
        cert, scores = res.certified[:n_reads], res.score
        cig_by_i = (self._timed_decode(res.codes, np.flatnonzero(cert),
                                       res.goal_i, res.goal_j, ql, tl)
                    if want_cigar else {})
        with self._counters_lock:
            self.counters.cert_total += n_reads
            self.counters.cert_hits += int(cert.sum())
            self.counters.batches += 1
            self.counters.realign_batches += 1
            self.counters.realign_chunks += res.chunks
        results: List[ReadMapping] = []
        missed: List[int] = []
        for i in range(n_reads):
            _, qb, qe, tb, te, fwd, _ = hints[i]
            if not cert[i]:
                results.append(ReadMapping(mapped=False))
                missed.append(i)
                continue
            cigar, target_begin = cig_by_i.get(i, (None, None))
            results.append(ReadMapping(
                mapped=True, is_fwd=bool(fwd), q_begin=qb, q_end=qe,
                t_begin=tb, t_end=te, score=int(scores[i]), cigar=cigar,
                target_begin=target_begin))
        return results, missed

    @scoped("host_path")
    def _map_bucket(self, seqs: Sequence[str], budget: int,
                    band_hint: int = 0,
                    ) -> Tuple[List[ReadMapping], List[int]]:
        """The staged host path for one group of reads (port of the JAX
        package's ``_map_bucket``): minimize, per-strand lookup and chain
        (K1), strand choice and region strings on the host, then the DP.
        Returns the results and the reads that overflowed ``budget``.

        Score-only runs the full-matrix score (K3).  Under -c, regions
        wider than 512 whose configuration has a certificate run K4 at band
        256 (or the band ``band_hint`` proves), retry once at the band the
        misses need, and fall through to the whole-matrix band; everything
        else goes straight to K4 at a band that covers the whole matrix,
        which is the full DP: same scores, parents and goal cell.  K5
        walks the parents."""
        cfg = self.cfg
        k, w = self.index.k, self.index.w
        arr, lens = _pack_reads(seqs, k + w - 1)
        arr_d, lens_d = self._to_device(arr, lens)
        mres = mz.minimize_batch(arr_d, lens_d, k, w,
                                 oob_end_windows=cfg.oob_end_windows)
        fwd_hash, fwd_pos = self._strand_index(True)
        rev_hash, rev_pos = self._strand_index(False)
        keep_rev = mres.dedup_keep
        if cfg.fasta_match_nesting:
            # Bug-compat: rev lookups gated on a fwd-index hit per
            # minimizer (team_mapper.cpp:629-638).
            keep_rev = keep_rev & match_ops.hash_present(fwd_hash,
                                                         mres.hashes)
        rows = []
        for keep, idx_hash, idx_pos in ((mres.dedup_keep, fwd_hash, fwd_pos),
                                        (keep_rev, rev_hash, rev_pos)):
            got = match_ops.find_matches(mres.hashes, mres.pos, keep,
                                         idx_hash, idx_pos, budget)
            ch = chain_ops.lis_chain(got.f_pos, got.r_pos, got.count)
            rows += [got.overflow.to(torch.int32), ch.length, ch.q_start,
                     ch.q_end, ch.t_start, ch.t_end]
        host = torch.stack(rows).cpu().numpy()
        (over_f, len_f, qs_f, qe_f, ts_f, te_f,
         over_r, len_r, qs_r, qe_r, ts_r, te_r) = host
        overflow = (over_f | over_r).astype(bool)

        # Longer chain wins, ties forward (team_mapper.cpp:644-648); 1-based
        # minimizer positions -> 0-based inclusive windows extended by k
        # (team_mapper.cpp:653-656).
        use_fwd = len_f >= len_r
        have = np.where(use_fwd, len_f, len_r) > 0
        q_begin = np.where(use_fwd, qs_f, qs_r) - 1
        q_end = np.where(use_fwd, qe_f, qe_r) + k - 2
        t_begin = np.where(use_fwd, ts_f, ts_r) - 1
        t_end = np.where(use_fwd, te_f, te_r) + k - 2

        results = [ReadMapping(mapped=False) for _ in seqs]
        retry = [i for i in range(len(seqs)) if overflow[i]]
        jobs = [i for i in range(len(seqs)) if have[i] and not overflow[i]]
        if not jobs:
            return results, retry
        pairs = [self._region_strings(seqs[i], int(q_begin[i]),
                                      int(q_end[i]), int(t_begin[i]),
                                      int(t_end[i]), bool(use_fwd[i]))
                 for i in jobs]
        qa, ql = _pack_reads([q for q, _ in pairs], 1)
        ta, tl = _pack_reads([t for _, t in pairs], 1)
        n_jobs = len(jobs)
        cig_by_b: dict = {}
        if not cfg.output_cigar:
            q_d, ql_d, t_d, tl_d = self._to_device(qa, ql, ta, tl)
            scores = al.align_scores(q_d, ql_d, t_d, tl_d, self._mode,
                                     cfg.match, cfg.mismatch,
                                     cfg.gap).score.cpu().numpy()
        else:
            dash_free = not ((qa == 45).any() or (ta == 45).any())
            # The certificate needs the mode's gap sign and, in global
            # mode, no literal '-' byte.
            cert_ok = self._cert_possible and not (self._mode == 0
                                                   and not dash_free)
            w_whole = -(-max(int(ql.max()), int(tl.max()) + 2) // 128) * 128
            res = None
            if qa.shape[1] > 512 and cert_ok:
                band = 256
                if band_hint:
                    band = min(
                        _pow2_at_least(max(band_hint, 256), 256),
                        -(-max(qa.shape[1], ta.shape[1] + 2) // 128) * 128)
                res = self._banded_pass(qa, ql, ta, tl, band, dash_free,
                                        True, strict=True)
                cert = res.certified[:n_jobs]
                if not cert.all():
                    # Retry once at the band the misses provably certify
                    # at, solved from the first pass's scores (exact lower
                    # bounds), capped at the whole-matrix width.
                    w_need = _needed_band_arr(
                        ql.astype(np.int64), np.minimum(tl, ta.shape[1]),
                        res.score, cfg.match, cfg.mismatch, cfg.gap,
                        self._mode, strict=True)[:n_jobs]
                    W2 = min(_pow2_at_least(
                        max(int(np.max(w_need[~cert])), 2 * band), 512),
                        w_whole)
                    res = self._banded_pass(qa, ql, ta, tl, W2, dash_free,
                                            True, strict=True)
                    if not res.certified[:n_jobs].all():
                        res = None
            if res is None:
                res = self._banded_pass(qa, ql, ta, tl, w_whole, dash_free,
                                        True, strict=True)
            if not res.certified[:n_jobs].all():
                raise RuntimeError(
                    f"staged path: band {w_whole} does not cover the whole "
                    "matrix of every region")
            scores = res.score
            cig_by_b = self._timed_decode(res.codes, np.arange(n_jobs),
                                          res.goal_i, res.goal_j, ql, tl)
        for b, i in enumerate(jobs):
            cigar, target_begin = cig_by_b.get(b, (None, None))
            results[i] = ReadMapping(
                mapped=True, is_fwd=bool(use_fwd[i]),
                q_begin=int(q_begin[i]), q_end=int(q_end[i]),
                t_begin=int(t_begin[i]), t_end=int(t_end[i]),
                score=int(scores[b]), cigar=cigar, target_begin=target_begin)
        return results, retry

    @scoped("fused")
    def _map_bucket_fused(self, seqs: Sequence[str], budget: int):
        """One fused device batch (``map_step``, or ``map_step_cigar``
        under -c).  Returns (results, budget_retry, realign, realign_hint,
        need): budget_retry reads overflowed; realign reads missed the
        banded certificate and realign_hint maps each to (certifying band,
        chain coordinates, score); need holds the exact per-read match
        totals (key -1: the batch maximum)."""
        cfg = self.cfg
        floor = cfg.k + cfg.w - 1
        with record_function("fused.pack"):
            arr, lens = _pack_reads(
                seqs, floor, len_to=_bucket_cap(max(len(s) for s in seqs),
                                                floor))
            dash_free = bool(self._dash_free_sticky and self._ref_dash_free
                             and not (arr == 45).any())
        cap = arr.shape[1]
        region_cap = _region_cap(cap)
        mode = self._mode
        if not dash_free:
            self._dash_free_sticky = False
        kw = dict(k=cfg.k, w=cfg.w, mode=mode, budget=budget,
                  region_cap=region_cap, oob_end_windows=cfg.oob_end_windows,
                  dash_free=dash_free)

        def step(fn, band):
            """The fused step on the batch, its outputs as host arrays."""
            with record_function("fused.upload"):
                reads_d, lens_d = self._to_device(arr, lens)
            with record_function("fused.step"):
                res = fn(reads_d, lens_d, self.device_index(), cfg.match,
                         cfg.mismatch, cfg.gap, band=band, **kw)
            with record_function("fused.fetch"):
                return res.to_numpy()

        n_real = len(seqs)
        cig = None
        cig_by_i: dict = {}
        if cfg.output_cigar:
            # The parent tensor's ceiling also clamps a band persisted under
            # a smaller batch.
            max_band = self._max_fused_band(cap, arr.shape[0])
            band = min(self._bucket_band(cap, True), max_band)
            cig = step(dm.map_step_cigar, band)
            out = cig.base
            mapped = out.mapped[:n_real]
            self._adapt_band_cigar(cap, cig, n_real, band, max_band)
            certified = cig.certified[:n_real]
            with self._counters_lock:
                self.counters.cert_total += int(mapped.sum())
                self.counters.cert_hits += int((mapped & certified).sum())
            cig_by_i = self._timed_decode(
                cig.codes, np.flatnonzero(mapped & certified), cig.goal_i,
                cig.goal_j, cig.q_len, cig.t_len)
        else:
            band = self._bucket_band(cap, False)
            out = step(dm.map_step, band)
            self._adapt_band_score(cap, out, n_real)
        results: List[ReadMapping] = []
        retry: List[int] = []
        retry_need: dict = {}
        realign: List[int] = []
        hint: dict = {}
        with self._counters_lock:
            self.counters.batches += 1
        for i in range(n_real):
            if out.overflow[i]:
                results.append(ReadMapping(mapped=False))
                retry.append(i)
                retry_need[i] = int(out.need[i])
            elif not out.mapped[i]:
                results.append(ReadMapping(mapped=False))
            elif cig is not None and not cig.certified[i]:
                # The strict certificate missed: the realign pass runs the
                # read at the band its banded score (a lower bound) proves.
                results.append(ReadMapping(mapped=False))
                realign.append(i)
                need = _needed_band_arr(
                    np.int64(cig.q_len[i]), np.int64(cig.t_len[i]),
                    np.int64(out.score[i]), cfg.match, cfg.mismatch,
                    cfg.gap, mode, strict=True)
                if need is not None:
                    hint[i] = (int(need), int(out.q_begin[i]),
                               int(out.q_end[i]), int(out.t_begin[i]),
                               int(out.t_end[i]), bool(out.is_fwd[i]),
                               int(out.score[i]))
            elif out.inexact[i]:
                # The banded score is a lower bound; the realign pass runs
                # the read at the band that bound proves.
                results.append(ReadMapping(mapped=False))
                realign.append(i)
                ql_i = min(int(out.q_end[i]) - int(out.q_begin[i]) + 1, cap)
                tl_i = min(int(out.t_end[i]) - int(out.t_begin[i]) + 1,
                           region_cap)
                need = _needed_band_arr(
                    np.int64(ql_i), np.int64(tl_i), np.int64(out.score[i]),
                    cfg.match, cfg.mismatch, cfg.gap, mode, strict=False)
                if need is not None:
                    hint[i] = (int(need), int(out.q_begin[i]),
                               int(out.q_end[i]), int(out.t_begin[i]),
                               int(out.t_end[i]), bool(out.is_fwd[i]),
                               int(out.score[i]))
            else:
                cigar, target_begin = cig_by_i.get(i, (None, None))
                results.append(ReadMapping(
                    mapped=True, is_fwd=bool(out.is_fwd[i]),
                    q_begin=int(out.q_begin[i]), q_end=int(out.q_end[i]),
                    t_begin=int(out.t_begin[i]), t_end=int(out.t_end[i]),
                    score=int(out.score[i]), cigar=cigar,
                    target_begin=target_begin))
        retry_need[-1] = int(out.need[:n_real].max())
        return results, retry, realign, hint, retry_need

    @scoped("map_batch")
    def map_batch(self, seqs: Sequence[str]) -> List[ReadMapping]:
        """Map one batch of reads on the next device in turn: the fused
        step under the budget ladder, the realign pass for certificate
        misses with a provable band, and the staged host path for the
        rest."""
        with self.devices.batch():
            return self._map_batch(seqs)

    def _map_batch(self, seqs: Sequence[str]) -> List[ReadMapping]:
        cfg = self.cfg
        # FASTA match nesting exists only on the staged path.
        fused = not cfg.fasta_match_nesting
        results: List[ReadMapping] = [ReadMapping(mapped=False)] * len(seqs)
        pending = list(range(len(seqs)))
        force_host: set = set()     # certificate misses no band can settle
        oom_retry: set = set()      # device out-of-memory reruns: same budget
        mult: dict = {}             # per-read budget multiplier (overflow)
        band_hint: dict = {}        # per-read certifying band (fused score)
        budget = cfg.initial_match_budget
        floor = cfg.k + cfg.w - 1
        attempts = 0
        while pending:
            # Regions longer than the fused step's cap (chains spanning far
            # more target than query) never resolve by budget doubling;
            # after two fused rounds the stragglers take the host path.
            if attempts >= 2 and fused:
                fused = False
                with self._counters_lock:
                    self.counters.host_fallbacks += sum(
                        1 for i in pending if i not in band_hint
                        and i not in force_host and i not in oom_retry)
            attempts += 1
            # One realign pass covers every missed read with a proven band,
            # whatever its length bucket.
            band_all = [i for i in pending
                        if i in band_hint and i not in force_host]
            band_members = set(band_all)
            rest = [i for i in pending if i not in band_members]
            pairs = [(band_all, "band")]
            for bucket in _bucket_indices([len(seqs[i]) for i in rest],
                                          cfg.bucket_growth, floor):
                idxs = [rest[j] for j in bucket]
                on_dev = [i for i in idxs if (fused or i in oom_retry)
                          and i not in force_host]
                on_dev_s = set(on_dev)
                host_idx = [i for i in idxs if i not in on_dev_s]
                pairs.append((on_dev, "fused"))
                # Host-path -c dispatches are memory-bound by their parent
                # tensors (up to whole-matrix width): 32-read chunks.
                step = 32 if cfg.output_cigar else max(len(host_idx), 1)
                pairs += [(host_idx[o:o + step], "host")
                          for o in range(0, len(host_idx), step)]
            next_pending: List[int] = []
            for sub_idxs, kind in pairs:
                if not sub_idxs:
                    continue
                sub = [seqs[i] for i in sub_idxs]
                # Budget scales with the bucket's canonical cap (~3L/8
                # covers the expected per-strand match total); the bucket
                # boost and the per-read multipliers both target absolute
                # budgets covering an observed need, so combine by max.
                cap = _bucket_cap(max(len(s) for s in sub), floor)
                base = max(_pow2_at_least(budget, 8),
                           -(-3 * cap // (8 * 128)) * 128)
                b_budget = base * max(self._budget_boost.get(cap, 1),
                                      max(mult.get(i, 1) for i in sub_idxs))
                t_call = time.perf_counter()
                need: dict = {}
                retry: List[int] = []
                realign: List[int] = []
                hints: dict = {}
                try:
                    if kind == "band":
                        res, realign = self._realign_bucket(
                            sub, {loc: band_hint[i]
                                  for loc, i in enumerate(sub_idxs)})
                    elif kind == "fused":
                        res, retry, realign, hints, need = \
                            self._map_bucket_fused(sub, b_budget)
                    else:
                        res, retry = self._map_bucket(
                            sub, b_budget, band_hint=max(
                                band_hint.get(i, (0,))[0] for i in sub_idxs))
                except Exception as e:
                    # Per-batch fault isolation, the JAX package's ladder
                    # (its mapper.py:1174-1194; the reference logs a
                    # per-read Align throw and goes on).
                    with self._counters_lock:
                        self.counters.faults += 1
                    print(f"ERROR: Exception during Align: {e}",
                          file=sys.stderr)
                    if kind != "host":
                        # Device out of memory (batches in flight): rerun
                        # on the device at the same budget once the
                        # pressure drains; any other error, or a sixth
                        # attempt, takes the host path.
                        if (isinstance(e, torch.cuda.OutOfMemoryError)
                                and attempts < 6):
                            oom_retry.update(sub_idxs)
                        else:
                            force_host.update(sub_idxs)
                        next_pending.extend(sub_idxs)
                    elif _is_cuda_error(e):
                        # A sticky CUDA error poisons the context: every
                        # later call fails the same way, so a CUDA error
                        # on the host path (where the device route sent
                        # these reads) ends the run rather than report
                        # every later batch unmapped.
                        raise
                    else:
                        for i in sub_idxs:
                            results[i] = ReadMapping(mapped=False)
                    continue
                retry_s, realign_s = set(retry), set(realign)
                # >2% of a batch overflowing marks the bucket repeat-dense:
                # widen its future starting budget to cover the exact
                # observed need.  The boost is cut back until base x boost
                # is within 32,768 (or the boost is 1): the JAX package's
                # ladder (its mapper.py:1213), kept so that the retries
                # match it; K1 itself takes larger budgets.
                if len(retry_s) > max(2, len(sub_idxs) // 50):
                    need_max = max((need.get(loc, 0) for loc in retry_s),
                                   default=0)
                    boost = max(self._budget_boost.get(cap, 1) * 2,
                                _pow2_at_least(
                                    -(-21 * need_max // (20 * base)), 1))
                    while boost > 1 and base * boost > 32768:
                        boost //= 2
                    self._budget_boost[cap] = boost
                elif (kind == "fused" and not retry_s
                      and self._budget_boost.get(cap, 1) > 1
                      and 0 < need.get(-1, 0) * 21 // 20
                      <= base * self._budget_boost[cap] // 2):
                    # Clean batch whose exact max need fits half the
                    # boosted budget: decay one step.
                    self._budget_boost[cap] //= 2
                dt_call = time.perf_counter() - t_call
                to_realign = [loc for loc in realign_s
                              if kind == "fused" and loc in hints]
                with self._counters_lock:
                    if kind == "band":
                        self.counters.t_realign_s += dt_call
                    elif kind == "fused":
                        self.counters.t_fused_s += dt_call
                    else:
                        self.counters.t_host_s += dt_call
                        self.counters.batches += 1
                    self.counters.budget_retries += len(retry_s)
                    self.counters.realign_reroutes += len(to_realign)
                    self.counters.host_fallbacks += (len(realign_s)
                                                     - len(to_realign))
                for loc, i in enumerate(sub_idxs):
                    if loc in retry_s:
                        # Jump straight to a multiplier covering the exact
                        # need (5% slack); doubling stays the floor.
                        jump = _pow2_at_least(
                            -(-21 * need.get(loc, 0) // (20 * base)), 1)
                        mult[i] = max(mult.get(i, 1) * 2, jump)
                        next_pending.append(i)
                    elif loc in realign_s:
                        # First miss with a provable band -> realign pass;
                        # a second miss (or no finite band) -> host path.
                        if kind == "fused" and loc in hints:
                            band_hint[i] = hints[loc]
                        else:
                            band_hint.pop(i, None)
                            force_host.add(i)
                        next_pending.append(i)
                    else:
                        oom_retry.discard(i)
                        results[i] = res[loc]
            pending = next_pending
            # Safety: 24 rounds, as the JAX package (its "~16M matches per
            # read").  An overflow round at least doubles a read's budget;
            # K1 refuses budgets past ops/chain._MAX_N (2^27 - 1 matches a
            # row), so a read that needs more faults before this cap.
            if attempts >= 24:
                break
        cells = 0.0
        n_mapped = 0
        for r in results:
            if r.mapped:
                n_mapped += 1
                cells += float((r.q_end - r.q_begin + 1)
                               * (r.t_end - r.t_begin + 1))
        with self._counters_lock:
            self.counters.reads += len(seqs)
            self.counters.mapped += n_mapped
            self.counters.dp_cells += cells
        return results

    @scoped("format")
    def _format_chunk(self, chunk: Sequence[Tuple[str, str]],
                      mappings: Sequence[ReadMapping],
                      per_read_stats: bool) -> List[List[str]]:
        """Per-record output lines for one mapped chunk (stats + PAF)."""
        cfg = self.cfg
        per_rec: List[List[str]] = [[] for _ in chunk]
        if per_read_stats:
            arr, lens = _pack_reads([seq for _, seq in chunk],
                                    cfg.k + cfg.w - 1)
            arr_d, lens_d = self._to_device(arr, lens)
            sres = mz.minimize_batch(arr_d, lens_d, cfg.k, cfg.w,
                                     oob_end_windows=cfg.oob_end_windows)
            stat_h = sres.hashes.cpu().numpy()
            stat_v = sres.valid.cpu().numpy()
            for bi in range(len(chunk)):
                per_rec[bi].append(st.read_statistics(stat_h[bi],
                                                      stat_v[bi]))
        # Native batch serializer (native/paf.cpp); paf_line is the
        # fallback and executable spec.  One line per MAPPED read in order.
        nat = native.paf_format(
            [name for name, _ in chunk], [len(seq) for _, seq in chunk],
            mappings, self.ref_name, self.ref_len, cfg.output_cigar)
        if nat is not None:
            it = iter(nat)
            for bi, m in enumerate(mappings):
                if m.mapped:
                    per_rec[bi].append(next(it))
        else:
            for bi, ((name, seq), m) in enumerate(zip(chunk, mappings)):
                if m.mapped:
                    per_rec[bi].append(paf_line(
                        name, len(seq), m, self.ref_name, self.ref_len,
                        cfg.output_cigar))
        return per_rec

    def _inflight_limit(self) -> int:
        """Bytes of estimated batch workspace allowed in flight at once.

        BIOINFO1_INFLIGHT_BYTES overrides.  The default is half of the
        device's free memory measured after the index upload, so it follows
        the card (the JAX package's 7e9 was sized for a TPU beside its
        index); on the CPU it is half of the available host memory.  With
        several devices the batches in flight spread over them; the first
        device's free memory stays the measure."""
        env = os.environ.get("BIOINFO1_INFLIGHT_BYTES")
        if env:
            return int(float(env))
        self.device_index()
        return _free_memory_bytes(self.device) // 2

    def map_records_iter(self, records: Sequence[Tuple[str, str]],
                         per_read_stats: bool = False, start_at: int = 0):
        """Yield (next_record_index, lines) in input order.

        Records queue per length bucket and flush at a fixed size; up to
        three batches run at once on worker threads (host work of one batch
        overlaps the device work of the next), bounded by the in-flight
        bytes valve.  Yields carry the contiguous completed prefix, so
        checkpoint/resume (``start_at``) stays exact."""
        cfg = self.cfg
        flush_size = _pow2_at_least(cfg.batch_size, 8)
        floor = cfg.k + cfg.w - 1
        queues: dict = {}               # cap -> [(idx, name, seq), ...]
        results: dict = {}              # idx -> [lines]
        emitted = start_at
        n_queued = 0
        DEPTH = 3
        max_inflight_bytes = self._inflight_limit()

        def _flush_cost(n_entries: int, cap: int) -> int:
            # ~320 B of transient workspace per padded base (match tables,
            # region windows, DP state), plus under -c the parent stream:
            # ~(2*cap + W)/4 byte rows of W lanes per read, and the walk.
            bpad = _batch_cap(n_entries, 8)
            cost = bpad * cap * 320
            if cfg.output_cigar:
                W = self._bucket_band(cap, True)
                cost += bpad * W * ((2 * cap + W) // 4 + 64)
            return cost

        executor = ThreadPoolExecutor(max_workers=DEPTH)
        in_flight: list = []            # FIFO [(entries, chunk, fut, cost)]

        def complete_oldest():
            entries, chunk, fut, _cost = in_flight.pop(0)
            with record_function("iter.wait"):
                mappings = fut.result()
            t_fmt = time.perf_counter()
            per_rec = self._format_chunk(chunk, mappings, per_read_stats)
            with self._counters_lock:
                self.counters.t_format_s += time.perf_counter() - t_fmt
            for (idx, _, _), lines in zip(entries, per_rec):
                results[idx] = lines

        def complete_in_flight():
            while in_flight:
                complete_oldest()

        def flush(cap):
            nonlocal n_queued
            entries = queues.pop(cap)
            n_queued -= len(entries)
            chunk = [(name, seq) for _, name, seq in entries]
            cost = _flush_cost(len(entries), cap)
            while in_flight and (
                    len(in_flight) >= DEPTH
                    or sum(c for *_x, c in in_flight) + cost
                    > max_inflight_bytes):
                complete_oldest()
            fut = executor.submit(self.map_batch, [s for _, s in chunk])
            in_flight.append((entries, chunk, fut, cost))

        def drain():
            nonlocal emitted
            lines: List[str] = []
            while emitted in results:
                lines.extend(results.pop(emitted))
                emitted += 1
            return lines

        last_yield = start_at
        # Pressure valve: a bucket that never fills would pin `emitted`;
        # once its oldest record is stale (16 flushes' worth of later
        # records) it flushes and completes synchronously.  A large
        # occupancy cap is the memory backstop.
        stale_window = 16 * flush_size
        hard_cap = 64 * flush_size
        try:
            for idx in range(start_at, len(records)):
                name, seq = records[idx]
                cap = _bucket_cap(len(seq), floor)
                queues.setdefault(cap, []).append((idx, name, seq))
                n_queued += 1
                lines: List[str] = []
                if len(queues[cap]) >= flush_size:
                    flush(cap)
                    lines.extend(drain())

                def limbo():
                    return (n_queued + len(results)
                            + sum(len(e) for e, *_rest in in_flight))
                while queues:
                    oldest = min(queues, key=lambda c: queues[c][0][0])
                    if (idx - queues[oldest][0][0] < stale_window
                            and limbo() < hard_cap):
                        break
                    flush(oldest)
                    complete_in_flight()
                    lines.extend(drain())
                if lines or emitted > last_yield:
                    last_yield = emitted
                    yield emitted, lines
            while queues:
                flush(next(iter(queues)))
            complete_in_flight()
            lines = drain()
            if lines or emitted > last_yield:
                yield emitted, lines
        finally:
            executor.shutdown(wait=True)
            self._save_band_cache()

    def map_records(self, records: Sequence[Tuple[str, str]],
                    per_read_stats: bool = False) -> List[str]:
        """Map (name, seq) records to output lines in input order; with
        ``per_read_stats`` each read's -s block precedes its PAF line."""
        out: List[str] = []
        for _, lines in self.map_records_iter(records, per_read_stats):
            out.extend(lines)
        return out


def map_all(reference_records: Sequence[Tuple[str, str]],
            read_records: Sequence[Tuple[str, str]],
            cfg: MapperConfig,
            device: Optional[torch.device] = None) -> List[str]:
    """One-shot mapping: the PAF lines of ``read_records`` against the first
    of ``reference_records``, in input order.  ``device`` defaults to
    ``resolve_device()``: the card, unless BIOINFO1_PLATFORM=cpu; without
    a card that raises."""
    return Mapper(reference_records, cfg, device=device).map_records(
        read_records)
