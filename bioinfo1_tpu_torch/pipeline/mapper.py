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

Not ported yet, and refused rather than ignored: FASTA match nesting
(``--bug-compat`` on a FASTA reads file), ``-c`` where no exactness
certificate exists (global mode with gap >= 0, local or semiGlobal with
gap > 0: the JAX package runs those on its staged host path) and more than
one device.  Reads the JAX package hands to its staged host path
(``_map_bucket``: after two fused attempts, or on a realign certificate
miss) raise ``NotImplementedError`` naming the read.  Unlike the JAX
package, a device or kernel error is not re-routed: it propagates and the
run fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bioinfo1_tpu import native
from bioinfo1_tpu.index import builder
from bioinfo1_tpu.utils import cigar as cg
from bioinfo1_tpu.utils import stats as st
from bioinfo1_tpu_torch.ops import align as al
from bioinfo1_tpu_torch.ops import band as bd
from bioinfo1_tpu_torch.ops import minimizer as mz
from bioinfo1_tpu_torch.ops import trace as tr
from bioinfo1_tpu_torch.pipeline import device_map as dm
from bioinfo1_tpu_torch.utils.runtime import resolve_device


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
    host_fallbacks: int = 0        # certificate misses re-routed to realign
    realign_batches: int = 0       # realign passes run
    realign_chunks: int = 0        # their device dispatches (-c splits them)
    t_fused_s: float = 0.0         # fused step dispatch + fetch
    t_realign_s: float = 0.0       # realign passes
    t_decode_s: float = 0.0        # native CIGAR decode
    t_format_s: float = 0.0        # stats + PAF serialization

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.cert_total:
            d["cert_hit_rate"] = round(self.cert_hits / self.cert_total, 4)
        for k in ("t_fused_s", "t_realign_s", "t_decode_s", "t_format_s"):
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


def unported_features(cfg: MapperConfig) -> List[str]:
    """The configuration's features this port does not run yet."""
    out = []
    if cfg.output_cigar and not certificate_possible(cfg):
        out.append(f"-c with -a {cfg.align_type} -g {cfg.gap} (no exactness "
                   "certificate: the staged host path)")
    if cfg.fasta_match_nesting:
        out.append("--bug-compat FASTA match nesting")
    if cfg.devices > 1:
        out.append(f"--devices {cfg.devices} (more than one device)")
    return out


def _free_memory_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class Mapper:
    """Reusable mapping engine bound to one reference index and one device."""

    def __init__(self, reference_records: Sequence[Tuple[str, str]],
                 cfg: MapperConfig, load_index: Optional[str] = None,
                 device: Optional[torch.device] = None):
        missing = unported_features(cfg)
        if missing:
            raise NotImplementedError(
                "not yet ported to bioinfo1_tpu_torch: " + ", ".join(missing))
        self.cfg = cfg
        self.device = device if device is not None else resolve_device()
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
        self._device_index = None

    def device_index(self) -> dm.DeviceIndex:
        """The index on the device, packed and uploaded at first use."""
        # Locked: two first batches racing here would upload it twice.
        with self._counters_lock:
            if self._device_index is None:
                self._device_index = dm.device_index_from_host(
                    self.index, self.device)
            return self._device_index

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
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def _realign_bucket(self, seqs: Sequence[str], hints: dict,
                        ) -> Tuple[List[ReadMapping], List[int]]:
        """Certificate misses: re-run only the banded alignment at the band
        each read's own fused score (an exact lower bound) proves
        certifiable, reusing the exact chain coordinates from the failed
        pass; under -c with parents, the strict certificate and the walk.
        One pass covers every missed read across length buckets; under -c
        it is dispatched in row chunks whose parent tensor stays under
        _PARENT_BYTES (each read's result does not depend on its chunk).
        Returns (results, locs that still missed)."""
        cfg = self.cfg
        mode = self._mode
        want_cigar = cfg.output_cigar
        qs, ts = [], []
        for i in range(len(seqs)):
            _, qb, qe, tb, te, fwd, _ = hints[i]
            q = seqs[i][qb: qe + 1]
            q += "\0" * (qe - qb + 1 - len(q))
            src = self.index.ref_fwd_seq if fwd else self.index.ref_rev_seq
            t = src[tb: te + 1]
            t += "\0" * (te - tb + 1 - len(t))
            qs.append(q)
            ts.append(t)
        qa, ql = _pack_reads(qs, 1)
        ta, tl = _pack_reads(ts, 1)
        w_whole = max(qa.shape[1], ta.shape[1] + 2)
        W = min(_pow2_at_least(max(max(h[0] for h in hints.values()), 256),
                               256), -(-w_whole // 128) * 128)
        dash_free = bool(self._dash_free_sticky and self._ref_dash_free
                         and not (qa == 45).any() and not (ta == 45).any())
        q_all, ql_all, t_all, tl_all = self._to_device(qa, ql, ta, tl)
        n_reads = len(seqs)
        size = n_reads
        if want_cigar:
            n_steps = bd.band_shapes(qa.shape[1], ta.shape[1], W)[3]
            size = max(1, int(_PARENT_BYTES
                              // (bd.parent_rows(n_steps) * W)))
        cert = np.zeros(n_reads, bool)
        scores = np.zeros(n_reads, np.int64)
        cig_by_i: dict = {}
        n_chunks = 0
        for lo in range(0, n_reads, size):
            hi = min(lo + size, n_reads)
            q_d, ql_d, t_d, tl_d = (x[lo:hi] for x in
                                    (q_all, ql_all, t_all, tl_all))
            out = bd.align_scores_banded(
                q_d, ql_d, t_d, tl_d, cfg.match, cfg.mismatch, cfg.gap,
                band=W, mode=mode, dash_free=dash_free,
                want_parents=want_cigar)
            # Non-strict for score-only callers: ties are fine when only
            # the score is emitted.
            cert_d = bd.certify(out.score, q_d, ql_d, t_d, tl_d, cfg.match,
                                cfg.mismatch, cfg.gap, W, strict=want_cigar,
                                mode=mode)
            host = torch.stack([cert_d.to(torch.int32), out.score,
                                out.goal_i, out.goal_j]).cpu().numpy()
            cert[lo:hi] = host[0].astype(bool)
            scores[lo:hi] = host[1]
            if want_cigar:
                packed = tr.walk_parents(
                    out.parents, out.goal_i, out.goal_j, out.score, q_d, t_d,
                    cfg.match, cfg.mismatch, cfg.gap, mode).cpu().numpy()
                del out     # frees the parents before the next chunk
                sel = [i for i in range(hi - lo) if cert[lo + i]]
                if sel:
                    t_dec = time.perf_counter()
                    cigs, tbs = _decode_cigars(packed, sel, host[2], host[3],
                                               ql[lo:hi], tl[lo:hi], cfg)
                    cig_by_i.update((lo + i, pair)
                                    for i, pair in zip(sel, zip(cigs, tbs)))
                    with self._counters_lock:
                        self.counters.t_decode_s += (time.perf_counter()
                                                     - t_dec)
            n_chunks += 1
        with self._counters_lock:
            self.counters.cert_total += n_reads
            self.counters.cert_hits += int(cert.sum())
            self.counters.batches += 1
            self.counters.realign_batches += 1
            self.counters.realign_chunks += n_chunks
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

    def _map_bucket_fused(self, seqs: Sequence[str], budget: int):
        """One fused device batch (``map_step``, or ``map_step_cigar``
        under -c).  Returns (results, budget_retry, realign, realign_hint,
        need): budget_retry reads overflowed; realign reads missed the
        banded certificate and realign_hint maps each to (certifying band,
        chain coordinates, score); need holds the exact per-read match
        totals (key -1: the batch maximum)."""
        cfg = self.cfg
        floor = cfg.k + cfg.w - 1
        arr, lens = _pack_reads(seqs, floor, len_to=_bucket_cap(
            max(len(s) for s in seqs), floor))
        cap = arr.shape[1]
        region_cap = _region_cap(cap)
        mode = self._mode
        dash_free = bool(self._dash_free_sticky and self._ref_dash_free
                         and not (arr == 45).any())
        if not dash_free:
            self._dash_free_sticky = False
        reads_d, lens_d = self._to_device(arr, lens)
        kw = dict(k=cfg.k, w=cfg.w, mode=mode, budget=budget,
                  region_cap=region_cap, oob_end_windows=cfg.oob_end_windows,
                  dash_free=dash_free)
        n_real = len(seqs)
        cig = None
        cig_by_i: dict = {}
        if cfg.output_cigar:
            # The parent tensor's ceiling also clamps a band persisted under
            # a smaller batch.
            max_band = self._max_fused_band(cap, arr.shape[0])
            band = min(self._bucket_band(cap, True), max_band)
            cig = dm.map_step_cigar(
                reads_d, lens_d, self.device_index(), cfg.match,
                cfg.mismatch, cfg.gap, band=band, **kw).to_numpy()
            out = cig.base
            mapped = out.mapped[:n_real]
            if mapped.any():
                # Persist the band for future batches: the largest needed
                # band, capped at 2x the 99th percentile so one outlier
                # does not widen every later batch's parent stream (it
                # pays the realign pass instead).
                need = _needed_band_arr(
                    cig.q_len[:n_real], cig.t_len[:n_real],
                    out.score[:n_real], cfg.match, cfg.mismatch, cfg.gap,
                    mode, strict=True)
                if need is None:
                    persist = band
                else:
                    w99 = float(np.percentile(need[mapped], 99))
                    w100 = float(need[mapped].max())
                    persist = -(-int(max(min(w100, 2 * w99), 256))
                                // 128) * 128
                self._band_by_key[(cap, True)] = min(max(persist, 256),
                                                     max_band)
            certified = cig.certified[:n_real]
            with self._counters_lock:
                self.counters.cert_total += int(mapped.sum())
                self.counters.cert_hits += int((mapped & certified).sum())
            sel = np.flatnonzero(mapped & certified)
            if len(sel):
                t_dec = time.perf_counter()
                cigs, tbs = _decode_cigars(cig.codes, sel, cig.goal_i,
                                           cig.goal_j, cig.q_len, cig.t_len,
                                           cfg)
                cig_by_i = dict(zip(sel.tolist(), zip(cigs, tbs)))
                with self._counters_lock:
                    self.counters.t_decode_s += time.perf_counter() - t_dec
        else:
            band = self._bucket_band(cap, False)
            out = dm.map_step(
                reads_d, lens_d, self.device_index(), cfg.match,
                cfg.mismatch, cfg.gap, band=band, **kw).to_numpy()
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

    def map_batch(self, seqs: Sequence[str],
                  names: Optional[Sequence[str]] = None) -> List[ReadMapping]:
        """Map one batch of reads through the budget ladder and the realign
        pass.  ``names`` only label errors."""
        cfg = self.cfg
        results: List[ReadMapping] = [ReadMapping(mapped=False)] * len(seqs)
        pending = list(range(len(seqs)))
        staged: set = set()         # reads the JAX package stages on host
        mult: dict = {}             # per-read budget multiplier (overflow)
        band_hint: dict = {}        # per-read certifying band (fused score)
        budget = cfg.initial_match_budget
        attempts = 0
        while pending:
            # After two fused rounds the JAX package sends the stragglers
            # (regions longer than the fused step's cap) to its staged host
            # path, as it does reads whose realign pass missed.
            if attempts >= 2:
                staged.update(i for i in pending if i not in band_hint)
            staged_now = [i for i in pending if i in staged]
            if staged_now:
                i = staged_now[0]
                who = names[i] if names is not None else f"#{i}"
                raise NotImplementedError(
                    f"read {who} ({len(seqs[i])} bp) needs the staged host "
                    "path (pipeline/mapper._map_bucket), which is not yet "
                    "ported to bioinfo1_tpu_torch")
            attempts += 1
            band_all = [i for i in pending if i in band_hint]
            band_members = set(band_all)
            rest = [i for i in pending if i not in band_members]
            grouped = [(band_all, "band")] if band_all else []
            grouped += [([rest[j] for j in bucket], "fused")
                        for bucket in _bucket_indices(
                            [len(seqs[i]) for i in rest], cfg.bucket_growth,
                            cfg.k + cfg.w - 1)]
            next_pending: List[int] = []
            for sub_idxs, kind in grouped:
                sub = [seqs[i] for i in sub_idxs]
                # Budget scales with the bucket's canonical cap (~3L/8
                # covers the expected per-strand match total); the bucket
                # boost and the per-read multipliers both target absolute
                # budgets covering an observed need, so combine by max.
                cap = _bucket_cap(max(len(s) for s in sub), cfg.k + cfg.w - 1)
                base = max(_pow2_at_least(budget, 8),
                           -(-3 * cap // (8 * 128)) * 128)
                b_budget = base * max(self._budget_boost.get(cap, 1),
                                      max(mult.get(i, 1) for i in sub_idxs))
                t_call = time.perf_counter()
                need: dict = {}
                if kind == "band":
                    res, realign = self._realign_bucket(
                        sub, {loc: band_hint[i]
                              for loc, i in enumerate(sub_idxs)})
                    retry, hints = [], {}
                else:
                    res, retry, realign, hints, need = \
                        self._map_bucket_fused(sub, b_budget)
                retry_s, realign_s = set(retry), set(realign)
                # >2% of a batch overflowing marks the bucket repeat-dense:
                # widen its future starting budget to cover the exact
                # observed need (capped within the chain kernel's range).
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
                with self._counters_lock:
                    if kind == "band":
                        self.counters.t_realign_s += dt_call
                    else:
                        self.counters.t_fused_s += dt_call
                    self.counters.budget_retries += len(retry_s)
                    self.counters.host_fallbacks += len(realign_s)
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
                        # a second miss (or no finite band) -> staged path.
                        if kind == "fused" and loc in hints:
                            band_hint[i] = hints[loc]
                        else:
                            band_hint.pop(i, None)
                            staged.add(i)
                        next_pending.append(i)
                    else:
                        results[i] = res[loc]
            pending = next_pending
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
        index); on the CPU it is half of the available host memory."""
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
            fut = executor.submit(self.map_batch, [s for _, s in chunk],
                                  [n for n, _ in chunk])
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
