"""Chip smoke test of the PyTorch + CUDA port (bioinfo1_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile-map]

Phases (each prints one JSON line; any mismatch fails the run):
  0. device: card, torch and CUDA versions, nvidia-smi name and power
     limit; builds the CUDA kernels from bioinfo1_tpu_torch/csrc.
  1. every kernel against its plain PyTorch version on the card, exact
     integer equality, with both times: K1 LIS chain, K2 banded score,
     K3 full score.
  2. the CLI's default score-only path at E. coli scale: a 4,641,652 bp
     synthetic genome (direct-address index on the card) and 2,048
     ONT-profile reads (2/4/8 kb plus 10% at 200-500 bp) through
     bioinfo1_tpu_torch.cli.main; every kernel must have launched, the
     realign pass must have run and >= 90% of reads >= 2 kb must map.
  3. the first 96 reads again with BIOINFO1_PLATFORM=cpu in a subprocess:
     their PAF lines must equal the GPU run's byte for byte.
  4. only with --profile-map: the map stage alone on phase 2's inputs,
     fresh and with adapted bands, without and then under torch.profiler
     (device busy time and share, device time by kernel).

The genome and reads come from the ONT-profile simulator below, which
makes the same draws as bioinfo1_tpu/utils/simulate.py.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
no CUDA device is visible.  Scratch files go to build/chip_smoke/.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
GENOME_LEN = 4_641_652
GENOME_SEED = 20250817
N_READS = 2048
N_CPU_READS = 96

KERNELS = {
    "lis_chain": ("bioinfo1_tpu_torch/csrc/lis_chain.cu",
                  "bioinfo1_tpu/ops/pallas_chain.py:57"),
    "band_score": ("bioinfo1_tpu_torch/csrc/band_score.cu",
                   "bioinfo1_tpu/ops/pallas_band.py:56"),
    "full_score": ("bioinfo1_tpu_torch/csrc/full_score.cu",
                   "bioinfo1_tpu/ops/pallas_align.py:45"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> int:
    return max(int((getattr(got, f).long() - getattr(want, f).long())
                   .abs().max()) for f in got.__dataclass_fields__)


def compare(name: str, kernel, plain, reps: int = 3) -> dict:
    """Run kernel and plain version on the same inputs; exact equality."""
    got = kernel()                              # first call: warm-up + check
    torch.cuda.synchronize()
    ms = cuda_ms(kernel, reps)
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max_abs_err(got, want)
    check(err == 0, f"{name}: kernel differs from its plain version "
                    f"(max abs err {err})")
    return {"call": name, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err}


# ---- synthetic ONT data ---------------------------------------------------
# The same draws, in the same order, as bioinfo1_tpu/utils/simulate.py, so a
# seed gives the same genome and reads (tests/test_torch_smoke_inputs.py).

BASES = np.frombuffer(b"CATG", dtype=np.uint8)
COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[np.frombuffer(b"ATGC", np.uint8)] = np.frombuffer(b"TACG", np.uint8)


def random_genome(n: int, rng) -> np.ndarray:
    return BASES[rng.integers(0, 4, n)]


def mutate_read(frag: np.ndarray, rng, sub_rate: float = 0.05,
                ins_rate: float = 0.03, del_rate: float = 0.04,
                indel_geom_p: float = 0.6) -> np.ndarray:
    """ONT-like errors per base: a substitution (uniform base), or an
    insertion / deletion of geometric length (mean 1/p)."""
    r = rng.random(len(frag))
    out, i = [], 0
    for e in np.flatnonzero(r < sub_rate + ins_rate + del_rate):
        if e < i:
            continue                       # inside a deletion
        out.append(frag[i:e])
        if r[e] < sub_rate:
            out.append(BASES[rng.integers(0, 4, 1)])
            i = e + 1
        elif r[e] < sub_rate + ins_rate:
            ln = rng.geometric(indel_geom_p)
            out += [frag[e:e + 1], BASES[rng.integers(0, 4, ln)]]
            i = e + 1
        else:
            i = e + int(rng.geometric(indel_geom_p))
    out.append(frag[i:])
    return np.concatenate(out)


def simulate_reads(genome: np.ndarray, lengths, rng):
    """(name, seq) records sampled from ``genome``, ~12% error, about half
    reverse-complemented."""
    recs = []
    for i, ln in enumerate(lengths):
        start = int(rng.integers(0, max(1, len(genome) - ln)))
        frag = mutate_read(genome[start:start + ln], rng)
        if rng.random() < 0.5:
            frag = COMPLEMENT[frag[::-1]]
        recs.append((f"ont{i}", frag.tobytes().decode("latin1")))
    return recs


# ---- phase 1 inputs -------------------------------------------------------

def chain_inputs(rng, R: int, N: int, dev):
    """Match rows of sorted query positions with repeat copies 4999 and
    5000 apart (both sides of the predecessor window), random jumps, an
    empty row and a full row."""
    f = np.zeros((R, N), np.int32)
    r = np.zeros((R, N), np.int32)
    cnt = rng.integers(0, N + 1, R).astype(np.int32)
    cnt[0], cnt[1] = 0, N
    span = max(4 * N, 20000)
    for b in range(R):
        n = int(cnt[b])
        fs = np.sort(rng.integers(1, span, n)).astype(np.int32)
        rs = (fs + rng.integers(0, 3, n).astype(np.int32)
              * (4999 + (b & 1)) + rng.integers(-30, 30, n).astype(np.int32))
        jump = rng.random(n) < 0.05
        rs[jump] = rng.integers(1, 4 * span, int(jump.sum()))
        f[b, :n] = fs
        r[b, :n] = np.maximum(rs, 1)
    # Row 2: predecessors exactly 4999 apart (chain), row 3: 5000 (none).
    for b, step in ((2, 4999), (3, 5000)):
        n = min(N, 64)
        cnt[b] = n
        f[b, :n] = 1 + step * np.arange(n)
        r[b, :n] = 1 + step * np.arange(n)
    t = [torch.from_numpy(x).to(dev) for x in (f, r, cnt)]
    return t


def pair_inputs(rng, B: int, n: int, m: int, dev, dash_rows: int = 8):
    """ONT-like query/target pairs (indels drift the path), lengths spread
    over the widths, a few rows with '-' bytes and targets past n + W."""
    qa = np.zeros((B, n), np.uint8)
    ta = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(n // 4, n + 1))
        tgt = random_genome(min(m, int(ln * 1.3) + 8), rng)
        qry = mutate_read(tgt[:ln], rng)[:n]
        if b % 7 == 0:
            tgt = random_genome(m, rng)                   # long target
        qa[b, :len(qry)], ql[b] = qry, len(qry)
        ta[b, :len(tgt)], tl[b] = tgt, len(tgt)
    for b in range(min(dash_rows, B)):
        qa[b, rng.integers(0, max(ql[b], 1), 3)] = ord("-")
        ta[b, rng.integers(0, max(tl[b], 1), 3)] = ord("-")
    ql[-1] = tl[-1] = 0
    return [torch.from_numpy(x).to(dev) for x in (qa, ql, ta, tl)]


def phase_kernels(dev) -> dict:
    from bioinfo1_tpu_torch.ops import align as al
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.kernels import build
    from bioinfo1_tpu_torch.ops import chain as ch
    rng = np.random.default_rng(1)
    rows = {"lis_chain": [], "band_score": [], "full_score": []}

    for R, N in ((512, 1536), (64, 16384), (64, 24576)):
        f, r, cnt = chain_inputs(rng, R, N, dev)
        row = compare(f"lis_chain R={R} N={N}",
                      lambda: ch.lis_chain(f, r, cnt),
                      lambda: ch.lis_chain_plain(f, r, cnt),
                      reps=3 if N <= 1536 else 1)
        row["smem"] = 12 * N <= build.SMEM_LIMIT
        rows["lis_chain"].append(row)

    scoring = (1, -1, -1)
    q, ql, t, tl = pair_inputs(rng, 256, 4096, 6144, dev)
    for mode in (0, 1, 2):
        for dash_free in (True, False):
            rows["band_score"].append(compare(
                f"band W=256 mode={mode} dash_free={dash_free}",
                lambda: bd.align_scores_banded(q, ql, t, tl, *scoring,
                                               band=256, mode=mode,
                                               dash_free=dash_free),
                lambda: bd.align_scores_banded_plain(
                    q, ql, t, tl, *scoring, band=256, mode=mode,
                    dash_free=dash_free)))
    for B, W in ((256, 4096), (32, 19968)):       # realign / global scratch
        qq, qql, tt, ttl = (x[:B].contiguous() for x in (q, ql, t, tl))
        row = compare(f"band W={W} B={B} mode=0",
                      lambda: bd.align_scores_banded(qq, qql, tt, ttl,
                                                     *scoring, band=W),
                      lambda: bd.align_scores_banded_plain(
                          qq, qql, tt, ttl, *scoring, band=W), reps=1)
        row["smem"] = 12 * W <= build.SMEM_LIMIT
        rows["band_score"].append(row)
    del q, ql, t, tl

    q, ql, t, tl = pair_inputs(rng, 64, 512, 1024, dev)
    for mode in (0, 1, 2):
        rows["full_score"].append(compare(
            f"full n=512 m=1024 mode={mode}",
            lambda: al.align_scores(q, ql, t, tl, mode, *scoring),
            lambda: al.align_scores_plain(q, ql, t, tl, mode, *scoring),
            reps=5))
    return rows


# ---- phase 2 / 3 ----------------------------------------------------------

def write_inputs():
    os.makedirs(WORK, exist_ok=True)
    genome = random_genome(GENOME_LEN, np.random.default_rng(GENOME_SEED))
    rng = np.random.default_rng(GENOME_SEED + 1)
    n_short = N_READS // 10
    lengths = [(2000, 4000, 8000)[i % 3] for i in range(N_READS - n_short)]
    lengths += [int(x) for x in rng.integers(200, 501, n_short)]
    order = rng.permutation(len(lengths))
    recs = simulate_reads(genome, [lengths[i] for i in order], rng)
    ref = os.path.join(WORK, "ref.fa")
    g = genome.tobytes().decode("latin1")
    with open(ref, "w") as fh:
        fh.write(">ecoli_like\n")
        for i in range(0, len(g), 80):
            fh.write(g[i:i + 80] + "\n")

    def write_fq(path, rs):
        with open(path, "w") as fh:
            for name, s in rs:
                fh.write(f"@{name}\n{s}\n+\n{'5' * len(s)}\n")
    reads = os.path.join(WORK, "reads.fq")
    write_fq(reads, recs)
    reads96 = os.path.join(WORK, "reads96.fq")
    write_fq(reads96, recs[:N_CPU_READS])
    return ref, reads, reads96, recs, g


def parse_profile(err: str) -> dict:
    """Stage totals and the two JSON counter lines of --profile."""
    stages, jsons = {}, []
    for line in err.splitlines():
        parts = line.split()
        if line.startswith("{"):
            jsons.append(json.loads(line))
        elif len(parts) == 4 and parts[0] != "stage":
            stages[parts[0]] = float(parts[1])
    return {"stages_s": stages, "throughput": jsons[0], "mapper": jsons[1]}


def phase_pipeline(ref, reads, recs) -> dict:
    from bioinfo1_tpu_torch import cli
    from bioinfo1_tpu_torch.ops import align as al
    from bioinfo1_tpu_torch.ops import band as bd
    from bioinfo1_tpu_torch.ops import chain as ch
    out = os.path.join(WORK, "gpu.paf")
    wrappers = {"lis_chain": ch.lis_chain,
                "band_score": bd.align_scores_banded,
                "full_score": al.align_scores}
    for w in wrappers.values():
        w.launches = 0
    err = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.main([ref, reads, "-o", out, "--profile"], stderr=err)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    sys.stderr.write(err.getvalue())
    check(rc == 0, f"cli.main returned {rc}")
    prof = parse_profile(err.getvalue())
    for k, n in launches.items():
        check(n >= 1, f"kernel {k} never launched on the main path")
    check(prof["mapper"]["realign_batches"] >= 1, "realign pass never ran")
    with open(out) as fh:
        lines = fh.read().splitlines()
    names = {line.split("\t")[0] for line in lines}
    long_reads = [n for n, s in recs if len(s) >= 2000]
    frac = sum(n in names for n in long_reads) / len(long_reads)
    check(frac >= 0.9, f"only {frac:.3f} of reads >= 2 kb mapped")
    map_s = prof["stages_s"]["map"]
    return {"phase": 2, "rc": rc, "wall_s": wall, "map_s": map_s,
            "reads_per_s_map": len(recs) / map_s,
            "reads_per_s_wall": len(recs) / wall,
            "index_build_s": prof["stages_s"]["index_build"],
            "index_upload_s": prof["stages_s"]["index_upload"],
            "mapped_frac_ge_2kb": frac, "paf_lines": len(lines),
            "launches": launches, "stages_s": prof["stages_s"],
            "mapper": prof["mapper"]}, lines


def phase_cpu_crosscheck(ref, reads96, recs, gpu_lines) -> dict:
    out = os.path.join(WORK, "cpu96.paf")
    env = dict(os.environ, BIOINFO1_PLATFORM="cpu", BIOINFO1_BAND_CACHE="0")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bioinfo1_tpu_torch.cli", ref, reads96,
         "-o", out], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=900)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"CPU run failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
    with open(out) as fh:
        cpu_lines = fh.read().splitlines()
    first = {n for n, _ in recs[:N_CPU_READS]}
    gpu_first = [line for line in gpu_lines if line.split("\t")[0] in first]
    check(cpu_lines == gpu_first,
          f"CPU and GPU PAF differ for the first {N_CPU_READS} reads")
    return {"phase": 3, "reads": N_CPU_READS, "paf_lines": len(cpu_lines),
            "byte_identical": True, "cpu_wall_s": dt}


def device_time(prof):
    """(busy seconds, top device events) of a torch.profiler run: busy is
    the union of the device intervals; top lists the 12 names with the most
    device time as [name, launches, ms]."""
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in ev):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name: dict = {}
    for e in ev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return busy_us / 1e6, [[k, n, us / 1e3] for k, (n, us) in top]


def phase_profile(genome: str, recs) -> dict:
    """The map stage alone, with the index resident: a fresh mapper's first
    pass (band adaptation from scratch, as one CLI run) and its second pass
    (bands adapted).  Mapper A runs both passes without the profiler (wall
    times); mapper B runs them under torch.profiler, and each of its passes
    reports its own wall time, device busy time and busy share."""
    from torch.profiler import ProfilerActivity, profile
    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig
    dev = torch.device("cuda", 0)
    res: dict = {"phase": 4, "reads": len(recs)}
    for profiled in (False, True):
        mapper = Mapper([("ecoli_like", genome)], MapperConfig(), device=dev)
        mapper.device_index()
        for name in ("fresh", "adapted"):
            before = mapper.counters.as_dict()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if profiled else None
            if prof:
                prof.start()
            t0 = time.perf_counter()
            mapper.map_records(recs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = mapper.counters.as_dict()
            row = {"wall_s": wall, "reads_per_s": len(recs) / wall,
                   "realign_batches": after["realign_batches"]
                   - before["realign_batches"],
                   "cert_misses": (after["cert_total"] - after["cert_hits"])
                   - (before["cert_total"] - before["cert_hits"])}
            if prof:
                prof.stop()
                busy, top = device_time(prof)
                check(busy > 0, "the profiler recorded no device time")
                row.update(device_busy_s=busy, busy_share=busy / wall,
                           top_device=top)
            res[f"{name}{'_profiled' if profiled else ''}"] = row
        del mapper
        torch.cuda.empty_cache()
    return res


def main() -> int:
    profile_map = "--profile-map" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 1
    from bioinfo1_tpu_torch.kernels import build

    # Fresh band adaptation in both runs (phase 2 and the phase 3 CPU run).
    os.environ["BIOINFO1_BAND_CACHE"] = "0"
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built_s = build.ensure_built()
    build.library()
    build_s = time.perf_counter() - t0
    with open(build.NVCC_LOG) as fh:
        ptxas = [line.strip() for line in fh
                 if "registers" in line or "Compiling entry" in line]
    emit({"phase": 0, "device": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_s": built_s, "ptxas": ptxas})

    rows = phase_kernels(dev)
    emit({"phase": 1, "kernels": rows})
    torch.cuda.empty_cache()

    ref, reads, reads96, recs, genome = write_inputs()
    p2, gpu_lines = phase_pipeline(ref, reads, recs)
    emit(p2)
    emit(phase_cpu_crosscheck(ref, reads96, recs, gpu_lines))
    if profile_map:
        emit(phase_profile(genome, recs))

    table = []
    for name, (source, replaces) in KERNELS.items():
        main_row = rows[name][0]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces,
                      "launches": p2["launches"][name],
                      "max_abs_err": max(r["max_abs_err"]
                                         for r in rows[name]),
                      "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                      "shape": main_row["call"]})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
