"""Command-line entry point (port of bioinfo1_tpu/cli.py).

Same surface, defaults, help/version text and exit codes as the JAX
package's CLI for the flags the port runs: ``-a -m -n -g -k -w -f -c -s -o
--sam-cigar --bug-compat --resume --profile --batch-size --save-index
--load-index --devices -h --version``.  The device comes from
``BIOINFO1_PLATFORM`` (``cuda`` by default, or ``cpu``).  ``--devices N``
deals the batches to at most N local CUDA devices, each holding a copy of
the index (0, the default: all, as the largest power-of-two prefix; 1:
one); on the CPU the run uses one device.  ``-c`` where no exactness
certificate exists (``-a global`` with ``-g >= 0``, ``-a local`` /
``semiGlobal`` with ``-g > 0``) and ``--bug-compat`` on a FASTA reads file
(FASTA match nesting) run on the mapper's staged host path.

Several processes: set ``JAX_COORDINATOR_ADDRESS`` (host:port of process
0), ``JAX_NUM_PROCESSES`` (> 1) and ``JAX_PROCESS_ID`` and launch one
process each, as for the JAX package (parallel/shard.py).  Each process
parses and maps its contiguous read slice on its own devices (give each
its cards with ``CUDA_VISIBLE_DEVICES``), and the PAF is merged to process
0 in input order: to its stdout, or with ``-o FILE`` from the per-process
checkpoints ``FILE.part<p>`` / ``FILE.progress.p<p>`` into ``FILE``, which
``--resume`` continues from after a crash.  A peer that dies fails the run
within seconds, naming the process and ``--resume``.
"""

from __future__ import annotations

import io
import json
import os
import re
import sys
from typing import List, NoReturn, Optional

from bioinfo1_tpu_torch.io import fastx
from bioinfo1_tpu_torch.utils import stats as st

VERSION = "3.1.0"
PROGRAM_NAME = "toolForGenomeAllignment"

HELP_TEXT = (
    "\n"
    f"Usage: {PROGRAM_NAME}[options] <file1> <file2>\n"
    "NOTE: file1 needs to be in FASTA format, while the second file will "
    "contain a set of fragments in either FASTA or FASTQ format.\n"
    "Options: \n"
    "\t  -a, --alignment TYPE     Alignment type: global, local, semiGlobal\n"
    "\t  -m MATCH                 Match score (default: 1)\n"
    "\t  -n MISMATCH              Mismatch penalty (default: -1)\n"
    "\t  -g GAP                   Gap penalty (default: -1)\n"
    "\t  -k KMER                  k-mer length for minimizers (default: 15)\n"
    "\t  -w WINDOW                window size for minimizers (default: 5)\n"
    "\t  -f FREQUENCY_THRESHOLD   Frequency threshold factor (default: 0.001)\n"
    "\t  -c                       Output CIGAR string\n"
    "\t  -h, --help               Show this help message\n"
    "\t  --version                Show version information\n"
    "\t  -s                       Basic statistic for first and second file\n"
)


def _write_progress(path: str, completed: int, total, part_bytes) -> None:
    """Atomic checkpoint write: completed read count plus the output file's
    byte offset at that point (the resume path truncates to it)."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"completed_reads": completed, "total_reads": total,
                   "part_bytes": part_bytes}, fh)
    os.replace(tmp, path)


def _peer_failure_exit(err, e) -> NoReturn:
    """A peer process failed: report and exit at once, without atexit
    hooks - no CUDA or gloo teardown may block against the dead peer and
    hide the message."""
    print(str(e), file=err)
    try:
        err.flush()
        sys.stdout.flush()
    except (OSError, ValueError):
        pass
    os._exit(1)


def _resume_state(progress_path: str, part_path: str):
    """(start_at, "a") for --resume.  Output lines are flushed before the
    progress file updates, so a crash in that window leaves lines beyond
    completed_reads in the output file; truncate the file to the byte
    offset the progress file recorded.  Progress files without the offset
    fall back to append-as-is."""
    with open(progress_path) as fh:
        d = json.load(fh)
    start_at = int(d.get("completed_reads", 0))
    pb = d.get("part_bytes")
    if pb is not None:
        with open(part_path, "r+") as fh:
            fh.truncate(int(pb))
    return start_at, "a"


def _atof(s: str) -> float:
    """std::atof semantics: parse the longest leading float, 0.0 on failure
    (the reference parses -f with atof at team_mapper.cpp:374)."""
    m = re.match(
        r"\s*[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?"
        r"|\s*[+-]?(inf(inity)?|nan)", s, re.IGNORECASE)
    if not m:
        return 0.0
    try:
        return float(m.group(0))
    except ValueError:
        return 0.0


def _atoi(s: str) -> int:
    """std::atoi semantics: parse leading integer, 0 on failure."""
    s = s.strip()
    i, n = 0, len(s)
    if i < n and s[i] in "+-":
        i += 1
    j = i
    while j < n and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])


def main(argv: Optional[List[str]] = None, stdout=None, stderr=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = stdout if stdout is not None else sys.stdout
    err = stderr if stderr is not None else sys.stderr

    from bioinfo1_tpu_torch.pipeline.mapper import Mapper, MapperConfig

    cfg = MapperConfig()
    file1 = file2 = ""
    statistic = False
    save_index = load_index = None
    out_path = None
    resume = False
    profile = False

    if not argv:
        print("Error: Not enough arguments", file=err)
        print(HELP_TEXT, end="", file=out)
        return 1
    if argv[0] in ("-h", "--help"):
        print(HELP_TEXT, end="", file=out)
        return 0
    if argv[0] == "--version":
        print(f"{PROGRAM_NAME} v{VERSION}", file=out)
        return 0
    if len(argv) < 2:
        print("Error: Expected two input files", file=err)
        return 1

    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-a", "--alignment") and i + 1 < len(argv):
            i += 1
            if argv[i] in ("global", "local", "semiGlobal"):
                cfg.align_type = argv[i]
            else:
                print("Error: Expected Alignment type: global, local, "
                      "semiGlobal", file=err)
                print(HELP_TEXT, end="", file=out)
                return 1
        elif a == "-m" and i + 1 < len(argv):
            i += 1
            cfg.match = _atoi(argv[i])
        elif a == "-n" and i + 1 < len(argv):
            i += 1
            cfg.mismatch = _atoi(argv[i])
        elif a == "-g" and i + 1 < len(argv):
            i += 1
            cfg.gap = _atoi(argv[i])
        elif a == "-k" and i + 1 < len(argv):
            i += 1
            cfg.k = _atoi(argv[i])
        elif a == "-w" and i + 1 < len(argv):
            i += 1
            cfg.w = _atoi(argv[i])
        elif a == "-f" and i + 1 < len(argv):
            i += 1
            cfg.f = _atof(argv[i])
        elif a == "-c":
            cfg.output_cigar = True
        elif a == "-s":
            statistic = True
        elif a == "--sam-cigar":
            cfg.sam_cigar = True
        elif a == "--bug-compat":
            cfg.banned_rev_from_fwd = True
            cfg.fasta_match_nesting = True
            cfg.local_target_begin_end = True
            cfg.threshold_from_rev_unique = True
            cfg.exact_ties = True
            cfg.oob_end_windows = True
        elif a == "--save-index" and i + 1 < len(argv):
            i += 1
            save_index = argv[i]
        elif a == "--load-index" and i + 1 < len(argv):
            i += 1
            load_index = argv[i]
        elif a == "-o" and i + 1 < len(argv):
            i += 1
            out_path = argv[i]
        elif a == "--resume":
            resume = True
        elif a == "--profile":
            profile = True
        elif a == "--batch-size" and i + 1 < len(argv):
            i += 1
            cfg.batch_size = max(1, _atoi(argv[i]))
        elif a == "--devices" and i + 1 < len(argv):
            i += 1
            cfg.devices = max(0, _atoi(argv[i]))
        elif not file1:
            file1 = a
        elif not file2:
            file2 = a
        else:
            print(f"Unknown or extra argument: {a}", file=err)
            print(HELP_TEXT, end="", file=out)
            return 1
        i += 1

    if not file1 or not file2:
        print("Error: Two input files are required.", file=err)
        print(HELP_TEXT, end="", file=out)
        return 1

    from bioinfo1_tpu_torch.parallel import shard as ps
    try:
        ps.distributed_initialize_if_needed()
    except ValueError as e:
        print(f"Error: {e}", file=err)
        return 1
    nproc, pid = ps.process_count(), ps.process_index()
    if nproc > 1 and pid != 0:
        # Only process 0 speaks on stdout (statistics and the merged PAF);
        # the others' stdout is discarded.
        out = io.StringIO()

    from bioinfo1_tpu_torch.utils.runtime import resolve_device
    try:
        device = resolve_device()
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=err)
        return 1

    try:
        reference_records = fastx.parse_fasta_any(file1)
    except (OSError, fastx.FormatError) as e:
        print(f"Error: cannot read reference FASTA: {e}", file=err)
        return 1
    if not reference_records:
        print(f"Error: reference FASTA is empty: {file1}", file=err)
        return 1
    if statistic:
        print("Basic statistic for reference genome", file=out)
        print("------------------------------------", file=out)
        print(fastx.basic_statistics(reference_records, "fasta"), file=out)

    from bioinfo1_tpu_torch.utils.tracing import Counters, StageTimers
    timers = StageTimers(device)
    counters = Counters()
    with timers.stage("index_build"):
        mapper = Mapper(reference_records, cfg, load_index=load_index,
                        device=device)
    if save_index:
        from bioinfo1_tpu_torch.index.builder import save_index as do_save
        do_save(mapper.index, save_index)
    with timers.stage("index_upload"):
        mapper.device_index()

    if statistic:
        idx = mapper.index
        print(st.index_statistics(
            (idx.fwd.n_distinct_hashes, idx.fwd.n_singleton_hashes,
             idx.fwd.top_surviving),
            (idx.rev.n_distinct_hashes, idx.rev.n_singleton_hashes,
             idx.rev.top_surviving),
            cfg.k), file=out)

    # The liveness-aware merge channel opens before mapping: a peer that
    # dies mid-run fails the whole job in seconds (naming the resumable
    # part files) instead of stalling the merge for its timeout.
    merge_sess = (ps.MergeSession(part_hint=out_path or "")
                  if nproc > 1 else None)

    # Constant-memory streaming for file output without -s (which needs
    # every record up front), in one-process runs.
    stream_mode = out_path is not None and not statistic and nproc == 1
    reads = None
    total_reads = None
    try:
        if stream_mode:
            stream = fastx.stream_reads(file2)
            is_fastq = stream.is_fastq
        elif nproc > 1 and not statistic:
            # A count-only pass sizes the slices, then each process reads
            # only its own contiguous slice of records.
            _, total_reads = fastx.parse_reads_slice(file2, 0, 0)
            lo, hi = ps.process_read_slice(total_reads)
            reads, _ = fastx.parse_reads_slice(file2, lo, hi)
            is_fastq = reads.is_fastq
        else:
            reads = fastx.parse_reads(file2)
            is_fastq = reads.is_fastq
    except (OSError, fastx.FormatError):
        print("Given file is not in FASTA or FASTQ format! ", file=err)
        return 1
    # The FASTA-branch match-nesting bug only applies when the reads file
    # is FASTA (team_mapper.cpp:629-638); the mapper shares ``cfg``.
    if cfg.fasta_match_nesting and is_fastq:
        cfg.fasta_match_nesting = False

    if statistic:
        print(file=out)
        print("Basic statistic for fragments of genome", file=out)
        print("------------------------------------", file=out)
        kind = "fastq" if is_fastq else "fasta"
        print(fastx.basic_statistics(reads.records, kind), file=out)
    # Per-read stats only exist in the reference's FASTA branch.
    per_read_stats = statistic and not is_fastq

    def report():
        if profile:
            print(timers.report(), file=err)
            print(counters.json_line(), file=err)
            print(json.dumps(mapper.counters.as_dict()), file=err)

    counters.start()
    if nproc > 1:
        if total_reads is not None:
            local_records = reads.records       # already this one's slice
        else:
            lo, hi = ps.process_read_slice(len(reads.records))
            local_records = reads.records[lo:hi]
        start_at = 0
        if out_path is None:
            with timers.stage("map"):
                local_lines = mapper.map_records(
                    local_records, per_read_stats=per_read_stats)
        else:
            # Every process checkpoints its slice to a part file of its
            # own, so --resume works per process and the merge reruns from
            # the completed parts after a crash.
            part_path = f"{out_path}.part{pid}"
            progress_path = f"{out_path}.progress.p{pid}"
            fmode = "w"
            if (resume and os.path.exists(progress_path)
                    and os.path.exists(part_path)):
                start_at, fmode = _resume_state(progress_path, part_path)
            try:
                with timers.stage("map"), open(part_path, fmode) as pf:
                    for done, lines in mapper.map_records_iter(
                            local_records, per_read_stats=per_read_stats,
                            start_at=start_at):
                        for line in lines:
                            print(line, file=pf)
                        pf.flush()
                        _write_progress(progress_path, done,
                                        len(local_records), pf.tell())
                        # Abort (resumably) within seconds of a peer dying
                        # rather than mapping to completion first.
                        merge_sess.check()
            except RuntimeError as e:
                _peer_failure_exit(err, e)
            with open(part_path) as pf:
                local_lines = pf.read().splitlines()
        try:
            with timers.stage("merge"):
                merged = merge_sess.gather(local_lines)
        except RuntimeError as e:
            _peer_failure_exit(err, e)
        if merged is not None:
            if out_path is None:
                for line in merged:
                    print(line, file=out)
            else:
                with open(out_path, "w") as sink:
                    for line in merged:
                        print(line, file=sink)
        counters.observe(len(local_records) - start_at,
                         sum(len(s) for _, s in local_records[start_at:]),
                         mapper.counters.dp_cells, mapper.counters.mapped)
        report()
        return 0

    if out_path is None:
        with timers.stage("map"):
            lines = mapper.map_records(reads.records,
                                       per_read_stats=per_read_stats)
        for line in lines:
            print(line, file=out)
        counters.observe(len(reads.records),
                         sum(len(s) for _, s in reads.records),
                         mapper.counters.dp_cells,
                         sum(1 for line in lines if "\t" in line))
        report()
        return 0

    # Checkpointed file output: FILE.progress records the number of fully
    # processed reads; --resume continues from there after a crash.
    progress_path = out_path + ".progress"
    start_at = 0
    file_mode = "w"
    if resume and os.path.exists(progress_path) and os.path.exists(out_path):
        start_at, file_mode = _resume_state(progress_path, out_path)

    if stream_mode:
        done = 0
        n_bases = 0
        with timers.stage("map"), open(out_path, file_mode) as paf_out:
            for batch in stream.batches:
                lo = max(0, start_at - done)
                if lo >= len(batch):
                    done += len(batch)
                    continue
                base = done + lo
                n_bases += sum(len(s) for _, s in batch[lo:])
                for nxt, lines in mapper.map_records_iter(batch[lo:]):
                    for line in lines:
                        print(line, file=paf_out)
                    paf_out.flush()
                    _write_progress(progress_path, base + nxt, None,
                                    paf_out.tell())
                done += len(batch)
            paf_out.flush()
            _write_progress(progress_path, done, done, paf_out.tell())
        counters.observe(done - start_at, n_bases, mapper.counters.dp_cells,
                         mapper.counters.mapped)
        report()
        return 0

    with timers.stage("map"), open(out_path, file_mode) as paf_out:
        for done, lines in mapper.map_records_iter(
                reads.records, per_read_stats=per_read_stats,
                start_at=start_at):
            for line in lines:
                print(line, file=paf_out)
            paf_out.flush()
            _write_progress(progress_path, done, len(reads.records),
                            paf_out.tell())
    counters.observe(len(reads.records) - start_at,
                     sum(len(s) for _, s in reads.records[start_at:]),
                     mapper.counters.dp_cells, mapper.counters.mapped)
    report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
