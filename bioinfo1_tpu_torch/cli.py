"""Command-line entry point (port of bioinfo1_tpu/cli.py).

Same surface, defaults, help/version text and exit codes as the JAX
package's CLI for the flags the port runs: ``-a -m -n -g -k -w -f -c -s -o
--sam-cigar --resume --profile --batch-size --save-index --load-index -h
--version``, ``--bug-compat`` (except FASTA match nesting) and
``--devices`` 0 or 1.  The device comes from ``BIOINFO1_PLATFORM``
(``cuda`` by default, or ``cpu``).

Refused with rc 1 and a one-line message, never silently ignored: ``-c``
where no exactness certificate exists (``-a global`` with ``-g >= 0``,
``-a local`` / ``semiGlobal`` with ``-g > 0``), ``--bug-compat`` on a
FASTA reads file (FASTA match nesting) - both run on the JAX package's
staged host path - ``--devices N`` with N > 1, and the multi-process
variables ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import List, Optional

from bioinfo1_tpu.cli import (HELP_TEXT, PROGRAM_NAME, VERSION, _atof, _atoi,
                              _resume_state, _write_progress)
from bioinfo1_tpu.io import fastx
from bioinfo1_tpu.utils import stats as st

_NOT_PORTED = "is not yet ported to bioinfo1_tpu_torch"
_MULTI_PROCESS_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                       "JAX_PROCESS_ID")


def main(argv: Optional[List[str]] = None, stdout=None, stderr=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = stdout if stdout is not None else sys.stdout
    err = stderr if stderr is not None else sys.stderr

    from bioinfo1_tpu_torch.pipeline.mapper import (Mapper, MapperConfig,
                                                    unported_features)

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

    # FASTA match nesting is refused below, once the reads file is known.
    refused = (unported_features(
        dataclasses.replace(cfg, fasta_match_nesting=False)) or [None])[0]
    if refused is None and any(os.environ.get(v)
                               for v in _MULTI_PROCESS_VARS):
        refused = ("a multi-process run (" + " / ".join(_MULTI_PROCESS_VARS)
                   + ")")
    if refused:
        print(f"Error: {refused} {_NOT_PORTED}", file=err)
        return 1

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
    # FASTA match nesting applies only to a FASTA reads file, which is not
    # known yet; the index does not depend on it, so build without it and
    # refuse below once the reads file is sniffed.
    with timers.stage("index_build"):
        mapper = Mapper(reference_records,
                        dataclasses.replace(cfg, fasta_match_nesting=False),
                        load_index=load_index, device=device)
    if save_index:
        from bioinfo1_tpu.index.builder import save_index as do_save
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

    # Constant-memory streaming for file output without -s (which needs
    # every record up front).
    stream_mode = out_path is not None and not statistic
    reads = None
    try:
        if stream_mode:
            stream = fastx.stream_reads(file2)
            is_fastq = stream.is_fastq
        else:
            reads = fastx.parse_reads(file2)
            is_fastq = reads.is_fastq
    except (OSError, fastx.FormatError):
        print("Given file is not in FASTA or FASTQ format! ", file=err)
        return 1
    if cfg.fasta_match_nesting and not is_fastq:
        print(f"Error: --bug-compat on a FASTA reads file (FASTA match "
              f"nesting) {_NOT_PORTED}", file=err)
        return 1

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
