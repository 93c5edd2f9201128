"""FASTA/FASTQ ingestion (reference: bioparser usage, team_mapper.cpp:399-402,
527-557) plus input statistics (team_mapper.cpp:186-280).

The hot path delegates to the native C++ extension when available (see
``bioinfo1_tpu/io/native.py``); this module is the pure-Python fallback and
the semantic definition:

* names are the header's first whitespace-delimited token,
* FASTA sequences may wrap lines; all whitespace inside the record is dropped,
* FASTQ records are @name / sequence lines / '+' separator / quality lines of
  matching total length,
* gzip input is transparently decompressed (bioparser supports gzip via zlib),
* format sniffing tries FASTQ first and falls back to FASTA, exactly like the
  reference's try/catch chain.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterator, List, Tuple

Record = Tuple[str, str]  # (name, sequence)


class FormatError(ValueError):
    pass


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            with gzip.open(f) as gz:
                return gz.read()
        return f.read()


def parse_fasta(path: str) -> List[Record]:
    text = _read_bytes(path).decode("latin1")
    pos, n = 0, len(text)
    while pos < n and text[pos].isspace():
        pos += 1
    if pos >= n or text[pos] != ">":
        raise FormatError(f"file is not in FASTA format: {path}")
    records: List[Record] = []
    name = None
    seq_parts: List[str] = []
    for line in text[pos:].splitlines():
        if line.startswith(">"):
            if name is not None:
                records.append((name, "".join(seq_parts)))
            name = line[1:].split(None, 1)[0] if line[1:].strip() else ""
            seq_parts = []
        else:
            seq_parts.append("".join(line.split()))
    if name is not None:
        records.append((name, "".join(seq_parts)))
    return records


def parse_fastq(path: str) -> List[Record]:
    text = _read_bytes(path).decode("latin1")
    lines = [ln.rstrip() for ln in text.splitlines()]
    i, n = 0, len(lines)
    records: List[Record] = []
    while i < n and not lines[i]:
        i += 1
    if i >= n or not lines[i].startswith("@"):
        raise FormatError(f"file is not in FASTQ format: {path}")
    while i < n:
        if not lines[i]:
            i += 1
            continue
        if not lines[i].startswith("@"):
            raise FormatError(f"malformed FASTQ record: {path}")
        name = lines[i][1:].split(None, 1)[0] if lines[i][1:].strip() else ""
        i += 1
        seq_parts: List[str] = []
        while i < n and not lines[i].startswith("+"):
            seq_parts.append(lines[i])
            i += 1
        if i >= n:
            raise FormatError(f"malformed FASTQ record: {path}")
        i += 1  # skip '+' line
        seq = "".join(seq_parts)
        qual_len = 0
        while qual_len < len(seq) and i < n:
            qual_len += len(lines[i])
            i += 1
        if qual_len != len(seq):
            raise FormatError(f"malformed FASTQ record: {path}")
        records.append((name, seq))
    return records


@dataclasses.dataclass
class SniffedReads:
    records: List[Record]
    is_fastq: bool


def _try_native(path: str, mode: int):
    """Native C++ parse (native/fastx.cpp); None if unavailable."""
    try:
        from bioinfo1_tpu_torch.io import native_io
        return native_io.parse(path, mode)
    except Exception:
        return None


def parse_fasta_any(path: str) -> List[Record]:
    """FASTA parse preferring the native parser (identical semantics)."""
    res = _try_native(path, 1)
    if res is not None:
        kind, records = res
        if kind != 1:
            raise FormatError(f"file is not in FASTA format: {path}")
        return records
    return parse_fasta(path)


def parse_reads(path: str) -> SniffedReads:
    """FASTQ-first format sniffing with FASTA fallback (team_mapper.cpp:527-557)."""
    res = _try_native(path, 0)
    if res is not None:
        kind, records = res
        if kind == 2:
            return SniffedReads(records, True)
        if kind == 1:
            return SniffedReads(records, False)
        raise FormatError("Given file is not in FASTA or FASTQ format!")
    try:
        return SniffedReads(parse_fastq(path), True)
    except FormatError:
        pass
    try:
        return SniffedReads(parse_fasta(path), False)
    except FormatError:
        raise FormatError("Given file is not in FASTA or FASTQ format!")


def parse_reads_slice(path: str, lo: int, hi: int
                      ) -> Tuple[SniffedReads, int]:
    """Records [lo, hi) plus the TOTAL record count (multi-host read
    sharding: each process materializes only its contiguous slice; a
    count-only native pass sizes the slices, so per-host memory is
    ~1/nproc of the reads file instead of all of it)."""
    try:
        from bioinfo1_tpu_torch.io import native_io
        res = native_io.parse_slice(path, 0, lo, hi)
    except Exception:
        res = None
    if res is not None:
        kind, records, total = res
        if kind == 2:
            return SniffedReads(records, True), total
        if kind == 1:
            return SniffedReads(records, False), total
        raise FormatError("Given file is not in FASTA or FASTQ format!")
    sr = parse_reads(path)          # pure-Python fallback: parse then slice
    return SniffedReads(sr.records[lo:hi], sr.is_fastq), len(sr.records)


def _open_text(path: str):
    """Line-buffered latin1 text stream, transparently gunzipping."""
    f = open(path, "rb")
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.open(f), encoding="latin1")
    return io.TextIOWrapper(f, encoding="latin1")


def _iter_fasta_records(fh) -> Iterator[Record]:
    name = None
    parts: List[str] = []
    for line in fh:
        line = line.rstrip("\r\n")
        if line.startswith(">"):
            if name is not None:
                yield (name, "".join(parts))
            name = line[1:].split(None, 1)[0] if line[1:].strip() else ""
            parts = []
        else:
            parts.append("".join(line.split()))
    if name is not None:
        yield (name, "".join(parts))


def _iter_fastq_records(fh) -> Iterator[Record]:
    it = iter(fh)
    line = None
    for raw in it:
        line = raw.rstrip()
        if line:
            break
    else:
        return
    while True:
        if not line.startswith("@"):
            raise FormatError("malformed FASTQ record")
        name = line[1:].split(None, 1)[0] if line[1:].strip() else ""
        seq_parts: List[str] = []
        for raw in it:
            line = raw.rstrip()
            if line.startswith("+"):
                break
            seq_parts.append(line)
        else:
            raise FormatError("malformed FASTQ record")
        seq = "".join(seq_parts)
        qual_len = 0
        while qual_len < len(seq):
            try:
                qual_len += len(next(it).rstrip())
            except StopIteration:
                raise FormatError("malformed FASTQ record")
        if qual_len != len(seq):
            raise FormatError("malformed FASTQ record")
        yield (name, seq)
        for raw in it:
            line = raw.rstrip()
            if line:
                break
        else:
            return


@dataclasses.dataclass
class ReadStream:
    """Constant-memory reads ingestion (the reference parses FASTQ in 1 GB
    chunks, team_mapper.cpp:534-545; this is the streaming analog for both
    formats)."""

    is_fastq: bool
    batches: Iterator[List[Record]]


def stream_reads_native(path: str,
                        batch_records: int = 16384) -> ReadStream:
    """Record-sliced streaming over the NATIVE parser: one count-only C++
    pass sizes the stream, then each batch is a record-slice parse.

    CAUTION: every slice re-reads (and re-gunzips) the whole file, so
    total work is O(file * n_batches) - the right shape for the multi-host
    pattern (one count pass + ONE slice per process) but NOT for
    whole-file streaming, where the single-pass Python ``stream_reads``
    is strictly better.  Falls back to stream_reads when the native
    library is unavailable."""
    try:
        from bioinfo1_tpu_torch.io import native_io
        res = native_io.parse_slice(path, 0, 0, 0)
    except Exception:
        res = None
    if res is None:
        return stream_reads(path)
    kind, _, total = res
    if kind == 0:
        raise FormatError("Given file is not in FASTA or FASTQ format!")

    def batches() -> Iterator[List[Record]]:
        from bioinfo1_tpu_torch.io import native_io
        for lo in range(0, total, batch_records):
            _, records, _ = native_io.parse_slice(
                path, kind, lo, min(lo + batch_records, total))
            yield records

    return ReadStream(is_fastq=kind == 2, batches=batches())


def stream_reads(path: str, chunk_bases: int = 1 << 30) -> ReadStream:
    """Iterate (name, seq) record batches of ~chunk_bases total sequence
    without materializing the whole file.  Format is sniffed from the first
    non-space byte ('@' FASTQ / '>' FASTA - the formats are mutually
    exclusive on that byte, so this matches the reference's try-FASTQ-first
    fallback chain without a second pass)."""
    first = None
    with _open_text(path) as fh:
        while True:
            ch = fh.read(1)
            if not ch:
                break
            if not ch.isspace():
                first = ch
                break
    if first not in ("@", ">"):
        raise FormatError("Given file is not in FASTA or FASTQ format!")
    is_fastq = first == "@"

    def batches() -> Iterator[List[Record]]:
        with _open_text(path) as fh:
            it = (_iter_fastq_records(fh) if is_fastq
                  else _iter_fasta_records(fh))
            batch: List[Record] = []
            bases = 0
            for rec in it:
                batch.append(rec)
                bases += len(rec[1])
                if bases >= chunk_bases:
                    yield batch
                    batch, bases = [], 0
            if batch:
                yield batch

    return ReadStream(is_fastq=is_fastq, batches=batches())


def basic_statistics(records: List[Record], kind: str) -> str:
    """Per-file statistics block (-s flag), byte-matching the reference's
    printBasicStatisticFASTA/FASTQ (team_mapper.cpp:186-280): per-sequence
    name + length lines, count, integer-division mean, max, min, and N50.
    """
    lines = []
    total_bases = 0
    max_len, min_len = 0, None
    all_lengths = []
    label = "SequenceFASTA" if kind == "fasta" else "SequenceFASTQ"
    for name, seq in records:
        size = len(seq)
        all_lengths.append(size)
        total_bases += size
        lines.append(f"{label} name: {name}")
        lines.append(f"Length of sequence: {size}")
        max_len = max(max_len, size)
        min_len = size if min_len is None else min(min_len, size)
    count = len(records)
    lines.append(f"Total number of sequences: {count}")
    lines.append(f"Average length of sequences: {total_bases // count if count else 0}")
    lines.append(f"Maximal length of sequence: {max_len}")
    lines.append(f"Minimal length of sequence: {min_len if min_len is not None else 0}")
    cumulative = 0
    for length in sorted(all_lengths, reverse=True):
        cumulative += length
        if cumulative >= total_bases // 2:
            lines.append(f"N50 length: {length}")
            break
    return "\n".join(lines)
