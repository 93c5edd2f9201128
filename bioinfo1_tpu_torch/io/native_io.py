"""ctypes binding for the native FASTA/FASTQ parser (native/fastx.cpp).

Returns the same (name, sequence) record lists as the pure-Python parsers in
io/fastx.py (which remain the executable spec and fallback).  The native
path is one C++ pass + two memcpys; the Python path line-splits the whole
file in the interpreter.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from bioinfo1_tpu_torch import native as _native_mod

Record = Tuple[str, str]

_configured = False


def _lib():
    global _configured
    lib = _native_mod.get_lib()
    if lib is None:
        return None
    if not _configured:
        lib.bioinfo1_fastx_parse.restype = ctypes.c_void_p
        lib.bioinfo1_fastx_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
        if hasattr(lib, "bioinfo1_fastx_parse_slice"):
            lib.bioinfo1_fastx_parse_slice.restype = ctypes.c_void_p
            lib.bioinfo1_fastx_parse_slice.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64]
            lib.bioinfo1_fastx_total.restype = ctypes.c_int64
            lib.bioinfo1_fastx_total.argtypes = [ctypes.c_void_p]
        lib.bioinfo1_fastx_kind.restype = ctypes.c_int
        lib.bioinfo1_fastx_kind.argtypes = [ctypes.c_void_p]
        for fn in ("count", "name_bytes", "seq_bytes"):
            f = getattr(lib, f"bioinfo1_fastx_{fn}")
            f.restype = ctypes.c_int64
            f.argtypes = [ctypes.c_void_p]
        lib.bioinfo1_fastx_copy.restype = None
        lib.bioinfo1_fastx_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64)]
        lib.bioinfo1_fastx_free.restype = None
        lib.bioinfo1_fastx_free.argtypes = [ctypes.c_void_p]
        _configured = True
    return lib


def parse(path: str, mode: int = 0) -> Optional[Tuple[int, List[Record]]]:
    """Parse via the native library.

    mode: 0 = sniff FASTQ-then-FASTA, 1 = FASTA, 2 = FASTQ.
    Returns (kind, records) with kind 1=fasta/2=fastq, or None when the
    native library is unavailable.  Raises nothing: kind 0 means the file
    failed to parse in the requested mode(s).
    """
    lib = _lib()
    if lib is None:
        return None
    h = lib.bioinfo1_fastx_parse(path.encode(), mode)
    return _materialize(lib, h)


def parse_slice(path: str, mode: int, lo: int, hi: int
                ) -> Optional[Tuple[int, List[Record], int]]:
    """Parse keeping only records [lo, hi) (multi-host read sharding).

    Returns (kind, records, total_record_count); lo == hi == 0 is a
    count-only pass (no sequence bytes held).  None when the native library
    (or its slice entry point) is unavailable.
    """
    lib = _lib()
    if lib is None or not hasattr(lib, "bioinfo1_fastx_parse_slice"):
        return None
    h = lib.bioinfo1_fastx_parse_slice(path.encode(), mode, lo, hi)
    total = int(lib.bioinfo1_fastx_total(h))
    res = _materialize(lib, h, free=False)
    lib.bioinfo1_fastx_free(h)
    if res is None:
        # Malformed file: report kind 0 so the caller raises FormatError
        # directly instead of a TypeError triggering a redundant full-file
        # Python re-parse on every process.
        return (0, [], total)
    kind, records = res
    return (kind, records, total)


def _materialize(lib, h, free: bool = True
                 ) -> Optional[Tuple[int, List[Record]]]:
    try:
        kind = lib.bioinfo1_fastx_kind(h)
        if kind == 0:
            return (0, [])
        n = lib.bioinfo1_fastx_count(h)
        nb = lib.bioinfo1_fastx_name_bytes(h)
        sb = lib.bioinfo1_fastx_seq_bytes(h)
        names = ctypes.create_string_buffer(max(int(nb), 1))
        seqs = ctypes.create_string_buffer(max(int(sb), 1))
        name_off = np.empty(n + 1, dtype=np.int64)
        seq_off = np.empty(n + 1, dtype=np.int64)
        lib.bioinfo1_fastx_copy(
            h, names, name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            seqs, seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        names_b = names.raw[:nb].decode("latin1")
        seqs_b = seqs.raw[:sb].decode("latin1")
        records = [
            (names_b[name_off[i]:name_off[i + 1]],
             seqs_b[seq_off[i]:seq_off[i + 1]])
            for i in range(n)
        ]
        return (kind, records)
    finally:
        if free:
            lib.bioinfo1_fastx_free(h)
