"""ctypes bindings for the native host runtime (build/libbioinfo1_native.so).

The reference is pure C++; our host-side glue - bug-compat oracles, the
FASTA/FASTQ parser (native/fastx.cpp via io/native_io.py), and the PAF
serializer (native/paf.cpp, bound here) - is C++ too, bound with ctypes
(the image ships no pybind11).  The library is built lazily via
tools/build_native.sh; everything degrades gracefully to Python fallbacks
when the toolchain is unavailable.

The fallbacks are not the library in every respect: ``freq_orders2`` (the
reference's frequency-tie order, under ``--bug-compat``) has none, so the
output depends on whether the library loaded.  A load therefore never gives
up on a library that another process is still writing: the port's builds
are serialised by a lock file beside the library, and a library that exists
but does not load yet (the JAX package's loader builds it in place, without
the lock) is retried for up to ``_LOAD_WAIT_S`` seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import time
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_REPO, "build", "libbioinfo1_native.so")
_BUILD_SCRIPT = os.path.join(_REPO, "tools", "build_native.sh")
_LOAD_WAIT_S = 120.0

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None on failure."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib = _build_and_load()
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bioinfo1_freq_orders2.restype = ctypes.c_int64
        lib.bioinfo1_freq_orders2.argtypes = [
            u32p, ctypes.c_int64, u32p, ctypes.c_int64,
            u32p, i32p, u32p, ctypes.c_int64,
            u32p, i32p, u32p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.bioinfo1_paf_format.restype = ctypes.c_int64
        lib.bioinfo1_paf_format.argtypes = [
            ctypes.c_char_p, i64p,
            i32p, u8p, u8p, i32p, i32p, i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, i64p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        if hasattr(lib, "bioinfo1_cigar_rle"):
            lib.bioinfo1_cigar_rle.restype = ctypes.c_int64
            lib.bioinfo1_cigar_rle.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64,
                i32p, i32p, i32p, i32p, i32p,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_char_p, ctypes.c_int64, i64p, i32p,
            ]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    return _lib


def _build_and_load() -> ctypes.CDLL:
    """Build the library if it is missing (one process at a time), then load
    it, retrying while the file exists but does not load yet."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    with open(_LIB_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_LIB_PATH) and os.path.exists(_BUILD_SCRIPT):
            subprocess.run([_BUILD_SCRIPT], check=True, capture_output=True)
    deadline = time.monotonic() + _LOAD_WAIT_S
    while True:
        try:
            return ctypes.CDLL(_LIB_PATH)
        except OSError:
            if not os.path.exists(_LIB_PATH) or time.monotonic() > deadline:
                raise
            time.sleep(0.5)


#: Per-strand histogram orderings: (iter_hash, iter_count, sorted_hash).
StrandOrders = Tuple[np.ndarray, np.ndarray, np.ndarray]


def freq_orders2(fwd_hashes: np.ndarray, rev_hashes: np.ndarray,
                 ) -> Optional[Tuple[StrandOrders, StrandOrders]]:
    """Replicate the reference's histogram orderings for BOTH strands.

    The streams must be in the reference's Minimize() emit order (prefix,
    dense, suffix windows).  Returns per-strand (iter_hash, iter_count,
    sorted_hash): the libstdc++ map-copy iteration order (drives the stats
    scan) and the post-std::sort count-descending hash order (the banned set
    is its first min(threshold, limit) entries) - or None when the native
    library is unavailable.  The strands share one stateful map exactly like
    the reference's namespace-scope global (see native/bugcompat.cpp).
    """
    lib = get_lib()
    if lib is None:
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fh = np.ascontiguousarray(fwd_hashes, dtype=np.uint32)
    rh = np.ascontiguousarray(rev_hashes, dtype=np.uint32)
    fcap = max(len(fh), 1)
    rcap = max(len(rh), 1)
    f_iter = np.empty(fcap, dtype=np.uint32)
    f_cnt = np.empty(fcap, dtype=np.int32)
    f_sort = np.empty(fcap, dtype=np.uint32)
    r_iter = np.empty(rcap, dtype=np.uint32)
    r_cnt = np.empty(rcap, dtype=np.int32)
    r_sort = np.empty(rcap, dtype=np.uint32)
    rev_m = ctypes.c_int64(0)
    n = lib.bioinfo1_freq_orders2(
        fh.ctypes.data_as(u32p), len(fh), rh.ctypes.data_as(u32p), len(rh),
        f_iter.ctypes.data_as(u32p), f_cnt.ctypes.data_as(i32p),
        f_sort.ctypes.data_as(u32p), fcap,
        r_iter.ctypes.data_as(u32p), r_cnt.ctypes.data_as(i32p),
        r_sort.ctypes.data_as(u32p), rcap, ctypes.byref(rev_m))
    if n < 0:
        return None
    m = rev_m.value
    return ((f_iter[:n], f_cnt[:n], f_sort[:n]),
            (r_iter[:m], r_cnt[:m], r_sort[:m]))


MODE_INT = {"global": 0, "local": 1, "semiGlobal": 2}


def cigar_rle_batch(packed, cols, goal_i, goal_j, q_len, t_len,
                    mode: str, sam_convention: bool = False,
                    local_target_begin_end: bool = False):
    """Decode a batch of CIGARs from PACKED device-walk codes natively.

    ``packed`` is the (S4, B) uint8 tensor ops/trace.pack_codes emits
    (fetched from device); ``cols`` selects each wanted read's column.
    Returns (cigars: List[str], target_begins: List[int]) or None when the
    native library is unavailable - callers fall back to
    utils.cigar.cigar_from_codes on the unpacked codes (the executable
    spec for native/cigar.cpp).
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "bioinfo1_cigar_rle"):
        return None
    # Transpose so each read's code bytes are contiguous for the C++ scan
    # (one ~MB memcpy beats two column-strided passes of cache misses).
    s4, b_total = np.shape(packed)
    p = np.ascontiguousarray(np.asarray(packed, dtype=np.uint8).T)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    n = len(cols)
    gi = np.ascontiguousarray(goal_i, dtype=np.int32)
    gj = np.ascontiguousarray(goal_j, dtype=np.int32)
    ql = np.ascontiguousarray(q_len, dtype=np.int32)
    tl = np.ascontiguousarray(t_len, dtype=np.int32)
    off = np.zeros(n + 1, dtype=np.int64)
    tbs = np.zeros(n, dtype=np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    args = (
        p.ctypes.data_as(u8p), s4, b_total,
        cols.ctypes.data_as(i32p),
        gi.ctypes.data_as(i32p), gj.ctypes.data_as(i32p),
        ql.ctypes.data_as(i32p), tl.ctypes.data_as(i32p),
        n, MODE_INT[mode], 1 if sam_convention else 0,
        1 if local_target_begin_end else 0,
    )
    # Hard output bound (<= 2 chars per op + pad): one single-pass call.
    cap = int(n * (8 * s4 + 32))
    out = ctypes.create_string_buffer(max(cap, 1))
    required = lib.bioinfo1_cigar_rle(
        *args, out, cap, off.ctypes.data_as(i64p),
        tbs.ctypes.data_as(i32p))
    if required < 0 or required > cap:      # unreachable per the bound
        return None
    blob = out.raw[:required].decode("latin1")
    cigars = [blob[off[i]:off[i + 1]] for i in range(n)]
    return cigars, tbs.tolist()


def paf_format(names, read_lens, mappings, ref_name: str, ref_len: int,
               with_cigar: bool):
    """Serialize one batch of PAF rows natively (native/paf.cpp).

    ``mappings`` is the pipeline's List[ReadMapping]; unmapped entries are
    skipped.  Returns the rows as a list of str lines (newline-split of the
    native blob), or None when the native library is unavailable - callers
    fall back to pipeline.mapper.paf_line.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "bioinfo1_paf_format"):
        return None
    n = len(mappings)
    name_blob = "".join(names).encode("latin1")
    name_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s.encode("latin1")) for s in names], out=name_off[1:])
    rl = np.asarray(read_lens, dtype=np.int32)
    mapped = np.fromiter((m.mapped for m in mappings), np.uint8, n)
    is_fwd = np.fromiter((m.is_fwd for m in mappings), np.uint8, n)
    qb = np.fromiter((m.q_begin for m in mappings), np.int32, n)
    qe = np.fromiter((m.q_end for m in mappings), np.int32, n)
    tb = np.fromiter((m.t_begin for m in mappings), np.int32, n)
    te = np.fromiter((m.t_end for m in mappings), np.int32, n)
    sc = np.fromiter((m.score for m in mappings), np.int32, n)
    if with_cigar:
        cigs = [(m.cigar or "") for m in mappings]
        cigar_blob = "".join(cigs).encode("latin1")
        cigar_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(c) for c in cigs], out=cigar_off[1:])
    else:
        cigar_blob = b""
        cigar_off = np.zeros(n + 1, dtype=np.int64)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    args = (
        name_blob, name_off.ctypes.data_as(i64p),
        rl.ctypes.data_as(i32p), mapped.ctypes.data_as(u8p),
        is_fwd.ctypes.data_as(u8p),
        qb.ctypes.data_as(i32p), qe.ctypes.data_as(i32p),
        tb.ctypes.data_as(i32p), te.ctypes.data_as(i32p),
        sc.ctypes.data_as(i32p), n,
        ref_name.encode("latin1"), len(ref_name.encode("latin1")),
        ref_len,
        cigar_blob, cigar_off.ctypes.data_as(i64p),
        1 if with_cigar else 0,
    )
    required = lib.bioinfo1_paf_format(*args, None, 0)
    if required == 0:
        return []
    out = ctypes.create_string_buffer(required)
    lib.bioinfo1_paf_format(*args, out, required)
    return out.raw[:required].decode("latin1").splitlines()
