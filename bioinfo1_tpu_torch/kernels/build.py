"""Build and bind the port's hand-written CUDA kernels.

Every ``bioinfo1_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
the objects are linked into one shared library with a plain C interface,
``build/torch_kernels/libbioinfo1_torch_kernels.so``, bound with
``ctypes``: pointers are ``c_void_p`` (``tensor.data_ptr()``), the stream is
``torch.cuda.current_stream().cuda_stream``.  The build runs at first use
and again whenever a source's hash changes (the hash is stamped beside the
library), under an exclusive lock in the build directory, so that several
processes on a fresh tree run ``nvcc`` once: the first builds, the others
wait and find the stamp.  Each C entry point returns ``cudaGetLastError()`` right after
its launch; ``launch`` raises if that is not 0.

A failed build or launch raises.  There is no fallback: the plain PyTorch
versions are taken only for tensors that lie on the CPU, by the wrappers in
``ops/``, before they ever reach this module.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libbioinfo1_torch_kernels.so")
NVCC_LOG = os.path.join(BUILD_DIR, "nvcc.log")
BUILD_LOCK = os.path.join(BUILD_DIR, "build.lock")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: argument types (all return int = cudaError_t).
_SIGNATURES = {
    # f, r, count, R, N, packed_scratch, prev_scratch, qlo_scratch, out,
    # path, threads (ops/chain.chain_plan), stream
    "bioinfo1_lis_chain": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P],
    # q, n, n_pad, t, m, m_eff, q_len, t_len, B, W, n_steps, mode,
    # dash_free, match, mismatch, gap, scratch, out, path, lpt,
    # reads_per_cta (the cluster size on the "cluster" path, the strip
    # width on the "strip" path), smem_bytes (reads per launch on the
    # "strip" path) (ops/band.band_plan), stream
    "bioinfo1_band_score": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P],
    # as bioinfo1_band_score, with parents before the stream
    "bioinfo1_band_parents": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                              _P],
    # parents, mode, cluster, threads, out (int*): clusters resident at once
    "bioinfo1_band_cluster_occupancy": [_I, _I, _I, _I, _P],
    # parents, mode, dash_free, threads, out (int*): strip CTAs an SM holds
    # at once
    "bioinfo1_band_strip_occupancy": [_I, _I, _I, _I, _P],
    # out (int*): the ints of a strip's record in the strip path's scratch
    "bioinfo1_band_strip_rec_ints": [_P],
    # parents, S4, B, W, goal_i, goal_j, score, q, qn, t, tm, mode, match,
    # mismatch, gap, slab_rows, window (ops/trace.WALK_*), out, stream
    "bioinfo1_walk_parents": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I,
                              _I, _I, _I, _I, _I, _I, _P, _P],
    # q, n, t, m, q_len, t_len, B, mode, match, mismatch, gap, row, out,
    # lpt, warps_per_cta (ops/align.full_plan), stream
    "bioinfo1_full_score": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                            _P, _I, _I, _P],
    # x, out, n, n_iter, step, stream
    "bioinfo1_int32_probe": [_P, _P, _L, _I, _I, _P],
}

# Shared memory a block may ask for on Hopper is 227 KB; keep headroom for
# the kernels' static reduction buffers.
SMEM_LIMIT = 220 * 1024

_lock = threading.Lock()
_lib = None
# Kernel launches by CUDA device index, every kernel together (the wrappers
# count by kernel); read and reset like a wrapper's count.
launches_by_device: dict = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc_flags() -> tuple:
    """NVCC_FLAGS, plus one -D for each name in BIOINFO1_NVCC_DEFINES
    (comma-separated; a measurement script's switch for trial
    instantiations, never set by the package)."""
    names = os.environ.get("BIOINFO1_NVCC_DEFINES", "")
    return NVCC_FLAGS + tuple(f"-D{n}" for n in names.split(",") if n)


def source_hash() -> str:
    """sha256 over the nvcc flags and every source and header."""
    h = hashlib.sha256(" ".join(nvcc_flags()).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _cuda_tool(name: str) -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)
    if os.path.exists(cand):
        return cand
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (set CUDA_HOME or put {name} "
                           "on PATH)")
    return found


def _nvcc() -> str:
    return _cuda_tool("nvcc")


def sass() -> str:
    """``cuobjdump -sass`` of the built library: the machine code of every
    kernel, one ``Function : <mangled name>`` section each."""
    ensure_built()
    proc = subprocess.run([_cuda_tool("cuobjdump"), "-sass", LIB_PATH],
                          capture_output=True, text=True, check=True)
    return proc.stdout


def _stamp_matches(want: str) -> bool:
    stamp = LIB_PATH + ".sha256"
    if not (os.path.exists(LIB_PATH) and os.path.exists(stamp)):
        return False
    with open(stamp) as fh:
        return fh.read().strip() == want


def ensure_built() -> float:
    """Build the library if it is missing or stale; seconds spent building
    (0.0 when the stamped hash matched, also when another process built it
    while this one waited for the lock)."""
    want = source_hash()
    if _stamp_matches(want):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    # flock is released when the file closes or its process dies, so a
    # crashed build leaves no lock behind.
    with open(BUILD_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stamp_matches(want):
            return 0.0
        return _build(want)


def _build(want: str) -> float:
    """nvcc every source at once, link, rename the library into place and
    stamp it; seconds spent."""
    stamp = LIB_PATH + ".sha256"
    tmp = f"{LIB_PATH}.tmp{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = os.path.join(BUILD_DIR,
                           f"{os.path.basename(src)}.{os.getpid()}.o")
        cmd = [nvcc, *nvcc_flags(), "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, obj, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{obj} (rc {proc.returncode}):\n{err[-4000:]}")
    objs = [obj for _cmd, obj, _proc in jobs]
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (rc {proc.returncode}):\n"
                          f"{proc.stderr[-4000:]}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(NVCC_LOG, "w") as fh:
        fh.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as fh:
        fh.write(want)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            ensure_built()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bioinfo1_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bioinfo1_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def call(name: str, *args, device: torch.device) -> None:
    """Call C entry point ``name`` with ``device`` current, so the
    library's own CUDA runtime acts there whatever device the calling
    thread had made current; raise on a CUDA error.  Counts nothing: a
    launch goes through ``launch``."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.bioinfo1_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def launch(wrapper, name: str, *args, device: torch.device,
           counter: str = "launches") -> None:
    """Call C entry point ``name`` with ``device`` (the tensors' device)
    current, so the library's own CUDA runtime launches there whatever
    device the calling thread had made current; raise on a CUDA error, else
    count one launch on ``wrapper.<counter>`` (``launches`` unless the
    wrapper serves two kernels) and on ``launches_by_device``."""
    call(name, *args, device=device)
    with _lock:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)
        launches_by_device[device.index] = (
            launches_by_device.get(device.index, 0) + 1)
