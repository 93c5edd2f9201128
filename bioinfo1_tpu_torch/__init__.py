"""bioinfo1_tpu_torch - the mapper ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``bioinfo1_tpu`` (the JAX package, which stays the
reference).  Module names follow the JAX package so each counterpart is
easy to find; every module's docstring names the JAX file it ports.

Layers:
  cli               command-line entry point
  pipeline/         host pipeline (mapper.py) and the fused step (device_map.py)
  ops/              tensor ops, each kernel beside its plain PyTorch version
  kernels/build.py  nvcc build + ctypes binding of csrc/*.cu
  utils/            device resolution, stage timers and counters, CIGAR and
                    statistics text, the read simulator
  io/, index/, native.py
                    FASTA/FASTQ parsing, the index builder and the ctypes
                    binding of build/libbioinfo1_native.so (numpy and
                    ctypes only)

The port imports nothing of ``bioinfo1_tpu``: the host-only modules are
its own copies.

The top-level API is the JAX package's: ``PROGRAM_NAME``, ``MapperParams``
and ``ALIGNMENT_TYPES`` here, and, imported at first use (so that
``import bioinfo1_tpu_torch`` imports no torch), ``Mapper``,
``MapperConfig``, ``map_all``, ``build_index`` and ``map_step``.
"""

import dataclasses

__version__ = "0.1.0"
PROGRAM_NAME = "bioinfo1-tpu"

ALIGNMENT_TYPES = ("global", "local", "semiGlobal")


@dataclasses.dataclass
class MapperParams:
    """The reference mapper's parameters, as the JAX package's test oracle
    names them (its ``reference_model.MapperParams``); the mapper itself
    takes ``MapperConfig``."""

    align_type: str = "global"
    match: int = 1
    mismatch: int = -1
    gap: int = -1
    k: int = 15
    w: int = 5
    f: float = 0.001
    output_cigar: bool = False
    # bug-compat switches (all False = fixed semantics)
    banned_rev_from_fwd: bool = False
    fasta_match_nesting: bool = False
    local_target_begin_end: bool = False
    oob_end_windows: bool = False


_LAZY = {
    "Mapper": ("bioinfo1_tpu_torch.pipeline.mapper", "Mapper"),
    "MapperConfig": ("bioinfo1_tpu_torch.pipeline.mapper", "MapperConfig"),
    "map_all": ("bioinfo1_tpu_torch.pipeline.mapper", "map_all"),
    "build_index": ("bioinfo1_tpu_torch.index.builder", "build_index"),
    "map_step": ("bioinfo1_tpu_torch.pipeline.device_map", "map_step"),
}


def __getattr__(name):
    """The lazy part of the API (importing torch only when it is used)."""
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
