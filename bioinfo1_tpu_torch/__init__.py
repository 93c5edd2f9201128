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
"""

__version__ = "0.1.0"
