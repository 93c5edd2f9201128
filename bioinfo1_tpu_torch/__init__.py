"""bioinfo1_tpu_torch - the mapper ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``bioinfo1_tpu`` (the JAX package, which stays the
reference).  Module names follow the JAX package so each counterpart is
easy to find; every module's docstring names the JAX file it ports.

Layers:
  cli               command-line driver (score-only slice)
  pipeline/         host pipeline (mapper.py) and the fused step (device_map.py)
  ops/              tensor ops, each kernel beside its plain PyTorch version
  kernels/build.py  nvcc build + ctypes binding of csrc/*.cu
  utils/            device resolution, stage timers and counters

Host-only modules (FASTA/FASTQ parsing, the index builder, the native
PAF serializer, statistics, the read simulator) are imported from
``bioinfo1_tpu``; they use numpy and ctypes only, never JAX.
"""

__version__ = "0.1.0"
