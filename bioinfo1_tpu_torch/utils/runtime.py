"""Device resolution (port of bioinfo1_tpu/utils/runtime.py).

The JAX package pins a backend with ``configure_jax``.  The port reads the
same knob, ``BIOINFO1_PLATFORM``, once per run and hands the resulting
``torch.device`` to the mapper:

* ``cuda`` (the default): the first CUDA device.  If CUDA is absent the
  run raises - it never continues on the CPU.
* ``cpu``: the plain PyTorch versions of every kernel, on the CPU (what the
  tests use).
"""

from __future__ import annotations

import os

import torch


def resolve_device() -> torch.device:
    """The device named by ``BIOINFO1_PLATFORM`` (default ``cuda``)."""
    name = os.environ.get("BIOINFO1_PLATFORM", "cuda")
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "BIOINFO1_PLATFORM=cuda but torch finds no CUDA device; "
                "set BIOINFO1_PLATFORM=cpu to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(
        f"BIOINFO1_PLATFORM={name!r}: the port accepts 'cpu' or 'cuda'")
