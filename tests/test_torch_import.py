"""The port imports no JAX, and never falls back to the CPU when CUDA is
asked for and missing."""

import io
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import pkgutil, sys
import bioinfo1_tpu_torch, bioinfo1_tpu_torch.cli
import bioinfo1_tpu_torch.pipeline.mapper
for m in pkgutil.walk_packages(bioinfo1_tpu_torch.__path__,
                               "bioinfo1_tpu_torch."):
    __import__(m.name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_requested_without_cuda_raises(monkeypatch):
    from bioinfo1_tpu_torch.utils import runtime
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in (None, "cuda"):
        if value is None:
            monkeypatch.delenv("BIOINFO1_PLATFORM", raising=False)
        else:
            monkeypatch.setenv("BIOINFO1_PLATFORM", value)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.resolve_device()
    monkeypatch.setenv("BIOINFO1_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        runtime.resolve_device()
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")
    assert runtime.resolve_device() == torch.device("cpu")


def test_cli_without_cuda_exits_1_and_maps_nothing(tmp_path, monkeypatch):
    from bioinfo1_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cuda")
    ref = tmp_path / "ref.fa"
    ref.write_text(">r\n" + "ACGT" * 50 + "\n")
    reads = tmp_path / "reads.fa"
    reads.write_text(">q\n" + "ACGT" * 20 + "\n")
    out, err = io.StringIO(), io.StringIO()
    assert cli.main([str(ref), str(reads)], stdout=out, stderr=err) == 1
    assert out.getvalue() == ""
    assert "no CUDA device" in err.getvalue()


def test_kernel_sources_build_into_build_dir():
    """The build is keyed by a hash of the sources and flags, and targets
    sm_90a under build/torch_kernels (nothing is compiled here)."""
    from bioinfo1_tpu_torch.kernels import build
    assert build.LIB_PATH == os.path.join(
        REPO, "build", "torch_kernels", "libbioinfo1_torch_kernels.so")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    names = sorted(os.path.basename(p) for p in build._sources())
    assert names == ["band_score.cu", "common.cuh", "full_score.cu",
                     "lis_chain.cu", "walk_parents.cu"]
    assert len(build.source_hash()) == 64
