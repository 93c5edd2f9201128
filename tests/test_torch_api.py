"""The port's top-level API against the JAX package's.

``bioinfo1_tpu_torch`` exports what ``bioinfo1_tpu/__init__.py`` exports:
``PROGRAM_NAME``, ``MapperParams`` and ``ALIGNMENT_TYPES`` at once, and
``Mapper``, ``MapperConfig``, ``map_all``, ``build_index`` and ``map_step``
at first use, so that importing the package imports no torch.  ``map_all``
must give the JAX package's lines in every mode, score-only and with
CIGARs, and runs on the card unless told otherwise.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bioinfo1_tpu
import bioinfo1_tpu_torch
from bioinfo1_tpu.pipeline import mapper as jmapper
from bioinfo1_tpu_torch.utils import simulate as sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def records():
    """A 20 kb genome and six ONT-profile reads, half of them in a band-0
    bucket (<= 512 bp); short, since the plain versions run on the CPU."""
    rng = np.random.default_rng(20261017)
    genome = sim.random_genome(20000, rng)
    recs = sim.simulate_reads(genome, [260, 400, 480, 600, 700, 800], rng)
    return [("chr", genome.tobytes().decode("latin1"))], recs


@pytest.mark.parametrize("cigar", [False, True], ids=["score", "c"])
@pytest.mark.parametrize("mode", bioinfo1_tpu_torch.ALIGNMENT_TYPES)
def test_map_all_matches_jax(records, mode, cigar):
    ref, reads = records
    got = bioinfo1_tpu_torch.map_all(
        ref, reads, bioinfo1_tpu_torch.MapperConfig(align_type=mode,
                                                    output_cigar=cigar),
        device=torch.device("cpu"))
    want = bioinfo1_tpu.map_all(
        ref, reads, jmapper.MapperConfig(align_type=mode, output_cigar=cigar))
    assert got == want
    assert len(got) >= len(reads) - 1
    assert all(("cg:Z:" in line) == cigar for line in got)


def test_eager_names_equal_the_jax_packages():
    assert bioinfo1_tpu_torch.PROGRAM_NAME == bioinfo1_tpu.PROGRAM_NAME
    assert bioinfo1_tpu_torch.ALIGNMENT_TYPES == bioinfo1_tpu.ALIGNMENT_TYPES

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(bioinfo1_tpu_torch.MapperParams) == \
        fields(bioinfo1_tpu.MapperParams)
    assert dataclasses.asdict(bioinfo1_tpu_torch.MapperParams()) == \
        dataclasses.asdict(bioinfo1_tpu.MapperParams())


@pytest.mark.parametrize("name,module", [
    ("Mapper", "bioinfo1_tpu_torch.pipeline.mapper"),
    ("MapperConfig", "bioinfo1_tpu_torch.pipeline.mapper"),
    ("map_all", "bioinfo1_tpu_torch.pipeline.mapper"),
    ("build_index", "bioinfo1_tpu_torch.index.builder"),
    ("map_step", "bioinfo1_tpu_torch.pipeline.device_map"),
])
def test_lazy_name_is_the_ports_object(name, module):
    import importlib
    assert getattr(bioinfo1_tpu_torch, name) is \
        getattr(importlib.import_module(module), name)
    # The JAX package lazily exports the same names.
    assert name in bioinfo1_tpu._LAZY


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError):
        bioinfo1_tpu_torch.not_an_export


def test_bare_import_imports_no_torch():
    code = ("import sys, bioinfo1_tpu_torch as p\n"
            "assert p.PROGRAM_NAME and p.MapperParams() and "
            "p.ALIGNMENT_TYPES\n"
            "bad = sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith('torch.') or m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_map_all_defaults_to_the_card(records, monkeypatch):
    """Without a device argument map_all asks resolve_device(): the card,
    which it never trades for the CPU."""
    ref, reads = records
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BIOINFO1_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bioinfo1_tpu_torch.map_all(ref, reads,
                                   bioinfo1_tpu_torch.MapperConfig())
    # BIOINFO1_PLATFORM=cpu is the other way to the CPU.
    monkeypatch.setenv("BIOINFO1_PLATFORM", "cpu")
    assert bioinfo1_tpu_torch.map_all(
        ref, reads[:2], bioinfo1_tpu_torch.MapperConfig()) == \
        bioinfo1_tpu_torch.map_all(ref, reads[:2],
                                   bioinfo1_tpu_torch.MapperConfig(),
                                   device=torch.device("cpu"))
