"""chip_smoke.py makes its own ONT-profile data and reads its own profile;
both are checked here on the CPU.

The smoke's simulator must draw exactly what bioinfo1_tpu/utils/simulate.py
draws from the same seed, so its genome and reads are the ones the JAX
package's tests and tools use.  The smoke also imports no JAX and, with no
CUDA device, exits non-zero before printing a result.
"""

import importlib.util
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bioinfo1_tpu.utils import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 20250817])
def test_random_genome_matches_simulate(smoke, seed):
    got = smoke.random_genome(50_000, np.random.default_rng(seed))
    want = simulate.random_genome(50_000, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 7, 99])
def test_mutate_read_matches_simulate(smoke, seed):
    frag = simulate.random_genome(6000, np.random.default_rng(seed + 1000))
    got = smoke.mutate_read(frag, np.random.default_rng(seed))
    want = simulate.mutate_read(frag, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


def test_simulate_reads_matches_simulate(smoke):
    genome = simulate.random_genome(200_000, np.random.default_rng(5))
    lengths = [200, 500, 2000, 4000, 8000, 350, 2000, 4000]
    got = smoke.simulate_reads(genome, lengths, np.random.default_rng(6))
    want = simulate.simulate_reads(genome, lengths, np.random.default_rng(6))
    assert got == want


def test_device_time_merges_overlapping_intervals(smoke):
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU

    def ev(name, start, end, dev=cuda):
        rng = SimpleNamespace(start=start, end=end,
                              elapsed_us=lambda: end - start)
        return SimpleNamespace(name=name, device_type=dev, time_range=rng)

    prof = SimpleNamespace(events=lambda: [
        ev("k2", 0.0, 100.0), ev("k2", 50.0, 120.0), ev("k1", 200.0, 210.0),
        ev("host_op", 0.0, 1000.0, cpu), ev("k3", 205.0, 208.0)])
    busy, top = smoke.device_time(prof)
    assert busy == 130.0 / 1e6
    assert top == [["k2", 2, 0.17], ["k1", 1, 0.01], ["k3", 1, 0.003]]


def test_smoke_imports_no_jax_and_fails_without_cuda():
    code = ("import runpy, sys\n"
            "sys.argv = ['chip_smoke.py']\n"
            "try:\n"
            "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules if m == 'jax'"
            " or m.startswith('jax.') or m.startswith('bioinfo1_tpu.')"
            " or m == 'bioinfo1_tpu']\n"
            "print('RC', rc, 'BAD', bad)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "RC 1 BAD []", proc.stdout
