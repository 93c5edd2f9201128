"""The command as a benchmark run starts it: no card, no result; no
program, no result; and nothing a run loads is JAX or the JAX package."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import cell
from conftest import DATA, ROOT

ARGS = ["--workload", "ecoli_paf.ont_2_8kb", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = _run(ROOT)
    _no_result(proc)
    assert "no CUDA device" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bioinfo1_tpu_torch_x", object())
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bioinfo1_tpu.utils", object())
    assert cell.forbidden_modules() == ["bioinfo1_tpu"]


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_harness_sources_import_no_jax():
    here = os.path.join(ROOT, "benchmark")
    for dirpath, _dirs, files in os.walk(here):
        if "tests" in dirpath.split(os.sep):
            continue
        for fn in files:
            if fn.endswith(".py"):
                assert not set(_imports(os.path.join(dirpath, fn))) & set(
                    cell.FORBIDDEN), fn
    ref = os.path.join(here, "references", "mapper.py")
    assert not {"bioinfo1_tpu_torch", "benchmark"} & set(_imports(ref))


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then sys.modules."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import cell\n"
        f"c = cell.Cell('ecoli_paf.ont_50kb', "
        f"spec_path={os.path.join(DATA, 'BENCHMARK.json')!r}, "
        f"traffic_dir={os.path.join(DATA, 'traffic')!r})\n"
        "r = cell.run_cell(c, 5, 1.0, False, devices=[torch.device('cpu')])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))
    assert "bioinfo1_tpu_torch" in loaded
    assert not loaded & set(cell.FORBIDDEN)
