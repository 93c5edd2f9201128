"""The CUDA kernel library's build (bioinfo1_tpu_torch/kernels/build.py)
under several processes: ``ensure_built`` holds an exclusive lock in the
build directory around its stale check and build, so that processes
started together on a fresh tree (the CLI's processes of one multi-process
run) compile once.  A stand-in ``nvcc`` here logs each call and writes a
stub object or library."""

import os
import stat
import subprocess
import sys
import time

from bioinfo1_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
sleep 0.3
while [ $# -gt 0 ]; do
  if [ "$1" = -o ]; then out="$2"; fi
  shift
done
printf stub > "$out"
"""

# argv: build dir, fake nvcc, go file.  Says it is ready (a file beside the
# go file), waits for the go file, so that the processes call ensure_built
# together, and prints its seconds.
_WORKER = """
import os, sys, time
from bioinfo1_tpu_torch.kernels import build
d, nvcc, go = sys.argv[1:4]
build.BUILD_DIR = d
build.LIB_PATH = os.path.join(d, "lib.so")
build.NVCC_LOG = os.path.join(d, "nvcc.log")
build.BUILD_LOCK = os.path.join(d, "build.lock")
build._nvcc = lambda: nvcc
open(f"{go}.ready{os.getpid()}", "w").close()
while not os.path.exists(go):
    time.sleep(0.01)
print(build.ensure_built())
"""


def test_three_processes_compile_once(tmp_path):
    d = tmp_path / "torch_kernels"
    log = tmp_path / "nvcc_calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    go = tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(d), str(nvcc), str(go)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)]
    secs = []
    try:
        deadline = time.time() + 240
        while (len(list(tmp_path.glob("go.ready*"))) < 3
               and time.time() < deadline):
            time.sleep(0.02)
        go.write_text("")
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            secs.append(float(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    sources = [s for s in build._sources() if s.endswith(".cu")]
    calls = log.read_text().splitlines()
    # One set of compiles (one nvcc -c per source) and one link.
    assert sum(" -c " in c for c in calls) == len(sources) == 5
    assert sum(c.startswith("-shared") for c in calls) == 1
    assert len(calls) == len(sources) + 1
    assert sum(s > 0 for s in secs) == 1 and secs.count(0.0) == 2
    assert (d / "lib.so").read_text() == "stub"
    assert (d / "lib.so.sha256").read_text() == build.source_hash()
    assert sorted(os.listdir(d)) == ["build.lock", "lib.so", "lib.so.sha256",
                                     "nvcc.log"]
