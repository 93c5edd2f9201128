"""The port's build of the native host library (bioinfo1_tpu_torch/native.py)
never writes the library's final path in place: the build script runs on a
private tree beside it, with a stand-in compiler here that logs its output
path, and the result is renamed into place.  A loader in another process
(the JAX package's takes no lock and gives up after one failed load) then
meets no library or a whole one."""

import os
import stat

from bioinfo1_tpu_torch import native

_FAKE_GXX = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = -o ]; then out="$2"; fi
  shift
done
echo "$out" >> "{log}"
printf whole > "$out"
"""


def _fake_build(tmp_path, monkeypatch):
    """The library's path under tmp_path, a stand-in g++ first on PATH, and
    the loader, the renames and the compiler's output paths recorded."""
    lib = tmp_path / "build" / "libbioinfo1_native.so"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "gxx.log"
    gxx = bindir / "g++"
    gxx.write_text(_FAKE_GXX.format(log=log))
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    loaded, renamed = [], []
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: loaded.append(
        (path, open(path).read())) or "handle")
    real_replace = os.replace

    def replace(src, dst):
        renamed.append((str(src), str(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(native.os, "replace", replace)
    return lib, log, loaded, renamed


def test_build_renames_a_whole_library_into_place(tmp_path, monkeypatch):
    lib, log, loaded, renamed = _fake_build(tmp_path, monkeypatch)
    assert native._build_and_load() == "handle"
    outputs = log.read_text().split()
    assert len(outputs) == 1
    # The compiler wrote a private path beside the library, never the
    # library's own path; the one rename put its output there.
    assert outputs[0] != str(lib)
    assert os.path.dirname(os.path.dirname(outputs[0])).startswith(
        str(lib.parent) + os.sep)
    assert renamed == [(outputs[0], str(lib))]
    assert loaded == [(str(lib), "whole")]
    assert sorted(os.listdir(lib.parent)) == [lib.name, lib.name + ".lock"]


def test_existing_library_is_not_rebuilt(tmp_path, monkeypatch):
    lib, log, loaded, renamed = _fake_build(tmp_path, monkeypatch)
    lib.parent.mkdir()
    lib.write_text("present")
    assert native._build_and_load() == "handle"
    assert not log.exists() and renamed == []
    assert loaded == [(str(lib), "present")]
