"""Multi-process runs of the port (bioinfo1_tpu_torch/parallel/shard.py,
the CLI's multi-process branches) on the CPU, under the JAX package's
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID contract.

* Two port CLI processes, score-only to stdout: process 0 prints the
  one-process PAF, which is the JAX CLI's; process 1 prints nothing.
* Four processes, ``-c -o``: the merged file is the one-process file (and
  the JAX CLI's); every ``.part<p>`` / ``.progress.p<p>`` exists and the
  parts concatenate to the merged file.
* Two processes under ``BIOINFO1_MERGE=allgather`` (gloo): the same bytes,
  and the JAX package's notice on stderr.
* Peer death: process 1, run through this file's own worker entry (its
  ``Mapper.map_records_iter`` blocks after its first yield, heartbeats
  going on), is SIGKILLed once its progress file shows a read; process 0
  must exit non-zero within BIOINFO1_HB_GRACE + 10 s naming ``process 1``
  and ``--resume``; all processes rerun with ``--resume`` print the
  one-process PAF.
* The environment contract, the read slices and the merge endpoint held to
  the JAX package's; its merge wire protocol held in one process, a port
  session against a JAX one each way round.

Every subprocess runs with BIOINFO1_PLATFORM=cpu, BIOINFO1_BAND_CACHE=0,
OMP_NUM_THREADS=2 and a bounded ``communicate``.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HB_GRACE = 5
ARGS = ["-k", "9", "-w", "3"]
TIMEOUT = 180


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


MP_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
           "BIOINFO1_MERGE", "BIOINFO1_MERGE_HOST", "BIOINFO1_MERGE_PORT")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in MP_VARS}
    env.update(BIOINFO1_PLATFORM="cpu", BIOINFO1_BAND_CACHE="0",
               OMP_NUM_THREADS="2", **extra)
    return env


def _launch(n: int, args, extra_env=None, held=()):
    """n port CLI processes under one coordinator address and a merge port
    of their own; the processes in ``held`` run this file's worker entry
    (``_held_main``) instead of the CLI module."""
    coord, merge = _free_port(), _free_port()
    procs = []
    for p in range(n):
        env = _env(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(p),
                   BIOINFO1_MERGE_PORT=str(merge), **(extra_env or {}))
        entry = ([os.path.abspath(__file__)] if p in held
                 else ["-m", "bioinfo1_tpu_torch.cli"])
        procs.append(subprocess.Popen(
            [sys.executable, *entry, *args], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _finish(procs):
    """(rc, stdout, stderr) of each process; kills them all on a timeout."""
    try:
        res = []
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            res.append((p.returncode, out, err))
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def mp_inputs(tmp_path_factory):
    """A 2.6 kb random genome, 20 ONT-profile reads of 150-1,200 bp, and
    for the peer-death test 40 of ~450 bp (one length bucket: a process of
    20 maps batches of 8, 8 and 4)."""
    from bioinfo1_tpu_torch.utils import simulate
    d = tmp_path_factory.mktemp("torch_mp")
    rng = np.random.default_rng(20261017)
    genome = simulate.random_genome(2600, rng)
    lengths = [int(x) for x in rng.integers(150, 1201, 20)]
    recs = simulate.simulate_reads(genome, lengths, rng)
    ref = d / "ref.fa"
    ref.write_text(f">chr\n{genome.tobytes().decode('latin1')}\n")
    kill = simulate.simulate_reads(
        genome, [int(x) for x in rng.integers(430, 471, 40)], rng)
    for name, rs in (("reads.fq", recs), ("reads_kill.fq", kill)):
        with open(d / name, "w") as fh:
            for r, s in rs:
                fh.write(f"@{r}\n{s}\n+\n{'I' * len(s)}\n")
    return d, str(ref), str(d / "reads.fq")


def _run(main, args):
    out, err = io.StringIO(), io.StringIO()
    rc = main(args, stdout=out, stderr=err)
    assert rc == 0, err.getvalue()
    return out.getvalue()


@pytest.fixture(scope="module")
def _cpu_env():
    """In-process runs: on the CPU, fresh bands, one process."""
    with pytest.MonkeyPatch.context() as mp:
        for k in MP_VARS:
            mp.delenv(k, raising=False)
        mp.setenv("BIOINFO1_PLATFORM", "cpu")
        mp.setenv("BIOINFO1_BAND_CACHE", "0")
        yield


@pytest.fixture(scope="module")
def single(mp_inputs, _cpu_env):
    """The port's one-process stdout on the default flags."""
    from bioinfo1_tpu_torch import cli as tcli
    _, ref, reads = mp_inputs
    return _run(tcli.main, ARGS + [ref, reads])


def test_two_processes_stdout_match_one_and_jax(mp_inputs, single):
    from bioinfo1_tpu import cli as jcli
    _, ref, reads = mp_inputs
    assert single == _run(jcli.main, ARGS + [ref, reads])
    assert single.count("\n") >= 15
    (rc0, out0, err0), (rc1, out1, err1) = _finish(
        _launch(2, ARGS + [ref, reads]))
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out0 == single
    assert out1 == ""


def test_four_processes_cigar_file_match_one_and_jax(mp_inputs, _cpu_env):
    from bioinfo1_tpu import cli as jcli
    from bioinfo1_tpu_torch import cli as tcli
    d, ref, reads = mp_inputs
    one, jax_out, multi = d / "one_c.paf", d / "jax_c.paf", d / "multi_c.paf"
    _run(tcli.main, ARGS + ["-c", "-o", str(one), ref, reads])
    _run(jcli.main, ARGS + ["-c", "-o", str(jax_out), ref, reads])
    assert one.read_text() == jax_out.read_text()
    assert one.read_text().count("cg:Z:") >= 15
    res = _finish(_launch(4, ARGS + ["-c", "-o", str(multi), ref, reads]))
    assert [r[0] for r in res] == [0] * 4, [r[2] for r in res]
    assert multi.read_text() == one.read_text()
    parts = ""
    for p in range(4):
        parts += (d / f"multi_c.paf.part{p}").read_text()
        prog = json.loads((d / f"multi_c.paf.progress.p{p}").read_text())
        assert prog["completed_reads"] == prog["total_reads"] == 5
    assert parts == one.read_text()


def test_allgather_merge_matches_one(mp_inputs, single):
    _, ref, reads = mp_inputs
    (rc0, out0, err0), (rc1, out1, err1) = _finish(_launch(
        2, ARGS + [ref, reads], {"BIOINFO1_MERGE": "allgather"}))
    assert (rc0, rc1) == (0, 0), err0 + err1
    assert out0 == single and out1 == ""
    notice = ("bioinfo1: no merge host derivable (set BIOINFO1_MERGE_HOST "
              "or JAX_COORDINATOR_ADDRESS); using allgather merge (no "
              "liveness)")
    assert notice in err0 and notice in err1


def test_peer_death_fails_fast_and_resumes(mp_inputs, _cpu_env):
    from bioinfo1_tpu_torch import cli as tcli
    d, ref, _ = mp_inputs
    reads = str(d / "reads_kill.fq")
    flags = ARGS + ["--batch-size", "2"]
    one, multi = d / "one_kill.paf", d / "multi_kill.paf"
    _run(tcli.main, flags + ["-o", str(one), ref, reads])
    # One batch in flight at a time (the in-flight bytes valve at 1), so
    # the first batch completes, and is checkpointed, when the second
    # flushes.
    hb = {"BIOINFO1_HB_INTERVAL": "1", "BIOINFO1_HB_GRACE": str(HB_GRACE),
          "BIOINFO1_INFLIGHT_BYTES": "1"}
    args = flags + ["-o", str(multi), ref, reads]
    procs = _launch(2, args, hb, held={1})
    victim = procs[1]
    prog = d / "multi_kill.paf.progress.p1"
    try:
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and victim.poll() is None:
            try:
                if json.loads(prog.read_text())["completed_reads"] >= 1:
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        assert victim.poll() is None, victim.communicate()
        done = json.loads(prog.read_text())
        assert 0 < done["completed_reads"] < done["total_reads"], done
        victim.send_signal(signal.SIGKILL)
        t_kill = time.time()
        _, err0 = procs[0].communicate(timeout=HB_GRACE + 10)
        detect_s = time.time() - t_kill
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert procs[0].returncode != 0
    assert detect_s < HB_GRACE + 10
    assert "process 1" in err0 and "--resume" in err0, err0
    res = _finish(_launch(2, args + ["--resume"], hb))
    assert [r[0] for r in res] == [0, 0], [r[2] for r in res]
    assert multi.read_text() == one.read_text()


@pytest.mark.parametrize("env,needle", [
    ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1"}, "JAX_NUM_PROCESSES"),
    ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2"},
     "JAX_PROCESS_ID"),
    ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_PROCESS_ID": "0"},
     "JAX_NUM_PROCESSES"),
    ({"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "2"}, "outside [0, JAX_NUM_PROCESSES=2)"),
    ({"JAX_COORDINATOR_ADDRESS": ":1", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "0"}, "names no host"),
])
def test_environment_refusals_exit_1(mp_inputs, _cpu_env, monkeypatch, env,
                                     needle):
    """A coordinator address without a count or an id, an id outside [0,
    n), or an address without a host (no rendezvous for the allgather
    merge): rc 1, one line, nothing mapped."""
    from bioinfo1_tpu_torch import cli as tcli
    _, ref, reads = mp_inputs
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out, err = io.StringIO(), io.StringIO()
    assert tcli.main(ARGS + [ref, reads], stdout=out, stderr=err) == 1
    assert out.getvalue() == ""
    assert needle in err.getvalue()
    assert len(err.getvalue().strip().splitlines()) == 1


# The JAX package's CLI with jax.distributed.initialize's wait for its
# peers cut from 300 s to 5; nothing else differs.
_JAX_CLI_SHORT_WAIT = (
    "import functools, sys, jax\n"
    "jax.distributed.initialize = functools.partial(\n"
    "    jax.distributed.initialize, initialization_timeout=5)\n"
    "from bioinfo1_tpu import cli\n"
    "sys.exit(cli.main(sys.argv[1:]))\n")


@pytest.mark.parametrize("host", ["", "127.0.0.1"], ids=["hostless", "host"])
def test_hostless_address_fails_in_both_packages(mp_inputs, single, host):
    """JAX_COORDINATOR_ADDRESS=:PORT, two processes, no BIOINFO1_MERGE_HOST
    (ROADMAP C9): the port refuses with rc 1 and one line, and two JAX CLI
    processes fail too, printing nothing: no process can register with the
    coordinator at a host-less address.  The same two JAX processes with
    127.0.0.1 in front of the port print the one-process PAF, so the
    failure is the address's."""
    from bioinfo1_tpu_torch import cli as tcli
    _, ref, reads = mp_inputs
    port, merge = _free_port(), _free_port()
    env = {"JAX_COORDINATOR_ADDRESS": f"{host}:{port}",
           "JAX_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_CLI_SHORT_WAIT, *ARGS, ref, reads],
        env=_env(JAX_PROCESS_ID=str(p), JAX_PLATFORMS="cpu",
                 BIOINFO1_MERGE_PORT=str(merge), **env),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(2)]
    (rc0, out0, err0), (rc1, out1, _) = _finish(procs)
    # Gloo's connection notices on stdout are library noise.
    out0, out1 = ("".join(line + "\n" for line in out.splitlines()
                          if not line.startswith("[Gloo]"))
                  for out in (out0, out1))
    if host:
        assert (rc0, rc1) == (0, 0), err0
        assert (out0, out1) == (single, "")
        return
    assert rc0 != 0 and rc1 != 0
    assert out0 == out1 == ""
    assert "RegisterTask" in err0, err0[-2000:]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setenv("JAX_PROCESS_ID", "0")
        out, err = io.StringIO(), io.StringIO()
        assert tcli.main(ARGS + [ref, reads], stdout=out, stderr=err) == 1
    assert out.getvalue() == ""
    assert "names no host" in err.getvalue()
    assert len(err.getvalue().strip().splitlines()) == 1


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "1"},
    {"JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_NUM_PROCESSES": "1",
     "JAX_PROCESS_ID": "0"},
    {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"},
])
def test_one_process_environments_map_as_one(mp_inputs, single,
                                             monkeypatch, env):
    """JAX_NUM_PROCESSES=1 is a one-process run, and the process variables
    without a coordinator address are ignored: the default run's PAF."""
    from bioinfo1_tpu_torch import cli as tcli
    from bioinfo1_tpu_torch.parallel import shard as ps
    _, ref, reads = mp_inputs
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert (ps.process_index(), ps.process_count()) == (0, 1)
    assert _run(tcli.main, ARGS + [ref, reads]) == single


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_read_slices_match_jax(monkeypatch, n):
    import jax

    from bioinfo1_tpu.parallel import shard as jshard
    from bioinfo1_tpu_torch.parallel import shard as ps
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", str(n))
    monkeypatch.setattr(jax, "process_count", lambda: n)
    for p in range(n):
        monkeypatch.setenv("JAX_PROCESS_ID", str(p))
        monkeypatch.setattr(jax, "process_index", lambda: p)
        for records in (0, 1, 5, 6, 20, 21, 1000):
            assert ps.process_read_slice(records) == \
                jshard.process_read_slice(records)
    slices = []
    for p in range(n):
        monkeypatch.setenv("JAX_PROCESS_ID", str(p))
        slices.append(ps.process_read_slice(21))
    assert [lo for lo, _ in slices][0] == 0 and slices[-1][1] == 21
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.5:8476"},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.5"},
    {"JAX_COORDINATOR_ADDRESS": ":8476"},
    {"JAX_COORDINATOR_ADDRESS": ":8476", "BIOINFO1_MERGE_HOST": "h1"},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.5:8476",
     "BIOINFO1_MERGE_PORT": "5000"},
])
def test_merge_endpoint_matches_jax(monkeypatch, env):
    from bioinfo1_tpu.parallel import shard as jshard
    from bioinfo1_tpu_torch.parallel import shard as ps
    for k in ("BIOINFO1_MERGE_HOST", "BIOINFO1_MERGE_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ps._merge_endpoint() == jshard._merge_endpoint()


@pytest.mark.parametrize("port_is", [0, 1])
def test_merge_wire_matches_jax(monkeypatch, port_is):
    """A port MergeSession and a JAX one in one process, the port's as
    process ``port_is``: process 0's merged list is the concatenation."""
    import jax

    from bioinfo1_tpu.parallel import shard as jshard
    from bioinfo1_tpu_torch.parallel import shard as ps
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("BIOINFO1_MERGE_PORT", str(_free_port()))
    monkeypatch.setenv("BIOINFO1_HB_INTERVAL", "0.2")
    monkeypatch.delenv("BIOINFO1_MERGE", raising=False)
    monkeypatch.delenv("BIOINFO1_MERGE_HOST", raising=False)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1 - port_is)
    lines = [["r0\t100\t0", "r1\t200\t1"], ["r2\t300\t2"]]
    if port_is == 0:
        receiver = ps.MergeSession(part_hint="x.paf", p=0, n=2)
        sender = jshard.MergeSession(part_hint="x.paf")
    else:
        receiver = jshard.MergeSession(part_hint="x.paf")
        sender = ps.MergeSession(part_hint="x.paf", p=1, n=2)
    assert (receiver.mode, sender.mode) == ("p2p", "p2p")
    sent = []
    t = threading.Thread(target=lambda: sent.append(sender.gather(lines[1])))
    t.start()
    time.sleep(0.5)                    # a few heartbeats first
    merged = receiver.gather(lines[0])
    t.join(timeout=30)
    assert not t.is_alive()
    assert sent == [None]
    assert merged == lines[0] + lines[1]
    receiver.check()


@pytest.mark.parametrize("port_is", [0, 1])
def test_p2p_blobs_wire_matches_jax(monkeypatch, port_is):
    """The plain point-to-point gather (``_p2p_gather_blobs``, behind
    ``gather_lines_to_process0``): a port process and a JAX one in one
    process, the port's as process ``port_is``; process 0 gets both blobs
    in process order, and the lines split back as the merge does."""
    import jax

    from bioinfo1_tpu.parallel import shard as jshard
    from bioinfo1_tpu_torch.parallel import shard as ps
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("BIOINFO1_MERGE_PORT", str(_free_port()))
    monkeypatch.delenv("BIOINFO1_MERGE_HOST", raising=False)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1 - port_is)
    blobs = [b"r0\t100\nr1\t200", "r2\t\u00e9".encode()]
    if port_is == 0:
        receive = lambda: ps._p2p_gather_blobs(blobs[0], 30, p=0, n=2)
        send = lambda: jshard._p2p_gather_blobs(blobs[1], 30)
    else:
        receive = lambda: jshard._p2p_gather_blobs(blobs[0], 30)
        send = lambda: ps._p2p_gather_blobs(blobs[1], 30, p=1, n=2)
    sent = []
    t = threading.Thread(target=lambda: sent.append(send()))
    t.start()
    got = receive()
    t.join(timeout=30)
    assert not t.is_alive() and sent == [None]
    assert got == blobs
    assert ps._split_blobs(got) == ["r0\t100", "r1\t200", "r2\t\u00e9"]


def test_fail_message_matches_jax(monkeypatch):
    import jax

    from bioinfo1_tpu.parallel import shard as jshard
    from bioinfo1_tpu_torch.parallel import shard as ps
    monkeypatch.setenv("BIOINFO1_MERGE", "allgather")
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    for hint in ("out.paf", ""):
        mine = ps.MergeSession(part_hint=hint, p=0, n=2)
        theirs = jshard.MergeSession(part_hint=hint)
        assert mine.mode == theirs.mode == "allgather"
        why = "RuntimeError('merge connection closed early')"
        assert mine._fail_msg(3, why) == theirs._fail_msg(3, why)


_WORKER = """
import runpy, sys
sys.argv = ["chip_smoke.py", "--process-worker", *sys.argv[1:]]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "bioinfo1_tpu" or m.startswith("bioinfo1_tpu."))
assert not bad, bad
print("ok")
"""


def test_smoke_process_worker_imports_no_jax(mp_inputs, single, tmp_path):
    """chip_smoke.py --process-worker (phase 2p's processes) maps, here as
    one process on the CPU, writes its record, and imports neither jax nor
    the JAX package."""
    _, ref, reads = mp_inputs
    rec = tmp_path / "worker.json"
    env = _env(JAX_PROCESS_ID="0")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _WORKER, str(rec), "--", *ARGS, ref, reads],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == single + "ok\n"
    row = json.loads(rec.read_text())
    assert row["rc"] == 0 and row["pid"] == 0
    assert row["mapper"]["faults"] == 0
    assert row["throughput"]["reads"] == 20
    assert set(row["launches"].values()) == {0}


def _held_main() -> int:
    """Worker entry of the peer-death test: the port's CLI, with
    ``Mapper.map_records_iter`` held after its first yield, so that the
    process has checkpointed a batch and is still alive (its heartbeat
    thread running) when the test kills it."""
    from bioinfo1_tpu_torch import cli
    from bioinfo1_tpu_torch.pipeline import mapper

    real = mapper.Mapper.map_records_iter

    def held(self, *args, **kwargs):
        it = real(self, *args, **kwargs)
        yield next(it)
        threading.Event().wait()

    mapper.Mapper.map_records_iter = held
    return cli.main(sys.argv[1:])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(_held_main())
