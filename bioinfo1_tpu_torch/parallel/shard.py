"""Data parallelism: over the local devices of one process, the index
replicated on every device or split by hash range over them (the
one-process part of bioinfo1_tpu/parallel/shard.py: ``make_mesh``,
``auto_mesh``, ``replicate_index``, ``shard_index``), and over several
processes (its multi-process part, under the same names: the process's
read slice, the point-to-point merge to process 0 with heartbeat
liveness, the allgather merge; see "Several processes" below).

The JAX package splits each padded batch over a 1-D mesh under
``shard_map``: one compiled program, so the split costs no host dispatch.
Here every fused step is a few hundred PyTorch ops dispatched from the host,
and that dispatch, not the device, bounds a 2-8 kb pass; a batch split into
N slices would dispatch them N times.  So the unit of the split is the
whole batch: a ``DeviceSet`` deals the mapper's batches to its entries in
turn, and each batch runs wholly on its entry's device against that
device's index copy, with one dispatch, as on one device.  Every read's
result depends on that read alone, so the output is the one-device run's
byte for byte.

With the index sharded (``shard_index``), entry d holds the lookup arrays
of one hash range; a batch still runs wholly on its entry's device, and
only its lookup goes out to the shards (ops/match.
find_matches_combined_sharded).

A device may repeat in the list: the CPU tests deal over ``[cpu] * N``,
and on one card ``[cuda:0, cuda:0]`` runs two streams against one index
copy.  ``local_devices`` (the CLI's ``--devices``) never repeats one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import struct
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from bioinfo1_tpu_torch.pipeline import device_map as dm


def pow2_prefix(n_available: int, max_devices: int = 0) -> int:
    """The largest power of two <= ``n_available``, capped at
    ``max_devices`` when that is above 0 (at least 1), as ``auto_mesh``
    sizes its mesh."""
    n = min(n_available, max_devices) if max_devices > 0 else n_available
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def local_devices(first: torch.device,
                  max_devices: int = 0) -> List[torch.device]:
    """The CUDA devices from ``first`` on, as many as ``pow2_prefix``
    allows (``auto_mesh``'s counterpart; ``first`` is cuda:0 unless the
    caller chose another card)."""
    n = torch.cuda.device_count() - first.index
    return [torch.device("cuda", first.index + i)
            for i in range(pow2_prefix(n, max_devices))]


class DeviceSet:
    """Ordered devices that batches are dealt to in turn (a device may
    repeat).  An entry whose CUDA device repeats in the list has a stream
    of its own, so that its batches overlap the other entries'; any other
    entry runs on its device's default stream, as one device does.
    ``batches[i]`` counts the batches dealt to entry ``i``."""

    def __init__(self, devices: Sequence[torch.device]) -> None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("DeviceSet: no devices")
        for d in devs:
            if d.type == "cuda" and d.index is None:
                raise ValueError(f"DeviceSet: {d} names no card")
        self.devices: List[torch.device] = devs
        self.streams = [torch.cuda.Stream(d)
                        if d.type == "cuda" and devs.count(d) > 1 else None
                        for d in devs]
        self.batches = [0] * len(devs)
        self._next = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def distinct(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    def current(self) -> torch.device:
        """The device of the batch this thread runs (see ``batch``), else
        the first device."""
        return getattr(self._local, "device", self.devices[0])

    @contextlib.contextmanager
    def batch(self) -> Iterator[torch.device]:
        """Deal the next entry to the batch this thread runs in the block:
        its device is ``current()`` on this thread and, on CUDA, the
        current device, with the entry's stream (if it has one) the current
        stream.  Yields the device."""
        with self._lock:
            i = self._next
            self._next = (i + 1) % len(self.devices)
            self.batches[i] += 1
        d = self.devices[i]
        self._local.device = d
        try:
            if d.type == "cuda":
                with torch.cuda.device(d), \
                        torch.cuda.stream(self.streams[i]):
                    yield d
            else:
                yield d
        finally:
            del self._local.device


def replicate_index(index: dm.DeviceIndex, devices: DeviceSet,
                    ) -> Dict[torch.device, dm.DeviceIndex]:
    """One copy of a packed device index per distinct device of the set
    (the given one serves its own device), every copy complete before any
    stream reads it."""
    out = {}
    for d in devices.distinct():
        if index.key_hash.device == d:
            out[d] = index
            continue
        out[d] = dataclasses.replace(index, **{
            f.name: getattr(index, f.name).to(d)
            for f in dataclasses.fields(index)
            if isinstance(getattr(index, f.name), torch.Tensor)})
    for d in out:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return out


def shard_index(index, devices: DeviceSet) -> Dict[torch.device,
                                                   dm.ShardedIndex]:
    """Pack the host index hash-range-sharded, one shard per entry of the
    set on that entry's device, with one lookup stream per card; returns
    the view of each distinct device (its ``ref_bytes``), every shard
    complete before any stream reads it (the counterpart of the JAX
    package's ``shard_index``)."""
    shards = dm.sharded_device_index_from_host(index, len(devices.devices),
                                               devices.devices)
    lookup = {d: torch.cuda.Stream(d) for d in devices.distinct()
              if d.type == "cuda"}
    streams = [lookup.get(d) for d in devices.devices]
    served = [torch.zeros((), dtype=torch.int64, device=d)
              for d in devices.devices]
    for d in lookup:
        torch.cuda.synchronize(d)
    return {d: dm.ShardedIndex(
        shards=shards, streams=streams, served=served,
        ref_bytes=shards[devices.devices.index(d)].ref_bytes)
        for d in devices.distinct()}


# ---- Several processes ----------------------------------------------------
#
# One process per host (or per card, with CUDA_VISIBLE_DEVICES), under the
# JAX package's variables: JAX_COORDINATOR_ADDRESS (host:port),
# JAX_NUM_PROCESSES and JAX_PROCESS_ID.  Each process maps its contiguous
# read slice on its own devices (the part above: no collective sits on the
# map path), and the PAF lines are merged to process 0 in process order,
# which is input order.  The merge itself has no JAX in it; only the
# allgather fallback needs a collective, which here is torch.distributed
# on gloo.


def _process_env() -> Tuple[int, int]:
    """(process index, process count) from the three variables.  A run is
    multi-process only when JAX_COORDINATOR_ADDRESS is set and
    JAX_NUM_PROCESSES > 1; without the address the other two are ignored.
    With the address, the count and the id must be integers (the id may be
    left out when the count is 1) and the id must lie in [0, count): there
    is no cluster metadata to find them in.  ValueError, one line,
    otherwise."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return 0, 1
    try:
        n = int(os.environ["JAX_NUM_PROCESSES"])
        p = int(os.environ.get("JAX_PROCESS_ID", "0" if n == 1 else ""))
    except (KeyError, ValueError):
        raise ValueError(
            f"JAX_COORDINATOR_ADDRESS={addr} needs JAX_NUM_PROCESSES and "
            "JAX_PROCESS_ID, both integers") from None
    if n < 1 or not 0 <= p < n:
        raise ValueError(f"JAX_PROCESS_ID={p} lies outside [0, "
                         f"JAX_NUM_PROCESSES={n})")
    return p, n


def process_index() -> int:
    """This process's index (``jax.process_index``'s counterpart)."""
    return _process_env()[0]


def process_count() -> int:
    """The number of processes (``jax.process_count``'s counterpart)."""
    return _process_env()[1]


def distributed_initialize_if_needed() -> None:
    """Check the multi-process variables; ValueError with a one-line
    message when they are inconsistent (``_process_env``), or when the
    merge would need a rendezvous at a coordinator address without a host.

    The JAX package's call is ``jax.distributed.initialize``, a rendezvous:
    every process blocks there until all have reached the coordinator.
    This one is not: it reads the variables and returns, and no collective
    runs at start-up.  The processes find each other through the merge
    channel (``MergeSession``), whose senders retry their connection to
    process 0 for up to max(4 x BIOINFO1_HB_GRACE, 120 s), and process 0
    fails the run if a peer has not registered by then."""
    _, n = _process_env()
    if n > 1 and _merge_mode(n) == "allgather":
        _allgather_init_method()


def process_read_slice(n_records: int) -> tuple:
    """[lo, hi) contiguous slice of the global record list owned by this
    process (per-host read sharding).  Contiguous blocks keep the merged
    output in global input order."""
    p, n = process_index(), process_count()
    per = -(-n_records // n)          # ceil
    lo = min(p * per, n_records)
    return lo, min(lo + per, n_records)


def _merge_endpoint():
    """(host, port) of the process-0 merge socket, derived from the
    coordinator address (which lives on process 0 by convention), or
    BIOINFO1_MERGE_HOST; the port from BIOINFO1_MERGE_PORT, else the
    coordinator's port + 17 (9400 + 17 without one).  host is None when it
    cannot be derived: senders would otherwise connect to themselves and
    hang out the merge timeout; the allgather merge is then the only
    one."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    host, _, port = addr.partition(":")
    host = os.environ.get("BIOINFO1_MERGE_HOST", host) or None
    mport = os.environ.get("BIOINFO1_MERGE_PORT")
    if mport:
        return host, int(mport)
    return host, (int(port) if port else 9400) + 17


def _merge_mode(n: int) -> str:
    """"single", "allgather" (BIOINFO1_MERGE=allgather, or no merge host)
    or "p2p"."""
    if n == 1:
        return "single"
    if (os.environ.get("BIOINFO1_MERGE") == "allgather"
            or _merge_endpoint()[0] is None):
        return "allgather"
    return "p2p"


def _allgather_init_method() -> str:
    """``tcp://<coordinator address>``, the gloo group's rendezvous.  An
    address without a host is refused (ValueError, one line): the JAX
    package's processes cannot meet there either, since none can register
    with a coordinator at ``:PORT`` (jax.distributed.initialize fails)."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    if not addr.partition(":")[0]:
        raise ValueError(
            f"JAX_COORDINATOR_ADDRESS={addr!r} names no host: the allgather "
            "merge cannot rendezvous (set host:port, or BIOINFO1_MERGE_HOST "
            "for the point-to-point merge)")
    return f"tcp://{addr}"


def _p2p_gather_blobs(blob: bytes, timeout_s: float = 0.0,
                      p: Optional[int] = None, n: Optional[int] = None):
    """Point-to-point gather of one byte blob per process to process 0.

    Each non-zero process opens one TCP connection to process 0 and
    streams its blob (a ``<iq`` header: process index, size); total traffic
    is the sum of the blob sizes, received only where the output is
    written.  Returns [blob_p0, ..., blob_{P-1}] on process 0, None
    elsewhere."""
    p = process_index() if p is None else p
    n = process_count() if n is None else n
    host, port = _merge_endpoint()
    if not timeout_s:
        # Processes reach the merge whenever their own map stage ends; the
        # skew between them depends on the workload, so the window must
        # reach far past any expected skew.
        timeout_s = float(os.environ.get("BIOINFO1_MERGE_TIMEOUT", 21600))
    if p == 0:
        blobs = {0: blob}
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        srv.listen(n)
        srv.settimeout(timeout_s)
        try:
            for _ in range(n - 1):
                conn, _a = srv.accept()
                conn.settimeout(timeout_s)
                with conn:
                    hdr = _recv_exact(conn, 12)
                    pid, size = struct.unpack("<iq", hdr)
                    blobs[pid] = _recv_exact(conn, size)
        finally:
            srv.close()
        return [blobs[i] for i in range(n)]
    # Sender: connect with retry (process 0 may not be listening yet).
    deadline = time.time() + timeout_s
    last_err = None
    while time.time() < deadline:
        try:
            with socket.create_connection((host, port), timeout=10) as s:
                s.settimeout(timeout_s)
                s.sendall(struct.pack("<iq", p, len(blob)))
                s.sendall(blob)
            return None
        except OSError as e:
            last_err = e
            time.sleep(0.2)
    raise RuntimeError(f"merge send to process 0 failed: {last_err}")


def _recv_exact(conn, size: int) -> bytes:
    chunks = []
    got = 0
    while got < size:
        b = conn.recv(min(1 << 22, size - got))
        if not b:
            raise RuntimeError("merge connection closed early")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def _split_blobs(blobs) -> List[str]:
    """The lines of the blobs, in process order."""
    merged: List[str] = []
    for b in blobs:
        text = b.decode("utf-8")
        if text:
            merged.extend(text.split("\n"))
    return merged


class MergeSession:
    """Liveness-aware merge channel, the JAX package's own protocol.

    Created on every process before the map stage: non-zero processes open
    one TCP connection to process 0 at once (HELLO ``R`` + ``<i`` process
    index) and send a HEARTBEAT ``H`` every BIOINFO1_HB_INTERVAL (default
    5 s) from a daemon thread; the PAF blob rides the same connection at
    merge time (DATA ``D`` + ``<q`` size + bytes, answered by ACK ``A``).
    Process 0 watches the connections while it maps: a connection that
    closes early, goes silent past BIOINFO1_HB_GRACE (default 30 s), or
    never registers (within max(4 x grace, 120 s)) fails the run in seconds
    with a message naming the dead process and the resumable part files.
    BIOINFO1_MERGE_TIMEOUT (default 21,600 s) bounds the merge;
    BIOINFO1_DEBUG_MERGE traces the channel on stderr.

    ``p`` and ``n`` (default: this process's index and the count) let a
    test run two sessions in one process.  A one-process run is a no-op;
    without a derivable merge host, or under BIOINFO1_MERGE=allgather, the
    session merges by allgather (no liveness)."""

    HELLO, HEARTBEAT, DATA, ACK = b"R", b"H", b"D", b"A"

    def __init__(self, part_hint: str = "", p: Optional[int] = None,
                 n: Optional[int] = None):
        self.p = process_index() if p is None else p
        self.n = process_count() if n is None else n
        self.part_hint = part_hint
        self.mode = _merge_mode(self.n)
        if self.mode != "p2p":
            return
        self.hb_interval = float(os.environ.get("BIOINFO1_HB_INTERVAL", 5))
        self.hb_grace = float(os.environ.get("BIOINFO1_HB_GRACE", 30))
        self.timeout = float(os.environ.get("BIOINFO1_MERGE_TIMEOUT", 21600))
        self.start_time = time.time()
        self._lock = threading.Lock()
        self.blobs: dict = {}
        self.dead: dict = {}
        self.registered: set = set()
        self._send_done = threading.Event()
        self._send_err: list = []
        self._blob_ready = threading.Event()
        self._blob = b""
        self._debug(f"session created p={self.p}/{self.n}")
        if self.p == 0:
            _host, port = _merge_endpoint()
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("0.0.0.0", port))
            srv.listen(self.n)
            srv.settimeout(1.0)
            self._srv = srv
            self._closing = False
            target = self._accept_loop
        else:
            target = self._sender_loop
        threading.Thread(target=target, daemon=True).start()

    # ---- process 0 ----
    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _a = self._srv.accept()
            except OSError:
                continue
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn):
        pid = -1
        try:
            conn.settimeout(self.hb_grace)
            hdr = _recv_exact(conn, 5)
            if hdr[:1] != self.HELLO:
                raise RuntimeError("bad hello frame")
            pid = struct.unpack("<i", hdr[1:])[0]
            with self._lock:
                self.registered.add(pid)
            while True:
                t = _recv_exact(conn, 1)
                if t == self.HEARTBEAT:
                    continue                      # settimeout re-arms
                if t == self.DATA:
                    size = struct.unpack("<q", _recv_exact(conn, 8))[0]
                    blob = _recv_exact(conn, size)
                    with self._lock:
                        self.blobs[pid] = blob
                    conn.sendall(self.ACK)
                    return
                raise RuntimeError(f"bad frame type {t!r}")
        except Exception as e:
            # A reader thread's boundary: whatever ended the connection
            # marks its process dead, for check() / gather() to report.
            with self._lock:
                if pid not in self.blobs:
                    self.dead[pid] = repr(e)
            self._debug(f"reader for process {pid} ended: {e!r}")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _debug(msg):
        if os.environ.get("BIOINFO1_DEBUG_MERGE"):
            print(f"bioinfo1-merge[{time.time():.1f}]: {msg}",
                  file=sys.stderr, flush=True)

    # ---- non-zero processes ----
    def _sender_loop(self):
        host, port = _merge_endpoint()
        deadline = time.time() + max(self.hb_grace * 4, 120)
        sock = None
        try:
            last = None
            while time.time() < deadline and sock is None:
                try:
                    sock = socket.create_connection((host, port), timeout=10)
                except OSError as e:
                    last = e
                    time.sleep(0.2)
            if sock is None:
                raise RuntimeError(f"cannot reach merge host: {last}")
            sock.settimeout(self.timeout)
            sock.sendall(self.HELLO + struct.pack("<i", self.p))
            while not self._blob_ready.wait(self.hb_interval):
                sock.sendall(self.HEARTBEAT)
            blob = self._blob
            sock.sendall(self.DATA + struct.pack("<q", len(blob)))
            sock.sendall(blob)
            if _recv_exact(sock, 1) != self.ACK:
                raise RuntimeError("merge ack missing")
        except Exception as e:
            # The sender thread's boundary: check() / gather() raise it.
            self._send_err.append(
                f"merge to process 0 failed (process 0 dead or "
                f"unreachable): {e}")
        finally:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            self._send_done.set()

    def _fail_msg(self, pid, why):
        hint = (f"; completed work is checkpointed in "
                f"{self.part_hint}.part<p>/.progress.p<p> - rerun all "
                f"processes with --resume" if self.part_hint else
                "; rerun to retry")
        return (f"bioinfo1: peer process {pid} failed during the run "
                f"({why}){hint}")

    def check(self):
        """Raise RuntimeError now if a peer is already known dead.

        Called from the map loop, so that a run aborts (resumably) within
        seconds of a peer failure instead of only at merge time."""
        if self.mode != "p2p":
            return
        if self.p == 0:
            with self._lock:
                for pid, why in self.dead.items():
                    raise RuntimeError(self._fail_msg(pid, why))
        elif self._send_err:
            raise RuntimeError(self._send_err[0])

    def gather(self, lines):
        """Merge this process's lines; the list on process 0, None
        elsewhere.  Raises RuntimeError promptly when a peer (or process 0)
        is dead."""
        if self.mode == "single":
            return list(lines)
        if self.mode == "allgather":
            print("bioinfo1: no merge host derivable "
                  "(set BIOINFO1_MERGE_HOST or JAX_COORDINATOR_ADDRESS); "
                  "using allgather merge (no liveness)", file=sys.stderr)
            return _gather_lines_allgather(lines, self.p, self.n)
        self._debug("gather entered")
        blob = ("\n".join(lines)).encode("utf-8")
        if self.p != 0:
            self._blob = blob
            self._blob_ready.set()
            if not self._send_done.wait(self.timeout):
                raise RuntimeError("merge send timed out")
            if self._send_err:
                raise RuntimeError(self._send_err[0])
            return None
        self.blobs[0] = blob
        deadline = time.time() + self.timeout
        reg_deadline = self.start_time + max(self.hb_grace * 4, 120)
        while True:
            with self._lock:
                if len(self.blobs) == self.n:
                    break
                for pid, why in self.dead.items():
                    raise RuntimeError(self._fail_msg(pid, why))
                if time.time() > reg_deadline:
                    missing = [q for q in range(1, self.n)
                               if q not in self.registered]
                    if missing:
                        raise RuntimeError(self._fail_msg(
                            missing[0], "never connected to the merge "
                            "liveness channel"))
            if time.time() > deadline:
                raise RuntimeError("merge timed out")
            time.sleep(0.05)
        self.close()
        return _split_blobs(self.blobs[i] for i in range(self.n))

    def close(self):
        if getattr(self, "_srv", None) is not None:
            self._closing = True
            try:
                self._srv.close()
            except OSError:
                pass
            self._srv = None


def gather_lines_to_process0(lines):
    """Deterministic merge of output lines to process 0.

    The replacement for the reference's nondeterministic ``omp critical``
    stdout interleaving (team_mapper.cpp:685): each process's PAF lines
    (its contiguous read slice, already in input order) are streamed point
    to point to process 0 and concatenated in process order, so the merged
    stream is the one-process output.  Returns the merged line list on
    process 0, None elsewhere.  One-process runs return the lines.
    BIOINFO1_MERGE=allgather takes the collective path (e.g. when the merge
    port is firewalled), as does a run without a merge host."""
    mode = _merge_mode(process_count())
    if mode == "single":
        return list(lines)
    if mode == "allgather":
        if os.environ.get("BIOINFO1_MERGE") != "allgather":
            print("bioinfo1: no merge host derivable "
                  "(set BIOINFO1_MERGE_HOST or JAX_COORDINATOR_ADDRESS); "
                  "using allgather merge", file=sys.stderr)
        return _gather_lines_allgather(lines)
    blobs = _p2p_gather_blobs(("\n".join(lines)).encode("utf-8"))
    return None if blobs is None else _split_blobs(blobs)


def _gather_lines_allgather(lines, p: Optional[int] = None,
                            n: Optional[int] = None):
    """Collective merge: a gloo group over the processes (rendezvous at
    ``_allgather_init_method``, set up here and destroyed after), the blob
    sizes gathered, then the blobs padded to the largest as uint8 (the
    JAX package's max-padded ``process_allgather``).  The merged lines on
    process 0, None elsewhere."""
    import datetime

    import torch.distributed as tdist
    p = process_index() if p is None else p
    n = process_count() if n is None else n
    blob = ("\n".join(lines)).encode("utf-8")
    timeout = float(os.environ.get("BIOINFO1_MERGE_TIMEOUT", 21600))
    tdist.init_process_group(
        "gloo", init_method=_allgather_init_method(), world_size=n, rank=p,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
        tdist.all_gather(sizes, torch.tensor([len(blob)], dtype=torch.int64))
        cap = max(int(s) for s in sizes)
        padded = torch.zeros(max(cap, 1), dtype=torch.uint8)
        if blob:
            padded[:len(blob)] = torch.frombuffer(bytearray(blob),
                                                  dtype=torch.uint8)
        blobs = [torch.empty_like(padded) for _ in range(n)]
        tdist.all_gather(blobs, padded)
    finally:
        tdist.destroy_process_group()
    if p != 0:
        return None
    return _split_blobs(b[:int(s)].numpy().tobytes()
                        for b, s in zip(blobs, sizes))
