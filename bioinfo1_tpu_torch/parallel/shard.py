"""Data parallelism over the local devices: one process, the index
replicated on every device (the one-process part of
bioinfo1_tpu/parallel/shard.py: ``make_mesh``, ``auto_mesh``,
``replicate_index``).

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

A device may repeat in the list: the CPU tests deal over ``[cpu] * N``,
and on one card ``[cuda:0, cuda:0]`` runs two streams against one index
copy.  ``local_devices`` (the CLI's ``--devices``) never repeats one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, List, Sequence

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
