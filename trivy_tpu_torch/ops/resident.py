"""Device residency for tables that serve many dispatches.

``device_tables(device)`` uploads ``_resident_arrays()`` once per
device (a card by its index: ``cuda`` is ``cuda:0`` when that is the
current card) and hands back the same tensors on every later call;
given a ``parallel.mesh.DeviceMesh`` it places them once per DISTINCT
device of the mesh and hands back one tuple per flat shard (a mesh
that names ``cuda:0`` four times uploads once);
``device_array(device, name, make)`` does the same for one more array
a launch picks by ``name``; ``invalidate_device()`` drops them all. A
table's content is fixed once it is built or loaded, so one upload per
device is one upload per (table, device). ``device_stats()`` counts
uploads and dispatches; a subclass mirrors them into its own metrics
through the ``_note_*`` hooks. Every table gets a process-monotonic
``generation`` that tells "the same tables again" from a newer build.

Resident tensors are never written: per-dispatch payloads are fresh
tensors, and an array that numpy hands back read-only (``np.load``) is
copied once on its way to the device.

An upload runs on the stream that is current on the thread that first
asks for the tables, and the host waits for it before the tables are
handed out (``_settled``): a caller that reads them on another stream
(the interval waves' side streams, ``detect/batch.py``, or the sieve
on a host-pool thread) never sees a half-copied table.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import torch

_GENERATIONS = itertools.count(1)
_GENERATION_LOCK = threading.Lock()


def _next_generation() -> int:
    with _GENERATION_LOCK:
        return next(_GENERATIONS)


def _settled(device: str) -> None:
    """Wait on the host until the upload just enqueued on ``device``'s
    current stream has completed (a no-op off CUDA)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _key(device) -> str:
    """The name a device's copy is kept under: a card by its index, so
    ``cuda`` and ``cuda:0`` share one copy."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _tensor(a: np.ndarray, device: str) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


class ResidentTables:
    def _init_resident(self) -> None:
        self.generation = _next_generation()
        self._device: dict = {}
        self._device_lock = threading.Lock()
        self._device_stats = {"uploads": 0, "upload_bytes": 0,
                              "dispatches": 0, "invalidations": 0}

    def _resident_arrays(self) -> tuple:
        raise NotImplementedError

    def _note_upload(self, nbytes: int) -> None:
        pass

    def _note_dispatch(self) -> None:
        pass

    def _note_invalidation(self) -> None:
        pass

    def device_tables(self, device):
        """The resident tensors on ``device`` (a tuple), or on every
        shard of a ``DeviceMesh`` (a list of tuples, one per flat
        shard). One call counts one dispatch."""
        mesh = device if hasattr(device, "distinct") else None
        with self._device_lock:
            if mesh is None:
                placed = self._placed(_key(device))
            else:
                by_dev = {d: self._placed(_key(d)) for d in mesh.distinct}
                placed = [by_dev[d] for d in mesh.flat]
            self._device_stats["dispatches"] += 1
        self._note_dispatch()
        return placed

    def _placed(self, key: str) -> tuple:
        """The tensors on device ``key``, uploaded on first use (the
        caller holds the lock)."""
        placed = self._device.get(key)
        if placed is None:
            arrs = self._resident_arrays()
            placed = tuple(_tensor(a, key) for a in arrs)
            _settled(key)
            nbytes = int(sum(a.nbytes for a in arrs))
            self._device[key] = placed
            self._device_stats["uploads"] += 1
            self._device_stats["upload_bytes"] += nbytes
            self._note_upload(nbytes)
        return placed

    def device_array(self, device, name, make) -> torch.Tensor:
        """``make()`` (a numpy array) on ``device``, uploaded once per
        (device, ``name``) and counted with the other uploads."""
        key = (_key(device), name)
        with self._device_lock:
            placed = self._device.get(key)
            if placed is None:
                arr = np.ascontiguousarray(make())
                placed = _tensor(arr, key[0])
                _settled(key[0])
                self._device[key] = placed
                self._device_stats["uploads"] += 1
                self._device_stats["upload_bytes"] += int(arr.nbytes)
                self._note_upload(int(arr.nbytes))
        return placed

    def invalidate_device(self) -> None:
        """Drop every device copy (the next dispatch re-uploads)."""
        with self._device_lock:
            if not self._device:
                return
            self._device.clear()
            self._device_stats["invalidations"] += 1
        self._note_invalidation()

    def device_stats(self) -> dict:
        with self._device_lock:
            out = dict(self._device_stats)
        out["generation"] = self.generation
        return out
