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
An upload of the tables records its ``_UPLOAD_SPAN`` phase span
(``db_upload``, ``dfa_upload``) under the active span.

Every live table is in a weak registry that ``resident_snapshot``
walks: one row per (table, placement) with the bytes staged for it. A
placement is the reference's bounded label: ``default`` for a table
asked for on one device (the unsharded paths, whose 1 × 1
``local_mesh`` counts as one device), ``mesh`` for a table asked for on
a ``DeviceMesh``. The reference's third label, ``device`` (a single
``jax.Device`` placement), has no caller in either package. A card's
copy serves both labels when both ask for it; it is uploaded once.

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
import logging
import threading
import weakref

import numpy as np
import torch

log = logging.getLogger("trivy_tpu_torch.ops.resident")

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


# every live ResidentTables instance, for resident_snapshot — weak refs
# so a dropped table (hot swap, test teardown) leaves no ghost row
_RESIDENT_REGISTRY: "weakref.WeakSet" = weakref.WeakSet()
_RESIDENT_REG_LOCK = threading.Lock()


def _placement_label(placement) -> str:
    """The bounded label of a ``device_tables`` argument: "mesh" for a
    ``DeviceMesh`` other than a 1 × 1 ``local_mesh``, else "default" —
    never the repr of a device (ref ``db/compiled.py``)."""
    if hasattr(placement, "distinct") and \
            not getattr(placement, "local", False):
        return "mesh"
    return "default"


def _key_device(key) -> str:
    return key if isinstance(key, str) else key[0]


def resident_snapshot() -> list:
    """[{table, placement, bytes, generation}] across every live
    resident table (ref ``db/compiled.py::resident_snapshot``): the
    bytes currently staged on the devices each placement reached.
    ``invalidate_device`` drops a table's rows."""
    with _RESIDENT_REG_LOCK:
        tables = list(_RESIDENT_REGISTRY)
    out = []
    for t in tables:
        with t._device_lock:
            rows = [(label, sum(nbytes for key, nbytes
                                in t._device_bytes.items()
                                if _key_device(key) in devices))
                    for label, devices in t._placements.items()]
            gen = t.generation
        for label, nbytes in rows:
            out.append({"table": t._TABLE, "placement": label,
                        "bytes": int(nbytes), "generation": gen})
    out.sort(key=lambda r: (r["table"], r["placement"],
                            r["generation"]))
    return out


def prewarm_resident(device="cuda") -> list:
    """Stage every live resident table on ``device`` now (ref
    ``db/compiled.py::prewarm_resident``); a table whose upload fails
    is skipped — the first dispatch stages it as before. Returns
    ``[{table, generation, staged}]``."""
    with _RESIDENT_REG_LOCK:
        tables = list(_RESIDENT_REGISTRY)
    out = []
    for t in sorted(tables, key=lambda x: x._TABLE):
        row = {"table": t._TABLE, "generation": t.generation,
               "staged": True}
        try:
            t.device_tables(device)
        except (RuntimeError, OSError, ValueError) as e:
            log.warning("prewarm staging skipped %s: %r", t._TABLE, e)
            row["staged"] = False
        out.append(row)
    return out


class ResidentTables:
    _UPLOAD_SPAN = "db_upload"
    _TABLE = "advisory_db"      # resident_snapshot's table label

    def _init_resident(self) -> None:
        self.generation = _next_generation()
        self._device: dict = {}
        # device key (or (device key, name)) -> bytes staged there
        self._device_bytes: dict = {}
        # placement label -> device keys that placement reached
        self._placements: dict = {}
        self._device_lock = threading.Lock()
        self._device_stats = {"uploads": 0, "upload_bytes": 0,
                              "dispatches": 0, "invalidations": 0}
        with _RESIDENT_REG_LOCK:
            _RESIDENT_REGISTRY.add(self)

    def _resident_arrays(self) -> tuple:
        raise NotImplementedError

    def _span_attrs(self) -> dict:
        return {}

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
                keys = [_key(device)]
                placed = self._placed(keys[0])
            else:
                by_dev = {d: self._placed(_key(d)) for d in mesh.distinct}
                placed = [by_dev[d] for d in mesh.flat]
                keys = [_key(d) for d in mesh.distinct]
            self._placements.setdefault(_placement_label(device),
                                        set()).update(keys)
            self._device_stats["dispatches"] += 1
        self._note_dispatch()
        return placed

    def _placed(self, key: str) -> tuple:
        """The tensors on device ``key``, uploaded on first use (the
        caller holds the lock)."""
        placed = self._device.get(key)
        if placed is None:
            from ..obs.trace import phase_span
            arrs = self._resident_arrays()
            nbytes = int(sum(a.nbytes for a in arrs))
            with phase_span(self._UPLOAD_SPAN, bytes=nbytes,
                            generation=self.generation,
                            **self._span_attrs()):
                placed = tuple(_tensor(a, key) for a in arrs)
                _settled(key)
            self._device[key] = placed
            self._device_bytes[key] = nbytes
            self._device_stats["uploads"] += 1
            self._device_stats["upload_bytes"] += nbytes
            self._note_upload(nbytes)
        return placed

    def device_array(self, device, name, make) -> torch.Tensor:
        """``make()`` (a numpy array) on ``device``, uploaded once per
        (device, ``name``) and counted with the other uploads in
        ``device_stats()`` (not in the ``_note_upload`` hook, which
        counts uploads of the tables themselves)."""
        key = (_key(device), name)
        with self._device_lock:
            placed = self._device.get(key)
            if placed is None:
                arr = np.ascontiguousarray(make())
                placed = _tensor(arr, key[0])
                _settled(key[0])
                self._device[key] = placed
                self._device_bytes[key] = int(arr.nbytes)
                self._device_stats["uploads"] += 1
                self._device_stats["upload_bytes"] += int(arr.nbytes)
        return placed

    def invalidate_device(self) -> None:
        """Drop every device copy (the next dispatch re-uploads)."""
        with self._device_lock:
            if not self._device:
                return
            self._device.clear()
            self._device_bytes.clear()
            self._placements.clear()
            self._device_stats["invalidations"] += 1
        self._note_invalidation()

    def device_stats(self) -> dict:
        """Upload and dispatch counts, the bytes staged now
        (``staged_bytes``, on every device) and the generation."""
        with self._device_lock:
            out = dict(self._device_stats)
            out["staged_bytes"] = int(sum(self._device_bytes.values()))
        out["generation"] = self.generation
        return out
