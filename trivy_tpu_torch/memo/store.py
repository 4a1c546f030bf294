"""Findings-memo persistence over the blob-cache tier (copied from
``trivy_tpu/memo/store.py``).

Backends mirror the blob cache's (memory, fs) but carry an opaque
raw-bytes contract — memo entries are checksummed JSON whose
deserialization lives in ``memo.findings``, never the blob-typed
``types.convert`` readers. The reference's Redis and S3 memo stores
ride its remote blob caches and come with them (ROADMAP A.9f): a
``redis://`` or ``s3://`` memo URI is refused by name, never taken as
a directory.

Every backend goes behind :class:`ResilientMemoStore`, which reuses
``artifact.resilient.CircuitBreaker``: a backend outage degrades a
lookup into a miss (recompute) and a store into a drop — there is no
path through the memo that turns an outage into an exception, and no
local mirror to fill (the recompute IS the fallback, so an outage
costs warm throughput, never correctness). The optional fault
injector hook (duck-typed: ``on_cache_op(op, key)``) makes a cache
outage drill hit the memo tier the same way it hits the blob cache.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ..artifact.resilient import CircuitBreaker
from ..obs.trace import add_event
from .metrics import MEMO_METRICS

log = logging.getLogger("trivy_tpu_torch.memo.store")

# memo URIs of the remote stores that come with the remote blob caches
REMOTE_SCHEMES = ("redis://", "s3://")


class MemoryMemoStore:
    """In-process store — the default for MemoryCache-backed runs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._d: dict = {}

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._d.get(key)

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._d[key] = bytes(data)

    def delete(self, key: str) -> None:
        with self._lock:
            self._d.pop(key, None)

    def keys(self) -> list:
        with self._lock:
            return sorted(self._d)

class FSMemoStore:
    """One file per entry under ``<cache-dir>/memo/`` — the fs-cache
    analog (atomic temp-file + rename writes)."""

    def __init__(self, cache_dir: str):
        self.dir = os.path.join(cache_dir, "memo")
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, key: str) -> str:
        # keys are hex digests (memo.keys.make_key) — path-safe by
        # construction; reject anything else rather than join it
        if not key.replace("-", "").isalnum():
            raise ValueError(f"bad memo key {key!r}")
        return os.path.join(self.dir, key + ".json")

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self) -> list:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(n[:-5] for n in names if n.endswith(".json"))


class ResilientMemoStore:
    """Circuit-broken memo backend: degraded-to-recompute, never
    down. Mirrors ``artifact.resilient.ResilientCache`` semantics
    minus the local mirror — a memo miss is already the correct
    fallback answer."""

    FAILURES = (ConnectionError, TimeoutError, OSError, ValueError)

    def __init__(self, primary, breaker: Optional[CircuitBreaker] = None,
                 fault_injector=None, name: str = ""):
        self.primary = primary
        self.breaker = breaker or CircuitBreaker()
        self.fault_injector = fault_injector
        self.name = name or type(primary).__name__
        self._lock = threading.Lock()
        self.counters = {"primary_ops": 0, "primary_errors": 0,
                         "degraded_ops": 0}

    def _inc(self, k: str) -> None:
        with self._lock:
            self.counters[k] += 1

    def _op(self, op: str, key: str, *args):
        """(ok, value) — ok False means "answer degraded"."""
        if not self.breaker.allow():
            self._inc("degraded_ops")
            return False, None
        self._inc("primary_ops")
        try:
            if self.fault_injector is not None:
                # the memo rides the same cache tier the blob cache
                # does, so a cache-outage drill must reach it too
                self.fault_injector.on_cache_op(f"memo_{op}", key)
            v = getattr(self.primary, op)(key, *args)
        except self.FAILURES as e:
            self._inc("primary_errors")
            self.breaker.record_failure()
            add_event("memo_degraded", op=op, error=repr(e),
                      breaker=self.breaker.state)
            log.warning("memo %s %s failed (%r); degrading to "
                        "recompute", self.name, op, e)
            return False, None
        self.breaker.record_success()
        return True, v

    def get(self, key: str) -> Optional[bytes]:
        ok, v = self._op("get", key)
        if not ok:
            MEMO_METRICS.inc("lookup_errors")
        return v if ok else None

    def put(self, key: str, data: bytes) -> None:
        ok, _ = self._op("put", key, data)
        if not ok:
            MEMO_METRICS.inc("store_errors")

    def delete(self, key: str) -> None:
        self._op("delete", key)

    def keys(self):
        if not self.breaker.allow():
            return None
        try:
            keys = self.primary.keys()
        except self.FAILURES:
            self.breaker.record_failure()
            return None
        self.breaker.record_success()
        return keys

    def breaker_stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        return {"backend": self.name, **counters,
                "breaker": self.breaker.stats()}


def make_memo_store(cache=None, cache_dir: str = "",
                    uri: str = ""):
    """Pick the memo backend matching the blob-cache tier.

    ``uri`` overrides: ``memory`` or a directory path; otherwise the
    backend mirrors ``cache`` (FSCache → fs, anything else → memory).
    A ``redis://`` or ``s3://`` URI raises ``ValueError`` (ROADMAP
    A.9f). Returns the RAW backend — the caller wraps it in
    :class:`ResilientMemoStore`."""
    if uri.startswith(REMOTE_SCHEMES):
        raise ValueError(
            f"--memo-cache {uri.split('://', 1)[0]}:// is not ported "
            "yet (ROADMAP A.9f); use 'memory' or a directory")
    if uri:
        if uri == "memory":
            return MemoryMemoStore()
        return FSMemoStore(uri)
    from ..artifact.cache import FSCache
    if isinstance(cache, FSCache):
        return FSMemoStore(cache_dir or os.path.dirname(cache.dir))
    if cache is None and cache_dir:
        return FSMemoStore(cache_dir)
    return MemoryMemoStore()
