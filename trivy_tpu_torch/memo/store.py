"""Findings-memo persistence over the blob-cache tier (copied from
``trivy_tpu/memo/store.py``).

Backends mirror the blob cache's (memory, fs, redis, s3) but carry an
opaque raw-bytes contract — memo entries are checksummed JSON whose
deserialization lives in ``memo.findings``, never the blob-typed
``types.convert`` readers. The Redis and S3 stores ride the remote
blob caches' connections (``artifact/redis_cache.py``,
``artifact/s3_cache.py``) under the reference's keys, so one memo
serves both packages. Every store has the bounded ``scan_keys``
listing (``(keys, complete)``).

Every backend goes behind :class:`ResilientMemoStore`, which reuses
``artifact.resilient.CircuitBreaker``: a backend outage degrades a
lookup into a miss (recompute) and a store into a drop — there is no
path through the memo that turns an outage into an exception, and no
local mirror to fill (the recompute IS the fallback, so an outage
costs warm throughput, never correctness). Each degraded op is a
``memo_degraded`` event. The optional fault injector hook
(``faults.FaultInjector.on_cache_op(op, key)``) makes a cache outage
drill hit the memo tier the same way it hits the blob cache.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ..artifact.cache import FSCache
from ..artifact.redis_cache import RedisCache
from ..artifact.resilient import CircuitBreaker
from ..artifact.s3_cache import S3Cache
from ..obs.trace import add_event
from .metrics import MEMO_METRICS

log = logging.getLogger("trivy_tpu_torch.memo.store")


def _cap(keys: list, limit: int) -> tuple:
    """Shared ``scan_keys`` bounding: a positive ``limit`` truncates
    and reports the iteration incomplete — the caller (index rebuild)
    must not mistake a capped page for the whole keyspace."""
    keys = sorted(keys)
    if limit and len(keys) > limit:
        return keys[:limit], False
    return keys, True


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

    def scan_keys(self, prefix: str = "", limit: int = 0) -> tuple:
        with self._lock:
            keys = [k for k in self._d if k.startswith(prefix)]
        return _cap(keys, limit)


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

    def scan_keys(self, prefix: str = "", limit: int = 0) -> tuple:
        # unlike keys(), an unreadable directory RAISES so the
        # resilient wrapper can flag the iteration incomplete — a
        # rebuild must distinguish "empty store" from "can't look"
        names = os.listdir(self.dir)
        return _cap([n[:-5] for n in names
                     if n.endswith(".json")
                     and n[:-5].startswith(prefix)], limit)


class RedisMemoStore:
    """Raw-bytes entries on the blob cache's own Redis connection
    (``fanal::memo::<key>``), honoring its expiration policy."""

    def __init__(self, redis_cache):
        self.cache = redis_cache

    def _key(self, key: str) -> str:
        return f"fanal::memo::{key}"

    def get(self, key: str) -> Optional[bytes]:
        raw = self.cache.client.command("GET", self._key(key))
        return raw if raw else None

    def put(self, key: str, data: bytes) -> None:
        args = ["SET", self._key(key), data]
        exp = getattr(self.cache, "expiration_s", 0)
        if exp:
            args += ["EX", str(exp)]
        self.cache.client.command(*args)

    def delete(self, key: str) -> None:
        self.cache.client.command("DEL", self._key(key))

    def keys(self):
        return None          # no cheap enumeration — journal only

    def scan_keys(self, prefix: str = "", limit: int = 0) -> tuple:
        """Bounded SCAN cursor walk — O(page) per round trip, never
        the O(keyspace) blocking KEYS."""
        ns = self._key(prefix)
        keys, cursor = [], "0"
        while True:
            reply = self.cache.client.command(
                "SCAN", cursor, "MATCH", ns + "*", "COUNT", "512")
            if not isinstance(reply, (list, tuple)) or len(reply) != 2:
                raise ConnectionError(f"bad SCAN reply: {reply!r}")
            cursor_raw, page = reply
            cursor = cursor_raw.decode() \
                if isinstance(cursor_raw, bytes) else str(cursor_raw)
            for k in page or []:
                if isinstance(k, bytes):
                    k = k.decode("utf-8", "replace")
                keys.append(k[len("fanal::memo::"):])
            if cursor == "0":
                return _cap(keys, limit)
            if limit and len(keys) >= limit:
                return sorted(keys)[:limit], False


class S3MemoStore:
    """Raw-bytes entries as ``memo/<key>`` objects in the blob
    cache's bucket/prefix."""

    def __init__(self, s3_cache):
        self.cache = s3_cache

    def _key(self, key: str) -> str:
        return self.cache._key("memo", key) \
            if hasattr(self.cache, "_key") else f"memo/{key}"

    def get(self, key: str) -> Optional[bytes]:
        status, data = self.cache.client.request("GET",
                                                 self._key(key))
        return data if status == 200 else None

    def put(self, key: str, data: bytes) -> None:
        self.cache.client.request("PUT", self._key(key), data)

    def delete(self, key: str) -> None:
        self.cache.client.request("DELETE", self._key(key))

    def keys(self):
        return None          # journal only

    def scan_keys(self, prefix: str = "", limit: int = 0) -> tuple:
        ns = self._key(prefix)
        # strip the trailing key part back off to find the object
        # prefix that _key() prepends (bucket/prefix layout differs
        # between S3Cache and the bare fallback)
        base = ns[:len(ns) - len(prefix)]
        objs, complete = self.cache.client.list_keys(
            ns, max_keys=limit or 0)
        keys = [o[len(base):] for o in objs if o.startswith(base)]
        if limit and len(keys) > limit:
            return sorted(keys)[:limit], False
        return sorted(keys), complete


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

    def scan_keys(self, prefix: str = "",
                  limit: int = 0) -> tuple:
        """(keys, complete) — Federator semantics: an outage yields a
        PARTIAL answer flagged ``complete=False``, never an error.
        Index rebuilds treat an incomplete scan as a degraded slice,
        not as ground truth."""
        if not hasattr(self.primary, "scan_keys"):
            keys = self.keys()          # duck-typed stores: best
            if keys is None:            # effort via full keys()
                return [], False
            return _cap([k for k in keys
                         if k.startswith(prefix)], limit)
        ok, v = self._op("scan_keys", prefix, limit)
        if not ok or v is None:
            return [], False
        keys, complete = v
        return list(keys), bool(complete)

    def breaker_stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        return {"backend": self.name, **counters,
                "breaker": self.breaker.stats()}


def make_memo_store(cache=None, cache_dir: str = "",
                    uri: str = ""):
    """Pick the memo backend matching the blob-cache tier.

    ``uri`` overrides: ``memory``, a directory path, ``redis://…``
    or ``s3://…``; otherwise the backend mirrors ``cache`` (FSCache →
    fs, Redis/S3 behind a breaker → the same connection, anything
    else → memory). Returns the RAW backend — the caller wraps it in
    :class:`ResilientMemoStore`."""
    if uri:
        if uri == "memory":
            return MemoryMemoStore()
        if uri.startswith("redis://"):
            return RedisMemoStore(RedisCache(uri))
        if uri.startswith("s3://"):
            return S3MemoStore(S3Cache(uri))
        return FSMemoStore(uri)
    # unwrap the resilience/fault layers to find the real backend
    inner = cache
    for attr in ("primary", "inner"):
        nxt = getattr(inner, attr, None)
        if nxt is not None:
            inner = nxt
    if isinstance(inner, RedisCache):
        return RedisMemoStore(inner)
    if isinstance(inner, S3Cache):
        return S3MemoStore(inner)
    if isinstance(inner, FSCache):
        return FSMemoStore(cache_dir or os.path.dirname(inner.dir))
    if cache is None and cache_dir:
        return FSMemoStore(cache_dir)
    return MemoryMemoStore()
