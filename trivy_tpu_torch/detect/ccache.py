"""Keyed memo caches for the dispatch hot path.

:class:`KeyedLRU` is the shared machinery: a thread-safe LRU that
memoizes a factory per key, caches ``ValueError`` failures as a
sentinel (re-raised fresh on every hit — a malformed input repeated
across 10k SBOMs should cost one parse attempt, not 10k), and books
hit/miss totals into ``DETECT_METRICS`` under caller-named counters.

:data:`INTERVAL_CACHE` memoizes constraint→interval compilation,
which is PURE per (grammar, constraint string) — the resulting
``Interval`` objects carry parsed version keys that every consumer
treats as read-only (rank encoding and bound interning only read
them) — so one process-wide instance serves every dispatcher and
every DB compile. Hit and miss totals are counted in
``DETECT_METRICS``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from .metrics import DETECT_METRICS


class _CachedError:
    __slots__ = ("message",)

    def __init__(self, message: str):
        self.message = message


class KeyedLRU:
    """Thread-safe LRU memo over a per-call factory.

    ``lookup(key, factory)`` returns the cached value (the SAME
    object every hit — callers that mutate results must copy out) or
    runs ``factory(key)`` and caches it. A factory raising
    ``ValueError`` caches the message and every later hit re-raises
    a fresh ``ValueError``."""

    def __init__(self, maxsize: int, hit_counter: str,
                 miss_counter: str):
        self.maxsize = maxsize
        self._hit = hit_counter
        self._miss = miss_counter
        self._lock = threading.Lock()
        self._d: OrderedDict = OrderedDict()

    def lookup(self, key, factory):
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
        if hit is not None:
            DETECT_METRICS.inc(self._hit)
            if isinstance(hit, _CachedError):
                raise ValueError(hit.message)
            return hit
        DETECT_METRICS.inc(self._miss)
        try:
            value = factory(key)
        except ValueError as e:
            self._put(key, _CachedError(str(e)))
            raise
        self._put(key, value)
        return value

    def _put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


class ConstraintIntervalCache(KeyedLRU):
    """LRU over ``comparer.constraint_intervals`` keyed by
    (grammar, constraint string)."""

    def __init__(self, maxsize: int = 65536):
        super().__init__(maxsize, "interval_cache_hits",
                         "interval_cache_misses")

    def intervals(self, grammar: str, comparer,
                  constraint: str) -> tuple:
        """Compiled intervals for one ``||``-free constraint, shared
        across callers (read-only by contract). Raises ValueError on
        a (cached) parse failure, like ``constraint_intervals``."""
        return self.lookup(
            (grammar, constraint),
            lambda _k: tuple(
                comparer.constraint_intervals(constraint)))


INTERVAL_CACHE = ConstraintIntervalCache()
