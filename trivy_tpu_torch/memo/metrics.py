"""Findings-memo metrics (copied from ``trivy_tpu/memo/metrics.py``):
hit/miss/store/invalidation counters plus the delta re-match
accounting.

Process-wide by design, like ``detect.metrics.DETECT_METRICS``: the
numbers ``SchedMetrics.snapshot``'s ``memo`` section shows are
cumulative totals across every memo instance in the process.
"""

from __future__ import annotations

import threading


class MemoMetrics:
    """Cumulative counters for the findings-memo path."""

    _KEYS = (
        # per-query lookup outcomes (a "query" is one package's
        # candidate-advisory set within one layer)
        "hits", "misses",
        # layer entries fully served / written / bytes written
        "layer_hits", "stores", "bytes",
        # entries or sub-entries invalidated: delta-touched packages
        # at hot swap, plus corrupt entries dropped on deserialize
        "invalidations", "corrupt",
        # backend degradation (circuit breaker / outage): a failed
        # lookup is a miss, a failed store is dropped — never an error
        "lookup_errors", "store_errors",
        # db hot-swap migration: entries re-keyed to the new
        # generation, device jobs re-matched for delta-touched
        # packages, swaps processed
        "migrated_entries", "rematch_jobs", "rematch_entries",
        "swaps",
        # hot swaps whose migration failed (the re-match dispatch or a
        # store write raised): the touched entries are recomputed at
        # the next scan, and this counter says so (the port's own)
        "swap_failures",
        # advisory-delta observability: advisory keys the delta
        # touched, sub-records re-matched against the new generation,
        # sub-records invalidated outright (no longer evaluable —
        # recompute on next scan)
        "delta_touched", "delta_rematched", "delta_invalidated",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._KEYS}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            # lint: disable=unbounded-label-cardinality -- counter
            # names are code-literal call sites, never
            # request-derived strings
            self._c[name] = self._c.get(name, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
        lookups = out["hits"] + out["misses"]
        out["hit_rate"] = round(out["hits"] / lookups, 4) \
            if lookups else 0.0
        return out


MEMO_METRICS = MemoMetrics()
