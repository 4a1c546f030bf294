"""Dispatch-path metrics: dedup ratios, constraint-cache hit rates,
device-resident DB upload amortization.

Process-wide by design: the constraint-interval cache is a process
singleton, DB uploads happen once per (generation, device), and the
numbers an operator watches are the cumulative totals. The counter
names are the reference's (``pack_tasks`` counts the host pool's
tasks, ``runtime/hostpool.py``). Counter updates take one short
lock; nothing here sits on a per-byte hot path (per-job costs
are batched by the dispatchers before they land here).
"""

from __future__ import annotations

import threading


class DetectMetrics:
    """Cumulative counters for the interval-dispatch hot path."""

    _KEYS = (
        # dispatch_jobs: jobs submitted vs unique after dedup
        "jobs_in", "jobs_unique",
        # constraint-interval compile cache (detect/ccache.py)
        "interval_cache_hits", "interval_cache_misses",
        # purl parse cache (purl.py)
        "purl_cache_hits", "purl_cache_misses",
        # device-resident advisory tables (db/compiled.py)
        "db_uploads", "db_upload_bytes", "db_invalidations",
        "resident_dispatches",
        # host-pool packing/decode tasks (runtime/hostpool.py)
        "pack_tasks",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._KEYS}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def note_dispatch(self, jobs_in: int, jobs_unique: int) -> None:
        with self._lock:
            self._c["jobs_in"] += jobs_in
            self._c["jobs_unique"] += jobs_unique

    def note_db_upload(self, nbytes: int) -> None:
        with self._lock:
            self._c["db_uploads"] += 1
            self._c["db_upload_bytes"] += nbytes

    def reset(self) -> None:
        """Test hook — production code never calls this."""
        with self._lock:
            for k in self._c:
                self._c[k] = 0

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
        jobs_in = out["jobs_in"]
        out["dedup_ratio"] = round(
            1.0 - out["jobs_unique"] / jobs_in, 4) if jobs_in else 0.0
        ic = out["interval_cache_hits"] + out["interval_cache_misses"]
        out["interval_cache_hit_rate"] = round(
            out["interval_cache_hits"] / ic, 4) if ic else 0.0
        out["upload_amortization"] = round(
            out["resident_dispatches"] / out["db_uploads"], 2) \
            if out["db_uploads"] else 0.0
        return out


DETECT_METRICS = DetectMetrics()
