"""Streaming registry ingest (reference: ``trivy_tpu/artifact/
stream.py``): the process-wide ingest counters, which the scan server
reports under ``/metrics``' ``ingest`` section on both sched modes.
The streaming layer fetch that fills them comes with the registry
client (ROADMAP A.9f).
"""

from __future__ import annotations

import threading


class IngestMetrics:
    """Process-wide streaming-ingest counters (thread-safe);
    snapshotted into ``GET /metrics`` on both sched modes and
    rendered as ``trivy_tpu_ingest_*_total`` Prometheus families."""

    _KEYS = ("streams", "layers_fetched", "bytes_fetched",
             "layers_skipped", "bytes_skipped", "range_resumes",
             "full_restarts", "warm_probe_outages",
             "cancelled_fetches", "config_memo_hits")

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {k: 0 for k in self._KEYS}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            # lint: disable=unbounded-label-cardinality -- counter
            # names are code-literal call sites, never
            # request-derived strings
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def reset(self) -> None:
        with self._lock:
            self.counters = {k: 0 for k in self._KEYS}


INGEST_METRICS = IngestMetrics()
