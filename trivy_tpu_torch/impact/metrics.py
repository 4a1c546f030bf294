"""Impact-index metrics (reference: ``trivy_tpu/impact/metrics.py``;
docs/serving.md "CVE impact queries & push re-scans").

Process-wide singleton like ``memo.metrics.MEMO_METRICS``: one
impact index serves every scanner in a replica, and the numbers an
operator watches (update/query/rebuild counters, cumulative
maintenance wall time for the <2% write-through overhead budget) are
totals on ``GET /metrics`` — JSON and Prometheus text alike.
"""

from __future__ import annotations

import threading


class ImpactMetrics:
    """Cumulative counters + maintenance wall-clock for the inverted
    findings index."""

    _KEYS = (
        # index maintenance (write-through side effects of memo
        # stores, corrupt drops, and hot-swap migrations);
        # image_updates counts image-record changes, distinct from
        # the live-image gauge ImpactIndex.stats() reports as images
        "updates", "drops", "renames", "image_updates",
        # image-record persistence to the shared memo tier (skips
        # are unchanged records — the swap-storm dedupe)
        "persist_puts", "persist_skips",
        # query traffic (local slice lookups, not federated fan-outs)
        "queries",
        # rebuild/recovery passes (reshard, cold start); degraded =
        # the backing scan_keys reported an incomplete iteration
        "rebuilds", "rebuild_entries", "rebuild_degraded",
        # hot-swap push stream: batches emitted, images queued
        "push_batches", "push_images",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._KEYS}
        self._maintenance_s = 0.0

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            # lint: disable=unbounded-label-cardinality -- counter
            # names are code-literal call sites, never
            # request-derived strings
            self._c[name] = self._c.get(name, 0) + n

    def add_maintenance(self, seconds: float) -> None:
        with self._lock:
            self._maintenance_s += max(0.0, seconds)

    def reset(self) -> None:
        """Test hook — production code never calls this."""
        with self._lock:
            for k in self._c:
                self._c[k] = 0
            self._maintenance_s = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["maintenance_s"] = round(self._maintenance_s, 6)
        return out


IMPACT_METRICS = ImpactMetrics()
