"""Watch/admission metrics (reference: ``trivy_tpu/watch/metrics.py``;
docs/serving.md "Continuous scanning & admission control").

Process-wide by design, like ``memo.metrics.MEMO_METRICS``: the watch
loop and the admission controller are long-lived singletons per
process, and the numbers an operator alerts on
(``trivy_tpu_watch_{events,deduped,scans}_total``,
``trivy_tpu_admission_{allow,deny,fail_open,timeout}_total``, the
event-lag and admission-latency histograms) are cumulative totals on
``GET /metrics`` — JSON and Prometheus text alike, on both sched
modes. The watch loop (``loop.py``), the registry notification source
(``source.py``) and the admission controller (``admission.py``) feed
it; the scan server reports the snapshot and the Prometheus
histograms.
"""

from __future__ import annotations

import threading

from ..sched.metrics import LatencyHistogram


class WatchMetrics:
    """Cumulative counters + latency histograms for the watch loop
    and the K8s admission webhook."""

    _KEYS = (
        # -- watch loop: every valid push event entering the loop
        #    ends in EXACTLY ONE of scans / deduped / shed (the
        #    storm-drain accounting invariant, test-enforced)
        "events", "deduped", "scans", "shed",
        # malformed notifications are counted and dropped at the
        # parse boundary — they never become events
        "malformed",
        # scan outcomes (disjoint from the event disposition above:
        # a failed scan still disposed its events as "scans")
        "completed", "failed",
        # source hiccups survived via the shared backoff policy
        "source_errors",
        # events whose image reference no resolver could map to a
        # scannable target (disposed as shed)
        "unresolvable",
        # hot-swap impact push stream: re-scan events enqueued by
        # impact/push.py (each then disposes normally as
        # scans/deduped/shed — this counts the stream's input side)
        "impact_rescans",
        # -- admission webhook verdict counters
        "admission_allow", "admission_deny", "admission_fail_open",
        "admission_timeout", "admission_reviews",
        # verdict-cache traffic (keyed by the memo ctx_sig — a db
        # hot swap strands the old generation's entries)
        "admission_cache_hits", "admission_cache_misses",
        # deadline-missed digests queued for a warm background scan
        # so the NEXT admission of that digest hits
        "admission_background_scans",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._KEYS}
        # event lag: push-event arrival -> scan resolution; the
        # admission histogram is review() wall time. Both carry
        # trace-id exemplars (OpenMetrics exposition only).
        self._hist = {"watch_lag": LatencyHistogram(),
                      "admission_latency": LatencyHistogram()}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            # lint: disable=unbounded-label-cardinality -- counter
            # names are code-literal call sites, never
            # request-derived strings
            self._c[name] = self._c.get(name, 0) + n

    def observe(self, hist: str, seconds: float,
                trace_id: str = "") -> None:
        with self._lock:
            self._hist[hist].observe(seconds, exemplar=trace_id)

    def reset(self) -> None:
        """Test hook — production code never calls this."""
        with self._lock:
            for k in self._c:
                self._c[k] = 0
            self._hist = {"watch_lag": LatencyHistogram(),
                          "admission_latency": LatencyHistogram()}

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["lag"] = self._hist["watch_lag"].to_dict()
            out["admission_latency"] = \
                self._hist["admission_latency"].to_dict()
        lookups = (out["admission_cache_hits"]
                   + out["admission_cache_misses"])
        out["admission_cache_hit_rate"] = round(
            out["admission_cache_hits"] / lookups, 4) \
            if lookups else 0.0
        return out

    def hist_snapshot(self) -> dict:
        """Raw bucket counts + exemplars for Prometheus exposition
        (obs/prom.py renders ``trivy_tpu_watch_lag_seconds`` and
        ``trivy_tpu_admission_latency_seconds``)."""
        with self._lock:
            return {k: h.raw() for k, h in self._hist.items()}


WATCH_METRICS = WatchMetrics()
