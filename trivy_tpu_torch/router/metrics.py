"""Router metrics (reference: ``trivy_tpu/router/metrics.py``;
docs/serving.md "Scan router & autoscaling").

Process-wide singleton like ``watch.metrics.WATCH_METRICS``: one
router front per process, and the numbers an operator pages on —
``trivy_tpu_router_{requests,failovers,replays,spills}_total``, the
ring-churn event counter, per-replica in-flight gauges — are
cumulative totals on the router's ``GET /metrics``.

Books-balance invariant (test- and bench-enforced): every ACCEPTED
request increments exactly one of the terminal outcome counters
(``ok``/``degraded``/``timeout``/``rate_limited``/``unavailable``/
``failed``), so ``accepted == sum(terminal)`` at quiesce — a replica
dying mid-request produces a failover, never a lost request.
"""

from __future__ import annotations

import threading

from ..sched.metrics import LatencyHistogram


class RouterMetrics:
    """Cumulative counters + latency histograms for the scan-router
    front and its autoscaler."""

    _KEYS = (
        # every request the front accepted for routing ends in
        # EXACTLY ONE terminal outcome below (books balance)
        "accepted",
        "ok", "degraded", "timeout", "rate_limited", "unavailable",
        # terminal non-retryable error passthrough (400/413/500 from
        # the replica) — still exactly-once, still in the books
        "failed",
        # routing mechanics
        "forwards",          # upstream attempts (>= accepted)
        "failovers",         # attempts abandoned for the next owner
        "replays",           # failovers that re-sent a Scan body
        "spills",            # bounded-load overflow to next node
        "conn_errors",       # upstream connection failures observed
        "drain_redirects",   # 503 unavailable -> next owner
        # membership / health
        "ring_churn",        # add+remove events on the live ring
        "ejections",         # breaker-opened replicas pulled out
        "recoveries",        # half-open probes that closed a breaker
        "probes", "probe_failures",
        # autoscaler
        "scale_ups", "scale_downs", "scale_holds",
        "drains_started", "drain_kills",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._KEYS}
        # end-to-end router wall time vs time spent waiting on the
        # upstream replica: the difference, summed, is the attributed
        # router overhead the bench gates at < 2%
        self._hist = {"route_latency": LatencyHistogram(),
                      "upstream_latency": LatencyHistogram()}
        self._gauges: dict = {}      # replica -> inflight (bounded
        #                              by fleet size, <= MAX_REPLICAS)

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

    def set_inflight(self, replica: str, n: int) -> None:
        with self._lock:
            # lint: disable=unbounded-label-cardinality -- replica
            # names come from operator config / the autoscaler, and
            # the federation layer caps the fleet at MAX_REPLICAS
            self._gauges[replica] = n

    def drop_replica(self, replica: str) -> None:
        with self._lock:
            self._gauges.pop(replica, None)

    def reset(self) -> None:
        """Test hook — production code never calls this."""
        with self._lock:
            for k in self._c:
                self._c[k] = 0
            self._hist = {"route_latency": LatencyHistogram(),
                          "upstream_latency": LatencyHistogram()}
            self._gauges = {}

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["inflight"] = dict(self._gauges)
            out["route_latency"] = \
                self._hist["route_latency"].to_dict()
            out["upstream_latency"] = \
                self._hist["upstream_latency"].to_dict()
        terminal = (out["ok"] + out["degraded"] + out["timeout"]
                    + out["rate_limited"] + out["unavailable"]
                    + out["failed"])
        out["terminal"] = terminal
        out["lost"] = out["accepted"] - terminal  # 0 at quiesce
        return out

    def hist_snapshot(self) -> dict:
        """Raw bucket counts + exemplars for Prometheus exposition
        (obs/prom.py renders ``trivy_tpu_router_route_seconds`` and
        ``trivy_tpu_router_upstream_seconds``)."""
        with self._lock:
            return {k: h.raw() for k, h in self._hist.items()}


ROUTER_METRICS = RouterMetrics()
