"""Elastic warm-state lifecycle counters (reference:
``trivy_tpu/router/lifecycle.py``; docs/serving.md "Elastic
lifecycle").

The scan server books its drain handoff (``GET /handoff``, ``POST
/prefetch``) here and reports the snapshot under ``/metrics``'
``lifecycle`` section. The prewarm and handoff planning, and the
router that drives them, come with ``router/`` (ROADMAP A.9h).
"""

from __future__ import annotations

import threading


class LifecycleMetrics:
    """Cumulative lifecycle counters, one singleton per process
    (replica- or router-side — both surfaces render the same
    families; see obs/prom.py).

    ``prewarm_seconds`` accumulates wall time spent inside prewarm
    walks (monotonic deltas), so the exposition stays a counter.
    """

    _KEYS = (
        # scale-up prewarm
        "prewarm_runs",               # prewarm attempts started
        "prewarm_keys",               # memo keys staged while warming
        "prewarm_bytes",              # payload bytes staged
        "prewarm_deadline_exceeded",  # walks cut off by the deadline
        "prewarm_cold_joins",         # degraded to a cold join
        # drain handoff
        "handoff_published",          # digests the victim exported
        "handoff_prefetched",         # digests accepted by successors
        "handoff_abandoned",          # digests no successor took
    )

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._KEYS}
        self._seconds = 0.0

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def add_seconds(self, seconds: float) -> None:
        with self._lock:
            self._seconds += max(0.0, seconds)

    def reset(self) -> None:
        """Test hook — production code never calls this."""
        with self._lock:
            for k in self._c:
                self._c[k] = 0
            self._seconds = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["prewarm_seconds"] = round(self._seconds, 6)
        return out


LIFECYCLE_METRICS = LifecycleMetrics()
