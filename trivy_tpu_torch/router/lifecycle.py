"""Elastic warm-state lifecycle: the counters, prewarm planning and the
drain handoff's HTTP half (reference: ``trivy_tpu/router/lifecycle.py``;
docs/serving.md "Elastic lifecycle").

* **prewarm** — ring placement is a deterministic cross-process
  function (``router/ring.py`` hashes with blake2b), so a replica
  that has NOT yet joined can compute exactly which keys the
  post-join ring will assign it: build a ring over
  ``members + [self]`` and keep the keys it owns.
  :func:`prewarm_ranges` is that computation; the scan server's
  ``--prewarm-members`` walks the shared memo tier for those keys
  (``memo/warmth.py::range_walk``) BEFORE flipping ``/healthz`` to
  ready, bounded by a deadline so a degraded memo tier degrades to a
  cold join instead of wedging the scale-up.
* **handoff** — a draining replica publishes its hot-digest set
  (recency ordered) on ``GET /handoff`` and books it here;
  :func:`plan_handoff` says where each digest lands once the victim
  leaves (a ring WITHOUT the victim), :func:`fetch_handoff` pulls the
  set and ``_post_json`` pushes a successor's ``POST /prefetch``
  batch; :func:`run_handoff` drives them from a router's scale-down
  (``scaler.py::Autoscaler``).

Stdlib-only, like the reference: the planning functions are pure and
agree across processes and packages without coordination.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from typing import Dict, Iterable, List, Optional

from .ring import DEFAULT_CAPACITY_FACTOR, DEFAULT_VNODES, Ring

log = logging.getLogger("trivy_tpu_torch.router.lifecycle")

# a draining replica publishes at most this many hot digests —
# recency-ordered, so the cap keeps the hottest working set and the
# handoff payload bounded regardless of how long the victim served
HANDOFF_CAP = 4096


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


# ---------------------------------------------------------------
# pure planning (deterministic cross-process, like the ring itself)
# ---------------------------------------------------------------


def prewarm_ranges(members: Iterable[str], joiner: str,
                   keys: Iterable[str],
                   vnodes: int = DEFAULT_VNODES,
                   capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
                   ) -> List[str]:
    """Keys the POST-join ring will assign to ``joiner``.

    ``members`` is the current fleet (joiner not yet on the ring);
    the returned subset of ``keys`` — in input order, so a recency-
    ordered key listing prewarms hottest-first — is exactly what the
    joiner should stage from the shared memo tier before flipping
    ready. Pure: two processes with the same inputs agree without
    coordination.
    """
    ring = Ring(vnodes=vnodes, capacity_factor=capacity_factor)
    for m in members:
        ring.add(m)
    ring.add(joiner)
    return [k for k in keys if ring.owner(k) == joiner]


def plan_handoff(members: Iterable[str], victim: str,
                 digests: Iterable[str],
                 vnodes: int = DEFAULT_VNODES,
                 capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
                 ) -> Dict[str, List[str]]:
    """successor -> digests: where each of the victim's hot digests
    lands once the victim leaves the ring. Built over ``members``
    WITHOUT the victim (the post-departure ring), preserving the
    victim's recency order within each successor's list so
    prefetches warm hottest-first."""
    ring = Ring(vnodes=vnodes, capacity_factor=capacity_factor)
    for m in members:
        if m != victim:
            ring.add(m)
    plan: Dict[str, List[str]] = {}
    for d in digests:
        owner = ring.owner(d)
        if owner is not None:
            plan.setdefault(owner, []).append(d)
    return plan


# ---------------------------------------------------------------
# HTTP orchestration (drain handoff over the replica surface)
# ---------------------------------------------------------------


def _post_json(url: str, payload: dict,
               timeout_s: float) -> Optional[dict]:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            doc = json.loads(resp.read() or b"{}")
    except (urllib.error.URLError, ConnectionError, TimeoutError,
            OSError, ValueError) as e:
        log.warning("lifecycle POST %s failed: %r", url, e)
        return None
    return doc if isinstance(doc, dict) else None


def fetch_handoff(url: str,
                  timeout_s: float = 5.0) -> List[str]:
    """``GET <replica>/handoff`` — the victim's recency-ordered hot
    digests (hottest last, like an LRU; callers reverse when they
    want hottest-first). Empty on any failure: handoff is an
    optimization, the drain itself must not depend on it."""
    try:
        req = urllib.request.Request(url.rstrip("/") + "/handoff",
                                     method="GET")
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            doc = json.loads(resp.read() or b"{}")
    except (urllib.error.URLError, ConnectionError, TimeoutError,
            OSError, ValueError) as e:
        log.warning("handoff fetch from %s failed: %r", url, e)
        return []
    if not isinstance(doc, dict):
        return []
    return [str(d) for d in doc.get("digests") or []][:HANDOFF_CAP]


def run_handoff(router, victim: str,
                timeout_s: float = 5.0) -> dict:
    """Drain-handoff orchestration, called right after ``victim`` is
    marked draining: pull its hot-digest set, plan successors on the
    victim-less ring, push ``POST /prefetch`` to each. Books every
    digest exactly once (prefetched or abandoned) into
    :data:`LIFECYCLE_METRICS`; returns the summary the scaler/soak
    report logs. Failure anywhere degrades to the pre-handoff world
    (successors fault cold) — never blocks the drain."""
    vh = router.replica(victim)
    summary = {"victim": victim, "published": 0,
               "prefetched": 0, "abandoned": 0, "successors": {}}
    if vh is None:
        return summary
    digests = fetch_handoff(vh.url, timeout_s=timeout_s)
    if not digests:
        return summary
    # hottest-first for the successors' bounded warm sets
    digests = list(reversed(digests))
    summary["published"] = len(digests)
    LIFECYCLE_METRICS.inc("handoff_published", len(digests))
    members = [h.name for h in router.replicas()
               if h.name != victim and not h.draining]
    plan = plan_handoff(members + [victim], victim, digests)
    for successor in sorted(plan):
        batch = plan[successor]
        sh = router.replica(successor)
        doc = _post_json(sh.url + "/prefetch", {"digests": batch},
                         timeout_s) if sh is not None else None
        accepted = 0
        if doc is not None:
            try:
                accepted = max(0, min(len(batch),
                                      int(doc.get("accepted") or 0)))
            except (TypeError, ValueError):
                accepted = 0
        summary["successors"][successor] = accepted
        summary["prefetched"] += accepted
        summary["abandoned"] += len(batch) - accepted
    # digests whose successor vanished mid-plan are abandoned too
    planned = sum(len(v) for v in plan.values())
    summary["abandoned"] += len(digests) - planned
    LIFECYCLE_METRICS.inc("handoff_prefetched",
                          summary["prefetched"])
    LIFECYCLE_METRICS.inc("handoff_abandoned", summary["abandoned"])
    log.info("handoff from %s: %d published, %d prefetched, "
             "%d abandoned", victim, summary["published"],
             summary["prefetched"], summary["abandoned"])
    return summary
