"""Declarative SLOs with multi-window burn-rate alerting (reference:
``trivy_tpu/obs/slo.py``; docs/observability.md "SLOs & burn rates").

The standard SRE multi-window multi-burn-rate construction over the
scheduler's request outcomes:

* an :class:`SLO` declares an **objective** over a class of events —
  ``availability`` (request resolved without failing/timing out),
  ``latency`` (request resolved under ``threshold_s``) or
  ``efficiency`` (useful share of device wall) — scoped globally or to
  one tenant (``tenant=``) / priority class (``min_priority=``);
* the engine buckets good/bad events into a monotonic-clock ring and
  computes **burn rates** — ``(bad share over window) / (1 -
  objective)`` — over paired windows: **5m/1h** (fast, trips at burn
  >= 14.4) and **30m/6h** (slow, trips at burn >= 6). Both windows of
  a pair must agree, so a single bad burst cannot page;
* each violated SLO carries **exemplar trace ids** of its worst recent
  bad events, and a trip TRANSITION dumps those traces through the
  flight recorder (``obs/recorder.py``).

Only ADMITTED requests count: backpressure rejections (429/503) are
the tenancy layer's shed accounting, not availability events.

Clock discipline: the ring keys and window math are
``time.monotonic`` only; wall time appears solely as exemplar labels.

Fleet federation (``obs/federate.py``): :meth:`SloEngine.export_state`
serializes the bucket ring keyed by AGE, :func:`merge_exports` sums N
replicas' exports and :func:`verdicts_from_export` recomputes the
burn rates over the merge — the same math as one engine fed the
union event stream.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

# (label, short window s, long window s, burn-rate threshold)
FAST_WINDOWS = ("5m", 300.0, 3600.0, 14.4)
SLOW_WINDOWS = ("30m", 1800.0, 21600.0, 6.0)
WINDOW_LABELS = ("5m", "1h", "30m", "6h")

_BUCKET_S = 10.0            # ring granularity
_RING_CAP = int(21600 / _BUCKET_S) + 2     # longest window + slack
_EXEMPLARS = 8              # worst bad traces kept per SLO

_BAD_OUTCOMES = ("failed", "timed_out")


@dataclass(frozen=True)
class SLO:
    """One declarative objective. ``kind`` is ``availability``,
    ``latency`` (additionally needs ``threshold_s``), or
    ``efficiency`` — the MFU-style goodput gauge: its events are
    device MILLISECONDS (useful vs. demand-gated idle, booked by
    :meth:`SloEngine.record_device` from the cost-attribution
    plane), not request outcomes, and ``objective`` is the target
    useful share of device wall."""

    name: str
    kind: str = "availability"
    objective: float = 0.99         # good-event share target
    threshold_s: float = 0.0        # latency: good iff under this
    tenant: str = ""                # "" = all tenants
    min_priority: int = -(10 ** 9)  # scope to a priority class

    def __post_init__(self):
        if self.kind not in ("availability", "latency",
                             "efficiency"):
            raise ValueError(f"SLO {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO {self.name!r}: objective must "
                             f"be in (0, 1), got {self.objective}")
        if self.kind == "latency" and self.threshold_s <= 0:
            raise ValueError(f"SLO {self.name!r}: latency SLOs "
                             f"need threshold_s > 0")

    def matches(self, tenant: str, priority: int) -> bool:
        if self.tenant and tenant != self.tenant:
            return False
        return priority >= self.min_priority

    def classify(self, outcome: str, latency_s: float):
        """True=good, False=bad, None=out of scope (cancelled
        requests are the caller's choice, not the service's)."""
        if self.kind == "efficiency":
            # device-time events only (record_device) — a request
            # outcome carries no goodput information
            return None
        if outcome == "cancelled":
            return None
        if self.kind == "availability":
            return outcome not in _BAD_OUTCOMES
        # latency: a request that never completed blew the target
        if outcome in _BAD_OUTCOMES:
            return False
        return latency_s <= self.threshold_s


def default_slos() -> list:
    """The out-of-the-box objectives: 99% of admitted requests
    resolve, 95% resolve under 30s. Deployments override via
    --slo-config (docs/serving.md)."""
    return [
        SLO(name="availability", kind="availability",
            objective=0.99),
        SLO(name="latency_p95_30s", kind="latency", objective=0.95,
            threshold_s=30.0),
    ]


def parse_slo_config(text) -> list:
    """``--slo-config`` parser, mirroring --tenant-config's inline
    grammar::

        avail:kind=availability,objective=0.999;
        lat:kind=latency,objective=0.95,threshold_s=2.5,tenant=alice

    Unknown keys and malformed values raise ValueError so a typo'd
    objective fails the run up front."""
    if isinstance(text, (list, tuple)):
        return list(text)
    text = (text or "").strip()
    if not text:
        return default_slos()
    coerce = {"kind": str, "tenant": str, "objective": float,
              "threshold_s": float, "min_priority": int}
    out = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, sep, rest = chunk.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(f"bad slo-config entry {chunk!r} "
                             f"(want name:key=value,...)")
        kv: dict = {}
        for pair in rest.split(","):
            pair = pair.strip()
            if not pair:
                continue
            key, eq, raw = pair.partition("=")
            key = key.strip()
            if not eq or key not in coerce:
                raise ValueError(
                    f"bad slo-config entry {pair!r} for {name!r} "
                    f"(choose from {sorted(coerce)})")
            try:
                kv[key] = coerce[key](raw.strip())
            except (TypeError, ValueError):
                raise ValueError(
                    f"bad slo-config value for {name}.{key}: "
                    f"{raw!r}")
        out.append(SLO(name=name, **kv))
    if not out:
        raise ValueError("slo-config parsed to zero SLOs")
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        # caught here so a typo'd config fails the CLI's clean
        # error path, not SloEngine.__init__ deep in server setup
        raise ValueError(f"duplicate SLO names: {names}")
    return out


def _trip_thresholds(kind: str, fast_burn: float,
                     slow_burn: float) -> tuple:
    """Per-kind burn thresholds. An efficiency book's burn rate is
    bounded by ``1 / (1 - objective)`` — idle share can never
    exceed 1 — so the standard 14.4/6 multipliers would be
    unreachable; an efficiency SLO trips at burn >= 1 on both
    windows of a pair, i.e. measured useful share below the
    objective sustained across the window pair."""
    if kind == "efficiency":
        return 1.0, 1.0
    return fast_burn, slow_burn


def _window_share(book, now: float, window_s: float) -> float:
    """Good share over one trailing window (the efficiency gauge
    value); 0 when the window is empty."""
    good, bad = SloEngine._window_counts(book, now, window_s)
    total = good + bad
    return good / total if total else 0.0


class _Exemplar:
    __slots__ = ("trace_id", "latency_s", "outcome", "t")

    def __init__(self, trace_id, latency_s, outcome, t):
        self.trace_id = trace_id
        self.latency_s = latency_s
        self.outcome = outcome
        self.t = t


@dataclass
class _Book:
    """Per-SLO state: the good/bad ring + trip latches."""

    slo: SLO
    ring: dict = field(default_factory=dict)  # bucket -> [good, bad]
    good: int = 0
    bad: int = 0
    exemplars: list = field(default_factory=list)
    fast_tripped: bool = False
    slow_tripped: bool = False
    trips: int = 0


class SloEngine:
    """Records outcomes, computes verdicts, dumps evidence.

    ``record`` is on the request-resolution path, so it is one dict
    update under one lock; burn-rate evaluation (which walks the
    rings) runs on ``verdicts()`` — the /slo and /metrics readers —
    and at most once per second opportunistically from ``record``
    so a trip dumps its traces even when nobody is scraping."""

    def __init__(self, slos=None, recorder=None,
                 fast_burn: float = FAST_WINDOWS[3],
                 slow_burn: float = SLOW_WINDOWS[3]):
        self.slos = list(slos) if slos is not None \
            else default_slos()
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.recorder = recorder
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self._lock = threading.Lock()
        self._books = {s.name: _Book(slo=s) for s in self.slos}
        self._last_eval = 0.0
        self.dumps = 0

    # --- recording ---

    def record(self, outcome: str, latency_s: float = 0.0,
               tenant: str = "", priority: int = 0,
               trace_id: str = "") -> None:
        now = time.monotonic()
        bucket = int(now / _BUCKET_S)
        with self._lock:
            for book in self._books.values():
                slo = book.slo
                if not slo.matches(tenant, priority):
                    continue
                verdict = slo.classify(outcome, latency_s)
                if verdict is None:
                    continue
                slot = book.ring.get(bucket)
                if slot is None:
                    slot = book.ring[bucket] = [0, 0]
                    while len(book.ring) > _RING_CAP:
                        book.ring.pop(next(iter(book.ring)))
                if verdict:
                    slot[0] += 1
                    book.good += 1
                else:
                    slot[1] += 1
                    book.bad += 1
                    if trace_id:
                        book.exemplars.append(_Exemplar(
                            trace_id, latency_s, outcome, now))
                        # worst-first (slowest / most recent), capped
                        book.exemplars.sort(
                            key=lambda e: (-e.latency_s, -e.t))
                        del book.exemplars[_EXEMPLARS:]
            due = now - self._last_eval >= 1.0
            if due:
                self._last_eval = now
        if due:
            self.verdicts(now=now)

    def record_device(self, useful_s: float,
                      idle_s: float = 0.0) -> None:
        """Book device goodput into every ``kind=efficiency``
        book: ``useful_s`` of attributed device wall as good
        events, ``idle_s`` of demand-gated idle (the device sat
        while admitted work waited) as bad — both in integer
        milliseconds so the ring stays count-shaped and the burn/
        federation math applies unchanged. Called by the scheduler
        at every dispatch collection (obs/cost.py); a no-op when no
        efficiency SLO is declared."""
        good_ms = max(0, int(float(useful_s) * 1000.0))
        bad_ms = max(0, int(float(idle_s) * 1000.0))
        if not good_ms and not bad_ms:
            return
        now = time.monotonic()
        bucket = int(now / _BUCKET_S)
        with self._lock:
            for book in self._books.values():
                if book.slo.kind != "efficiency":
                    continue
                slot = book.ring.get(bucket)
                if slot is None:
                    slot = book.ring[bucket] = [0, 0]
                    while len(book.ring) > _RING_CAP:
                        book.ring.pop(next(iter(book.ring)))
                slot[0] += good_ms
                slot[1] += bad_ms
                book.good += good_ms
                book.bad += bad_ms

    # --- burn-rate math ---

    @staticmethod
    def _window_counts(book: _Book, now: float,
                       window_s: float) -> tuple:
        lo = int((now - window_s) / _BUCKET_S)
        good = bad = 0
        for b, (g, bd) in book.ring.items():
            if b >= lo:
                good += g
                bad += bd
        return good, bad

    @staticmethod
    def _burn(book: _Book, now: float,
              window_s: float) -> float:
        good, bad = SloEngine._window_counts(book, now, window_s)
        total = good + bad
        if not total:
            return 0.0
        budget = 1.0 - book.slo.objective
        return (bad / total) / budget

    # --- verdicts ---

    def verdicts(self, now=None) -> list:
        """[{name, kind, objective, ok, burn{window: rate},
        fast_tripped, slow_tripped, exemplar_trace_ids, ...}] —
        the ``GET /slo`` payload. Trip TRANSITIONS dump the worst
        recent bad traces through the flight recorder."""
        if now is None:
            now = time.monotonic()
        to_dump: list = []
        out = []
        with self._lock:
            for book in self._books.values():
                slo = book.slo
                burns = {
                    "5m": self._burn(book, now, FAST_WINDOWS[1]),
                    "1h": self._burn(book, now, FAST_WINDOWS[2]),
                    "30m": self._burn(book, now, SLOW_WINDOWS[1]),
                    "6h": self._burn(book, now, SLOW_WINDOWS[2]),
                }
                fast_thr, slow_thr = _trip_thresholds(
                    slo.kind, self.fast_burn, self.slow_burn)
                fast = burns["5m"] >= fast_thr and \
                    burns["1h"] >= fast_thr
                slow = burns["30m"] >= slow_thr and \
                    burns["6h"] >= slow_thr
                if (fast and not book.fast_tripped) or \
                        (slow and not book.slow_tripped):
                    book.trips += 1
                    to_dump.extend(
                        e.trace_id for e in book.exemplars)
                book.fast_tripped = fast
                book.slow_tripped = slow
                entry = {
                    "name": slo.name,
                    "kind": slo.kind,
                    "objective": slo.objective,
                    "ok": not (fast or slow),
                    "burn": {k: round(v, 4)
                             for k, v in burns.items()},
                    "fast_tripped": fast,
                    "slow_tripped": slow,
                    "trips": book.trips,
                    "good": book.good,
                    "bad": book.bad,
                    "exemplar_trace_ids": [e.trace_id for e in
                                           book.exemplars],
                }
                if slo.kind == "latency":
                    entry["threshold_s"] = slo.threshold_s
                if slo.kind == "efficiency":
                    # the MFU-style gauge: useful share of device
                    # wall over the fast window (ms-weighted)
                    entry["efficiency"] = round(_window_share(
                        book, now, FAST_WINDOWS[1]), 4)
                if slo.tenant:
                    entry["tenant"] = slo.tenant
                out.append(entry)
        # dumps OUTSIDE the lock: recorder.dump does file IO
        for trace_id in dict.fromkeys(to_dump):
            self._dump(trace_id)
        return out

    def _dump(self, trace_id: str) -> None:
        if self.recorder is None:
            return
        try:
            self.recorder.dump(trace_id)
            self.dumps += 1
        except (OSError, ValueError):
            # evicted from the ring (or disk trouble): the verdict
            # still carries the trace id for /trace lookup
            pass

    def snapshot(self) -> dict:
        """The /metrics shape: verdict list + dump counter."""
        return {"slos": self.verdicts(), "dumps": self.dumps}

    # --- fleet federation (docs/observability.md "Fleet plane") ---

    def export_state(self, now=None) -> dict:
        """Serializable ring state for federation. Buckets are keyed
        by AGE (now_bucket - bucket) rather than the raw monotonic
        bucket index, because monotonic clocks share no epoch across
        processes — age is the only transferable coordinate, and it
        keeps the export monotonic-only per the clock rule."""
        if now is None:
            now = time.monotonic()
        now_bucket = int(now / _BUCKET_S)
        with self._lock:
            slos = []
            for book in self._books.values():
                s = book.slo
                slos.append({
                    "slo": {"name": s.name, "kind": s.kind,
                            "objective": s.objective,
                            "threshold_s": s.threshold_s,
                            "tenant": s.tenant,
                            "min_priority": s.min_priority},
                    "good": book.good,
                    "bad": book.bad,
                    "buckets": [[now_bucket - b, g, bd]
                                for b, (g, bd) in
                                book.ring.items()],
                    "exemplar_trace_ids": [e.trace_id for e in
                                           book.exemplars],
                })
        return {"bucket_s": _BUCKET_S, "slos": slos}


def merge_exports(exports: list) -> dict:
    """Sum N replicas' :meth:`SloEngine.export_state` documents by
    (SLO name, bucket age). The first export's SLO definition wins
    per name — a fleet is expected to run one config; a replica
    mid-rolling-deploy just contributes its counts."""
    merged: dict = {}
    order: list = []
    for ex in exports:
        if not isinstance(ex, dict):
            continue
        entries = ex.get("slos")
        if not isinstance(entries, list):
            continue
        for entry in entries:
            # peer documents arrive over the network: a malformed
            # entry is dropped, never allowed to poison the merge
            if not isinstance(entry, dict):
                continue
            slo = entry.get("slo") or {}
            if not isinstance(slo, dict):
                continue
            name = str(slo.get("name") or "")
            if not name:
                continue
            slot = merged.get(name)
            if slot is None:
                slot = merged[name] = {
                    "slo": dict(slo), "good": 0, "bad": 0,
                    "_ages": {}, "exemplar_trace_ids": []}
                order.append(name)
            slot["good"] += int(entry.get("good") or 0)
            slot["bad"] += int(entry.get("bad") or 0)
            for age, g, bd in entry.get("buckets") or []:
                acc = slot["_ages"].setdefault(int(age), [0, 0])
                acc[0] += int(g)
                acc[1] += int(bd)
            for tid in entry.get("exemplar_trace_ids") or []:
                if tid not in slot["exemplar_trace_ids"] and \
                        len(slot["exemplar_trace_ids"]) < \
                        _EXEMPLARS:
                    slot["exemplar_trace_ids"].append(tid)
    slos = []
    for name in order:
        slot = merged[name]
        ages = slot.pop("_ages")
        slot["buckets"] = [[a, g, bd] for a, (g, bd) in
                           sorted(ages.items())]
        slos.append(slot)
    return {"bucket_s": _BUCKET_S, "slos": slos}


def verdicts_from_export(export: dict, now=None,
                         fast_burn: float = FAST_WINDOWS[3],
                         slow_burn: float = SLOW_WINDOWS[3]) -> list:
    """Recompute the multi-window burn rates over an exported (or
    merged) bucket set — the SAME `_burn` math `verdicts()` runs, so
    a federated verdict over N replicas equals a single engine fed
    the union event stream (the unit tests prove byte-equality of
    ok/burn/good/bad). Trip latches are per-engine state and are
    reported from the merged counts' instantaneous view."""
    if now is None:
        now = time.monotonic()
    now_bucket = int(now / _BUCKET_S)
    out = []
    for entry in (export or {}).get("slos") or []:
        cfg = dict(entry.get("slo") or {})
        try:
            slo = SLO(name=str(cfg.get("name") or "slo"),
                      kind=str(cfg.get("kind") or "availability"),
                      objective=float(cfg.get("objective") or 0.99),
                      threshold_s=float(cfg.get("threshold_s")
                                        or 0.0),
                      tenant=str(cfg.get("tenant") or ""),
                      min_priority=int(cfg.get("min_priority")
                                       or -(10 ** 9)))
        except ValueError:
            continue
        book = _Book(slo=slo)
        for age, g, bd in entry.get("buckets") or []:
            slot = book.ring.setdefault(now_bucket - int(age),
                                        [0, 0])
            slot[0] += int(g)
            slot[1] += int(bd)
        burns = {
            "5m": SloEngine._burn(book, now, FAST_WINDOWS[1]),
            "1h": SloEngine._burn(book, now, FAST_WINDOWS[2]),
            "30m": SloEngine._burn(book, now, SLOW_WINDOWS[1]),
            "6h": SloEngine._burn(book, now, SLOW_WINDOWS[2]),
        }
        fast_thr, slow_thr = _trip_thresholds(
            slo.kind, fast_burn, slow_burn)
        fast = burns["5m"] >= fast_thr and burns["1h"] >= fast_thr
        slow = burns["30m"] >= slow_thr and \
            burns["6h"] >= slow_thr
        verdict = {
            "name": slo.name,
            "kind": slo.kind,
            "objective": slo.objective,
            "ok": not (fast or slow),
            "burn": {k: round(v, 4) for k, v in burns.items()},
            "fast_tripped": fast,
            "slow_tripped": slow,
            "good": int(entry.get("good") or 0),
            "bad": int(entry.get("bad") or 0),
            "exemplar_trace_ids": list(
                entry.get("exemplar_trace_ids") or []),
        }
        if slo.kind == "latency":
            verdict["threshold_s"] = slo.threshold_s
        if slo.kind == "efficiency":
            verdict["efficiency"] = round(_window_share(
                book, now, FAST_WINDOWS[1]), 4)
        if slo.tenant:
            verdict["tenant"] = slo.tenant
        out.append(verdict)
    return out
