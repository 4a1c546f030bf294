"""Tenancy-aware admission: weighted fair queuing, quotas, rate
limits (reference: ``trivy_tpu/sched/tenant.py``; docs/serving.md
"Multi-tenant QoS").

One abusive client must not starve every other tenant, and overload
must degrade for the OFFENDER, not for everyone. The pieces:

* :class:`TenantQueue` — drop-in replacement for the single FIFO
  admission queue: per-tenant sub-queues scheduled by **stride
  scheduling** (the deterministic cousin of weighted fair queuing —
  each tenant carries a virtual ``pass``; the pop always serves the
  lowest pass and advances it by ``stride = K / weight``, so observed
  service share converges to configured weights under backlog while
  an idle tenant accumulates no credit). Priority classes are
  preserved WITHIN each tenant (higher ``ScanRequest.priority`` pops
  first, FIFO within a class); the coalescer downstream still batches
  across tenants freely — padding buckets don't care who owns a row,
  the queue only decides *ordering*.

* **Admission quotas** — per-tenant ``max_queued`` (queue slots) and
  ``max_inflight`` (admitted-but-unresolved requests, i.e. work
  volume in the pipeline). An over-quota tenant is answered with
  :class:`RateLimitedError` → HTTP 429 + ``Retry-After`` — the same
  language ``artifact/registry.py`` already speaks as a client — so
  it sheds its OWN load while compliant tenants' deadlines hold.
  Only genuine global exhaustion still raises
  :class:`~.queue.QueueFullError` → 503.

* **Token-bucket rate limits** — per-tenant ``rate``/``burst``;
  over-rate arrivals get 429 with a computed ``Retry-After``.

* :class:`TenantBook` — per-tenant admitted/rejected/shed counters
  and request-latency histograms, exported through
  ``ScanScheduler.stats()["tenants"]`` → ``/metrics`` (JSON and
  Prometheus text) as the fairness/autoscaling signal.

Tenant cardinality is bounded: beyond ``max_tenants`` distinct
UNCONFIGURED tenant ids, new ids fold into the shared anonymous
tenant — a client minting random tenant names must not explode the
queue's bookkeeping or the ``/metrics`` label space.
"""

from __future__ import annotations

import heapq
import json
import os
import threading
import time
from dataclasses import dataclass, field, fields, replace
from typing import Optional

from .metrics import LatencyHistogram
from .queue import (QueueFullError, ScanRequest, SchedError,
                    SchedulerClosed)

ANONYMOUS = "anon"

# stride scheduling constant: pass advances by _STRIDE1 / weight per
# pop, so a weight-4 tenant is served 4x as often as a weight-1
# tenant under backlog
_STRIDE1 = float(1 << 20)


class RateLimitedError(SchedError):
    """Per-tenant quota or rate-limit rejection — the tenant's own
    load is shed (HTTP 429 + Retry-After), unlike the global
    QueueFullError 503. Carries the hint the server sends back."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 tenant: str = ""):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.tenant = tenant


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant QoS knobs. Zero means unlimited."""

    name: str = ""
    weight: float = 1.0       # WFQ service share under backlog
    rate: float = 0.0         # token-bucket refill, requests/second
    burst: float = 0.0        # bucket capacity (default: max(rate,1))
    max_queued: int = 0       # admission quota: queued requests
    max_inflight: int = 0     # admission quota: unresolved requests


@dataclass(frozen=True)
class TenancyConfig:
    """The whole tenancy table: explicit tenants + the default
    template unknown tenants instantiate from."""

    tenants: dict = field(default_factory=dict)
    default: TenantConfig = field(default_factory=TenantConfig)
    anonymous: str = ANONYMOUS
    # cap on DYNAMICALLY discovered tenants (configured tenants are
    # always honored); overflow folds into the anonymous tenant
    max_tenants: int = 64

    def for_tenant(self, name: str) -> TenantConfig:
        cfg = self.tenants.get(name)
        if cfg is None:
            cfg = replace(self.default, name=name)
        return cfg


_TENANT_FIELDS = {f.name: f for f in fields(TenantConfig)
                  if f.name != "name"}


def _coerce_tenant_kv(key: str, raw: str):
    f = _TENANT_FIELDS[key]
    if f.type in ("int", int):
        return int(raw)
    return float(raw)


def parse_tenant_config(text) -> TenancyConfig:
    """``--tenant-config`` parser. Accepts either a JSON file path
    (``{"alice": {"weight": 4, "rate": 100}, "default": {...}}``) or
    an inline spec::

        alice:weight=4,rate=100,burst=200,max_queued=64;bob:weight=1
        default:rate=50,max_inflight=128

    Unknown keys and malformed values raise ValueError so a typo'd
    config fails the run up front instead of silently granting
    unlimited service."""
    if isinstance(text, TenancyConfig):
        return text
    text = (text or "").strip()
    if not text:
        return TenancyConfig()
    if os.path.isfile(text):
        with open(text, "r", encoding="utf-8") as f:
            try:
                doc = json.load(f)
            except ValueError as e:
                raise ValueError(
                    f"tenant config {text!r}: invalid JSON ({e})")
        if not isinstance(doc, dict):
            raise ValueError(
                f"tenant config {text!r}: want an object mapping "
                f"tenant -> settings")
        tenants: dict = {}
        default = TenantConfig()
        for name, kv in doc.items():
            if not isinstance(kv, dict):
                raise ValueError(
                    f"tenant {name!r}: want an object of settings")
            bad = set(kv) - set(_TENANT_FIELDS)
            if bad:
                raise ValueError(
                    f"tenant {name!r}: unknown keys {sorted(bad)} "
                    f"(choose from {sorted(_TENANT_FIELDS)})")
            cfg = TenantConfig(name=name, **{
                k: _coerce_tenant_kv(k, str(v))
                for k, v in kv.items()})
            if name == "default":
                default = replace(cfg, name="")
            else:
                tenants[name] = cfg
        return TenancyConfig(tenants=tenants, default=default)
    tenants = {}
    default = TenantConfig()
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, sep, rest = chunk.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"bad tenant-config entry {chunk!r} "
                f"(want name:key=value,...)")
        kv: dict = {}
        for pair in rest.split(","):
            pair = pair.strip()
            if not pair:
                continue
            key, eq, raw = pair.partition("=")
            key = key.strip()
            if not eq or key not in _TENANT_FIELDS:
                raise ValueError(
                    f"bad tenant-config entry {pair!r} for "
                    f"{name!r} (choose from "
                    f"{sorted(_TENANT_FIELDS)})")
            try:
                kv[key] = _coerce_tenant_kv(key, raw.strip())
            except (TypeError, ValueError):
                raise ValueError(
                    f"bad tenant-config value for {name}.{key}: "
                    f"{raw!r}")
        cfg = TenantConfig(name=name, **kv)
        if name == "default":
            default = replace(cfg, name="")
        else:
            tenants[name] = cfg
    return TenancyConfig(tenants=tenants, default=default)


class TokenBucket:
    """Classic token bucket; ``take`` returns 0.0 on admit or the
    seconds until a token will be available (the Retry-After hint).
    Callers serialize access (the queue holds its lock)."""

    def __init__(self, rate: float, burst: float = 0.0):
        self.rate = max(1e-9, float(rate))
        self.burst = float(burst) if burst and burst > 0 \
            else max(self.rate, 1.0)
        self.tokens = self.burst
        self._t = time.monotonic()

    def take(self, n: float = 1.0) -> float:
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


class TenantBook:
    """Per-tenant counters + request-latency histograms. The books
    must balance: for every tenant, ``admitted`` equals
    ``ok + degraded + failed + timed_out + cancelled`` once the
    pipeline drains (rejections never count as admitted)."""

    OUTCOMES = ("ok", "degraded", "failed", "timed_out", "cancelled")
    REJECTIONS = ("rejected_rate", "rejected_quota",
                  "rejected_budget", "rejected_503")

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}      # tenant -> {event: n}
        self._hist: dict = {}          # tenant -> LatencyHistogram

    def _slot(self, tenant: str) -> dict:
        c = self._counters.get(tenant)
        if c is None:
            c = {k: 0 for k in
                 ("admitted",) + self.OUTCOMES + self.REJECTIONS}
            # lint: disable=unbounded-label-cardinality -- tenant
            # ids are pre-folded by TenantQueue._resolve: dynamic
            # overflow past max_tenants lands on the anonymous
            # tenant before any book call sees it
            self._counters[tenant] = c
        return c

    def inc(self, tenant: str, event: str, n: int = 1) -> None:
        with self._lock:
            slot = self._slot(tenant)
            # lint: disable=unbounded-label-cardinality -- event
            # names are code-literal outcome/rejection kinds
            slot[event] = slot.get(event, 0) + n

    def observe(self, tenant: str, seconds: float,
                trace_id: str = "") -> None:
        with self._lock:
            h = self._hist.get(tenant)
            if h is None:
                # lint: disable=unbounded-label-cardinality -- ids
                # pre-folded to max_tenants (anon) upstream
                h = self._hist[tenant] = LatencyHistogram()
            h.observe(seconds, exemplar=trace_id)

    def hist_snapshot(self) -> dict:
        """Raw per-tenant bucket counts for the Prometheus
        histogram family (obs/prom.py), with trace-id exemplars."""
        with self._lock:
            return {t: h.raw() for t, h in self._hist.items()}

    def snapshot(self, live: Optional[dict] = None) -> dict:
        """``{tenant: {counters, shed, latency, [depth/inflight/
        weight from ``live``]}}``. ``shed`` is the total load the
        tenant itself absorbed as 429s."""
        with self._lock:
            out = {}
            names = set(self._counters) | set(live or {})
            for t in names:
                c = dict(self._slot(t))
                h = self._hist.get(t)
                entry = {
                    "counters": c,
                    "shed": c["rejected_rate"] + c["rejected_quota"]
                    + c["rejected_budget"],
                    "latency": h.to_dict() if h is not None
                    else LatencyHistogram().to_dict(),
                }
                if live and t in live:
                    entry.update(live[t])
                out[t] = entry
            return out


class _Sub:
    """One tenant's sub-queue: a priority heap plus the stride and
    quota state. All fields are guarded by the TenantQueue lock."""

    __slots__ = ("cfg", "heap", "pass_value", "stride", "bucket",
                 "queued", "inflight")

    def __init__(self, cfg: TenantConfig, vtime: float):
        self.cfg = cfg
        self.heap: list = []      # (-priority, seq, req)
        self.pass_value = vtime
        self.stride = _STRIDE1 / max(cfg.weight, 1e-6)
        self.bucket = TokenBucket(cfg.rate, cfg.burst) \
            if cfg.rate > 0 else None
        self.queued = 0
        self.inflight = 0


class TenantQueue:
    """The tenancy-aware admission queue (put/get/depth/close).
    With the default TenancyConfig every request lands on one
    unlimited anonymous tenant and behavior reduces EXACTLY to the
    old bounded FIFO — the parity suites ride on that, and the
    package exports ``AdmissionQueue`` as an alias for it."""

    def __init__(self, maxsize: int = 256,
                 tenancy: Optional[TenancyConfig] = None):
        self.maxsize = max(1, int(maxsize))
        self.tenancy = tenancy or TenancyConfig()
        self.book = TenantBook()
        self._cv = threading.Condition()
        self._subs: dict = {}          # tenant -> _Sub
        self._total = 0
        self._vtime = 0.0              # pass of the last pop
        self._seq = 0
        self._closed = False
        # device-second budgets (--tenant-budget, obs/cost.py):
        # tenant -> TenantBudget, read against the cost ledger's
        # windowed books at admission
        self._budgets: dict = {}
        self._cost_ledger = None

    def configure_budgets(self, budgets: dict, ledger) -> None:
        """Arm budget admission: ``budgets`` maps tenant →
        :class:`~trivy_tpu_torch.obs.cost.TenantBudget`; ``ledger`` is
        the :class:`~trivy_tpu_torch.obs.cost.CostLedger` whose windowed
        device-second books the check reads."""
        self._budgets = dict(budgets or {})
        self._cost_ledger = ledger

    # --- tenant resolution (under lock) ---

    def _resolve(self, req: ScanRequest) -> tuple:
        tenant = getattr(req, "tenant", "") or self.tenancy.anonymous
        if tenant not in self._subs \
                and tenant not in self.tenancy.tenants \
                and tenant != self.tenancy.anonymous \
                and len(self._subs) >= self.tenancy.max_tenants:
            # tenant-cardinality bound: dynamic overflow folds into
            # the anonymous tenant (and shares its quotas) instead of
            # growing the books without bound
            tenant = self.tenancy.anonymous
        req.tenant = tenant
        sub = self._subs.get(tenant)
        if sub is None:
            sub = _Sub(self.tenancy.for_tenant(tenant), self._vtime)
            self._subs[tenant] = sub
        return tenant, sub

    # --- admission ---

    def put(self, req: ScanRequest, block: bool = False,
            timeout: Optional[float] = None) -> None:
        # admission accounting (TenantBook takes its own lock) is
        # booked AFTER the cv releases (lint: lock-discipline) —
        # the decision is made under the lock, the book entry
        # follows microseconds later, and books still balance
        # because every exit path below sets exactly one event
        tenant = ""
        event = ""
        try:
            # budget gate BEFORE the cv: the windowed-spend read
            # takes the cost ledger's own lock, and lock discipline
            # forbids acquiring another module's lock under ours.
            # The read is microseconds stale by admission time —
            # budgets are a 10s-bucketed signal, staleness within
            # one lock handoff is noise
            budget = self._budgets.get(
                getattr(req, "tenant", "")
                or self.tenancy.anonymous) \
                if self._budgets else None
            if budget is not None and self._cost_ledger is not None:
                spend = self._cost_ledger.window_device_s(
                    budget.tenant, budget.window_s)
                if spend >= budget.device_s:
                    if budget.action == "throttle":
                        tenant = budget.tenant
                        event = "rejected_budget"
                        e = RateLimitedError(
                            f"tenant {budget.tenant!r} over "
                            f"device-second budget "
                            f"({spend:.3f}s of {budget.device_s:g}s"
                            f" per {budget.window_s:g}s)",
                            retry_after_s=max(
                                1.0, min(budget.window_s / 4,
                                         10.0)),
                            tenant=budget.tenant)
                        e.book_event = "rejected_budget"
                        raise e
                    # deprioritize: admit, but at the budget's
                    # priority floor — the request yields inside
                    # its own tenant lane until the spend ages out
                    if int(getattr(req, "priority", 0) or 0) \
                            > budget.floor:
                        req.priority = budget.floor
            with self._cv:
                if self._closed:
                    raise SchedulerClosed("scheduler is closed")
                tenant, sub = self._resolve(req)
                cfg = sub.cfg
                # per-tenant gates FIRST: an over-limit tenant gets
                # its own 429 even when the queue is also globally
                # full — the shed must land on the offender
                if sub.bucket is not None:
                    wait = sub.bucket.take()
                    if wait > 0.0:
                        event = "rejected_rate"
                        raise RateLimitedError(
                            f"tenant {tenant!r} over rate limit "
                            f"({cfg.rate:g}/s)",
                            retry_after_s=wait, tenant=tenant)
                self._check_quotas(tenant, sub)
                if not block and self._total >= self.maxsize:
                    event = "rejected_503"
                    raise QueueFullError(
                        f"scan queue full "
                        f"({self.maxsize} pending)")
                deadline = (time.monotonic() + timeout
                            if timeout is not None else None)
                waited = False
                while self._total >= self.maxsize:
                    remaining = None if deadline is None else \
                        deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        event = "rejected_503"
                        raise QueueFullError(
                            f"scan queue full "
                            f"({self.maxsize} pending)")
                    self._cv.wait(remaining)
                    waited = True
                    if self._closed:
                        raise SchedulerClosed(
                            "scheduler is closed")
                if waited:
                    # re-check the quotas after any blocking wait:
                    # N waiters could all have passed the pre-wait
                    # check against the same headroom and overshoot
                    # the quota by N-1 once capacity frees
                    self._check_quotas(tenant, sub)
                if not sub.queued:
                    # (re)activation: an idle tenant resumes at the
                    # CURRENT virtual time — idleness earns no
                    # credit, so a returning tenant cannot
                    # monopolize the queue
                    sub.pass_value = max(sub.pass_value,
                                         self._vtime)
                self._seq += 1
                heapq.heappush(
                    sub.heap,
                    (-int(getattr(req, "priority", 0) or 0),
                     self._seq, req))
                sub.queued += 1
                sub.inflight += 1
                self._total += 1
                event = "admitted"
                self._cv.notify_all()
        except BaseException as e:
            # quota rejections raised inside _check_quotas carry
            # their book event; closed-scheduler exits book nothing
            event = getattr(e, "book_event", event)
            raise
        finally:
            if tenant and event:
                self.book.inc(tenant, event)

    def _check_quotas(self, tenant: str, sub: "_Sub") -> None:
        """Admission quotas, under the queue lock. Raises the typed
        429 — tagged with its book event, which ``put`` records
        once the lock is released — so the tenant sheds its own
        load."""
        cfg = sub.cfg
        if cfg.max_queued and sub.queued >= cfg.max_queued:
            e = RateLimitedError(
                f"tenant {tenant!r} queue quota reached "
                f"({cfg.max_queued} queued)",
                retry_after_s=self._quota_hint(cfg),
                tenant=tenant)
            e.book_event = "rejected_quota"
            raise e
        if cfg.max_inflight and sub.inflight >= cfg.max_inflight:
            e = RateLimitedError(
                f"tenant {tenant!r} in-flight quota reached "
                f"({cfg.max_inflight} unresolved)",
                retry_after_s=self._quota_hint(cfg),
                tenant=tenant)
            e.book_event = "rejected_quota"
            raise e

    def _quota_hint(self, cfg: TenantConfig) -> float:
        # Retry-After for a quota rejection: the time the tenant's
        # own rate limit needs to drain one slot, or a 1s default
        # when it has no rate limit (quota pressure clears with
        # service, which we cannot predict cheaply)
        if cfg.rate > 0:
            return max(0.05, 1.0 / cfg.rate)
        return 1.0

    # --- service (the WFQ pop) ---

    def get(self, timeout: Optional[float] = None)\
            -> Optional[ScanRequest]:
        with self._cv:
            if not self._total and (timeout is None or timeout > 0):
                self._cv.wait(timeout)
            if not self._total:
                return None
            best = None
            for sub in self._subs.values():
                if sub.queued and (best is None or
                                   sub.pass_value < best.pass_value):
                    best = sub
            _, _, req = heapq.heappop(best.heap)
            best.queued -= 1
            self._total -= 1
            self._vtime = best.pass_value
            best.pass_value += best.stride
            self._cv.notify_all()
            return req

    # --- resolution bookkeeping (scheduler calls exactly once) ---

    def note_done(self, req: ScanRequest, outcome: str,
                  latency_s: Optional[float] = None) -> None:
        """Release the request's in-flight quota slot and book its
        outcome + latency on its tenant. Idempotent per request —
        double resolution races count once."""
        tenant = getattr(req, "tenant", "") or self.tenancy.anonymous
        with self._cv:
            if getattr(req, "_tenant_released", False):
                return
            req._tenant_released = True
            sub = self._subs.get(tenant)
            if sub is not None and sub.inflight > 0:
                sub.inflight -= 1
        self.book.inc(tenant, outcome)
        if latency_s is not None:
            self.book.observe(tenant, latency_s,
                              trace_id=getattr(req, "trace_id",
                                               "") or "")

    # --- introspection ---

    def depth(self) -> int:
        with self._cv:
            return self._total

    def tenant_depths(self) -> dict:
        with self._cv:
            return {t: {"queue_depth": sub.queued,
                        "inflight": sub.inflight,
                        "weight": sub.cfg.weight}
                    for t, sub in self._subs.items()}

    def tenant_snapshot(self) -> dict:
        return self.book.snapshot(self.tenant_depths())

    # --- lifecycle ---

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
