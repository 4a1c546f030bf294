"""RPC server (reference: pkg/rpc/server/{listen.go,server.go}; the
JAX package's ``rpc/server.py``).

``python -m trivy_tpu_torch server`` owns the blob cache, the advisory
store (behind ``SwappableStore`` so a rebuilt compiled DB hot-swaps
between requests, listen.go:54-83's RW-waitgroup analog), and the
card's dispatch. Thin clients push BlobInfos over the Cache service
and ask the Scanner service to scan — server.go:37-48 runs the same
local scanner against the server-side cache, and so does this; with
``sched="on"`` concurrent Scan RPCs coalesce through the port's
scheduler into shared interval dispatches.

The wire (routes, bodies, status codes, headers) is the reference's,
so either package's client talks to either package's server. One
departure: a Scan body's ``backend`` picks where the request runs —
``cuda``, ``cpu`` or ``cpu-ref``, with the reference's ``tpu`` (its
clients' default) taken as the card — and any other value answers
400, never a silent CPU run. ``POST /registry/notifications`` (a
``watch.WebhookSource``) and ``POST /k8s/admission`` (a
``watch.AdmissionController``) answer when the server holds their
owner, 404 otherwise, as the reference's; a ``fault_injector``
(``faults.FaultInjector``, ``--fault-spec``) decides per POST whether
to answer 500 unprocessed or to drop the response after processing.
The fleet routes are the reference's: ``GET /impact?cve=`` answers
from an ``impact.ImpactIndex`` (404 without one), ``GET
/metrics/federate`` from an ``obs.federate.Federator`` (404 without
peers), ``GET /metrics/snapshot`` is the pull a federating front
makes and ``GET /clock`` the monotonic clock probe. With
``prewarm_members`` the server walks its post-join slice of the
shared memo tier and stages its resident tables before ``/healthz``
says ``ok`` (``warming`` until then).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..artifact.cache import FSCache, MemoryCache
from ..db import AdvisoryStore, CompiledDB
from ..sched import QueueFullError, RateLimitedError
from ..db.compiled import SwappableStore
from ..scan.local import LocalScanner, ScanTarget
from ..types import ScanOptions
from ..types.convert import (artifact_info_from_dict,
                             blob_info_from_dict)
from ..obs.propagate import TRACEPARENT_HEADER
from ..obs.propagate import extract as extract_context

log = logging.getLogger("trivy_tpu_torch.rpc.server")

SCANNER_PREFIX = "/twirp/trivy.scanner.v1.Scanner/"
CACHE_PREFIX = "/twirp/trivy.cache.v1.Cache/"
DEFAULT_TOKEN_HEADER = "Trivy-Token"
# tenant identity rides this header (or the body's "tenant" field,
# which wins); absent both, the scan lands on the shared anonymous
# tenant (docs/serving.md "Multi-tenant QoS")
TENANT_HEADER = "Trivy-Tenant"
IDEMPOTENCY_TTL_S = 300.0
# per-tenant idempotency-window entry cap: a flooding tenant evicts
# its OWN oldest entries, never another tenant's dedup window
IDEMPOTENCY_TENANT_CAP = 1024
# bound on distinct tenants tracked by the idempotency window (LRU
# tenant eviction) — client-minted tenant ids must not grow it
# without bound
IDEMPOTENCY_MAX_TENANTS = 512


def _clean_tenant(raw) -> str:
    """Normalize a client-supplied tenant id: printable, trimmed,
    bounded — it becomes a metrics label and a bookkeeping key."""
    t = "".join(c for c in str(raw or "") if c.isprintable()).strip()
    return t[:64]
# admission control (docs/robustness.md "Untrusted input"): requests
# beyond these caps answer 413 BEFORE any body is read or work is
# queued — an oversized body or a 100k-blob Scan must cost the
# server a header read, not memory or queue slots
MAX_BODY_BYTES = 64 << 20
MAX_SCAN_BLOBS = 1024
# where a Scan body may ask to run: the port's backends, and the
# reference clients' default ``tpu`` as this server's accelerator
BODY_BACKENDS = {"tpu": "cuda", "cuda": "cuda", "cpu": "cpu",
                 "cpu-ref": "cpu-ref"}


def body_backend(raw) -> str:
    """The backend a Scan body asks for, or ``BadRequest`` (400)."""
    backend = BODY_BACKENDS.get(str(raw))
    if backend is None:
        raise BadRequest(f"unknown backend {str(raw)[:32]!r} (one of "
                         f"{', '.join(sorted(BODY_BACKENDS))})")
    return backend


class ServerDraining(RuntimeError):
    """New work refused: the server is shutting down (503)."""


class RequestTooLarge(ValueError):
    """Request exceeds the admission caps (413)."""


class BadRequest(ValueError):
    """A request the server cannot run as asked (400)."""


class _IdemEntry:
    """One idempotent Scan in flight or completed: duplicate keys
    wait on the event and replay the stored outcome."""

    def __init__(self, ttl_s: float):
        self.expires = time.monotonic() + ttl_s
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def resolve(self, result=None,
                error: Optional[BaseException] = None) -> None:
        self._result = result
        self._error = error
        self._event.set()

    def outcome(self, timeout: float):
        if not self._event.wait(timeout):
            raise RuntimeError(
                "idempotent request still in flight")
        if self._error is not None:
            raise self._error
        return self._result


class _IdempotencyCache:
    """Dedup window for RPC Scan: the client's 5xx retry loop can
    resend a request whose response was lost AFTER the server
    enqueued it — without this, every lost response double-enqueues
    the scan into the scheduler.

    The window is **per-tenant**: a key collision across tenants
    must never replay another tenant's cached result, and each
    tenant's entries are capped (own-oldest eviction) so one tenant
    flooding fresh keys cannot evict others' dedup windows."""

    def __init__(self, ttl_s: float = IDEMPOTENCY_TTL_S,
                 per_tenant_cap: int = IDEMPOTENCY_TENANT_CAP,
                 max_tenants: int = IDEMPOTENCY_MAX_TENANTS):
        from collections import OrderedDict
        self.ttl_s = ttl_s
        self.per_tenant_cap = max(1, per_tenant_cap)
        self.max_tenants = max(1, max_tenants)
        self._lock = threading.Lock()
        # tenant (LRU) -> key (insertion order) -> _IdemEntry
        self._tenants: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.evictions = 0

    def _bucket(self, tenant: str):
        from collections import OrderedDict
        bucket = self._tenants.get(tenant)
        if bucket is None:
            bucket = self._tenants[tenant] = OrderedDict()
            while len(self._tenants) > self.max_tenants:
                # evict the least-recently-used TENANT wholesale —
                # isolation is preserved (buckets are never merged)
                _, dropped = self._tenants.popitem(last=False)
                self.evictions += len(dropped)
        else:
            self._tenants.move_to_end(tenant)
        return bucket

    def claim(self, key: str, tenant: str = "") -> tuple:
        """(fresh, entry): fresh means the caller runs the scan and
        resolves the entry; otherwise it waits on the entry."""
        now = time.monotonic()
        with self._lock:
            for t in list(self._tenants):
                bucket = self._tenants[t]
                # entries share one TTL, so insertion order IS
                # expiry order: pop from the front and stop at the
                # first live entry — O(expired), not O(all), which
                # matters because this sweep runs under the global
                # lock on every Scan RPC
                while bucket:
                    k, e = next(iter(bucket.items()))
                    if e.expires > now:
                        break
                    del bucket[k]
                if not bucket:
                    del self._tenants[t]
            bucket = self._bucket(tenant)
            entry = bucket.get(key)
            if entry is not None:
                self.hits += 1
                return False, entry
            entry = _IdemEntry(self.ttl_s)
            bucket[key] = entry
            while len(bucket) > self.per_tenant_cap:
                bucket.popitem(last=False)
                self.evictions += 1
            return True, entry

    def forget(self, key: str, tenant: str = "") -> None:
        with self._lock:
            bucket = self._tenants.get(tenant)
            if bucket is not None:
                bucket.pop(key, None)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": sum(len(b)
                                   for b in self._tenants.values()),
                    "tenants": len(self._tenants),
                    "hits": self.hits,
                    "evictions": self.evictions,
                    "per_tenant_cap": self.per_tenant_cap,
                    "ttl_s": self.ttl_s}


class ScanServer:
    """Request handlers + the swappable store. HTTP-framework-free so
    tests can drive it directly.

    With ``sched="on"`` Scan requests route through the continuous-
    batching scheduler (``sched/``): concurrent RPC scans
    coalesce into shared interval dispatches, a full admission queue
    answers 503 (the client's transient-retry code), and per-request
    ``deadline_s`` from the body is honored. ``sched="off"`` keeps
    the direct one-scan-at-a-time path for differential testing.

    ``backend`` is where the server's own scheduler and boot warm-up
    run (``cuda`` by default: without a card the constructor raises);
    a request runs on its body's backend (``body_backend``).
    ``compile_cache_dir`` builds (or loads) both kernels and
    warm-launches them at boot (``runtime/aot.py``); a kernel that
    does not build or launch raises here."""

    def __init__(self, store=None, cache=None,
                 cache_dir: str = "", token: str = "",
                 token_header: str = DEFAULT_TOKEN_HEADER,
                 sched: str = "off", sched_config=None,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 max_scan_blobs: int = MAX_SCAN_BLOBS,
                 tracer=None, slos=None, memo=None,
                 replica_name: str = "self",
                 compile_cache_dir: str = "",
                 backend: str = "cuda", admission=None,
                 watch_source=None, federator=None, impact=None,
                 prewarm_members=None,
                 prewarm_deadline_s: float = 5.0):
        if backend == "cuda":
            from .. import resolve_device
            resolve_device(backend)         # no card: fail the boot
        self.backend = backend
        self.max_body_bytes = max_body_bytes
        self.max_scan_blobs = max_scan_blobs
        if isinstance(store, SwappableStore):
            self.store = store
        else:
            self.store = SwappableStore(store if store is not None
                                        else AdvisoryStore())
        if cache is None:
            cache = FSCache(cache_dir) if cache_dir else MemoryCache()
        self.cache = cache
        # memo: memo.FindingsMemo (or None) — per-layer
        # detection-verdict memoization for every scan path, with
        # the advisory-delta re-match registered on the store's hot
        # swap (docs/performance.md "Findings memoization")
        self.memo = memo
        if memo is not None:
            from ..db.lifecycle import attach_memo
            attach_memo(self.store, memo)
        self.token = token
        self.token_header = token_header
        self._idem = _IdempotencyCache()
        self._draining = False
        # Scan RPCs currently being served; mirrored into /healthz
        # (with the draining flag) so a scan router can stop routing
        # NEW work here before the 503s start, and can tell when a
        # draining replica has quiesced
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # fault_injector: faults.FaultInjector (or None); the HTTP
        # handler consults it per POST (--fault-spec)
        self.fault_injector = None
        self.scheduler = None
        self._owns_scheduler = False
        if hasattr(sched, "submit"):        # a ScanScheduler
            self.scheduler = sched          # shared — caller closes
        elif sched not in (None, "off", False):
            from ..sched import ScanScheduler, SchedConfig
            cfg = sched_config
            if isinstance(sched, SchedConfig):
                cfg = sched
            self.scheduler = ScanScheduler(config=cfg,
                                           backend=backend,
                                           tracer=tracer)
            self._owns_scheduler = True
        # tracer (docs/observability.md): Scan RPCs propagate the
        # client's trace_id into per-request span trees, served back
        # at GET /trace/<id>; a shared scheduler's tracer wins so
        # both request sources land in one flight recorder
        if tracer is None:
            if self.scheduler is not None:
                tracer = self.scheduler.tracer
            else:
                from ..obs.trace import get_tracer
                tracer = get_tracer()
        self.tracer = tracer
        # SLO burn-rate engine (docs/observability.md "SLOs & burn
        # rates"): scheduled servers share the scheduler's engine;
        # sched-off servers keep their own so GET /slo answers on
        # both paths. ``slos`` is a list of obs.slo.SLO
        # (--slo-config); None = the default pair
        if self.scheduler is not None:
            if slos is not None:
                if not self._owns_scheduler:
                    # a shared scheduler's engine holds live burn
                    # windows, trip latches and exemplars other
                    # request sources depend on — silently swapping
                    # it would reset every SLO to "ok"; the caller
                    # must configure the scheduler it owns
                    raise ValueError(
                        "slos= conflicts with a shared scheduler; "
                        "configure the scheduler's own SLO engine")
                from ..obs.slo import SloEngine
                self.scheduler.slo = SloEngine(
                    slos, recorder=self.tracer.recorder)
            self.slo = self.scheduler.slo
        else:
            from ..obs.slo import SloEngine
            self.slo = SloEngine(slos,
                                 recorder=self.tracer.recorder)
        # the always-on sampling host profiler backing
        # GET /debug/profile (TRIVY_TPU_PROFILE=off disables)
        from ..obs.profiler import get_profiler
        self.profiler = get_profiler()
        # continuous scanning (docs/serving.md "Continuous scanning &
        # admission control"): admission: watch.AdmissionController
        # answering POST /k8s/admission (404 when unset);
        # watch_source: watch.WebhookSource fed by POST
        # /registry/notifications (404 when unset)
        self.admission = admission
        self.watch_source = watch_source
        # fleet federation (docs/observability.md "Fleet plane"):
        # an obs.federate.Federator makes this replica a federating
        # front — GET /metrics/federate pulls every peer's snapshot
        # and serves the merged exposition + fleet SLO verdicts
        self.federator = federator
        self.replica_name = replica_name
        # inverted impact index (docs/serving.md "CVE impact
        # queries"): GET /impact?cve= answers this replica's owned
        # slice; the memo maintains the index write-through
        self.impact = impact
        if impact is not None and memo is not None:
            memo.attach_impact(impact)
        # elastic lifecycle (docs/serving.md "Elastic lifecycle"):
        # the hot-digest recency book (exported on GET /handoff so a
        # drain's ring successors prefetch the moving working set),
        # the boot-time kernel build + warm launch into a persistent
        # build directory, and the pre-join memo prewarm that keeps
        # /healthz in the ``warming`` state until the post-join key
        # ranges are staged (or the deadline bounds the walk into a
        # cold join)
        from ..memo.warmth import HotSet
        self.hot = HotSet()
        self._warming = False
        self.compile_cache: dict = {}
        if compile_cache_dir:
            from ..runtime.aot import boot_precompile
            from ..secret.batch import BatchSecretScanner
            # the builtin rules' sieve table: the one a client's
            # secret scan launches on this card
            sieve = BatchSecretScanner(backend=backend)
            self.compile_cache = boot_precompile(
                cache_dir=compile_cache_dir, dfa_table=sieve.table,
                run_specs=tuple(sieve.plan.run_specs), backend=backend)
        if prewarm_members and self.memo is not None:
            self._warming = True
            threading.Thread(
                target=self._prewarm,
                args=(list(prewarm_members),
                      max(0.0, prewarm_deadline_s)),
                daemon=True,
                name="scan-server-prewarm").start()

    def _prewarm(self, members, deadline_s: float) -> None:
        """Pre-join prewarm: the memo KEYSPACE is partitioned by
        hashing key strings on the post-join ring (deterministic
        cross-process, like request routing — though keys hash
        independently of the route digests), the resident advisory
        and DFA tables are staged on the server's device (the card
        on ``cuda``; ``cpu-ref`` reads no resident tensor), and the
        owned slice is walked out of the shared tier (staging page
        and transport caches and proving reachability). Only then
        does /healthz flip from ``warming`` — bounded by
        ``deadline_s``, so a degraded memo tier costs warmth, never
        the scale-up."""
        from ..memo.warmth import range_walk
        from ..router.lifecycle import LIFECYCLE_METRICS
        from ..router.ring import Ring
        LIFECYCLE_METRICS.inc("prewarm_runs")
        try:
            ring = Ring()
            for m in members:
                ring.add(str(m))
            ring.add(self.replica_name)
            if self.backend != "cpu-ref":
                from ..ops.resident import prewarm_resident
                prewarm_resident(self.backend)
            res = range_walk(
                self.memo.store,
                lambda k: ring.owner(k) == self.replica_name,
                deadline_s)
            LIFECYCLE_METRICS.inc("prewarm_keys", res["keys"])
            LIFECYCLE_METRICS.inc("prewarm_bytes", res["bytes"])
            LIFECYCLE_METRICS.add_seconds(res["seconds"])
            if res["deadline_exceeded"]:
                LIFECYCLE_METRICS.inc("prewarm_deadline_exceeded")
            if not res["complete"]:
                LIFECYCLE_METRICS.inc("prewarm_cold_joins")
            log.info("prewarm as %s: %d keys, %d bytes in %.3f s "
                     "(complete=%s)", self.replica_name, res["keys"],
                     res["bytes"], res["seconds"], res["complete"])
        finally:
            # ready is unconditional: prewarm buys warmth, it never
            # gates liveness past its deadline
            self._warming = False

    def build_info(self) -> dict:
        """The trivy_tpu_build_info identity labels (also mirrored
        into the /healthz JSON so probes see versions token-free)."""
        from ..sched.metrics import build_info
        return build_info(
            backend=self.backend,
            sched="on" if self.scheduler is not None else "off")

    def health(self) -> dict:
        """The ``GET /healthz`` payload. ``draining`` flips the
        moment :meth:`begin_drain` runs — while the listener is
        still up delivering in-flight responses — so a router
        watching this field stops sending NEW work before it ever
        sees a drain 503. ``inflight`` counts Scan RPCs currently
        being served (a drained replica is safe to stop when it
        reaches zero)."""
        with self._inflight_lock:
            inflight = self._inflight
        if self._draining:
            status = "draining"
        elif self._warming:
            status = "warming"
        else:
            status = "ok"
        return {"status": status,
                "draining": self._draining,
                "warming": self._warming,
                "inflight": inflight,
                "build": self.build_info()}

    def close(self) -> None:
        # only tear down a scheduler this server constructed — an
        # externally provided one may serve other request sources
        if self.scheduler is not None and self._owns_scheduler:
            self.scheduler.close()

    def begin_drain(self) -> None:
        """New Scan RPCs answer 503 from here on; queued and
        in-flight work keeps running until shutdown_gracefully."""
        self._draining = True

    def handoff(self) -> dict:
        """``GET /handoff`` — the hot-digest export (recency order,
        hottest last) a drain orchestrator feeds to
        ``router.lifecycle.plan_handoff`` so ring successors warm
        up while this replica's in-flight work finishes."""
        from ..router.lifecycle import LIFECYCLE_METRICS
        digests = self.hot.export()
        LIFECYCLE_METRICS.inc("handoff_published", len(digests))
        return {"name": self.replica_name,
                "draining": self._draining,
                "digests": digests}

    def prefetch(self, body: dict) -> dict:
        """``POST /prefetch`` — take a departing peer's hot digests
        into this replica's hot book. The verdict payloads live in
        the SHARED memo tier, so adoption is bookkeeping, not a
        copy: the next scan of an adopted digest is a memo hit."""
        from ..router.lifecycle import LIFECYCLE_METRICS
        digests = [str(d) for d in body.get("digests") or [] if d]
        for d in digests:
            self.hot.touch(d)
        LIFECYCLE_METRICS.inc("handoff_prefetched", len(digests))
        return {"accepted": len(digests),
                "name": self.replica_name}

    def shutdown_gracefully(self, timeout_s: float = 30.0) -> bool:
        """SIGTERM path: 503 new work, drain the admission queue,
        flush in-flight batches, then close. True when everything
        drained inside the timeout."""
        self.begin_drain()
        drained = True
        if self.scheduler is not None:
            drained = self.scheduler.drain(timeout_s)
        self.close()
        return drained

    # ---- Cache service (service.proto:10-15) ----

    def put_artifact(self, body: dict) -> dict:
        info = artifact_info_from_dict(body.get("artifact_info") or {})
        self.cache.put_artifact(body.get("artifact_id", ""), info)
        return {}

    def put_blob(self, body: dict) -> dict:
        blob = blob_info_from_dict(body.get("blob_info") or {})
        self.cache.put_blob(body.get("diff_id", ""), blob)
        return {}

    def missing_blobs(self, body: dict) -> dict:
        missing_artifact, missing = self.cache.missing_blobs(
            body.get("artifact_id", ""), body.get("blob_ids") or [])
        return {"missing_artifact": missing_artifact,
                "missing_blob_ids": list(missing)}

    def delete_blobs(self, body: dict) -> dict:
        self.cache.delete_blobs(body.get("blob_ids") or [])
        return {}

    # ---- Scanner service (service.proto:8-29) ----

    def scan(self, body: dict) -> dict:
        """Scan entry: drain gate + idempotent replay around the
        actual scan. A duplicate key within the TTL never reaches
        the scheduler — the retry that follows a lost response waits
        on (or replays) the first enqueue's outcome instead."""
        if self._draining:
            raise ServerDraining("server draining, retry elsewhere")
        blob_ids = body.get("blob_ids") or []
        if blob_ids:
            # hot-digest book: the base layer digest is the route
            # key a scale-down's successors prefetch on
            self.hot.touch(str(blob_ids[0]))
        with self._inflight_lock:
            self._inflight += 1
        try:
            return self._scan_idempotent(body)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _scan_idempotent(self, body: dict) -> dict:
        tenant = _clean_tenant(body.get("tenant"))
        key = str(body.get("idempotency_key") or "")[:128]
        if not key:
            return self._scan(body)
        fresh, entry = self._idem.claim(key, tenant)
        if not fresh:
            return entry.outcome(timeout=self._idem.ttl_s)
        try:
            out = self._scan(body)
        except BaseException as e:
            # only SUCCESS is worth replaying: the lost-response
            # hazard this cache exists for applies to work that was
            # enqueued and completed. Caching an error would make a
            # transient server-side failure terminal for the whole
            # retry loop (every retry reuses the key); forget the
            # entry so the next attempt re-runs, and resolve any
            # concurrent duplicate waiters with this outcome
            self._idem.forget(key, tenant)
            entry.resolve(error=e)
            raise
        entry.resolve(result=out)
        return out

    def _scan(self, body: dict) -> dict:
        opts = body.get("options") or {}
        options = ScanOptions(
            vuln_type=opts.get("vuln_type") or ["os", "library"],
            security_checks=opts.get("security_checks") or ["vuln"],
            list_all_packages=opts.get("list_all_packages", False),
            scan_removed_packages=opts.get(
                "scan_removed_packages", False),
            backend=body_backend(opts.get("backend", "tpu")),
        )
        blob_ids = body.get("blob_ids") or []
        if len(blob_ids) > self.max_scan_blobs:
            raise RequestTooLarge(
                f"scan request lists {len(blob_ids)} blobs "
                f"(max {self.max_scan_blobs})")
        target = ScanTarget(name=body.get("target", ""),
                            artifact_id=body.get("artifact_id", ""),
                            blob_ids=blob_ids)
        if self.scheduler is not None:
            return self._scan_scheduled(target, options, body)
        # readers hold the store across the whole scan; swap waits
        # for them to drain (SwappableStore), like the server's
        # dbUpdateWg/requestWg pair
        ctx = extract_context(body)
        root = self.tracer.start_request(
            target.name, trace_id=ctx.trace_id,
            parent_span_id=ctx.parent_span_id)
        db = self.store.acquire()
        t0 = time.monotonic()
        tenant = _clean_tenant(body.get("tenant"))
        try:
            with root.activate():
                scanner = LocalScanner(self.cache, db,
                                       memo=self.memo,
                                       tenant=tenant)
                results, os_found = scanner.scan(target, options)
        except BaseException:
            root.end("failed")
            self.slo.record("failed",
                            latency_s=time.monotonic() - t0,
                            tenant=tenant,
                            trace_id=root.trace_id)
            raise
        finally:
            self.store.release()
        root.end()
        self.slo.record("ok", latency_s=time.monotonic() - t0,
                        tenant=tenant, trace_id=root.trace_id)
        return {
            "os": os_found.to_dict() if os_found else None,
            "results": [r.to_dict() for r in results],
        }

    def _scan_scheduled(self, target, options, body: dict) -> dict:
        """One Scan RPC → one scheduler request; concurrent handler
        threads coalesce into shared device dispatches. The store
        reader is held from admission to resolution so a DB hot-swap
        still waits for in-flight scheduled scans."""
        from ..sched import AnalyzedWork, ScanRequest

        db = self.store.acquire()
        tenant = _clean_tenant(body.get("tenant"))

        def analyze(req):
            scanner = LocalScanner(self.cache, db,
                                   memo=self.memo, tenant=tenant)
            prepared = scanner.prepare(target, options)

            def finish(found, detected):
                results, os_found = scanner.finish(prepared,
                                                   detected)
                return {
                    "os": os_found.to_dict() if os_found else None,
                    "results": [r.to_dict() for r in results],
                }

            return AnalyzedWork(jobs=prepared.jobs, finish=finish,
                                group=options.backend)

        try:
            priority = int(body.get("priority") or 0)
        except (TypeError, ValueError):
            priority = 0
        req = ScanRequest(
            name=target.name, analyze=analyze,
            deadline_s=float(body.get("deadline_s") or 0.0),
            group=options.backend,
            on_done=lambda _req: self.store.release(),
            # tenant identity (body field, or the Trivy-Tenant
            # header the handler folded in): the scheduler's WFQ
            # orders per tenant, quotas answer 429 + Retry-After.
            # Priority jumps the line only WITHIN the tenant.
            tenant=tenant,
            priority=max(-100, min(100, priority)),
            # the client's propagated context rides the body
            # (traceparent, or the legacy bare trace_id); the
            # scheduler's tracer validates both ids (hex only — the
            # trace id becomes a dump file name) and roots this
            # request's span tree under the caller's span
            trace_id=extract_context(body).trace_id[:64],
            parent_span_id=extract_context(body)
            .parent_span_id[:64])
        try:
            self.scheduler.submit(req)
        except BaseException:
            self.store.release()
            raise
        return req.result()

    def metrics(self) -> dict:
        """The /metrics payload: scheduler state when serving is on,
        plus the cache circuit breaker and idempotency window."""
        out = {"scheduler": "off"} if self.scheduler is None \
            else self.scheduler.stats()
        out["draining"] = self._draining
        out["idempotency"] = self._idem.stats()
        from ..obs.procstats import process_self_stats
        out["process"] = process_self_stats()
        if "dispatch" not in out:
            # scheduler-off servers still report the dispatch-ring
            # books (slot depth/occupancy/overlap — the async slot
            # runtime runs on the direct path too)
            from ..runtime.ring import RING_METRICS
            out["dispatch"] = RING_METRICS.snapshot()
        if "guard" not in out:
            # scheduler-off servers still report the ingest-guard
            # counters (the scheduler's stats() already carry them)
            from ..guard.budget import GUARD_METRICS
            out["guard"] = GUARD_METRICS.snapshot()
        if "detect" not in out:
            # same for the dispatch-path counters (dedup, caches,
            # resident-DB upload amortization)
            from ..detect.metrics import DETECT_METRICS
            out["detect"] = DETECT_METRICS.snapshot()
        if "secret" not in out:
            # and the secret-sieve counters (selectivity, verify
            # tail, DFA upload amortization)
            from ..secret.metrics import SECRET_METRICS
            out["secret"] = SECRET_METRICS.snapshot()
        if "resident" not in out:
            # device-residency gauges ride the scheduler snapshot
            # when serving is on; sched-off servers report them too
            from ..db.compiled import resident_snapshot
            out["resident"] = resident_snapshot()
        if "memo" not in out:
            # findings-memo counters (hits/misses/stores/
            # invalidations, delta re-match) — sched-off servers
            # report them too
            from ..memo.metrics import MEMO_METRICS
            out["memo"] = MEMO_METRICS.snapshot()
        if "ingest" not in out:
            # streaming-ingest counters (layers fetched/warm-skipped,
            # Range resumes, cancelled fetches — docs/performance.md
            # §9), identical section shape on both sched modes
            from ..artifact.stream import INGEST_METRICS
            out["ingest"] = INGEST_METRICS.snapshot()
        if self.memo is not None:
            out["memo"] = self.memo.stats()
        if "watch" not in out:
            # watch/admission counters (docs/serving.md
            # "Continuous scanning") — sched-off servers report
            # them too
            from ..watch.metrics import WATCH_METRICS
            out["watch"] = WATCH_METRICS.snapshot()
        if self.admission is not None:
            out["admission_controller"] = self.admission.stats()
        if self.impact is not None:
            # inverted-index gauges + maintenance counters
            # (docs/serving.md "CVE impact queries")
            out["impact"] = self.impact.stats()
        if "slo" not in out:
            out["slo"] = self.slo.snapshot()
        if "cost" not in out:
            # sched-off servers still report the cost books (memo
            # attribution charges on the direct path too)
            from ..obs.cost import COST_LEDGER
            out["cost"] = COST_LEDGER.snapshot()
        # elastic-lifecycle counters (prewarm/handoff) and the AOT
        # compile-cache split — identical section shape on both
        # sched modes (docs/serving.md "Elastic lifecycle")
        from ..router.lifecycle import LIFECYCLE_METRICS
        from ..runtime.aot import COMPILE_CACHE_METRICS
        out["lifecycle"] = dict(LIFECYCLE_METRICS.snapshot(),
                                warming=self._warming,
                                hot=self.hot.snapshot())
        out["compile_cache"] = COMPILE_CACHE_METRICS.snapshot()
        out["profiler"] = self.profiler.stats()
        out["admission"] = {"max_body_bytes": self.max_body_bytes,
                            "max_scan_blobs": self.max_scan_blobs}
        breaker = getattr(self.cache, "breaker_stats", None)
        if callable(breaker):
            out["cache_breaker"] = breaker()
        out["trace"] = dict(self.tracer.stats(),
                            recorder=self.tracer.recorder.stats())
        out["build_info"] = self.build_info()
        if self.federator is not None:
            out["federation"] = self.federator.stats()
        return out

    def metrics_text(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition of the same snapshot — served
        when a /metrics scrape sends ``Accept: text/plain``, or the
        OpenMetrics variant (exemplars + ``# EOF``) when it
        negotiates ``application/openmetrics-text``
        (docs/observability.md has a scrape config)."""
        from ..obs.prom import render_prometheus
        from ..watch.metrics import WATCH_METRICS
        phase = self.scheduler.metrics.hist_snapshot() \
            if self.scheduler is not None else None
        tenant = self.scheduler.queue.book.hist_snapshot() \
            if self.scheduler is not None else None
        return render_prometheus(
            self.metrics(), phase_hists=phase,
            trace_hists=self.tracer.phase_snapshot(),
            tenant_hists=tenant,
            tracer_stats=self.tracer.stats(),
            recorder_stats=self.tracer.recorder.stats(),
            watch_hists=WATCH_METRICS.hist_snapshot(),
            openmetrics=openmetrics)

    def trace(self, trace_id: str):
        """Chrome trace-event JSON for ``GET /trace/<id>``, or None
        when the id is unknown (or already evicted from the ring)."""
        return self.tracer.trace(trace_id)

    def slo_verdicts(self) -> dict:
        """The ``GET /slo`` payload: per-SLO burn rates, trip state
        and exemplar trace ids (docs/observability.md). A federating
        front also answers the fleet question — ``fleet.slo_ok`` is
        burn math over every replica's merged event buckets, with
        ``complete: false`` flagging a partial view (peer down or
        stale) rather than pretending the fleet is healthy."""
        out = self.slo.snapshot()
        if self.federator is not None:
            rows = self.federator.collect()
            out["fleet"] = self.federator.fleet_slo(
                self.slo.export_state(), rows)
        return out

    def metrics_snapshot(self) -> dict:
        """The ``GET /metrics/snapshot`` payload a federating front
        pulls: replica identity, the full prom exposition, the SLO
        engine's age-keyed bucket export (monotonic-only, so the
        front can rebase it onto its own clock), and the cost
        ledger's export in the same coordinate — the autoscaler
        reads fleet cost-per-scan from it without a second pull."""
        from ..obs.cost import COST_LEDGER
        measured = self.scheduler.metrics.device_time_s() \
            if self.scheduler is not None else 0.0
        return {"name": self.replica_name,
                "build_info": self.build_info(),
                "prom": self.metrics_text(),
                "slo_export": self.slo.export_state(),
                "cost_export": {
                    "export": COST_LEDGER.export_state(),
                    "measured_device_s": round(measured, 6)},
                "mono": time.monotonic()}

    def costs(self) -> dict:
        """The ``GET /costs`` payload: this replica's per-tenant
        invoice, the accounting-identity verdict, and the age-keyed
        export a federating front merges (obs/cost.py,
        docs/observability.md "Cost attribution & goodput")."""
        from ..obs.cost import COST_LEDGER, balance
        if self.scheduler is not None:
            out = self.scheduler.cost_snapshot()
        else:
            from ..runtime.aot import COMPILE_CACHE_METRICS
            aot = COMPILE_CACHE_METRICS.snapshot()
            out = COST_LEDGER.snapshot(
                aot_compile_s=float(aot.get("seconds", 0.0) or 0.0))
            out["measured_device_s"] = 0.0
            out["balance"] = balance(out.get("device_s", 0.0), 0.0)
        out["replica"] = self.replica_name
        out["export"] = COST_LEDGER.export_state()
        out["complete"] = True
        return out

    def profile_text(self, seconds=None) -> str:
        """Collapsed-stack host profile over the last ``seconds``
        (whole ring when None) for ``GET /debug/profile``."""
        return self.profiler.collapsed(seconds)

    def federate_text(self) -> str:
        """The ``GET /metrics/federate`` exposition: this replica's
        families merged with every reachable peer's, each sample
        carrying a bounded-cardinality ``replica`` label, plus the
        fleet SLO verdict gauges. Raises LookupError when the server
        was started without ``--federate-peers``."""
        if self.federator is None:
            raise LookupError("federation not configured")
        rows = self.federator.collect()
        fleet = self.federator.fleet_slo(
            self.slo.export_state(), rows)
        return self.federator.render(
            self.replica_name, self.metrics_text(), rows,
            fleet=fleet)

    def impact_query(self, cve: str) -> dict:
        """The ``GET /impact?cve=`` payload: this replica's owned
        slice of layers/images affected by one CVE. Raises
        LookupError when the server runs without an impact index
        (mirrors ``federate_text``'s unconfigured contract)."""
        if self.impact is None:
            raise LookupError("impact index not configured")
        return self.impact.query(cve)

    # ---- dispatch ----

    ROUTES = {
        CACHE_PREFIX + "PutArtifact": put_artifact,
        CACHE_PREFIX + "PutBlob": put_blob,
        CACHE_PREFIX + "MissingBlobs": missing_blobs,
        CACHE_PREFIX + "DeleteBlobs": delete_blobs,
        SCANNER_PREFIX + "Scan": scan,
    }

    def handle(self, path: str, body: dict) -> dict:
        fn = self.ROUTES.get(path)
        if fn is None:
            raise LookupError(path)
        return fn(self, body)


class DBWorker(threading.Thread):
    """Hot-swap worker (reference: hourly DB update, listen.go:54-83).

    Watches a compiled-DB path prefix; when the file changes, loads
    and stages the new tables, then swaps them in — in-flight scans
    finish against the old tables, new scans see the new ones."""

    def __init__(self, store: SwappableStore, db_prefix: str,
                 interval_s: float = 60.0):
        super().__init__(daemon=True)
        self.store = store
        self.db_prefix = db_prefix
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._mtime = self._current_mtime()

    def _current_mtime(self) -> float:
        try:
            return os.path.getmtime(self.db_prefix + ".npz")
        except OSError:
            return 0.0

    def check_once(self) -> bool:
        mtime = self._current_mtime()
        if mtime and mtime != self._mtime:
            try:
                cdb = CompiledDB.load(self.db_prefix)
            except Exception as e:
                # any load failure (truncated zip, bad JSON, OSError)
                # must leave the watcher alive with the old tables —
                # CompiledDB.save renames atomically, but the watched
                # path can still receive garbage from outside
                log.warning("db reload failed: %s", e)
                return False
            self._mtime = mtime
            self.store.swap(cdb)
            log.info("advisory db hot-swapped (%d rows)",
                     cdb.stats.get("rows", 0))
            return True
        return False

    def run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_once()

    def stop(self) -> None:
        self._stop.set()


def _make_handler(server: ScanServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # a reply's head and body go out in two writes: without this,
        # a kept-alive client waits for its delayed ACK on each answer
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: dict,
                   headers=None) -> None:
            self._reply_text(code, json.dumps(payload),
                             "application/json", headers=headers)

        def _reply_text(self, code: int, text: str,
                        ctype: str, headers=None) -> None:
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers or ():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _authorized(self) -> bool:
            if not server.token:
                return True
            import hmac
            got = self.headers.get(server.token_header) or ""
            if hmac.compare_digest(got, server.token):
                return True
            self._reply(401, {"code": "unauthenticated",
                              "msg": "invalid token"})
            return False

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, server.health())
            elif self.path == "/metrics/snapshot":
                # the federation pull: replica identity + prom text
                # + age-keyed SLO bucket export, token-protected like
                # every operational route
                if not self._authorized():
                    return
                self._reply(200, server.metrics_snapshot())
            elif self.path == "/metrics/federate":
                # fleet exposition: this replica merged with every
                # reachable peer, one replica label per sample
                if not self._authorized():
                    return
                try:
                    text = server.federate_text()
                except LookupError:
                    self._reply(404, {
                        "code": "bad_route",
                        "msg": "federation not configured "
                               "(--federate-peers)"})
                    return
                self._reply_text(
                    200, text,
                    "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/clock":
                # monotonic clock probe for pairwise offset
                # estimation (obs/propagate.py): token-protected —
                # a clock readout fingerprints process uptime
                if not self._authorized():
                    return
                self._reply(200, {"mono": time.monotonic()})
            elif self.path == "/metrics":
                # /healthz stays open (probes), but the operational
                # detail in /metrics honors the server token
                if not self._authorized():
                    return
                # content negotiation: an OpenMetrics scrape
                # (Accept: application/openmetrics-text) gets the
                # 1.0.0 exposition WITH exemplars; a plain
                # Prometheus scrape (Accept: text/plain) gets the
                # byte-stable 0.0.4 text; everything else keeps the
                # JSON snapshot
                accept = self.headers.get("Accept") or ""
                if "application/openmetrics-text" in accept:
                    from ..obs.prom import OPENMETRICS_CTYPE
                    self._reply_text(
                        200, server.metrics_text(openmetrics=True),
                        OPENMETRICS_CTYPE)
                elif "text/plain" in accept \
                        or "openmetrics" in accept:
                    self._reply_text(
                        200, server.metrics_text(),
                        "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._reply(200, server.metrics())
            elif self.path == "/slo":
                # SLO burn-rate verdicts: operational detail, so it
                # honors the token like /metrics and /trace
                if not self._authorized():
                    return
                self._reply(200, server.slo_verdicts())
            elif self.path == "/costs":
                # per-tenant cost ledger + goodput reconciliation
                # (docs/observability.md "Cost attribution &
                # goodput"): operational detail, token-gated
                if not self._authorized():
                    return
                self._reply(200, server.costs())
            elif self.path == "/handoff":
                # drain handoff (docs/serving.md "Elastic
                # lifecycle"): the hot-digest working set a ring
                # successor prefetches — operational, token-gated
                if not self._authorized():
                    return
                self._reply(200, server.handoff())
            elif self.path.startswith("/debug/profile"):
                # collapsed-stack host profile
                # (docs/observability.md "Host profiler"):
                # ?seconds=N bounds the lookback window
                if not self._authorized():
                    return
                from urllib.parse import parse_qs, urlsplit
                q = parse_qs(urlsplit(self.path).query)
                seconds = None
                try:
                    if q.get("seconds"):
                        seconds = max(1, int(q["seconds"][0]))
                except (TypeError, ValueError):
                    self._reply(400, {"code": "malformed",
                                      "msg": "bad seconds= value"})
                    return
                self._reply_text(
                    200, server.profile_text(seconds),
                    "text/plain; charset=utf-8")
            elif self.path.startswith("/impact"):
                # CVE impact query (docs/serving.md "CVE impact
                # queries"): this replica's owned index slice —
                # token-gated operational data like /metrics
                if not self._authorized():
                    return
                from urllib.parse import parse_qs, urlsplit
                q = parse_qs(urlsplit(self.path).query)
                cve = (q.get("cve") or [""])[0].strip()
                if not cve:
                    self._reply(400, {"code": "malformed",
                                      "msg": "missing cve= query "
                                             "parameter"})
                    return
                try:
                    self._reply(200, server.impact_query(cve[:256]))
                except LookupError:
                    self._reply(404, {
                        "code": "bad_route",
                        "msg": "impact index not configured "
                               "(--impact-index)"})
            elif self.path.startswith("/trace/"):
                # per-request trace lookup (docs/observability.md):
                # operational detail, so it honors the token too
                if not self._authorized():
                    return
                doc = server.trace(self.path[len("/trace/"):])
                if doc is None:
                    self._reply(404, {"code": "not_found",
                                      "msg": self.path})
                else:
                    self._reply(200, doc)
            else:
                self._reply(404, {"code": "bad_route",
                                  "msg": self.path})

        def do_POST(self):
            if not self._authorized():
                return
            inj = server.fault_injector
            action = inj.rpc_action(self.path) if inj is not None \
                else "ok"
            if action == "error":
                # injected transport fault BEFORE processing — the
                # client's 5xx retry covers it
                self._reply(500, {"code": "injected",
                                  "msg": "injected rpc error"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                self._reply(400, {"code": "malformed",
                                  "msg": "bad content-length"})
                self.close_connection = True
                return
            if length > server.max_body_bytes or length < 0:
                # admission cap: answer 413 WITHOUT reading the
                # body; the unread stream makes the connection
                # unusable for keep-alive, so close it
                self._reply(413, {
                    "code": "payload_too_large",
                    "msg": f"request body of {length} bytes "
                           f"exceeds {server.max_body_bytes}"})
                self.close_connection = True
                return
            raw = self.rfile.read(length) if length else b"{}"
            try:
                body = json.loads(raw or b"{}")
            except ValueError:
                if self.path.split("?", 1)[0] == \
                        "/registry/notifications" and \
                        server.watch_source is not None:
                    # the notification route's always-200 contract
                    # covers non-JSON poison too: a registry
                    # redelivers on non-2xx forever; count it as
                    # one malformed envelope and move on
                    self._reply(200,
                                server.watch_source
                                .push_notification(None))
                    return
                self._reply(400, {"code": "malformed",
                                  "msg": "invalid json body"})
                return
            # tenant identity: an explicit body field wins, else the
            # Trivy-Tenant header, else the shared anonymous tenant
            tenant_hdr = self.headers.get(TENANT_HEADER)
            if tenant_hdr and isinstance(body, dict) \
                    and not body.get("tenant"):
                body["tenant"] = tenant_hdr
            # trace context: an explicit body field wins, else the
            # Traceparent header — folded here so every route sees
            # one canonical place
            tp_hdr = self.headers.get(TRACEPARENT_HEADER)
            if tp_hdr and isinstance(body, dict) \
                    and not body.get("traceparent"):
                body["traceparent"] = tp_hdr
            # continuous-scanning routes (docs/serving.md): the
            # registry notification webhook and the K8s admission
            # webhook answer their own protocols, not twirp
            if self.path.split("?", 1)[0] == \
                    "/registry/notifications":
                if server.watch_source is None:
                    self._reply(404, {"code": "bad_route",
                                      "msg": self.path})
                    return
                # always 200: a registry redelivers on non-2xx, and
                # a poison envelope must not be redelivered forever —
                # malformed events are counted and dropped
                self._reply(
                    200, server.watch_source.push_notification(body))
                return
            if self.path.split("?", 1)[0] == "/k8s/admission":
                self._handle_admission(body)
                return
            if self.path.split("?", 1)[0] == "/prefetch":
                # drain-handoff adoption (docs/serving.md "Elastic
                # lifecycle"): book the migrating working set; the
                # payloads live in the shared memo tier
                self._reply(200, server.prefetch(body))
                return
            from ..sched import DeadlineExceeded, SchedulerClosed
            try:
                out = server.handle(self.path, body)
            except LookupError:
                self._reply(404, {"code": "bad_route",
                                  "msg": self.path})
                return
            except RequestTooLarge as e:
                # admission cap on request SHAPE (e.g. blob count):
                # 413 is authoritative, not retryable
                self._reply(413, {"code": "payload_too_large",
                                  "msg": str(e)})
                return
            except BadRequest as e:
                # a request this server cannot run as asked (an
                # unknown body backend): not retryable
                self._reply(400, {"code": "malformed",
                                  "msg": str(e)})
                return
            except RateLimitedError as e:
                # per-tenant quota/rate shed: 429 + Retry-After —
                # the offending tenant backs off (the client's
                # retry loop honors the header); other tenants'
                # traffic is untouched, unlike a blanket 503.
                # The HEADER is integer delta-seconds (RFC 9110 —
                # fractional values make standards-compliant
                # clients ignore the hint entirely); the exact
                # float rides the JSON body as retry_after_s
                retry_after = max(0.001, e.retry_after_s)
                import math
                self._reply(429, {"code": "rate_limited",
                                  "msg": str(e),
                                  "retry_after_s":
                                      round(retry_after, 3)},
                            headers=[("Retry-After",
                                      str(int(math.ceil(
                                          retry_after))))])
                return
            except QueueFullError as e:
                # backpressure: 503 is the transient code the client
                # retries with backoff (retry.go's twirp.Unavailable)
                self._reply(503, {"code": "resource_exhausted",
                                  "msg": str(e)})
                return
            except (ServerDraining, SchedulerClosed) as e:
                # graceful shutdown: also transient from the fleet's
                # perspective — another replica will take the retry
                self._reply(503, {"code": "unavailable",
                                  "msg": str(e)})
                return
            except DeadlineExceeded as e:
                # the request's own deadline — retrying would expire
                # again, so answer with a non-retried 4xx
                self._reply(408, {"code": "deadline_exceeded",
                                  "msg": str(e)})
                return
            except Exception as e:          # noqa: BLE001
                log.warning("rpc %s failed: %r", self.path, e)
                self._reply(500, {"code": "internal",
                                  "msg": str(e)})
                return
            if action == "drop":
                # injected lost response AFTER processing: the work
                # happened, the client never hears back — exactly the
                # case Scan idempotency keys exist for
                self.close_connection = True
                return
            self._reply(200, out)

        def _handle_admission(self, body: dict) -> None:
            """POST /k8s/admission: AdmissionReview in, review out.
            The apiserver's ``?timeout=10s`` query parameter bounds
            the verdict; the fail stance decides what a miss answers —
            only the explicit ``408`` stance surfaces the deadline as
            HTTP, handing the decision to the webhook's K8s-side
            ``failurePolicy``."""
            from urllib.parse import parse_qs, urlsplit

            from ..watch.admission import (AdmissionUnavailable,
                                           MalformedReview)
            if server.admission is None:
                self._reply(404, {"code": "bad_route",
                                  "msg": self.path})
                return
            deadline_s = 0.0
            q = parse_qs(urlsplit(self.path).query)
            if q.get("timeout"):
                raw = q["timeout"][0].strip()
                try:
                    deadline_s = float(raw[:-1]) \
                        if raw.endswith("s") else float(raw)
                except (TypeError, ValueError):
                    self._reply(400, {"code": "malformed",
                                      "msg": "bad timeout= value"})
                    return
            try:
                doc = server.admission.review(body,
                                              deadline_s=deadline_s)
            except MalformedReview as e:
                self._reply(400, {"code": "malformed",
                                  "msg": str(e)})
                return
            except AdmissionUnavailable as e:
                self._reply(408, {"code": "deadline_exceeded",
                                  "msg": str(e)})
                return
            except Exception as e:      # noqa: BLE001
                log.warning("admission review failed: %r", e)
                self._reply(500, {"code": "internal",
                                  "msg": str(e)})
                return
            self._reply(200, doc)

    return Handler


def serve(addr: str = "127.0.0.1", port: int = 4954,
          server: Optional[ScanServer] = None,
          db_watch_prefix: str = "",
          db_watch_interval_s: float = 60.0) -> tuple:
    """Start the HTTP server on a background thread. Returns
    (httpd, worker|None); call ``httpd.shutdown()`` to stop."""
    server = server or ScanServer()
    httpd = ThreadingHTTPServer((addr, port), _make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever,
                              daemon=True)
    thread.start()
    worker = None
    if db_watch_prefix:
        worker = DBWorker(server.store, db_watch_prefix,
                          db_watch_interval_s)
        worker.start()
    log.info("listening on %s:%d", addr, httpd.server_address[1])
    return httpd, worker


def serve_forever(addr: str, port: int, server: ScanServer,
                  db_watch_prefix: str = "",
                  db_watch_interval_s: float = 60.0,
                  drain_timeout_s: float = 30.0,
                  on_tick=None) -> None:
    """Foreground serve with graceful SIGTERM handling: on signal,
    new Scan RPCs answer 503 while queued and in-flight requests run
    to completion (bounded by ``drain_timeout_s``), then the process
    exits — a rolling restart never drops accepted work. ``on_tick``
    (optional) runs on this thread about once a second: the server's
    ``--profile-out`` window is stepped there, on the thread that
    opened the capture."""
    import signal

    httpd, worker = serve(addr, port, server, db_watch_prefix,
                          db_watch_interval_s)
    stop = threading.Event()

    def _term(signum, frame):
        log.info("signal %s: draining", signum)
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass                    # not the main thread (tests)
    try:
        while not stop.wait(1.0):
            if on_tick is not None:
                on_tick()
    except KeyboardInterrupt:
        pass
    finally:
        if worker:
            worker.stop()
        # order matters: 503 new work first, drain while the HTTP
        # server still delivers in-flight responses, THEN stop it
        server.shutdown_gracefully(drain_timeout_s)
        httpd.shutdown()
