"""Scan router core: bounded-load consistent-hash routing with
zero-loss failover (reference: ``trivy_tpu/router/core.py``;
docs/serving.md "Scan router & autoscaling").

One :class:`ScanRouter` fronts N ``python -m trivy_tpu_torch server``
replicas (each serving its own card). Every
twirp POST is routed by consistent hashing on the request's layer
digest (``blob_ids[0]`` — the base layer, the most widely shared blob
— so one image's layers and the follow-up PutBlob traffic land on the
replica whose memo/cache tier is already warm for them), with the
bounded-load spill keeping a hot digest from melting one shard.

Failure semantics (the robustness contract, bench-gated):

* a connection failure or lost response mid-request records a
  breaker failure and REPLAYS the identical raw body — same
  idempotency key, same traceparent — against the next ring owner;
  the server-side idempotency window makes the replay safe, so the
  client sees exactly one result;
* a 503 ``unavailable`` marks the replica draining (no NEW work) and
  fails the request over the same way; the draining replica keeps
  its in-flight scans;
* a 503 ``resource_exhausted`` spills to the next owner (bounded
  load in action) and only becomes the client's 503 — with a
  Retry-After hint — when every routable replica is saturated;
* 429/408 and other client-visible verdicts pass through untouched
  (the per-tenant 429 must land on the offending tenant, not turn
  into a router retry storm);
* every ACCEPTED request is booked into exactly one terminal outcome
  counter — the books-balance invariant the kill-mid-storm bench
  asserts.

Health is an overlay on membership: the ring only changes on
add/remove (so reshard movement stays ≤ K/N), while draining and
breaker-open replicas are excluded from NEW work via the lookup's
exclude set. The :class:`HealthProber` owns the breaker's half-open
recovery probes; the request path never routes to a non-closed
breaker, so a dead replica costs its cooldown, not a request.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..artifact.resilient import CLOSED, CircuitBreaker
from ..obs.propagate import TRACEPARENT_HEADER
from ..rpc.server import (CACHE_PREFIX, DEFAULT_TOKEN_HEADER,
                          SCANNER_PREFIX, TENANT_HEADER)
from .metrics import ROUTER_METRICS
from .ring import DEFAULT_CAPACITY_FACTOR, DEFAULT_VNODES, Ring

log = logging.getLogger("trivy_tpu_torch.router")

SCAN_PATH = SCANNER_PREFIX + "Scan"
ROUTED_REPLICA_HEADER = "Trivy-Routed-Replica"
# Retry-After the router sends when every routable replica is
# saturated or gone — long enough to shed, short enough that a
# recovering fleet is retried promptly
EXHAUSTED_RETRY_AFTER_S = 1.0
# affinity window: artifact/blob id -> route key, so PutBlob(diff_id)
# and PutArtifact(artifact_id) follow the MissingBlobs call that
# opened the session to the same replica (LRU, bounded)
AFFINITY_CAP = 65536
MAX_ATTEMPTS = 8                 # failover hops per request, capped


class ReplicaHandle:
    """One backend replica: endpoint, breaker, probed health."""

    def __init__(self, name: str, url: str,
                 breaker: Optional[CircuitBreaker] = None,
                 warming: bool = False):
        self.name = name
        self.url = url.rstrip("/")
        self.breaker = breaker or CircuitBreaker()
        self.draining = False
        # warming: on the ring (membership — reshard already paid)
        # but NOT routable until its prewarm completes; the prober
        # tracks the replica's own /healthz ``warming`` flag, so a
        # replica that restarts mid-probe-interval is re-admitted
        # only when warm again, never cold
        self.warming = warming
        self.inflight = 0            # router-side in-flight count
        self.probed_inflight = 0     # replica-reported (healthz)
        self.probe_ok = True
        self.build: dict = {}

    def stats(self) -> dict:
        return {"name": self.name, "url": self.url,
                "draining": self.draining,
                "warming": self.warming,
                "inflight": self.inflight,
                "probed_inflight": self.probed_inflight,
                "probe_ok": self.probe_ok,
                "breaker": self.breaker.stats()}


class _Attempt:
    """Outcome of one upstream forward."""

    __slots__ = ("kind", "status", "body", "retry_after", "error")

    def __init__(self, kind: str, status: int = 0, body: bytes = b"",
                 retry_after: str = "", error: str = ""):
        self.kind = kind          # terminal|conn|draining|saturated
        self.status = status
        self.body = body
        self.retry_after = retry_after
        self.error = error


class ScanRouter:
    """Routes twirp POSTs across replicas; embeddable (front.py
    wraps it in HTTP, tests drive it directly)."""

    def __init__(self, replicas: Optional[List[Tuple[str, str]]] = None,
                 token: str = "",
                 token_header: str = DEFAULT_TOKEN_HEADER,
                 vnodes: int = DEFAULT_VNODES,
                 capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
                 timeout_s: float = 300.0,
                 max_attempts: int = MAX_ATTEMPTS,
                 fault_injector=None):
        self.token = token
        self.token_header = token_header
        self.timeout_s = timeout_s
        self.max_attempts = max(1, max_attempts)
        self.fault_injector = fault_injector
        self.ring = Ring(vnodes=vnodes,
                         capacity_factor=capacity_factor)
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaHandle] = {}
        self._affinity: OrderedDict = OrderedDict()
        self._ejected: set = set()   # replicas seen breaker-open
        for name, url in replicas or []:
            self.add_replica(name, url)

    # ---- membership (ring churn happens ONLY here) ----

    def add_replica(self, name: str, url: str,
                    warming: bool = False) -> None:
        """``warming=True`` puts the replica on the ring (membership
        — the reshard happens now, once) but keeps it out of the
        routable set until its prewarm completes and a probe sees
        ``warming: false`` on /healthz (docs/serving.md "Elastic
        lifecycle")."""
        with self._lock:
            if name in self._replicas:
                return
            self._replicas[name] = ReplicaHandle(name, url,
                                                 warming=warming)
        self.ring.add(name)
        ROUTER_METRICS.inc("ring_churn")
        ROUTER_METRICS.set_inflight(name, 0)
        log.info("replica %s joined the ring (%s)", name, url)

    def remove_replica(self, name: str) -> None:
        with self._lock:
            handle = self._replicas.pop(name, None)
        if handle is None:
            return
        self.ring.remove(name)
        ROUTER_METRICS.inc("ring_churn")
        ROUTER_METRICS.drop_replica(name)
        log.info("replica %s left the ring", name)

    def replica(self, name: str) -> Optional[ReplicaHandle]:
        with self._lock:
            return self._replicas.get(name)

    def replicas(self) -> List[ReplicaHandle]:
        with self._lock:
            return [self._replicas[n]
                    for n in sorted(self._replicas)]

    def mark_draining(self, name: str,
                      draining: bool = True) -> None:
        with self._lock:
            h = self._replicas.get(name)
            if h is not None:
                h.draining = draining

    def mark_warming(self, name: str,
                     warming: bool = True) -> None:
        """Flip a replica's warming overlay (tests and proberless
        embedders; with a prober running the replica's own /healthz
        is authoritative)."""
        with self._lock:
            h = self._replicas.get(name)
            if h is not None:
                h.warming = warming

    # ---- routing-set overlay (health never reshards the ring) ----

    def _unroutable(self) -> set:
        """Replicas excluded from NEW work: draining, warming (on
        the ring but prewarm not yet complete), or breaker not
        CLOSED (half-open probes belong to the prober, not to a
        client's request)."""
        out = set()
        with self._lock:
            for name, h in self._replicas.items():
                if h.draining or h.warming \
                        or h.breaker.state != CLOSED:
                    out.add(name)
        return out

    def _loads(self) -> Dict[str, int]:
        with self._lock:
            return {n: h.inflight
                    for n, h in self._replicas.items()}

    # ---- route-key extraction + cache-session affinity ----

    def _remember(self, ids: List[str], key: str) -> None:
        with self._lock:
            for i in ids:
                if not i:
                    continue
                self._affinity[i] = key
                self._affinity.move_to_end(i)
            while len(self._affinity) > AFFINITY_CAP:
                self._affinity.popitem(last=False)

    def _recall(self, ident: str) -> Optional[str]:
        with self._lock:
            return self._affinity.get(ident)

    def route_key(self, path: str, body: dict) -> str:
        """The consistent-hash key for one request. Scan and
        MissingBlobs key on the base layer digest and open an
        affinity session (artifact id + every blob id -> key) so the
        PutArtifact/PutBlob/DeleteBlobs traffic of the same image
        follows them to the same replica's warm cache."""
        if path == SCAN_PATH or path == CACHE_PREFIX + "MissingBlobs":
            blob_ids = [str(b) for b in body.get("blob_ids") or []]
            key = (blob_ids[0] if blob_ids
                   else str(body.get("artifact_id")
                            or body.get("target") or ""))
            self._remember([str(body.get("artifact_id") or "")]
                           + blob_ids, key)
            return key
        if path == CACHE_PREFIX + "PutBlob":
            ident = str(body.get("diff_id") or "")
            return self._recall(ident) or ident
        if path == CACHE_PREFIX + "PutArtifact":
            ident = str(body.get("artifact_id") or "")
            return self._recall(ident) or ident
        if path == CACHE_PREFIX + "DeleteBlobs":
            blob_ids = [str(b) for b in body.get("blob_ids") or []]
            ident = blob_ids[0] if blob_ids else ""
            return self._recall(ident) or ident
        return path

    # ---- the request path ----

    def route(self, path: str, raw: bytes,
              headers: Optional[dict] = None) -> Tuple[int, bytes,
                                                       List[tuple]]:
        """Route one twirp POST. Returns (status, body_bytes,
        extra_headers). The raw body is forwarded verbatim on every
        attempt — the replay carries the SAME idempotency key and
        traceparent, which is what makes failover lossless."""
        t0 = time.monotonic()
        headers = headers or {}
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                body = {}
        except ValueError:
            body = {}
        if path == SCAN_PATH and not body.get("idempotency_key"):
            # a keyless Scan (raw curl) would make replay unsafe —
            # mint the key here so every hop shares it
            import uuid
            body["idempotency_key"] = uuid.uuid4().hex
            raw = json.dumps(body).encode()
        key = self.route_key(path, body)
        ROUTER_METRICS.inc("accepted")
        upstream_s = 0.0
        tried: set = set()
        replayed = False
        status, out, extra = 503, b"", []
        outcome = "unavailable"
        saturated_hint = ""
        for attempt in range(self.max_attempts):
            target = self.ring.assign(key, self._loads(),
                                      exclude=self._unroutable()
                                      | tried)
            if target is None:
                break
            planned = self.ring.walk(key)
            if planned and target != planned[0] \
                    and planned[0] not in tried \
                    and attempt == 0:
                # first pick already spilled past the plain owner:
                # bounded load (or the owner's health) in action
                ROUTER_METRICS.inc("spills")
            tried.add(target)
            if attempt > 0:
                ROUTER_METRICS.inc("failovers")
                if path == SCAN_PATH:
                    ROUTER_METRICS.inc("replays")
                    replayed = True
            t_up = time.monotonic()
            res = self._forward(target, path, raw, headers)
            upstream_s += time.monotonic() - t_up
            if res.kind == "terminal":
                status, out = res.status, res.body
                extra = [(ROUTED_REPLICA_HEADER, target)]
                if res.retry_after:
                    extra.append(("Retry-After", res.retry_after))
                if status == 200:
                    outcome = "ok"
                    if path == SCAN_PATH:
                        out = self._stamp(out, target, replayed)
                elif status == 408:
                    outcome = "timeout"
                elif status == 429:
                    outcome = "rate_limited"
                elif status == 503:
                    outcome = "unavailable"
                else:
                    outcome = "failed"
                break
            if res.kind == "draining":
                ROUTER_METRICS.inc("drain_redirects")
                self.mark_draining(target)
            elif res.kind == "saturated":
                ROUTER_METRICS.inc("spills")
                saturated_hint = res.retry_after \
                    or saturated_hint
            elif res.kind == "conn":
                ROUTER_METRICS.inc("conn_errors")
            log.info("failing %s over past %s (%s %s)", path,
                     target, res.kind, res.error or res.status)
        if not extra:
            # no replica could terminate the request: the router's
            # own 503 + Retry-After — transient by contract, the
            # client's retry loop (or another front) takes it
            hint = saturated_hint or str(EXHAUSTED_RETRY_AFTER_S)
            status = 503
            out = json.dumps(
                {"code": "unavailable",
                 "msg": "no routable replica "
                        f"(tried {sorted(tried)})",
                 "retry_after_s": float(hint)}).encode()
            extra = [("Retry-After",
                      str(int(float(hint))
                          if float(hint) >= 1 else 1))]
            outcome = "unavailable"
        # exactly-once terminal booking: the books-balance invariant
        ROUTER_METRICS.inc(outcome)
        wall = time.monotonic() - t0
        ROUTER_METRICS.observe("route_latency", wall)
        ROUTER_METRICS.observe("upstream_latency", upstream_s)
        return status, out, extra

    def _stamp(self, out: bytes, target: str,
               replayed: bool) -> bytes:
        """Fold routed_replica into a successful Scan response body
        (clients log which backend served them)."""
        try:
            doc = json.loads(out or b"{}")
        except ValueError:
            return out
        if not isinstance(doc, dict):
            return out
        doc["routed_replica"] = target
        if replayed:
            doc["replayed"] = True
        return json.dumps(doc).encode()

    def _forward(self, name: str, path: str, raw: bytes,
                 headers: dict) -> _Attempt:
        handle = self.replica(name)
        if handle is None:
            return _Attempt("conn", error="replica removed")
        with self._lock:
            handle.inflight += 1
            inflight = handle.inflight
        ROUTER_METRICS.inc("forwards")
        ROUTER_METRICS.set_inflight(name, inflight)
        try:
            return self._forward_once(handle, path, raw, headers)
        finally:
            with self._lock:
                handle.inflight -= 1
                inflight = handle.inflight
            ROUTER_METRICS.set_inflight(name, inflight)

    def _forward_once(self, handle: ReplicaHandle, path: str,
                      raw: bytes, headers: dict) -> _Attempt:
        req = urllib.request.Request(
            handle.url + path, data=raw, method="POST",
            headers={"Content-Type": "application/json"})
        if self.token:
            req.add_header(self.token_header, self.token)
        for h in (TENANT_HEADER, TRACEPARENT_HEADER):
            v = headers.get(h)
            if v:
                req.add_header(h, v)
        inj = self.fault_injector
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                body = resp.read()
                if inj is not None and \
                        inj.on_route_forward(handle.name) == "drop":
                    # injected lost response AFTER the upstream did
                    # the work — exactly the replay hazard the shared
                    # idempotency key neutralizes
                    return _Attempt("conn",
                                    error="injected response drop")
                handle.breaker.record_success()
                return _Attempt("terminal", status=resp.status,
                                body=body)
        except urllib.error.HTTPError as e:
            body = e.read()
            retry_after = (e.headers.get("Retry-After")
                           if e.headers else "") or ""
            if e.code == 503:
                code = ""
                try:
                    doc = json.loads(body or b"{}")
                    code = str(doc.get("code") or "")
                    if doc.get("retry_after_s") is not None:
                        retry_after = str(doc["retry_after_s"])
                except ValueError:
                    log.debug("unparseable 503 body from %s",
                              handle.name)
                if code == "unavailable":
                    # graceful drain: replica finishes its in-flight
                    # work but takes no more — not a breaker failure
                    return _Attempt("draining", status=503,
                                    body=body,
                                    retry_after=retry_after)
                return _Attempt("saturated", status=503, body=body,
                                retry_after=retry_after)
            if e.code >= 500:
                handle.breaker.record_failure()
            else:
                handle.breaker.record_success()
            return _Attempt("terminal", status=e.code, body=body,
                            retry_after=retry_after)
        except (urllib.error.URLError, ConnectionError,
                TimeoutError, OSError) as e:
            handle.breaker.record_failure()
            return _Attempt("conn", error=repr(e))

    # ---- introspection ----

    def stats(self) -> dict:
        replicas = [h.stats() for h in self.replicas()]
        ejected = {r["name"] for r in replicas
                   if r["breaker"]["state"] != CLOSED}
        with self._lock:
            affinity = len(self._affinity)
        return {"replicas": replicas,
                "ring": {"nodes": self.ring.nodes(),
                         "vnodes": self.ring.vnodes,
                         "capacity_factor":
                             self.ring.capacity_factor},
                "routable": sorted(
                    set(self.ring.nodes()) - self._unroutable()),
                "ejected": sorted(ejected),
                "affinity_entries": affinity,
                "router": ROUTER_METRICS.snapshot()}


class HealthProber(threading.Thread):
    """Background /healthz prober: drain visibility, breaker
    recovery, per-replica inflight. Owns the half-open probe — the
    request path only ever routes to CLOSED breakers."""

    def __init__(self, router: ScanRouter,
                 interval_s: float = 1.0,
                 timeout_s: float = 2.0):
        super().__init__(daemon=True, name="router-prober")
        self.router = router
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self._stop = threading.Event()

    def probe_once(self) -> None:
        for handle in self.router.replicas():
            self._probe(handle)

    def _probe(self, handle: ReplicaHandle) -> None:
        breaker = handle.breaker
        was = breaker.state
        if was != CLOSED and not breaker.allow():
            return                  # still cooling down
        ROUTER_METRICS.inc("probes")
        try:
            req = urllib.request.Request(
                handle.url + "/healthz", method="GET")
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                doc = json.loads(resp.read() or b"{}")
        except (urllib.error.URLError, ConnectionError,
                TimeoutError, OSError, ValueError) as e:
            breaker.record_failure()
            ROUTER_METRICS.inc("probe_failures")
            if was == CLOSED and breaker.state != CLOSED:
                ROUTER_METRICS.inc("ejections")
                log.warning("replica %s ejected (probe: %r)",
                            handle.name, e)
            handle.probe_ok = False
            return
        breaker.record_success()
        if was != CLOSED:
            ROUTER_METRICS.inc("recoveries")
            log.info("replica %s recovered", handle.name)
        handle.probe_ok = True
        handle.draining = bool(doc.get("draining"))
        # the replica's own ready-state machine is authoritative: a
        # restarted replica re-announcing ``warming`` is NOT
        # re-admitted cold, and one that finished its prewarm is
        # admitted on the next probe — one probe interval, by design
        handle.warming = bool(doc.get("warming"))
        try:
            handle.probed_inflight = int(doc.get("inflight") or 0)
        except (TypeError, ValueError):
            handle.probed_inflight = 0
        handle.build = doc.get("build") or {}

    def run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.probe_once()

    def stop(self) -> None:
        self._stop.set()
