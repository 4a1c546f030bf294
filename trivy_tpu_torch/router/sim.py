"""Simulated scan replica for router tests and bench (reference:
``trivy_tpu/router/sim.py``; docs/serving.md "Scan router &
autoscaling").

A stdlib-only stand-in for ``python -m trivy_tpu_torch server`` that speaks exactly
the protocol surface the router depends on — the twirp POST routes,
``/healthz`` with ``draining``/``inflight``, the 503
``unavailable``/``resource_exhausted`` split, 429 + Retry-After per
tenant, and the idempotency-window replay — while modeling the parts
that matter for fleet behavior:

* bounded concurrency (``max_concurrent`` semaphore): a replica has
  finite parallelism, so aggregate throughput should scale with the
  replica count — the bench's ≥ 0.8×N gate is meaningless against an
  infinitely parallel sleep;
* per-replica warm state: the recency-ordered book of layer digests
  this replica has seen; a repeat of a known base digest answers
  ``memo_hit: true`` — the signal the post-reshard warm-hit bench
  measures;
* the elastic lifecycle (docs/serving.md "Elastic lifecycle"): with
  ``memo_dir`` the replica write-throughs every digest it warms into
  a shared directory (the sim stand-in for the redis/s3 memo tier);
  given ``ring_members`` it boots in a ``warming`` state, computes
  the key ranges the post-join ring will assign it (the ring is a
  pure cross-process function), stages exactly those digests from
  the shared tier, and only then flips ``/healthz`` to ready — all
  under ``prewarm_deadline_s``, so an unreadable/slow memo tier
  degrades to a bounded cold join instead of wedging the scale-up.
  ``GET /handoff`` exports the hot set for a draining replica's
  successors; ``POST /prefetch`` is how they take it;
* seeded faults: ``kill_after=N`` hard-exits the process mid-request
  after N scans (replica death mid-storm), ``flaky_every=N`` does
  the work then drops every Nth response (the lost-response hazard
  idempotent replay neutralizes);
* runtime chaos (``POST /chaos``): the soak harness steers error
  windows (brownouts), response-drop windows, service-time changes
  and rolling DB hot swaps (``db_generation`` bump → warm state
  cold, like a memo ctx_sig change) on a *live* replica mid-run;
* a per-replica SLO engine + ``GET /metrics/snapshot``, so the
  federation plane (obs/federate.py) renders genuine fleet
  burn-rate verdicts over a sim fleet.

IMPORTANT: keep this module importable with stdlib only (no torch,
no heavyweight imports of this package) — ``python -m
trivy_tpu_torch.router.sim`` is the subprocess replica the
SubprocessReplicaController spawns, and its startup cost is
fleet-bringup cost (the package's ``__init__`` imports torch only
when ``resolve_device`` runs, so the sim's process never loads it).
The twirp path constants are restated here (protocol literals, same
values as ``rpc/server.py``) for exactly that reason. The obs imports
below are lazy and land in ``obs/slo.py``, ``obs/cost.py`` and
``obs/procstats.py`` — stdlib-only by charter (obs/__init__.py).
One departure: :meth:`SimReplica.build_info` names the build's
``torch_version`` and ``cuda_version`` (empty: a sim runs no torch)
where the reference's names ``jax_version``, as the port's
server does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

SCANNER_PREFIX = "/twirp/trivy.scanner.v1.Scanner/"
CACHE_PREFIX = "/twirp/trivy.cache.v1.Cache/"
TENANT_HEADER = "Trivy-Tenant"
IDEM_CAP = 4096
HOT_CAP = 4096                  # bounded warm-set recency book


def _memo_fname(digest: str) -> str:
    """Digest -> shared-memo-dir marker filename (path-safe). The
    original digest rides as file CONTENT because the sanitization
    is not reversible."""
    return "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in digest)[:200]


class SimReplica:
    """One simulated replica: in-process (tests) or the target of
    ``python -m trivy_tpu_torch.router.sim`` (subprocess fleet)."""

    def __init__(self, name: str = "sim", port: int = 0,
                 addr: str = "127.0.0.1",
                 service_ms: float = 5.0,
                 max_concurrent: int = 2,
                 kill_after: int = 0,
                 flaky_every: int = 0,
                 tenant_rate: float = 0.0,
                 seed: int = 20260804,
                 slo_availability: float = 0.99,
                 memo_dir: str = "",
                 ring_members=None,
                 prewarm_deadline_s: float = 5.0,
                 prewarm_delay_ms: float = 0.0,
                 hot_cap: int = HOT_CAP):
        self.name = name
        self.addr = addr
        self._port = port
        self.service_ms = max(0.0, service_ms)
        self.max_concurrent = max(1, max_concurrent)
        self.kill_after = max(0, kill_after)
        self.flaky_every = max(0, flaky_every)
        # tenant_rate > 0: each tenant may start at most this many
        # scans per second (token bucket, burst == rate)
        self.tenant_rate = max(0.0, tenant_rate)
        self._sem = threading.BoundedSemaphore(self.max_concurrent)
        self._lock = threading.Lock()
        # layer digests seen, recency-ordered (oldest first) with
        # refcounts, bounded at hot_cap — the /handoff export is
        # this book's tail, never an unbounded history
        self._warm: OrderedDict = OrderedDict()
        self.hot_cap = max(1, hot_cap)
        self._blobs: set = set()         # cache-tier blob ids
        self._idem: OrderedDict = OrderedDict()  # key -> response
        self._buckets: dict = {}         # tenant -> (tokens, last)
        self.draining = False
        self.inflight = 0
        # elastic-lifecycle knobs: the shared memo tier is a
        # directory of digest marker files (the sim stand-in for
        # redis/s3); ring_members given => boot warming and prewarm
        # the post-join key ranges before flipping ready
        self.memo_dir = memo_dir
        self.ring_members = [str(m) for m in ring_members or []
                             if str(m)]
        self.prewarm_deadline_s = max(0.0, prewarm_deadline_s)
        self.prewarm_delay_ms = max(0.0, prewarm_delay_ms)
        self.warming = bool(self.memo_dir and self.ring_members)
        self.prewarm_seconds = 0.0
        self.counters = {"scans": 0, "memo_hits": 0, "deduped": 0,
                         "dropped": 0, "rate_limited": 0,
                         "cache_ops": 0, "drained_rejects": 0,
                         "chaos_errors": 0, "chaos_drops": 0,
                         "db_swaps": 0, "hostile_quarantined": 0,
                         "cache_op_errors": 0,
                         "prewarm_runs": 0, "prewarm_keys": 0,
                         "prewarm_bytes": 0,
                         "prewarm_deadline_exceeded": 0,
                         "prewarm_cold_joins": 0,
                         "handoff_published": 0,
                         "handoff_prefetched": 0,
                         "handoff_abandoned": 0}
        # runtime chaos knobs, steered via POST /chaos mid-run
        import random
        self._chaos_rng = random.Random(seed)
        self.error_rate = 0.0       # answer 500 internal (brownout)
        self.drop_rate = 0.0        # do the work, drop the response
        self.cache_error_rate = 0.0  # cache-tier ops answer 500
        self.db_generation = 0      # memo/advisory-DB generation
        # per-replica SLO engine: availability burn over this sim's
        # own outcomes, exported age-keyed for federation
        # (lazy import: obs/slo.py is stdlib-only). The
        # objective is a knob because compressed soak runs need a
        # tighter target for a scripted brownout to trip decisively
        # inside one burn window.
        from ..obs.slo import SLO, SloEngine, default_slos
        slos = default_slos()
        if slo_availability != 0.99:
            slos = [SLO(name="availability", kind="availability",
                        objective=slo_availability)] + \
                   [s for s in slos if s.kind != "availability"]
        self.slo = SloEngine(slos)
        # per-sim cost books (obs/cost.py): each sim owns its OWN
        # ledger (many sims share one process, the global singleton
        # would mix their invoices); charged in scan() with exactly
        # the simulated service wall, so the fleet books balance
        # identically to a real replica's
        from ..obs.cost import CostLedger
        self.cost_ledger = CostLedger()
        self._device_s = 0.0      # measured device-time integral
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ----

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd \
            else self._port

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}"

    def start(self) -> "SimReplica":
        self._httpd = ThreadingHTTPServer(
            (self.addr, self._port), _make_handler(self))
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"sim-{self.name}")
        self._thread.start()
        if self.warming:
            threading.Thread(target=self._prewarm, daemon=True,
                             name=f"sim-{self.name}-prewarm").start()
        return self

    # ---- elastic lifecycle (docs/serving.md "Elastic lifecycle") --

    def _touch_warm(self, digests) -> list:
        """Insert/refresh digests in the recency book; returns the
        NEWLY seen ones (the write-through set for the shared memo
        tier). Lock held briefly; no IO here."""
        fresh = []
        with self._lock:
            for d in digests:
                if not d:
                    continue
                if d not in self._warm:
                    fresh.append(d)
                self._warm[d] = self._warm.get(d, 0) + 1
                self._warm.move_to_end(d)
            while len(self._warm) > self.hot_cap:
                self._warm.popitem(last=False)
        return fresh

    def _memo_publish(self, digests) -> None:
        """Write-through to the shared memo tier (one marker file
        per digest, content = the digest). Best-effort: the tier
        degrading must never fail a scan."""
        if not self.memo_dir:
            return
        try:
            os.makedirs(self.memo_dir, exist_ok=True)
        except OSError:
            # memo-tier outage: scans still work, joins go cold
            return
        for d in digests:
            path = os.path.join(self.memo_dir, _memo_fname(d))
            if os.path.exists(path):
                continue
            try:
                with open(path, "w", encoding="utf-8") as f:
                    f.write(d)
            except OSError:
                # memo-tier outage: scans still work, joins go cold
                break

    def _memo_digests(self) -> list:
        """Shared-tier listing, newest-written first, so a deadline
        cut mid-walk keeps the most recently published (hottest)
        entries staged. Empty on outage — the caller degrades to a
        cold join."""
        try:
            entries = []
            with os.scandir(self.memo_dir) as it:
                for e in it:
                    if e.is_file():
                        entries.append((e.stat().st_mtime, e.path))
        except OSError:
            return []
        out = []
        for _mt, path in sorted(entries, reverse=True):
            try:
                with open(path, encoding="utf-8") as f:
                    d = f.read().strip()
            except OSError:
                continue
            if d:
                out.append(d)
        return out

    def _prewarm(self) -> None:
        """Pre-join prewarm: compute the key ranges the POST-join
        ring assigns this replica (pure cross-process placement),
        stage them from the shared memo tier, then flip ready.
        Bounded by prewarm_deadline_s — deadline hit or tier outage
        degrades to a cold join, never a wedged scale-up."""
        from .lifecycle import prewarm_ranges
        self._inc("prewarm_runs")
        t0 = time.monotonic()
        digests = self._memo_digests()
        staged = 0
        nbytes = 0
        exceeded = False
        if digests:
            owned = prewarm_ranges(self.ring_members, self.name,
                                   digests)
            for d in owned:
                if self.prewarm_deadline_s and \
                        time.monotonic() - t0 \
                        >= self.prewarm_deadline_s:
                    exceeded = True
                    break
                if self.prewarm_delay_ms:
                    # simulated memo-tier fetch latency (the bench's
                    # degraded-tier arm drives the deadline with it)
                    time.sleep(self.prewarm_delay_ms / 1000.0)
                self._touch_warm([d])
                staged += 1
                nbytes += len(d)
        self.prewarm_seconds = round(time.monotonic() - t0, 6)
        self._inc("prewarm_keys", staged)
        self._inc("prewarm_bytes", nbytes)
        if exceeded:
            self._inc("prewarm_deadline_exceeded")
            self._inc("prewarm_cold_joins")
        elif not digests:
            self._inc("prewarm_cold_joins")
        self.warming = False

    def handoff(self) -> dict:
        """``GET /handoff`` — the recency-ordered hot-digest export
        (oldest first, hottest last) a drain orchestrator feeds to
        :func:`trivy_tpu_torch.router.lifecycle.plan_handoff`."""
        with self._lock:
            digests = list(self._warm)
        self._inc("handoff_published", len(digests))
        return {"name": self.name, "draining": self.draining,
                "digests": digests}

    def prefetch(self, body: dict) -> dict:
        """``POST /prefetch`` — take a departing peer's hot digests
        into this replica's warm state (no service time: a prefetch
        is a memo pull, not a scan)."""
        digests = [str(d) for d in body.get("digests") or [] if d]
        fresh = self._touch_warm(digests)
        self._memo_publish(fresh)
        self._inc("handoff_prefetched", len(digests))
        return {"accepted": len(digests), "name": self.name}

    def drain(self) -> None:
        self.draining = True

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    def kill(self) -> None:
        """Abrupt in-process death: close the listening socket with
        no drain — in-flight requests error out at the router, which
        must replay them elsewhere (the soak kill step for fleets
        too large to spawn as subprocesses)."""
        self.stop()

    def chaos(self, body: dict) -> dict:
        """``POST /chaos`` — runtime-steerable failure knobs. Absent
        keys leave the knob alone; returns the full current state so
        the harness can read-modify-write."""
        with self._lock:
            if "error_rate" in body:
                self.error_rate = max(
                    0.0, min(1.0, float(body["error_rate"])))
            if "drop_rate" in body:
                self.drop_rate = max(
                    0.0, min(1.0, float(body["drop_rate"])))
            if "cache_error_rate" in body:
                self.cache_error_rate = max(
                    0.0, min(1.0, float(body["cache_error_rate"])))
            if "service_ms" in body:
                self.service_ms = max(0.0,
                                      float(body["service_ms"]))
            if "db_generation" in body:
                gen = int(body["db_generation"])
                if gen != self.db_generation:
                    # hot swap: a new advisory-DB generation strands
                    # the warm state, exactly like a memo ctx_sig
                    # change — the next scan of a known digest is
                    # cold again
                    self.db_generation = gen
                    self._warm.clear()
                    self.counters["db_swaps"] += 1
            return {"error_rate": self.error_rate,
                    "drop_rate": self.drop_rate,
                    "cache_error_rate": self.cache_error_rate,
                    "service_ms": self.service_ms,
                    "db_generation": self.db_generation}

    def warm_digests(self) -> set:
        with self._lock:
            return set(self._warm)

    # ---- request handlers ----

    def _inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def _admit_tenant(self, tenant: str) -> float:
        """0.0 = admitted; > 0 = retry-after seconds (429)."""
        if self.tenant_rate <= 0:
            return 0.0
        now = time.monotonic()
        with self._lock:
            tokens, last = self._buckets.get(
                tenant, (self.tenant_rate, now))
            tokens = min(self.tenant_rate,
                         tokens + (now - last) * self.tenant_rate)
            if tokens >= 1.0:
                self._buckets[tenant] = (tokens - 1.0, now)
                return 0.0
            self._buckets[tenant] = (tokens, now)
            return round((1.0 - tokens) / self.tenant_rate, 3)

    def scan(self, body: dict, tenant: str) -> tuple:
        """(status, payload, drop_response). Models the server's
        drain gate, idempotency window, memo warmth and service
        time."""
        if self.draining:
            self._inc("drained_rejects")
            return 503, {"code": "unavailable",
                         "msg": "sim draining"}, False
        wait = self._admit_tenant(tenant or "")
        if wait > 0:
            self._inc("rate_limited")
            return 429, {"code": "rate_limited",
                         "msg": f"tenant {tenant!r} over rate",
                         "retry_after_s": wait}, False
        key = str(body.get("idempotency_key") or "")
        if key:
            with self._lock:
                cached = self._idem.get(key)
            if cached is not None:
                self._inc("deduped")
                return 200, dict(cached, deduped=True), False
        with self._lock:
            chaos_err = (self.error_rate > 0
                         and self._chaos_rng.random()
                         < self.error_rate)
        if chaos_err:
            # brownout window: a genuine 500 — terminal `failed` at
            # the router, a bad event on this replica's SLO books
            self._inc("chaos_errors")
            self.slo.record("failed")
            return 500, {"code": "internal",
                         "msg": "sim chaos error window"}, False
        blob_ids = [str(b) for b in body.get("blob_ids") or []]
        base = blob_ids[0] if blob_ids else ""
        t0 = time.monotonic()
        with self._lock:
            self.inflight += 1
            hit = base in self._warm if base else False
        fresh = self._touch_warm(blob_ids)
        # write-through to the shared memo tier so a future joiner's
        # prewarm walk finds this replica's warm work
        self._memo_publish(fresh)
        try:
            with self._sem:             # finite parallelism
                if self.service_ms:
                    # a memo hit skips the simulated analyze work,
                    # like the real findings memo does
                    time.sleep(self.service_ms / 1000.0
                               * (0.1 if hit else 1.0))
            # cost attribution: the simulated service wall IS the
            # device time; booking the same value on both sides
            # keeps the fleet accounting identity exact
            work_s = (self.service_ms / 1000.0
                      * (0.1 if hit else 1.0)) \
                if self.service_ms else 0.0
            with self._lock:
                self._device_s += work_s
            self.cost_ledger.charge(
                tenant or "", device_interval_s=work_s,
                memo_hits=1 if hit else 0,
                memo_misses=0 if hit else 1,
                requests=1)
            with self._lock:
                self.counters["scans"] += 1
                n = self.counters["scans"]
                if hit:
                    self.counters["memo_hits"] += 1
            if self.kill_after and n >= self.kill_after:
                # replica death mid-storm: the response for THIS
                # request (and every other in-flight one) is never
                # written — the router must replay them elsewhere
                os._exit(17)
            payload = {"os": {"family": "sim", "name": "0"},
                       "results": [],
                       "memo_hit": hit,
                       "db_generation": self.db_generation,
                       "replica": self.name}
            if body.get("hostile"):
                # hostile-artifact trickle: the guard layer's
                # contract is quarantine-and-degrade, never crash —
                # a 200 with the degraded verdict, like the real
                # server's per-target FailureCause path
                payload["degraded"] = True
                payload["quarantined"] = [str(body.get("target")
                                              or "")]
                self._inc("hostile_quarantined")
            if key:
                with self._lock:
                    self._idem[key] = payload
                    while len(self._idem) > IDEM_CAP:
                        self._idem.popitem(last=False)
            drop = bool(self.flaky_every
                        and n % self.flaky_every == 0)
            if not drop and self.drop_rate > 0:
                with self._lock:
                    drop = self._chaos_rng.random() < self.drop_rate
                if drop:
                    self._inc("chaos_drops")
            if drop:
                self._inc("dropped")
            # the work completed, whoever hears about it — a dropped
            # response is still a good event on this replica's books
            self.slo.record("ok", time.monotonic() - t0)
            return 200, payload, drop
        finally:
            with self._lock:
                self.inflight -= 1

    def cache_op(self, path: str, body: dict):
        self._inc("cache_ops")
        with self._lock:
            outage = (self.cache_error_rate > 0
                      and self._chaos_rng.random()
                      < self.cache_error_rate)
        if outage:
            # cache-tier outage window: a genuine 500 the resilient
            # cache layer circuit-breaks around in a real server —
            # terminal `failed` at the router, NOT an SLO-bad scan
            self._inc("cache_op_errors")
            return None
        op = path[len(CACHE_PREFIX):]
        with self._lock:
            if op == "PutBlob":
                self._blobs.add(str(body.get("diff_id") or ""))
            elif op == "DeleteBlobs":
                for b in body.get("blob_ids") or []:
                    self._blobs.discard(str(b))
                    self._warm.pop(str(b), None)
            elif op == "MissingBlobs":
                blob_ids = [str(b)
                            for b in body.get("blob_ids") or []]
                return {"missing_artifact": True,
                        "missing_blob_ids":
                            [b for b in blob_ids
                             if b not in self._blobs]}
        return {}

    def health(self) -> dict:
        with self._lock:
            inflight = self.inflight
        if self.draining:
            status = "draining"
        elif self.warming:
            status = "warming"
        else:
            status = "ok"
        return {"status": status,
                "draining": self.draining,
                "warming": self.warming,
                "inflight": inflight,
                "build": {"replica": self.name, "sim": True}}

    def metrics(self) -> dict:
        from ..obs.procstats import process_self_stats
        with self._lock:
            out = dict(self.counters)
            out["warm_digests"] = len(self._warm)
            out["idempotency_entries"] = len(self._idem)
            out["tenant_buckets"] = len(self._buckets)
            out["inflight"] = self.inflight
            out["db_generation"] = self.db_generation
        out["draining"] = self.draining
        out["warming"] = self.warming
        out["prewarm_seconds"] = self.prewarm_seconds
        out["name"] = self.name
        out["process"] = process_self_stats()
        out["slo"] = self.slo.snapshot()
        return out

    def build_info(self) -> dict:
        return {"version": "sim", "torch_version": "",
                "cuda_version": "",
                "backend": "sim", "sched": "sim"}

    def metrics_text(self) -> str:
        """Minimal but valid 0.0.4 exposition — enough families for
        the federation plane's merged view (counters + the process
        self-stats the soak leak audit reads off every process)."""
        m = self.metrics()
        lines = []
        lines.append("# HELP trivy_tpu_sim_events_total Simulated "
                     "replica lifecycle events by kind.")
        lines.append("# TYPE trivy_tpu_sim_events_total counter")
        for k in sorted(self.counters):
            lines.append(
                f'trivy_tpu_sim_events_total{{event="{k}"}} '
                f"{m.get(k, 0)}")
        # the elastic-lifecycle families by their fleet-wide names
        # (docs/serving.md "Elastic lifecycle") — same spellings the
        # real server and the router front expose, so a merged
        # federation view aggregates sim and real replicas alike
        for kind, fams in (
                ("prewarm", ("keys", "bytes", "deadline_exceeded")),
                ("handoff", ("published", "prefetched",
                             "abandoned"))):
            for sub in fams:
                fam = f"trivy_tpu_{kind}_{sub}_total"
                lines.append(f"# HELP {fam} Elastic-lifecycle "
                             f"{kind} counter.")
                lines.append(f"# TYPE {fam} counter")
                lines.append(f"{fam} {m.get(f'{kind}_{sub}', 0)}")
        lines.append("# HELP trivy_tpu_prewarm_seconds_total Wall "
                     "seconds spent in prewarm walks.")
        lines.append("# TYPE trivy_tpu_prewarm_seconds_total "
                     "counter")
        lines.append("trivy_tpu_prewarm_seconds_total "
                     f"{m.get('prewarm_seconds', 0.0)}")
        proc = m.get("process") or {}
        for key, fam in (("rss_bytes",
                          "trivy_tpu_process_rss_bytes"),
                         ("open_fds", "trivy_tpu_process_open_fds"),
                         ("threads", "trivy_tpu_process_threads")):
            v = proc.get(key)
            if v is None or (isinstance(v, int) and v < 0):
                continue
            lines.append(f"# HELP {fam} Process self-stat gauge.")
            lines.append(f"# TYPE {fam} gauge")
            lines.append(f"{fam} {v}")
        return "\n".join(lines) + "\n"

    def metrics_snapshot(self) -> dict:
        """``GET /metrics/snapshot`` — the federation pull contract
        (same shape as ``rpc/server.py metrics_snapshot``): name,
        build identity, prom text, the age-keyed SLO export, and the
        replica's monotonic now for staleness checks."""
        with self._lock:
            measured = self._device_s
        return {"name": self.name,
                "build_info": self.build_info(),
                "prom": self.metrics_text(),
                "slo_export": self.slo.export_state(),
                "cost_export": {
                    "export": self.cost_ledger.export_state(),
                    "measured_device_s": round(measured, 6)},
                "mono": time.monotonic()}

    def costs(self) -> dict:
        """``GET /costs`` — same contract as the real server's
        (rpc/server.py): invoice + identity verdict + federation
        export."""
        from ..obs.cost import balance
        with self._lock:
            measured = self._device_s
        out = self.cost_ledger.snapshot()
        out["measured_device_s"] = round(measured, 6)
        out["balance"] = balance(out.get("device_s", 0.0), measured)
        out["replica"] = self.name
        out["export"] = self.cost_ledger.export_state()
        out["complete"] = True
        return out


def _make_handler(sim: SimReplica):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass                    # quiet: bench spawns fleets

        def _reply(self, code: int, payload: dict,
                   headers=None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers or ():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, sim.health())
            elif self.path == "/metrics":
                self._reply(200, sim.metrics())
            elif self.path == "/metrics/snapshot":
                self._reply(200, sim.metrics_snapshot())
            elif self.path == "/handoff":
                self._reply(200, sim.handoff())
            elif self.path == "/costs":
                self._reply(200, sim.costs())
            else:
                self._reply(404, {"code": "bad_route",
                                  "msg": self.path})

        def do_POST(self):
            if self.path == "/drain":
                sim.drain()
                self._reply(200, {"draining": True})
                return
            if self.path == "/chaos":
                try:
                    length = int(self.headers.get("Content-Length")
                                 or 0)
                    body = json.loads(self.rfile.read(length)
                                      or b"{}")
                except ValueError:
                    body = None
                if not isinstance(body, dict):
                    self._reply(400, {"code": "malformed",
                                      "msg": "chaos wants a JSON "
                                             "object"})
                    return
                self._reply(200, sim.chaos(body))
                return
            try:
                length = int(self.headers.get("Content-Length")
                             or 0)
                body = json.loads(self.rfile.read(length)
                                  or b"{}")
            except ValueError:
                self._reply(400, {"code": "malformed",
                                  "msg": "invalid json body"})
                return
            if not isinstance(body, dict):
                body = {}
            if self.path == "/prefetch":
                self._reply(200, sim.prefetch(body))
            elif self.path == SCANNER_PREFIX + "Scan":
                tenant = str(body.get("tenant")
                             or self.headers.get(TENANT_HEADER)
                             or "")
                code, payload, drop = sim.scan(body, tenant)
                if drop:
                    # lost response: work done, client unanswered
                    self.close_connection = True
                    return
                headers = []
                if code == 429:
                    import math
                    headers = [("Retry-After", str(int(math.ceil(
                        payload.get("retry_after_s", 1.0)))))]
                self._reply(code, payload, headers)
            elif self.path.startswith(CACHE_PREFIX):
                if sim.draining:
                    self._reply(503, {"code": "unavailable",
                                      "msg": "sim draining"})
                    return
                res = sim.cache_op(self.path, body)
                if res is None:
                    self._reply(500, {"code": "internal",
                                      "msg": "sim cache outage"})
                    return
                self._reply(200, res)
            else:
                self._reply(404, {"code": "bad_route",
                                  "msg": self.path})

    return Handler


def main(argv=None) -> int:
    """Subprocess entry: start one replica and serve until killed.
    Prints ``PORT <n>`` on stdout so the spawning controller learns
    the bound port when asked for port 0."""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="trivy-tpu-sim-replica")
    p.add_argument("--name", default="sim")
    p.add_argument("--addr", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--service-ms", type=float, default=5.0)
    p.add_argument("--max-concurrent", type=int, default=2)
    p.add_argument("--kill-after", type=int, default=0)
    p.add_argument("--flaky-every", type=int, default=0)
    p.add_argument("--tenant-rate", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=20260804)
    p.add_argument("--slo-availability", type=float, default=0.99)
    p.add_argument("--memo-dir", default="",
                   help="shared memo-tier directory (write-through "
                        "warm state; enables prewarm when "
                        "--ring-members is also given)")
    p.add_argument("--ring-members", default="",
                   help="comma-separated current fleet names; boot "
                        "in the warming state and prewarm the "
                        "post-join key ranges before flipping ready")
    p.add_argument("--prewarm-deadline-s", type=float, default=5.0)
    p.add_argument("--prewarm-delay-ms", type=float, default=0.0)
    p.add_argument("--hot-cap", type=int, default=HOT_CAP)
    args = p.parse_args(argv)
    members = [m for m in args.ring_members.split(",") if m]
    sim = SimReplica(name=args.name, port=args.port,
                     addr=args.addr, service_ms=args.service_ms,
                     max_concurrent=args.max_concurrent,
                     kill_after=args.kill_after,
                     flaky_every=args.flaky_every,
                     tenant_rate=args.tenant_rate,
                     seed=args.seed,
                     slo_availability=args.slo_availability,
                     memo_dir=args.memo_dir,
                     ring_members=members,
                     prewarm_deadline_s=args.prewarm_deadline_s,
                     prewarm_delay_ms=args.prewarm_delay_ms,
                     hot_cap=args.hot_cap).start()
    print(f"PORT {sim.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    sim.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
