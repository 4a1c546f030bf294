"""The soak runner (copied from ``trivy_tpu/soak/runner.py``): executes
a scenario schedule against a live routed fleet and renders the
verdict.

Fleet shape (all in one process group, CPU-sim devices):

* a :class:`router.core.ScanRouter` + HTTP front
  (``router.front.RouterServer``) with a health prober;
* N sim replicas (``router.sim.SimReplica``) — in-process by
  default, one OS process each with ``--mode subprocess`` — each
  carrying its own SLO engine and ``/metrics/snapshot``;
* the watch loop (``watch.loop.WatchLoop``) fed by a
  ``WebhookSource``: every push arrival and storm envelope enters
  as a registry notification, debounces, and submits through the
  router — watch traffic rides the same fleet as everything else;
* the federation plane (``obs.federate.Federator``) pulling
  replica SLO exports for the fleet burn-rate verdict, and a local
  tracer + flight recorder whose trip-transition dumps are the
  evidence trail for designed SLO trips.

Invariants enforced at quiesce (the run FAILS on any):

* global books: every accepted request reaches exactly one terminal
  state — router ``lost == 0``, watch ``events == scans + deduped +
  shed``, every submitted scan resolved;
* SLO trips exactly: no fleet ``slo_ok == False`` epoch before the
  first step designed to trip, and every ``expect_trip`` step does
  trip (with flight-recorder dumps from the disruption window);
* the leak audit's flat-after-warm-up verdict
  (:class:`soak.audit.ResourceAudit`).

The report is schema-stable JSON (``sort_keys``); its ``stable``
subtree is byte-identical across same-seed runs, with every
wall-clock-dependent measurement quarantined elsewhere.

One departure from the reference, the verdict clock
(:meth:`SoakRunner._sample_epoch`): the reference stamps each epoch
before its audit sample and federation scrape, and measures verdicts
from an origin taken before the fleet's set-up while the steps run on
the timeline thread's own. A verdict could then carry failures that
happened after its stamp, and a designed trip be called early. Here
every verdict and ok-rate point is stamped after the scrape that
produced it, and verdicts, ok-rate points and steps share one origin
(``_origin``, taken once the fleet is up). Only ``first_trip_t``, the
trip verdict and the sustained-throughput window move; all three read
the wall clock in either package.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..router.core import SCAN_PATH, HealthProber, ScanRouter
from ..router.metrics import ROUTER_METRICS
from ..router.sim import TENANT_HEADER
from ..watch.loop import WatchConfig, WatchLoop
from ..watch.source import WebhookSource
from .audit import ResourceAudit
from .registry import SyntheticRegistry
from .scenario import Scenario

log = logging.getLogger("trivy_tpu_torch.soak.runner")

REPORT_SCHEMA = 1
# real-seconds margin added to disruption windows when classifying
# "steady" epochs for the sustained-throughput measurement
_STEADY_MARGIN_S = 1.0


class _ScanResult:
    """What the watch loop reaps: ``error`` empty means the scan
    reached a good terminal state."""

    __slots__ = ("status", "payload", "error", "replica",
                 "memo_hit", "degraded")

    def __init__(self, status, payload, error=""):
        self.status = status
        self.payload = payload or {}
        self.error = error
        self.replica = self.payload.get("routed_replica", "")
        self.memo_hit = bool(self.payload.get("memo_hit"))
        self.degraded = bool(self.payload.get("degraded"))


class _ScanRequest:
    """Future-like handle satisfying the WatchLoop contract
    (``.done``, ``.result(timeout)``, ``.trace_id``)."""

    __slots__ = ("_event", "_result", "trace_id")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self.trace_id = ""

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("scan not resolved")
        return self._result

    def finish(self, result) -> None:
        self._result = result
        self._event.set()


class RouterSubmitRunner:
    """``submit_path`` adapter: watch submissions become routed
    twirp Scans through the fleet front, each under its own trace
    span, each booked into the local SLO engine (trip dumps)."""

    backend = "cpu"

    def __init__(self, soak: "SoakRunner", max_workers: int):
        self.soak = soak
        self.pool = ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="soak-scan")

    def submit_path(self, path, options, tenant: str = "",
                    priority: int = 0, trace_id: str = "",
                    parent_span_id: str = "") -> _ScanRequest:
        manifest = self.soak.registry.resolve_path(path)
        req = _ScanRequest()
        self.pool.submit(self._work, req, manifest, tenant,
                         trace_id, parent_span_id)
        return req

    def _work(self, req, manifest, tenant, trace_id,
              parent_span_id) -> None:
        soak = self.soak
        span = soak.tracer.start_request(
            manifest["digest"][:19], trace_id=trace_id,
            parent_span_id=parent_span_id)
        req.trace_id = span.trace_id
        key = f"{manifest['digest']}:{soak.next_key()}"
        raw = json.dumps(
            soak.registry.scan_body(manifest,
                                    idempotency_key=key)).encode()
        t0 = time.monotonic()
        try:
            status, out, _ = soak.router.route(
                SCAN_PATH, raw,
                headers={TENANT_HEADER: tenant})
            try:
                payload = json.loads(out or b"{}")
            except ValueError:
                payload = {}
            if not isinstance(payload, dict):
                payload = {}
            error = "" if status == 200 else \
                f"status {status}: {payload.get('code', '')}"
            result = _ScanResult(status, payload, error)
            span.end("ok" if status == 200 else "error")
            soak.book_scan(result, span.trace_id,
                           time.monotonic() - t0)
            req.finish(result)
        except Exception as e:    # noqa: BLE001 — a scan worker
            # must always resolve its future; anything else wedges
            # the watch loop's in-flight table at drain
            span.end("error")
            soak.book_scan(_ScanResult(0, {}, repr(e)),
                           span.trace_id, time.monotonic() - t0)
            req.finish(_ScanResult(0, {}, repr(e)))

    def close(self) -> None:
        self.pool.shutdown(wait=True)


class SoakRunner:
    """One scenario, one fleet, one verdict."""

    def __init__(self, scenario: Scenario, replicas: int = 3,
                 mode: str = "inproc", token: str = "",
                 epoch_s: float = 0.5, service_ms: float = 5.0,
                 max_concurrent: int = 4,
                 slo_availability: float = 0.995,
                 max_inflight: int = 64):
        if mode not in ("inproc", "subprocess"):
            raise ValueError(f"unknown soak mode {mode!r}")
        self.scenario = scenario
        self.n_replicas = max(1, replicas)
        self.mode = mode
        self.token = token
        self.epoch_s = max(0.05, epoch_s)
        self.service_ms = service_ms
        self.max_concurrent = max_concurrent
        self.slo_availability = slo_availability
        self.max_inflight = max_inflight
        self.registry = SyntheticRegistry(scenario.spec.registry)
        # local obs plane: tracer + recorder + the SLO engine whose
        # trip transitions dump evidence (replica engines carry the
        # federated verdict; this one carries the dumps)
        import tempfile
        from ..obs.recorder import FlightRecorder
        from ..obs.slo import SLO, SloEngine
        from ..obs.trace import Tracer
        self._tmpdir = tempfile.mkdtemp(prefix="soak-")
        self.recorder = FlightRecorder(
            dump_dir=self._tmpdir + "/dumps")
        self.tracer = Tracer(enabled=True, recorder=self.recorder)
        self.engine = SloEngine(
            [SLO(name="availability", kind="availability",
                 objective=slo_availability)],
            recorder=self.recorder)
        self.audit = ResourceAudit()
        self._lock = threading.Lock()
        self._key = 0
        self.counters = {"pushed": 0, "push_accepted": 0,
                         "push_malformed": 0, "storm_envelopes": 0,
                         "scans_ok": 0, "scans_failed": 0,
                         "scans_shed": 0, "degraded": 0,
                         "memo_hits": 0, "kills": 0,
                         "scale_ups": 0, "scale_downs": 0,
                         "hot_swaps": 0}
        self.verdicts: list = []     # (t_real, slo_ok, complete)
        self._ok_series: list = []   # (t_real, ok, accepted)
        self._waiters: list = []
        self.controller = None
        self.router = None
        self.prober = None
        self.loop = None
        self.source = None
        self.submitter = None
        self._fed_state = {"key": None, "fed": None}
        # the one origin of steps, verdicts and ok-rate points (run()
        # takes it again once the fleet is up)
        self._origin = time.monotonic()

    # ---- bookkeeping hooks ----

    def next_key(self) -> int:
        with self._lock:
            self._key += 1
            return self._key

    def book_scan(self, result: _ScanResult, trace_id: str,
                  latency_s: float) -> None:
        """Terminal bookkeeping for one routed scan: soak counters
        plus the local SLO engine (ok/failed/timed_out classes feed
        burn; 429/503 are shed — transient by the tree's contract,
        they never count against availability)."""
        with self._lock:
            if result.status == 200:
                self.counters["scans_ok"] += 1
                if result.memo_hit:
                    self.counters["memo_hits"] += 1
                if result.degraded:
                    self.counters["degraded"] += 1
            elif result.status in (429, 503):
                self.counters["scans_shed"] += 1
            else:
                self.counters["scans_failed"] += 1
        if result.status == 200:
            self.engine.record("ok", latency_s,
                               trace_id=trace_id)
        elif result.status == 408:
            self.engine.record("timed_out", latency_s,
                               trace_id=trace_id)
        elif result.status != 429:
            # 503 included: a router "no routable replica" during a
            # brownout IS the user-visible outage — counting it bad
            # here makes the local engine trip (and dump evidence)
            # exactly when the fleet fails its users
            self.engine.record("failed", latency_s,
                               trace_id=trace_id)

    # ---- fleet lifecycle ----

    def _setup_fleet(self) -> None:
        from ..router.scaler import (SimReplicaController,
                                     SubprocessReplicaController)
        ROUTER_METRICS.reset()
        # elastic lifecycle (docs/serving.md): every replica shares
        # one memo-tier directory, so scale_up steps exercise the
        # real prewarm walk (join warming, stage owned ranges, flip
        # ready) and scale_down steps run the drain handoff
        memo_dir = self._tmpdir + "/memo"
        if self.mode == "inproc":
            self.controller = SimReplicaController(
                prefix="soak",
                service_ms=self.service_ms,
                max_concurrent=self.max_concurrent,
                seed=self.scenario.spec.seed,
                slo_availability=self.slo_availability,
                memo_dir=memo_dir)
        else:
            self.controller = SubprocessReplicaController(
                prefix="soak", extra_args=[
                    "--service-ms", str(self.service_ms),
                    "--max-concurrent", str(self.max_concurrent),
                    "--seed", str(self.scenario.spec.seed),
                    "--slo-availability",
                    str(self.slo_availability),
                    "--memo-dir", memo_dir])
        self.router = ScanRouter(token=self.token)
        for _ in range(self.n_replicas):
            name, url = self.controller.start()
            self.router.add_replica(name, url)
        self.prober = HealthProber(self.router, interval_s=0.2,
                                   timeout_s=1.0)
        self.prober.start()
        self.source = WebhookSource(
            resolver=self.registry.resolver(), maxsize=8192,
            tenant="watch")
        self.submitter = RouterSubmitRunner(
            self, max_workers=self.max_inflight)
        self.loop = WatchLoop(
            self.submitter, self.source,
            config=WatchConfig(debounce_s=0.05,
                               max_inflight=self.max_inflight,
                               submit_retries=2,
                               checkpoint_path=self._tmpdir
                               + "/cursor.json"),
            options=object())
        self._register_probes()

    def _register_probes(self) -> None:
        # gated series are the leak signals: process self-stats
        # (added by the audit itself) plus structures that must
        # QUIESCE, not just stay under a cap
        self.audit.add_probe(
            "watch_backlog",
            lambda: len(self.loop._pending)
            + len(self.loop._inflight))
        self.audit.add_probe(
            "cursor_ack_window",
            lambda: self.loop.cursor.stats()["ack_window"])
        # cap-bounded structures: they legitimately grow TOWARD
        # their caps all run long (AFFINITY_CAP LRU, DUMP_CAP FIFO
        # — both regression-test-enforced), so the flat-after-warmup
        # test can't gate them; the audit tracks them for the report
        self.audit.add_probe(
            "router_affinity",
            lambda: self.router.stats()["affinity_entries"],
            gate=False)
        self.audit.add_probe(
            "recorder_dump_files",
            lambda: self.recorder.stats().get("dump_files", 0),
            gate=False)
        # corpus-bounded structures: recorded for visibility, never
        # gated (they saturate at corpus size, which a short run
        # only ever approaches from below)
        self.audit.add_probe(
            "registry_index",
            lambda: len(self.registry._by_digest), gate=False)
        self.audit.add_probe("replica_warm_digests",
                             self._probe_replica("warm_digests"),
                             gate=False)
        self.audit.add_probe(
            "replica_idempotency",
            self._probe_replica("idempotency_entries"),
            gate=False)
        self.audit.add_probe("replica_rss_bytes",
                             self._probe_replica_rss)
        # high-water RSS rides the same sampler; the ratchet is
        # monotone by design (procstats.peak ratchet), so it informs
        # the report but never gates the bounded-growth verdict
        self.audit.add_probe("replica_peak_rss_bytes",
                             self._probe_replica_peak_rss,
                             gate=False)

    def _replica_metrics(self) -> list:
        import urllib.request
        out = []
        for h in self.router.replicas():
            try:
                with urllib.request.urlopen(
                        h.url + "/metrics", timeout=1.0) as resp:
                    out.append(json.loads(resp.read() or b"{}"))
            except Exception:    # noqa: BLE001 — dead replicas are
                # expected mid-chaos; the sampler degrades
                continue
        return out

    def _probe_replica(self, key: str):
        def probe():
            rows = self._replica_metrics()
            if not rows:
                return -1
            return max(int(r.get(key, 0)) for r in rows)
        return probe

    def _probe_replica_rss(self):
        rows = self._replica_metrics()
        vals = [int((r.get("process") or {}).get("rss_bytes", -1))
                for r in rows]
        vals = [v for v in vals if v > 0]
        return max(vals) if vals else -1

    def _probe_replica_peak_rss(self):
        rows = self._replica_metrics()
        vals = [int((r.get("process") or {}).get(
            "peak_rss_bytes", -1)) for r in rows]
        vals = [v for v in vals if v > 0]
        return max(vals) if vals else -1

    def _teardown_fleet(self) -> None:
        for w in self._waiters:
            w.join(timeout=10.0)
        if self.prober is not None:
            self.prober.stop()
        if self.submitter is not None:
            self.submitter.close()
        if self.controller is not None:
            for name in list(getattr(self.controller, "replicas",
                                     None)
                             or getattr(self.controller, "procs",
                                        {})):
                try:
                    self.controller.stop(name)
                except Exception:   # noqa: BLE001 — already dead
                    pass

    # ---- federation verdicts ----

    def _fleet_verdict(self) -> dict:
        from ..obs.federate import Federator
        peers = [(h.name, h.url) for h in self.router.replicas()]
        key = tuple(peers)
        if key != self._fed_state["key"]:
            self._fed_state["key"] = key
            self._fed_state["fed"] = Federator(
                peers, token=self.token, timeout_s=1.0) \
                if peers else None
        fed = self._fed_state["fed"]
        if fed is None:
            return {"slo_ok": True, "complete": False}
        fleet = fed.fleet_slo({}, fed.collect())
        # the front's own engine is authoritative for user-visible
        # availability: a brownout ejects the erroring replicas
        # within a few requests (breakers), after which the outage
        # is router-side 503s the replica engines never see
        local_ok = all(v["ok"] for v in self.engine.verdicts())
        return {"slo_ok": local_ok
                and bool(fleet.get("slo_ok", True)),
                "complete": bool(fleet.get("complete", False)),
                "replicas": fleet.get("replicas", 0)}

    def _fleet_invoice(self) -> dict:
        """The per-tenant invoice at quiesce: the same federated
        ``GET /costs`` rollup the router front serves
        (obs/cost.py:federated_costs), plus the totals-match
        identity the report gates on — the invoice's per-tenant
        device-seconds must sum to the fleet ledger's attributed
        total."""
        from ..obs.cost import federated_costs
        inv = federated_costs(
            [(h.name, h.url) for h in self.router.replicas()],
            token=self.token)
        tenant_sum = sum(float(v.get("device_s", 0.0))
                         for v in (inv.get("tenants") or
                                   {}).values())
        fleet_total = float(inv.get("attributed_device_s", 0.0))
        inv["tenant_device_s"] = round(tenant_sum, 6)
        inv["totals_match"] = abs(tenant_sum - fleet_total) \
            <= max(1e-6, 1e-4 * max(fleet_total, 1.0))
        return inv

    # ---- step execution ----

    def _post_chaos(self, url: str, doc: dict) -> None:
        import urllib.request
        req = urllib.request.Request(
            url + "/chaos", data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=2.0):
                pass
        except Exception as e:   # noqa: BLE001 — a chaos POST to a
            # replica that just died is chaos doing its job
            log.warning("chaos POST to %s failed: %r", url, e)

    def _broadcast_chaos(self, doc: dict) -> None:
        for h in self.router.replicas():
            self._post_chaos(h.url, doc)

    def _routable_names(self) -> list:
        return [h.name for h in self.router.replicas()
                if not h.draining]

    def _do_kill(self) -> None:
        victims = self._routable_names()
        if len(victims) <= 1:
            log.warning("kill step skipped: fleet too small")
            return
        victim = victims[-1]
        log.info("soak: killing replica %s", victim)
        self.controller.kill(victim)
        with self._lock:
            self.counters["kills"] += 1

        def remove_later():
            time.sleep(1.0)
            self.router.remove_replica(victim)
        t = threading.Thread(target=remove_later, daemon=True,
                             name="soak-kill-reaper")
        t.start()
        self._waiters.append(t)

    def _do_scale_up(self) -> None:
        # the real join lifecycle: the new replica gets the current
        # ring membership, computes its post-join ranges, prewarms
        # out of the shared memo tier, and joins the ring WARMING —
        # the prober admits it when its /healthz flips ready
        members = self._routable_names()
        name, url = self.controller.start(ring_members=members)
        self.router.add_replica(
            name, url,
            warming=bool(self.controller.prewarm_enabled))
        ROUTER_METRICS.inc("scale_ups")
        with self._lock:
            self.counters["scale_ups"] += 1

    def _do_scale_down(self) -> None:
        victims = self._routable_names()
        if len(victims) <= 1:
            log.warning("scale-down skipped: fleet too small")
            return
        victim = victims[-1]
        self.router.mark_draining(victim)
        self.controller.drain(victim)
        ROUTER_METRICS.inc("scale_downs")
        ROUTER_METRICS.inc("drains_started")
        with self._lock:
            self.counters["scale_downs"] += 1
        # drain handoff: hand the victim's hot-digest set to its
        # ring successors while its in-flight work finishes —
        # best-effort, never blocks the drain
        from ..router.lifecycle import run_handoff
        run_handoff(self.router, victim, timeout_s=2.0)

        def quiesce():
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                h = self.router.replica(victim)
                if h is None:
                    return
                if h.inflight == 0 and h.probed_inflight == 0:
                    break
                time.sleep(0.05)
            self.controller.stop(victim)
            self.router.remove_replica(victim)
            ROUTER_METRICS.inc("drain_kills")
        t = threading.Thread(target=quiesce, daemon=True,
                             name="soak-drain-waiter")
        t.start()
        self._waiters.append(t)

    def _do_hot_swap(self, real_duration: float) -> None:
        """Rolling DB generation bump: one replica at a time across
        the window — the memo hot-swap pattern at fleet scale."""
        replicas = [(h.name, h.url)
                    for h in self.router.replicas()]
        if not replicas:
            return
        gap = real_duration / max(1, len(replicas))
        with self._lock:
            self.counters["hot_swaps"] += 1
            gen = self.counters["hot_swaps"]

        def roll():
            for i, (name, url) in enumerate(replicas):
                if i:
                    time.sleep(gap)
                self._post_chaos(url, {"db_generation": gen})
        t = threading.Thread(target=roll, daemon=True,
                             name="soak-hot-swap")
        t.start()
        self._waiters.append(t)

    def _do_storm(self, step) -> None:
        """A registry push burst shaped by the step's composed
        ``event-storm`` fault spec: ``storm_events`` envelopes over
        ``storm_digests`` distinct images (tag churn included) with
        ``storm_malformed`` malformed envelopes interleaved —
        the ``faults/`` scenario, materialized registry-side."""
        import random
        spec = step.fault_spec()
        n = spec.storm_events if spec and spec.storm_events else 128
        n_digests = max(1, (spec.storm_digests if spec else 0) or 8)
        n_malformed = max(0, spec.storm_malformed if spec else 0)
        rng = random.Random(spec.seed if spec
                            else self.scenario.spec.seed)
        # a deterministic image subset far from the popular head
        images = [((i * 2654435761) + rng.randrange(1 << 16))
                  % self.scenario.spec.registry.images
                  for i in range(n_digests)]
        malformed_at = set(rng.sample(
            range(n + n_malformed), n_malformed)) \
            if n_malformed else set()
        sent = bad = 0
        for slot in range(n + n_malformed):
            if slot in malformed_at:
                env = rng.choice([
                    {"events": "not-a-list"},
                    {"events": [{"action": "push",
                                 "target": {}}]},
                    ["not", "an", "envelope"],
                    {"events": [{"action": "push",
                                 "target": {"repository": "r"}}]},
                ])
                bad += 1
            else:
                env = self.registry.notification(
                    images[sent % n_digests],
                    event_id=f"storm-{slot}")
                sent += 1
            res = self.source.push_notification(env)
            with self._lock:
                self.counters["storm_envelopes"] += 1
                self.counters["push_accepted"] += \
                    res.get("accepted", 0)
                self.counters["push_malformed"] += \
                    res.get("malformed", 0)

    def _run_step(self, step) -> None:
        comp = self.scenario.spec.compression
        real_dur = step.duration / comp
        if step.kind == "storm":
            self._do_storm(step)
        elif step.kind == "kill":
            self._do_kill()
        elif step.kind == "scale_up":
            self._do_scale_up()
        elif step.kind == "scale_down":
            self._do_scale_down()
        elif step.kind == "hot_swap":
            self._do_hot_swap(real_dur)
        elif step.kind in ("brownout", "flaky", "cache_outage"):
            knob = {"brownout": "error_rate",
                    "flaky": "drop_rate",
                    "cache_outage": "cache_error_rate"}[step.kind]
            rate = step.value or 1.0
            # flaky scopes its drops to ONE replica (a bad NIC, not
            # a fleet event — same scoping as the replica-flaky
            # fault spec): failover replays absorb a single flaky
            # member, whereas fleet-wide drops open every breaker
            # and the cooldown aftermath trips the SLO outside the
            # designed window. Brownouts stay fleet-wide — that IS
            # the designed correlated failure.
            victims = None
            if step.kind == "flaky":
                live = sorted(self._routable_names())
                victims = live[:1]

            def window(knob=knob, rate=rate, dur=real_dur,
                       victims=victims):
                if victims is None:
                    self._broadcast_chaos({knob: rate})
                else:
                    for h in self.router.replicas():
                        if h.name in victims:
                            self._post_chaos(h.url, {knob: rate})
                time.sleep(dur)
                # reset fleet-wide either way: a scoped victim may
                # have been replaced mid-window; clearing a knob on
                # a healthy replica is a no-op
                self._broadcast_chaos({knob: 0.0})
            t = threading.Thread(target=window, daemon=True,
                                 name=f"soak-{step.kind}")
            t.start()
            self._waiters.append(t)

    # ---- the run ----

    def _push_arrival(self, image_index: int) -> None:
        env = self.registry.notification(image_index)
        res = self.source.push_notification(env)
        with self._lock:
            self.counters["pushed"] += 1
            self.counters["push_accepted"] += \
                res.get("accepted", 0)
            self.counters["push_malformed"] += \
                res.get("malformed", 0)

    def _timeline(self, sched: dict) -> None:
        """Walk arrivals and steps on the compressed clock. Behind
        schedule = push immediately (open loop never stalls)."""
        comp = self.scenario.spec.compression
        events = [(a[0] / comp, "arrival", a[1])
                  for a in sched["arrivals"]]
        events += [(st["t"] / comp, "step", st)
                   for st in sched["steps"]]
        events.sort(key=lambda e: (e[0], e[1]))
        for due, kind, payload in events:
            delay = due - self._clock()
            if delay > 0:
                time.sleep(delay)
            if kind == "arrival":
                self._push_arrival(payload)
            else:
                from .scenario import Step
                self._run_step(Step(**payload))

    def _clock(self) -> float:
        """Seconds since the run's one origin (``_origin``)."""
        return time.monotonic() - self._origin

    def _sample_epoch(self, ok_rate: bool = True) -> None:
        """One epoch of the sampler: the audit sample, the federated
        verdict and (with ``ok_rate``) the router's ok-rate point. Each
        is stamped after the scrape that produced it, so a verdict
        never carries a failure from after its own time, and on the
        origin the steps run on."""
        self.audit.sample()
        v = self._fleet_verdict()
        self.verdicts.append(
            (round(self._clock(), 3), v["slo_ok"], v["complete"]))
        if ok_rate:
            snap = ROUTER_METRICS.snapshot()
            self._ok_series.append(
                (self._clock(), snap["ok"], snap["accepted"]))

    def _disruption_windows(self) -> list:
        """Real-time [start, end] spans when throughput is expected
        to wobble (steps + margin) — excluded from the sustained-ips
        measurement."""
        comp = self.scenario.spec.compression
        out = []
        for st in self.scenario.spec.steps:
            start = st.t / comp - _STEADY_MARGIN_S
            end = st.t / comp + max(st.duration / comp, 0.5) \
                + _STEADY_MARGIN_S
            out.append((start, end))
        return out

    def _sustained_ips(self) -> dict:
        """Goodput (ok) and offered (accepted) rates over epochs
        wholly outside every disruption window — the steady-state
        throughput the full soak compares with the direct
        router storm at equivalent N."""
        windows = self._disruption_windows()
        total_dt = total_ok = total_acc = 0.0
        for (t_a, ok_a, acc_a), (t_b, ok_b, acc_b) in zip(
                self._ok_series, self._ok_series[1:]):
            if any(t_a < end and t_b > start
                   for start, end in windows):
                continue
            total_dt += t_b - t_a
            total_ok += ok_b - ok_a
            total_acc += acc_b - acc_a
        if total_dt <= 0:
            return {"ips": 0.0, "offered_ips": 0.0,
                    "seconds": 0.0, "scans": 0}
        return {"ips": round(total_ok / total_dt, 2),
                "offered_ips": round(total_acc / total_dt, 2),
                "seconds": round(total_dt, 2),
                "scans": int(total_ok)}

    def run(self) -> dict:
        sched = self.scenario.schedule()
        spec = self.scenario.spec
        real_total = spec.duration_s / spec.compression
        wall_start = time.time()
        t_mono = time.monotonic()
        self._setup_fleet()
        self._origin = time.monotonic()
        loop_stats: dict = {}

        def pump():
            loop_stats.update(
                self.loop.run(max_wall_s=real_total + 60.0))
        loop_thread = threading.Thread(target=pump, daemon=True,
                                       name="soak-watch-pump")
        loop_thread.start()
        timeline = threading.Thread(
            target=self._timeline, args=(sched,), daemon=True,
            name="soak-timeline")
        timeline.start()
        try:
            # epoch sampler: audit + federated verdict + ok-rate
            while timeline.is_alive():
                time.sleep(self.epoch_s)
                self._sample_epoch()
            timeline.join()
            for w in list(self._waiters):
                w.join(timeout=max(15.0, real_total))
            # quiesce: no more pushes; drain the loop through the
            # fleet, then take the final books
            self.source.close()
            loop_thread.join(timeout=120.0)
            self._sample_epoch(ok_rate=False)
            self.engine.verdicts()   # final trip eval → dumps
            return self._report(sched, loop_stats, wall_start,
                                time.monotonic() - t_mono)
        finally:
            self._teardown_fleet()

    # ---- the verdicts ----

    def _trip_analysis(self) -> dict:
        comp = self.scenario.spec.compression
        designed = [
            {"kind": st.kind, "t": st.t,
             "real_start": round(st.t / comp, 3),
             "real_end": round((st.t + st.duration) / comp
                               + _STEADY_MARGIN_S, 3)}
            for st in self.scenario.spec.steps if st.expect_trip]
        first_designed = min((d["real_start"] for d in designed),
                             default=None)
        trips = [t for t, ok, _ in self.verdicts if not ok]
        first_trip = trips[0] if trips else None
        # grace: federation staleness means a trip can surface one
        # epoch late, never early
        early_trip = (first_trip is not None
                      and (first_designed is None
                           or first_trip
                           < first_designed - 1e-9))
        missed_trip = bool(designed) and first_trip is None
        return {"expected": designed,
                "first_trip_t": first_trip,
                "tripped": first_trip is not None,
                "early_trip": early_trip,
                "missed_trip": missed_trip,
                "trips_exact": not early_trip and not missed_trip,
                "dumps": self.engine.dumps,
                "dump_dir": self.recorder.dump_dir}

    def _report(self, sched, loop_stats, wall_start,
                wall_s) -> dict:
        from ..obs.timeline import MergedTimeline, export_tracer
        router_stats = ROUTER_METRICS.snapshot()
        watch_ok = (loop_stats.get("events", 0)
                    == loop_stats.get("scans", 0)
                    + loop_stats.get("deduped", 0)
                    + loop_stats.get("shed", 0))
        lost = router_stats.get("lost", 0)
        books_ok = watch_ok and lost == 0
        trip = self._trip_analysis()
        audit_v = self.audit.verdict()
        invoice = self._fleet_invoice()
        peak_rss = [v for v in self.audit.series(
            "replica_peak_rss_bytes") if v > 0]
        replica_rows = sorted(self._replica_metrics(),
                              key=lambda r: r.get("name", ""))
        merged = MergedTimeline(
            [export_tracer(self.tracer, process="soak-front")])
        with self._lock:
            counters = dict(self.counters)
        stable = {
            "scenario": sched["name"],
            "seed": sched["seed"],
            "schedule_digest": self.scenario.digest(),
            "arrivals": len(sched["arrivals"]),
            "steps": len(sched["steps"]),
            "expected_trips": [d["kind"] for d in
                               trip["expected"]],
            "events_pushed": counters["pushed"]
            + counters["storm_envelopes"],
            "malformed": counters["push_malformed"],
            "books_balanced": books_ok,
            "lost": lost,
            "trips_exact": trip["trips_exact"],
            "audit_ok": audit_v["ok"],
            "invoice_totals_match": invoice["totals_match"],
        }
        from ..router.lifecycle import LIFECYCLE_METRICS
        return {
            "schema": REPORT_SCHEMA,
            "stable": stable,
            "scenario": {"name": sched["name"],
                         "seed": sched["seed"],
                         "digest": self.scenario.digest(),
                         "duration_s": sched["duration_s"],
                         "compression": sched["compression"],
                         "registry": self.registry.stats()},
            "books": {"router": router_stats,
                      "watch": loop_stats,
                      "watch_balanced": watch_ok,
                      "lost": lost,
                      "balanced": books_ok,
                      "counters": counters},
            "slo": {"verdict_epochs": len(self.verdicts),
                    "trip": trip,
                    "local": self.engine.snapshot()},
            "audit": audit_v,
            "costs": invoice,
            "throughput": {"sustained": self._sustained_ips(),
                           "scans_ok": counters["scans_ok"]},
            "fleet": {"mode": self.mode,
                      "replicas_start": self.n_replicas,
                      "replicas_end": len(replica_rows),
                      "replicas": replica_rows,
                      "peak_rss_bytes": int(max(peak_rss))
                      if peak_rss else -1,
                      # handoff counters booked by THIS process's
                      # run_handoff; per-replica prewarm counters
                      # ride the replica rows above
                      "lifecycle": LIFECYCLE_METRICS.snapshot()},
            "timeline": merged.report(),
            "wall": {"started_unix": round(wall_start, 3),
                     "duration_s": round(wall_s, 3)},
        }


def stable_view(report: dict) -> str:
    """The byte-identical-across-same-seed-runs slice of a report,
    canonically serialized (the determinism gate compares these)."""
    return json.dumps(report.get("stable") or {}, sort_keys=True,
                      separators=(",", ":"))


def run_soak(scenario: Scenario, replicas: int = 3,
             mode: str = "inproc", report_path: str = "",
             **kwargs) -> dict:
    """Build, run, optionally persist. The report is dumped with
    ``sort_keys`` so same-seed runs diff cleanly."""
    runner = SoakRunner(scenario, replicas=replicas, mode=mode,
                        **kwargs)
    report = runner.run()
    if report_path:
        with open(report_path, "w", encoding="utf-8") as f:
            json.dump(report, f, sort_keys=True, indent=2)
            f.write("\n")
    return report
