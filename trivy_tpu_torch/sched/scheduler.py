"""The continuous-batching scan scheduler (reference:
``trivy_tpu/sched/scheduler.py``).

Topology (docs/serving.md has the full picture)::

    sources (CLI fleet, submit_path) ──submit──▶ admission queue
        │ intake thread (deadline sweep)
        ▼
    host worker pool ──analyze()──▶ Coalescer (volume buckets)
        │ device executor thread (one, serializes kernel work)
        ▼
    sieve launch ─▶ interval waves ─▶ (ring drain) collect
        │ per-request finish() back on the worker pool
        ▼
    request futures resolve

The device executor owns ALL kernel launches, so device work is
enqueued in one order from one thread; the worker pool runs every
host phase. While the card chews batch N, the pool analyzes batch N+1
and assembles batch N-1. Iteration-level scheduling à la Orca/vLLM:
requests join whichever batch is forming when their host analysis
lands, not the batch they arrived with.

Async slot runtime: the executor LAUNCHES each coalesced batch —
segment pack and upload, the ``dfa_blockmask`` sieve and its
compaction enqueued on the executor's current stream with an event
recorded behind them (``secret/batch.py``), the interval waves on a
side stream that first waits for that stream (``detect/batch.py``) —
into a bounded dispatch ring (``SchedConfig.dispatch_depth``, default
2) and immediately takes the next batch, so batch N+1 packs and
uploads while batch N computes. The ring's drain thread COLLECTS slots
in FIFO order: each handle waits on its own CUDA events before any
read (the drain thread's current stream does not order it after the
executor's), then decode → patch → finish fan-out; a full ring parks
the executor. Occupancy feedback: when nothing is queued, analyzing,
or pending coalesce, the effective depth shrinks to 1 — an interactive
request never waits behind a speculative batch. A slot whose launch
raises a fault the injector raised goes down the bisect/quarantine
ladder, which launches and collects each attempt inline, so poison
isolation is the reference's. On the card every other failure (a real
CUDA error is sticky: every later launch in the process fails too, so
the ladder could not corner it) fails the slot's requests with a
``DeviceDispatchError``; the CPU groups keep the ladder for every
error.

Cross-request consistency: two concurrent requests can share a layer
blob (fleets share file trees). A request that analyzed a layer will
patch that blob's secrets only when its batch's sieve resolves; any
OTHER request whose final merge reads that blob must wait for the
patch. The scheduler tracks pending blob writes and hands each
request the set of patch events it depends on — the collecting
thread alone resolves them, so there is no cycle to deadlock on.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..obs.cost import COST_LEDGER, parse_budget_config
from ..obs.trace import get_tracer, trace_cause
from .coalescer import Batch, Coalescer, SchedConfig
from .metrics import SchedMetrics
from .queue import (DeadlineExceeded, DeviceDispatchError,
                    QueueFullError, RequestCancelled, ScanRequest,
                    SchedulerClosed)
from .tenant import RateLimitedError, TenantQueue

log = logging.getLogger("trivy_tpu_torch.sched")


def _annotate_degraded(result, faults: list):
    """Thread the request's survived faults into whatever shape the
    finish callable produced: objects expose ``apply_degraded``
    (BatchScanResult), RPC responses are plain dicts, anything else
    passes through unannotated (the caller still got a result)."""
    mark = getattr(result, "apply_degraded", None)
    if mark is not None:
        mark(faults)
    elif isinstance(result, dict):
        result["status"] = "degraded"
        result["failure_causes"] = [dict(f) for f in faults]
    return result


class ScanScheduler:
    """Owns the queue, the coalescer, the worker pool, and the
    device executor. One instance per process serves every request
    source; ``group`` keys keep incompatible dispatches apart."""

    def __init__(self, config: Optional[SchedConfig] = None,
                 backend: str = "cuda", mesh=None,
                 secret_scanner=None, tracer=None, slo=None):
        self.config = config or SchedConfig()
        self.backend = backend
        # mesh: parallel.mesh.DeviceMesh (or None) — every batch's
        # interval waves split their rows over its devices (the sieve
        # shards through the secret scanner's own mesh); the host rung
        # of the isolation ladder runs without it
        from ..parallel.mesh import check_mesh
        check_mesh(mesh, backend)
        self.mesh = mesh
        self.secret_scanner = secret_scanner
        # fault_injector: faults.FaultInjector (or None), whose
        # on_device_dispatch(names) is consulted at the top of every
        # device dispatch so injected device failures exercise the
        # bisect/quarantine machinery — on the card they are the only
        # failures that may (_isolable)
        self.fault_injector = None
        # tracer: obs.trace.Tracer — every admitted request gets a
        # root span with per-stage children (docs/observability.md)
        self.tracer = tracer if tracer is not None else get_tracer()
        # slo: obs.slo.SloEngine — burn-rate verdicts over the
        # admitted-request outcomes; a tripped burn rate auto-dumps
        # its worst recent traces through this tracer's flight
        # recorder. Pass a configured engine or let the defaults ride.
        if slo is None:
            from ..obs.slo import SloEngine, parse_slo_config
            cfg_slos = getattr(self.config, "slos", None)
            if cfg_slos is not None:
                # accept the --slo-config string grammar here too —
                # one parser, and a typo'd objective fails with its
                # ValueError instead of an AttributeError deep in
                # SloEngine
                cfg_slos = parse_slo_config(cfg_slos)
            slo = SloEngine(cfg_slos,
                            recorder=self.tracer.recorder)
        self.slo = slo
        self.metrics = SchedMetrics()
        # tenancy-aware admission (sched/tenant.py): with the default
        # (no TenancyConfig) this is exactly the old bounded FIFO —
        # one unlimited anonymous tenant
        self.queue = TenantQueue(self.config.max_queue,
                                 tenancy=getattr(self.config,
                                                 "tenancy", None))
        # per-tenant device-second budgets (--tenant-budget,
        # obs/cost.py): admission consults the windowed cost ledger
        # and throttles (429) or deprioritizes over-budget tenants
        budgets = getattr(self.config, "budgets", None)
        if budgets:
            self.queue.configure_budgets(
                parse_budget_config(budgets), COST_LEDGER)
        self.metrics.set_depth_gauge(self.queue.depth)
        self.coalescer = Coalescer(self.config)
        # dispatch ring (runtime/ring.py): bounds launched-but-
        # uncollected device slots and owns the collect drain thread
        from ..runtime.ring import DispatchRing
        self.ring = DispatchRing(
            depth=max(1, getattr(self.config, "dispatch_depth", 2)),
            name="sched")
        self._pool: Optional[ThreadPoolExecutor] = None
        self._threads: list = []
        self._cv = threading.Condition()
        self._analyzing = 0
        self._kernel_s = 0.0      # interval-kernel wall (all batches)
        # monotonic end of the last metered device dispatch — the
        # demand-gated idle baseline (goodput: device time between
        # "work was ready" and "dispatch started" is waste)
        self._last_device_end = None
        self._running = False
        self._draining = False
        self._batch_seq = 0       # device-thread only (batch ids)
        self._lock = threading.Lock()
        # blob id → patch event of the request that will write it
        self._blob_lock = threading.Lock()
        self._pending_blobs: dict = {}
        # analysis puts while an inspect is in flight: blob id → the
        # put's sequence number; an inspect's missing-blob check is
        # stamped with the sequence number it began at
        self._put_lock = threading.Lock()
        self._put_seq = 0
        self._analysis_puts: dict = {}
        self._inspects: list = []

    # --- lifecycle ---

    def start(self) -> "ScanScheduler":
        with self._lock:
            if self._running:
                return self
            if self.queue.closed:
                # a closed scheduler never revives — restarting the
                # threads against a permanently closed queue would
                # only leak them
                raise SchedulerClosed("scheduler is closed")
            self._running = True
            self._pool = ThreadPoolExecutor(
                max_workers=max(1, self.config.workers),
                thread_name_prefix="sched-host")
            for name, fn in (("sched-intake", self._intake_loop),
                             ("sched-device", self._device_loop)):
                t = threading.Thread(target=fn, name=name,
                                     daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def close(self, wait: bool = True) -> None:
        with self._lock:
            if not self._running:
                return
            self._running = False
        self.queue.close()
        with self._cv:
            self._cv.notify_all()
        # anything not yet handed to the device fails typed
        while True:
            req = self.queue.get(timeout=0)
            if req is None:
                break
            self._fail(req, SchedulerClosed("scheduler closed"))
        for req in self.coalescer.drain():
            self._fail(req, SchedulerClosed("scheduler closed"))
        # drain the dispatch ring BEFORE the pool stops: in-flight
        # device slots complete (a deadline never cancels device
        # work already launched), their patches land, and their
        # finish tasks still find a live pool to run on — collected
        # even on wait=False, because an abandoned slot's requests
        # would never resolve
        self.ring.close(collect=True)
        if self._pool is not None:
            self._pool.shutdown(wait=wait)
        # a second drain AFTER the pool settles: an _analyze that was
        # mid-flight during the first drain may have added its
        # request to the coalescer since — without this, that future
        # would never resolve (and an RPC adapter's on_done release
        # would never run)
        for req in self.coalescer.drain():
            self._fail(req, SchedulerClosed("scheduler closed"))
        for t in self._threads:
            t.join(timeout=5 if wait else 0)
        self._threads = []

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: refuse new admissions (submit raises
        SchedulerClosed, which the RPC layer answers 503), let the
        queued and in-flight requests run to completion, then close.
        Returns True when everything drained inside the timeout."""
        with self._lock:
            if not self._running:
                return True
            self._draining = True
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            if self.metrics.in_flight() == 0 \
                    and self.queue.depth() == 0 \
                    and self.coalescer.pending() == 0:
                with self._cv:
                    if self._analyzing == 0:
                        break
            time.sleep(0.02)
        drained = self.metrics.in_flight() == 0
        self.close()
        return drained

    def __enter__(self) -> "ScanScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # --- submission ---

    def submit(self, request: ScanRequest,
               block: bool = False) -> ScanRequest:
        """Admit one request. Raises QueueFullError (backpressure)
        unless ``block``, SchedulerClosed after close()."""
        if self._draining:
            raise SchedulerClosed("scheduler draining")
        if not self._running:
            self.start()
        if request.deadline is None and \
                self.config.default_deadline_s > 0:
            request.deadline = (request.submitted_at +
                                self.config.default_deadline_s)
        request.group = request.group or self.backend
        root = self.tracer.start_request(
            request.name, trace_id=request.trace_id,
            parent_span_id=getattr(request, "parent_span_id", ""))
        request.trace_id = root.trace_id
        request.span_root = root
        request.span_queue = self.tracer.child(root, "queue_wait")
        try:
            self.queue.put(request, block=block)
        except (QueueFullError, RateLimitedError) as e:
            self.metrics.inc("rejected")
            if isinstance(e, RateLimitedError):
                self.metrics.inc("rate_limited")
            # "rejected", not "failed": a backpressure 503/429
            # carries no diagnostic value, and the tracer only
            # crash-dumps degraded/failed traces — a rejection storm
            # (including a tenant flood's 429s) must never become a
            # disk-write storm
            request.span_queue.end("error")
            root.end("rejected")
            raise
        except SchedulerClosed:
            request.span_queue.end("error")
            root.end("rejected")
            raise
        self.metrics.inc("submitted")
        self.metrics.note_depth(self.queue.depth())
        with self._cv:
            self._cv.notify_all()
        return request

    def in_flight(self) -> int:
        """Admitted-but-unresolved requests. Open-loop submitters
        (the watch loop's in-flight watermarks, docs/serving.md
        "Continuous scanning") poll this instead of reaching into
        the metrics object."""
        return self.metrics.in_flight()

    def stats(self) -> dict:
        out = self.metrics.snapshot()
        out["config"] = {
            "max_queue": self.config.max_queue,
            "workers": self.config.workers,
            "flush_timeout_s": self.config.flush_timeout_s,
            "max_batch_bytes": self.config.max_batch_bytes,
            "max_batch_jobs": self.config.max_batch_jobs,
            "max_batch_items": self.config.max_batch_items,
        }
        out["backend"] = self.backend
        out["draining"] = self._draining
        # per-tenant fairness/QoS books (docs/serving.md
        # "Multi-tenant QoS"): queue depth, in-flight, admission and
        # shed counters, latency quantiles — the autoscaling signal
        out["tenants"] = self.queue.tenant_snapshot()
        # SLO verdicts (obs/slo.py): burn rates over the outcome
        # stream — the autoscaling/alerting signal GET /slo serves
        out["slo"] = self.slo.snapshot()
        with self._lock:
            out["interval_kernel_s"] = round(self._kernel_s, 4)
        # per-tenant cost books + the goodput reconciliation
        # (docs/observability.md "Cost attribution & goodput")
        out["cost"] = self.cost_snapshot()
        return out

    def cost_snapshot(self) -> dict:
        """The cost plane's replica-local view: per-tenant ledger,
        the measured per-dispatch device-time integral, and the
        accounting-identity verdict — served at ``GET /costs`` and
        inside ``stats()["cost"]``. The bill amortized across tenants
        is the boot's kernel build and warm-launch wall
        (``runtime/aot.py::COMPILE_CACHE_METRICS``)."""
        from ..obs.cost import balance
        from ..runtime.aot import COMPILE_CACHE_METRICS
        aot = COMPILE_CACHE_METRICS.snapshot()
        ledger = COST_LEDGER.snapshot(
            aot_compile_s=float(aot.get("seconds", 0.0) or 0.0))
        measured = self.metrics.device_time_s()
        out = dict(ledger)
        out["measured_device_s"] = round(measured, 6)
        out["balance"] = balance(ledger.get("device_s", 0.0),
                                 measured)
        return out

    # --- cross-request blob dependencies (called from analyze) ---

    def register_blob_writes(self, blob_ids: list,
                             request: ScanRequest) -> None:
        """This request's sieve results will patch these cache
        blobs; requests reading them must wait for the patch."""
        with self._blob_lock:
            for b in blob_ids:
                self._pending_blobs[b] = request.patched_event
        request._registered_blobs = list(blob_ids)

    def blob_deps(self, blob_ids: list,
                  request: ScanRequest) -> list:
        """Patch events (other requests') this request's final
        secret merge depends on."""
        with self._blob_lock:
            out = []
            for b in blob_ids:
                ev = self._pending_blobs.get(b)
                if ev is not None and \
                        ev is not request.patched_event:
                    out.append(ev)
            return out

    def inspect_began(self) -> int:
        """Stamp an inspect before its missing-blob check; pass the
        stamp to ``put_analyzed_blob`` and ``inspect_ended``."""
        with self._put_lock:
            self._inspects.append(self._put_seq)
            return self._put_seq

    def inspect_ended(self, since: int) -> None:
        with self._put_lock:
            self._inspects.remove(since)
            # a put at or before the oldest stamp still in flight can
            # never be skipped again: every later check saw it
            lo = min(self._inspects, default=self._put_seq)
            self._analysis_puts = {b: n for b, n in
                                   self._analysis_puts.items() if n > lo}

    def put_analyzed_blob(self, cache, blob_id: str, blob,
                          since: int) -> bool:
        """Put a blob this request analyzed (its secrets not patched
        yet) unless another request put the same blob after this
        inspect's missing-blob check (``since``). That copy is the same
        analysis and may carry its request's secret patch already; a
        second put would replace it with an unpatched one under a
        reader that waits on no one. Returns whether it was put."""
        with self._put_lock:
            if self._analysis_puts.get(blob_id, -1) > since:
                return False
            cache.put_blob(blob_id, blob)
            self._put_seq += 1
            self._analysis_puts[blob_id] = self._put_seq
            return True

    def _clear_blob_writes(self, request: ScanRequest) -> None:
        blobs = getattr(request, "_registered_blobs", ())
        with self._blob_lock:
            for b in blobs:
                if self._pending_blobs.get(b) is \
                        request.patched_event:
                    del self._pending_blobs[b]

    # --- resolution helpers ---

    def _end_trace(self, req: ScanRequest, status: str,
                   err=None) -> None:
        """Close the request's span tree: any stage span still open
        (a failure can resolve the request mid-stage), then the
        root — which completes the trace (flight-recorder ring,
        export, degraded-dump) in the tracer."""
        root = req.span_root
        if root is None or root.noop:
            return
        for name in ("span_queue", "span_coalesce"):
            sp = getattr(req, name, None)
            if sp is not None:
                sp.end("error" if status == "failed" else None)
        if err is not None:
            root.set("error", repr(err))
        if req.faults:
            root.set("faults", len(req.faults))
        root.end(status)

    def _note_slo(self, req: ScanRequest, outcome: str,
                  latency: float) -> None:
        self.slo.record(outcome, latency_s=latency,
                        tenant=getattr(req, "tenant", "") or "",
                        priority=int(getattr(req, "priority", 0)
                                     or 0),
                        trace_id=req.trace_id or "")

    def _complete(self, req: ScanRequest, result) -> None:
        self._clear_blob_writes(req)
        if req.set_result(result):
            latency = time.monotonic() - req.submitted_at
            self.metrics.inc("completed")
            self.metrics.observe("request", latency,
                                 trace_id=req.trace_id or "")
            COST_LEDGER.charge(getattr(req, "tenant", "") or "",
                               requests=1)
            status = "degraded" if req.faults else "ok"
            self.queue.note_done(req, status, latency)
            self._end_trace(req, status)
            self._note_slo(req, status, latency)

    def _fail(self, req: ScanRequest, err: BaseException) -> None:
        self._clear_blob_writes(req)
        if req.set_error(err):
            latency = time.monotonic() - req.submitted_at
            if isinstance(err, DeadlineExceeded):
                outcome = "timed_out"
            elif isinstance(err, RequestCancelled):
                outcome = "cancelled"
            else:
                outcome = "failed"
            self.metrics.inc(outcome)
            self.queue.note_done(req, outcome)
            self._end_trace(req, "failed", err)
            self._note_slo(req, outcome, latency)

    def _sweep(self, req: ScanRequest) -> bool:
        """True if the request is dead (expired/cancelled) and was
        resolved here."""
        if req.cancelled:
            self._fail(req, RequestCancelled(
                f"scan {req.name!r}: cancelled"))
            return True
        if req.expired():
            self._fail(req, DeadlineExceeded(
                f"scan {req.name!r}: deadline exceeded"))
            return True
        return False

    # --- stage 1: intake + host analyze ---

    def _intake_loop(self) -> None:
        # the admission queue is the ONLY wait buffer: intake stops
        # pulling once the pool has a small prefetch window in
        # flight, so a saturated pool backs pressure up into the
        # bounded queue (and from there into typed 503s) instead of
        # an unbounded executor backlog
        prefetch = max(2, self.config.workers * 2)
        while self._running:
            with self._cv:
                while self._running and self._analyzing >= prefetch:
                    self._cv.wait(0.05)
            if not self._running:
                break
            req = self.queue.get(timeout=0.05)
            if req is None:
                continue
            if req.span_queue is not None:
                req.span_queue.end()
            self.metrics.observe(
                "queue_wait", time.monotonic() - req.submitted_at,
                trace_id=req.trace_id or "")
            if self._sweep(req):
                continue
            with self._cv:
                self._analyzing += 1
            try:
                self._pool.submit(self._analyze, req)
            except RuntimeError:     # pool shut down under us
                with self._cv:
                    self._analyzing -= 1
                self._fail(req, SchedulerClosed("scheduler closed"))

    def _analyze(self, req: ScanRequest) -> None:
        t0 = self.metrics.host_begin()
        sp = self.tracer.child(req.span_root, "analyze")
        try:
            if not self._sweep(req):
                with sp.activate():
                    req.work = req.analyze(req)
                req.work.group = req.work.group or req.group
                sp.end()
                # the coalesce span opens BEFORE the request is
                # published to the device thread, which closes it
                # when the batch flushes
                req.span_coalesce = self.tracer.child(
                    req.span_root, "coalesce")
                self.coalescer.add(req)
            else:
                sp.end("error")
        except Exception as e:       # noqa: BLE001
            sp.end("error")
            log.warning("analyze %r failed: %r", req.name, e)
            self._fail(req, e)
        finally:
            self.metrics.host_end(t0)
            host_s = time.monotonic() - t0
            self.metrics.observe("analyze", host_s,
                                 trace_id=req.trace_id or "")
            work = getattr(req, "work", None)
            COST_LEDGER.charge(
                getattr(req, "tenant", "") or "",
                host_analyze_s=host_s,
                bytes_in=float(getattr(work, "candidate_bytes", 0)
                               or 0))
            with self._cv:
                self._analyzing -= 1
                self._cv.notify_all()

    # --- stage 2: device executor ---

    def _upstream_idle(self) -> bool:
        return self.queue.depth() == 0 and self._analyzing == 0

    def _device_loop(self) -> None:
        wait_s = min(0.1, max(0.005,
                              self.config.flush_timeout_s / 2))
        while self._running:
            group = self.coalescer.ready_group(self._upstream_idle())
            if group is None:
                with self._cv:
                    self._cv.wait(wait_s)
                continue
            batch = self.coalescer.take(group)
            if batch is None or not batch.requests:
                continue
            try:
                self._execute(batch)
            except Exception as e:   # noqa: BLE001
                log.warning("batch execution failed: %r", e)
                for r in batch.requests:
                    self._fail(r, e)
        # drain on shutdown
        for req in self.coalescer.drain():
            self._fail(req, SchedulerClosed("scheduler closed"))

    def _effective_depth(self) -> int:
        """Occupancy feedback for the dispatch ring: the configured
        depth while work is queued/analyzing/pending (speculative
        batches pay for themselves), shrunk to 1 when the pipeline
        upstream is empty — the next request to arrive gets the
        device as soon as the current batch drains, not after a
        speculative slot ahead of it."""
        cfg = max(1, getattr(self.config, "dispatch_depth", 2))
        if cfg > 1 and self._upstream_idle() \
                and self.coalescer.pending() == 0:
            return 1
        return cfg

    def _execute(self, batch: Batch) -> None:
        from ..runtime.ring import RingClosed
        reqs = [r for r in batch.requests if not self._sweep(r)]
        if not reqs:
            return
        self.metrics.note_batch(
            len(reqs), batch.candidate_bytes, batch.jobs,
            batch.bucket_bytes, batch.bucket_jobs)

        self._batch_seq += 1
        bid = self._batch_seq
        occ = round(batch.occupancy, 4)
        for r in reqs:
            sp = r.span_coalesce
            if sp is not None:
                if not sp.noop:
                    sp.set("batch", bid)
                    sp.set("items", len(reqs))
                    sp.set("bucket_bytes", batch.bucket_bytes)
                    sp.set("bucket_jobs", batch.bucket_jobs)
                    sp.set("occupancy", occ)
                sp.end()

        group = batch.group or self.backend
        try:
            # capacity first, then launch (pack + upload + enqueue)
            # on THIS thread, collect on the ring's drain thread —
            # the loop takes the next batch while this one computes.
            # The first request's root is active around the submit
            # so a ring-full park records its slot_wait span (the
            # timeline charges the stall to the batch it delayed)
            import contextlib
            root = reqs[0].span_root
            ctx = root.activate() if root is not None \
                and not root.noop else contextlib.nullcontext()
            launched: dict = {}

            def _do_launch():
                launched["slot"] = self._launch(reqs, group, bid)
                return launched["slot"]

            with ctx:
                self.ring.submit(
                    self._collect_slot,
                    depth=self._effective_depth(),
                    label=f"batch:{bid}",
                    launch=_do_launch)
        except RingClosed:
            slotp = launched.get("slot")
            if slotp is not None:
                # the ring closed between a SUCCESSFUL launch and
                # the slot append: device work is already enqueued,
                # so collect it inline — spans end, payload tags
                # restore, device accounting balances, and the
                # close(collect=True) "in-flight work completes"
                # contract holds
                self._collect_slot(slotp)
            else:
                for r in reqs:
                    self._fail(r,
                               SchedulerClosed("scheduler closed"))
        except Exception as e:       # noqa: BLE001 — a failed
            # launch (fault injection fires at dispatch) goes down the
            # isolation ladder: bisect corners the poison
            log.warning("async launch failed for %d requests "
                        "(%r); isolating", len(reqs), e)
            self._resolve_batch(reqs, self._recover(reqs, group, bid,
                                                    e))

    def _launch(self, reqs: list, group: str, bid: int,
                depth: int = 0, attempt: str = "batch") -> dict:
        """Non-blocking half of one batch dispatch: flatten + tag
        payloads, enqueue the sieve (its handle carries the CUDA event
        recorded behind it) and the interval waves (each with its own
        event), return the slot payload ``_collect`` reads. Every
        request gets a ``device`` span per attempt, so bisect halves
        and quarantine retries appear as sibling spans in the trace.
        Raises on launch failure with payload tags restored and device
        spans error-ended; what the fault injector raised is marked
        injected."""
        from ..detect.batch import dispatch_jobs_async

        spans = []
        for r in reqs:
            sp = self.tracer.child(r.span_root, "device")
            if not sp.noop:
                sp.set("batch", bid)
                sp.set("requests", len(reqs))
                if depth:
                    sp.set("bisect_depth", depth)
                if attempt != "batch":
                    sp.set("attempt", attempt)
            spans.append(sp)
        slot = {"reqs": reqs, "spans": spans, "group": group,
                "bid": bid, "wrapped": [], "owner": [],
                "local": [], "sieve": None, "ih": None,
                "kstats": {}, "t0": None}
        try:
            if self.fault_injector is not None:
                try:
                    self.fault_injector.on_device_dispatch(
                        [r.name for r in reqs])
                except Exception as e:   # noqa: BLE001
                    e._sched_injected = True
                    raise

            # flatten sieve candidates; owner map brings results
            # home by ENTRY INDEX (paths repeat across images — see
            # secret.batch)
            files = []
            for i, r in enumerate(reqs):
                for j, (path, content) in enumerate(
                        r.work.candidates):
                    files.append((path, content))
                    slot["owner"].append(i)
                    slot["local"].append(j)

            # payloads are tagged with the request's batch index for
            # the duration of the dispatch and restored at collect —
            # a failed slot restores before the isolation ladder
            # re-tags against its own indices
            for i, r in enumerate(reqs):
                for job in r.work.jobs:
                    slot["wrapped"].append((job, job.payload))
                    job.payload = (i, job.payload)

            slot["t0"] = self.metrics.device_begin()
            # batch-shared phases (segment pack, H2D staging, wave
            # enqueue) record under the FIRST request's device span
            with spans[0].activate():
                if files and self.secret_scanner is not None:
                    slot["sieve"] = \
                        self.secret_scanner.dispatch_files(files)
                all_jobs = [job for job, _ in slot["wrapped"]]
                if all_jobs:
                    slot["ih"] = dispatch_jobs_async(
                        all_jobs, backend=group, mesh=self.mesh,
                        stats=slot["kstats"])
            return slot
        except Exception as e:       # noqa: BLE001
            self._unwind_slot(slot, error=e)
            raise

    def _meter_dispatch(self, reqs: list, t0, wall_s: float,
                        kstats: dict, sieved: bool) -> None:
        """Book one device dispatch's wall into the cost plane:

        * goodput — the dispatch wall is useful device time; the gap
          between this dispatch's start and max(previous dispatch
          end, earliest submit in the batch) is DEMAND-GATED idle
          (the device sat while admitted work waited) — both feed
          every ``kind=efficiency`` SLO book;
        * attribution — the wall splits by kernel family (the
          interval bucket-ladder's measured ``device_s`` vs the DFA
          sieve remainder) and lands on each request's tenant
          proportionally to its work volume (candidate bytes +
          interval jobs), so per-tenant books sum back to the
          measured dispatch integral by construction.

        Called on every path that closed a device_begin — success
        and unwind, the bisect ladder's attempts included — so failed
        dispatches are billed too and the identity holds through
        quarantine."""
        if t0 is None or not reqs:
            return
        wall_s = max(0.0, wall_s)
        gate = min((r.submitted_at for r in reqs), default=t0)
        with self._lock:
            if self._last_device_end is not None:
                gate = max(gate, self._last_device_end)
                idle_s = max(0.0, t0 - gate)
            else:
                # first dispatch of the process: warm-up, not waste
                idle_s = 0.0
            end = t0 + wall_s
            if self._last_device_end is None \
                    or end > self._last_device_end:
                self._last_device_end = end
        self.slo.record_device(wall_s, idle_s=idle_s)
        if not COST_LEDGER.enabled:
            return
        interval_s = min(wall_s, max(0.0, float(
            (kstats or {}).get("device_s", 0.0) or 0.0)))
        if sieved:
            dfa_s = wall_s - interval_s
        else:
            # no sieve in this dispatch: the whole wall is the
            # interval ladder (enqueue + materialize included)
            interval_s, dfa_s = wall_s, 0.0
        weights = []
        for r in reqs:
            w = getattr(r, "work", None)
            weights.append(
                float(getattr(w, "candidate_bytes", 0) or 0)
                + float(len(getattr(w, "jobs", ()) or ())))
        total_w = sum(weights)
        n = len(reqs)
        for r, w in zip(reqs, weights):
            share = (w / total_w) if total_w > 0 else (1.0 / n)
            COST_LEDGER.charge(
                getattr(r, "tenant", "") or "",
                device_interval_s=interval_s * share,
                device_dfa_s=dfa_s * share)

    def _unwind_slot(self, slot: dict, error=None) -> None:
        """Restore payload tags + close accounting for a slot that
        will not produce results itself (launch/collect failure —
        the isolation ladder re-dispatches from a clean state)."""
        for job, orig in slot["wrapped"]:
            job.payload = orig
        if slot["t0"] is not None:
            wall = self.metrics.device_end(slot["t0"])
            self._meter_dispatch(slot["reqs"], slot["t0"], wall,
                                 slot["kstats"],
                                 slot["sieve"] is not None)
        for sp in slot["spans"]:
            if error is not None:
                sp.event("device_failed", error=repr(error))
            sp.end("error" if error is not None else None)

    def _collect(self, slot: dict) -> dict:
        """Blocking half of one batch dispatch: materialize the
        interval waves (the device wall passes here) and collect the
        sieve → ``{id(req): (sieve_found, detected)}``. Raises on
        failure with the slot unwound. Every path that closed a
        device_begin meters its wall, so the ladder's halves bill
        their own walls and the accounting identity survives poison
        isolation."""
        from ..detect.batch import collect_dispatch

        reqs = slot["reqs"]
        spans = slot["spans"]
        try:
            with spans[0].activate():
                detected_by: dict = {}
                if slot["ih"] is not None:
                    for i, payload in collect_dispatch(slot["ih"]):
                        detected_by.setdefault(i, []).append(
                            payload)
                    with self._lock:
                        self._kernel_s += slot["kstats"].get(
                            "device_s", 0.0)
                found_by: dict = {}
                if slot["sieve"] is not None:
                    for idx, secret in self.secret_scanner.collect(
                            slot["sieve"]):
                        found_by.setdefault(
                            slot["owner"][idx], []).append(
                            (slot["local"][idx], secret))
        except Exception as e:       # noqa: BLE001
            self._unwind_slot(slot, error=e)
            raise
        for job, orig in slot["wrapped"]:
            job.payload = orig
        wall = self.metrics.device_end(slot["t0"])
        self._meter_dispatch(reqs, slot["t0"], wall,
                             slot["kstats"],
                             slot["sieve"] is not None)
        self.metrics.observe("device",
                             time.monotonic() - slot["t0"],
                             trace_id=reqs[0].trace_id or "")
        for sp in spans:
            sp.end()
        return {id(r): (found_by.get(i, []), detected_by.get(i, []))
                for i, r in enumerate(reqs)}

    def _collect_slot(self, slot: dict) -> None:
        """Drain-thread half: collect, then patch + finish fan-out. A
        collect failure goes to the isolation ladder."""
        reqs = slot["reqs"]
        try:
            results = self._collect(slot)
        except Exception as e:       # noqa: BLE001
            log.warning("slot collect failed for %d requests "
                        "(%r); isolating", len(reqs), e)
            results = self._recover(reqs, slot["group"], slot["bid"],
                                    e)
        self._resolve_safe(reqs, results)

    def _resolve_safe(self, reqs: list, results: dict) -> None:
        """_resolve_batch, but a raising resolution can never leak a
        request: on the drain thread nobody reads the slot's error
        (results flow through the requests themselves), so anything
        unresolved fails typed here."""
        try:
            self._resolve_batch(reqs, results)
        except Exception as e:       # noqa: BLE001
            log.warning("batch resolution failed: %r", e)
            for r in reqs:
                self._fail(r, e)

    def _resolve_batch(self, reqs: list, results: dict) -> None:
        # patch + event-set happen HERE, on the collecting thread
        # (ring drain, or the executor on the sync fallback), so
        # every patch event is resolved without touching the worker
        # pool — a finish waiting on another request's patch can
        # never starve the work that would satisfy it
        for r in reqs:
            out = results.get(id(r))
            if out is None:
                continue             # quarantine already failed it
            if self._sweep(r):
                # the deadline passed while the batch ran on device:
                # the collect is abandoned (sweep resolved it 408)
                self.metrics.inc("expired_inflight")
                continue
            found, detected = out
            try:
                if r.work.patch is not None:
                    r.work.patch(found)
            except Exception as e:   # noqa: BLE001
                log.warning("patch %r failed: %r", r.name, e)
                self._fail(r, e)
                continue
            r.patched_event.set()
            self._clear_blob_writes(r)
            try:
                self._pool.submit(self._finish, r, found, detected)
            except RuntimeError:     # pool shut down under us
                self._fail(r, SchedulerClosed("scheduler closed"))

    # --- poison-image isolation (docs/robustness.md) ---

    def _isolable(self, err: BaseException, group: str) -> bool:
        """Whether a failed dispatch may go down the bisect/quarantine
        ladder, whose last rung finishes the request on the host. On
        the card only a fault the injector raised may: any other error
        (a launch error, which CUDA keeps sticky, or a kernel that
        would not build) fails the request instead, so the host path
        never stands in for the card unseen. The CPU groups keep the
        reference's ladder for every error."""
        return group != "cuda" or getattr(err, "_sched_injected", False)

    def _recover(self, reqs: list, group: str, bid: int,
                 err: BaseException) -> dict:
        """After a batch's async launch or collect raised ``err``:
        the isolation ladder when ``err`` is isolable, else every
        request fails with the device's cause."""
        if not self._isolable(err, group):
            return self._fail_on_device(reqs, err)
        return self._dispatch_isolated(reqs, group, batch_id=bid)

    def _fail_on_device(self, reqs: list, err: BaseException) -> dict:
        """Fail each of ``reqs`` with a ``DeviceDispatchError`` caused by
        ``err``; the empty result map tells _resolve_batch they are
        resolved already."""
        log.error("device dispatch failed for %d requests: %r",
                  len(reqs), err)
        self.metrics.inc("device_failures", len(reqs))
        fault = DeviceDispatchError(f"device dispatch failed: {err}")
        fault.__cause__ = err
        for r in reqs:
            if r.span_root is not None:
                r.span_root.event("device_failed", error=repr(err))
            self._fail(r, fault)
        return {}

    def _dispatch_isolated(self, reqs: list, group: str,
                           depth: int = 0,
                           batch_id: int = 0) -> dict:
        """Dispatch with failure isolation: a raising batch is
        bisected until the poison request(s) are cornered alone,
        retried bounded, then quarantined to the exact host path —
        the rest of the batch completes normally. Only a request
        whose host fallback ALSO fails, or whose dispatch failed with
        an error that is not isolable, resolves with an error. Each
        attempt launches and collects inline on the calling thread."""
        try:
            return self._collect(self._launch(reqs, group, batch_id,
                                              depth=depth))
        except Exception as e:       # noqa: BLE001
            if not self._isolable(e, group):
                return self._fail_on_device(reqs, e)
            if len(reqs) == 1:
                return self._quarantine(reqs[0], group, e,
                                        depth=depth,
                                        batch_id=batch_id)
            log.warning("device dispatch failed for %d requests "
                        "(%r); bisecting", len(reqs), e)
            self.metrics.inc("batch_bisects")
            for r in reqs:
                if r.span_root is not None:
                    r.span_root.event("batch_bisect",
                                      depth=depth + 1,
                                      requests=len(reqs))
            mid = (len(reqs) + 1) // 2
            out = self._dispatch_isolated(reqs[:mid], group,
                                          depth + 1, batch_id)
            out.update(self._dispatch_isolated(reqs[mid:], group,
                                               depth + 1, batch_id))
            return out

    def _quarantine(self, req: ScanRequest, group: str,
                    err: BaseException, depth: int = 0,
                    batch_id: int = 0) -> dict:
        """Single failing request: bounded on-device retries (a
        transient may clear), then the host-fallback path."""
        for _ in range(max(0, self.config.quarantine_retries)):
            try:
                return self._collect(self._launch(
                    [req], group, batch_id, depth=depth,
                    attempt="quarantine_retry"))
            except Exception as e:   # noqa: BLE001
                if not self._isolable(e, group):
                    return self._fail_on_device([req], e)
                err = e
        self.metrics.inc("quarantined")
        log.warning("quarantining %r after device failure: %r",
                    req.name, err)
        if req.span_root is not None:
            req.span_root.event("quarantined", error=repr(err))
        req.record_fault(
            "device", "quarantined",
            f"device dispatch failed, completed on host: {err}")
        sp = self.tracer.child(req.span_root, "host_fallback")
        try:
            with sp.activate():
                out = self._host_fallback(req)
            sp.end()
            self.metrics.inc("host_fallbacks")
            return out
        except Exception as e2:      # noqa: BLE001
            sp.end("error")
            log.warning("host fallback for %r failed: %r",
                        req.name, e2)
            req.record_fault("host", "fallback_failed", str(e2))
            self._fail(req, e2)
            return {}

    def _host_fallback(self, req: ScanRequest) -> dict:
        """The exact host path for one quarantined request: a
        whole-file CPU secret scan (reference engine — identical
        findings to the sieve by construction) and the cpu-ref
        interval evaluation (detect/batch.py host fallback)."""
        from ..detect.batch import dispatch_jobs

        work = req.work
        found = []
        base = getattr(self.secret_scanner, "scanner", None)
        if work.candidates and base is not None:
            for j, (path, content) in enumerate(work.candidates):
                secret = base.scan(path, content)
                if secret.findings:
                    found.append((j, secret))
        detected = []
        if work.jobs:
            wrapped = [(job, job.payload) for job in work.jobs]
            for job, orig in wrapped:
                job.payload = (0, orig)
            try:
                for _i, payload in dispatch_jobs(
                        work.jobs, backend="cpu-ref", stats={}):
                    detected.append(payload)
            finally:
                for job, orig in wrapped:
                    job.payload = orig
        return {id(req): (found, detected)}

    # --- stage 3: host finish ---

    def _finish(self, req: ScanRequest, found: list,
                detected: list) -> None:
        t0 = self.metrics.host_begin()
        sp = self.tracer.child(req.span_root, "report")
        try:
            work = req.work
            if work.deps and not sp.noop:
                sp.event("deps_wait", n=len(work.deps))
            for ev in work.deps:
                # deps are resolved by the device thread; they cannot
                # wait on this request, so a bounded wait only guards
                # against scheduler shutdown mid-flight
                while not ev.wait(timeout=1.0):
                    if not self._running:
                        sp.end("error")
                        self._fail(req, SchedulerClosed(
                            "scheduler closed"))
                        return
                    if self._sweep(req):
                        sp.end("error")
                        return
            if self._sweep(req):
                # expired after the device batch resolved but before
                # assembly — abandon, the 408 already went out
                self.metrics.inc("expired_inflight")
                sp.end("error")
                return
            with sp.activate():
                result = work.finish(found, detected)
                if req.faults:
                    if not sp.noop:
                        # the degraded report references its trace so
                        # the operator can pull the span tree
                        # (GET /trace/<id> / flight-recorder dump)
                        req.faults.append(trace_cause(
                            self.tracer, req.trace_id))
                    result = _annotate_degraded(result, req.faults)
            # the report span closes BEFORE the root resolves so the
            # completed trace's children nest inside the root
            sp.end()
            self._complete(req, result)
        except Exception as e:       # noqa: BLE001
            sp.end("error")
            log.warning("finish %r failed: %r", req.name, e)
            self._fail(req, e)
        finally:
            self.metrics.host_end(t0)
            host_s = time.monotonic() - t0
            self.metrics.observe("finish", host_s,
                                 trace_id=req.trace_id or "")
            COST_LEDGER.charge(getattr(req, "tenant", "") or "",
                               host_finish_s=host_s)
