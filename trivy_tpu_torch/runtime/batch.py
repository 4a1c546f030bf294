"""Multi-image batch scanner: the fleet runtime's direct path
(reference: ``trivy_tpu/runtime/batch.py``, ``--sched off``).

Pipeline per batch of images:

  1. host: load each image, compute cache keys, walk MISSING layers
     through the non-secret analyzers; secret candidates accumulate
     across all images tagged (image, layer); squash + advisory join
     per image;
  2. device dispatch #1: one sieve launch over every candidate byte of
     every image (``secret/batch.py``), enqueued on the host pool;
  3. device dispatch #2: the interval match over every (package,
     advisory) pair of every image, deduplicated across the fleet and
     split into waves that a ``DispatchRing`` keeps in flight
     (``detect/batch.py::dispatch_jobs_async``);
  4. host: collect the sieve, patch the blobs it found secrets in and
     re-merge every image's secrets; collect the waves;
  5. host: per-image result assembly, enrichment.

Cached images skip 1-2 entirely (content-addressed ``missing_blobs``).
Two kernel dispatches per BATCH — not per image — amortize dispatch
latency across the whole fleet.

With ``sched`` other than ``"off"`` every image (or BOM) becomes one
request of the continuous-batching scheduler (``sched/``): it is
loaded, analyzed and joined on the scheduler's host workers, joins
whichever device batch is forming, and is finished back on the pool
(``_scan_scheduled``, ``submit_path``). ``mesh`` (a
``parallel.mesh.DeviceMesh``) shards both device stages over its
devices on either path: the runner's ``BatchSecretScanner`` sieves per
shard and every interval dispatch splits its rows per shard. ``memo``
(a ``memo.FindingsMemo``) goes into every ``LocalScanner`` the runner
builds, on both paths: a layer whose detection questions were
answered before dispatches nothing. A ``store`` that is a
``db.compiled.SwappableStore`` is acquired per scan and released
exactly once, so a hot swap waits for in-flight scans.
``scan_registry_refs`` scans images straight from a registry on either
path: each ref streams (``artifact/stream.py``: layer blobs inflate
into the scan as they arrive, and the warm layers that ``blob_keyer``
finds in the cache are never fetched) or, with ``streaming=False``,
is pulled whole first (``artifact/registry.py``); on the scheduled
path the ref is loaded inside the request's analyze. A scan run under
an active span (the simhost root, a propagated watch submission)
joins that span's trace (``obs/propagate.py::current_context``).

Both paths trace every image as a request (``obs/trace.py``): on the
direct path its root has ``analyze`` (with the ``join`` of prepare),
one ``device`` span shared by the fleet's dispatch window, under whose
first member the batch's phase spans record from every thread that
does the work (pack on the host pool, the ring's slot waits, the
interval waves' busy spans, the sieve's collect), and ``report``.
"""

from __future__ import annotations

import copy
import logging
import tarfile
import time
from dataclasses import dataclass, field
from typing import Optional

from ..applier import merge_layer_secrets
from ..artifact.artifact import ArtifactOption, ImageArtifact
from ..artifact.cache import MemoryCache
from ..artifact.image import load_image
from ..artifact.registry import DistributionClient
from ..artifact.sbom import decode_to_blob
from ..artifact.stream import stream_image
from ..db import AdvisoryStore
from ..detect.batch import (collect_dispatch, dispatch_jobs,
                            dispatch_jobs_async)
from ..guard.budget import GuardError, make_budget
from ..obs.trace import activate_or_null, get_tracer, phase_span, \
    trace_cause
from ..scan.local import LocalScanner, ScanTarget
from ..sched import (AnalyzedWork, DeadlineExceeded, QueueFullError,
                     RateLimitedError, ScanRequest, ScanScheduler,
                     SchedConfig, SchedulerClosed)
from ..sched.queue import DeviceDispatchError
from ..secret.batch import BatchSecretScanner, rules_fingerprint
from ..types import Metadata, Report, ScanOptions
from ..types.report import FailureCause
from ..utils import defer_gc
from .hostpool import get_host_pool, map_in_pool
from .ring import (RING_METRICS, DispatchRing, RingMetrics,
                   TeeRingMetrics, resolve_dispatch_depth)

log = logging.getLogger("trivy_tpu_torch.runtime.batch")


@dataclass
class BatchScanResult:
    name: str
    report: Optional[Report] = None
    error: str = ""
    # degraded-mode status: ok | degraded | failed, with
    # machine-readable FailureCause records. A slot with ``error`` set
    # is failed; a slot that completed through a survivable fault is
    # degraded.
    status: str = "ok"
    causes: list = field(default_factory=list)

    def apply_degraded(self, causes: list) -> None:
        fc = [FailureCause.coerce(c) for c in causes]
        self.causes.extend(fc)
        if self.status != "failed":
            self.status = "degraded"
        if self.report is not None:
            self.report.mark_degraded(fc)

    def mark_failed(self, stage: str, kind: str,
                    message: str) -> "BatchScanResult":
        self.status = "failed"
        self.causes.append(FailureCause(stage=stage, kind=kind,
                                        message=message))
        if self.report is not None:
            self.report.mark_degraded(self.causes[-1:],
                                      status="failed")
        return self


class BatchScanRunner:
    def __init__(self, store: Optional[AdvisoryStore] = None,
                 cache=None, backend: str = "cuda", mesh=None,
                 secret_scanner=None, sched="off", sched_config=None,
                 artifact_option=None, fault_injector=None,
                 tracer=None, memo=None, dispatch_depth: int = 0):
        self.store = store if store is not None else AdvisoryStore()
        self.cache = cache if cache is not None else MemoryCache()
        # dispatch_depth: bound on in-flight interval waves — the
        # double-buffered slot runtime. 0 = TRIVY_TPU_DISPATCH_DEPTH or
        # the default 2; 1 restores the synchronous ladder
        self.dispatch_depth = resolve_dispatch_depth(dispatch_depth)
        # memo: memo.FindingsMemo (or None) — per-layer detection
        # verdicts, threaded into every LocalScanner this runner builds
        self.memo = memo
        self.backend = backend
        self.mesh = mesh
        if secret_scanner is None:
            secret_scanner = BatchSecretScanner(backend=backend,
                                                mesh=mesh)
        self.secret_scanner = secret_scanner
        self.artifact_option = artifact_option
        # tracer: obs.trace.Tracer — per-request span trees on both
        # paths
        self.tracer = tracer if tracer is not None else get_tracer()
        # fault_injector: faults.FaultInjector (or None; --fault-spec)
        # — threads into the scheduler's device dispatch
        # (on_device_dispatch), this runner's host phases
        # (on_host_analyze, on_image_load) and the registry client's
        # blob fetches (on_blob_chunk)
        self.fault_injector = fault_injector
        # sched: "off" = the direct single-batch ladder below;
        # "on"/SchedConfig/ScanScheduler = continuous batching with
        # pipelined host/device overlap (sched/)
        self.sched_config = sched_config
        self._scheduler = None
        self._owns_scheduler = False
        if hasattr(sched, "submit"):       # a ScanScheduler
            self._scheduler = sched        # shared — caller closes
            self.sched = "on"
        elif sched not in (None, "off", False):
            self.sched = "on"
            if isinstance(sched, SchedConfig):
                self.sched_config = sched
        else:
            self.sched = "off"
        self.last_stats: dict = {}   # phase timings of the last batch

    # --- scheduler plumbing ---

    @property
    def scheduler(self):
        if self._scheduler is None:
            cfg = self.sched_config
            if cfg is None:
                # propagate the runner's slot depth so --sched on
                # and off honor the same --dispatch-depth knob
                cfg = SchedConfig(dispatch_depth=self.dispatch_depth)
            self._scheduler = ScanScheduler(
                config=cfg, backend=self.backend, mesh=self.mesh,
                secret_scanner=self.secret_scanner,
                tracer=self.tracer)
            self._scheduler.fault_injector = self.fault_injector
            self._owns_scheduler = True
        return self._scheduler

    def close(self) -> None:
        # only tear down a scheduler this runner constructed — an
        # externally provided one may serve other request sources
        if self._scheduler is not None and self._owns_scheduler:
            self._scheduler.close()
            self._scheduler = None

    def _store_view(self) -> tuple:
        """``(db, release|None)``: a ``SwappableStore`` holder is
        acquired per scan so a ``db update`` swap waits for in-flight
        work; plain stores pass through untouched."""
        s = self.store
        if hasattr(s, "acquire") and hasattr(s, "release"):
            return s.acquire(), s.release
        return s, None

    def scan_paths(self, paths: list,
                   options: Optional[ScanOptions] = None) -> list:
        if self.sched == "on":
            # lazy image load inside analyze() — tar walking is host
            # work that should overlap device execution too
            return self._scan_scheduled(
                [(p, None) for p in paths], options)
        images, failures = [], {}
        for i, p in enumerate(paths):
            try:
                if self.fault_injector is not None:
                    self.fault_injector.on_image_load(p)
                images.append((i, load_image(
                    p, budget=self._ingest_budget(p))))
            except (OSError, ValueError, tarfile.TarError) as e:
                failures[i] = _failed_slot(p, e)
        results = self.scan_images([img for _, img in images],
                                   options)
        out = dict(failures)
        for (i, _), res in zip(images, results):
            out[i] = res
        return [out[i] for i in range(len(paths))]

    def scan_images(self, images: list,
                    options: Optional[ScanOptions] = None) -> list:
        if self.sched == "on":
            return self._scan_scheduled(
                [(getattr(img, "name", ""), img) for img in images],
                options)
        with defer_gc():
            return self._scan_images(images, options)

    def blob_keyer(self, scan_secrets: bool = True):
        """Warm-layer probe keyer for ``artifact.stream.stream_image``:
        computes the SAME ``(artifact_id, blob_ids, base)`` this
        runner's inspect will scan under — same artifact option, same
        secret-rules fingerprint — from image *metadata* alone, so the
        streaming path can skip the blob GET for every layer the
        cache already holds. A mismatched keyer would skip layers
        inspect then reports missing (a failed scan), which is why
        this lives on the runner instead of the stream module."""
        opt = self._image_opt(scan_secrets)

        def keyer(img):
            a = ImageArtifact(img, self.cache, opt,
                              budget=getattr(img, "ingest_budget",
                                             None))
            return a.cache_keys()

        return keyer

    def scan_registry_refs(self, refs: list, client=None,
                           options: Optional[ScanOptions] = None,
                           streaming: bool = True) -> list:
        """Scan images straight from a registry, on the direct or the
        scheduled path (``sched``). With ``streaming`` (the default)
        each ref becomes a ``StreamingImageSource``: layer blobs
        decompress into the scan as they arrive, warm layers skip
        their GET entirely, and the per-layer pipeline overlaps the
        fleet's device work. ``streaming=False`` pulls each image
        whole first (``DistributionClient.pull``), the baseline.
        ``client`` is a ``DistributionClient`` (a new one when None);
        the runner's fault injector reaches its blob fetches. Results
        come back in ``refs`` order; a ref that cannot be resolved
        fails its own slot."""
        if client is None:
            client = DistributionClient()
        # the registry stream is a failure domain of its own: thread
        # the runner's injector into the blob fetch engine
        client.fault_injector = self.fault_injector
        options = options or ScanOptions(backend=self.backend)
        scan_secrets = "secret" in options.security_checks
        keyer = self.blob_keyer(scan_secrets)

        def load(ref, budget):
            if not streaming:
                return client.pull(ref, budget=budget)
            return stream_image(client, ref, cache=self.cache,
                                keyer=keyer, budget=budget)

        if self.sched == "on":
            return self._scan_scheduled([(r, None) for r in refs],
                                        options, loader=load)
        sources, failures = [], {}
        for i, ref in enumerate(refs):
            try:
                if self.fault_injector is not None:
                    self.fault_injector.on_image_load(ref)
                sources.append((i, load(ref, self._ingest_budget(ref))))
            except (OSError, ValueError) as e:
                # RegistryError is a ValueError; GuardError keeps its
                # typed ingest stage/kind through _failed_slot
                failures[i] = _failed_slot(ref, e)
        try:
            results = self.scan_images([src for _, src in sources],
                                       options)
        finally:
            for _, src in sources:
                try:
                    src.close()
                    getattr(src, "cleanup", lambda: None)()
                except Exception:   # noqa: BLE001 — cleanup only
                    log.debug("source close failed", exc_info=True)
        out = dict(failures)
        for (i, _), res in zip(sources, results):
            out[i] = res
        return [out[i] for i in range(len(refs))]

    def _ingest_budget(self, name: str):
        """Fresh per-target ResourceBudget, or None when the runner's
        artifact option disabled the guards (``--no-ingest-guards``)."""
        opt = self.artifact_option
        enabled = opt.ingest_guards if opt is not None else True
        return make_budget(
            getattr(opt, "ingest_limits", None) if opt else None,
            enabled=enabled, name=name)

    def _image_opt(self, scan_secrets: bool) -> ArtifactOption:
        """Per-scan artifact option: the runner-level template (CLI
        skip dirs / file patterns) with secret scanning routed to the
        batch sieve instead of a per-artifact scanner."""
        if self.artifact_option is None:
            return ArtifactOption(
                scan_secrets=scan_secrets,
                secret_rules_fp=rules_fingerprint(
                    self.secret_scanner))
        opt = copy.copy(self.artifact_option)
        opt.scan_secrets = scan_secrets and \
            self.artifact_option.scan_secrets
        opt.secret_scanner = None
        # blob keys must reflect the sieve that ACTUALLY produces
        # this runner's secret findings (the shared batch scanner,
        # not the per-option default)
        if not opt.secret_rules_fp:
            opt.secret_rules_fp = rules_fingerprint(
                self.secret_scanner)
        return opt

    # --- the scheduled (continuous-batching) route ---

    def _scan_scheduled(self, items: list,
                        options: Optional[ScanOptions] = None,
                        loader=None) -> list:
        """``items``: [(name, image-or-None)] — None loads the path
        (or, with ``loader``, the registry ref) lazily inside
        analyze(). Submits one request per image to the
        scheduler and gathers results in input order; per-request
        failures (load errors, deadline expiry) fail their own slot,
        never the fleet."""
        options = options or ScanOptions(backend=self.backend)
        sched = self.scheduler
        reqs = []
        for name, img in items:
            req = self._image_request(sched, name, img, options,
                                      loader=loader)
            while True:
                try:
                    reqs.append(sched.submit(req, block=True))
                    break
                except RateLimitedError as e:
                    # closed-loop fleet semantics: block=True means
                    # "wait for capacity", and a tenant rate limit
                    # is capacity too — sleep the shed hint and
                    # retry instead of killing the whole fleet.
                    # Serving callers (submit_path) still surface
                    # the 429 to the client.
                    time.sleep(min(max(e.retry_after_s, 0.01), 5.0))
        out = []
        for (name, _), req in zip(items, reqs):
            try:
                out.append(req.result())
            except Exception as e:       # noqa: BLE001 — one slot's
                # failure (typed or not) must never crash the fleet
                # gather; the cause lands in the slot's report
                out.append(_failed_slot(name, e,
                                        trace_id=req.trace_id,
                                        tracer=self.tracer))
        self.last_stats = {"images": len(items),
                           "sched": sched.stats()}
        for k, v in self.last_stats["sched"].items():
            if k.endswith("_s") or k == "overlap_ratio":
                self.last_stats[k] = v
        return out

    def submit_path(self, path: str,
                    options: Optional[ScanOptions] = None,
                    tenant: str = "", priority: int = 0,
                    trace_id: str = "", parent_span_id: str = ""):
        """Serving-mode entry: enqueue ONE image scan through the
        scheduler and return its ScanRequest future (``.result()``
        blocks; raises QueueFullError on backpressure, or
        RateLimitedError when the ``tenant`` is over its quota or
        rate limit — docs/serving.md "Multi-tenant QoS"). The batch
        composition is the scheduler's business — concurrent
        submitters share device dispatches across tenants."""
        options = options or ScanOptions(backend=self.backend)
        sched = self.scheduler
        return sched.submit(
            self._image_request(sched, path, None, options,
                                tenant=tenant, priority=priority,
                                trace_id=trace_id,
                                parent_span_id=parent_span_id))

    def _image_request(self, sched, name: str, image, options,
                       tenant: str = "", priority: int = 0,
                       trace_id: str = "", parent_span_id: str = "",
                       loader=None):
        scan_secrets = "secret" in options.security_checks

        def analyze(req):
            inj = self.fault_injector
            if inj is not None:
                # host failure domains: corrupt layer tar fails this
                # slot only; a slow-host stall eats into the deadline
                inj.on_host_analyze(name)
                inj.on_image_load(name)
            db, release = self._store_view()
            if release is not None:
                # the reader is held from analyze to resolution so a
                # DB hot swap waits for this scan; chained AFTER any
                # caller-provided on_done, released exactly once at
                # whatever resolution path fires first
                prev = req.on_done

                def _done(r, _prev=prev, _rel=release):
                    try:
                        if _prev is not None:
                            _prev(r)
                    finally:
                        _rel()
                req.on_done = _done
            budget = self._ingest_budget(name)
            # loader: the registry seam (scan_registry_refs) — a
            # StreamingImageSource (or a pulled image) instead of a
            # local tar; either way the image is loaded INSIDE analyze
            # so manifest/config fetches overlap device execution like
            # tar walking does
            if image is not None:
                img = image
            elif loader is not None:
                img = loader(name, budget)
            else:
                img = load_image(name, budget=budget)
            owns_img = image is None
            opt = self._image_opt(scan_secrets)
            a = _SchedImageArtifact(img, self.cache, opt,
                                    budget=budget)
            # register pending blob writes BEFORE the analyzed blobs
            # land in the cache (the _batch_secrets hook fires between
            # analysis and put_blob), so a concurrent request can
            # never observe an unpatched blob without also seeing the
            # dependency that guards it
            a._sched = sched
            a._sched_req = req
            try:
                ref = a.inspect()
            finally:
                if owns_img:
                    # after inspect every analyzed byte lives in the
                    # cache; release the source now (a streaming
                    # source's spools are whole decompressed layers
                    # on disk, a pulled image's layout too)
                    try:
                        img.close()
                        getattr(img, "cleanup", lambda: None)()
                    except Exception:   # noqa: BLE001 — cleanup
                        log.debug("source close failed for %r",
                                  name, exc_info=True)
            a.reference = ref
            if a.budget is not None:
                # survivable hostile input (e.g. a corrupt rpmdb):
                # the slot completes but reports status=degraded
                # with ingest-stage causes
                for kind, msg in a.budget.soft_faults:
                    req.record_fault("ingest", kind, msg)
            scanner = LocalScanner(self.cache, db, memo=self.memo)
            prepared = scanner.prepare(
                ScanTarget(name=ref.name, artifact_id=ref.id,
                           blob_ids=ref.blob_ids), options)
            candidates = []
            patch = None
            deps = []
            if scan_secrets:
                # collected paths already carry the image '/' prefix
                candidates = [(path, content)
                              for _, path, content in a.collected]
                deps = sched.blob_deps(ref.blob_ids, req)
                if a.collected:
                    patch = _make_patch(self.cache, a)

            def finish(found, detected):
                if scan_secrets:
                    blobs = [self.cache.get_blob(b)
                             for b in ref.blob_ids]
                    prepared.detail.secrets = \
                        merge_layer_secrets(blobs)
                results, os_found = scanner.finish(prepared,
                                                   detected)
                return BatchScanResult(
                    name=ref.name,
                    report=Report(
                        artifact_name=ref.name,
                        artifact_type="container_image",
                        metadata=Metadata(
                            os=os_found,
                            image_id=ref.image_metadata.id,
                            diff_ids=ref.image_metadata.diff_ids,
                            repo_tags=ref.image_metadata.repo_tags,
                            image_config=ref.image_metadata
                            .image_config,
                        ),
                        results=results,
                    ))

            return AnalyzedWork(candidates=candidates,
                                jobs=prepared.jobs, patch=patch,
                                finish=finish, deps=deps)

        if not trace_id and not parent_span_id:
            # ambient fleet context (obs/propagate.py): a scan
            # submitted under an active span — the simhost root, a
            # watch event's propagated context — joins that trace
            # instead of starting an unlinked one
            from ..obs.propagate import current_context
            ctx = current_context()
            if ctx is not None:
                trace_id = ctx.trace_id
                parent_span_id = ctx.parent_span_id
        return ScanRequest(name=name or getattr(image, "name", ""),
                           analyze=analyze,
                           deadline_s=getattr(options, "deadline_s",
                                              0.0) or 0.0,
                           tenant=tenant, priority=priority,
                           trace_id=trace_id[:64],
                           parent_span_id=parent_span_id[:64])

    def _scan_images(self, images: list,
                     options: Optional[ScanOptions] = None) -> list:
        db, release = self._store_view()
        try:
            return self._scan_images_db(db, images, options)
        finally:
            if release is not None:
                release()

    def _scan_images_db(self, db, images: list,
                        options: Optional[ScanOptions] = None) \
            -> list:
        options = options or ScanOptions(backend=self.backend)
        scan_secrets = "secret" in options.security_checks

        # ---- phase 1: analyze missing layers, collect candidates,
        # squash + join PER IMAGE ----
        # tracing: the direct path has no queue, so each image's span
        # tree is analyze → device (the fleet-shared dispatch window)
        # → report
        tracer = self.tracer
        # ambient fleet context (obs/propagate.py): scans launched
        # under an active span (the simhost root, a propagated watch
        # submission) join that trace — per-image roots become its
        # remote-style children; with no ambient span the behavior
        # is identical to the single-process path
        from ..obs.propagate import current_context
        amb = current_context()
        slots, failures = [], {}     # [(input idx, artifact)]
        roots: dict = {}             # input idx -> root span
        opt = self._image_opt(scan_secrets)
        scanner = LocalScanner(self.cache, db, memo=self.memo)
        prepared = []                # aligned with slots
        analyze_s = join_s = 0.0
        for idx, img in enumerate(images):
            name = getattr(img, "name", "")
            root = roots[idx] = tracer.start_request(
                name,
                trace_id=amb.trace_id if amb else "",
                parent_span_id=amb.parent_span_id if amb else "")
            a = _CollectingImageArtifact(img, self.cache, opt)
            sp = tracer.child(root, "analyze")
            t1 = time.perf_counter()
            try:
                with sp.activate():
                    a.reference = a.inspect()
            except Exception as e:   # noqa: BLE001 — a hostile or
                # broken artifact fails ITS slot with a typed cause;
                # the fleet keeps scanning
                sp.end("error")
                root.set("error", repr(e))
                root.end("failed")
                failures[idx] = _failed_slot(
                    name, e, trace_id=root.trace_id, tracer=tracer)
                continue
            analyze_s += time.perf_counter() - t1
            # squash + advisory join for THIS image immediately,
            # instead of a fleet-wide barrier after every analyze;
            # prepare emits its own "join" phase span (scan/local.py)
            t1 = time.perf_counter()
            ref = a.reference
            with sp.activate():
                prepared.append(scanner.prepare(
                    ScanTarget(name=ref.name, artifact_id=ref.id,
                               blob_ids=ref.blob_ids), options))
            join_s += time.perf_counter() - t1
            sp.end()
            slots.append((idx, a))
        artifacts = [a for _, a in slots]
        # one shared device window per surviving image: the sieve and
        # interval dispatches below serve the whole fleet, so every
        # slot's "device" span brackets the same wall interval
        dev_spans = {idx: tracer.child(roots[idx], "device", shared=True)
                     for idx, _ in slots}
        # pack/h2d_upload/db_upload phase spans attach under the
        # fleet's first shared device span (they bracket work done
        # once for the whole batch), on every thread that does it
        sp0 = next(iter(dev_spans.values()), None)

        ring = None
        try:
            # ---- phase 2a: ENQUEUE the sieve dispatch ----
            # the packing + enqueue runs on the host pool so the interval
            # enqueue below overlaps the SEGMENT PACKING too, not just the
            # device execution behind it; results are collected in 2b —
            # the secret part of the squash is re-derived afterwards via
            # applier.merge_layer_secrets
            t0 = time.perf_counter()
            collected = [c for a in artifacts for c in a.collected]
            sec_stats: dict = {}       # only this batch's, never stale
            sieve_handle = sieve_future = None

            def _enqueue_sieve(files):
                with activate_or_null(sp0):
                    return self.secret_scanner.dispatch_files(files)

            if scan_secrets and collected:
                pool = get_host_pool()
                files = [(p, c) for _, p, c in collected]
                if pool is not None:
                    sieve_future = pool.submit(_enqueue_sieve, files)
                else:
                    sieve_handle = _enqueue_sieve(files)
            secret_s = time.perf_counter() - t0

            # ---- phase 4a: ENQUEUE the interval waves ----
            # dedup + wave packing + uploads run here, every wave is
            # launched into a bounded dispatch ring, and the ring's drain
            # thread waits for wave N while wave N+1 packs — so the device
            # computes THROUGH the sieve collect below instead of
            # serializing after it. Joined AFTER the sieve enqueue so the
            # device work stays in enqueue order.
            t0 = time.perf_counter()
            if sieve_future is not None:
                sieve_handle = sieve_future.result()
                secret_s += time.perf_counter() - t0
                t0 = time.perf_counter()
            all_jobs = []
            for idx, p in enumerate(prepared):
                for job in p.jobs:
                    job.payload = (idx, job.payload)
                    all_jobs.append(job)
            detected_by_image: dict = {}
            kstats: dict = {}          # this batch's dispatch counters
            # per-scan books: the ring reports into its own RingMetrics
            # (exact for THIS scan even when concurrent scans run their
            # own rings in-process) AND the process-wide RING_METRICS
            scan_rm = RingMetrics()
            if all_jobs and options.backend != "cpu-ref" \
                    and self.dispatch_depth > 1:
                ring = DispatchRing(depth=self.dispatch_depth,
                                    name="interval",
                                    metrics=TeeRingMetrics(
                                        scan_rm, RING_METRICS))
            with activate_or_null(sp0):
                ih = dispatch_jobs_async(all_jobs,
                                         backend=options.backend,
                                         mesh=self.mesh, stats=kstats,
                                         ring=ring)
            interval_s = time.perf_counter() - t0

            # ---- phase 2b: sieve collect + late secret merge ----
            # overlaps the interval waves still computing/draining
            t0 = time.perf_counter()
            if sieve_handle is not None:
                with activate_or_null(sp0):
                    # collect emits its own dfa_scan/decode/verify
                    # phase spans; the blob patch + re-merge is
                    # collect-side host work too
                    found = self.secret_scanner.collect(sieve_handle)
                    with phase_span("decode", stage="patch"):
                        _patch_blobs(self.cache, artifacts, found)
                        sec_stats = dict(getattr(self.secret_scanner,
                                                 "stats", {}))
                        # re-merge EVERY artifact: a patched blob may
                        # be shared with artifacts whose own
                        # `collected` is empty (fleets share layers —
                        # the cached-layer case), and their prepare()
                        # ran before the patch landed. Nothing found →
                        # nothing patched → prepare()'s merge stands.
                        if found:
                            for a, p in zip(artifacts, prepared):
                                blobs = [self.cache.get_blob(b)
                                         for b in a.reference.blob_ids]
                                p.detail.secrets = \
                                    merge_layer_secrets(blobs)
            secret_s += time.perf_counter() - t0

            # ---- phase 4b: collect the interval waves ----
            t0 = time.perf_counter()
            with activate_or_null(sp0):
                detected_pairs = collect_dispatch(ih)
            for idx, payload in detected_pairs:
                detected_by_image.setdefault(idx, []).append(payload)
            interval_s += time.perf_counter() - t0
        except BaseException:
            # a failed launch or collect fails the whole batch: its
            # shared device spans and its roots end as errors, so the
            # traces finish (and export) instead of staying open
            for idx, _ in slots:
                dev_spans[idx].end("error")
                roots[idx].end("error")
            raise
        finally:
            if ring is not None:
                ring.close()
        for sp in dev_spans.values():
            sp.end()

        ring1 = scan_rm.snapshot()
        ring_busy = ring1["slot_busy_s"]
        ring_overlap = ring1["slot_overlap_s"]
        jobs_in = kstats.get("jobs_in", len(all_jobs))
        self.last_stats = {
            "images": len(images),
            "analyze_s": round(analyze_s, 4),
            "secret_batch_s": round(secret_s, 4),
            "squash_join_s": round(join_s, 4),
            "interval_dispatch_s": round(interval_s, 4),
            "interval_device_s": round(
                kstats.get("device_s", 0.0), 4),
            "interval_jobs": len(all_jobs),
            "interval_jobs_unique": kstats.get("jobs_unique", 0),
            "interval_dedup_ratio": round(
                1.0 - kstats.get("jobs_unique", 0) / jobs_in, 4)
            if jobs_in else 0.0,
            # slot-runtime accounting for THIS scan: how much of the
            # in-flight wall ran >= 2 waves deep
            "dispatch_depth": self.dispatch_depth,
            "interval_waves": ih.waves,
            "dispatch_overlap_ratio": round(
                ring_overlap / ring_busy, 4) if ring_busy > 0
            else 0.0,
            "secret": sec_stats,
        }

        # ---- phase 5: assemble per image ----
        out = dict(failures)
        for local, ((idx, a), p) in enumerate(zip(slots, prepared)):
            sp = tracer.child(roots[idx], "report")
            with sp.activate():
                results, os_found = scanner.finish(
                    p, detected_by_image.get(local, []))
                ref = a.reference
                res = BatchScanResult(
                    name=ref.name,
                    report=Report(
                        artifact_name=ref.name,
                        artifact_type="container_image",
                        metadata=Metadata(
                            os=os_found,
                            image_id=ref.image_metadata.id,
                            diff_ids=ref.image_metadata.diff_ids,
                            repo_tags=ref.image_metadata.repo_tags,
                            image_config=ref.image_metadata.image_config,
                        ),
                        results=results,
                    ))
            sp.end()
            root = roots[idx]
            b = getattr(a, "budget", None)
            degraded = b is not None and b.soft_faults
            if degraded:
                causes = [{"stage": "ingest", "kind": k, "message": m}
                          for k, m in b.soft_faults]
                if not root.noop:
                    causes.append(trace_cause(tracer, root.trace_id))
                res.apply_degraded(causes)
            root.end("degraded" if degraded else "ok")
            out[idx] = res
        return [out[i] for i in range(len(images))]

    def scan_boms(self, boms: list,
                  options: Optional[ScanOptions] = None) -> list:
        """Batch-scan SBOM documents: ``boms`` is a list of
        (name, raw-bytes). No tar walking, no analyzers: decode →
        name-join → ONE interval dispatch for the whole fleet against
        the resident advisory tables."""
        if self.sched == "on":
            return self._scan_boms_scheduled(boms, options)
        with defer_gc():
            return self._scan_boms(boms, options)

    def _scan_boms_scheduled(self, boms: list,
                             options: Optional[ScanOptions] = None)\
            -> list:
        options = options or ScanOptions(
            backend=self.backend, security_checks=["vuln"])
        sched = self.scheduler
        reqs = [sched.submit(self._bom_request(name, data, options),
                             block=True)
                for name, data in boms]
        out = []
        for (name, _), req in zip(boms, reqs):
            try:
                out.append(req.result())
            except Exception as e:       # noqa: BLE001
                out.append(_failed_slot(name, e))
        self.last_stats = {"sboms": len(boms),
                           "sched": sched.stats()}
        return out

    def _bom_request(self, name: str, data: bytes, options):
        def analyze(req):
            db, release = self._store_view()
            if release is not None:
                prev = req.on_done

                def _done(r, _prev=prev, _rel=release):
                    try:
                        if _prev is not None:
                            _prev(r)
                    finally:
                        _rel()
                req.on_done = _done
            # a malformed document fails its own slot, never the
            # fleet (ValueError resolves this request only)
            atype, decoded, blob, blob_id = decode_to_blob(data)
            self.cache.put_blob(blob_id, blob)
            scanner = LocalScanner(self.cache, db, memo=self.memo)
            prepared = scanner.prepare(
                ScanTarget(name=name, artifact_id=blob_id,
                           blob_ids=[blob_id]), options)

            def finish(found, detected):
                results, os_found = scanner.finish(prepared,
                                                   detected)
                return BatchScanResult(
                    name=name,
                    report=Report(artifact_name=name,
                                  artifact_type=atype,
                                  metadata=Metadata(os=os_found),
                                  results=results,
                                  cyclonedx=decoded.cyclonedx))

            return AnalyzedWork(jobs=prepared.jobs, finish=finish)

        return ScanRequest(name=name, analyze=analyze,
                           deadline_s=getattr(options, "deadline_s",
                                              0.0) or 0.0)

    def _scan_boms(self, boms: list,
                   options: Optional[ScanOptions] = None) -> list:
        db, release = self._store_view()
        try:
            return self._scan_boms_db(db, boms, options)
        finally:
            if release is not None:
                release()

    def _scan_boms_db(self, db, boms: list,
                      options: Optional[ScanOptions] = None) -> list:
        options = options or ScanOptions(
            backend=self.backend, security_checks=["vuln"])

        # ---- phase 1: decode + blob (host, pooled) ----
        # the host pool spreads document decodes over the spare cores
        # in ≥64-doc slabs; a malformed document fails only its own
        # slot
        t0 = time.perf_counter()
        scanner = LocalScanner(self.cache, db, memo=self.memo)

        def decode_one(item):
            _name, data = item
            try:
                return decode_to_blob(data)
            except ValueError as e:
                return e

        decodes = map_in_pool(decode_one, list(boms), chunk=64)
        prepared, metas, failures = [], [], {}
        for i, ((name, _data), dec) in enumerate(zip(boms, decodes)):
            if isinstance(dec, ValueError):
                failures[i] = _failed_slot(name, dec)
                continue
            atype, decoded, blob, blob_id = dec
            self.cache.put_blob(blob_id, blob)
            prepared.append((i, scanner.prepare(
                ScanTarget(name=name, artifact_id=blob_id,
                           blob_ids=[blob_id]), options)))
            metas.append((i, name, atype, decoded))
        decode_s = time.perf_counter() - t0

        # ---- phase 2: ONE interval dispatch over all SBOMs ----
        t0 = time.perf_counter()
        all_jobs = []
        for idx, (_, p) in enumerate(prepared):
            for job in p.jobs:
                job.payload = (idx, job.payload)
                all_jobs.append(job)
        detected: dict = {}
        kstats: dict = {}
        for idx, payload in dispatch_jobs(all_jobs,
                                          backend=options.backend,
                                          mesh=self.mesh, stats=kstats):
            detected.setdefault(idx, []).append(payload)
        interval_s = time.perf_counter() - t0

        # ---- phase 3: assemble ----
        out = dict(failures)
        for idx, ((i, p), (_, name, atype, decoded)) in \
                enumerate(zip(prepared, metas)):
            results, os_found = scanner.finish(
                p, detected.get(idx, []))
            out[i] = BatchScanResult(
                name=name,
                report=Report(artifact_name=name,
                              artifact_type=atype,
                              metadata=Metadata(os=os_found),
                              results=results,
                              cyclonedx=decoded.cyclonedx))
        jobs_in = kstats.get("jobs_in", len(all_jobs))
        self.last_stats = {
            "sboms": len(boms),
            "decode_s": round(decode_s, 4),
            "interval_dispatch_s": round(interval_s, 4),
            "interval_device_s": round(
                kstats.get("device_s", 0.0), 4),
            "interval_jobs": len(all_jobs),
            "interval_jobs_unique": kstats.get("jobs_unique", 0),
            "interval_dedup_ratio": round(
                1.0 - kstats.get("jobs_unique", 0) / jobs_in, 4)
            if jobs_in else 0.0,
        }
        return [out[i] for i in range(len(boms))]


class _CollectingImageArtifact(ImageArtifact):
    """ImageArtifact that defers secret scanning to the batch: its
    _batch_secrets records (layer, path, content) and returns nothing;
    the runner patches blobs once the fleet's sieve resolves."""

    def inspect(self):
        self.collected = []        # per-instance, even when cached
        return super().inspect()

    def _batch_secrets(self, candidates: list) -> dict:
        self.collected = [(li, "/" + path, content)
                          for li, path, content in candidates]
        return {}


class _SchedImageArtifact(_CollectingImageArtifact):
    """Collecting artifact that additionally announces which cache
    blobs this request will patch — registered with the scheduler
    BEFORE put_blob runs, so concurrent requests sharing a layer
    always see either the patched blob or the pending-write event —
    and that puts a blob another request analyzed and put meanwhile
    never again (``Scheduler.put_analyzed_blob``): a second, unpatched
    copy would replace the first request's patch under its finish."""

    _sched = None
    _sched_req = None
    _since = -1

    def inspect(self):
        if self._sched is None:
            return super().inspect()
        self._since = self._sched.inspect_began()
        try:
            return super().inspect()
        finally:
            self._sched.inspect_ended(self._since)

    def _put_blob(self, blob_id: str, blob) -> None:
        if self._sched is None:
            return super()._put_blob(blob_id, blob)
        self._sched.put_analyzed_blob(self.cache, blob_id, blob,
                                      self._since)

    def _inspect_layers(self, todo, blob_ids, base):
        self._sched_blob_ids = blob_ids
        return super()._inspect_layers(todo, blob_ids, base)

    def _batch_secrets(self, candidates: list) -> dict:
        if candidates and self._sched is not None and \
                self.opt.scan_secrets:
            ids = sorted({self._sched_blob_ids[li]
                          for li, _, _ in candidates})
            self._sched.register_blob_writes(ids, self._sched_req)
        return super()._batch_secrets(candidates)


def _failed_slot(name: str, err: BaseException, trace_id: str = "",
                 tracer=None) -> BatchScanResult:
    """One failed fleet slot with a machine-readable cause: the
    typed scheduler errors map to distinct kinds so a caller can
    tell backpressure (retryable) from deadline (not) from a broken
    image. When the slot was traced, a trailing ``obs/trace`` cause
    references the flight-recorder dump (the primary cause stays
    first — callers key off ``causes[0]``)."""
    if isinstance(err, GuardError):
        # resource-budget (bombs, floods, deadlines) or
        # malformed-archive (traversal, truncation, undecodable names)
        stage, kind = err.stage, err.kind
    elif isinstance(err, DeadlineExceeded):
        stage, kind = "sched", "deadline_exceeded"
    elif isinstance(err, QueueFullError):
        stage, kind = "sched", "queue_full"
    elif isinstance(err, SchedulerClosed):
        stage, kind = "sched", "shutdown"
    elif isinstance(err, DeviceDispatchError):
        stage, kind = "device", "dispatch_failed"
    elif isinstance(err, (OSError, ValueError, tarfile.TarError)):
        stage, kind = "host", "load_failed"
    else:
        stage, kind = "sched", "error"
    res = BatchScanResult(name=name, error=str(err)).mark_failed(
        stage, kind, str(err))
    if trace_id and tracer is not None:
        res.causes.append(
            FailureCause.coerce(trace_cause(tracer, trace_id)))
    return res


def _make_patch(cache, artifact):
    """Per-request secret patch: map batch sieve results back to this
    artifact's layers by the LOCAL candidate index and rewrite the
    affected cached blobs (the one-artifact slice of _patch_blobs)."""

    def patch(found: list) -> None:
        by_layer: dict = {}
        for idx, s in found:
            li = artifact.collected[idx][0]
            by_layer.setdefault(li, []).append(s)
        for li, secrets in by_layer.items():
            blob_id = artifact.reference.blob_ids[li]
            blob = cache.get_blob(blob_id)
            if blob is not None:
                secrets.sort(key=lambda s: s.file_path)
                for s in secrets:
                    s.findings.sort(key=lambda f: (f.rule_id,
                                                   f.start_line))
                blob.secrets = secrets
                cache.put_blob(blob_id, blob)

    return patch


def _patch_blobs(cache, artifacts, found) -> None:
    """Map batch results back to (artifact, layer) by the entry index
    scan_files returns and rewrite the affected cached blobs. Path
    strings are never consulted: fleets share file trees, so identical
    paths across images/layers are the common case, not the
    exception."""
    owners = []
    for a in artifacts:
        for li, _path, _ in a.collected:
            owners.append((a, li))
    by_blob: dict = {}
    for idx, s in found:
        a, li = owners[idx]
        by_blob.setdefault((a, li), []).append(s)
    for (a, li), secrets in by_blob.items():
        blob_id = a.reference.blob_ids[li]
        blob = cache.get_blob(blob_id)
        if blob is not None:
            secrets.sort(key=lambda s: s.file_path)
            for s in secrets:
                s.findings.sort(key=lambda f: (f.rule_id,
                                               f.start_line))
            blob.secrets = secrets
            cache.put_blob(blob_id, blob)
