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

Only the direct path is here: ``sched`` must be ``"off"`` (the
continuous-batching scheduler is ROADMAP A.5). The reference's
``mesh`` (A.6), ``memo`` (A.7), ``tracer`` (A.8) and
``fault_injector`` (A.9) arguments are not taken until their items
are ported, nor are ``blob_keyer`` and ``scan_registry_refs`` (A.9).
"""

from __future__ import annotations

import copy
import tarfile
import time
from dataclasses import dataclass, field
from typing import Optional

from ..applier import merge_layer_secrets
from ..artifact.artifact import ArtifactOption, ImageArtifact
from ..artifact.cache import MemoryCache
from ..artifact.image import load_image
from ..artifact.sbom import decode_to_blob
from ..db import AdvisoryStore
from ..detect.batch import (collect_dispatch, dispatch_jobs,
                            dispatch_jobs_async)
from ..guard.budget import GuardError, make_budget
from ..scan.local import LocalScanner, ScanTarget
from ..secret.batch import BatchSecretScanner, rules_fingerprint
from ..types import Metadata, Report, ScanOptions
from ..types.report import FailureCause
from ..utils import defer_gc
from .hostpool import get_host_pool, map_in_pool
from .ring import (RING_METRICS, DispatchRing, RingMetrics,
                   TeeRingMetrics, resolve_dispatch_depth)


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
                 cache=None, backend: str = "cuda",
                 secret_scanner=None, sched="off",
                 artifact_option=None, dispatch_depth: int = 0):
        if sched != "off":
            raise NotImplementedError(
                "the continuous-batching scheduler is not ported yet "
                "(ROADMAP A.5); pass sched='off'")
        self.store = store if store is not None else AdvisoryStore()
        self.cache = cache if cache is not None else MemoryCache()
        # dispatch_depth: bound on in-flight interval waves — the
        # double-buffered slot runtime. 0 = TRIVY_TPU_DISPATCH_DEPTH or
        # the default 2; 1 restores the synchronous ladder
        self.dispatch_depth = resolve_dispatch_depth(dispatch_depth)
        self.backend = backend
        if secret_scanner is None:
            secret_scanner = BatchSecretScanner(backend=backend)
        self.secret_scanner = secret_scanner
        self.artifact_option = artifact_option
        self.last_stats: dict = {}   # phase timings of the last batch

    def _store_view(self) -> tuple:
        """``(db, release|None)``: plain stores pass through untouched
        (the hot-swappable ``SwappableStore`` holder is ROADMAP A.7)."""
        s = self.store
        if hasattr(s, "acquire") and hasattr(s, "release"):
            return s.acquire(), s.release
        return s, None

    def scan_paths(self, paths: list,
                   options: Optional[ScanOptions] = None) -> list:
        images, failures = [], {}
        for i, p in enumerate(paths):
            try:
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
        with defer_gc():
            return self._scan_images(images, options)

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
        slots, failures = [], {}     # [(input idx, artifact)]
        opt = self._image_opt(scan_secrets)
        scanner = LocalScanner(self.cache, db)
        prepared = []                # aligned with slots
        analyze_s = join_s = 0.0
        for idx, img in enumerate(images):
            name = getattr(img, "name", "")
            a = _CollectingImageArtifact(img, self.cache, opt)
            t1 = time.perf_counter()
            try:
                a.reference = a.inspect()
            except Exception as e:   # noqa: BLE001 — a hostile or
                # broken artifact fails ITS slot with a typed cause;
                # the fleet keeps scanning
                failures[idx] = _failed_slot(name, e)
                continue
            analyze_s += time.perf_counter() - t1
            # squash + advisory join for THIS image immediately,
            # instead of a fleet-wide barrier after every analyze
            t1 = time.perf_counter()
            ref = a.reference
            prepared.append(scanner.prepare(
                ScanTarget(name=ref.name, artifact_id=ref.id,
                           blob_ids=ref.blob_ids), options))
            join_s += time.perf_counter() - t1
            slots.append((idx, a))
        artifacts = [a for _, a in slots]

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
        if scan_secrets and collected:
            pool = get_host_pool()
            files = [(p, c) for _, p, c in collected]
            if pool is not None:
                sieve_future = pool.submit(
                    self.secret_scanner.dispatch_files, files)
            else:
                sieve_handle = self.secret_scanner.dispatch_files(files)
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
        ring = None
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
        try:
            ih = dispatch_jobs_async(all_jobs, backend=options.backend,
                                     stats=kstats, ring=ring)
            interval_s = time.perf_counter() - t0

            # ---- phase 2b: sieve collect + late secret merge ----
            # overlaps the interval waves still computing/draining
            t0 = time.perf_counter()
            if sieve_handle is not None:
                found = self.secret_scanner.collect(sieve_handle)
                _patch_blobs(self.cache, artifacts, found)
                sec_stats = dict(getattr(self.secret_scanner,
                                         "stats", {}))
                # re-merge EVERY artifact: a patched blob may be
                # shared with artifacts whose own `collected` is empty
                # (fleets share layers — the cached-layer case), and
                # their prepare() ran before the patch landed. Nothing
                # found → nothing patched → prepare()'s merge stands.
                if found:
                    for a, p in zip(artifacts, prepared):
                        blobs = [self.cache.get_blob(b)
                                 for b in a.reference.blob_ids]
                        p.detail.secrets = merge_layer_secrets(blobs)
            secret_s += time.perf_counter() - t0

            # ---- phase 4b: collect the interval waves ----
            t0 = time.perf_counter()
            for idx, payload in collect_dispatch(ih):
                detected_by_image.setdefault(idx, []).append(payload)
            interval_s += time.perf_counter() - t0
        finally:
            if ring is not None:
                ring.close()

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
            b = getattr(a, "budget", None)
            if b is not None and b.soft_faults:
                res.apply_degraded([{"stage": "ingest", "kind": k,
                                     "message": m}
                                    for k, m in b.soft_faults])
            out[idx] = res
        return [out[i] for i in range(len(images))]

    def scan_boms(self, boms: list,
                  options: Optional[ScanOptions] = None) -> list:
        """Batch-scan SBOM documents: ``boms`` is a list of
        (name, raw-bytes). No tar walking, no analyzers: decode →
        name-join → ONE interval dispatch for the whole fleet against
        the resident advisory tables."""
        with defer_gc():
            return self._scan_boms(boms, options)

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
        scanner = LocalScanner(self.cache, db)

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
                                          stats=kstats):
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


def _failed_slot(name: str, err: BaseException) -> BatchScanResult:
    """One failed fleet slot with a machine-readable cause: an ingest
    guard trip keeps its typed stage and kind, a load error is
    ``host/load_failed``, anything else ``sched/error`` (the
    reference's scheduler kinds come with ROADMAP A.5)."""
    if isinstance(err, GuardError):
        # resource-budget (bombs, floods, deadlines) or
        # malformed-archive (traversal, truncation, undecodable names)
        stage, kind = err.stage, err.kind
    elif isinstance(err, (OSError, ValueError, tarfile.TarError)):
        stage, kind = "host", "load_failed"
    else:
        stage, kind = "sched", "error"
    return BatchScanResult(name=name, error=str(err)).mark_failed(
        stage, kind, str(err))


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
