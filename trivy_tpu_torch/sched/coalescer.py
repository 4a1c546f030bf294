"""Request coalescer: analyzed requests → padding-bucketed device
batches (reference: ``trivy_tpu/sched/coalescer.py``).

Batching is by WORK VOLUME, not image count (the Orca/vLLM lesson
applied to scanning): a batch closes when its accumulated secret
candidate bytes or interval-job rows reach the flush budget, or when
the oldest pending request has waited ``flush_timeout_s``, or when
the executor reports the pipeline upstream is idle (nothing queued or
analyzing — waiting any longer would only add latency).

Each flushed batch books the smallest PADDING BUCKET ≥ its actual
volume (the reference's buckets quantize device shapes for XLA's
compile cache; the port's kernels take any shape, and keeps the
buckets as the metrics' yardstick): the unused remainder of the
bucket is the padding waste the metrics report (occupancy = volume /
bucket).

Requests carry a ``group`` key (backend + mesh identity: the group
names the backend, and the mesh is its scheduler's own, one per
instance); only same-group requests coalesce — a cpu-ref differential
request never rides a CUDA batch.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from .queue import ScanRequest


def _bucket_for(volume: int, ladder: tuple) -> int:
    for b in ladder:
        if volume <= b:
            return b
    return ladder[-1] if ladder else volume


@dataclass
class SchedConfig:
    """Tuning knobs (see docs/serving.md)."""

    max_queue: int = 256            # admission bound (backpressure)
    workers: int = 4                # host worker pool size
    flush_timeout_s: float = 0.05   # max wait before a partial flush
    max_batch_bytes: int = 4 << 20  # candidate-byte flush budget
    max_batch_jobs: int = 32768     # interval-job flush budget
    max_batch_items: int = 128      # hard cap on requests per batch
    byte_buckets: tuple = (64 << 10, 256 << 10, 1 << 20, 4 << 20)
    job_buckets: tuple = (512, 2048, 8192, 32768)
    default_deadline_s: float = 0.0  # 0 = no deadline
    # poison-image isolation: when a single-request dispatch fails,
    # retry it this many times on-device before quarantining it to
    # the exact host path (docs/robustness.md)
    quarantine_retries: int = 1
    # async device runtime (docs/performance.md §8): bound on
    # launched-but-uncollected device slots. >= 2 double-buffers —
    # batch N+1 packs/uploads while batch N computes; the executor
    # shrinks the EFFECTIVE depth to 1 whenever the pipeline
    # upstream is empty so a latency-sensitive request (admission
    # verdicts) never parks behind a speculative batch. 1 restores
    # the strict synchronous ladder
    dispatch_depth: int = 2
    # flush as soon as the pipeline upstream drains (right for
    # closed-loop fleet scans: no more work is coming). Serving
    # deployments set False so ``flush_timeout_s`` acts as a real
    # batching window — at moderate arrival rates the eager flush
    # would otherwise shatter batches to single requests
    eager_idle_flush: bool = True
    # multi-tenant QoS (sched/tenant.py): a TenancyConfig with
    # per-tenant weights, quotas, and rate limits. None = one
    # unlimited anonymous tenant, i.e. the old single-FIFO behavior
    tenancy: object = None
    # service-level objectives (obs/slo.py): a list of SLO
    # declarations the scheduler's burn-rate engine evaluates
    # (--slo-config). None = the default availability/latency pair
    slos: object = None
    # per-tenant device-second budgets (obs/cost.py): the
    # --tenant-budget grammar or a {tenant: TenantBudget} dict.
    # None = no budget admission
    budgets: object = None


@dataclass
class Batch:
    """One coalesced device dispatch."""

    requests: list = field(default_factory=list)
    group: str = ""
    candidate_bytes: int = 0
    jobs: int = 0
    bucket_bytes: int = 0
    bucket_jobs: int = 0

    @property
    def occupancy(self) -> float:
        if self.bucket_bytes:
            return self.candidate_bytes / self.bucket_bytes
        if self.bucket_jobs:
            return self.jobs / self.bucket_jobs
        return 1.0


class Coalescer:
    """Thread-safe pending set; the device executor drains it."""

    def __init__(self, config: SchedConfig):
        self.config = config
        self._lock = threading.Lock()
        self._pending: dict = {}     # group → [ScanRequest]
        self._oldest: dict = {}      # group → arrival monotonic

    def add(self, req: ScanRequest) -> None:
        with self._lock:
            group = req.work.group or req.group
            self._pending.setdefault(group, []).append(req)
            self._oldest.setdefault(group, time.monotonic())

    def pending(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    def _volume(self, reqs: list) -> tuple:
        return (sum(r.work.candidate_bytes for r in reqs),
                sum(len(r.work.jobs) for r in reqs))

    def ready_group(self, upstream_idle: bool) -> Optional[str]:
        """Group that should flush now, or None. Size-or-timeout:
        budget reached, oldest wait over, or upstream drained."""
        cfg = self.config
        now = time.monotonic()
        with self._lock:
            for group, reqs in self._pending.items():
                if not reqs:
                    continue
                nbytes, njobs = self._volume(reqs)
                if (nbytes >= cfg.max_batch_bytes
                        or njobs >= cfg.max_batch_jobs
                        or len(reqs) >= cfg.max_batch_items
                        or now - self._oldest[group]
                        >= cfg.flush_timeout_s
                        or (upstream_idle
                            and cfg.eager_idle_flush)):
                    return group
        return None

    def take(self, group: str) -> Optional[Batch]:
        """Pop up to the flush budget from ``group`` (FIFO) and book
        its padding bucket."""
        cfg = self.config
        with self._lock:
            reqs = self._pending.get(group)
            if not reqs:
                return None
            batch = Batch(group=group)
            while reqs and len(batch.requests) < cfg.max_batch_items:
                r = reqs[0]
                rb = r.work.candidate_bytes
                rj = len(r.work.jobs)
                if batch.requests and (
                        batch.candidate_bytes + rb
                        > cfg.max_batch_bytes
                        or batch.jobs + rj > cfg.max_batch_jobs):
                    break
                reqs.pop(0)
                batch.requests.append(r)
                batch.candidate_bytes += rb
                batch.jobs += rj
            if reqs:
                self._oldest[group] = time.monotonic()
            else:
                del self._pending[group]
                del self._oldest[group]
        if batch.candidate_bytes:
            batch.bucket_bytes = _bucket_for(batch.candidate_bytes,
                                             cfg.byte_buckets)
        if batch.jobs:
            batch.bucket_jobs = _bucket_for(batch.jobs,
                                            cfg.job_buckets)
        return batch

    def drain(self) -> list:
        """All pending requests (shutdown path)."""
        with self._lock:
            out = [r for reqs in self._pending.values()
                   for r in reqs]
            self._pending.clear()
            self._oldest.clear()
        return out
