"""Scheduler metrics: queue depth, batch occupancy, padding waste,
host/device overlap, per-phase latency histograms (reference:
``trivy_tpu/sched/metrics.py``).

Everything here is lock-protected counters — cheap enough to update
on every request — snapshotted into one JSON-able dict that both the
server's ``/metrics`` endpoint and the ``--sched-stats`` CLI dump
serve verbatim.

The overlap ratio is measured, not inferred: the device executor
brackets every kernel batch with ``device_begin``/``device_end`` and
every host worker brackets its work with ``host_begin``/``host_end``;
an accumulator integrates the wall-clock during which the device was
busy AND at least one host worker was busy. ``overlap_ratio =
that / device_busy`` — 0 means the strict host→device ladder, 1
means the device never waited alone.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left


def build_info(backend: str = "", sched: str = "") -> dict:
    """The build-info identity labels (value-1 info gauge on
    /metrics, mirrored into the /healthz JSON): enough for a fleet
    scrape to tell replica versions apart mid-rolling-deploy. The
    port reports torch's version and the CUDA version torch was built
    with (``torch.version.cuda``; empty on a CPU-only build) where
    the reference reports jax's; both are read lazily and tolerated
    missing — metrics must render on a box with no accelerator stack
    at all."""
    from .. import __version__
    try:
        import torch
        torch_version = str(getattr(torch, "__version__", ""))
        cuda_version = str(getattr(torch.version, "cuda", "") or "")
    except Exception:   # noqa: BLE001 — any import-time failure
        torch_version = cuda_version = ""
    return {"version": __version__,
            "torch_version": torch_version,
            "cuda_version": cuda_version,
            "backend": str(backend or ""),
            "sched": str(sched or "")}


class LatencyHistogram:
    """Fixed-bound latency histogram (seconds) with quantile
    estimates by linear interpolation inside the winning bucket.

    Bucket search is a bisect over ``BOUNDS`` (O(log n), not the
    linear scan the observe hot path used to pay), and the ladder
    starts at 100µs/250µs/500µs so device-phase latencies spread
    over real buckets instead of collapsing into the first one."""

    BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
              0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
              30.0, 60.0)

    def __init__(self):
        self.counts = [0] * (len(self.BOUNDS) + 1)
        self.total = 0
        self.sum = 0.0
        self.max = 0.0
        # bucket index -> (exemplar id, value, unix seconds): the
        # most recent trace id observed into each bucket, attached
        # as an OpenMetrics exemplar so a slow-bucket scrape links
        # straight to a representative trace (obs/prom.py renders
        # them only on the openmetrics content type)
        self.exemplars: dict = {}

    def observe(self, v: float, exemplar: str = "") -> None:
        # bisect_left finds the first bound >= v, i.e. the same
        # bucket the old `v <= b` scan chose; values past the last
        # bound land in the overflow slot
        i = bisect_left(self.BOUNDS, v)
        self.counts[i] += 1
        self.total += 1
        self.sum += v
        if v > self.max:
            self.max = v
        if exemplar:
            self.exemplars[i] = (exemplar, v, time.time())

    def quantile(self, q: float) -> float:
        if not self.total:
            return 0.0
        target = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c:
                lo = self.BOUNDS[i - 1] if i else 0.0
                hi = self.BOUNDS[i] if i < len(self.BOUNDS) \
                    else self.max
                frac = (target - seen) / c
                return lo + (hi - lo) * min(1.0, frac)
            seen += c
        return self.max

    def to_dict(self) -> dict:
        mean = self.sum / self.total if self.total else 0.0
        return {
            "count": self.total,
            "mean_s": round(mean, 6),
            "p50_s": round(self.quantile(0.50), 6),
            "p90_s": round(self.quantile(0.90), 6),
            "p99_s": round(self.quantile(0.99), 6),
            "max_s": round(self.max, 6),
        }

    def raw(self) -> dict:
        """The exposition shape (obs/prom.py): raw bucket counts
        plus the per-bucket exemplars."""
        return {"bounds": list(self.BOUNDS),
                "counts": list(self.counts),
                "sum": self.sum, "count": self.total,
                "exemplars": dict(self.exemplars)}


class SchedMetrics:
    """One instance per scheduler; every method is thread-safe."""

    PHASES = ("queue_wait", "analyze", "device", "finish", "request")

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {
            "submitted": 0, "completed": 0, "failed": 0,
            "rejected": 0, "rate_limited": 0, "timed_out": 0,
            "cancelled": 0, "batches": 0,
        }
        self.hist = {p: LatencyHistogram() for p in self.PHASES}
        # coalescer accounting
        self._batch_items = 0
        self._batch_bytes = 0
        self._batch_jobs = 0
        self._bucket_bytes = 0        # padded byte capacity booked
        self._bucket_jobs = 0
        # overlap accounting: device_active is a COUNTER — the
        # async slot runtime keeps several dispatches in flight, and
        # device busy wall is the union of their windows, not the
        # (double-counting) sum
        self._host_active = 0
        self._device_active = 0
        self._device_since = None
        self._host_busy_s = 0.0
        self._device_busy_s = 0.0
        # per-dispatch device-time INTEGRAL (sum of every dispatch
        # window's wall, overlaps double-counted): the measured side
        # of the cost-attribution balance identity — the ledger
        # attributes each dispatch's wall across its requests, so
        # attributed totals must equal this integral, not the union
        # busy wall (obs/cost.py)
        self._device_time_s = 0.0
        self._overlap_s = 0.0
        self._both_since = None
        self._depth_fn = None         # live queue-depth gauge
        self._depth_max = 0
        self._started = time.monotonic()

    # --- counters / histograms ---

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            # lint: disable=unbounded-label-cardinality -- counter
            # names are code-literal call sites (batch_bisects,
            # quarantined, ...), never request-derived strings
            self.counters[name] = self.counters.get(name, 0) + n

    def observe(self, phase: str, seconds: float,
                trace_id: str = "") -> None:
        with self._lock:
            self.hist[phase].observe(seconds, exemplar=trace_id)

    def in_flight(self) -> int:
        """Admitted but unresolved requests (drain watches this)."""
        with self._lock:
            c = self.counters
            resolved = (c["completed"] + c["failed"] +
                        c["timed_out"] + c["cancelled"])
            return max(0, c["submitted"] - resolved)

    def set_depth_gauge(self, fn) -> None:
        self._depth_fn = fn

    def note_depth(self, depth: int) -> None:
        with self._lock:
            if depth > self._depth_max:
                self._depth_max = depth

    # --- coalescer accounting ---

    def note_batch(self, items: int, cand_bytes: int, jobs: int,
                   bucket_bytes: int, bucket_jobs: int) -> None:
        with self._lock:
            self.counters["batches"] += 1
            self._batch_items += items
            self._batch_bytes += cand_bytes
            self._batch_jobs += jobs
            self._bucket_bytes += bucket_bytes
            self._bucket_jobs += bucket_jobs

    # --- overlap accounting ---

    def _update_both(self, now: float) -> None:
        both = self._device_active > 0 and self._host_active > 0
        if both and self._both_since is None:
            self._both_since = now
        elif not both and self._both_since is not None:
            self._overlap_s += now - self._both_since
            self._both_since = None

    def host_begin(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._host_active += 1
            self._update_both(now)
        return now

    def host_end(self, t0: float) -> None:
        now = time.monotonic()
        with self._lock:
            self._host_active -= 1
            self._host_busy_s += now - t0
            self._update_both(now)

    def device_begin(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._device_active += 1
            if self._device_active == 1:
                self._device_since = now
            self._update_both(now)
        return now

    def device_end(self, t0: float) -> float:
        now = time.monotonic()
        with self._lock:
            self._device_active -= 1
            self._device_time_s += now - t0
            if self._device_active == 0 and \
                    self._device_since is not None:
                # union accounting: busy wall accrues only when the
                # LAST overlapping dispatch window closes
                self._device_busy_s += now - self._device_since
                self._device_since = None
            self._update_both(now)
        # this dispatch's own wall — the executor attributes it
        # across the batch's requests (obs/cost.py)
        return now - t0

    def device_time_s(self) -> float:
        """The per-dispatch device-time integral so far."""
        with self._lock:
            return self._device_time_s

    # --- snapshot ---

    def hist_snapshot(self) -> dict:
        """Raw bucket counts per phase for Prometheus exposition
        (the reference's obs/prom.py) — the JSON snapshot only carries the
        derived quantiles."""
        with self._lock:
            return {p: h.raw() for p, h in self.hist.items()}

    def snapshot(self) -> dict:
        # the live queue-depth gauge is called OUTSIDE self._lock:
        # it takes the scheduler queue's lock, so calling it under
        # the (non-reentrant) metrics lock imposes a metrics→queue
        # lock order on every gauge implementation — and deadlocks
        # outright on a gauge that consults the metrics
        depth_fn = self._depth_fn
        depth = depth_fn() if depth_fn else 0
        with self._lock:
            now = time.monotonic()
            overlap = self._overlap_s
            if self._both_since is not None:
                overlap += now - self._both_since
            batches = self.counters["batches"]
            occupancy = (
                self._batch_bytes / self._bucket_bytes
                if self._bucket_bytes else
                (self._batch_jobs / self._bucket_jobs
                 if self._bucket_jobs else 0.0))
            padding_waste = 1.0 - occupancy if batches else 0.0
            out = {
                "counters": dict(self.counters),
                "queue_depth": depth,
                "queue_depth_max": self._depth_max,
                "batch": {
                    "count": batches,
                    "items_total": self._batch_items,
                    "mean_items": round(
                        self._batch_items / batches, 2)
                    if batches else 0.0,
                    "candidate_bytes": self._batch_bytes,
                    "interval_jobs": self._batch_jobs,
                    "bucket_bytes": self._bucket_bytes,
                    "bucket_jobs": self._bucket_jobs,
                    "occupancy": round(occupancy, 4),
                    "padding_waste": round(padding_waste, 4),
                },
                "host_busy_s": round(self._host_busy_s, 4),
                "device_busy_s": round(self._device_busy_s, 4),
                "device_time_s": round(self._device_time_s, 6),
                "overlap_s": round(overlap, 4),
                "overlap_ratio": round(
                    overlap / self._device_busy_s, 4)
                if self._device_busy_s else 0.0,
                "uptime_s": round(now - self._started, 2),
                "latency": {p: h.to_dict()
                            for p, h in self.hist.items()},
            }
        # dispatch-ring accounting (runtime/ring.py): current/max
        # dispatch depth, slot occupancy, and the overlap ratio the
        # async runtime buys — process-wide like the guard totals,
        # so sched-off direct scans report it too
        from ..runtime.ring import RING_METRICS
        out["dispatch"] = RING_METRICS.snapshot()
        # ingest-guard counters (guard/budget.py): process-wide by
        # design — budgets are per-target and short-lived, the trip
        # totals are what an operator watches on /metrics
        from ..guard.budget import GUARD_METRICS
        out["guard"] = GUARD_METRICS.snapshot()
        # dispatch-path counters (detect/metrics.py): job dedup,
        # constraint/purl cache hit rates, resident-DB upload
        # amortization — process-wide, like the guard totals
        from ..detect.metrics import DETECT_METRICS
        out["detect"] = DETECT_METRICS.snapshot()
        # secret-sieve counters (secret/metrics.py): selectivity,
        # verify tail, on-device vs host-verified file counts, DFA
        # table upload amortization
        from ..secret.metrics import SECRET_METRICS
        out["secret"] = SECRET_METRICS.snapshot()
        # device-residency accounting: live bytes + generation per
        # (table, placement) — advisory DB and DFA table alike
        from ..db.compiled import resident_snapshot
        out["resident"] = resident_snapshot()
        # findings-memo counters (memo/metrics.py): hit/miss/store/
        # invalidation totals plus the delta re-match accounting —
        # process-wide like the rest
        from ..memo.metrics import MEMO_METRICS
        out["memo"] = MEMO_METRICS.snapshot()
        # watch/admission counters (docs/serving.md "Continuous
        # scanning") — process-wide like the rest
        from ..watch.metrics import WATCH_METRICS
        out["watch"] = WATCH_METRICS.snapshot()
        return out
