"""The watch loop (copied from ``trivy_tpu/watch/loop.py``): registry
push events → debounced, deduped,
bounded-in-flight scan submissions (docs/serving.md "Continuous
scanning & admission control").

One loop serves any :mod:`watch.source`; scans ride the SAME
continuous-batching scheduler as RPC and CLI traffic
(``BatchScanRunner.submit_path``), with per-source tenant identity
and priority — so the tenancy QoS layer, the SLO engine, and the
findings memo all apply to watch traffic for free.

Event accounting invariant (storm-drain test-enforced): every valid
event entering the loop ends in EXACTLY ONE of

* ``scans`` — it triggered a scan submission (which may later
  complete or fail; that is scan accounting, not event accounting);
* ``deduped`` — it was folded into a pending or in-flight scan of
  the same digest (a tag repushed 5x in a burst scans once);
* ``shed`` — admission rejected it (429/503 after bounded backoff
  honoring Retry-After) or no resolver could map it to a target.

Backpressure flows in layers: the scheduler's bounded queue sheds
via the existing typed 429/503 errors; the loop's in-flight
watermarks stop PULLING the source before that point, so a webhook
source buffers (bounded) and a paced source simply falls behind —
the loop itself never crashes and never grows unbounded state.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from ..sched import QueueFullError, RateLimitedError
from ..utils.backoff import full_jitter_delay
from .metrics import WATCH_METRICS
from .source import Cursor

log = logging.getLogger("trivy_tpu_torch.watch.loop")


@dataclass
class WatchConfig:
    """Loop tuning knobs (CLI: ``trivy-tpu watch``)."""

    # debounce window: a scan fires this long after the FIRST event
    # of a burst, folding every same-digest event that lands inside
    # the window into one submission. 0 = submit immediately (dedupe
    # still folds into in-flight scans).
    debounce_s: float = 0.25
    # in-flight watermarks: stop pulling the source at ``high``
    # outstanding scans, resume at ``low`` (0 = high // 2)
    max_inflight: int = 32
    resume_inflight: int = 0
    # bounded submit retries before an event sheds (backoff honors
    # RateLimitedError.retry_after_s, full jitter otherwise — the
    # shared utils/backoff.py policy)
    submit_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    # source-failure backoff (reconnect/retry)
    source_backoff_max_s: float = 5.0
    # per-source identity threaded into every submission
    tenant: str = "watch"
    priority: int = 0
    checkpoint_path: str = ""
    # keep the latest BatchScanResult per digest (tests use it
    # for the byte-identity gate; servers leave it off)
    keep_results: bool = False

    @property
    def low_watermark(self) -> int:
        return self.resume_inflight or max(1, self.max_inflight // 2)


class _Group:
    """One pending-or-in-flight scan and the events it covers."""

    __slots__ = ("digest", "events", "first_ts", "req")

    def __init__(self, event):
        self.digest = event.digest
        self.events = [event]
        self.first_ts = event.ts
        self.req = None


class WatchLoop:
    """Single-threaded event pump: call :meth:`run` (blocking) or
    drive :meth:`step` yourself (tests). All counters mirror into
    the process-wide :data:`WATCH_METRICS`."""

    def __init__(self, runner, source, config=None, options=None):
        from ..types import ScanOptions
        self.runner = runner
        self.source = source
        self.config = config or WatchConfig()
        self.options = options or ScanOptions(
            backend=getattr(runner, "backend", "cuda"))
        self.cursor = Cursor(self.config.checkpoint_path)
        if self.cursor.position >= 0:
            source.resume_from(self.cursor.position)
        self.counters = {k: 0 for k in (
            "events", "deduped", "scans", "shed", "completed",
            "failed", "source_errors", "unresolvable")}
        self.results: dict = {}        # digest -> BatchScanResult
        self._pending: dict = {}       # digest -> _Group (debouncing)
        self._inflight: dict = {}      # digest -> _Group (submitted)
        self._paused = False           # watermark state
        self._source_attempt = 0
        self.inflight_peak = 0
        self._closed = False

    # --- counters ---

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n
        WATCH_METRICS.inc(name, n)

    def stats(self) -> dict:
        return dict(self.counters,
                    pending=len(self._pending),
                    inflight=len(self._inflight),
                    inflight_peak=self.inflight_peak,
                    cursor=self.cursor.position)

    # --- event disposition ---

    def _ack_group(self, group: _Group) -> None:
        for ev in group.events:
            if ev.seq >= 0:
                self.cursor.ack(ev.seq)

    def _reap(self) -> None:
        """Harvest completed scans without blocking — the loop stays
        responsive to arrivals while results trickle in."""
        for seq in self.source.take_dropped():
            # events the source discarded before delivery (webhook
            # overflow): ack so the cursor's contiguous high-water
            # mark can pass the hole — they're counted in the
            # source's ``dropped``, not in the loop books
            self.cursor.ack(seq)
        now = time.monotonic()
        for digest in [d for d, g in self._inflight.items()
                       if g.req.done]:
            group = self._inflight.pop(digest)
            try:
                result = group.req.result(timeout=0)
                failed = bool(getattr(result, "error", ""))
            except Exception as e:      # noqa: BLE001 — deadline,
                # shutdown, or a scan error: the slot failed, the
                # loop carries on
                result, failed = None, True
                log.warning("watch scan %r failed: %r",
                            group.digest, e)
            self._count("failed" if failed else "completed")
            if result is not None and self.config.keep_results:
                self.results[digest] = result
            for ev in group.events:
                WATCH_METRICS.observe(
                    "watch_lag", max(0.0, now - ev.ts),
                    trace_id=getattr(group.req, "trace_id", "")
                    or "")
            self._ack_group(group)
        n = len(self._inflight)
        if n > self.inflight_peak:
            self.inflight_peak = n
        if self._paused and n <= self.config.low_watermark:
            self._paused = False

    def _submit(self, group: _Group) -> None:
        """Submit one debounced group; bounded retries, then shed."""
        cfg = self.config
        ev = group.events[0]
        if not ev.path:
            self._count("unresolvable")
            self._shed(group)
            return
        # propagated trace context: a traceparent on the source
        # event roots this scan under the submitter's span (fleet
        # plane); garbage parses to the empty context, i.e. a fresh
        # local trace — exactly the no-propagation behavior
        from ..obs.propagate import EMPTY_CONTEXT, parse_traceparent
        ctx = parse_traceparent(getattr(ev, "traceparent", "")) \
            or EMPTY_CONTEXT
        attempts = max(1, cfg.submit_retries)
        for attempt in range(attempts):
            retry = attempt + 1 < attempts
            try:
                group.req = self.runner.submit_path(
                    ev.path, self.options,
                    tenant=ev.tenant or cfg.tenant,
                    priority=ev.priority or cfg.priority,
                    trace_id=ctx.trace_id,
                    parent_span_id=ctx.parent_span_id)
                break
            except RateLimitedError as e:
                # no sleep after the FINAL attempt: the pump is
                # single-threaded, and a backoff nothing will retry
                # only stalls reaping and intake under overload
                if retry:
                    time.sleep(min(max(e.retry_after_s, 0.001),
                                   cfg.backoff_max_s))
            except QueueFullError:
                if retry:
                    time.sleep(full_jitter_delay(
                        attempt, cfg.backoff_base_s,
                        cfg.backoff_max_s))
            except Exception as e:   # noqa: BLE001 — scheduler
                # closed/draining mid-loop: shed, keep the loop alive
                log.warning("watch submit %r failed: %r",
                            group.digest, e)
                break
        if group.req is None:
            self._shed(group)
            return
        self._count("scans")
        self._count("deduped", len(group.events) - 1)
        self._inflight[group.digest] = group
        n = len(self._inflight)
        if n > self.inflight_peak:
            self.inflight_peak = n
        if n >= self.config.max_inflight:
            self._paused = True

    def _shed(self, group: _Group) -> None:
        """Admission (or resolution) rejected the group: the trigger
        event sheds, its folded followers stay deduped — books
        balance either way, and the cursor still advances (a shed
        event is accounted, not forgotten)."""
        self._count("shed")
        self._count("deduped", len(group.events) - 1)
        self._ack_group(group)

    def _flush_due(self, force: bool = False) -> None:
        now = time.monotonic()
        for digest in list(self._pending):
            group = self._pending[digest]
            if force or now - group.first_ts >= \
                    self.config.debounce_s:
                if not force and \
                        len(self._inflight) >= \
                        self.config.max_inflight:
                    return           # watermark: hold the group
                del self._pending[digest]
                self._submit(group)

    def _admit(self, event) -> None:
        self._count("events")
        group = self._pending.get(event.digest)
        if group is not None:
            group.events.append(event)
            return                   # disposition resolves with group
        inflight = self._inflight.get(event.digest)
        if inflight is not None:
            # same digest, same content: the running scan covers it
            self._count("deduped")
            inflight.events.append(event)
            return
        group = _Group(event)
        if self.config.debounce_s <= 0:
            self._submit(group)
        else:
            self._pending[event.digest] = group

    # --- the pump ---

    def step(self, timeout: float = 0.05) -> bool:
        """One iteration: reap, flush due groups, maybe pull one
        event. Returns False once the source is exhausted AND
        nothing is pending or in flight."""
        self._reap()
        self._flush_due()
        if self.source.exhausted and not self._pending:
            if not self._inflight:
                return False
            time.sleep(min(timeout, 0.02))
            return True
        if self._paused:
            time.sleep(min(timeout, 0.02))
            return True
        try:
            event = self.source.get(timeout)
            self._source_attempt = 0
        except Exception as e:       # noqa: BLE001 — transport
            # hiccup: reconnect/retry with the shared backoff policy,
            # never crash the loop
            self._count("source_errors")
            delay = full_jitter_delay(
                self._source_attempt, 0.05,
                self.config.source_backoff_max_s)
            self._source_attempt += 1
            log.warning("watch source error (retry in %.2fs): %r",
                        delay, e)
            time.sleep(delay)
            return True
        if event is not None:
            self._admit(event)
        elif self._pending or self._inflight:
            # no arrival this tick but work is debouncing or in
            # flight: don't spin on sources whose get() returns
            # immediately (trace replay after exhaustion)
            time.sleep(min(timeout, 0.01))
        return True

    def run(self, max_wall_s: float = 0.0) -> dict:
        """Pump until the source exhausts (or ``max_wall_s``
        elapses), then drain. Returns the final counters."""
        deadline = time.monotonic() + max_wall_s if max_wall_s \
            else None
        while not self._closed and self.step():
            if deadline is not None and \
                    time.monotonic() >= deadline:
                break
        return self.drain()

    def drain(self, timeout_s: float = 120.0) -> dict:
        """Flush every pending group, wait out in-flight scans,
        checkpoint, and return the counters."""
        self._flush_due(force=True)
        deadline = time.monotonic() + timeout_s
        while self._inflight and time.monotonic() < deadline:
            self._reap()
            if self._inflight:
                time.sleep(0.01)
        self._reap()
        self.cursor.save()
        return self.stats()

    def close(self) -> None:
        self._closed = True
