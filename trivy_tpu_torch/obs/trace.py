"""Zero-dependency per-request tracing (reference:
``trivy_tpu/obs/trace.py``).

Dapper-style spans over the scan pipeline: every admitted request
gets a root ``scan`` span whose children bracket the stages it moved
through — ``queue_wait`` → ``analyze`` (host) → ``coalesce`` (with
batch id, padding bucket and occupancy) → ``device`` (one span per
dispatch attempt, so bisect retries and quarantine probes are
visible as siblings) → ``host_fallback`` (quarantine only) →
``report``. Fault injections, guard-budget trips and breaker
degradations land as span EVENTS on whatever span is active.

Identifiers follow the W3C/OTel shape (hex trace/span ids) but the
wire format is the Chrome trace-event JSON Perfetto loads directly
(``to_chrome``): complete spans become ``"ph": "X"`` duration events
keyed by the thread that ran them, span events become ``"ph": "i"``
instants.

A :class:`Tracer` is one tracing domain. The module-level default
(:func:`get_tracer`) is what the scheduler and the batch runner share
unless a caller injects its own; disabling a tracer
(``Tracer(enabled=False)``) turns every ``start_span`` into a shared
no-op span, the arm that tracing overhead is measured against.

Deep seams (segment packing, uploads, the sieve, the interval waves,
the ring's slot waits, the memo, guard trips) record through
:func:`phase_span` and :func:`add_event` on whatever span is active on
their thread, and the thread hops of the async runtime carry a span
along with :func:`activate_or_null`. A span of work that ran on the
card is stamped where the work ran (``obs/busy.py``: CUDA events) and
closed later with :meth:`Span.end_at`.

Everything here is import-light on purpose: no trivy_tpu_torch
imports at module scope, so the flight recorder's log handler and the
guard and memo seams can reach :func:`current_span` and
:func:`add_event` without cycles.
"""

from __future__ import annotations

import contextvars
import os
import re
import threading
import time

_ID_RE = re.compile(r"[0-9a-f]{8,64}")

# spans per trace / concurrently open traces are bounded so a request
# source that never completes (or a hostile trace_id storm) cannot
# grow the tracer without limit
MAX_SPANS_PER_TRACE = 4096
MAX_OPEN_TRACES = 1024
# distinct span NAMES tracked as /metrics histograms: each name is a
# label value on trivy_tpu_trace_span_seconds, so a hostile or buggy
# caller minting names must fold into "other" instead of growing the
# exposition without bound (same policy sched/tenant.py applies to
# tenant labels)
MAX_PHASE_NAMES = 64


def new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def _clean_trace_id(trace_id) -> str:
    """Externally supplied trace ids (RPC bodies) are only honored in
    the canonical lowercase-hex shape — anything else gets a fresh id
    (the id is later used as a flight-recorder file name, so this is
    a security boundary, not just hygiene). fullmatch, not match: $
    would admit a trailing newline into the file name."""
    trace_id = (trace_id or "").lower()
    return trace_id if _ID_RE.fullmatch(trace_id) else ""


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "trivy_tpu_torch_active_span", default=None)


def current_span():
    """The span active on this thread/context, or None."""
    return _ACTIVE.get()


def add_event(name: str, **attrs) -> None:
    """Record an event on the active span; no-op without one. The
    guard budgets and the memo store call this — they never need a
    tracer handle."""
    span = _ACTIVE.get()
    if span is not None:
        span.event(name, **attrs)


class _PhaseSpanCtx:
    """Context manager behind :func:`phase_span`: opens a child of
    the active span (activated, so nested phases chain), ends it on
    exit — with status "error" when the body raised."""

    __slots__ = ("name", "attrs", "span", "_token")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.span = NOOP_SPAN
        self._token = None

    def __enter__(self):
        parent = _ACTIVE.get()
        if parent is not None and not parent.noop:
            self.span = parent.tracer.child(parent, self.name,
                                            **self.attrs)
            self._token = _ACTIVE.set(self.span)
        return self.span

    def __exit__(self, exc_type, *exc):
        if self._token is not None:
            _ACTIVE.reset(self._token)
        self.span.end("error" if exc_type is not None else None)


def phase_span(name: str, **attrs) -> _PhaseSpanCtx:
    """``with phase_span("pack"):`` — bracket a pipeline phase as a
    child of whatever span is active on this thread, or do nothing
    when none is. This is how deep seams (segment packing, H2D
    uploads, resident-table staging) show up in Perfetto without
    threading a tracer handle through every call chain."""
    return _PhaseSpanCtx(name, attrs)


def activate_or_null(span):
    """``with activate_or_null(sp):`` — activate ``span`` on this
    thread, or do nothing when there is none. The async slot
    runtime hops threads (host-pool packers, the ring's drain) and
    carries the launching batch's span along this way."""
    import contextlib
    return span.activate() if span is not None \
        else contextlib.nullcontext()


class _SpanContext:
    __slots__ = ("span", "_token")

    def __init__(self, span):
        self.span = span
        self._token = None

    def __enter__(self):
        self._token = _ACTIVE.set(self.span)
        return self.span

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)


class Span:
    """One timed operation: wall-anchored start, monotonic duration,
    typed attributes, instant events. ``end`` is idempotent and
    hands the finished span to its tracer."""

    noop = False
    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "start_wall", "start_mono", "end_mono", "attrs",
                 "events", "status", "tid", "is_root")

    def __init__(self, tracer, name: str, trace_id: str,
                 parent_id=None, attrs=None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        # a propagated (remote) parent makes a LOCAL root whose
        # parent_id points into another process's trace: is_root, not
        # parent_id, decides completion bookkeeping from here on
        self.is_root = parent_id is None
        self.name = name
        self.start_wall = time.time()
        self.start_mono = time.monotonic()
        self.end_mono = None
        self.attrs = dict(attrs) if attrs else {}
        self.events = []
        self.status = "ok"
        self.tid = threading.get_ident()

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs) -> None:
        self.events.append((time.monotonic(), name, attrs))

    def activate(self) -> _SpanContext:
        """``with span.activate():`` — publish as the thread's
        current span (log correlation + add_event routing)."""
        return _SpanContext(self)

    @property
    def duration_s(self) -> float:
        if self.end_mono is None:
            return 0.0
        return max(0.0, self.end_mono - self.start_mono)

    def end(self, status=None) -> None:
        if self.end_mono is not None:
            return
        self.end_mono = time.monotonic()
        if status and status != "ok":
            self.status = status
        self.tracer._finish(self)

    def end_at(self, start_mono: float, end_mono: float,
               status=None) -> None:
        """End the span with explicit monotonic stamps instead of
        "now": a span of work that ran on the card is opened at its
        launch, stamped where the work ran (CUDA events, converted to
        this clock) and closed after the host waited for it."""
        if self.end_mono is not None:
            return
        self.start_wall += start_mono - self.start_mono
        self.start_mono = start_mono
        self.end_mono = max(start_mono, end_mono)
        if status and status != "ok":
            self.status = status
        self.tracer._finish(self)


class _NoopSpan:
    """Shared do-nothing span returned by a disabled tracer."""

    noop = True
    trace_id = ""
    span_id = ""
    parent_id = None
    is_root = False
    name = ""
    attrs: dict = {}
    events: list = []
    status = "ok"
    start_mono = 0.0
    end_mono = 0.0
    duration_s = 0.0

    def set(self, key, value):
        pass

    def event(self, name, **attrs):
        pass

    def end(self, status=None):
        pass

    def end_at(self, start_mono, end_mono, status=None):
        pass

    def activate(self):
        return _NOOP_CTX


class _NoopCtx:
    def __enter__(self):
        return NOOP_SPAN

    def __exit__(self, *exc):
        pass


_NOOP_CTX = _NoopCtx()
NOOP_SPAN = _NoopSpan()


class Tracer:
    """One tracing domain: creates spans, collects completed traces
    into the flight recorder, optionally exports each completed
    trace as Perfetto-loadable JSON, and derives per-span-name
    latency histograms for ``/metrics``."""

    def __init__(self, enabled: bool = True, recorder=None,
                 export_dir: str = "", phase_metrics: bool = True):
        self.enabled = enabled
        self.export_dir = export_dir
        self.epoch_wall = time.time()
        self.epoch_mono = time.monotonic()
        self._lock = threading.Lock()
        self._spans: dict = {}    # open trace_id -> [finished Span]
        # propagated traces can have several concurrently-open LOCAL
        # roots on one trace_id (N scans sharing a fleet trace): the
        # bucket completes when the LAST root ends, and a bad status
        # on any earlier root still forces the dump
        self._open_roots: dict = {}   # trace_id -> open root count
        self._dirty: set = set()      # trace_ids owed a dump
        if recorder is None:
            from .recorder import FlightRecorder
            recorder = FlightRecorder()
        self.recorder = recorder
        # dumps triggered off-tracer (SLO burn-rate trips, operator
        # pokes) must land on the same timebase as _finish's dumps
        recorder.epoch_mono = self.epoch_mono
        self._phase = {} if phase_metrics else None
        self.n_spans = 0
        self.n_traces = 0
        self.n_exported = 0

    # --- span creation ---

    def start_span(self, name: str, trace_id: str = "",
                   parent=None, attrs=None, remote_parent: str = ""):
        if not self.enabled:
            return NOOP_SPAN
        if parent is not None:
            if parent.noop:
                return NOOP_SPAN
            span = Span(self, name, parent.trace_id,
                        parent_id=parent.span_id, attrs=attrs)
            req = parent.attrs.get("request")
            if req is not None and "request" not in span.attrs:
                span.attrs["request"] = req
            return span
        span = Span(self, name,
                    _clean_trace_id(trace_id) or new_trace_id())
        rp = _clean_trace_id(remote_parent)
        if rp:
            # a propagated parent from another process: this span is
            # still a LOCAL root (it owns its bucket's completion)
            # but its parent_id links it into the fleet-wide tree
            span.parent_id = rp
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            while len(self._spans) >= MAX_OPEN_TRACES:
                # drop the oldest open trace — a root that never ends
                # must not pin its children forever
                dropped = next(iter(self._spans))
                self._spans.pop(dropped)
                self._open_roots.pop(dropped, None)
                self._dirty.discard(dropped)
            self._spans.setdefault(span.trace_id, [])
            self._open_roots[span.trace_id] = \
                self._open_roots.get(span.trace_id, 0) + 1
        return span

    def start_request(self, name: str, trace_id: str = "",
                      parent_span_id: str = ""):
        """Root span for one scan request; a propagated
        ``parent_span_id`` links it under a remote caller's span."""
        root = self.start_span("scan", trace_id=trace_id,
                               remote_parent=parent_span_id)
        root.set("request", name)
        return root

    def child(self, parent, name: str, **attrs):
        if parent is None or parent.noop:
            return NOOP_SPAN
        return self.start_span(name, parent=parent,
                               attrs=attrs or None)

    # --- completion plumbing ---

    def _finish(self, span: Span) -> None:
        if self._phase is not None and not span.is_root:
            self._observe_phase(span.name, span.duration_s,
                                span.trace_id)
        with self._lock:
            self.n_spans += 1
            if not span.is_root:
                bucket = self._spans.get(span.trace_id)
                if bucket is None:
                    # finished after its root (e.g. a sweep resolved
                    # the request mid-stage): file it with the
                    # completed trace while it is still in the ring
                    self.recorder.append(span.trace_id, span)
                elif len(bucket) < MAX_SPANS_PER_TRACE:
                    bucket.append(span)
                return
            remaining = self._open_roots.get(span.trace_id, 1) - 1
            if remaining > 0:
                # sibling roots on the same propagated trace are
                # still open: file this root like a child and keep
                # the bucket until the last one ends
                self._open_roots[span.trace_id] = remaining
                bucket = self._spans.get(span.trace_id)
                if bucket is not None and \
                        len(bucket) < MAX_SPANS_PER_TRACE:
                    bucket.append(span)
                if span.status in ("degraded", "failed", "error"):
                    self._dirty.add(span.trace_id)
                return
            self._open_roots.pop(span.trace_id, None)
            spans = self._spans.pop(span.trace_id, [])
            spans.append(span)
            self.n_traces += 1
            dirty = span.trace_id in self._dirty
            self._dirty.discard(span.trace_id)
        self._complete(span, spans, dirty=dirty)

    def _observe_phase(self, name: str, dur_s: float,
                       trace_id: str = "") -> None:
        from ..sched.metrics import LatencyHistogram
        with self._lock:
            h = self._phase.get(name)
            if h is None:
                if len(self._phase) >= MAX_PHASE_NAMES:
                    # cardinality cap: overflow names fold into one
                    # shared histogram so /metrics stays bounded
                    name = "other"
                    h = self._phase.get(name)
                if h is None:
                    h = self._phase[name] = LatencyHistogram()
            h.observe(dur_s, exemplar=trace_id)

    def _complete(self, root: Span, spans: list,
                  dirty: bool = False) -> None:
        self.recorder.add(root.trace_id, spans)
        if self.export_dir:
            try:
                self._export(root.trace_id, spans)
            except OSError:
                pass
        if dirty or root.status in ("degraded", "failed", "error"):
            # degraded/failed scans dump the full trace to disk so
            # the evidence outlives the in-memory ring ("rejected"
            # backpressure answers deliberately do NOT — a 503 storm
            # must not become a disk-write storm; the recorder also
            # caps how many dump files it keeps)
            try:
                self.recorder.dump(root.trace_id, spans,
                                   epoch_mono=self.epoch_mono)
            except (OSError, ValueError):
                pass

    def _export(self, trace_id: str, spans: list) -> None:
        self.recorder.write_doc(
            os.path.join(self.export_dir, f"trace-{trace_id}.json"),
            to_chrome(spans, self.epoch_mono, self.epoch_wall))
        self.n_exported += 1

    # --- lookup / reporting ---

    def trace(self, trace_id: str):
        """Chrome trace-event document for one trace (completed, or
        the finished spans of one still in flight), or None."""
        spans = self.recorder.get(trace_id)
        if spans is None:
            with self._lock:
                open_spans = self._spans.get(trace_id)
                spans = list(open_spans) if open_spans else None
        if spans is None:
            return None
        return to_chrome(spans, self.epoch_mono, self.epoch_wall)

    def phase_snapshot(self) -> dict:
        """{span name: raw histogram} for Prometheus exposition
        (with per-bucket trace-id exemplars)."""
        with self._lock:
            return {name: h.raw()
                    for name, h in (self._phase or {}).items()}

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "spans": self.n_spans,
                    "traces": self.n_traces,
                    "open_traces": len(self._spans),
                    "exported": self.n_exported}


def to_chrome(spans: list, epoch_mono: float = 0.0,
              epoch_wall=None) -> dict:
    """Chrome trace-event JSON (Perfetto / chrome://tracing): spans
    as complete ("X") duration events, span events as instants."""
    events = []
    for s in spans:
        end = s.end_mono if s.end_mono is not None else s.start_mono
        args = {"trace_id": s.trace_id, "span_id": s.span_id,
                "status": s.status}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        args.update(s.attrs)
        tid = s.tid & 0xffff
        events.append({
            "ph": "X", "cat": "trivy_tpu", "name": s.name,
            "ts": round((s.start_mono - epoch_mono) * 1e6, 3),
            "dur": round(max(0.0, end - s.start_mono) * 1e6, 3),
            "pid": 1, "tid": tid, "args": args,
        })
        for t, name, attrs in s.events:
            events.append({
                "ph": "i", "cat": "trivy_tpu", "name": name,
                "ts": round((t - epoch_mono) * 1e6, 3),
                "s": "t", "pid": 1, "tid": tid,
                "args": dict(attrs),
            })
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if epoch_wall is not None:
        out["otherData"] = {"epoch_unix_s": round(epoch_wall, 6)}
    return out


def summarize(spans: list) -> str:
    """One-line phase breakdown: 'scan 42.1ms: queue_wait 0.2ms,
    analyze 30.0ms, device 8.1ms, report 2.3ms'."""
    root = next((s for s in spans
                 if getattr(s, "is_root", s.parent_id is None)),
                None)
    parts = [f"{s.name} {s.duration_s * 1e3:.1f}ms"
             for s in spans
             if not getattr(s, "is_root", s.parent_id is None)]
    head = (f"{root.name} {root.duration_s * 1e3:.1f}ms"
            if root is not None else "")
    if parts:
        return (head + ": " if head else "") + ", ".join(parts)
    return head


def trace_cause(tracer: Tracer, trace_id: str) -> dict:
    """FailureCause payload a degraded/failed result carries so the
    operator can pull the request's trace (served at /trace/<id>,
    dumped by the flight recorder)."""
    return {"stage": "obs", "kind": "trace",
            "message": f"trace {trace_id} captured (dump: "
                       f"{tracer.recorder.dump_path(trace_id)})"}


_TRACER = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-default tracer (created on first use, with the
    flight recorder's log ring attached to the trivy_tpu_torch
    logger)."""
    global _TRACER
    if _TRACER is None:
        candidate = Tracer()
        with _TRACER_LOCK:
            if _TRACER is None:
                _TRACER = candidate
                won = candidate
            else:
                won = None
        if won is not None:
            # the handler attach takes the recorder's and logging's
            # locks — outside _TRACER_LOCK (lint: lock-discipline).
            # A racing get_tracer() may briefly see the tracer
            # before its log ring attaches; only the first
            # microseconds of log capture can miss.
            from .recorder import attach_ring_handler
            attach_ring_handler(won.recorder)
    return _TRACER
