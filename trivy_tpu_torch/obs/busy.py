"""Busy spans: the spans the timeline counts as the device computing
(``dfa_scan``, ``device_compute``), stamped where the work runs.

A span of work that runs on a card cannot be a host bracket: a launch
returns as soon as the work is enqueued, so a bracket around it
measures microseconds and the timeline would charge the kernel's time
to ``dispatch_gap``; a ``synchronize()`` inside the bracket would
serialise the dispatch ring and the side-stream waves. So a
:class:`BusySpan` is opened at the launch (a child of the span that is
active there, or of one the caller names), takes a stamp before and
after each piece of its work with :meth:`BusySpan.mark` — a CUDA event
recorded on the stream the work runs on, or the host's monotonic clock
for work that ran inline on the CPU — and is closed with
:meth:`BusySpan.close` on the collect side, after the host has waited
for that work. Several pieces (one per shard) close as one span from
the earliest start to the latest end.

CUDA event times become the tracer's ``time.monotonic`` clock through
an anchor taken at the close: an event recorded on a private idle
stream of the card and waited for, with the monotonic clock read on
either side. Every stamp of the span completed before it, so each one
is ``anchor - elapsed(stamp, anchor)``; the error is the anchor's own
record-to-wake time, microseconds, and there is no drift between the
card's clock and the host's to correct for.

A span stamped by CUDA events carries ``clock="cuda_event"``. A span
that is not recorded (no active span, a disabled tracer) records no
events at all.
"""

from __future__ import annotations

import threading
import time

from .trace import NOOP_SPAN, current_span

_ANCHOR_STREAMS: dict = {}
_ANCHOR_LOCK = threading.Lock()


def _anchor_stream(device):
    import torch
    with _ANCHOR_LOCK:
        stream = _ANCHOR_STREAMS.get(device)
        if stream is None:
            stream = _ANCHOR_STREAMS[device] = torch.cuda.Stream(
                device=device)
    return stream


def _anchor(device) -> tuple:
    """(event, monotonic seconds at which it ran) on ``device``."""
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    stream = _anchor_stream(device)
    t0 = time.monotonic()
    ev.record(stream)
    ev.synchronize()
    t1 = time.monotonic()
    return ev, (t0 + t1) / 2.0


class BusySpan:
    """One busy span in flight: stamped by :meth:`mark` around each
    piece of work, closed by :meth:`close` after the work was waited
    for. The span itself is opened at the launch (:func:`open_busy`)
    or, where the reference opens it at the join, handed to
    :meth:`close` (:func:`pending_busy`)."""

    __slots__ = ("span", "marks", "recording")

    def __init__(self, span=None, recording: bool = False):
        self.span = span
        self.recording = recording
        # [(torch.device or None, CUDA event or monotonic seconds)]
        self.marks: list = []

    def mark(self, device=None) -> None:
        """Stamp the start or the end of one piece of work: on a card
        a timing event on ``device``'s current stream (the stream the
        work is enqueued on), else the host clock."""
        if not self.recording:
            return
        if device is not None and device.type == "cuda":
            import torch
            if device.index is None:
                device = torch.device("cuda",
                                      torch.cuda.current_device())
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            self.marks.append((device, ev))
        else:
            self.marks.append((None, time.monotonic()))

    def close(self, span=None, status=None) -> None:
        """End ``span`` (default: the span opened at the launch) at the
        stamps. Call it only after every piece marked has completed
        (its stream's event waited for). Without a complete pair of
        stamps the span ends now."""
        span = self.span if span is None else span
        marks, self.marks = self.marks, []
        if span is None or span.noop:
            return
        if len(marks) < 2:
            span.end(status)
            return
        anchors: dict = {}
        stamps = []
        for device, m in marks:
            if device is None:
                stamps.append(m)
                continue
            if device not in anchors:
                anchors[device] = _anchor(device)
            ev, at = anchors[device]
            stamps.append(at - m.elapsed_time(ev) / 1e3)
        if anchors:
            # what the stamps are, for a reader of the trace: the
            # card's own clock, not a host bracket
            span.set("clock", "cuda_event")
        span.end_at(min(stamps[0::2]), max(stamps[1::2]), status)

    def abort(self, span=None) -> None:
        """End ``span`` (default: the span opened at the launch) now,
        with status ``error``: the wait for its work raised, so its
        stamps may never complete and are dropped."""
        span = self.span if span is None else span
        self.marks = []
        if span is not None and not span.noop:
            span.end("error")


def child_span(name: str, parent=None, **attrs):
    """A child of ``parent`` (the span active on this thread when
    None), not activated; the no-op span without one."""
    if parent is None:
        parent = current_span()
    if parent is None or parent.noop:
        return NOOP_SPAN
    return parent.tracer.child(parent, name, **attrs)


def open_busy(name: str, parent=None, **attrs) -> BusySpan:
    """A :class:`BusySpan` whose span ``name`` opens now, a child of
    ``parent`` (the span active on this thread when None); it records
    nothing without one."""
    span = child_span(name, parent, **attrs)
    return BusySpan(span, recording=not span.noop)


def pending_busy() -> BusySpan:
    """A :class:`BusySpan` that stamps now, when a span is active on
    this thread, and gets its span at :meth:`BusySpan.close`."""
    parent = current_span()
    return BusySpan(None, recording=parent is not None
                    and not parent.noop)
