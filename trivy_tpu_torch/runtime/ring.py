"""Bounded dispatch ring: the double-buffered device-slot runtime
(reference: ``trivy_tpu/runtime/ring.py:51-409``).

The synchronous ladder — pack → upload → compute → collect — leaves
the device idle while the host packs the next batch and leaves the
host idle while the device computes. The ring splits every dispatch
into a LAUNCH half (pack, copy into the slot's pinned staging
buffers, upload and enqueue on a CUDA side stream, record an event;
run on the submitting thread) and a COLLECT half (wait for the
slot's event, read its pinned output, fan results out; run on the
ring's own drain thread), bounded at ``depth`` slots in flight:

* ``depth == 1`` degenerates to the synchronous ladder — submit
  blocks until the previous slot drained, so latency-sensitive
  callers never wait behind a speculative batch;
* ``depth >= 2`` is double buffering — slot N+1 launches while slot
  N computes, and the drain thread's blocking wait is where the
  device wall actually passes.

A submit that finds the ring full parks, and its wait is booked in
``RingMetrics.note_wait`` and bracketed in a ``slot_wait`` phase span
under the submitting thread's active span. Slots ALWAYS collect in FIFO
submission order — collection order is a correctness surface (secret
patches must land before dependents' merges), not a scheduling
choice. The ring itself is host-only: what a slot's launch and
collect do on the card is the caller's (``detect/batch.py``).

``RING_METRICS`` is the process-wide accounting every ring reports
into: current/high-water dispatch depth, the time-integral slot
occupancy, and the overlap ratio — share of slot-active wall during
which ≥ 2 slots were in flight.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..obs.trace import phase_span

log = logging.getLogger("trivy_tpu_torch.runtime.ring")


class RingMetrics:
    """Process-wide slot accounting; every method thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {
            "slots_launched": 0, "slots_collected": 0,
            "slot_errors": 0, "slot_waits": 0,
        }
        self._wait_s = 0.0
        self._active = 0              # slots currently in flight
        self._depth_limit = 1         # widest configured depth seen
        self._depth_max = 0           # high-water in-flight count
        self._since = None            # 0→1 transition instant
        self._overlap_since = None    # 1→2 transition instant
        self._busy_s = 0.0            # wall with >= 1 slot in flight
        self._overlap_s = 0.0         # wall with >= 2 slots in flight
        self._active_integral = 0.0   # ∫ active dt (occupancy)
        self._last_edge = None

    def note_depth_limit(self, depth: int) -> None:
        with self._lock:
            if depth > self._depth_limit:
                self._depth_limit = depth

    def note_wait(self, seconds: float) -> None:
        with self._lock:
            self.counters["slot_waits"] += 1
            self._wait_s += seconds

    def _edge(self, now: float) -> None:
        # accumulate the occupancy integral at every transition so
        # the time-weighted mean is exact, not sampled
        if self._last_edge is not None:
            self._active_integral += \
                self._active * (now - self._last_edge)
        self._last_edge = now

    def slot_begin(self) -> None:
        now = time.monotonic()
        with self._lock:
            self._edge(now)
            self.counters["slots_launched"] += 1
            self._active += 1
            if self._active > self._depth_max:
                self._depth_max = self._active
            if self._active == 1:
                self._since = now
            elif self._active == 2:
                self._overlap_since = now

    def slot_end(self, error: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            self._edge(now)
            self.counters["slots_collected"] += 1
            if error:
                self.counters["slot_errors"] += 1
            self._active -= 1
            if self._active == 1 and self._overlap_since is not None:
                self._overlap_s += now - self._overlap_since
                self._overlap_since = None
            if self._active == 0 and self._since is not None:
                self._busy_s += now - self._since
                self._since = None

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            busy = self._busy_s
            overlap = self._overlap_s
            integral = self._active_integral
            if self._last_edge is not None and self._active:
                integral += self._active * (now - self._last_edge)
            if self._since is not None:
                busy += now - self._since
            if self._overlap_since is not None:
                overlap += now - self._overlap_since
            return {
                "counters": dict(self.counters),
                "depth": self._active,
                "depth_limit": self._depth_limit,
                "depth_max": self._depth_max,
                "slot_wait_s": round(self._wait_s, 4),
                "slot_busy_s": round(busy, 4),
                "slot_overlap_s": round(overlap, 4),
                # share of in-flight wall during which >= 2 slots
                # overlapped: 0 = the strict serial ladder, → 1 =
                # the device never waited for a launch
                "dispatch_overlap_ratio": round(overlap / busy, 4)
                if busy > 0 else 0.0,
                # time-weighted mean in-flight slots over the
                # in-flight wall, normalized by the configured
                # depth: 1.0 = the ring is always as full as allowed
                "slot_occupancy": round(
                    integral / (busy * self._depth_limit), 4)
                if busy > 0 and self._depth_limit else 0.0,
            }


RING_METRICS = RingMetrics()


class TeeRingMetrics:
    """Fan one ring's accounting into several sinks — a per-scan
    RingMetrics (exact numbers for THIS scan's stats, immune to
    concurrent scans' rings) plus the process-wide RING_METRICS."""

    def __init__(self, *sinks: RingMetrics):
        self.sinks = sinks

    def note_depth_limit(self, depth: int) -> None:
        for s in self.sinks:
            s.note_depth_limit(depth)

    def note_wait(self, seconds: float) -> None:
        for s in self.sinks:
            s.note_wait(seconds)

    def slot_begin(self) -> None:
        for s in self.sinks:
            s.slot_begin()

    def slot_end(self, error: bool = False) -> None:
        for s in self.sinks:
            s.slot_end(error=error)


DEFAULT_DISPATCH_DEPTH = 2


def resolve_dispatch_depth(depth: int = 0) -> int:
    """One resolution rule for every entry point (runner arg,
    --dispatch-depth flag, SchedConfig): explicit positive value
    wins, 0 falls back to ``TRIVY_TPU_DISPATCH_DEPTH`` then the
    default, floor 1."""
    if not depth:
        try:
            depth = int(os.environ.get(
                "TRIVY_TPU_DISPATCH_DEPTH", "")
                or DEFAULT_DISPATCH_DEPTH)
        except ValueError:
            log.warning("bad TRIVY_TPU_DISPATCH_DEPTH ignored")
            depth = DEFAULT_DISPATCH_DEPTH
    return max(1, int(depth))


class RingClosed(RuntimeError):
    """submit() after close()."""


class Slot:
    """One in-flight dispatch: launched, awaiting its FIFO collect."""

    __slots__ = ("label", "payload", "collect", "done", "result",
                 "error")

    def __init__(self, label: str, payload, collect: Callable):
        self.label = label
        self.payload = payload
        self.collect = collect
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None):
        """Block until this slot drained; returns the collect
        result or re-raises the collect error."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"slot {self.label!r} not collected")
        if self.error is not None:
            raise self.error
        return self.result


class DispatchRing:
    """Bounded FIFO of in-flight device slots with a dedicated
    drain thread. ``submit`` blocks once ``depth`` slots are
    launched-but-uncollected; the drain thread pops the oldest slot
    and runs its collect callable."""

    def __init__(self, depth: int = 2, name: str = "ring",
                 metrics: Optional[RingMetrics] = None):
        self.depth = max(1, int(depth))
        self.name = name
        self.metrics = metrics if metrics is not None \
            else RING_METRICS
        self.metrics.note_depth_limit(self.depth)
        self._cv = threading.Condition()
        self._slots: deque = deque()      # launched, not collected
        self._collecting: Optional[Slot] = None
        self._reserved = 0                # capacity held by launches
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ---

    def _ensure_thread(self) -> None:
        # check and start under the cv: two first submits racing
        # here started two drain threads, which collected out of
        # FIFO order and overwrote each other's ``_collecting``
        with self._cv:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain_loop,
                    name=f"ring-{self.name}", daemon=True)
                self._thread.start()

    def close(self, collect: bool = True) -> None:
        """Stop accepting slots. ``collect=True`` drains every slot
        already launched (device work in flight completes); False
        abandons the queued ones with RingClosed."""
        abandoned = []
        with self._cv:
            self._closed = True
            if not collect:
                # only slots still queued are abandoned — the one
                # mid-collection (if any) finishes on the drain
                # thread, which owns its bookkeeping
                while self._slots:
                    slot = self._slots.popleft()
                    slot.error = RingClosed("ring closed")
                    abandoned.append(slot)
            self._cv.notify_all()
        for slot in abandoned:
            # waiters wake and metrics book outside the cv — the
            # metric sink takes its own lock
            slot.done.set()
            self.metrics.slot_end(error=True)
        t = self._thread
        if t is not None:
            t.join(timeout=30)

    # --- submission ---

    def submit(self, collect: Callable, payload=None,
               depth: Optional[int] = None,
               label: str = "",
               launch: Optional[Callable] = None) -> Slot:
        """Launch one slot. Without ``launch`` the caller has
        ALREADY enqueued its device work and ``payload`` carries its
        handle; with ``launch`` the ring first waits for capacity,
        then runs ``launch()`` on the calling thread to produce the
        payload — so pack/upload of slot N+1 never starts before a
        ring position frees (the bound covers staged HBM, not just
        queued bookkeeping). ``collect(payload)`` runs on the drain
        thread when the slot reaches the head of the ring.

        ``depth`` overrides the ring bound for this submit (1: this
        slot never parks behind a speculative batch)."""
        bound = self.depth if depth is None else max(1, int(depth))
        waited_s = 0.0
        try:
            with self._cv:
                if self._closed:
                    raise RingClosed("ring closed")
                if self._in_flight_locked() + self._reserved \
                        >= bound:
                    t0 = time.monotonic()
                    # a full ring is a typed stall: the pipeline is
                    # gated on the drain thread, and the timeline
                    # attributes device idle under this span to
                    # slot_wait (obs/timeline.py)
                    with phase_span("slot_wait", ring=self.name,
                                    depth=bound):
                        while self._in_flight_locked() + \
                                self._reserved >= bound and \
                                not self._closed:
                            self._cv.wait(0.1)
                    waited_s = time.monotonic() - t0
                    if self._closed:
                        raise RingClosed("ring closed")
                self._reserved += 1
        finally:
            if waited_s:
                # the metric sink takes its own lock — book the
                # wait outside the cv
                self.metrics.note_wait(waited_s)
        try:
            if launch is not None:
                # heavy work OUTSIDE the lock; a raising launch
                # releases the reservation and consumes no slot
                payload = launch()
        except BaseException:
            with self._cv:
                self._reserved -= 1
                self._cv.notify_all()
            raise
        # slot_begin BEFORE the slot becomes drainable: the drain
        # thread's slot_end must never run first, and the metric
        # sink's own lock must not nest under the cv. A close()
        # racing in below books the phantom slot closed again
        # (launched == collected holds).
        self.metrics.slot_begin()
        booked = False
        try:
            with self._cv:
                self._reserved -= 1
                if self._closed:
                    self._cv.notify_all()
                    raise RingClosed("ring closed")
                slot = Slot(label, payload, collect)
                self._slots.append(slot)
                booked = True
                self._cv.notify_all()
        finally:
            if not booked:
                self.metrics.slot_end(error=True)
        self._ensure_thread()
        return slot

    def _in_flight_locked(self) -> int:
        return len(self._slots) + \
            (1 if self._collecting is not None else 0)

    def in_flight(self) -> int:
        with self._cv:
            return self._in_flight_locked()

    def flush(self, timeout_s: float = 60.0) -> bool:
        """Wait until every launched slot collected."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._in_flight_locked():
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(0.1, left))
        return True

    # --- the drain thread ---

    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                while not self._slots and not self._closed:
                    self._cv.wait(0.1)
                if not self._slots:
                    if self._closed:
                        return
                    continue
                # the slot keeps occupying ring capacity until its
                # collect finished — depth bounds launched work, not
                # merely queued work
                slot = self._slots.popleft()
                self._collecting = slot
            try:
                slot.result = slot.collect(slot.payload)
            except BaseException as e:    # noqa: BLE001 — the
                # error belongs to the slot's owner; the drain
                # thread must survive to collect the slots behind it
                slot.error = e
            with self._cv:
                self._collecting = None
                self._cv.notify_all()
            self.metrics.slot_end(error=slot.error is not None)
            slot.done.set()
