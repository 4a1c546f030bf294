"""Admission queue: bounded, deadline-aware, cancellable (reference:
``trivy_tpu/sched/queue.py``).

The queue is the backpressure surface of the scheduler — ``put``
never blocks callers that asked for serving semantics; when the bound
is hit it raises the typed :class:`QueueFullError` so the RPC layer
can answer 503 (the client's retry-with-backoff treats that as
transient, exactly the reference's twirp.Unavailable loop). Batch
callers that WANT to wait (the CLI fleet path feeding 512 images into
a 256-slot queue) pass ``block=True``.

A :class:`ScanRequest` is a one-shot future plus the two host
callables the pipeline executor runs on its behalf:

* ``analyze()`` → :class:`AnalyzedWork` — phase-1 host work (image
  load/analyze/squash/join) run in the worker pool;
* ``work.finish(sieve_found, detected)`` → result — phase-3 host
  work (secret patch, result assembly) run in the worker pool after
  the device batch resolves.

Deadlines are absolute ``time.monotonic()`` instants. An expired
request is resolved with :class:`DeadlineExceeded` at whatever stage
notices first (admission pop, coalescer flush, or ``result()``
itself) — a deadline NEVER hangs, and never cancels device work
already in flight (the batch completes; the late result is simply
discarded).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

log = logging.getLogger("trivy_tpu_torch.sched.queue")


class SchedError(RuntimeError):
    """Base class for scheduler errors."""


class QueueFullError(SchedError):
    """Admission queue at capacity — back off and retry."""


class DeadlineExceeded(SchedError):
    """The request's deadline passed before completion."""


class RequestCancelled(SchedError):
    """The request was cancelled before completion."""


class SchedulerClosed(SchedError):
    """submit() after close()."""


class DeviceDispatchError(SchedError):
    """A card's dispatch failed for a reason no fault injector raised
    (a launch error, a kernel that would not build). The request fails
    with it: the host path never stands in for the card unseen."""


@dataclass
class AnalyzedWork:
    """What one request contributes to a device batch."""

    candidates: list = field(default_factory=list)  # [(path, bytes)]
    jobs: list = field(default_factory=list)        # interval jobs
    patch: Optional[Callable] = None   # (found)->None secret patch
    finish: Optional[Callable] = None  # (found, detected)->result
    deps: list = field(default_factory=list)  # events to await
    group: str = ""                    # batch-compatibility key

    @property
    def candidate_bytes(self) -> int:
        return sum(len(c) for _, c in self.candidates)


class ScanRequest:
    """One unit of admission: a name, the analyze callable, a
    deadline, and a one-shot result slot."""

    def __init__(self, name: str, analyze: Callable,
                 deadline_s: float = 0.0, group: str = "",
                 on_done: Optional[Callable] = None,
                 trace_id: str = "", tenant: str = "",
                 priority: int = 0, parent_span_id: str = ""):
        self.name = name
        self.analyze = analyze
        self.group = group
        # tenancy (sched/tenant.py): who owns this request (empty =
        # the shared anonymous tenant) and its priority class WITHIN
        # that tenant (higher pops first; FIFO within a class)
        self.tenant = tenant
        self.priority = priority
        # tracing (obs/trace.py): an incoming trace_id (RPC clients
        # propagate theirs) is honored by the scheduler's tracer,
        # which fills these span slots at each stage boundary
        self.trace_id = trace_id
        # fleet propagation (obs/propagate.py): a remote caller's
        # span id, making the scheduler's root a child in a cross-
        # process trace instead of an unlinked sibling
        self.parent_span_id = parent_span_id
        self.span_root = None
        self.span_queue = None
        self.span_coalesce = None
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + deadline_s
                         if deadline_s and deadline_s > 0 else None)
        self.on_done = on_done
        self.work: Optional[AnalyzedWork] = None
        # faults: failure-domain events survived on this request's
        # behalf (device quarantine, host fallback). Non-empty at
        # completion → the result is annotated status=degraded with
        # these as machine-readable causes. Written only by the
        # device executor thread.
        self.faults: list = []
        # patched_event: set once this request's secret patch landed
        # in the cache — other requests sharing a layer blob wait on
        # it before their final secret merge
        self.patched_event = threading.Event()
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._lock = threading.Lock()

    # --- resolution (exactly-once) ---

    def _resolve(self, result=None,
                 error: Optional[BaseException] = None) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self._result = result
            self._error = error
            self._done.set()
        # a dropped request must never wedge dependents
        self.patched_event.set()
        if self.on_done is not None:
            try:
                self.on_done(self)
            except Exception as e:  # noqa: BLE001 — never propagate
                log.warning("on_done callback failed for %r: %r",
                            self.name, e)
        return True

    def set_result(self, result) -> bool:
        return self._resolve(result=result)

    def set_error(self, error: BaseException) -> bool:
        return self._resolve(error=error)

    def record_fault(self, stage: str, kind: str,
                     message: str) -> None:
        self.faults.append({"stage": stage, "kind": kind,
                            "message": message})

    def cancel(self) -> None:
        """Best-effort: marks the request; a stage that has not yet
        started work on it resolves it with RequestCancelled."""
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now or time.monotonic()) >= self.deadline

    def remaining(self, default: float = 60.0) -> float:
        if self.deadline is None:
            return default
        return max(0.0, self.deadline - time.monotonic())

    def result(self, timeout: Optional[float] = None):
        """Block until resolution (or the deadline) and return the
        result, raising the typed error on failure. With a deadline
        set this can never hang: it waits at most until the deadline
        plus a small grace and then raises DeadlineExceeded."""
        if timeout is None and self.deadline is not None:
            timeout = max(0.0,
                          self.deadline - time.monotonic()) + 0.25
        if not self._done.wait(timeout):
            raise DeadlineExceeded(
                f"scan {self.name!r}: deadline exceeded")
        if self._error is not None:
            raise self._error
        return self._result


# The bounded admission queue itself lives in sched/tenant.py:
# ``TenantQueue`` with the default (single anonymous, unlimited
# tenant) config IS the bounded FIFO with typed-overflow put and
# blocking get this module used to define — one copy of the subtle
# blocking/backpressure state machine, not two. The package exports
# ``AdmissionQueue`` as an alias for compatibility.
