"""Spans and counters of the program, as the per-layer readers see them.

The program records its spans through an ``obs.trace.Tracer``; a
traced run hands the runners a ``Tracer`` of the program's own kind
that also keeps a plain copy of every span that finishes while it is
recording (``recording_tracer``). Readers get a :class:`TraceData`:
plain numbers and strings, nothing of the program.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class SpanRecord:
    name: str
    start: float          # time.monotonic seconds
    end: float
    attrs: dict

    @property
    def seconds(self) -> float:
        return max(0.0, self.end - self.start)


@dataclass
class TraceData:
    """What a traced run hands the per-layer readers.

    ``spans``: every span finished while recording; ``sched``: the
    scheduler's ``stats()`` of each runner of the window; ``kernels``:
    [(name, start_us, duration_us)] of the device's kernels in the
    profiled window; ``kernels_mono``: [(name, start, end)] of the same
    kernels on the host's monotonic clock (empty where the trace could
    not be tied to it); ``busy_s`` and ``window_s``: the device's busy
    union and the profiled window's length; ``completed``: items
    completed in the measured window; ``db_load_s``: the seconds of
    ``CompiledDB.load`` in set-up; ``t_start``: the profiled window's
    start (monotonic seconds); ``sieve``: what the bound of the secret
    sieve needs of the rule table (``roofline.sieve_shape``)."""
    spans: list = field(default_factory=list)
    sched: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    kernels_mono: list = field(default_factory=list)
    busy_s: float = 0.0
    window_s: float = 0.0
    completed: int = 0
    db_load_s: float = 0.0
    t_start: float = 0.0
    sieve: dict = field(default_factory=dict)

    def named(self, name: str, **having) -> list:
        """The spans called ``name`` whose attributes include every key
        of ``having`` (with that value, unless it is None)."""
        return [s for s in self.spans if s.name == name and all(
            k in s.attrs and (v is None or s.attrs[k] == v)
            for k, v in having.items())]


def recording_tracer(dump_dir: str):
    """A program ``Tracer`` that also keeps a ``SpanRecord`` of every
    span finished while its ``recording`` event is set (its
    ``records`` list). Degraded traces dump under ``dump_dir``."""
    from trivy_tpu_torch.obs.trace import Tracer

    class RecordingTracer(Tracer):
        def __init__(self):
            super().__init__()
            self.recorder.dump_dir = dump_dir
            self.recording = threading.Event()
            self.records: list = []
            self._records_lock = threading.Lock()

        def _finish(self, span) -> None:
            if self.recording.is_set() and span.end_mono is not None:
                rec = SpanRecord(span.name, span.start_mono,
                                 span.end_mono, dict(span.attrs))
                with self._records_lock:
                    self.records.append(rec)
            super()._finish(span)

    return RecordingTracer()
