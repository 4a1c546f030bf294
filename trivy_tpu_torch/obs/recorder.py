"""Flight recorder: a bounded in-memory ring of the last N completed
traces plus the recent log tail (reference:
``trivy_tpu/obs/recorder.py``).

The ring is always on — it costs one OrderedDict entry per completed
trace and evicts FIFO past ``capacity`` — so when a scan lands
degraded or failed the evidence is already in memory: the tracer
dumps the full span tree (with the log tail attached under
``otherData.recent_logs``) to ``dump_dir`` and the report's
FailureCauses reference the dump path.

:class:`RingLogHandler` is a stdlib logging handler that copies every
trivy_tpu_torch log record into the recorder's deque, annotated with the
active span's trace/request ids when one is bound — the crash dump
therefore carries the log lines that led up to the failure, not just
the timings.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import tempfile
import threading
import time

# age-based dump pruning (seconds; unset/0 = off): long-lived
# servers with occasional failures keep DUMP_CAP files forever
# otherwise — a fleet of them is DUMP_CAP x N stale evidence
DUMP_MAX_AGE_ENV = "TRIVY_TPU_DUMP_MAX_AGE_S"

# total-bytes cap on the dump dir (unset/0 = off): DUMP_CAP bounds
# the file COUNT, but a soak with repeated designed SLO trips dumps
# deep traces — N files of unbounded size is still an unbounded
# dir. Oldest dumps go first; the newest dump always survives even
# when it alone exceeds the cap (evidence of the trip that just
# happened beats an empty dir)
DUMP_MAX_BYTES_ENV = "TRIVY_TPU_DUMP_MAX_BYTES"


class FlightRecorder:
    """Last-N completed traces + recent log events, thread-safe."""

    # crash-dump files kept on disk at once — a mass-expiry event
    # (every admitted request timing out) is bounded to this many
    # writes' worth of disk, FIFO-pruned
    DUMP_CAP = 64

    def __init__(self, capacity: int = 256, log_capacity: int = 512,
                 dump_dir: str = ""):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._ring: collections.OrderedDict = collections.OrderedDict()
        self.logs: collections.deque = collections.deque(
            maxlen=max(1, log_capacity))
        self._dump_dir = dump_dir
        # (path, insert monotonic, bytes) — insert-time monotonic
        # stamps keep age pruning on the monotonic clock (the wall
        # mtime would reintroduce time.time() arithmetic, which the
        # obs clock lint forbids)
        self._dump_paths: collections.deque = collections.deque()
        self.evicted = 0
        self.dumps = 0
        self.dump_bytes = 0
        self.dumps_pruned = 0
        self._clock = time.monotonic   # injectable (age-prune tests)
        # the owning Tracer's monotonic epoch — dump() subtracts it
        # so every dump in the dir shares one timebase (us since
        # tracer start), whoever triggers the dump (a failed scan,
        # an SLO burn-rate trip, an operator)
        self.epoch_mono = 0.0

    # --- dump location ---

    @property
    def dump_dir(self) -> str:
        if self._dump_dir:
            return self._dump_dir
        # uid-scoped, not a fixed world-guessable name: the dumps
        # carry log tails and request names, and a squatter owning a
        # shared path could read (or blackhole) them
        uid = getattr(os, "getuid", lambda: "")()
        return os.path.join(tempfile.gettempdir(),
                            f"trivy-tpu-traces-{uid}")

    @dump_dir.setter
    def dump_dir(self, value: str) -> None:
        self._dump_dir = value

    def dump_path(self, trace_id: str) -> str:
        return os.path.join(self.dump_dir, f"trace-{trace_id}.json")

    # --- the trace ring ---

    def add(self, trace_id: str, spans: list) -> None:
        with self._lock:
            self._ring[trace_id] = list(spans)
            self._ring.move_to_end(trace_id)
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
                self.evicted += 1

    def append(self, trace_id: str, span) -> None:
        """Late child span for an already-completed trace (a sweep
        resolved the request mid-stage); dropped once evicted."""
        with self._lock:
            spans = self._ring.get(trace_id)
            if spans is not None:
                spans.append(span)

    def get(self, trace_id: str):
        with self._lock:
            spans = self._ring.get(trace_id)
            return list(spans) if spans is not None else None

    def trace_ids(self) -> list:
        with self._lock:
            return list(self._ring)

    def traces(self) -> list:
        """[(trace_id, [spans])] oldest → newest."""
        with self._lock:
            return [(tid, list(spans))
                    for tid, spans in self._ring.items()]

    # --- the log ring ---

    def note_log(self, entry: dict) -> None:
        self.logs.append(entry)       # deque append is atomic

    def recent_logs(self) -> list:
        return list(self.logs)

    # --- crash dumps ---

    @staticmethod
    def write_doc(path: str, doc: dict) -> None:
        """Atomic trace-file write (tmp + rename) — shared by crash
        dumps and the tracer's ``--trace-out`` exporter."""
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def dump(self, trace_id: str, spans=None,
             epoch_mono: float = None) -> str:
        """Write one trace (plus the recent log tail) as Perfetto-
        loadable JSON under ``dump_dir``; returns the path. The dir
        is created private (0700) and must be owned by this uid;
        at most ``DUMP_CAP`` dump files are kept (FIFO pruning).
        ``epoch_mono`` defaults to the owning tracer's epoch so
        every dump shares one timebase."""
        from .trace import to_chrome
        if epoch_mono is None:
            epoch_mono = self.epoch_mono
        if spans is None:
            spans = self.get(trace_id)
        if spans is None:
            raise ValueError(f"unknown trace {trace_id!r}")
        doc = to_chrome(spans, epoch_mono)
        doc.setdefault("otherData", {})["recent_logs"] = \
            self.recent_logs()
        path = self.dump_path(trace_id)
        d = os.path.dirname(path)
        os.makedirs(d, mode=0o700, exist_ok=True)
        if hasattr(os, "getuid") and \
                os.stat(d).st_uid != os.getuid():
            raise OSError(
                f"refusing to dump into {d!r}: owned by another uid")
        self.write_doc(path, doc)
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = 0
        try:
            max_age = float(os.environ.get(DUMP_MAX_AGE_ENV,
                                           "0") or 0)
        except ValueError:
            max_age = 0.0
        try:
            max_bytes = int(float(os.environ.get(
                DUMP_MAX_BYTES_ENV, "0") or 0))
        except ValueError:
            max_bytes = 0
        now = self._clock()
        with self._lock:
            self.dumps += 1
            # re-dumping a trace replaces its entry (same file name):
            # the books must not double-count the bytes or prune the
            # live file out from under the newer entry
            for i, (p, _, b) in enumerate(self._dump_paths):
                if p == path:
                    del self._dump_paths[i]
                    self.dump_bytes -= b
                    break
            self._dump_paths.append((path, now, nbytes))
            self.dump_bytes += nbytes
            prune = []
            if max_age > 0:
                while self._dump_paths and \
                        now - self._dump_paths[0][1] > max_age:
                    prune.append(self._dump_paths.popleft())
            while len(self._dump_paths) > self.DUMP_CAP:
                prune.append(self._dump_paths.popleft())
            for _, _, b in prune:
                self.dump_bytes -= b
            if max_bytes > 0:
                # rotate by TOTAL bytes, oldest first — but never
                # the dump just written: the freshest evidence is
                # the one an operator is about to fetch
                while self.dump_bytes > max_bytes and \
                        len(self._dump_paths) > 1:
                    victim = self._dump_paths.popleft()
                    self.dump_bytes -= victim[2]
                    prune.append(victim)
            self.dumps_pruned += len(prune)
        for old, _, _ in prune:
            try:
                os.remove(old)
            except OSError:
                pass
        return path

    def stats(self) -> dict:
        with self._lock:
            return {"traces": len(self._ring),
                    "capacity": self.capacity,
                    "evicted": self.evicted,
                    "dumps": self.dumps,
                    "dump_files": len(self._dump_paths),
                    "dump_bytes": self.dump_bytes,
                    "dumps_pruned": self.dumps_pruned,
                    "logs": len(self.logs)}


class RingLogHandler(logging.Handler):
    """Copies trivy_tpu_torch log records into the flight recorder, tagged
    with the active span's correlation ids."""

    def __init__(self, recorder: FlightRecorder):
        super().__init__(level=logging.DEBUG)
        self.recorder = recorder

    def emit(self, record) -> None:
        try:
            entry = {"t": round(record.created, 6),
                     "level": record.levelname,
                     "logger": record.name,
                     "msg": record.getMessage()}
            from .trace import current_span
            span = current_span()
            if span is not None and not span.noop:
                entry["trace_id"] = span.trace_id
                rid = span.attrs.get("request")
                if rid:
                    entry["request_id"] = rid
            self.recorder.note_log(entry)
        except Exception:           # noqa: BLE001 — logging must
            self.handleError(record)   # never take the pipeline down


_ATTACH_LOCK = threading.Lock()
_ATTACHED = False


def attach_ring_handler(recorder: FlightRecorder) -> None:
    """Attach the log ring to the trivy_tpu_torch root logger (once)."""
    global _ATTACHED
    with _ATTACH_LOCK:
        if _ATTACHED:
            return
        logger = logging.getLogger("trivy_tpu_torch")
        if not logger.handlers and not logging.getLogger().handlers:
            # the port configures no log handler of its own: with none
            # anywhere, warnings reach stderr through logging's last
            # resort. The ring's handler would end that, so the last
            # resort joins it (the reference's logger has its stderr
            # handler beside the ring)
            logger.addHandler(logging.lastResort)
        logger.addHandler(RingLogHandler(recorder))
        _ATTACHED = True
