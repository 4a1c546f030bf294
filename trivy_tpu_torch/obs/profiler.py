"""Always-on sampling host profiler and the opt-in device trace
(reference: ``trivy_tpu/obs/profiler.py``).

A daemon thread walks ``sys._current_frames()`` at ~49 Hz (a prime
tick, so it cannot phase-lock with 50/100 Hz periodic work) and
folds every thread's stack into a collapsed-stack counter — the
`folded` format flamegraph.pl / speedscope / inferno consume
directly. Samples land in per-second ring buckets, so
``GET /debug/profile?seconds=N`` (token-protected, mirroring
``/trace/<id>``) answers "what was the host doing for the last N
seconds" from a process that never had profiling "switched on" (the
scan server serves it, ``rpc/server.py``).

Overhead is bounded three ways and *measured*: the sampler skips its
own thread, distinct-stack cardinality folds into ``<overflow>``
past ``max_stacks`` per bucket, and the cumulative sampling CPU time
is tracked in ``stats()["overhead_s"]``. ``TRIVY_TPU_PROFILE=off``
keeps the sampler from starting.

The optional **device** trace rides :func:`device_trace`, behind
``--profile-out DIR``: ``torch.profiler`` around the scan, its Chrome
trace written to ``DIR/torch_trace.json`` and the host profiler's
folded stacks next to it as ``host_profile.folded``. On ``cuda`` it
records CPU and CUDA activity and raises when CUDA activity cannot
be recorded: it never drops to a host-only profile on the card. On
the CPU backends it records CPU activity.

Clock discipline: bucket keys and sample timing are
``time.monotonic``; wall time appears nowhere in the math.
"""

from __future__ import annotations

import os
import sys
import threading
import time

DEFAULT_HZ = 49.0
# per-second buckets retained — 15 minutes of history
RING_SECONDS = 900
# distinct folded stacks per bucket before folding to <overflow>
MAX_STACKS = 4096
# frames folded per stack before truncating (deep recursion guard)
MAX_DEPTH = 64


def _fold(frame) -> str:
    """One thread's stack, outermost-first, semicolon-joined:
    ``module.func;module.func;...`` (the collapsed-stack frame
    vocabulary)."""
    parts: list = []
    while frame is not None and len(parts) < MAX_DEPTH:
        code = frame.f_code
        mod = frame.f_globals.get("__name__", "") or \
            os.path.basename(code.co_filename)
        parts.append(f"{mod}.{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class HostProfiler:
    """The sampling thread + the per-second folded-stack ring."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 ring_seconds: int = RING_SECONDS,
                 max_stacks: int = MAX_STACKS):
        self.hz = max(1.0, float(hz))
        self.ring_seconds = max(1, int(ring_seconds))
        self.max_stacks = max(16, int(max_stacks))
        self._lock = threading.Lock()
        # bucket second (int monotonic) -> {folded stack: count}
        self._ring: dict = {}
        self._stop = threading.Event()
        self._thread = None
        self.samples = 0
        self.ticks = 0
        self.overhead_s = 0.0      # cumulative sampling CPU time

    # --- lifecycle ---

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "HostProfiler":
        with self._lock:
            if self.running:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="trivy-obs-profiler",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 1.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    # --- sampling ---

    @staticmethod
    def _next_tick(nxt: float, period: float, now: float) -> float:
        """Fixed-rate schedule (not fixed-sleep): a slow tick doesn't
        compound into a slower sampling rate — but missed ticks are
        DROPPED, never replayed: after a long GIL hold or blocking C
        call the sampler must not fire a zero-wait catch-up burst
        that overweights whatever runs right after the stall."""
        return max(nxt + period, now)

    def _loop(self) -> None:
        period = 1.0 / self.hz
        me = threading.get_ident()
        nxt = time.monotonic()
        while not self._stop.wait(max(0.0, nxt - time.monotonic())):
            nxt = self._next_tick(nxt, period, time.monotonic())
            t0 = time.process_time()
            try:
                self.sample_once(skip_thread=me)
            # lint: disable=bare-except-at-seam -- the ~49Hz tick
            # must never take the host down or pay logging on the
            # hot path; a failed tick self-heals next period
            except Exception:       # noqa: BLE001 — the profiler
                pass                # must never take the host down
            self.overhead_s += time.process_time() - t0

    def sample_once(self, skip_thread=None) -> int:
        """One walk over every live thread's stack; returns the
        number of stacks recorded (tests drive this directly)."""
        frames = sys._current_frames()
        sec = int(time.monotonic())
        n = 0
        with self._lock:
            bucket = self._ring.get(sec)
            if bucket is None:
                bucket = self._ring[sec] = {}
                while len(self._ring) > self.ring_seconds:
                    self._ring.pop(next(iter(self._ring)))
            for tid, frame in frames.items():
                if tid == skip_thread:
                    continue
                stack = _fold(frame)
                if stack not in bucket and \
                        len(bucket) >= self.max_stacks:
                    stack = "<overflow>"
                bucket[stack] = bucket.get(stack, 0) + 1
                n += 1
            self.ticks += 1
            self.samples += n
        return n

    # --- export ---

    def folded(self, seconds=None) -> dict:
        """{folded stack: count} over the last ``seconds`` (whole
        ring when None)."""
        with self._lock:
            if seconds is None:
                keys = list(self._ring)
            else:
                horizon = int(time.monotonic()) - max(
                    0, int(seconds)) + 1
                keys = [k for k in self._ring if k >= horizon]
            out: dict = {}
            for k in keys:
                for stack, c in self._ring[k].items():
                    out[stack] = out.get(stack, 0) + c
            return out

    def collapsed(self, seconds=None) -> str:
        """Collapsed-stack text (``stack count`` per line), heaviest
        first — feed to flamegraph.pl / speedscope as-is."""
        folded = self.folded(seconds)
        lines = [f"{stack} {count}" for stack, count in
                 sorted(folded.items(),
                        key=lambda kv: (-kv[1], kv[0]))]
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path: str, seconds=None) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.collapsed(seconds))
        return path

    def stats(self) -> dict:
        with self._lock:
            return {"running": self.running, "hz": self.hz,
                    "ticks": self.ticks, "samples": self.samples,
                    "buckets": len(self._ring),
                    "overhead_s": round(self.overhead_s, 6)}


_PROFILER = None
_LOCK = threading.Lock()


def get_profiler(start: bool = True) -> HostProfiler:
    """The process-wide profiler (created on first use; started
    unless ``start=False`` or ``TRIVY_TPU_PROFILE=off``)."""
    global _PROFILER
    if _PROFILER is None:
        with _LOCK:
            if _PROFILER is None:
                _PROFILER = HostProfiler()
    if start and os.environ.get("TRIVY_TPU_PROFILE", "") != "off":
        _PROFILER.start()
    return _PROFILER


TRACE_FILE = "torch_trace.json"
HOST_FILE = "host_profile.folded"


class DeviceTraceError(RuntimeError):
    """``--profile-out`` on ``cuda`` could not record CUDA activity."""


class _DeviceTraceCtx:
    """Context manager behind :func:`device_trace`: ``torch.profiler``
    around the body, its Chrome trace and the host folded stacks
    written at the end — or at the first :meth:`step` past
    ``max_seconds``."""

    def __init__(self, out_dir: str, backend: str = "cuda",
                 max_seconds: float = 0.0):
        self.out_dir = out_dir
        self.backend = backend
        self.max_seconds = max_seconds
        self._prof = None
        self._t0 = 0.0

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity, supported_activities
        if self.backend != "cuda":
            return [ProfilerActivity.CPU]
        import torch
        if not torch.cuda.is_available():
            raise DeviceTraceError("device trace on cuda: no CUDA "
                                   "device is available")
        if ProfilerActivity.CUDA not in supported_activities():
            raise DeviceTraceError("device trace on cuda: "
                                   "torch.profiler cannot record CUDA "
                                   "activity in this build")
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def __enter__(self):
        if not self.out_dir:
            return self
        os.makedirs(self.out_dir, exist_ok=True)
        from torch.profiler import profile
        prof = profile(activities=self._activities())
        prof.__enter__()
        self._prof = prof
        self._t0 = time.monotonic()
        get_profiler()
        return self

    def step(self) -> bool:
        """Close the capture and write its files once ``max_seconds``
        have passed (a long-lived server's bounded window). Call it on
        the thread that entered the context: a ``torch.profiler``
        capture stopped off that thread crashes the process. True
        while the capture is open."""
        if self._prof is None:
            return False
        if self.max_seconds > 0 and \
                time.monotonic() - self._t0 >= self.max_seconds:
            self.__exit__(None, None, None)
            return False
        return True

    def __exit__(self, *exc):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        try:
            prof.__exit__(*exc)
            prof.export_chrome_trace(
                os.path.join(self.out_dir, TRACE_FILE))
        finally:
            try:
                get_profiler(start=False).dump(
                    os.path.join(self.out_dir, HOST_FILE))
            except OSError:
                pass


def device_trace(out_dir: str, backend: str = "cuda",
                 max_seconds: float = 0.0) -> _DeviceTraceCtx:
    """``--profile-out DIR``: a ``torch.profiler`` trace of the body
    (``DIR/torch_trace.json``, Chrome trace-event JSON: Perfetto or
    chrome://tracing) + the host profiler's collapsed stacks
    (``DIR/host_profile.folded``). ``backend`` "cuda" records CPU and
    CUDA activity and raises :class:`DeviceTraceError` when CUDA
    activity cannot be recorded; the CPU backends record CPU activity.
    ``max_seconds`` bounds the capture window (0 = until the context
    exits): the body calls the context's ``step()`` on the entering
    thread, where the window closes — the reference's timer thread
    would stop a ``torch.profiler`` capture off its thread, which
    crashes the process. A falsy ``out_dir`` is a no-op."""
    return _DeviceTraceCtx(out_dir, backend=backend,
                           max_seconds=max_seconds)
