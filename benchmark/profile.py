"""The device's own account of a window, from ``torch.profiler``.

``DeviceTrace`` profiles CUDA activity from ``start`` to ``stop`` (both
on the calling thread) and reduces the trace to kernels, the busy
union of kernels, copies and sets, and the idle gaps between them. A
marker kernel launched at ``start`` and another at ``stop`` tie the
trace's clock to the host's monotonic clock (two, so that a drift
between the clocks is taken out too): each gap can then be named by
the program span that covered most of it on the host, and each kernel
placed inside the program's spans stamped by CUDA events.
"""

from __future__ import annotations

import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin"     # torch.cuda._sleep's kernel: nothing else launches it


class DeviceTrace:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.prof = None
        self.t_start = self.t_stop = 0.0
        self.markers_mono: list = []

    def _marker(self, t0: float) -> None:
        """Launch the marker kernel after host stamp ``t0`` and wait for
        it: it ran between ``t0`` and the stamp after the wait."""
        import torch
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.markers_mono.append((t0 + time.monotonic()) / 2.0)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_start = time.monotonic()
        self._marker(self.t_start)

    def stop(self) -> dict:
        """{"kernels": [(name, start_us, dur_us)], "kernels_mono":
        [(name, start_mono, end_mono)], "busy_s", "window_s", "gaps":
        [(start_mono, end_mono)], "ops": {name: seconds}} of the
        profiled window; without the markers in the trace the
        monotonic lists are empty."""
        import torch
        torch.cuda.synchronize()
        self.t_stop = time.monotonic()
        self._marker(self.t_stop)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "device_trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        spans = sorted((float(e["ts"]), float(e.get("dur", 0.0)),
                        e.get("name", ""), e.get("cat", ""))
                       for e in events if e.get("cat") in DEVICE_CATS
                       and "ts" in e)
        kernels = [(n, ts, d) for ts, d, n, c in spans if c == "kernel"]
        busy, gaps = 0.0, []
        cur_a = cur_b = None
        for ts, d, _, _ in spans:
            if cur_b is None or ts > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                    gaps.append((cur_b, ts))
                cur_a, cur_b = ts, ts + d
            else:
                cur_b = max(cur_b, ts + d)
        if cur_b is not None:
            busy += cur_b - cur_a
        ops: dict = {}
        for ts, d, n, _ in spans:
            ops[n] = ops.get(n, 0.0) + d / 1e6
        to_mono = clock_map([(ts + d / 2.0) for n, ts, d in kernels
                             if MARKER in n], self.markers_mono)
        if to_mono is None:
            mono_gaps, kernels_mono = [], []
        else:
            mono_gaps = [(to_mono(a), to_mono(b)) for a, b in gaps]
            kernels_mono = [(n, to_mono(ts), to_mono(ts + d))
                            for n, ts, d in kernels if MARKER not in n]
        return {"kernels": [k for k in kernels if MARKER not in k[0]],
                "kernels_mono": kernels_mono, "busy_s": busy / 1e6,
                "window_s": self.t_stop - self.t_start,
                "gaps": mono_gaps, "ops": ops}


def clock_map(marks_us: list, marks_mono: list):
    """The trace's microseconds → the host's monotonic seconds, from
    the markers' midpoints in the trace (``marks_us``, in order) and on
    the host (``marks_mono``): a line through the first and the last,
    an offset alone where only the first is there; None without one."""
    if not marks_us or len(marks_us) > len(marks_mono):
        return None
    u0, m0 = marks_us[0] / 1e6, marks_mono[0]
    if len(marks_us) == 1:
        return lambda us: us / 1e6 - u0 + m0
    u1, m1 = marks_us[-1] / 1e6, marks_mono[len(marks_us) - 1]
    rate = (m1 - m0) / (u1 - u0)
    return lambda us: m0 + (us / 1e6 - u0) * rate


def breakdown(dev: dict, spans: list, top: int = 10) -> dict:
    """``device_ops``: the device operations that took most time;
    ``idle_gaps``: the longest gaps between them, each named by the
    program span (``spans.SpanRecord``, request roots and queue waits
    left out) that covered most of it on the host, or ``host``."""
    ops = sorted(dev["ops"].items(), key=lambda kv: -kv[1])[:top]
    named = [s for s in spans if s.name not in ("scan", "queue_wait")]
    gaps = []
    for a, b in sorted(dev["gaps"], key=lambda g: g[0] - g[1])[:top]:
        cover: dict = {}
        for s in named:
            o = min(b, s.end) - max(a, s.start)
            if o > 0:
                cover[s.name] = cover.get(s.name, 0.0) + o
        label = max(cover, key=cover.get) if cover else "host"
        gaps.append([label, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}
