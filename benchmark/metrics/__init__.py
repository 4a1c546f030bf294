"""Per-layer metric readers, one module per metric, named as the metric.

Each module holds its metric's ``LAYER``, ``SOURCE``, ``UNIT`` and
``MOVES`` (the end-to-end metric it should move) and a
``read(trace)`` that takes the number from a ``spans.TraceData``, or
returns None where the run gave it nothing to read; the harness then
leaves the metric out of the line. A reader never returns 0 for a
share of a roofline or of a peak it could not read.
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str):
    """The reader module of the metric ``name``."""
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span_seconds(spans) -> float:
    return sum(s.seconds for s in spans)


def batch_items(trace):
    """Requests per device batch over the window: the scheduler's
    batch count and items, summed over the window's runners (less what
    they had counted before it)."""
    batches = items = 0
    for before, after in trace.sched:
        b0 = (before or {}).get("batch", {})
        b1 = after.get("batch", {})
        batches += b1.get("count", 0) - b0.get("count", 0)
        items += b1.get("items_total", 0) - b0.get("items_total", 0)
    return items / batches if batches else None


def per_item(trace, spans):
    """Seconds of ``spans`` per item completed in the window."""
    if not spans or not trace.completed:
        return None
    return span_seconds(spans) / trace.completed


# kernels that run beside the match and are never its own: the secret
# sieve's (a span of the match can cover one launched by another thread)
NOT_MATCH = ("dfa_sieve_kernel",)
# a kernel counts for a span that it overlaps, widened by this much on
# either side: the error of tying the two clocks together, each tied by
# a stamp microseconds wide
CLOCK_SLACK_S = 2e-4


def _merged(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def interval_roofline_pct(trace):
    """The resident interval match's share of its bytes bound: the
    bound of the rows of every ``device_compute`` (``kind=interval``)
    span of the profiled window, over the time of the kernels that ran
    inside those spans by the profiler's trace (each kernel once,
    however many spans cover it; the sieve's left out). A span is
    stamped by CUDA events around the match on its stream, but the
    time between its stamps also holds the stream's idle waits for the
    host to launch; the kernels inside it do not."""
    from ..roofline import interval_bound_ms
    spans = [s for s in trace.named("device_compute", kind="interval")
             if s.attrs.get("clock") == "cuda_event" and s.seconds > 0
             and s.start >= trace.t_start]
    if not spans or not trace.kernels_mono:
        return None
    windows = _merged([(s.start - CLOCK_SLACK_S, s.end + CLOCK_SLACK_S)
                       for s in spans])
    kernel_s, w = 0.0, 0
    for name, a, b in sorted(trace.kernels_mono, key=lambda k: k[1]):
        if any(x in name for x in NOT_MATCH):
            continue
        while w < len(windows) and windows[w][1] < a:
            w += 1
        if w < len(windows) and windows[w][0] <= b:
            kernel_s += b - a
    if kernel_s <= 0:
        return None
    bound = sum(interval_bound_ms(int(s.attrs.get("rows", 0)))[0]
                for s in spans)
    return 100.0 * bound / (1e3 * kernel_s)


def device_idle_pct(trace):
    """The share of the profiled window in which no kernel, copy or
    set ran on the device."""
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
