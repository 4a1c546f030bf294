"""Process self-stats: RSS, open fds, thread count — zero-dep
(reference: ``trivy_tpu/obs/procstats.py``).

The soak harness's leak audit (``soak/audit.py``, ROADMAP A.9h) needs every
process in the fleet — replica servers in both sched modes, the
router front, federated peers — to publish its own resource
footprint on ``/metrics``, so a week-compressed chaos run can assert
"no series grows without bound" without shelling out to ``ps``.

Reads ``/proc/self`` directly (Linux) and ``threading`` — no psutil,
matching the zero-dependency rule for the obs layer. On platforms
without procfs the gauges degrade to ``-1`` (absent, not zero: a
zero RSS would read as a real measurement).
"""

from __future__ import annotations

import os
import threading

_PAGE = 4096  # only used for the statm fallback

# high-water RSS observed by THIS process's own sampling (ratcheted
# on every process_self_stats call — the scrape cadence is the
# sampling cadence). The soak gate "peak RSS bounded" reads this
# through metrics federation instead of trusting whichever single
# sample a prober happened to catch.
_peak_lock = threading.Lock()
_peak_rss = -1


def reset_peak_rss() -> None:
    """Forget the high-water mark (test isolation)."""
    global _peak_rss
    with _peak_lock:
        _peak_rss = -1


def _rss_bytes() -> int:
    """Resident set size from ``/proc/self/status`` (VmRSS), with a
    ``/proc/self/statm`` fallback; -1 when neither is readable."""
    try:
        with open("/proc/self/status", encoding="ascii",
                  errors="replace") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    parts = line.split()
                    if len(parts) >= 2 and parts[1].isdigit():
                        return int(parts[1]) * 1024
    except OSError:
        pass
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            fields = f.read().split()
        if len(fields) >= 2 and fields[1].isdigit():
            return int(fields[1]) * _PAGE
    except OSError:
        pass
    return -1


def _open_fds() -> int:
    """Open file-descriptor count from ``/proc/self/fd``; -1 when
    procfs is unavailable."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def process_self_stats() -> dict:
    """One sample: ``{"rss_bytes", "open_fds", "threads",
    "peak_rss_bytes"}``.

    ``threads`` comes from :func:`threading.active_count` — the
    interpreter's view, which is what leak hunting cares about
    (a native thread the interpreter lost track of shows up in RSS
    instead). ``peak_rss_bytes`` is the ratcheted high-water of
    every sample this process has taken — the federated soak gate's
    "peak RSS bounded" series. Unavailable gauges are ``-1`` so
    renderers and the audit can tell "no data" from "zero"."""
    global _peak_rss
    rss = _rss_bytes()
    with _peak_lock:
        if rss > _peak_rss:
            _peak_rss = rss
        peak = _peak_rss
    return {
        "rss_bytes": rss,
        "open_fds": _open_fds(),
        "threads": threading.active_count(),
        "peak_rss_bytes": peak,
    }
