"""Steady-state resource audit (copied from ``trivy_tpu/soak/audit.py``):
the leak detector a soak run rides.

Per epoch the audit samples the process self-stats
(obs/procstats.py: RSS, open fds, interpreter threads) plus every
long-lived *bounded-by-design* structure the fleet carries —
recorder rings and dump dirs, idempotency windows, the admission
verdict cache, tenant books, impact postings, the watch cursor's
ack window — via registered probe callables. At the end of the run
:meth:`ResourceAudit.verdict` renders one pass/fail per series: a
series that keeps growing after warm-up fails the run, because over
a compressed week "slow leak" and "unbounded" are the same thing.

The bounded-growth test is deliberately simple and robust to noise:
drop a warm-up prefix, split the rest into a head and a tail third,
and fail if the tail's *minimum* clears the head's *maximum* by
more than tolerance + slack — monotone creep trips it, a plateau
(however noisy) never does.
"""

from __future__ import annotations

import threading

from ..obs.procstats import process_self_stats

# per-series absolute slack: jitter below this never fails
_DEFAULT_SLACK = {
    "rss_bytes": 24 * 1024 * 1024,   # allocator quantization
    "open_fds": 16,                  # transient sockets
    "threads": 8,                    # pool spin-up
}
_SLACK_OTHER = 4.0                   # structure sizes (entries)


class ResourceAudit:
    """Epoch sampler + flat-after-warm-up verdict.

    ``probes`` maps series name → zero-arg callable returning a
    number (a structure's current size). Probe errors record -1 for
    that epoch (absent, never fatal — a killed replica's probe must
    not crash the audit)."""

    def __init__(self, probes: dict = None,
                 warmup_frac: float = 0.25,
                 tolerance: float = 0.10):
        self.warmup_frac = min(0.75, max(0.0, warmup_frac))
        self.tolerance = max(0.0, tolerance)
        self._lock = threading.Lock()
        self._probes: dict = dict(probes or {})
        self._ungated: set = set()
        self._series: dict = {}      # name -> [value per epoch]
        self.epochs = 0

    def add_probe(self, name: str, fn, gate: bool = True) -> None:
        """``gate=False`` records the series for visibility but
        excludes it from the verdict — for structures bounded by the
        corpus rather than by a cap (a registry index saturates at
        ``images``; within a short run it only ever grows)."""
        with self._lock:
            self._probes[name] = fn
            if not gate:
                self._ungated.add(name)
            else:
                self._ungated.discard(name)

    def sample(self) -> dict:
        """One epoch: process self-stats + every registered probe.
        Returns the sample (also appended to the series)."""
        row = dict(process_self_stats())
        with self._lock:
            probes = list(self._probes.items())
        for name, fn in probes:
            try:
                row[name] = float(fn())
            except Exception:        # noqa: BLE001 — a probe over a
                # dead replica must degrade, not kill the audit
                row[name] = -1.0
        with self._lock:
            self.epochs += 1
            for name, v in row.items():
                self._series.setdefault(name, []).append(
                    float(v))
        return row

    @staticmethod
    def _bounded(values: list, warmup_frac: float,
                 tolerance: float, slack: float) -> dict:
        """One series → verdict. ``values`` may contain -1 sentinels
        (no data that epoch) — they are ignored."""
        vals = [v for v in values if v >= 0]
        if len(vals) < 6:
            return {"ok": True, "reason": "too few samples",
                    "samples": len(vals)}
        body = vals[int(len(vals) * warmup_frac):]
        third = max(1, len(body) // 3)
        head, tail = body[:third], body[-third:]
        head_max, tail_min = max(head), min(tail)
        limit = head_max * (1.0 + tolerance) + slack
        ok = tail_min <= limit
        return {"ok": ok,
                "head_max": head_max, "tail_min": tail_min,
                "limit": round(limit, 3),
                "peak": max(vals), "last": vals[-1],
                "samples": len(vals)}

    def verdict(self) -> dict:
        """Every series judged. ``ok`` is the AND over GATED series
        — one unbounded gated series fails the soak; ungated series
        carry their verdict for the report but never fail it."""
        with self._lock:
            series = {k: list(v) for k, v in self._series.items()}
            ungated = set(self._ungated)
        out = {"ok": True, "epochs": self.epochs, "series": {}}
        for name in sorted(series):
            slack = _DEFAULT_SLACK.get(name, _SLACK_OTHER)
            v = self._bounded(series[name], self.warmup_frac,
                              self.tolerance, slack)
            v["gated"] = name not in ungated
            out["series"][name] = v
            if not v["ok"] and v["gated"]:
                out["ok"] = False
        return out

    def series(self, name: str) -> list:
        with self._lock:
            return list(self._series.get(name, ()))
