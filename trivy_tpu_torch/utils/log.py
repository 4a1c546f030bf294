"""Logging setup (copied from ``trivy_tpu/utils/log.py``; reference
analog: pkg/log zap SugaredLogger).

Two wire formats on the same stderr handler: the default tab-
separated text, and ``--log-format json`` — one JSON object per
line carrying ``trace_id``/``request_id`` from the active span, so
logs correlate with the per-request traces of ``obs/trace.py``.

The handler writes to whatever ``sys.stderr`` is when a line is
emitted (as logging's last resort does), so a caller that redirects
stderr around a run gets that run's lines.
"""

from __future__ import annotations

import json
import logging
import sys

_FMT = "%(asctime)s\t%(levelname)s\t%(message)s"
_DATEFMT = "%Y-%m-%dT%H:%M:%S"


class JsonFormatter(logging.Formatter):
    """Structured log lines: ts/level/logger/msg plus the tracing
    correlation ids when a traced request is active on the emitting
    thread."""

    def format(self, record) -> str:
        out = {"ts": self.formatTime(record, _DATEFMT),
               "level": record.levelname,
               "logger": record.name,
               "msg": record.getMessage()}
        if record.exc_info and record.exc_info[1] is not None:
            out["exc"] = repr(record.exc_info[1])
        try:
            from ..obs.trace import current_span
            span = current_span()
        except Exception:           # noqa: BLE001 — logging must
            span = None             # never raise
        if span is not None and not span.noop:
            out["trace_id"] = span.trace_id
            rid = span.attrs.get("request")
            if rid:
                out["request_id"] = rid
        return json.dumps(out, ensure_ascii=False)


class _StderrHandler(logging.StreamHandler):
    """A stream handler bound to the current ``sys.stderr``."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


_root = logging.getLogger("trivy_tpu_torch")
_h = next((h for h in _root.handlers
           if type(h).__name__ == "_StderrHandler"), None)
if _h is None:
    _h = _StderrHandler()
    _h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    # this handler takes the place of the last resort that the flight
    # recorder's log ring may have put beside itself
    if logging.lastResort in _root.handlers:
        _root.removeHandler(logging.lastResort)
    _root.addHandler(_h)
    _root.setLevel(logging.INFO)
    _root.propagate = False


def set_level(debug: bool = False, quiet: bool = False) -> None:
    if quiet:
        _root.setLevel(logging.ERROR)
    elif debug:
        _root.setLevel(logging.DEBUG)
    else:
        _root.setLevel(logging.INFO)


def set_format(fmt: str) -> None:
    """``text`` (default) or ``json`` (structured lines with trace
    correlation ids). Unknown values raise so a typo'd --log-format
    fails the run up front."""
    if fmt in ("", "text", "plain"):
        _h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    elif fmt == "json":
        _h.setFormatter(JsonFormatter())
    else:
        raise ValueError(f"unknown log format {fmt!r} "
                         "(choose text or json)")
