"""Cross-process trace propagation (reference:
``trivy_tpu/obs/propagate.py``, its context half; docs/observability.md
"Fleet plane").

**TraceContext** — a W3C-traceparent-style context
(``00-<trace_id>-<parent_span_id>-01``) carried across the RPC seam:
the client injects the active span's context into a Scan body (or the
``Traceparent`` header), and the server roots the request's span tree
under it. Ids are validated with the same ``^[0-9a-f]{8,64}$``
discipline as :mod:`obs.trace` (fullmatch — they end up in
flight-recorder dump file names), so a hostile header degrades to "no
context", never to a bad id.

The clock-offset handshake (``ClockServer``, ``ClockClient``,
``estimate_offset``, the server's ``GET /clock``) comes with the fleet
plane, ROADMAP A.9i.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .trace import _ID_RE, current_span

# body field and HTTP header the context rides in (the RPC server
# folds the header into the body exactly like the tenant header, so
# every downstream consumer reads one place)
TRACEPARENT_KEY = "traceparent"
TRACEPARENT_HEADER = "Traceparent"

_VERSION = "00"
_ZERO_SPAN = "0" * 16


def _valid_id(value: str) -> bool:
    return bool(value) and _ID_RE.fullmatch(value) is not None


@dataclass(frozen=True)
class TraceContext:
    """One propagated (trace_id, parent_span_id) pair. Either field
    may be empty; :meth:`valid` means a usable trace id rode in."""

    trace_id: str = ""
    parent_span_id: str = ""

    def valid(self) -> bool:
        return _valid_id(self.trace_id)

    def to_header(self) -> str:
        """``00-<trace_id>-<parent_span_id>-01``; an empty parent
        renders as the all-zero span id (W3C's "no parent")."""
        return "-".join((_VERSION, self.trace_id,
                         self.parent_span_id or _ZERO_SPAN, "01"))


EMPTY_CONTEXT = TraceContext()


def parse_traceparent(text) -> Optional[TraceContext]:
    """Strict parse of a traceparent value; None on anything that
    does not round-trip (wrong arity, bad hex, version ff, an id
    outside the 8–64 lowercase-hex discipline). The all-zero parent
    span id means "root" and parses to an empty parent."""
    parts = str(text or "").strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    hexdigits = "0123456789abcdef"
    if len(version) != 2 or any(c not in hexdigits for c in version):
        return None
    if version == "ff":
        return None
    if len(flags) != 2 or any(c not in hexdigits for c in flags):
        return None
    if not _valid_id(trace_id) or set(trace_id) == {"0"}:
        return None
    if span_id == _ZERO_SPAN or set(span_id) == {"0"}:
        span_id = ""
    elif not _valid_id(span_id):
        return None
    return TraceContext(trace_id=trace_id, parent_span_id=span_id)


def current_context() -> Optional[TraceContext]:
    """The active span's context, or None when no (real) span is
    active — this is what clients inject at the wire seam."""
    span = current_span()
    if span is None or span.noop or not span.trace_id:
        return None
    return TraceContext(trace_id=span.trace_id,
                        parent_span_id=span.span_id)


def inject(body: dict, span=None) -> dict:
    """Stamp the active (or given) span's context into an RPC body.
    Keeps the legacy bare ``trace_id`` field too, so a new client
    against an old server degrades to the pre-fleet behavior (same
    trace id, remote root not linked) instead of losing the id."""
    if span is not None and not getattr(span, "noop", False) \
            and span.trace_id:
        ctx = TraceContext(trace_id=span.trace_id,
                           parent_span_id=span.span_id)
    else:
        ctx = current_context()
    if ctx is not None:
        body[TRACEPARENT_KEY] = ctx.to_header()
        body.setdefault("trace_id", ctx.trace_id)
    return body


def extract(body, headers=None) -> TraceContext:
    """Pull a context out of a request: the ``traceparent`` body
    field (or header) wins; a legacy bare ``trace_id`` still yields
    an unparented context. Never raises, never returns None — a
    garbage header is an EMPTY context (fresh root), matching the
    _clean_trace_id security posture."""
    raw = ""
    if isinstance(body, dict):
        raw = str(body.get(TRACEPARENT_KEY) or "")
    if not raw and headers is not None:
        try:
            raw = str(headers.get(TRACEPARENT_HEADER) or "")
        except Exception:   # noqa: BLE001 — a headers mapping that
            raw = ""        # raises is treated as absent
    ctx = parse_traceparent(raw) if raw else None
    if ctx is not None:
        return ctx
    legacy = ""
    if isinstance(body, dict):
        legacy = str(body.get("trace_id") or "").lower()
    if _valid_id(legacy):
        return TraceContext(trace_id=legacy)
    return EMPTY_CONTEXT
