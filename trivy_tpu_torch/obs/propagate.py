"""Cross-process trace propagation + clock-offset handshake — the
fleet plane's transport layer (reference: ``trivy_tpu/obs/propagate.py``;
docs/observability.md "Fleet plane").

Two independent pieces:

* **TraceContext** — a W3C-traceparent-style context
  (``00-<trace_id>-<parent_span_id>-01``) carried across every
  process seam: RPC Scan bodies (or the ``Traceparent`` header), the
  simhost spec file, and watch notification envelopes. Ids are
  validated with the same ``^[0-9a-f]{8,64}$`` discipline as
  :mod:`obs.trace` (fullmatch — they end up in flight-recorder dump
  file names), so a hostile header degrades to "no context", never
  to a bad id.

* **Clock-offset estimation** — a tiny monotonic-clock handshake
  (:class:`ClockServer` over TCP for simulated hosts, ``GET /clock``
  on the scan server) plus :func:`estimate_offset`: midpoint-of-RTT
  over the minimum-RTT sample, so ``local ≈ remote + offset`` with
  error bounded by rtt/2. Monotonic only — wall clocks never enter
  timeline math.

Import-light: stdlib only at module scope.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
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


# --- monotonic clock-offset handshake -----------------------------

@dataclass(frozen=True)
class OffsetEstimate:
    """``local_mono ≈ remote_mono + offset_s``, with the midpoint
    error bounded by ``error_bound_s`` (= best rtt / 2): the remote
    stamp was taken somewhere inside the probe's [t0, t1] window."""

    offset_s: float
    error_bound_s: float
    rtt_s: float
    samples: int


def estimate_offset(probe, samples: int = 8) -> OffsetEstimate:
    """Pairwise clock-offset estimate from ``samples`` round trips of
    ``probe()`` (a callable returning the peer's ``time.monotonic()``
    as float). Uses the minimum-RTT sample — the one with the
    tightest error bound — and the midpoint-of-RTT convention:
    ``offset = (t0+t1)/2 - remote``."""
    best_rtt, best_offset = None, 0.0
    n = 0
    for _ in range(max(1, int(samples))):
        t0 = time.monotonic()
        remote = float(probe())
        t1 = time.monotonic()
        n += 1
        rtt = max(0.0, t1 - t0)
        if best_rtt is None or rtt < best_rtt:
            best_rtt = rtt
            best_offset = (t0 + t1) / 2.0 - remote
    return OffsetEstimate(offset_s=best_offset,
                          error_bound_s=(best_rtt or 0.0) / 2.0,
                          rtt_s=best_rtt or 0.0, samples=n)


class ClockServer:
    """Line-oriented TCP clock responder a simulated host runs so the
    coordinating process can handshake offsets while the host scans:
    every received line is answered with ``{"mono": <monotonic>}\\n``.
    Daemon threads, bounded to loopback by default, closed
    idempotently."""

    def __init__(self, addr: str = "127.0.0.1", port: int = 0):
        self._sock = socket.create_server((addr, port))
        self._sock.settimeout(0.25)
        self.addr = addr
        self.port = self._sock.getsockname()[1]
        self._closed = False
        self.requests = 0
        self._thread = threading.Thread(
            target=self._serve, name="trivy-tpu-clock", daemon=True)
        self._thread.start()

    def write_port_file(self, path: str) -> None:
        """Publish the bound port atomically (tmp + rename), so a
        parent polling the file never reads a partial write."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(self.port))
        os.replace(tmp, path)

    def _serve(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._answer, args=(conn,),
                                 daemon=True)
            t.start()

    def _answer(self, conn) -> None:
        try:
            conn.settimeout(5.0)
            buf = b""
            while not self._closed:
                chunk = conn.recv(256)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    _, buf = buf.split(b"\n", 1)
                    self.requests += 1
                    line = json.dumps(
                        {"mono": time.monotonic()}) + "\n"
                    conn.sendall(line.encode("ascii"))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class ClockClient:
    """One persistent connection to a :class:`ClockServer`; its
    bound :meth:`probe` feeds :func:`estimate_offset` (a persistent
    connection keeps RTT jitter down versus connect-per-sample)."""

    def __init__(self, addr: str, port: int, timeout_s: float = 2.0):
        self._sock = socket.create_connection(
            (addr, int(port)), timeout=timeout_s)
        self._buf = b""

    def probe(self) -> float:
        self._sock.sendall(b"\n")
        while b"\n" not in self._buf:
            chunk = self._sock.recv(256)
            if not chunk:
                raise ConnectionError("clock server closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return float(json.loads(line.decode("ascii"))["mono"])

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def read_port_file(path: str, timeout_s: float = 10.0) -> int:
    """Poll for a :meth:`ClockServer.write_port_file` publication."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read().strip()
            if text:
                return int(text)
        except (OSError, ValueError):
            pass
        time.sleep(0.01)
    raise TimeoutError(f"clock port file {path!r} never appeared")


def http_clock_probe(url: str, token: str = "",
                     timeout_s: float = 2.0):
    """A probe() over the RPC server's ``GET /clock`` route, for
    offset handshakes between fleet replicas (returns a callable for
    :func:`estimate_offset`)."""
    import urllib.request

    def probe() -> float:
        req = urllib.request.Request(url.rstrip("/") + "/clock")
        if token:
            req.add_header("Trivy-Token", token)
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            doc = json.loads(resp.read().decode("utf-8"))
        return float(doc["mono"])

    return probe
