"""Metrics/SLO federation across a replica fleet (reference:
``trivy_tpu/obs/federate.py``; docs/observability.md "Fleet plane").

A :class:`Federator` holds the peer list of one federating front.
On every ``GET /metrics/federate`` scrape it pulls each peer's
snapshot JSON (``GET /metrics/snapshot``: prom text + SLO ring
export + build info), with

* **bounded fan-in** — at most ``fan_in`` concurrent pulls;
* **per-peer timeout** — one slow replica delays, never wedges, the
  scrape;
* **breaker-style skip** — a per-peer
  :class:`artifact.resilient.CircuitBreaker`: consecutive failures
  open the circuit and the peer is skipped (served from its last
  snapshot, marked stale) until the cooldown's half-open probe;
* **staleness marking** — a peer whose snapshot is older than
  ``stale_after_s`` is served but flagged, so partial federation is
  always visibly partial, never an error and never silently
  complete.

The merged exposition carries every sample under a ``replica``
label. Replica names are label values, so they follow the
cardinality rule: at most :data:`MAX_REPLICAS` distinct names,
overflow folds into ``other``.

Fleet SLO verdicts ride the same scrape: each peer's snapshot
carries its :meth:`SloEngine.export_state` (age-keyed buckets —
monotonic-only, no cross-process epoch needed), the front merges
them with :func:`obs.slo.merge_exports` and recomputes the
multi-window burn rates with :func:`obs.slo.verdicts_from_export` —
the same math as one engine fed the union event stream.
"""

from __future__ import annotations

import json
import re
import threading
import time

from .slo import merge_exports, verdicts_from_export

# distinct replica label values (the cardinality fold rule)
MAX_REPLICAS = 64

_NAME_OK = re.compile(r"[A-Za-z0-9_.:\-]{1,64}")
_METRIC_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")


def _clean_replica(name: str) -> str:
    name = str(name or "").strip()
    if not name:
        return "other"
    name = re.sub(r"[^A-Za-z0-9_.:\-]", "_", name)[:64]
    return name if _NAME_OK.fullmatch(name) else "other"


def _esc_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _inject_replica(line: str, replica: str) -> str:
    """Rewrite one exposition sample line to carry
    ``replica="<name>"`` (first label, injected after the ``{`` or
    as a fresh label set). A line that already carries a replica
    label — a federate-of-federate — is passed through untouched."""
    if 'replica="' in line:
        return line
    m = _METRIC_NAME.match(line)
    if m is None:
        return line
    name = m.group(0)
    rest = line[len(name):]
    label = f'replica="{_esc_label(replica)}"'
    if rest.startswith("{"):
        return f"{name}{{{label},{rest[1:]}"
    return f"{name}{{{label}}}{rest}"


def merge_expositions(parts: list) -> str:
    """Merge N ``(replica, prom_text)`` pairs into one text/plain
    0.0.4 document: families are grouped contiguously (strict
    parsers require one ``# TYPE`` per family), every sample gains
    the replica label, the first-seen HELP/TYPE per family wins."""
    families: dict = {}
    order: list = []
    for replica, text in parts:
        current = None
        for line in (text or "").splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or \
                    line.startswith("# TYPE "):
                fields = line.split(None, 3)
                if len(fields) < 3:
                    continue
                name = fields[2]
                fam = families.get(name)
                if fam is None:
                    fam = families[name] = \
                        {"help": None, "type": None, "samples": []}
                    order.append(name)
                key = "help" if fields[1] == "HELP" else "type"
                if fam[key] is None:
                    fam[key] = line
                current = name
            elif line.startswith("#"):
                continue            # comments / # EOF
            else:
                m = _METRIC_NAME.match(line)
                if m is None:
                    continue
                # histogram/summary series (_bucket/_sum/_count)
                # belong to the family whose header precedes them
                name = current if current is not None and \
                    m.group(0).startswith(current) else m.group(0)
                fam = families.get(name)
                if fam is None:
                    fam = families[name] = \
                        {"help": None, "type": None, "samples": []}
                    order.append(name)
                fam["samples"].append(
                    _inject_replica(line, replica))
    out = []
    for name in order:
        fam = families[name]
        if fam["help"]:
            out.append(fam["help"])
        if fam["type"]:
            out.append(fam["type"])
        out.extend(fam["samples"])
    return "\n".join(out) + "\n"


class _Peer:
    __slots__ = ("name", "url", "breaker", "snapshot",
                 "last_ok", "fetches", "failures", "skips")

    def __init__(self, name: str, url: str, breaker):
        self.name = name
        self.url = url
        self.breaker = breaker
        self.snapshot = None      # last good snapshot JSON
        self.last_ok = None       # monotonic of last success
        self.fetches = 0
        self.failures = 0
        self.skips = 0


def parse_peers(spec) -> list:
    """``name=url,name=url`` (or an iterable of such entries) →
    [(name, url)]; a bare url gets its host:port as the name."""
    if isinstance(spec, str):
        entries = [p for p in re.split(r"[,\s]+", spec) if p]
    else:
        entries = []
        for p in (spec or []):
            if isinstance(p, (tuple, list)) and len(p) == 2:
                # already-parsed (name, url) pairs pass through
                entries.append(f"{p[0]}={p[1]}" if p[0] else
                               str(p[1]))
            elif str(p):
                entries.append(str(p))
    out = []
    for entry in entries:
        name, sep, url = entry.partition("=")
        if not sep:
            url = entry
            name = re.sub(r"^https?://", "", url).rstrip("/")
        if not re.match(r"^https?://[^/]+", url):
            # a typo'd peer list fails up front (the CLI exits 2),
            # not at the first scrape with every peer "down"
            raise ValueError(
                f"peer {entry!r}: expected name=http://host:port")
        out.append((_clean_replica(name), url.rstrip("/")))
    return out


class Federator:
    """Pull-side federation state for one front replica. Transport
    is injectable (``fetch(url) -> snapshot dict``) so unit tests
    exercise breaker/staleness logic without sockets."""

    def __init__(self, peers, token: str = "",
                 token_header: str = "Trivy-Token",
                 timeout_s: float = 2.0,
                 stale_after_s: float = 60.0,
                 fan_in: int = 8,
                 fail_threshold: int = 3,
                 cooldown_s: float = 5.0,
                 fetch=None,
                 clock=time.monotonic):
        from ..artifact.resilient import CircuitBreaker
        self.token = token
        self.token_header = token_header
        self.timeout_s = timeout_s
        self.stale_after_s = stale_after_s
        self.fan_in = max(1, int(fan_in))
        self._clock = clock
        self._fetch = fetch or self._http_fetch
        self._lock = threading.Lock()
        self.scrapes = 0
        self.last_scrape_s = 0.0
        self.peers = []
        for i, (name, url) in enumerate(parse_peers(peers)):
            # cardinality fold: peers past the cap share one label
            if i >= MAX_REPLICAS:
                name = "other"
            self.peers.append(_Peer(name, url, CircuitBreaker(
                fail_threshold=fail_threshold,
                cooldown_s=cooldown_s, clock=clock)))

    # --- transport ---

    def _http_fetch(self, url: str) -> dict:
        import urllib.request
        req = urllib.request.Request(url + "/metrics/snapshot")
        if self.token:
            req.add_header(self.token_header, self.token)
        with urllib.request.urlopen(
                req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    # --- the scrape ---

    def _pull(self, peer: _Peer) -> dict:
        now = self._clock()
        if not peer.breaker.allow():
            peer.skips += 1
            return self._row(peer, up=False, skipped=True)
        try:
            snap = self._fetch(peer.url)
            if not isinstance(snap, dict):
                raise ValueError("snapshot is not a JSON object")
        except Exception as e:  # noqa: BLE001 — any transport or
            # decode failure is the condition federation exists to
            # absorb: mark, keep the last snapshot, move on
            peer.breaker.record_failure()
            peer.failures += 1
            return self._row(peer, up=False, error=repr(e))
        peer.breaker.record_success()
        peer.fetches += 1
        peer.snapshot = snap
        peer.last_ok = now
        return self._row(peer, up=True)

    def _row(self, peer: _Peer, up: bool, skipped: bool = False,
             error: str = "") -> dict:
        now = self._clock()
        age = None if peer.last_ok is None else now - peer.last_ok
        stale = (not up) and (age is None or
                              age > self.stale_after_s)
        return {"replica": peer.name, "url": peer.url, "up": up,
                "stale": stale, "skipped": skipped,
                "age_s": round(age, 3) if age is not None else None,
                "error": error,
                "snapshot": peer.snapshot,
                "breaker": peer.breaker.state}

    def collect(self) -> list:
        """Scrape every peer with bounded fan-in; one row per peer
        in declaration order. Never raises."""
        t0 = self._clock()
        rows: list = [None] * len(self.peers)
        sem = threading.Semaphore(self.fan_in)

        def work(i: int, peer: _Peer) -> None:
            with sem:
                rows[i] = self._pull(peer)

        threads = [threading.Thread(target=work, args=(i, p),
                                    daemon=True)
                   for i, p in enumerate(self.peers)]
        for t in threads:
            t.start()
        for t in threads:
            # the per-peer fetch timeout bounds each pull; the join
            # timeout is a second-layer backstop so a wedged socket
            # cannot wedge the scrape thread
            t.join(self.timeout_s * 2 + 1.0)
        for i, peer in enumerate(self.peers):
            if rows[i] is None:
                rows[i] = self._row(peer, up=False,
                                    error="scrape timeout")
        with self._lock:
            self.scrapes += 1
            self.last_scrape_s = self._clock() - t0
        return rows

    # --- rendering ---

    def render(self, local_name: str, local_text: str,
               rows: list, fleet: dict = None) -> str:
        """The ``GET /metrics/federate`` body: local + peer
        expositions merged under replica labels, then the
        federation-meta and fleet-SLO families."""
        parts = [(_clean_replica(local_name) or "self", local_text)]
        for row in rows:
            snap = row.get("snapshot")
            if snap and isinstance(snap.get("prom"), str):
                parts.append((row["replica"], snap["prom"]))
        out = [merge_expositions(parts).rstrip("\n")]
        p = "trivy_tpu_federate"
        out.append(f"# HELP {p}_peers Configured federation peers.")
        out.append(f"# TYPE {p}_peers gauge")
        out.append(f"{p}_peers {len(self.peers)}")
        out.append(f"# HELP {p}_peer_up Peer snapshot fetch "
                   f"succeeded on the last scrape.")
        out.append(f"# TYPE {p}_peer_up gauge")
        for row in rows:
            out.append(f'{p}_peer_up{{replica='
                       f'"{_esc_label(row["replica"])}"}} '
                       f'{1 if row["up"] else 0}')
        out.append(f"# HELP {p}_peer_stale Peer served from a "
                   f"snapshot older than stale_after_s (or never "
                   f"seen).")
        out.append(f"# TYPE {p}_peer_stale gauge")
        for row in rows:
            out.append(f'{p}_peer_stale{{replica='
                       f'"{_esc_label(row["replica"])}"}} '
                       f'{1 if row["stale"] else 0}')
        out.append(f"# HELP {p}_scrape_seconds Duration of the "
                   f"last federation scrape.")
        out.append(f"# TYPE {p}_scrape_seconds gauge")
        out.append(f"{p}_scrape_seconds "
                   f"{round(self.last_scrape_s, 6)}")
        if fleet is not None:
            fp = "trivy_tpu_fleet"
            out.append(f"# HELP {fp}_slo_ok Fleet-level SLO verdict "
                       f"over the merged event buckets (1 = within "
                       f"budget).")
            out.append(f"# TYPE {fp}_slo_ok gauge")
            for v in fleet.get("slos") or []:
                out.append(f'{fp}_slo_ok{{slo='
                           f'"{_esc_label(v["name"])}"}} '
                           f'{1 if v["ok"] else 0}')
            out.append(f"# HELP {fp}_slo_burn_rate Fleet-level "
                       f"error-budget burn rate per window.")
            out.append(f"# TYPE {fp}_slo_burn_rate gauge")
            for v in fleet.get("slos") or []:
                for win, rate in (v.get("burn") or {}).items():
                    out.append(
                        f'{fp}_slo_burn_rate{{slo='
                        f'"{_esc_label(v["name"])}",window='
                        f'"{_esc_label(win)}"}} {rate}')
            out.append(f"# HELP {fp}_complete Every peer answered "
                       f"fresh on the last scrape (0 = partial "
                       f"federation).")
            out.append(f"# TYPE {fp}_complete gauge")
            out.append(f"{fp}_complete "
                       f"{1 if fleet.get('complete') else 0}")
        return "\n".join(out) + "\n"

    # --- fleet SLO ---

    def fleet_slo(self, local_export: dict, rows: list,
                  now=None) -> dict:
        """Merged fleet verdicts + per-peer freshness. ``complete``
        is False the moment ANY peer is down or stale — the
        autoscaler contract is "partial federation is visibly
        partial"."""
        exports = []
        if local_export:
            exports.append(local_export)
        for row in rows:
            snap = row.get("snapshot")
            if snap and isinstance(snap.get("slo_export"), dict):
                exports.append(snap["slo_export"])
        merged = merge_exports(exports)
        verdicts = verdicts_from_export(merged, now=now)
        complete = all(r["up"] and not r["stale"] for r in rows)
        return {
            "slos": verdicts,
            "slo_ok": all(v["ok"] for v in verdicts)
            if verdicts else True,
            "complete": complete,
            "replicas": 1 + sum(1 for r in rows
                                if r.get("snapshot") is not None),
            "peers": [{"replica": r["replica"], "up": r["up"],
                       "stale": r["stale"],
                       "skipped": r["skipped"],
                       "age_s": r["age_s"],
                       "breaker": r["breaker"]}
                      for r in rows],
        }

    def stats(self) -> dict:
        with self._lock:
            scrapes = self.scrapes
            last = self.last_scrape_s
        return {
            "peers": len(self.peers),
            "scrapes": scrapes,
            "last_scrape_s": round(last, 6),
            "per_peer": [{"replica": p.name, "url": p.url,
                          "fetches": p.fetches,
                          "failures": p.failures,
                          "skips": p.skips,
                          "breaker": p.breaker.state}
                         for p in self.peers],
        }
