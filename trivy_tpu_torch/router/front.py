"""Router HTTP front (reference: ``trivy_tpu/router/front.py``;
docs/serving.md "Scan router & autoscaling").

``python -m trivy_tpu_torch route`` binds this: the same twirp surface
as a single ``server`` — clients point at the router URL and notice
nothing except the ``Trivy-Routed-Replica`` response header — plus
the router's own operational routes:

* ``GET /healthz`` — router liveness + routable replica count;
* ``GET /metrics`` — JSON snapshot (router books, per-replica
  breaker/drain state, scaler decisions), or the
  ``trivy_tpu_router_*`` Prometheus families on
  ``Accept: text/plain`` (obs/prom.py:render_router);
* ``GET /replicas`` — the fleet view (ring membership, health,
  in-flight).

Token auth mirrors the replica servers: POSTs and operational GETs
honor the token, ``/healthz`` stays open for probes.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..rpc.server import DEFAULT_TOKEN_HEADER
from .core import HealthProber, ScanRouter

log = logging.getLogger("trivy_tpu_torch.router.front")


class RouterServer:
    """The embeddable front: a ScanRouter + prober (+ optional
    autoscaler), HTTP-framework-free so tests drive it directly."""

    def __init__(self, router: ScanRouter,
                 token: str = "",
                 token_header: str = DEFAULT_TOKEN_HEADER,
                 prober: Optional[HealthProber] = None,
                 scaler=None):
        self.router = router
        self.token = token
        self.token_header = token_header
        self.prober = prober
        self.scaler = scaler

    def health(self) -> dict:
        routable = self.router.stats()["routable"]
        return {"status": "ok" if routable else "unroutable",
                "role": "router",
                "replicas": len(self.router.replicas()),
                "routable": len(routable)}

    def metrics(self) -> dict:
        from ..obs.procstats import process_self_stats
        from .lifecycle import LIFECYCLE_METRICS
        out = self.router.stats()
        if self.scaler is not None:
            out["scaler"] = self.scaler.stats()
        # drain-handoff orchestration runs IN this process
        # (Autoscaler scale-down → lifecycle.run_handoff), so the
        # router front carries the lifecycle families too
        out["lifecycle"] = LIFECYCLE_METRICS.snapshot()
        out["process"] = process_self_stats()
        return out

    def metrics_text(self) -> str:
        from ..obs.prom import render_router
        from .metrics import ROUTER_METRICS
        return render_router(self.metrics(),
                             hists=ROUTER_METRICS.hist_snapshot())

    def impact(self, cve: str) -> dict:
        """``GET /impact?cve=`` — federated union of every replica's
        owned index slice (impact/federate.py). The ring partitions
        the layer-digest space, so the union over answering replicas
        is exact for their slices; a down replica makes the answer
        partial (``complete: false``), never an error."""
        from ..impact.federate import federated_impact
        return federated_impact(
            [(h.name, h.url) for h in self.router.replicas()],
            cve,
            token=self.router.token,
            token_header=self.router.token_header)

    def costs(self) -> dict:
        """``GET /costs`` — fleet per-tenant invoice: every
        replica's cost-ledger export merged by (tenant) and
        (age, tenant), with the fleet-wide accounting-identity
        verdict (obs/cost.py:federated_costs). A down replica makes
        the answer partial (``complete: false``), never an error."""
        from ..obs.cost import federated_costs
        return federated_costs(
            [(h.name, h.url) for h in self.router.replicas()],
            token=self.router.token,
            token_header=self.router.token_header)

    def close(self) -> None:
        if self.scaler is not None:
            self.scaler.stop()
        if self.prober is not None:
            self.prober.stop()


def _make_handler(front: RouterServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: dict,
                   headers=None) -> None:
            self._reply_bytes(code, json.dumps(payload).encode(),
                              "application/json", headers)

        def _reply_bytes(self, code: int, data: bytes,
                         ctype: str, headers=None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers or ():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _authorized(self) -> bool:
            if not front.token:
                return True
            import hmac
            got = self.headers.get(front.token_header) or ""
            if hmac.compare_digest(got, front.token):
                return True
            self._reply(401, {"code": "unauthenticated",
                              "msg": "invalid token"})
            return False

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, front.health())
            elif self.path == "/metrics":
                if not self._authorized():
                    return
                accept = self.headers.get("Accept") or ""
                if "text/plain" in accept \
                        or "openmetrics" in accept:
                    self._reply_bytes(
                        200, front.metrics_text().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._reply(200, front.metrics())
            elif self.path == "/replicas":
                if not self._authorized():
                    return
                self._reply(200, {
                    "replicas": [h.stats()
                                 for h in front.router.replicas()],
                    "ring": front.router.stats()["ring"]})
            elif self.path.startswith("/impact"):
                if not self._authorized():
                    return
                from urllib.parse import parse_qs, urlsplit
                q = parse_qs(urlsplit(self.path).query)
                cve = (q.get("cve") or [""])[0].strip()
                if not cve:
                    self._reply(400, {
                        "code": "malformed",
                        "msg": "missing cve= query parameter"})
                    return
                self._reply(200, front.impact(cve[:256]))
            elif self.path == "/costs":
                # fleet cost rollup: partial answers carry
                # complete=false, a fully dark fleet still answers
                # 200 with empty books — never a 5xx
                if not self._authorized():
                    return
                self._reply(200, front.costs())
            else:
                self._reply(404, {"code": "bad_route",
                                  "msg": self.path})

        def do_POST(self):
            if not self._authorized():
                return
            try:
                length = int(self.headers.get("Content-Length")
                             or 0)
            except ValueError:
                self._reply(400, {"code": "malformed",
                                  "msg": "bad content-length"})
                self.close_connection = True
                return
            raw = self.rfile.read(length) if length > 0 else b"{}"
            path = self.path.split("?", 1)[0]
            status, body, extra = front.router.route(
                path, raw, dict(self.headers))
            self._reply_bytes(status, body, "application/json",
                              extra)

    return Handler


def serve_router(front: RouterServer, addr: str = "127.0.0.1",
                 port: int = 4955) -> tuple:
    """Start the router front on a background thread. Returns
    (httpd, thread); ``httpd.shutdown()`` + ``front.close()`` to
    stop."""
    httpd = ThreadingHTTPServer((addr, port), _make_handler(front))
    thread = threading.Thread(target=httpd.serve_forever,
                              daemon=True)
    thread.start()
    log.info("router listening on %s:%d (fronting %d replicas)",
             addr, httpd.server_address[1],
             len(front.router.replicas()))
    return httpd, thread
