"""The port's scan router (``trivy_tpu_torch/router/``: core, front,
metrics, scaler, sim, lifecycle's ``run_handoff``; ``obs/prom.py::
render_router``; the ``route`` subcommand) against the reference's
(``trivy_tpu/router/``, mirroring ``tests/test_router.py``).

Every scenario runs once per package on the same seeded inputs — each
package's router in front of its own ``SimReplica`` fleet — and the
outcomes must be equal: the replica each request lands on, the route
keys, the stamped bodies byte for byte, the headers, the books
(``ROUTER_METRICS``), the lifecycle counters and the scaler's
decisions. The router's outputs are bytes, counters and names, so no
tolerance applies; latency histograms and process gauges, which read
clocks, are left out of the comparisons. Scan bodies always carry an
idempotency key: a keyless Scan gets a random one minted by the
router. Every server binds a free 127.0.0.1 port and stops at the
test's end; no test asserts a wall-clock threshold."""

import contextlib
import hashlib
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

import trivy_tpu.artifact.resilient as rres
import trivy_tpu.faults as rfaults
import trivy_tpu.obs.prom as rprom
import trivy_tpu.router.core as rcore
import trivy_tpu.router.front as rfront
import trivy_tpu.router.lifecycle as rlife
import trivy_tpu.router.metrics as rmetrics
import trivy_tpu.router.scaler as rscaler
import trivy_tpu.router.sim as rsim
import trivy_tpu_torch.artifact.resilient as tres
import trivy_tpu_torch.faults as tfaults
import trivy_tpu_torch.obs.prom as tprom
import trivy_tpu_torch.router.core as tcore
import trivy_tpu_torch.router.front as tfront
import trivy_tpu_torch.router.lifecycle as tlife
import trivy_tpu_torch.router.metrics as tmetrics
import trivy_tpu_torch.router.scaler as tscaler
import trivy_tpu_torch.router.sim as tsim
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "ref": SimpleNamespace(core=rcore, front=rfront, life=rlife,
                           metrics=rmetrics, scaler=rscaler, sim=rsim,
                           prom=rprom, faults=rfaults, res=rres),
    "port": SimpleNamespace(core=tcore, front=tfront, life=tlife,
                            metrics=tmetrics, scaler=tscaler, sim=tsim,
                            prom=tprom, faults=tfaults, res=tres),
}
SCAN = tcore.SCAN_PATH
CACHE = "/twirp/trivy.cache.v1.Cache/"
TOKEN = "tok"


@pytest.fixture(autouse=True)
def _fresh_books():
    """Both packages' process-wide router and lifecycle books start
    and end every case at zero."""
    def reset():
        for p in PKGS.values():
            p.metrics.ROUTER_METRICS.reset()
            p.life.LIFECYCLE_METRICS.reset()
    reset()
    yield
    reset()


@pytest.fixture()
def stops():
    """Callables run at the test's end (servers, fleets)."""
    todo = []
    yield todo
    for fn in reversed(todo):
        fn()


def _keys(n, seed="ring"):
    return ["sha256:" + hashlib.sha256(f"{seed}:{i}".encode()).hexdigest()
            for i in range(n)]


def _idem(seed) -> str:
    return hashlib.sha256(f"idem:{seed}".encode()).hexdigest()[:32]


def _scan_body(digest, key, tenant=""):
    body = {"idempotency_key": key, "target": f"img:{digest[7:19]}",
            "artifact_id": "sha256:art-" + digest[-12:],
            "blob_ids": [digest]}
    if tenant:
        body["tenant"] = tenant
    return json.dumps(body).encode()


def _books(p) -> dict:
    """The router's books without the clock-read histograms."""
    snap = p.metrics.ROUTER_METRICS.snapshot()
    for k in ("route_latency", "upstream_latency"):
        snap.pop(k)
    return snap


def _fleet(p, stops, n, **kw):
    sims = [p.sim.SimReplica(name=f"s{i}", **kw).start() for i in range(n)]
    stops.extend(s.stop for s in sims)
    return sims


def _router(p, sims, **kw):
    return p.core.ScanRouter([(s.name, s.url) for s in sims], **kw)


def _owned(ring, node, seed):
    return next(k for k in _keys(512, seed) if ring.owner(k) == node)


class _Scripted:
    """A backend answering a scripted (status, payload, headers) per
    POST; the last entry repeats."""

    def __init__(self, script):
        self.script, self.requests = list(script), []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                outer.requests.append((self.path, self.rfile.read(n)))
                status, payload, headers = outer.script[
                    min(len(outer.requests), len(outer.script)) - 1]
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# --- the request path: one scenario per case, run on both packages ------

def case_keyed_sequence(p, stops):
    """A seeded sequence of keyed Scans and MissingBlobs over three
    replicas: each route key, status, header and stamped body."""
    sims = _fleet(p, stops, 3, service_ms=0)
    r = _router(p, sims)
    out = []
    for i, d in enumerate(_keys(24, "seq") + _keys(6, "seq")):
        if i % 3 == 2:
            body = json.dumps({"artifact_id": f"sha256:a{i}",
                               "blob_ids": [d, f"sha256:l{i}"]}).encode()
            path = CACHE + "MissingBlobs"
        else:
            path, body = SCAN, _scan_body(d, _idem(i))
        key = r.route_key(path, json.loads(body))
        status, raw, extra = r.route(path, body)
        out.append((path, key, r.ring.owner(key), status, raw, extra))
    return {"requests": out, "ring": r.ring.nodes(), "books": _books(p),
            "scans": [s.counters["scans"] for s in sims]}


def case_affinity(p, stops):
    """PutBlob/PutArtifact/DeleteBlobs follow the MissingBlobs that
    opened the session, to the same replica."""
    sims = _fleet(p, stops, 3, service_ms=0)
    r = _router(p, sims)
    base, layer = _keys(2, "aff")
    got = [r.route(CACHE + "MissingBlobs", json.dumps(
        {"artifact_id": "sha256:artA", "blob_ids": [base, layer]}).encode())]
    keys = [r.route_key(CACHE + "PutBlob", {"diff_id": layer}),
            r.route_key(CACHE + "PutArtifact", {"artifact_id": "sha256:artA"}),
            r.route_key(CACHE + "DeleteBlobs", {"blob_ids": [layer]}),
            r.route_key(CACHE + "PutBlob", {"diff_id": "sha256:other"}),
            r.route_key("/twirp/x/Other", {})]
    got.append(r.route(CACHE + "PutBlob", json.dumps(
        {"diff_id": layer, "blob_info": {}}).encode()))
    return {"keys": keys, "base": base, "got": got,
            "affinity": r.stats()["affinity_entries"],
            "blobs": [sorted(s._blobs) for s in sims], "books": _books(p)}


def case_spill(p, stops):
    """A melted owner (20 in flight) spills the Scan to the next ring
    node."""
    sims = _fleet(p, stops, 2, service_ms=0)
    r = _router(p, sims)
    d = _keys(1, "spill")[0]
    owner = r.ring.owner(d)
    r.replica(owner).inflight = 20
    status, raw, extra = r.route(SCAN, _scan_body(d, _idem("spill")))
    return {"owner": owner, "status": status, "raw": raw, "extra": extra,
            "books": _books(p)}


def case_drain_overlay(p, stops):
    """A draining owner answers 503 once; the router marks it, fails
    over with the same body and keeps the ring whole."""
    sims = _fleet(p, stops, 2, service_ms=0)
    r = _router(p, sims)
    d = _owned(r.ring, "s0", "drain")
    sims[0].drain()
    first = r.route(SCAN, _scan_body(d, _idem("d1")))
    books1 = _books(p)
    second = r.route(SCAN, _scan_body(d, _idem("d2")))
    return {"first": first, "second": second, "books1": books1,
            "books": _books(p), "ring": r.ring.nodes(),
            "draining": r.replica("s0").draining,
            "rejects": [s.counters["drained_rejects"] for s in sims]}


def case_conn_failover(p, stops):
    """A dead owner: the same raw body (the same idempotency key)
    replayed on the next owner."""
    sims = _fleet(p, stops, 2, service_ms=0)
    r = _router(p, sims)
    d = _owned(r.ring, "s0", "dead")
    sims[0].stop()
    out = r.route(SCAN, _scan_body(d, _idem("dead")))
    return {"out": out, "books": _books(p),
            "survivor_keys": list(sims[1]._idem),
            "breaker": r.replica("s0").breaker.stats()["consecutive_failures"]}


def case_tenant_429(p, stops):
    """A tenant's 429 passes through untouched: no failover, its
    Retry-After on the answer."""
    sims = _fleet(p, stops, 1, service_ms=0, tenant_rate=1.0)
    r = _router(p, sims)
    d = _keys(1, "tenant")[0]
    hdr = {"Trivy-Tenant": "flooder"}
    first = r.route(SCAN, _scan_body(d, _idem("t1")), hdr)
    status, raw, extra = r.route(SCAN, _scan_body(d, _idem("t2")), hdr)
    doc = json.loads(raw)
    return {"first": first[0], "status": status, "code": doc["code"],
            "hint": doc["retry_after_s"] > 0,
            "headers": sorted(k for k, _ in extra), "books": _books(p)}


def case_fleet_drain(p, stops):
    """Every replica draining: the router's own 503, with a hint."""
    sims = _fleet(p, stops, 2, service_ms=0)
    for s in sims:
        s.drain()
    r = _router(p, sims)
    return {"out": r.route(SCAN, _scan_body(_keys(1, "x")[0], _idem("x"))),
            "books": _books(p)}


def case_saturated(p, stops):
    """A 503 ``resource_exhausted`` spills, then exhausts into the
    router's 503 carrying the upstream's shed hint."""
    stub = _Scripted([(503, {"code": "resource_exhausted",
                             "retry_after_s": 0.25}, [])])
    stops.append(stub.stop)
    r = p.core.ScanRouter([("stub", stub.url)])
    out = r.route(SCAN, _scan_body(_keys(1, "sat")[0], _idem("sat")))
    return {"out": out, "books": _books(p), "forwarded": len(stub.requests)}


def case_passthrough(p, stops):
    """A replica's 400 and 500 end the request as ``failed``; a 500
    counts against the breaker, a 400 does not; headers forwarded."""
    stub = _Scripted([(400, {"code": "malformed"}, []),
                      (500, {"code": "internal"}, [])])
    stops.append(stub.stop)
    r = p.core.ScanRouter([("stub", stub.url)], token=TOKEN)
    hdr = {"Trivy-Tenant": "t1", "Traceparent": "00-" + "a" * 32 + "-"
           + "b" * 16 + "-01", "X-Other": "no"}
    outs = [r.route(SCAN, _scan_body(d, _idem(d)), hdr)
            for d in _keys(2, "pass")]
    return {"outs": outs, "books": _books(p),
            "bodies": [b for _, b in stub.requests],
            "breaker": r.replica("stub").breaker.stats()}


def case_flaky_replay(p, stops):
    """replica-flaky drops every third forwarded response: each drop
    is replayed with the same key, every client gets one 200."""
    sims = _fleet(p, stops, 2, service_ms=0)
    inj = p.faults.FaultInjector(p.faults.parse_fault_spec("replica-flaky"))
    r = _router(p, sims, fault_injector=inj)
    outs = [r.route(SCAN, _scan_body(d, _idem(d)))
            for d in _keys(9, "flaky")]
    return {"outs": outs, "books": _books(p), "faults": inj.stats(),
            "scans": [s.counters["scans"] for s in sims],
            "deduped": [s.counters["deduped"] for s in sims]}


def case_scoped_flaky(p, stops):
    """``replica_flaky=s1`` drops only s1's answers."""
    sims = _fleet(p, stops, 2, service_ms=0)
    inj = p.faults.FaultInjector(p.faults.parse_fault_spec(
        "replica-flaky:replica_flaky_every=1,replica_flaky=s1"))
    r = _router(p, sims, fault_injector=inj)
    outs = [r.route(SCAN, _scan_body(d, _idem(d)))
            for d in _keys(6, "scoped")]
    return {"outs": outs, "books": _books(p), "faults": inj.stats()}


def case_reshard_warmth(p, stops):
    """Removing a replica moves only its keys: the survivors' digests
    stay warm (memo hits)."""
    sims = _fleet(p, stops, 3, service_ms=0)
    r = _router(p, sims)
    keys = _keys(30, "warm")
    for i, d in enumerate(keys):
        r.route(SCAN, _scan_body(d, _idem(f"w{i}")))
    r.remove_replica("s2")
    hits = [json.loads(r.route(SCAN, _scan_body(d, _idem(f"x{i}")))[1])
            ["memo_hit"] for i, d in enumerate(keys)]
    return {"hits": hits, "books": _books(p), "ring": r.ring.nodes()}


def case_keyless(p, stops):
    """A keyless Scan gets a key minted at the router (random, so only
    its presence is compared)."""
    sims = _fleet(p, stops, 1, service_ms=0)
    r = _router(p, sims)
    body = json.dumps({"target": "img:x",
                       "blob_ids": _keys(1, "mint")}).encode()
    status, _, _ = r.route(SCAN, body)
    return {"status": status, "idem": len(sims[0]._idem),
            "books": _books(p)}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_request_path_equals_the_reference(case, stops):
    got = {name: CASES[case](p, stops) for name, p in PKGS.items()}
    assert got["port"] == got["ref"]
    books = got["port"]["books"]
    # exactly-once terminal booking: the books balance at quiesce
    assert books["lost"] == 0 and books["accepted"] == books["terminal"]


def test_keyed_sequence_lands_on_the_ring_owner(stops):
    """On an idle fleet (no spill) each request lands on the port
    ``Ring``'s owner of its route key, and the header and the stamped
    body name it."""
    got = case_keyed_sequence(PKGS["port"], stops)
    for path, key, owner, status, raw, extra in got["requests"]:
        assert status == 200 and dict(extra) == \
            {tcore.ROUTED_REPLICA_HEADER: owner}
        if path == SCAN:
            assert json.loads(raw)["routed_replica"] == owner
    assert got["books"]["spills"] == 0 and got["books"]["failovers"] == 0
    assert sum(got["scans"]) == 20


# --- the prober --------------------------------------------------------

def _prober_states(p, stops):
    sims = _fleet(p, stops, 2, service_ms=0)
    r = _router(p, sims)
    prober = p.core.HealthProber(r, timeout_s=0.5)
    states = []

    def look(tag):
        states.append((tag, [(h.name, h.breaker.state, h.probe_ok,
                              h.draining, h.warming)
                             for h in r.replicas()],
                       r.stats()["routable"]))

    prober.probe_once()
    look("up")
    r.replica("s0").breaker = p.res.CircuitBreaker(fail_threshold=2,
                                                   cooldown_s=0.05)
    port = sims[0].port
    sims[0].stop()
    for _ in range(4):
        prober.probe_once()
        if r.replica("s0").breaker.state != p.res.CLOSED:
            break
    look("ejected")
    served = json.loads(r.route(SCAN, _scan_body(_keys(1, "pr")[0],
                                                 _idem("pr")))[1])
    revived = p.sim.SimReplica(name="s0", port=port).start()
    stops.append(revived.stop)
    sims[1].drain()
    time.sleep(0.06)                    # past the breaker's cooldown
    prober.probe_once()
    look("recovered")
    books = _books(p)
    return {"states": states, "served_by": served["replica"],
            "books": {k: books[k] for k in (
                "ejections", "recoveries", "probe_failures", "probes")}}


def test_prober_ejects_and_recovers_as_the_reference(stops):
    """A dead replica is ejected after its breaker opens, requests land
    on the survivor, the revived one is re-admitted by the half-open
    probe, and a drain is read off ``/healthz``: the same states."""
    got = {name: _prober_states(p, stops) for name, p in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["port"]["states"][1][2] == ["s1"]
    assert got["port"]["states"][2][2] == ["s0"]


# --- the scaler --------------------------------------------------------

def test_decide_grid_equals_the_reference():
    """``decide`` over a grid of verdicts, loads, sizes, calm counts,
    prewarming replicas and two policies."""
    out = {}
    for name, p in PKGS.items():
        rows = []
        for pol in (dict(min_replicas=1, max_replicas=3, calm_ticks=2,
                         low_inflight=0.5),
                    dict(min_replicas=2, max_replicas=8, calm_ticks=1,
                         low_inflight=2.0, require_complete=False)):
            policy = p.scaler.ScalerPolicy(**pol)
            for slo_ok in (True, False):
                for complete in (True, False):
                    for avg in (0.0, 0.4, 1.0, 5.0):
                        for n in (0, 1, 2, 3, 8):
                            for calm in (0, 1, 2, 9):
                                for warming in (0, 1):
                                    rows.append(p.scaler.decide(
                                        slo_ok, complete, avg, n, calm,
                                        policy, warming=warming))
        out[name] = rows
    assert out["port"] == out["ref"]
    assert {a for a, _ in out["port"]} == {"up", "down", "hold"}


VERDICTS = ([{"slo_ok": False, "complete": True}] * 3 +
            [{"slo_ok": True, "complete": False}] * 2 +
            [{"slo_ok": True, "complete": True}] * 5 +
            [{"slo_ok": False, "complete": True,
              "cost": {"cost_per_scan_s": 0.5}}] +
            [{"slo_ok": True, "complete": True}] * 3)


def _scaler_run(p, stops, memo_dir):
    clk = {"t": 0.0}
    ctrl = p.scaler.SimReplicaController(prefix="as", service_ms=0)
    stops.append(lambda: [ctrl.stop(n) for n in list(ctrl.replicas)])
    router = p.core.ScanRouter()
    policy = p.scaler.ScalerPolicy(min_replicas=1, max_replicas=3,
                                   calm_ticks=2, cooldown_s=5.0,
                                   low_inflight=0.5)
    scaler = p.scaler.Autoscaler(router, ctrl, policy=policy,
                                 clock=lambda: clk["t"])
    ticks = []
    for i, verdict in enumerate(VERDICTS):
        if i == 2:
            # warm the fleet so a drain has digests to hand off
            for k, d in enumerate(_keys(12, "scale")):
                router.route(SCAN, _scan_body(d, _idem(f"s{k}")))
        ev = scaler.tick(verdict)
        ticks.append((ev, [h.name for h in router.replicas()],
                      sorted(ctrl.replicas)))
        clk["t"] += 3.0
    books = _books(p)
    return {"ticks": ticks, "stats": scaler.stats(),
            "lifecycle": p.life.LIFECYCLE_METRICS.snapshot(),
            "books": {k: books[k] for k in (
                "scale_ups", "scale_downs", "scale_holds",
                "drains_started", "drain_kills", "ring_churn")}}


def test_autoscaler_ticks_equal_the_reference(stops, tmp_path):
    """``Autoscaler.tick`` over a scripted verdict sequence with
    ``SimReplicaController`` and a scripted clock: the same events,
    fleet after each tick, drains (their handoff booked in
    ``LIFECYCLE_METRICS``) and stops as the reference's."""
    got = {name: _scaler_run(p, stops, str(tmp_path / name))
           for name, p in PKGS.items()}
    assert got["port"] == got["ref"]
    actions = [ev["action"] for ev, _, _ in got["port"]["ticks"]]
    assert "up" in actions and "down" in actions
    assert got["port"]["books"]["drain_kills"] >= 1
    life = got["port"]["lifecycle"]
    assert life["handoff_published"] == \
        life["handoff_prefetched"] + life["handoff_abandoned"] > 0


# --- the drain handoff -------------------------------------------------

def _handoff(p, stops, case):
    sims = _fleet(p, stops, 3, service_ms=0)
    r = _router(p, sims)
    for i, d in enumerate(_keys(30, "hand")):
        r.route(SCAN, _scan_body(d, _idem(f"h{i}")))
    if case == "dead_successor":
        sims[2].stop()
    if case == "dead_victim":
        sims[0].stop()
    victim = "s0" if case != "unknown" else "nobody"
    r.mark_draining(victim)
    summary = p.life.run_handoff(r, victim, timeout_s=2.0)
    return {"summary": summary,
            "lifecycle": p.life.LIFECYCLE_METRICS.snapshot(),
            "warm": [sorted(s.warm_digests()) for s in sims[1:]
                     if case != "dead_successor" or s is sims[1]]}


@pytest.mark.parametrize("case", ["live", "dead_successor", "dead_victim",
                                  "unknown"])
def test_run_handoff_equals_the_reference(case, stops):
    """``run_handoff``: the victim's hot digests pulled, planned on the
    victim-less ring and pushed to each successor; its summary, the
    successors' warm sets and every digest booked exactly once
    (prefetched or abandoned)."""
    got = {name: _handoff(p, stops, case) for name, p in PKGS.items()}
    assert got["port"] == got["ref"]
    s = got["port"]["summary"]
    assert s["published"] == s["prefetched"] + s["abandoned"]
    life = got["port"]["lifecycle"]
    assert life["handoff_prefetched"] == s["prefetched"]
    assert life["handoff_abandoned"] == s["abandoned"]
    if case == "live":
        assert s["published"] > 0 and s["abandoned"] == 0
    if case == "dead_successor":
        assert s["abandoned"] > 0


# --- the exposition ----------------------------------------------------

def _fed_metrics(p, events) -> tuple:
    m = p.metrics.RouterMetrics()
    for kind, *args in events:
        getattr(m, kind)(*args)
    hists = m.hist_snapshot()
    for h in hists.values():        # an exemplar's unix time: fixed
        h["exemplars"] = {i: (tid, v, 1.7e9) for i, (tid, v, _) in
                          h["exemplars"].items()}
    return m.snapshot(), hists


EVENTS = ([("inc", "accepted", 7), ("inc", "ok", 5), ("inc", "failed"),
           ("inc", "unavailable"), ("inc", "forwards", 9),
           ("inc", "spills", 2), ("inc", "ring_churn", 3),
           ("inc", "scale_holds", 4), ("set_inflight", "a", 2),
           ("set_inflight", "b", 0), ("drop_replica", "b")] +
          [("observe", "route_latency", 0.001 * 3 ** k, f"t{k}")
           for k in range(9)] +
          [("observe", "upstream_latency", 0.002 * 2 ** k)
           for k in range(7)])
PROCESS = {"rss_bytes": 123456, "open_fds": 17, "threads": 9}


@pytest.mark.parametrize("lifecycle", [False, True])
def test_render_router_is_byte_equal(lifecycle):
    """``render_router`` on the same stats and histograms gives the
    reference's bytes, and ``RouterMetrics`` fed the same events gives
    the same snapshot and raw histograms."""
    fed = {name: _fed_metrics(p, EVENTS) for name, p in PKGS.items()}
    assert fed["port"] == fed["ref"]
    snap, hists = fed["port"]
    breaker = {"state": "open", "consecutive_failures": 3, "trips": 1,
               "recoveries": []}
    stats = {"router": snap, "routable": ["a"], "affinity_entries": 4,
             "replicas": [
                 {"name": "a", "url": "http://a", "draining": False,
                  "warming": True, "inflight": 2, "probed_inflight": 1,
                  "probe_ok": True, "breaker": dict(breaker,
                                                    state="closed")},
                 {"name": "b", "url": "http://b", "draining": True,
                  "warming": False, "inflight": 0, "probed_inflight": 0,
                  "probe_ok": False, "breaker": breaker}],
             "process": PROCESS}
    if lifecycle:
        stats["lifecycle"] = {"handoff_published": 5,
                              "handoff_prefetched": 4,
                              "handoff_abandoned": 1, "prewarm_keys": 2,
                              "prewarm_bytes": 80, "prewarm_seconds": 0.5,
                              "prewarm_deadline_exceeded": 0}
    text = tprom.render_router(stats, hists=hists)
    assert text == rprom.render_router(stats, hists=hists)
    assert "trivy_tpu_router_lost 0" in text
    assert ("trivy_tpu_handoff_published_total 5" in text) == lifecycle
    assert tprom.render_router({}) == rprom.render_router({})


# --- the HTTP front ----------------------------------------------------

def _http(url, path, body=None, headers=None, raw=False):
    req = urllib.request.Request(
        url + path, method="GET" if body is None else "POST",
        data=None if body is None else body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            status, data, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, data, hdrs = e.code, e.read(), e.headers
    routed = hdrs.get(tcore.ROUTED_REPLICA_HEADER)
    return status, data if raw else json.loads(data or b"{}"), routed


def _steady(doc):
    """A front's JSON without what reads clocks or the process."""
    doc = json.loads(json.dumps(doc))
    doc.pop("process", None)
    for k in ("route_latency", "upstream_latency"):
        doc.get("router", {}).pop(k, None)
    return doc


def _steady_text(text: bytes) -> list:
    return [ln for ln in text.decode().splitlines()
            if "latency" not in ln and "process" not in ln]


def _front_run(p, stops):
    sims = _fleet(p, stops, 2, service_ms=0)
    router = _router(p, sims, token=TOKEN)
    front = p.front.RouterServer(router, token=TOKEN)
    httpd, _ = p.front.serve_router(front, port=0)
    stops.append(front.close)
    stops.append(httpd.shutdown)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    auth = {"Trivy-Token": TOKEN}
    out = [_http(url, "/healthz"), _http(url, "/metrics"),
           _http(url, SCAN, _scan_body(_keys(1, "fr")[0], _idem("fr")),
                 {}),
           _http(url, SCAN, _scan_body(_keys(1, "fr")[0], _idem("fr")),
                 auth),
           _http(url, CACHE + "MissingBlobs", json.dumps(
               {"artifact_id": "a", "blob_ids": ["x"]}).encode(), auth),
           _http(url, "/replicas", headers=auth),
           _http(url, "/impact", headers=auth),
           _http(url, "/impact?cve=CVE-2024-1", headers=auth),
           _http(url, "/costs", headers=auth),
           _http(url, "/nope", headers=auth)]
    status, doc, _ = _http(url, "/metrics", headers=auth)
    out.append((status, _steady(doc)))
    status, text, _ = _http(url, "/metrics", headers={
        **auth, "Accept": "text/plain"}, raw=True)
    out.append((status, _steady_text(text)))
    # the replicas' ports are the run's own
    return json.loads(re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:P",
                             json.dumps(out)))


def test_front_routes_equal_the_reference(stops):
    """The front over two replicas with a token: ``/healthz`` open, the
    rest behind the token (401 otherwise), the twirp POST routed with
    its header, ``/replicas``, the federated ``/impact`` (400 without
    ``cve=``; a partial union over replicas that have no index) and
    ``/costs``, a 404, the JSON ``/metrics`` and the text exposition:
    each answer the reference's, the clocks left out."""
    got = {name: _front_run(p, stops) for name, p in PKGS.items()}
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port[0][1]["role"] == "router" and port[1][0] == 401
    assert port[2][0] == 401 and port[3][0] == 200 and port[3][2]
    assert port[6][0] == 400 and port[9][0] == 404
    assert "trivy_tpu_router_accepted_total 2" in port[-1][1]


# --- the route subcommand ---------------------------------------------

def _cli(pkg, argv) -> tuple:
    from trivy_tpu.cli import main as rmain
    from trivy_tpu_torch.cli import main as tmain
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = (rmain if pkg == "ref" else tmain)(argv)
    return code, [ln for ln in err.getvalue().splitlines()
                  if ln.startswith("error:")]


@pytest.mark.parametrize("argv", [
    ["--listen", "nowhere"],
    ["--replicas", "a=ftp://x:1"],
    [],
    ["--replicas", "a=http://127.0.0.1:1", "--fault-spec", "cache-outage"],
    ["--replicas", "a=http://127.0.0.1:1", "--fault-spec", "no-such"],
    ["--replicas", "a=http://127.0.0.1:1", "--vnodes", "0"],
    ["--replicas", "a=http://127.0.0.1:1", "--capacity-factor", "1.0"],
])
def test_route_cli_errors_equal_the_reference(argv, monkeypatch):
    """Each malformed ``route`` exits with the reference's code and its
    one ``error:`` line, before it listens."""
    for p in PKGS.values():
        monkeypatch.setattr(p.front, "serve_router", _no_listen)
    got, want = _cli("port", ["route"] + argv), _cli("ref", ["route"] + argv)
    assert got == want and got[0] in (1, 2) and len(got[1]) == 1


def _no_listen(*a, **k):
    raise AssertionError("the route CLI listened")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _route_proc(argv, stops):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch", "route", "--listen",
         f"127.0.0.1:{port}", "--token", TOKEN, "--probe-interval",
         "0.2"] + argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)

    def kill():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stops.append(kill)
    line = proc.stdout.readline()
    assert line.startswith("trivy-tpu router listening on"), line
    return proc, f"http://127.0.0.1:{port}"


def _children(pid: int) -> list:
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/status") as f:
                    ppid = next(int(ln.split()[1]) for ln in f
                                if ln.startswith("PPid:"))
            except (OSError, StopIteration):
                continue
            if ppid == pid:
                out.append(int(d))
    return out


def test_route_cli_fronts_replicas_and_exits_on_sigterm(stops):
    """``python -m trivy_tpu_torch route --replicas a=URL,b=URL``: Scans
    through it land on the ring owner with the header, the books
    balance on ``/metrics``, SIGTERM exits 0."""
    sims = _fleet(PKGS["port"], stops, 2, service_ms=0)
    proc, url = _route_proc(["--replicas", ",".join(
        f"{s.name}={s.url}" for s in sims)], stops)
    from trivy_tpu_torch.router.ring import Ring
    ring = Ring()
    for s in sims:
        ring.add(s.name)
    auth = {"Trivy-Token": TOKEN}
    for i, d in enumerate(_keys(8, "cli")):
        status, doc, routed = _http(url, SCAN, _scan_body(d, _idem(i)), auth)
        assert status == 200 and routed == doc["routed_replica"] == \
            ring.owner(d)
    _, doc, _ = _http(url, "/metrics", headers=auth)
    r = doc["router"]
    assert r["accepted"] == r["ok"] == 8 and r["lost"] == 0
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0


def test_route_cli_subprocess_scaler_kill_mid_storm(stops):
    """``route --scaler subprocess --scaler-min 2`` brings up two sim
    replicas of the port (``python -m trivy_tpu_torch.router.sim``);
    one is hard-killed at ``replica-kill``'s seeded instant in a storm:
    every request ends 200, the books balance, and SIGTERM stops the
    front and its replicas."""
    proc, url = _route_proc(["--scaler", "subprocess", "--scaler-min",
                             "2", "--scaler-interval", "60"], stops)
    kids = _children(proc.pid)
    assert len(kids) == 2
    for k in kids:
        with open(f"/proc/{k}/cmdline", "rb") as f:
            assert b"trivy_tpu_torch.router.sim" in f.read().split(b"\0")
    inj = tfaults.FaultInjector("replica-kill:replica_kill_after=10")
    auth = {"Trivy-Token": TOKEN}
    statuses, lock, done = [], threading.Lock(), [0]

    def worker(chunk):
        for d in chunk:
            status, _, _ = _http(url, SCAN, _scan_body(d, _idem(d)), auth)
            with lock:
                statuses.append(status)
                done[0] += 1
                if inj.replica_kill_due(done[0]):
                    os.kill(kids[0], signal.SIGKILL)

    keys = _keys(40, "storm")
    threads = [threading.Thread(target=worker, args=(keys[i::4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert inj.counters["replica_kills"] == 1
    assert statuses == [200] * 40
    _, doc, _ = _http(url, "/metrics", headers=auth)
    r = doc["router"]
    assert r["accepted"] == r["ok"] == 40 and r["lost"] == 0
    assert r["conn_errors"] >= 1 and r["replays"] >= 1
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0
    assert not [k for k in kids if os.path.exists(f"/proc/{k}")
                and "zombie" not in open(f"/proc/{k}/status").read()]


def test_route_spec_drops_through_the_cli(stops):
    """``route --fault-spec replica-flaky:replica_flaky_every=2`` in
    front of one replica: each dropped answer ends the request 503 at
    the router (no other owner), and the client's retry with the same
    key is answered from the replica's idempotency window."""
    sims = _fleet(PKGS["port"], stops, 1, service_ms=0)
    proc, url = _route_proc(["--replicas", f"s0={sims[0].url}",
                             "--fault-spec",
                             "replica-flaky:replica_flaky_every=2"], stops)
    auth = {"Trivy-Token": TOKEN}
    out = []
    for i, d in enumerate(_keys(3, "drop")):
        for _ in range(2):              # the client's retry, same key
            status, doc, _ = _http(url, SCAN, _scan_body(d, _idem(i)), auth)
            out.append((status, doc.get("deduped", False)))
            if status == 200:
                break
    assert out == [(200, False), (503, False), (200, True), (503, False),
                   (200, True)]
    assert sims[0].counters["scans"] == 3 and \
        sims[0].counters["deduped"] == 2
    _, doc, _ = _http(url, "/metrics", headers=auth)
    r = doc["router"]
    assert r["lost"] == 0 and r["accepted"] == 5 and r["ok"] == 3 and \
        r["unavailable"] == 2
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0


# --- the sim replica ---------------------------------------------------

def _sim_run(p, stops):
    sim = p.sim.SimReplica(name="x", service_ms=0, flaky_every=3,
                           hot_cap=4).start()
    stops.append(sim.stop)
    out = []
    for i, d in enumerate(_keys(6, "sim") + _keys(2, "sim")):
        out.append(sim.scan(json.loads(_scan_body(d, _idem(i))), ""))
    out.append(sim.scan(json.loads(_scan_body(_keys(1, "sim")[0],
                                              _idem(0))), ""))
    out.append(sim.scan({"blob_ids": ["h"], "hostile": True,
                         "target": "evil"}, "t"))
    for path, body in ((CACHE + "PutBlob", {"diff_id": "d1"}),
                       (CACHE + "MissingBlobs", {"blob_ids": ["d1", "d2"]}),
                       (CACHE + "DeleteBlobs", {"blob_ids": ["d1"]}),
                       (CACHE + "MissingBlobs", {"blob_ids": ["d1"]})):
        out.append(sim.cache_op(path, body))
    out.append(sim.chaos({"service_ms": 0, "db_generation": 2}))
    out.append(sim.handoff())
    out.append(sim.prefetch({"digests": ["p1", "p2"]}))
    sim.drain()
    out.append(sim.scan(json.loads(_scan_body("sha256:z", "k")), ""))
    out.append(sim.health())
    m = sim.metrics()
    m.pop("process")
    m.pop("slo")
    out.append(m)
    out.append(sorted(sim.metrics_snapshot()))
    status, doc, _ = _http(sim.url, "/healthz")
    out.append((status, doc))
    return json.loads(json.dumps(out))


def test_sim_replica_equals_the_reference(stops):
    """The port's ``SimReplica`` answers the same scans (memo warmth,
    the idempotency window, flaky drops, the hostile trickle), cache
    ops, chaos, handoff, prefetch, drain and health as the
    reference's."""
    got = {name: _sim_run(p, stops) for name, p in PKGS.items()}
    assert got["port"] == got["ref"]


# --- real scan servers behind the front (the CPU) ----------------------

def _servers_run(pkg_name, stops):
    """Two in-process scan servers behind the package's front: a direct
    scan, the routed one, then a drain of the serving replica and the
    same scan again through the front."""
    import tests.test_torch_rpc as trpc
    P = trpc.PORT if pkg_name == "port" else trpc.REF
    p = PKGS[pkg_name]
    servers, replicas = [], []
    for i in range(2):
        kw = {"backend": "cpu"} if pkg_name == "port" else {}
        srv = P["server"].ScanServer(store=trpc._store(P), token="s3cret",
                                     **kw)
        httpd, _ = P["server"].serve(port=0, server=srv)
        stops.append(srv.close)
        stops.append(httpd.shutdown)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        servers.append(srv)
        replicas.append((f"r{i}", url))
        P["client"].RemoteCache(url, token="s3cret", max_retries=2,
                                backoff_base_s=0.01).put_blob(
            "sha256:blob1", trpc._blob(P))
    router = p.core.ScanRouter(replicas, token="s3cret")
    front = p.front.RouterServer(router, token="s3cret")
    httpd_r, _ = p.front.serve_router(front, port=0)
    stops.append(front.close)
    stops.append(httpd_r.shutdown)
    router_url = f"http://127.0.0.1:{httpd_r.server_address[1]}"
    direct = P["client"].RemoteScanner(replicas[0][1], token="s3cret",
                                       max_retries=2).scan(
        trpc._target(P), trpc._options(P))
    scanner = P["client"].RemoteScanner(router_url, token="s3cret",
                                        max_retries=4, backoff_base_s=0.01)
    routed = scanner.scan(trpc._target(P), trpc._options(P))
    serving = scanner.last_routed_replica
    servers[int(serving[1:])].begin_drain()
    again = scanner.scan(trpc._target(P), trpc._options(P))
    p.core.HealthProber(router).probe_once()
    books = _books(p)
    return {"direct": trpc._doc(*direct), "routed": trpc._doc(*routed),
            "again": trpc._doc(*again), "serving": serving,
            "after": scanner.last_routed_replica,
            "draining": router.replica(serving).draining,
            "books": {k: books[k] for k in (
                "accepted", "ok", "drain_redirects", "failovers",
                "replays", "lost")}}


def test_routed_scan_through_servers_equals_direct_and_the_reference(stops):
    """One routed Scan through two port ``ScanServer``s on the CPU: the
    report equals the direct scan's and the reference's in-process
    report; draining the serving replica fails the same scan over to
    the other with an equal report and no loss — as the reference's
    router does in front of its servers."""
    import tests.test_torch_rpc as trpc
    got = {name: _servers_run(name, stops) for name in PKGS}
    want = trpc._in_process()
    port = got["port"]
    assert port["direct"] == port["routed"] == port["again"] == want
    assert got["ref"]["routed"] == want
    assert port["serving"] in ("r0", "r1") and port["after"] != \
        port["serving"] and port["draining"]
    assert port == got["ref"]
    assert port["books"]["lost"] == 0 and port["books"]["replays"] == 1


# --- the client's routed-replica satellite -----------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_routed_replica_surfaced_on_the_client(pkg, stops):
    """Either package's ``RemoteScanner`` keeps the replica a router
    named (the stamped body over the header)."""
    import tests.test_torch_rpc as trpc
    P = trpc.PORT if pkg == "port" else trpc.REF
    stub = _Scripted([(200, {"results": [], "os": {"family": "sim",
                                                   "name": "0"},
                             "routed_replica": "r4"},
                       [(tcore.ROUTED_REPLICA_HEADER, "r9")])])
    stops.append(stub.stop)
    scanner = P["client"].RemoteScanner(stub.url, max_retries=2)
    results, _ = scanner.scan(trpc._target(P), trpc._options(P))
    assert results == [] and scanner.last_routed_replica == "r4"


def test_sim_build_info_names_torch_not_jax():
    """The one departure of the port's sim: its build identity names the
    torch and CUDA versions (empty: a sim runs no torch), as the port's
    server does, where the reference's names ``jax_version``."""
    got, want = tsim.SimReplica().build_info(), rsim.SimReplica().build_info()
    assert got == {"version": "sim", "torch_version": "",
                   "cuda_version": "", "backend": "sim", "sched": "sim"}
    assert {k: v for k, v in want.items() if k != "jax_version"} == \
        {k: v for k, v in got.items()
         if k not in ("torch_version", "cuda_version")}


def test_fs_cache_writers_of_one_key_do_not_collide(tmp_path):
    """Replicas behind one router share a blob directory, and sessions
    push the same shared layer at once: concurrent writers of one key
    (threads here, processes there) each write through a temporary file
    of their own, so none fails and the entry reads back whole."""
    import trivy_tpu_torch.types.artifact as tart
    from trivy_tpu_torch.artifact.cache import FSCache
    blob = tart.BlobInfo(os=tart.OS(family="alpine", name="3.9.4"),
                         package_infos=[tart.PackageInfo(packages=[
                             tart.Package(name=f"p{i}", version="1.0")
                             for i in range(400)])])
    caches = [FSCache(str(tmp_path)) for _ in range(2)]
    errors = []

    def put(cache):
        try:
            for _ in range(40):
                cache.put_blob("sha256:shared", blob)
        except Exception as e:      # noqa: BLE001 — asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=put, args=(caches[i % 2],))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert caches[1].get_blob("sha256:shared").to_dict() == blob.to_dict()
    assert sorted(os.listdir(tmp_path / "fanal" / "blob")) == \
        ["sha256_shared.json"]
