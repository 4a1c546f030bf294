"""The fleet plane: SLO and cost federation (``obs/slo.py``,
``obs/cost.py``), ``obs/federate.py`` and the server's
``/metrics/snapshot``, ``/metrics/federate`` and fleet ``/slo``, the
clock half of ``obs/propagate.py`` with ``GET /clock``, the ambient
trace context of ``runtime/batch.py`` and the simhost keys, against
the JAX package's (JAX on the CPU) in the same process.

Both packages get the same events, exports, snapshots and peers: the
same clock (a fixed monotonic reading patched into each SLO module), the
same injected transports. Exports, merges, verdicts, rows and merged
expositions must be equal byte for byte.
"""

import importlib
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tests.test_sched import _norm, make_fleet
from tests.torch_threads import one_torch_thread  # noqa: F401

PKGS = ("ref", "port")
BACKEND = {"ref": "cpu-ref", "port": "cpu"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "s3cret"
NOW = 123456.7


def _mod(pkg, name):
    root = "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _js(doc) -> str:
    return json.dumps(doc, sort_keys=True)


class _Clock:
    """A ``time`` stand-in whose monotonic reading the test sets."""

    def __init__(self, now: float):
        self.now = now

    def monotonic(self) -> float:
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    """Each package's SLO module reads this clock."""
    out = {}
    for pkg in PKGS:
        out[pkg] = _Clock(NOW)
        monkeypatch.setattr(_mod(pkg, "obs.slo"), "time", out[pkg])
    return out


def _engines(pkg):
    slo = _mod(pkg, "obs.slo")
    slos = [slo.SLO(name="avail", objective=0.99),
            slo.SLO(name="lat", kind="latency", objective=0.95,
                    threshold_s=0.5)]
    return [slo.SloEngine(list(slos)) for _ in range(3)]


def _feed(pkg, clock, seed: int):
    """Two replicas' seeded events over an hour of ticks, and a third
    engine fed their union."""
    a, b, union = _engines(pkg)
    rng = np.random.default_rng(seed)
    clock.now = NOW - 3600.0
    for i in range(200):
        clock.now += float(rng.uniform(0.0, 18.0))
        eng = a if rng.random() < 0.6 else b
        out = ("ok", "failed", "timed_out")[int(rng.integers(0, 8)) % 3
                                           if rng.random() < 0.2 else 0]
        lat = float(rng.uniform(0.0, 1.0))
        tid = f"{i:032x}" if out != "ok" else ""
        eng.record(out, latency_s=lat, trace_id=tid)
        union.record(out, latency_s=lat, trace_id=tid)
    clock.now = NOW
    return a, b, union


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_export_merge_and_verdicts_equal_reference(clocks, seed):
    """Each replica's export, their merge and the verdicts over it are
    byte-equal across packages, and equal to one engine fed the union
    of the events."""
    out = {}
    for pkg in PKGS:
        slo = _mod(pkg, "obs.slo")
        a, b, union = _feed(pkg, clocks[pkg], seed)
        exports = [a.export_state(now=NOW), b.export_state(now=NOW)]
        merged = slo.merge_exports(exports)
        fed = slo.verdicts_from_export(merged, now=NOW)
        one = slo.verdicts_from_export(union.export_state(now=NOW),
                                       now=NOW)
        # the merge keeps each replica's exemplars in turn, the union
        # engine the worst overall: the verdicts agree on the rest
        assert [{k: v for k, v in x.items() if k != "exemplar_trace_ids"}
                for x in fed] == \
            [{k: v for k, v in x.items() if k != "exemplar_trace_ids"}
             for x in one]
        out[pkg] = _js([exports, merged, fed, a.export_state()])
    assert out["port"] == out["ref"]


def test_slo_merge_edge_cases_equal_reference(clocks):
    """Malformed exports are dropped, the first definition of a name
    wins, exemplars dedupe and cap, ages sum; an efficiency SLO
    federates as any other kind."""
    export = {"bucket_s": 10.0, "slos": [{
        "slo": {"name": "s", "kind": "availability", "objective": 0.99},
        "good": 5, "bad": 2, "buckets": [[0, 5, 2], [3, 1, 0]],
        "exemplar_trace_ids": [f"{i:08x}" for i in range(12)]}]}
    other = {"slos": [{"slo": {"name": "s", "objective": 0.5},
                       "good": 1, "bad": 0, "buckets": [[3, 1, 1]]}]}
    out = {}
    for pkg in PKGS:
        slo = _mod(pkg, "obs.slo")
        merged = slo.merge_exports([None, {}, {"slos": "nope"},
                                    {"slos": [{"slo": {}}, 3]}, export,
                                    json.loads(json.dumps(export)), other])
        spec = "goodput:kind=efficiency,objective=0.5"
        a = slo.SloEngine(slos=slo.parse_slo_config(spec))
        b = slo.SloEngine(slos=slo.parse_slo_config(spec))
        a.record_device(0.9, idle_s=0.1)
        b.record_device(0.1, idle_s=0.9)
        eff = slo.verdicts_from_export(
            slo.merge_exports([a.export_state(), b.export_state()]))
        out[pkg] = _js([merged, slo.verdicts_from_export(merged, now=NOW),
                        eff, slo.verdicts_from_export({})])
    assert out["port"] == out["ref"]
    merged = json.loads(out["port"])[0]
    assert merged["slos"][0]["good"] == 11
    assert merged["slos"][0]["slo"]["objective"] == 0.99
    assert merged["slos"][0]["buckets"] == [[0, 10, 4], [3, 3, 1]]
    assert len(merged["slos"][0]["exemplar_trace_ids"]) == 8
    assert json.loads(out["port"])[2][0]["efficiency"] == 0.5


# --- cost federation -------------------------------------------------

def _cost_export(pkg, tenant, dev, age="0"):
    vec = dict.fromkeys(_mod(pkg, "obs.cost").VECTOR_KEYS, 0.0)
    vec["device_interval_s"] = dev
    return {"schema": 1, "bucket_s": 10.0, "cum": {tenant: dict(vec)},
            "buckets": {age: {tenant: dict(vec)}}}


def test_merge_cost_exports_equal_reference():
    """Sums by tenant and age, malformed entries dropped, the fleet-wide
    fold past the tenant cap."""
    out = {}
    for pkg in PKGS:
        cost = _mod(pkg, "obs.cost")
        exports = [_cost_export(pkg, "alice", 1.0),
                   _cost_export(pkg, "alice", 2.0),
                   _cost_export(pkg, "bob", 4.0, age="2"),
                   None, 42, {"cum": {"a": "nope"},
                              "buckets": {"x": 3, "0": {"b": None}}}]
        exports += [_cost_export(pkg, f"t{i}", 1.0)
                    for i in range(cost.MAX_COST_TENANTS + 8)]
        out[pkg] = _js(cost.merge_cost_exports(exports))
    assert out["port"] == out["ref"]
    merged = json.loads(out["port"])
    assert merged["cum"]["alice"]["device_interval_s"] == 3.0
    assert "other" in merged["cum"]


def _cost_answer(pkg, tenant, dev, measured):
    vec = dict.fromkeys(_mod(pkg, "obs.cost").VECTOR_KEYS, 0.0)
    vec["device_interval_s"] = dev
    return {"export": {"schema": 1, "bucket_s": 10.0,
                       "cum": {tenant: vec}, "buckets": {}},
            "measured_device_s": measured, "complete": True}


@pytest.mark.parametrize("case", ["all_up", "one_down"])
def test_federated_costs_equal_reference(case):
    """All replicas up: the books sum and balance; one down: a partial
    rollup with ``complete: false``, never an error."""
    out = {}
    for pkg in PKGS:
        answers = {"http://a": _cost_answer(pkg, "alice", 1.0, 1.0),
                   "http://b": _cost_answer(pkg, "bob", 2.0, 2.0)}

        def fetch(url):
            if case == "one_down" and url == "http://b":
                raise OSError("connection refused")
            return answers[url]
        out[pkg] = _js(_mod(pkg, "obs.cost").federated_costs(
            [("a", "http://a"), ("b", "http://b")], fetch=fetch))
    assert out["port"] == out["ref"]
    doc = json.loads(out["port"])
    assert doc["complete"] is (case == "all_up")
    assert doc["tenants"]["alice"]["device_s"] == 1.0


def test_federated_costs_over_http_equal_reference():
    """``federated_costs`` over a port server's and a reference
    server's ``/costs`` answers the same in both packages, and a dead
    replica makes it partial."""
    servers, urls = [], []
    for pkg in PKGS:
        srv, url, stop = _serve(pkg, replica_name=f"{pkg}-1")
        servers.append(stop)
        urls.append((pkg, url))
    try:
        reps = urls + [("dead", "http://127.0.0.1:9")]
        out = {pkg: _mod(pkg, "obs.cost").federated_costs(
            reps, token=TOKEN, timeout_s=2.0) for pkg in PKGS}
    finally:
        for stop in servers:
            stop()
    for doc in out.values():
        for r in doc["replicas"]:
            r["error"] = bool(r["error"])
    assert out["port"] == out["ref"]
    assert out["port"]["complete"] is False


# --- the federator ---------------------------------------------------

def _snap(pkg, name="peer", engine=None):
    return {"name": name, "build_info": {"version": "t"},
            "prom": "# HELP up Up.\n# TYPE up gauge\nup 1\n"
                    f'# TYPE hits counter\nhits{{kind="{name}"}} 3\n',
            "slo_export": (engine.export_state(now=NOW) if engine
                           else {"bucket_s": 10.0, "slos": []}),
            "mono": 0.0}


def _federator(pkg, fetch, peers=None, **kw):
    return _mod(pkg, "obs.federate").Federator(
        peers or [("p1", "http://a"), ("p2", "http://b")], fetch=fetch,
        **kw)


def test_federator_rows_render_and_fleet_equal_reference(clocks):
    """An unreachable peer is a down row, never an error; a peer that
    went down serves its last snapshot until it is stale; the breaker
    skips a peer past its threshold; rows, the fleet verdicts and the
    rendered exposition are byte-equal across packages."""
    out = {}
    for pkg in PKGS:
        clock = [0.0]
        healthy = {"http://a": True, "http://b": False}
        calls = []
        a, b, _ = _feed(pkg, clocks[pkg], 3)

        def fetch(url, a=a, b=b):
            calls.append(url)
            if not healthy[url]:
                raise OSError("connection refused")
            return _snap(pkg, url[-1], a if url.endswith("a") else b)

        fed = _federator(pkg, fetch, stale_after_s=30.0,
                         fail_threshold=2, cooldown_s=3600.0,
                         clock=lambda: clock[0])
        seq = []
        for t, up_a in ((0.0, True), (10.0, False), (20.0, False),
                        (100.0, False)):
            clock[0] = t
            healthy["http://a"] = up_a
            rows = fed.collect()
            fleet = fed.fleet_slo(b.export_state(now=NOW), rows, now=NOW)
            text = fed.render("front", "# TYPE l gauge\nl 1\n", rows,
                              fleet=fleet)
            seq.append((rows, fleet, text))
        stats = fed.stats()
        stats["last_scrape_s"] = 0.0
        out[pkg] = (_js(seq), _js(stats), sorted(calls))
    assert out["port"] == out["ref"]
    seq = json.loads(out["port"][0])
    rows0, fleet0, text0 = seq[0]
    assert [r["up"] for r in rows0] == [True, False]
    assert fleet0["complete"] is False
    assert 'trivy_tpu_federate_peer_up{replica="p2"} 0' in text0
    assert 'hits{replica="p1",kind="a"} 3' in text0
    assert seq[1][0][0]["snapshot"] is not None and \
        not seq[1][0][0]["stale"]
    assert seq[3][0][0]["stale"] and seq[3][0][0]["skipped"]
    assert seq[3][0][0]["breaker"] == "open"


def test_federation_helpers_equal_reference():
    """``parse_peers`` (and its errors), the replica label's cleaning,
    the cardinality fold and ``merge_expositions`` on seeded
    expositions, byte for byte."""
    rng = np.random.default_rng(9)
    parts = []
    for r in range(3):
        lines = []
        for fam in ("m", "h", "g"):
            kind = {"m": "counter", "h": "histogram", "g": "gauge"}[fam]
            if rng.random() < 0.8:
                lines.append(f"# HELP {fam} {fam} help {r}")
            lines.append(f"# TYPE {fam} {kind}")
            if fam == "h":
                lines += [f'h_bucket{{le="+Inf"}} {r}', f"h_sum {r}.5",
                          f"h_count {r}"]
            else:
                lines.append(f'{fam}{{x="{int(rng.integers(0, 9))}"}} {r}')
        lines += ["# EOF", "", 'deep{replica="z"} 1']
        parts.append((f"r{r}", "\n".join(lines)))
    out = {}
    for pkg in PKGS:
        f = _mod(pkg, "obs.federate")
        errors = []
        for bad in ("=:::", "x=ftp://nope", "justaname=", "name=not a url"):
            try:
                f.parse_peers(bad)
            except ValueError as e:
                errors.append(str(e))
        fed = f.Federator([(f"p{i}", f"http://h{i}")
                           for i in range(f.MAX_REPLICAS + 5)],
                          fetch=lambda u: {})
        out[pkg] = _js([
            f.parse_peers("a=http://h1:1,http://h2:2 b=https://h3"),
            f.parse_peers([("p1", "http://a:1"), ("", "http://b:2"),
                           "c=http://c:3"]),
            errors,
            [f._clean_replica(n) for n in ('evil"le} 1\n', "", "x" * 200,
                                           "ok.name-1")],
            sorted({p.name for p in fed.peers}),
            f.merge_expositions(parts),
            f._inject_replica('up{replica="deep"} 1', "front")])
    assert out["port"] == out["ref"]
    doc = json.loads(out["port"])
    assert len(doc[2]) == 4 and "other" in doc[4]
    assert 'h_bucket{replica="r1",le="+Inf"} 1' in doc[5]


# --- the HTTP surface ------------------------------------------------

def _serve(pkg, **kw):
    server = _mod(pkg, "rpc.server")
    if pkg == "port":
        kw.setdefault("backend", "cpu")
    kw.setdefault("token", TOKEN)
    srv = server.ScanServer(**kw)
    httpd, worker = server.serve(port=0, server=srv)

    def stop():
        httpd.shutdown()
        httpd.server_close()
        if worker is not None:
            worker.stop()
        srv.close()
    return srv, f"http://127.0.0.1:{httpd.server_address[1]}", stop


def _get(url, path, token=TOKEN):
    req = urllib.request.Request(url + path)
    if token:
        req.add_header("Trivy-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = resp.read().decode()
            ctype = resp.headers.get("Content-Type", "")
            return resp.status, json.loads(body) \
                if ctype.startswith("application/json") else body
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.mark.parametrize("peer_pkg", PKGS)
def test_snapshot_and_federate_end_to_end(peer_pkg):
    """A port front federating a peer of either package: the peer's
    ``/metrics/snapshot`` carries the reference's keys, the front's
    ``/metrics/federate`` both replicas' samples under ``replica``
    labels and the federation families, ``/slo`` the fleet verdicts
    over both exports, ``/metrics`` the federation stats; both routes
    are token-gated. The reference's front answers the same shape."""
    _, p_url, p_stop = _serve(peer_pkg)
    stops = [p_stop]
    try:
        seen = {}
        for pkg in PKGS:
            fed = _mod(pkg, "obs.federate").Federator(
                [("peerA", p_url)], token=TOKEN)
            _, f_url, f_stop = _serve(pkg, replica_name="front",
                                      federator=fed)
            stops.append(f_stop)
            code, snap = _get(p_url, "/metrics/snapshot")
            assert code == 200
            assert {"name", "build_info", "prom", "slo_export",
                    "cost_export", "mono"} <= set(snap)
            code, text = _get(f_url, "/metrics/federate")
            assert code == 200
            for needle in ('replica="front"', 'replica="peerA"',
                           'trivy_tpu_federate_peer_up{replica="peerA"} 1',
                           "trivy_tpu_fleet_complete 1",
                           "trivy_tpu_federate_peers 1"):
                assert needle in text, needle
            code, slo = _get(f_url, "/slo")
            fleet = slo["fleet"]
            slo_mod = _mod(pkg, "obs.slo")
            want = slo_mod.verdicts_from_export(slo_mod.merge_exports(
                [_get(f_url, "/metrics/snapshot")[1]["slo_export"],
                 snap["slo_export"]]))
            assert [(v["name"], v["good"], v["bad"], v["ok"])
                    for v in fleet["slos"]] == \
                [(v["name"], v["good"], v["bad"], v["ok"]) for v in want]
            assert fleet["complete"] is True and fleet["replicas"] == 2
            code, metrics = _get(f_url, "/metrics")
            assert metrics["federation"]["peers"] == 1
            assert metrics["federation"]["scrapes"] >= 2
            seen[pkg] = (sorted(fleet), sorted(fleet["peers"][0]),
                         [_get(f_url, p, token="")[0]
                          for p in ("/metrics/snapshot",
                                    "/metrics/federate", "/clock")])
        assert seen["port"] == seen["ref"]
        assert seen["port"][2] == [401, 401, 401]
    finally:
        for stop in stops:
            stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_federate_404_clock_and_a_dead_peer(pkg):
    """Without peers ``/metrics/federate`` is 404 (and ``/slo`` has no
    ``fleet``); ``/clock`` reads the monotonic clock; a dead peer is
    federated partially: down, stale, ``trivy_tpu_fleet_complete 0``."""
    _, url, stop = _serve(pkg)
    fed = _mod(pkg, "obs.federate").Federator(
        [("ghost", "http://127.0.0.1:9")], timeout_s=0.3)
    _, f_url, f_stop = _serve(pkg, replica_name="front", federator=fed,
                              token="")
    try:
        code, doc = _get(url, "/metrics/federate")
        assert (code, doc["code"]) == (404, "bad_route")
        assert "fleet" not in _get(url, "/slo")[1]
        before = time.monotonic()
        code, doc = _get(url, "/clock")
        assert code == 200 and before <= doc["mono"] <= time.monotonic()
        code, text = _get(f_url, "/metrics/federate", token="")
        assert code == 200
        assert 'trivy_tpu_federate_peer_up{replica="ghost"} 0' in text
        assert 'trivy_tpu_federate_peer_stale{replica="ghost"} 1' in text
        assert "trivy_tpu_fleet_complete 0" in text
        assert _get(f_url, "/slo", token="")[1]["fleet"]["complete"] is False
    finally:
        stop()
        f_stop()


def test_server_federate_flags_equal_reference(tmp_path):
    """A malformed ``--federate-peers`` exits 2 with the reference's
    line; ``--impact-index`` without the memo exits 2 as the
    reference's."""
    from tests.test_torch_rpc import _main
    cases = (["--federate-peers", "x=ftp://nope"],
             ["--impact-index", "--no-memo"])
    for argv in cases:
        got = {}
        for pkg in PKGS:
            extra = ["--backend", "cpu"] if pkg == "port" else []
            code, _, err = _main(_mod(pkg, "cli").main, [
                "server", "--listen", "127.0.0.1:1", "--sched", "off",
                "--cache-dir", str(tmp_path / pkg)] + argv + extra)
            got[pkg] = (code, [ln for ln in err.splitlines()
                               if ln.startswith("error:")])
        assert got["port"] == got["ref"]
        assert got["port"][0] == 2 and got["port"][1]


# --- the clock -------------------------------------------------------

def test_clock_offset_and_port_file_across_packages(tmp_path):
    """Each package's ``ClockClient`` reads the other's ``ClockServer``
    through the port file; on one machine's monotonic clock the
    estimate lies within its bound, which is half the best round trip;
    a port file that never appears times out in both; a skewed probe
    is recovered within the bound."""
    for srv_pkg, cli_pkg in (("ref", "port"), ("port", "ref")):
        sp = _mod(srv_pkg, "obs.propagate")
        cp = _mod(cli_pkg, "obs.propagate")
        srv = sp.ClockServer()
        try:
            path = str(tmp_path / f"{srv_pkg}.port")
            srv.write_port_file(path)
            assert cp.read_port_file(path) == srv.port
            cli = cp.ClockClient("127.0.0.1", srv.port)
            est = cp.estimate_offset(cli.probe, samples=5)
            cli.close()
            assert est.samples == 5 and srv.requests >= 5
            assert est.error_bound_s == est.rtt_s / 2.0
            assert abs(est.offset_s) <= est.error_bound_s + 0.05
        finally:
            srv.close()
        srv.close()                 # idempotent
        with pytest.raises(TimeoutError):
            cp.read_port_file(str(tmp_path / "never.port"), timeout_s=0.1)
        est = cp.estimate_offset(lambda: time.monotonic() + 42.5, 6)
        assert abs(est.offset_s + 42.5) <= est.error_bound_s + 1e-3
    _, url, stop = _serve("port")
    try:
        est = _mod("port", "obs.propagate").estimate_offset(
            _mod("ref", "obs.propagate").http_clock_probe(url, token=TOKEN),
            samples=4)
    finally:
        stop()
    assert abs(est.offset_s) <= est.error_bound_s + 0.05


# --- the ambient trace context ----------------------------------------

def _tree(pkg, tmp_path, sched: str):
    """Scans of a two-image fleet under an active span: the scan roots
    (and, direct, their children) as (name, parent is the ambient span,
    trace is the ambient trace)."""
    from tests.test_sched import make_store
    paths = make_fleet(tmp_path, 2)
    tracer = _mod(pkg, "obs.trace").get_tracer()
    tid = ("fb" if pkg == "ref" else "fc") * 16
    root = tracer.start_span("fleet", trace_id=tid)
    store = make_store() if pkg == "ref" else _port_store()
    runner = _mod(pkg, "runtime").BatchScanRunner(
        store=store, backend=BACKEND[pkg], sched=sched)
    try:
        with root.activate():
            res = runner.scan_paths(list(paths))
    finally:
        runner.close()
    root.end()
    spans = tracer.recorder.get(tid) or []
    roots = sorted((s.name, s.parent_id == root.span_id, s.trace_id == tid)
                   for s in spans if s.is_root and s.name == "scan")
    return roots, _norm(res)


def _port_store():
    store = _mod("port", "db").AdvisoryStore()
    store.put_advisory("alpine 3.16", "pkg1", "CVE-2099-0001",
                       {"FixedVersion": "2.0.0-r0"})
    store.put_vulnerability("CVE-2099-0001", {"Severity": "HIGH"})
    return store


@pytest.mark.parametrize("sched", ["off", "on"])
def test_ambient_context_span_trees_equal_reference(sched, tmp_path):
    """A fleet scanned under an active span joins its trace: one scan
    root per image, each linked to the ambient span, on the direct and
    the scheduled path, as the reference's; the reports are those of a
    scan with no ambient span."""
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
    out = {pkg: _tree(pkg, tmp_path / pkg, sched) for pkg in PKGS}
    assert out["port"][0] == out["ref"][0] == [("scan", True, True)] * 2
    runner = _mod("port", "runtime").BatchScanRunner(
        store=_port_store(), backend="cpu", sched=sched)
    try:
        plain = _norm(runner.scan_paths(make_fleet(tmp_path / "port", 2)))
    finally:
        runner.close()
    assert out["port"][1] == plain


def test_simhost_joins_the_parent_trace_with_a_clock(tmp_path):
    """Two port simhost processes given ``traceparent`` and
    ``clock_port_file``: the parent handshakes each one's clock while
    it scans, each host's root carries the parent's trace and span,
    the child links resolve, and the merged timeline aligns both
    exports — as the reference's two-process run."""
    from tests.test_async_rt import FIXTURE_DB, FIXTURE_VULNS
    prop = _mod("port", "obs.propagate")
    tracer = _mod("port", "obs.trace").get_tracer()
    root = tracer.start_span("fleet", trace_id="dd" * 16)
    paths = make_fleet(tmp_path, 6)

    def handshake(pid: int):
        # each host's clock is probed the moment its port file appears:
        # the host closes its ClockServer when its scan ends
        port = prop.read_port_file(str(tmp_path / f"clock{pid}.port"),
                                   timeout_s=120)
        cli = prop.ClockClient("127.0.0.1", port)
        try:
            return prop.estimate_offset(cli.probe, samples=6)
        finally:
            cli.close()

    pool = ThreadPoolExecutor(2)
    probes = [pool.submit(handshake, pid) for pid in range(2)]
    procs = []
    for pid in range(2):
        spec = {"paths": paths, "devices": 1, "dispatch_depth": 2,
                "db_fixture": FIXTURE_DB, "vulns": FIXTURE_VULNS,
                "backend": "cpu",
                "traceparent": prop.TraceContext(
                    trace_id=root.trace_id,
                    parent_span_id=root.span_id).to_header(),
                "clock_port_file": str(tmp_path / f"clock{pid}.port")}
        spec_path = str(tmp_path / f"spec{pid}.json")
        with open(spec_path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   TRIVY_TPU_NUM_PROCESSES="2",
                   TRIVY_TPU_PROCESS_ID=str(pid),
                   TRIVY_TPU_COORDINATOR="sim:0")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "trivy_tpu_torch.parallel.simhost",
             spec_path, str(tmp_path / f"out{pid}.json")], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        ests = [p.result(timeout=300) for p in probes]
        for est in ests:
            assert abs(est.offset_s) <= est.error_bound_s + 0.05
        offsets = [est.offset_s for est in ests]
        outs = []
        for pid, proc in enumerate(procs):
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:].decode()
            with open(tmp_path / f"out{pid}.json", encoding="utf-8") as f:
                outs.append(json.load(f))
    finally:
        pool.shutdown(wait=False)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    root.end()
    for o in outs:
        assert o["trace"]["trace_id"] == root.trace_id
        assert o["trace"]["remote_parent"] == root.span_id
        exported = o["timeline"]["spans"]
        host_root = [s for s in exported
                     if s["span_id"] == o["trace"]["root_span_id"]]
        assert host_root and host_root[0]["parent_id"] == root.span_id
        assert host_root[0]["is_root"] is True
        ids = {s["span_id"] for s in exported}
        for s in exported:
            if s["parent_id"] and not s["is_root"]:
                assert s["parent_id"] in ids
        scans = [s for s in exported if s["is_root"] and s["name"] == "scan"]
        assert scans and all(s["trace_id"] == root.trace_id for s in scans)
    rep = _mod("port", "obs.timeline").MergedTimeline(
        [o["timeline"] for o in outs], offsets=offsets).report()
    assert len(rep["hosts"]) == 2
