"""The soak harness: ``trivy_tpu_torch.soak`` (registry, scenario,
audit, runner) and the ``soak`` subcommand, against the JAX package's
``trivy_tpu.soak`` in the same process.

The same seeded inputs go to both packages: registry specs and image
indices, scenario specs, presets and files, scripted audit series and
scripted verdict lists. Their outputs must be equal byte for byte
(manifests, notifications, scan bodies, schedules and digests) or as
dicts (audit verdicts, trip analyses). The sim replica's chaos surface
is held to the same expectations on both packages.

The verdict clock is the one departure (ROADMAP Queue C). The reference
stamps a sampler epoch before its audit sample and federation scrape;
``test_verdict_clock_stamps_after_the_scrape`` replays, on a patched
clock and without a wall clock, an epoch whose slow scrape first sees
the brownout's failures: the port's trip is on time, the reference's is
called early. The port's runner is then run once on the reference
test's tiny scenario and held on counts: the books, the steps the
schedule holds, the schema and the stable digest."""

import importlib
import json
import os
import threading
import urllib.error
import urllib.request

import pytest

import trivy_tpu.soak as rsoak
import trivy_tpu_torch.soak as tsoak
from trivy_tpu.cli import build_parser as rparser
from trivy_tpu.cli import main as rmain
from trivy_tpu_torch.cli import build_parser as tparser
from trivy_tpu_torch.cli import main as tmain

SOAK = {"ref": rsoak, "port": tsoak}
ROOT = {"ref": "trivy_tpu", "port": "trivy_tpu_torch"}


def _mod(pkg, name):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


def _both(fn) -> dict:
    out = {}
    for pkg in SOAK:
        try:
            out[pkg] = ("ok", fn(pkg))
        except Exception as e:      # noqa: BLE001 — compared below
            out[pkg] = (type(e).__name__, str(e))
    return out


def _equal(fn):
    got = _both(fn)
    assert got["port"] == got["ref"], got
    return got["port"]


def _tiny(pkg, **over):
    """tests/test_soak.py's tiny scenario, in package ``pkg``."""
    s = SOAK[pkg]
    spec = dict(
        name="e2e-tiny", seed=7, duration_s=15.0, compression=3.0,
        base_rate=25.0,
        registry=s.RegistrySpec(seed=7, layers=5_000, images=800,
                                hostile_rate=0.02),
        steps=(
            s.Step(t=2.0, kind="storm",
                   fault="event-storm:storm_events=40,"
                         "storm_digests=4,storm_malformed=6"),
            s.Step(t=4.0, kind="kill"),
            s.Step(t=5.0, kind="scale_up"),
            s.Step(t=7.0, kind="hot_swap", duration=2.0),
            s.Step(t=10.0, kind="brownout", duration=4.0, value=1.0,
                   expect_trip=True),
        ))
    spec.update(over)
    return s.Scenario(s.ScenarioSpec(**spec))


# --- the synthetic registry -------------------------------------------------

REGISTRY_SPECS = [
    dict(seed=11),
    dict(seed=3, layers=50_000, images=5_000, reuse=0.8),
    dict(seed=9, layers=1_000_000, images=200_000),
    dict(seed=31, hostile_rate=1.0),
    dict(seed=23, layers=100, images=7, reuse=0.0,
         tenants=("a", "b"), tenant_weights=(1, 4)),
]


@pytest.mark.parametrize("kw", REGISTRY_SPECS)
def test_registry_manifests_equal_the_reference(kw):
    def run(pkg):
        reg = SOAK[pkg].SyntheticRegistry(SOAK[pkg].RegistrySpec(**kw))
        out = []
        for i in (0, 1, 7, 42, 123_456, 19_999):
            m = reg.manifest(i)
            out.append(json.dumps({
                "manifest": m, "tenant": reg.tenant_for(i),
                "hostile": reg.is_hostile(i),
                "notification": reg.notification(
                    i, event_id=f"e{i}", traceparent="00-ab-cd-01"),
                "default_notification": reg.notification(i),
                "body": reg.scan_body(m, idempotency_key=f"k{i}"),
                "by_digest": reg.by_digest(m["digest"]),
                "resolved": reg.resolver()("r:t", m["digest"])},
                sort_keys=True))
        return out, reg.base_pool, reg.stats()
    _equal(run)


def test_registry_resolution_and_validation_equal_the_reference():
    def run(pkg):
        s = SOAK[pkg]
        reg = s.SyntheticRegistry(s.RegistrySpec(seed=29))
        m = reg.manifest(5)
        out = [reg.resolver()("repo:tag", "sha256:" + "0" * 64),
               reg.resolve_path(s.registry.PATH_SCHEME + m["digest"])]
        for bad in (s.registry.PATH_SCHEME + "sha256:" + "0" * 64,
                    "/not/a/soak/path"):
            try:
                reg.resolve_path(bad)
            except KeyError as e:
                out.append(("KeyError", str(e)))
        for kw in (dict(layers=0), dict(reuse=1.5),
                   dict(tenants=("a",), tenant_weights=(1, 2))):
            try:
                s.RegistrySpec(**kw)
            except ValueError as e:
                out.append(("ValueError", str(e)))
        return out
    assert len(_equal(run)[1]) == 7


def test_registry_notification_parses_through_the_ports_watch_source():
    from trivy_tpu_torch.watch.source import parse_notification
    reg = tsoak.SyntheticRegistry(tsoak.RegistrySpec(seed=23))
    events, malformed = parse_notification(reg.notification(5),
                                           resolver=reg.resolver())
    assert malformed == 0 and len(events) == 1
    assert events[0].digest == reg.manifest(5)["digest"]
    assert reg.resolve_path(events[0].path)["index"] == 5


# --- scenarios ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["soak-smoke", "soak"])
@pytest.mark.parametrize("over", [{}, {"seed": 99},
                                  {"duration_s": 30.0,
                                   "compression": 10.0}])
def test_preset_schedules_equal_the_reference(name, over):
    def run(pkg):
        sc = SOAK[pkg].load_scenario(name, **over)
        return sc.to_json(), sc.digest(), sc.rate_at(7.5)
    _equal(run)


def test_tiny_scenario_schedule_equals_the_reference():
    _equal(lambda pkg: (_tiny(pkg).to_json(), _tiny(pkg).digest()))


def test_scenario_files_load_as_the_reference(tmp_path):
    docs = {
        "good": {"name": "filecase", "seed": 5, "duration_s": 10.0,
                 "compression": 2.0, "base_rate": 5.0,
                 "registry": {"seed": 5, "layers": 100, "images": 50},
                 "steps": [{"t": 4.0, "kind": "kill"},
                           {"t": 2.0, "kind": "brownout",
                            "duration": 3.0, "expect_trip": True}]},
        "unknown-field": {"steps": [{"t": 1.0, "kind": "kill",
                                     "blast_radius": 3}]},
        "bad-kind": {"steps": [{"t": 1.0, "kind": "meteor-strike"}]},
        "late-step": {"duration_s": 5.0,
                      "steps": [{"t": 9.0, "kind": "kill"}]},
        "not-an-object": ["a", "list"],
        "bad-rate": {"base_rate": 0},
    }
    for name, doc in docs.items():
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(doc))

        def run(pkg, p=p):
            sc = SOAK[pkg].load_scenario(str(p), seed=3)
            return sc.to_json(), sc.digest()
        got = _equal(run)
        assert (got[0] == "ok") == (name == "good"), (name, got)
    _equal(lambda pkg: SOAK[pkg].load_scenario("no-such-preset"))


def test_steps_validate_and_compose_as_the_reference():
    def run(pkg):
        s = SOAK[pkg]
        out = []
        for kw in (dict(t=1.0, kind="meteor-strike"),
                   dict(t=-1.0, kind="kill"),
                   dict(t=1.0, kind="kill", duration=-2.0)):
            try:
                s.Step(**kw)
            except ValueError as e:
                out.append(str(e))
        st = s.Step(t=1.0, kind="storm",
                    fault="event-storm:storm_events=64,"
                          "storm_malformed=4,cache-flaky")
        spec = st.fault_spec()
        out.append((spec.storm_events, spec.storm_malformed, spec.seed,
                    s.Step(t=1.0, kind="kill").fault_spec()))
        return out
    assert len(_equal(run)[1]) == 4


# --- the audit ----------------------------------------------------------------

SERIES = {
    "flat": [100.0] * 20,
    "plateau": [100, 130, 90, 120, 95, 125, 100, 118] * 3,
    "creep": [float(i * 10) for i in range(40)],
    "warmup": [float(min(i, 8) * 50) for i in range(32)],
    "sentinels": [-1.0, 5.0, -1.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0, -1.0],
    "few": [1.0, 2.0, 3.0],
    "jitter": [1000.0 + (i % 3) for i in range(24)],
}


@pytest.mark.parametrize("kw", [{}, {"warmup_frac": 0.5},
                                {"tolerance": 0.0},
                                {"warmup_frac": 2.0, "tolerance": -1.0}])
def test_audit_verdict_on_scripted_series_equals_the_reference(
        kw, monkeypatch):
    def run(pkg):
        stats = iter(range(10_000))
        monkeypatch.setattr(
            _mod(pkg, "soak.audit"), "process_self_stats",
            lambda: {"rss_bytes": 5e7 + next(stats) * 1e6,
                     "open_fds": 10, "threads": 4})
        audit = SOAK[pkg].ResourceAudit(**kw)
        cursor = {"i": 0}
        for name, values in SERIES.items():
            audit.add_probe(
                name, lambda v=values: v[cursor["i"] % len(v)],
                gate=name != "warmup")
        audit.add_probe("dead", lambda: 1 / 0)
        rows = []
        for cursor["i"] in range(max(map(len, SERIES.values()))):
            rows.append(audit.sample())
        return rows, audit.verdict(), audit.series("creep")
    rows, verdict, _ = _equal(run)[1]
    assert not verdict["series"]["creep"]["ok"]
    assert verdict["series"]["dead"]["reason"] == "too few samples"


@pytest.mark.parametrize("name", sorted(SERIES))
def test_bounded_growth_equals_the_reference(name):
    _equal(lambda pkg: SOAK[pkg].ResourceAudit._bounded(
        SERIES[name], 0.25, 0.10, 4.0))


# --- the trip analysis ----------------------------------------------------------

VERDICTS = {
    "none": [],
    "clean": [(t / 10, True, True) for t in range(60)],
    "on-time": [(t / 10, t < 40, True) for t in range(60)],
    "late": [(t / 10, t < 45, True) for t in range(60)],
    "early": [(t / 10, not 20 <= t < 22, True) for t in range(60)],
    "edge": [(3.333, False, True)],
    "just-before": [(3.332, False, False)],
}


@pytest.mark.parametrize("name", sorted(VERDICTS))
@pytest.mark.parametrize("scenario", ["tiny", "no-trip"])
def test_trip_analysis_on_scripted_verdicts_equals_the_reference(
        name, scenario):
    def run(pkg):
        sc = _tiny(pkg) if scenario == "tiny" else _tiny(pkg, steps=(
            SOAK[pkg].Step(t=2.0, kind="kill"),))
        runner = SOAK[pkg].SoakRunner(sc, replicas=2)
        runner.verdicts = list(VERDICTS[name])
        out = runner._trip_analysis()
        out.pop("dump_dir")
        return out
    got = _equal(run)[1]
    if scenario == "tiny":
        assert got["early_trip"] == (name in ("early", "just-before"))


# --- the sim replica's chaos surface -------------------------------------------

def _post(url, doc):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5.0) as resp:
        return resp.status, json.loads(resp.read() or b"{}")


def _chaos_surface(pkg) -> dict:
    sim_mod = _mod(pkg, "router.sim")
    sim = sim_mod.SimReplica(name="chaos-sim", service_ms=1.0, seed=77,
                             slo_availability=0.995).start()
    scan = sim.url + sim_mod.SCANNER_PREFIX + "Scan"
    body = {"idempotency_key": "k", "target": "t", "artifact_id": "a",
            "blob_ids": ["sha256:x"]}
    out = {}
    try:
        out["error_rate"] = _post(sim.url + "/chaos", {"error_rate": 1.0})
        try:
            _post(scan, body)
        except urllib.error.HTTPError as e:
            out["chaos_scan"] = e.code
        out["chaos_errors"] = sim.metrics()["chaos_errors"]
        _post(sim.url + "/chaos", {"error_rate": 0.0})
        out["healed"] = _post(scan, dict(body, idempotency_key="k2"))[0]
        out["warm"] = sim.metrics()["warm_digests"]
        _post(sim.url + "/chaos", {"db_generation": 2})
        m = sim.metrics()
        out["swap"] = (m["warm_digests"], m["db_swaps"],
                       m["db_generation"])
        try:
            _post(sim.url + "/chaos", ["not", "a", "dict"])
        except urllib.error.HTTPError as e:
            out["non_dict"] = e.code
        with urllib.request.urlopen(sim.url + "/metrics/snapshot",
                                    timeout=5.0) as r:
            snap = json.loads(r.read())
        out["snapshot_keys"] = sorted(
            {"name", "prom", "slo_export", "mono"} & set(snap))
        out["snapshot_name"] = snap["name"]
        out["process_threads"] = m["process"]["threads"] >= 1
    finally:
        sim.stop()
    return out


def test_sim_chaos_surface_equals_the_reference():
    got = _equal(_chaos_surface)[1]
    assert got["chaos_scan"] == 500 and got["healed"] == 200
    assert got["swap"] == (0, 1, 2) and got["non_dict"] == 400


# --- the verdict clock (the departure) -------------------------------------------

# a scripted run: brownout from 1.0 s of real time (virtual 3.0 at
# compression 3), the sampler's epoch 0.2 s, each scrape 0.5 s long; it
# sees the brownout's failures once it ends at or after 1.0 s
CLOCK_EPOCH_S, CLOCK_SCRAPE_S, CLOCK_SETUP_S, CLOCK_EPOCHS = \
    0.2, 0.5, 0.05, 4


class _FakeTime:
    """The runner module's ``time``: a clock that only the sampler's
    sleep, the fleet set-up and the scrape advance."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return 0.0

    def sleep(self, s: float) -> None:
        self.t += s


class _Idle:
    def sample(self):
        return {}

    def run(self, max_wall_s=0.0):
        return {}

    def close(self):
        pass


def _scripted_trip(pkg, monkeypatch) -> dict:
    """``SoakRunner.run`` of package ``pkg`` on the fake clock, with the
    fleet, the audit and the federation scrape replaced: the timeline
    takes its origin when it starts and ends after ``CLOCK_EPOCHS``
    scrapes; a scrape takes ``CLOCK_SCRAPE_S`` and reports the fleet
    failing iff the brownout had begun when it ended. Returns the
    run's trip analysis."""
    s = SOAK[pkg]
    clock = _FakeTime()
    monkeypatch.setattr(_mod(pkg, "soak.runner"), "time", clock)
    sc = s.Scenario(s.ScenarioSpec(
        name="clock", seed=7, duration_s=6.0, compression=3.0,
        base_rate=1.0, registry=s.RegistrySpec(seed=7, layers=100,
                                               images=10),
        steps=(s.Step(t=3.0, kind="brownout", duration=1.5, value=1.0,
                      expect_trip=True),)))
    brownout_s = 3.0 / 3.0
    runner = s.SoakRunner(sc, replicas=1, epoch_s=CLOCK_EPOCH_S)
    state = {"origin": None, "scrapes": 0}
    done = threading.Event()

    def setup():
        clock.t += CLOCK_SETUP_S
        runner.loop, runner.source = _Idle(), _Idle()

    def timeline(sched):
        state["origin"] = clock.monotonic()
        done.wait(10.0)

    def scrape():
        clock.t += CLOCK_SCRAPE_S
        state["scrapes"] += 1
        if state["scrapes"] >= CLOCK_EPOCHS:
            done.set()
        failing = clock.monotonic() - state["origin"] >= brownout_s
        return {"slo_ok": not failing, "complete": True}

    runner.audit = _Idle()
    monkeypatch.setattr(runner, "_setup_fleet", setup)
    monkeypatch.setattr(runner, "_timeline", timeline)
    monkeypatch.setattr(runner, "_fleet_verdict", scrape)
    monkeypatch.setattr(runner, "_teardown_fleet", lambda: None)
    monkeypatch.setattr(runner, "_report",
                        lambda *a: runner._trip_analysis())
    return runner.run()


def _on_time(trip: dict) -> bool:
    return trip["tripped"] and not trip["early_trip"] and \
        trip["first_trip_t"] >= trip["expected"][0]["real_start"]


def test_verdict_clock_stamps_after_the_scrape(monkeypatch):
    """The epoch whose scrape starts at 0.9 s and ends at 1.4 s is the
    first to see the brownout (from 1.0 s): the port stamps it 1.4 s,
    on the timeline's origin, so the designed trip is on time."""
    trip = _scripted_trip("port", monkeypatch)
    assert _on_time(trip), trip
    assert trip["first_trip_t"] == pytest.approx(1.4)
    assert trip["trips_exact"]


def test_reference_clock_calls_the_trip_early(monkeypatch):
    """The same script on the reference: its stamp, taken before the
    scrape on an origin before the fleet's set-up (0.95 s), falls
    before the brownout, and the designed trip is called early — the
    fault the port repairs (tests/test_soak.py's
    ``test_designed_trip_exact_with_evidence`` fails so under load)."""
    trip = _scripted_trip("ref", monkeypatch)
    assert not _on_time(trip), trip
    assert trip["early_trip"]
    assert trip["first_trip_t"] == pytest.approx(
        CLOCK_SETUP_S + CLOCK_EPOCH_S * 2 + CLOCK_SCRAPE_S)


def test_steps_run_on_the_verdicts_origin(monkeypatch):
    """The port's timeline walks the schedule on ``_origin``, the clock
    its verdicts are stamped on: each step and arrival runs at or after
    its due time on that clock."""
    clock = _FakeTime()
    monkeypatch.setattr(_mod("port", "soak.runner"), "time", clock)
    sc = _tiny("port", duration_s=15.0, base_rate=2.0)
    runner = tsoak.SoakRunner(sc, replicas=1)
    runner._origin = clock.monotonic() - 0.25
    seen = []
    monkeypatch.setattr(runner, "_push_arrival",
                        lambda i: seen.append(("arrival",
                                               runner._clock())))
    monkeypatch.setattr(runner, "_run_step",
                        lambda st: seen.append((st.kind,
                                                runner._clock())))
    sched = sc.schedule()
    runner._timeline(sched)
    comp = sc.spec.compression
    due = sorted([(a[0] / comp, "arrival") for a in sched["arrivals"]]
                 + [(st["t"] / comp, st["kind"])
                    for st in sched["steps"]])
    assert len(seen) == len(due)
    for (t_due, _), (_, t_ran) in zip(due, seen):
        assert t_ran >= t_due - 1e-9


# --- the runner, once, held on counts ---------------------------------------------

@pytest.fixture(scope="module")
def tiny_report(tmp_path_factory):
    path = tmp_path_factory.mktemp("soak") / "report.json"
    report = tsoak.run_soak(_tiny("port"), replicas=2, epoch_s=0.3,
                            service_ms=2.0, slo_availability=0.995,
                            report_path=str(path))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    return report


def test_tiny_run_books_balance(tiny_report):
    st = tiny_report["stable"]
    assert st["lost"] == 0 and st["books_balanced"]
    w = tiny_report["books"]["watch"]
    assert w["events"] == w["scans"] + w["deduped"] + w["shed"]
    assert tiny_report["books"]["router"]["lost"] == 0


def test_tiny_run_executes_the_schedules_steps(tiny_report):
    sched = _tiny("ref").schedule()
    kinds = [st["kind"] for st in sched["steps"]]
    c = tiny_report["books"]["counters"]
    assert c["kills"] == kinds.count("kill")
    assert c["scale_ups"] == kinds.count("scale_up")
    assert c["scale_downs"] == kinds.count("scale_down")
    assert c["hot_swaps"] == kinds.count("hot_swap")
    assert c["push_malformed"] == 6           # the storm's malformed
    assert c["storm_envelopes"] == 40 + 6
    assert c["pushed"] == len(sched["arrivals"])
    assert c["scans_failed"] + c["scans_shed"] > 0   # the brownout


def test_tiny_run_schema_and_stable_digest(tiny_report):
    rsc = _tiny("ref")
    st = tiny_report["stable"]
    assert tiny_report["schema"] == 1
    assert st["schedule_digest"] == rsc.digest()
    assert st["arrivals"] == len(rsc.schedule()["arrivals"])
    assert st["steps"] == 5 and st["expected_trips"] == ["brownout"]
    assert st["events_pushed"] == len(rsc.schedule()["arrivals"]) + 46
    assert st["malformed"] == 6 and st["invoice_totals_match"]
    assert set(tiny_report) == {
        "schema", "stable", "scenario", "books", "slo", "audit", "costs",
        "throughput", "fleet", "timeline", "wall"}
    assert set(tiny_report["wall"]) == {"started_unix", "duration_s"}
    gated = {k for k, v in tiny_report["audit"]["series"].items()
             if v["gated"]}
    assert {"rss_bytes", "threads", "watch_backlog",
            "cursor_ack_window"} <= gated
    view = tsoak.runner.stable_view(tiny_report)
    assert json.loads(view) == st and "wall" not in view


def test_tiny_run_trips_after_the_brownout(tiny_report):
    trip = tiny_report["slo"]["trip"]
    assert trip["tripped"] and not trip["early_trip"]
    assert trip["first_trip_t"] >= trip["expected"][0]["real_start"]
    assert trip["dumps"] > 0


# --- the soak subcommand ----------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["soak"],
    ["soak", "--scenario", "soak-smoke", "--replicas", "2", "--seed", "3",
     "--report", "r.json"],
    ["soak", "--scenario", "x.json", "--duration", "9", "--compression",
     "4", "--mode", "subprocess", "--epoch", "0.2", "--service-ms", "1"],
])
def test_soak_flags_parse_as_the_reference(argv):
    keys = ("command", "scenario", "replicas", "seed", "duration",
            "compression", "mode", "report", "epoch", "service_ms")
    got = [{k: getattr(p().parse_args(argv), k) for k in keys}
           for p in (rparser, tparser)]
    assert got[0] == got[1]


def test_soak_cli_errors_equal_the_reference(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"steps": [{"t": 1.0, "kind": "x"}]}))
    for target in ("no-such-preset", str(bad)):
        out = []
        for main in (rmain, tmain):
            code = main(["soak", "--scenario", target])
            out.append((code, capsys.readouterr().err.strip()))
        assert out[0] == out[1] and out[1][0] == 1, out
        assert out[1][1].startswith("error: ")
