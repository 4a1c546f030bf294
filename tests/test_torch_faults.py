"""Fault injection: ``trivy_tpu_torch.faults`` (spec, injector) with the
seams it drives — the circuit-broken cache, the scheduler's bisect and
quarantine ladder, degraded reports, the RPC drop / 500 / lost-response
path and ``--fault-spec`` on the ``image`` fleet — against the JAX
package's (JAX on the CPU) in the same process.

The spec grammar is held case by case: the same text parses to the same
spec and sub-seeds, and a bad one fails with the same message. The
injectors draw the same decisions from the same seed. The fleets are
``tests/test_sched.py``'s docker-save targets (the same files feed
both packages); a faulted fleet's reports, statuses and counters must
equal the reference's under the same spec. Which batch a
``device_fail_batches`` fault hits, and so how often the scheduler
bisects, depends on its order: only what the reference's own tests
hold is compared, never the order."""

import contextlib
import dataclasses
import io
import json
import re
import threading
import time

import numpy as np
import pytest

import trivy_tpu.faults as rfaults
import trivy_tpu_torch.faults as tfaults
from tests.test_sched import make_fleet
from tests.torch_threads import one_torch_thread  # noqa: F401
from trivy_tpu.faults.spec import derive_subseed as rsubseed
from trivy_tpu.faults.spec import parse_fault_specs as rspecs
from trivy_tpu_torch.faults.spec import derive_subseed as tsubseed
from trivy_tpu_torch.faults.spec import parse_fault_specs as tspecs

PKGS = ("ref", "port")
FAULTS = {"ref": rfaults, "port": tfaults}


def _both(fn) -> dict:
    """``fn(pkg)`` for each package: ("ok", value), or (error type
    name, message) when it raises."""
    out = {}
    for pkg in PKGS:
        try:
            out[pkg] = ("ok", fn(pkg))
        except Exception as e:      # noqa: BLE001 — compared below
            out[pkg] = (type(e).__name__, str(e))
    return out


def _spec_dict(spec) -> dict:
    return dataclasses.asdict(spec)


# --- the spec grammar ---------------------------------------------------

SPEC_TEXTS = sorted(tfaults.SCENARIOS) + [
    "",
    "cache-outage:seed=7,cache_fail_ops=80",
    "poison-image:poison=a.tar;b.tar,seed=9",
    "poison=img3.tar;img9.tar,device_fail_batches=1",
    "device_fail_batches=3",
    "cache_fail_ops=3,deadline_s=0.5",
    "event-storm,replica-kill,hostile-ingest",
    "event-storm:storm_events=64,storm_malformed=4,"
    "replica-kill:replica_kill_after=8",
    "event-storm:seed=1,replica-kill",
    "event-storm,replica-kill:seed=99",
    "standard-outage:poison=img1.tar,hostile-ingest",
    "cache-outage,standard-outage:cache_fail_ops=40",
    "poison-image:poison=a.tar;b.tar,device-transient:poison=b.tar;c.tar",
    "hostile-ingest:hostile=gzip-bomb;tar-flood",
    " cache-flaky , , slow-host:stall_s=0.01 ",
    # bad specs: the same error, the same message
    "no-such-scenario",
    "cache-outage:bogus_key=1",
    "seed=notanint",
    "cache-outage,cache-down",
    "event-storm,not-a-scenario",
    "cache-outage:cache_fail_rate=high",
    "cache-outage:=1",
]


@pytest.mark.parametrize("text", SPEC_TEXTS)
def test_spec_parses_as_the_reference(text):
    """``parse_fault_specs`` and ``parse_fault_spec``: the same
    sub-specs (fields and seeds) and the same merged spec, or the same
    error and message."""
    got = _both(lambda pkg: [_spec_dict(s) for s in (
        rspecs if pkg == "ref" else tspecs)(text)])
    assert got["port"] == got["ref"]
    got = _both(lambda pkg: _spec_dict(FAULTS[pkg].parse_fault_spec(text)))
    assert got["port"] == got["ref"]
    if got["ref"][0] == "ok":
        for pkg in PKGS:
            spec = FAULTS[pkg].parse_fault_spec(text)
            preds = {n: getattr(spec, n)() for n in dir(spec)
                     if n.startswith("wants_")}
            if pkg == "ref":
                want = preds
        assert preds == want


def test_subseeds_equal_the_reference_on_seeded_inputs():
    """``derive_subseed`` over seeded (base, index, name) triples, and
    the composed sub-seeds of seeded compositions."""
    rng = np.random.default_rng(20260804)
    names = sorted(tfaults.SCENARIOS)
    for _ in range(200):
        base = int(rng.integers(0, 2**40))
        idx = int(rng.integers(0, 9))
        name = names[int(rng.integers(len(names)))]
        assert tsubseed(base, idx, name) == rsubseed(base, idx, name)
    for _ in range(40):
        k = int(rng.integers(2, 5))
        picked = [names[int(i)] for i in rng.choice(len(names), k,
                                                    replace=False)]
        text = ",".join(picked)
        if rng.random() < 0.5:
            text = f"{picked[0]}:seed={int(rng.integers(1, 10**6))}," + \
                ",".join(picked[1:])
        assert [s.seed for s in tspecs(text)] == \
            [s.seed for s in rspecs(text)]


def _route_draws(pkg, text: str, n: int = 48) -> tuple:
    """The router site driven in one seeded order: each forward's
    verdict over three replicas, whether a kill is due at each forward
    count, and the counters after."""
    inj = FAULTS[pkg].FaultInjector(FAULTS[pkg].parse_fault_spec(text))
    out = []
    for i in range(n):
        out.append((inj.on_route_forward(f"r{i % 3}"),
                    inj.replica_kill_due(i)))
    return out, inj.stats(), inj.spec.wants_route_faults()


@pytest.mark.parametrize("text", [
    "replica-flaky", "replica-kill", "replica-flaky:seed=4",
    "replica-flaky:replica_flaky_every=2,replica_flaky=r1",
    "replica-kill:replica_kill_after=7,replica_kill=r2",
    "replica_flaky_every=5", "event-storm,replica-kill",
    "cache-outage"])
def test_route_decisions_equal_the_reference(text):
    """The router site of the port's injector (``on_route_forward``,
    ``replica_kill_due``) draws the same drops — the scoped
    ``replica_flaky`` included — fires the kill once at the same
    forward count and ends with the same counters as the reference's;
    a spec without route faults drops nothing and kills nothing."""
    got = _both(lambda pkg: _route_draws(pkg, text))
    assert got["ref"][0] == "ok"
    assert got["port"] == got["ref"]
    draws, stats, wants = got["port"][1]
    assert wants == ("replica" in text)
    assert stats["replica_kills"] == (1 if "kill" in text else 0)
    assert (stats["route_drops"] > 0) == ("flaky" in text)


# --- the injector's decisions -------------------------------------------

def _draws(pkg, text: str, n: int = 60) -> tuple:
    """A seeded run of every hook but the router's: each decision, the
    stats and the memo bytes after damage."""
    inj = FAULTS[pkg].FaultInjector(FAULTS[pkg].parse_fault_spec(text))
    out = []
    raw = bytes(np.random.default_rng(3).integers(0, 256, 97,
                                                  dtype=np.uint8))
    for i in range(n):
        step = []
        for hook, args in (("on_cache_op", ("get_blob", f"k{i}")),
                           ("on_device_dispatch", ([f"img{i % 7}.tar",
                                                    "b.tar"],)),
                           ("on_image_load", (f"img{i % 5}.tar",)),
                           ("on_blob_chunk", ("sha256:x", i % 3))):
            try:
                getattr(inj, hook)(*args)
                step.append("ok")
            except FAULTS[pkg].InjectedFault as e:
                step.append((type(e).__name__, str(e)))
        step.append(inj.rpc_action("/twirp/x"))
        step.append(inj.on_memo_load("k", raw).hex())
        out.append(step)
    return out, inj.stats()


@pytest.mark.parametrize("text", [
    "cache-flaky:seed=5", "cache-outage:cache_fail_ops=7",
    "cache-down", "device-transient", "device_fail_rate=0.3,seed=11",
    "poison-image:poison=img3.tar", "corrupt-layer:corrupt=img2.tar",
    "rpc-flaky:seed=2", "rpc_error_first=2,rpc_drop_first=3",
    "memo-poison", "memo_corrupt_loads=-1", "registry-flaky",
    "standard-outage:poison=img4.tar,hostile-ingest"])
def test_injector_decisions_equal_the_reference(text):
    """Every hook of the port's injector, driven in one seeded order,
    raises the same typed faults with the same messages, answers the
    same RPC actions, damages memo entries to the same bytes and ends
    with the same counters as the reference's."""
    got = _both(lambda pkg: _draws(pkg, text))
    assert got["ref"][0] == "ok"
    assert got["port"] == got["ref"]


def test_injected_faults_are_typed_as_the_reference():
    """``CacheFault`` is a ``ConnectionError`` (the breaker's outage),
    ``CorruptLayerFault`` and ``RegistryStreamFault`` are ``OSError``s,
    and all are ``InjectedFault``s."""
    for pkg in PKGS:
        f = FAULTS[pkg]
        assert issubclass(f.CacheFault, (f.InjectedFault, ConnectionError))
        assert issubclass(f.CorruptLayerFault, OSError)
        assert issubclass(f.inject.RegistryStreamFault, OSError)
        assert issubclass(f.DeviceFault, f.InjectedFault)
        assert issubclass(f.InjectedFault, RuntimeError)


def test_fault_injected_events_land_on_the_active_span():
    """A cache, host, memo or registry fault records a
    ``fault_injected`` event on the active request's span, with the
    reference's attributes."""
    from trivy_tpu.obs.trace import Tracer as RTracer
    from trivy_tpu_torch.obs.trace import Tracer as TTracer

    def events(pkg):
        tracer = (RTracer if pkg == "ref" else TTracer)()
        root = tracer.start_request("r")
        inj = FAULTS[pkg].FaultInjector(
            "cache_fail_ops=1,corrupt=bad,memo_corrupt_loads=1,"
            "blob_drop_first=1")
        with root.activate():
            for hook, args in (("on_cache_op", ("put_blob", "k")),
                               ("on_image_load", ("bad.tar",)),
                               ("on_blob_chunk", ("sha256:d", 5))):
                with contextlib.suppress(FAULTS[pkg].InjectedFault):
                    getattr(inj, hook)(*args)
            inj.on_memo_load("k", b"0123456789abcdef")
        return [(name, attrs) for _, name, attrs in root.events]

    got = _both(events)
    assert got["port"] == got["ref"] and len(got["ref"][1]) == 4


# --- the breaker and ResilientCache under CacheFault ---------------------

def _breaker_run(pkg, fail_ops: int, ops: list) -> dict:
    """``ops`` [(op, clock)] through ResilientCache(FaultyCache(
    MemoryCache)) on a fake clock: the counters, the breaker, the
    ``cache_degraded`` events and the consecutive failures seen when
    the breaker first opened."""
    mods = {"ref": ("trivy_tpu", rfaults), "port": ("trivy_tpu_torch",
                                                    tfaults)}[pkg]
    import importlib
    cache_mod = importlib.import_module(mods[0] + ".artifact.cache")
    res_mod = importlib.import_module(mods[0] + ".artifact.resilient")
    trace_mod = importlib.import_module(mods[0] + ".obs.trace")
    types_mod = importlib.import_module(mods[0] + ".types")
    clock = [0.0]
    inj = mods[1].FaultInjector(f"cache_fail_ops={fail_ops}")
    cache = res_mod.ResilientCache(
        mods[1].FaultyCache(cache_mod.MemoryCache(), inj),
        breaker=res_mod.CircuitBreaker(clock=lambda: clock[0]))
    tracer = trace_mod.Tracer()
    root = tracer.start_request("r")
    tripped_at = None
    blob = types_mod.BlobInfo(schema_version=2)
    with root.activate():
        for i, (op, t) in enumerate(ops):
            clock[0] = t
            if op == "put":
                cache.put_blob(f"sha256:b{i}", blob)
            elif op == "get":
                cache.get_blob(f"sha256:b{max(0, i - 1)}")
            else:
                cache.missing_blobs("sha256:a", [f"sha256:b{i}"])
            st = cache.breaker_stats()["breaker"]
            if tripped_at is None and st["state"] == "open":
                tripped_at = st["consecutive_failures"]
    st = cache.breaker_stats()
    st["breaker"].pop("open_for_s", None)
    return {"stats": st, "tripped_at": tripped_at,
            "injector": inj.stats(),
            "events": [n for _, n, _ in root.events]}


@pytest.mark.parametrize("case", ["outage", "probe_fails",
                                  "probe_recovers", "seeded"])
def test_breaker_under_cache_faults_equals_the_reference(case):
    """The ``cache-outage`` scenario under the breaker (3 failures,
    5 s cooldown) on a fake clock: the failures before the trip, the
    ``cache_degraded`` events, the fallback and primary counts and the
    breaker's state equal the reference's. A half-open probe that fails
    after the cooldown is a fourth failure and a fourth event in both
    packages, and the breaker stays tripped once."""
    if case == "outage":
        fail, ops = 40, [("put", 0.1 * i) for i in range(12)]
    elif case == "probe_fails":
        fail, ops = 40, [("put", 0.0), ("get", 0.1), ("put", 0.2),
                         ("put", 1.0), ("get", 6.0), ("put", 6.1)]
    elif case == "probe_recovers":
        fail, ops = 3, [("put", 0.0), ("get", 0.1), ("put", 0.2),
                        ("put", 1.0), ("get", 6.0), ("put", 6.1),
                        ("miss", 6.2)]
    else:
        rng = np.random.default_rng(7)
        fail = int(rng.integers(2, 9))
        t, ops = 0.0, []
        for _ in range(40):
            t += float(rng.exponential(1.5))
            ops.append((["put", "get", "miss"][int(rng.integers(3))], t))
    got = _both(lambda pkg: _breaker_run(pkg, fail, ops))
    assert got["ref"][0] == "ok"
    assert got["port"] == got["ref"]
    res = got["port"][1]
    assert res["tripped_at"] == 3
    if case == "probe_fails":
        assert res["stats"]["breaker"]["consecutive_failures"] == 4
        assert res["events"].count("cache_degraded") == 4
        assert res["stats"]["breaker"]["trips"] == 1
    if case == "probe_recovers":
        assert res["stats"]["breaker"]["state"] == "closed"
        assert res["events"].count("cache_degraded") == 3


def test_breaker_counts_ops_in_flight_when_it_trips():
    """Four ops that pass the closed breaker together and then fail
    count four failures in both packages: the breaker opens at the
    third, the fourth was already let through. (The other way a fourth
    failure arises, beside the failed half-open probe above.)"""
    def run(pkg):
        root = "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"
        import importlib
        res_mod = importlib.import_module(root + ".artifact.resilient")
        barrier = threading.Barrier(4)

        class Down:
            def get_blob(self, blob_id):
                barrier.wait(10)
                raise ConnectionError("down")

        cache = res_mod.ResilientCache(Down())
        threads = [threading.Thread(target=cache.get_blob,
                                    args=(f"sha256:{i}",))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        st = cache.breaker_stats()
        return (st["breaker"]["state"],
                st["breaker"]["consecutive_failures"],
                st["breaker"]["trips"], st["primary_errors"])

    got = _both(run)
    assert got["port"] == got["ref"] == ("ok", ("open", 4, 1, 4))


def test_wrap_cache_interposes_beneath_an_existing_breaker():
    """``wrap_cache`` puts the faults under a remote cache's own breaker
    and never stacks a second one; a fresh cache gets a breaker named
    "fault-injected"."""
    from trivy_tpu_torch.artifact.cache import MemoryCache
    from trivy_tpu_torch.artifact.resilient import ResilientCache
    inj = tfaults.FaultInjector("cache-outage")
    wrapped = inj.wrap_cache(MemoryCache())
    assert isinstance(wrapped, ResilientCache)
    assert wrapped.name == "fault-injected"
    assert isinstance(wrapped.primary, tfaults.FaultyCache)
    outer = ResilientCache(MemoryCache())
    assert inj.wrap_cache(outer) is outer
    assert isinstance(outer.primary, tfaults.FaultyCache)
    assert isinstance(inj.wrap_cache(MemoryCache(), resilient=False),
                      tfaults.FaultyCache)
    plain = MemoryCache()
    assert tfaults.FaultInjector("device-transient").wrap_cache(plain) \
        is plain


# --- fleets under injected faults ---------------------------------------

def _store(pkg):
    import importlib
    db = importlib.import_module(("trivy_tpu" if pkg == "ref"
                                  else "trivy_tpu_torch") + ".db")
    store = db.AdvisoryStore()
    store.put_advisory("alpine 3.16", "pkg1", "CVE-2099-0001",
                       {"FixedVersion": "2.0.0-r0"})
    store.put_vulnerability("CVE-2099-0001", {"Severity": "HIGH"})
    return store


def _norm(results) -> list:
    return [(r.name, r.status, "error", r.error) if r.error else
            (r.name, r.status, json.dumps(r.report.to_dict(),
                                          sort_keys=True))
            for r in results]


def _run_fleet(pkg, paths, spec="", wrap_cache=False):
    import importlib
    root = "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"
    runtime = importlib.import_module(root + ".runtime")
    sched = importlib.import_module(root + ".sched")
    cache_mod = importlib.import_module(root + ".artifact.cache")
    inj = FAULTS[pkg].FaultInjector(spec) if spec else None
    cache = None
    if wrap_cache:
        cache = inj.wrap_cache(cache_mod.MemoryCache())
        inj_for_runner = None
    else:
        inj_for_runner = inj
    runner = runtime.BatchScanRunner(
        store=_store(pkg), backend="cpu", cache=cache,
        sched=sched.SchedConfig(flush_timeout_s=0.01, workers=4),
        fault_injector=inj_for_runner)
    try:
        results = runner.scan_paths(paths)
        counters = runner.scheduler.metrics.snapshot()["counters"]
    finally:
        runner.close()
    return results, counters, inj


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    out = {}
    for n, shared in ((6, True), (8, False)):
        d = tmp_path_factory.mktemp(f"fleet{n}")
        paths = make_fleet(d, n, shared_secret=shared)
        out[n] = {"paths": paths,
                  "healthy": {pkg: _norm(_run_fleet(pkg, paths)[0])
                              for pkg in PKGS}}
        assert out[n]["healthy"]["port"] == out[n]["healthy"]["ref"]
    return out


def test_cache_outage_costs_throughput_not_availability(fleets):
    """A cache outage under the breaker: every target completes ``ok``
    with the healthy report in both packages."""
    f = fleets[6]
    for pkg in PKGS:
        res, _, inj = _run_fleet(pkg, f["paths"],
                                 "cache-outage:cache_fail_ops=30",
                                 wrap_cache=True)
        assert _norm(res) == f["healthy"][pkg]
        assert all(r.status == "ok" for r in res)
        assert inj.counters["cache_faults"] > 0


def test_poison_image_quarantined_rest_identical(fleets):
    """The poisoned target is quarantined alone and finishes on the
    host, degraded with the reference's causes; every other slot is the
    healthy one; the quarantine and host-fallback counts equal the
    reference's."""
    f = fleets[8]
    got = {}
    for pkg in PKGS:
        res, c, inj = _run_fleet(pkg, f["paths"],
                                 "poison-image:poison=img3.tar")
        got[pkg] = (res, c)
        bad = [r for r in res if "img3.tar" in r.name]
        assert len(bad) == 1 and bad[0].status == "degraded"
        assert bad[0].error == ""
        assert "quarantined" in [c_.kind for c_ in bad[0].causes]
        healthy = [x for x in _norm(res) if "img3.tar" not in x[0]]
        assert healthy == [x for x in f["healthy"][pkg]
                           if "img3.tar" not in x[0]]
        assert c["quarantined"] == c["host_fallbacks"] == 1
        assert inj.counters["device_faults"] >= 1
    rres, tres = got["ref"][0], got["port"][0]
    for r, t in zip(rres, tres):
        assert (t.name, t.status) == (r.name, r.status)
        assert [c_.kind for c_ in t.causes] == [c_.kind for c_ in r.causes]
        if not t.error:
            assert json.dumps(_strip_status(t.report.to_dict()),
                              sort_keys=True) == \
                json.dumps(_strip_status(r.report.to_dict()),
                           sort_keys=True)


def _strip_status(d: dict) -> dict:
    d = dict(d)
    d.pop("Status", None)
    d.pop("FailureCauses", None)
    return d


def test_transient_device_error_heals_invisibly(fleets):
    """One injected transient device fault: every slot ``ok`` with its
    healthy report, nothing quarantined, no host fallback."""
    f = fleets[6]
    for pkg in PKGS:
        res, c, inj = _run_fleet(pkg, f["paths"],
                                 "device-transient:device_fail_batches=1")
        assert _norm(res) == f["healthy"][pkg]
        assert inj.counters["device_faults"] == 1
        assert c.get("quarantined", 0) == c.get("host_fallbacks", 0) == 0


def test_corrupt_layer_fails_its_slot_only(fleets):
    """A corrupt layer fails its own slot with the reference's error
    and cause; the others are healthy."""
    f = fleets[6]
    got = {}
    for pkg in PKGS:
        res, _, _ = _run_fleet(pkg, f["paths"][:5],
                               "corrupt-layer:corrupt=img2.tar")
        got[pkg] = _norm(res)
        bad = [r for r in res if "img2.tar" in r.name]
        assert len(bad) == 1 and bad[0].status == "failed"
        assert "corrupt" in bad[0].error
        assert bad[0].causes[0].kind == "load_failed"
    assert got["port"] == got["ref"]


# --- the scheduler under faults -----------------------------------------

def test_deadline_fires_while_executing_on_device():
    """An injected device stall outlives a request's deadline: the
    caller gets ``DeadlineExceeded`` and the executor abandons the
    collect (``expired_inflight``)."""
    from trivy_tpu_torch.sched import (AnalyzedWork, DeadlineExceeded,
                                       ScanRequest, ScanScheduler,
                                       SchedConfig)
    sched = ScanScheduler(config=SchedConfig(workers=1,
                                             flush_timeout_s=0.01),
                          backend="cpu")
    sched.fault_injector = tfaults.FaultInjector("device_stall_s=0.3")
    try:
        req = sched.submit(ScanRequest(
            "inflight", lambda r: AnalyzedWork(
                finish=lambda f, d: "late"), deadline_s=0.1))
        with pytest.raises(DeadlineExceeded):
            req.result()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and sched.metrics.snapshot()[
                "counters"].get("expired_inflight", 0) < 1:
            time.sleep(0.05)
        c = sched.metrics.snapshot()["counters"]
        assert c.get("expired_inflight", 0) >= 1 and c["timed_out"] >= 1
    finally:
        sched.close()


def test_queue_full_deadline_device_failure_race_books_balance():
    """32 concurrent submits racing a full admission queue, short
    deadlines and injected device failures: each ends in exactly one of
    ok / degraded / 503 / 408, and the scheduler's books balance."""
    from trivy_tpu_torch.sched import (AnalyzedWork, DeadlineExceeded,
                                       QueueFullError, ScanRequest,
                                       ScanScheduler, SchedConfig)
    sched = ScanScheduler(config=SchedConfig(
        max_queue=4, workers=2, flush_timeout_s=0.005), backend="cpu")
    sched.fault_injector = tfaults.FaultInjector(
        "device_fail_rate=0.5,seed=11")
    outcomes: dict = {}

    def one(i):
        def analyze(req):
            time.sleep(0.002)
            return AnalyzedWork(finish=lambda f, d: f"r{i}")
        try:
            req = sched.submit(ScanRequest(
                f"r{i}", analyze,
                deadline_s=0.05 if i % 5 == 0 else 10.0))
        except QueueFullError:
            outcomes[i] = "503"
            return
        try:
            value = req.result(timeout=30)
        except DeadlineExceeded:
            outcomes[i] = "408"
            return
        except Exception as e:        # noqa: BLE001
            outcomes[i] = f"error:{type(e).__name__}"
            return
        outcomes[i] = "degraded" if req.faults else "ok"
        assert value == f"r{i}"

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(outcomes) == 32
        assert set(outcomes.values()) <= {"ok", "degraded", "503", "408"}
        c = sched.metrics.snapshot()["counters"]
        assert c["submitted"] == (c["completed"] + c["failed"] +
                                  c["timed_out"] + c["cancelled"])
        assert c["rejected"] == sum(1 for v in outcomes.values()
                                    if v == "503")
    finally:
        sched.close()


def test_drain_completes_inflight_then_refuses():
    """A draining scheduler refuses new work with ``SchedulerClosed``
    and completes everything already admitted."""
    from trivy_tpu_torch.sched import (AnalyzedWork, ScanRequest,
                                       ScanScheduler, SchedConfig,
                                       SchedulerClosed)
    gate = threading.Event()

    def analyze(req):
        gate.wait(5)
        return AnalyzedWork(finish=lambda f, d: req.name)

    sched = ScanScheduler(config=SchedConfig(workers=2,
                                             flush_timeout_s=0.005),
                          backend="cpu")
    sched.fault_injector = tfaults.FaultInjector("slow-host")
    reqs = [sched.submit(ScanRequest(f"r{i}", analyze)) for i in range(4)]
    done = {}
    t = threading.Thread(target=lambda: done.setdefault(
        "drained", sched.drain(timeout_s=10)))
    t.start()
    time.sleep(0.05)
    with pytest.raises(SchedulerClosed):
        sched.submit(ScanRequest("late", analyze))
    gate.set()
    t.join(timeout=15)
    assert done.get("drained") is True
    assert [r.result(timeout=5) for r in reqs] == [r.name for r in reqs]


# --- the RPC surface ----------------------------------------------------

def _rpc_server(pkg, injector=None, sched="off"):
    import importlib
    root = "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"
    db = importlib.import_module(root + ".db")
    server = importlib.import_module(root + ".rpc.server")
    store = db.AdvisoryStore()
    store.put_advisory("alpine 3.9", "pkg0", "CVE-2020-1000",
                       {"FixedVersion": "2.0.0-r0"})
    store.put_vulnerability("CVE-2020-1000", {"Severity": "HIGH"})
    kw = {} if pkg == "ref" else {"backend": "cpu"}
    srv = server.ScanServer(store=store, sched=sched, **kw)
    srv.fault_injector = injector
    httpd, _ = server.serve(port=0, server=srv)
    return srv, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_lost_response_does_not_double_enqueue():
    """The server processes the Scan and drops the response; the
    client retries with the same idempotency key: one admission, one
    replay, the full result."""
    from trivy_tpu_torch.rpc.client import RemoteCache, RemoteScanner
    from trivy_tpu_torch.scan.local import ScanTarget
    from trivy_tpu_torch.sched import SchedConfig
    from trivy_tpu_torch.types import ScanOptions
    from trivy_tpu_torch.types.artifact import (OS, BlobInfo, Package,
                                                PackageInfo)
    inj = tfaults.FaultInjector("rpc-lost-response:rpc_drop_first=1")
    srv, httpd, url = _rpc_server(
        "port", sched=SchedConfig(flush_timeout_s=0.01, workers=2))
    try:
        RemoteCache(url, max_retries=3, backoff_base_s=0.01).put_blob(
            "sha256:b0", BlobInfo(
                os=OS(family="alpine", name="3.9.4"),
                package_infos=[PackageInfo(packages=[Package(
                    name="pkg0", version="1.0.0", release="r0",
                    src_name="pkg0", src_version="1.0.0",
                    src_release="r0")])]))
        srv.fault_injector = inj
        results, _ = RemoteScanner(url, max_retries=4,
                                   backoff_base_s=0.01).scan(
            ScanTarget(name="img", artifact_id="sha256:a0",
                       blob_ids=["sha256:b0"]),
            ScanOptions(security_checks=["vuln"], backend="cpu"))
        assert [v.vulnerability_id for r in results
                for v in r.vulnerabilities] == ["CVE-2020-1000"]
        assert inj.counters["rpc_drops"] == 1
        assert srv.scheduler.stats()["counters"]["submitted"] == 1
        assert srv._idem.hits == 1
    finally:
        srv.close()
        httpd.shutdown()


@pytest.mark.parametrize("client_pkg", PKGS)
def test_injected_500_is_retried_transparently(client_pkg):
    """The port's server answers the first two POSTs 500 unprocessed;
    either package's client retries through them."""
    import importlib
    root = "trivy_tpu" if client_pkg == "ref" else "trivy_tpu_torch"
    client = importlib.import_module(root + ".rpc.client")
    local = importlib.import_module(root + ".scan.local")
    types = importlib.import_module(root + ".types")
    inj = tfaults.FaultInjector("rpc_error_first=2")
    srv, httpd, url = _rpc_server("port", injector=inj)
    try:
        results, _ = client.RemoteScanner(
            url, max_retries=5, backoff_base_s=0.01).scan(
            local.ScanTarget(name="img", artifact_id="a", blob_ids=[]),
            types.ScanOptions(security_checks=["vuln"], backend="cpu"))
        assert results == []
        assert inj.counters["rpc_errors"] == 2
    finally:
        srv.close()
        httpd.shutdown()


def test_injected_rpc_replies_equal_the_reference():
    """Under the same ``rpc_error_first`` / ``rpc_drop_first`` spec the
    port's server answers each raw POST as the reference's: the
    injected 500 body, then a dropped response (the connection closes
    without a reply), then the real answer."""
    import http.client
    bodies = {}
    for pkg in PKGS:
        inj = FAULTS[pkg].FaultInjector("rpc_error_first=1,"
                                        "rpc_drop_first=1")
        srv, httpd, url = _rpc_server(pkg, injector=inj)
        out = []
        try:
            port = httpd.server_address[1]
            for _ in range(3):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                try:
                    conn.request("POST", "/twirp/trivy.cache.v1.Cache/"
                                 "MissingBlobs", body=json.dumps(
                                     {"artifact_id": "a",
                                      "blob_ids": ["b"]}),
                                 headers={"Content-Type":
                                          "application/json"})
                    resp = conn.getresponse()
                    out.append((resp.status, json.loads(resp.read())))
                except (http.client.RemoteDisconnected,
                        ConnectionResetError):
                    out.append("dropped")
                finally:
                    conn.close()
            out.append(inj.stats())
        finally:
            srv.close()
            httpd.shutdown()
        bodies[pkg] = out
    assert bodies["port"] == bodies["ref"]
    assert bodies["port"][0][0] == 500 and bodies["port"][1] == "dropped"


@pytest.mark.parametrize("spec", ["replica-flaky", "replica-kill:seed=3"])
def test_server_takes_a_route_spec_as_the_reference(spec):
    """A server given a route spec (``server --fault-spec replica-flaky``)
    injects nothing at its own site, as the reference's: every POST is
    answered in full and the injector's counters match."""
    import http.client
    bodies = {}
    for pkg in PKGS:
        inj = FAULTS[pkg].FaultInjector(spec)
        srv, httpd, url = _rpc_server(pkg, injector=inj)
        out = []
        try:
            port = httpd.server_address[1]
            for path, body in (
                    ("/twirp/trivy.cache.v1.Cache/MissingBlobs",
                     {"artifact_id": "a", "blob_ids": ["b"]}),
                    ("/twirp/trivy.scanner.v1.Scanner/Scan",
                     {"target": "t", "artifact_id": "a", "blob_ids": [],
                      "idempotency_key": "k1",
                      "options": {"security_checks": ["vuln"],
                                  "backend": "cpu"}}),
                    ("/twirp/trivy.cache.v1.Cache/MissingBlobs",
                     {"artifact_id": "a", "blob_ids": []})):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                try:
                    conn.request("POST", path, body=json.dumps(body),
                                 headers={"Content-Type":
                                          "application/json"})
                    resp = conn.getresponse()
                    out.append((resp.status, json.loads(resp.read())))
                finally:
                    conn.close()
            out.append(inj.stats())
        finally:
            srv.close()
            httpd.shutdown()
        bodies[pkg] = out
    assert bodies["port"] == bodies["ref"]
    assert [b[0] for b in bodies["port"][:3]] == [200, 200, 200]
    assert bodies["port"][3]["rpc_drops"] == 0 and \
        bodies["port"][3]["rpc_errors"] == 0


def test_server_cli_takes_a_route_spec(tmp_path):
    """``server --fault-spec replica-kill`` is taken by both CLIs and the
    run goes on to the ``--listen`` check (exit 2, the same line)."""
    argv = ["server", "--listen", "127.0.0.1:x", "--fault-spec",
            "replica-kill"]
    got, want = _cli("port", argv + ["--backend", "cpu"]), _cli("ref", argv)
    assert got[0] == want[0] == 2
    assert got[2] == want[2] == ["error: --listen needs host:port, got "
                                 "'127.0.0.1:x'"]


# --- degraded reports -----------------------------------------------------

def _degraded_report(pkg, degraded: bool):
    import importlib
    types = importlib.import_module(("trivy_tpu" if pkg == "ref"
                                     else "trivy_tpu_torch") + ".types")
    r = types.Report(artifact_name="img.tar",
                     artifact_type="container_image",
                     metadata=types.Metadata())
    if degraded:
        r.mark_degraded([{"stage": "device", "kind": "quarantined",
                          "message": "injected poison"}])
    return r


@pytest.mark.parametrize("fmt", ["json", "table", "sarif", "github",
                                 "cyclonedx", "spdx"])
def test_degraded_annotations_equal_the_reference(fmt):
    """A degraded report and a clean one through each writer: the
    port's output equals the reference's (the status and the causes in
    the JSON, the table's banner, SARIF's ``scanStatus``, GitHub's
    ``ScanStatus``, the CycloneDX property and the SPDX comment);
    random ids and timestamps are left out."""
    import importlib

    def render(pkg, degraded):
        root = "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"
        rep = _degraded_report(pkg, degraded)
        buf = io.StringIO()
        if fmt == "json":
            return rep.to_dict()
        if fmt == "table":
            return importlib.import_module(
                root + ".report.writer").render_table(rep)
        if fmt == "sarif":
            importlib.import_module(root + ".report.sarif") \
                .SarifWriter(buf).write(rep)
            return json.loads(buf.getvalue())["runs"][0].get("properties")
        if fmt == "github":
            importlib.import_module(root + ".report.github") \
                .GithubWriter(buf).write(rep)
            return json.loads(buf.getvalue()).get("metadata", {}).get(
                "aquasecurity:trivy:ScanStatus")
        if fmt == "cyclonedx":
            return importlib.import_module(root + ".sbom.cyclonedx") \
                .Marshaler().marshal(rep)["metadata"].get("properties")
        return importlib.import_module(root + ".sbom.spdx") \
            .Marshaler().marshal(rep)["creationInfo"].get("comment")

    for degraded in (True, False):
        assert render("port", degraded) == render("ref", degraded)
    if fmt == "json":
        assert render("port", True)["Status"] == "degraded"
        assert "Status" not in render("port", False)
    if fmt == "table":
        assert "DEGRADED" in render("port", True)


# --- the CLI --------------------------------------------------------------

_TRACE = re.compile(r"trace [0-9a-f]+ captured \(dump: [^)]*\)")


def _untraced(text: str):
    """A JSON text with each ``obs/trace`` cause's trace id and dump
    path replaced (they are random per run)."""
    return json.loads(_TRACE.sub("trace ID captured (dump: PATH)", text))


def _cli(pkg, argv) -> tuple:
    from trivy_tpu.cli import main as rmain
    from trivy_tpu_torch.cli import main as tmain
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = (rmain if pkg == "ref" else tmain)(argv)
    return code, out.getvalue(), [ln for ln in err.getvalue().splitlines()
                                  if ln.startswith(("error:", "warning:"))]


@pytest.mark.parametrize("spec", [
    "poison-image:poison=img1.tar", "device-transient",
    "corrupt-layer:corrupt=img2.tar",
    "standard-outage:poison=img1.tar", "replica-flaky", "replica-kill"])
def test_cli_fault_spec_end_to_end(fleets, spec, tmp_path, monkeypatch):
    """``image a b c --fault-spec SPEC --format json`` on both packages:
    the same exit code, the same reports (statuses and causes
    included), the same ``error:`` and ``warning:`` lines. A route
    spec runs the fleet as the reference's does: nothing of it fires
    there."""
    monkeypatch.chdir(tmp_path)
    paths = fleets[8]["paths"][:4]
    argv = ["image", *paths, "--format", "json", "--backend", "cpu",
            "--security-checks", "vuln,secret", "--fault-spec", spec]
    want = _cli("ref", argv + ["--no-cache", "--no-memo"])
    got = _cli("port", argv)
    assert got[0] == want[0]
    assert _untraced(got[1]) == _untraced(want[1])
    assert [ln.split(" (")[0] for ln in got[2]] == \
        [ln.split(" (")[0] for ln in want[2]]
    if "poison" in spec:
        degraded = [d["ArtifactName"] for d in json.loads(got[1])
                    if d.get("Status") == "degraded"]
        assert len(degraded) == 1 and "img1.tar" in degraded[0]


def test_cli_sched_stats_carry_the_injector(fleets, tmp_path, monkeypatch):
    """``--sched-stats`` with ``--fault-spec`` dumps the injector's
    counters under ``faults``, as the reference's."""
    monkeypatch.chdir(tmp_path)
    paths = fleets[6]["paths"][:3]
    from trivy_tpu_torch.cli import main as tmain
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert tmain(["image", *paths, "--backend", "cpu", "--format",
                      "json", "--sched-stats", "--fault-spec",
                      "device-transient"]) == 0
    text = err.getvalue()
    stats, _ = json.JSONDecoder().raw_decode(text[text.index("{\n"):])
    assert stats["faults"]["scenario"] == "device-transient"
    assert stats["faults"]["device_faults"] == 2
    assert set(stats["faults"]) == set(
        rfaults.FaultInjector("device-transient").stats())


@pytest.mark.parametrize("entry", ["image", "fs", "rootfs", "config",
                                   "sbom", "client"])
def test_single_target_entries_refuse_fault_spec(entry, fleets, tmp_path,
                                                 monkeypatch):
    """Every single-target entry refuses ``--fault-spec`` with the
    reference's exit 2 and message, before any work."""
    import trivy_tpu_torch.cli as tcli
    monkeypatch.chdir(tmp_path)
    target = {"image": fleets[6]["paths"][0], "client":
              fleets[6]["paths"][0], "sbom": str(tmp_path / "bom.json")}
    argv = [entry, target.get(entry, str(tmp_path)), "--backend", "cpu",
            "--fault-spec", "poison-image"]

    def no_work(*a, **k):
        raise AssertionError("work before the refusal")

    for name in ("load_store", "scan_image", "scan_fs", "scan_sbom"):
        monkeypatch.setattr(tcli, name, no_work)
    got = _cli("port", argv)
    ref_entry = "image" if entry == "client" else entry
    want = _cli("ref", [ref_entry] + argv[1:])
    assert got[0] == want[0] == 2
    assert got[2] == want[2] == [
        "error: --fault-spec is wired into multi-target image scans, "
        "the server, and the route command; this command would inject "
        "nothing"]


@pytest.mark.parametrize("spec,want", [
    ("no-such-scenario", "unknown fault scenario"),
    ("cache-outage:bogus_key=1", "bad fault-spec entry"),
    ("hostile-ingest:hostile=nope", "unknown hostile builder")])
def test_cli_bad_spec_fails_up_front(fleets, spec, want, tmp_path,
                                     monkeypatch):
    """A malformed spec ends the fleet run with exit 1 and its
    ``error:`` line before any scan (the reference's ``main`` catches
    it the same way)."""
    import trivy_tpu_torch.cli as tcli
    monkeypatch.chdir(tmp_path)

    def no_work(*a, **k):
        raise AssertionError("a scan ran")

    monkeypatch.setattr(tcli, "BatchScanRunner", no_work)
    argv = ["image", *fleets[6]["paths"][:2], "--backend", "cpu",
            "--fault-spec", spec]
    got = _cli("port", argv)
    assert got[0] == 1 and len(got[2]) == 1 and want in got[2][0]
    ref = _cli("ref", argv + ["--no-cache"])
    assert ref[0] == 1 and ref[2][-1] == got[2][0]
