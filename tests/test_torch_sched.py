"""The continuous-batching scheduler: ``trivy_tpu_torch.sched`` with
``obs`` (trace, recorder, cost, slo), the runner's scheduled routes
(``BatchScanRunner(sched=SchedConfig(...))``: ``scan_paths``,
``scan_boms``, ``submit_path``) and ``python -m trivy_tpu_torch image
a.tar b.tar ...`` at its default ``--sched on``, against the JAX
package's (JAX on the CPU) in the same process.

The host pieces run seeded schedules through both packages on a fake
clock (queue, coalescer, tenant WFQ order, token buckets, the config
parsers, histograms, the cost ledger, the SLO engine): results equal,
errors equal by type and message. The runner's fleet is
``tests/test_torch_fleet.py``'s eight docker-save targets; its
scheduled reports must equal the reference's scheduled ones and its
``--sched off`` ones on ``cpu`` and ``cpu-ref`` at dispatch depth 1,
2 and 4 with several coalesced batches. Trace ids are random: only
the id and the dump path inside an ``obs/trace`` cause are replaced
before comparing."""

import json
import random
import re
import threading
import time
from types import SimpleNamespace

import pytest
import yaml

import trivy_tpu.obs.cost as rcost
import trivy_tpu.obs.slo as rslo
import trivy_tpu.sched as rsched
import trivy_tpu_torch.obs.cost as tcost
import trivy_tpu_torch.obs.slo as tslo
import trivy_tpu_torch.sched as tsched
from chip_smoke import _strip_status
from tests.test_torch_fleet import (N_IMAGES, _norm, _out,  # noqa: F401
                                    _reset_secret_config, _run, fleet)
from tests.test_torch_scan_local import _fast_yaml
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_witness import (assert_witnessed_clean,
                                 torch_lock_witness)  # noqa: F401
from trivy_tpu.cli import main as rmain
from trivy_tpu.faults import FaultInjector
from trivy_tpu.runtime import BatchScanRunner as RRunner
from trivy_tpu.types import ScanOptions as RScanOptions
from trivy_tpu_torch.cli import main as tmain
from trivy_tpu_torch.faults import FaultInjector as TFaultInjector
from trivy_tpu_torch.runtime import BatchScanRunner as TRunner
from trivy_tpu_torch.types import ScanOptions as TScanOptions

PKGS = {"ref": SimpleNamespace(sched=rsched, cost=rcost, slo=rslo),
        "port": SimpleNamespace(sched=tsched, cost=tcost, slo=tslo)}

_TRACE = re.compile(r"trace [0-9a-f]+ captured \(dump: [^)]*\)")


def _untraced(obj):
    """``obj`` as JSON with each ``obs/trace`` cause's trace id and
    dump path replaced (they are random per run)."""
    return _TRACE.sub("trace ID captured (dump: PATH)", json.dumps(obj))


def _both(fn) -> dict:
    """``fn(pkg)`` for each package: its value, or (error type name,
    message) when it raises."""
    out = {}
    for name, pkg in PKGS.items():
        try:
            out[name] = ("ok", fn(pkg))
        except Exception as e:      # noqa: BLE001 — compared below
            out[name] = (type(e).__name__, str(e))
    return out


@pytest.fixture
def clock(monkeypatch):
    """A fake monotonic clock for both packages' queues, buckets,
    coalescers and books (they read ``time.monotonic``)."""
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


# --- the host pieces, on seeded schedules ------------------------------

def _req(pkg, name, tenant="", priority=0, nbytes=0, njobs=0,
         group="g"):
    r = pkg.sched.ScanRequest(name, lambda req: None, tenant=tenant,
                              priority=priority, group=group)
    r.work = pkg.sched.AnalyzedWork(
        candidates=[("/f", b"x" * nbytes)] if nbytes else [],
        jobs=[object()] * njobs, group=group)
    return r


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tenant_queue_wfq_order_equals_reference(seed, clock):
    spec = "alice:weight=4;bob:weight=1,max_queued=5;carol:weight=2"
    rng = random.Random(seed)
    ops = [(rng.random() < 0.7, rng.choice(["alice", "bob", "carol",
                                            "dave"]),
            rng.randrange(3)) for _ in range(120)]

    def run(pkg):
        q = pkg.sched.TenantQueue(
            maxsize=40, tenancy=pkg.sched.parse_tenant_config(spec))
        log = []
        for k, (put, tenant, prio) in enumerate(ops):
            if put:
                try:
                    q.put(_req(pkg, f"r{k}", tenant, prio))
                    log.append(("put", k))
                except pkg.sched.SchedError as e:
                    log.append((type(e).__name__, str(e)))
            else:
                r = q.get(timeout=0)
                log.append(("get", r.name if r else None))
                if r is not None and k % 3 == 0:
                    q.note_done(r, "ok", 0.01 * k)
        return log, q.depth(), q.tenant_snapshot()

    got = _both(run)
    assert got["port"] == got["ref"] and got["ref"][0] == "ok"
    log = got["ref"][1][0]
    assert {e[0] for e in log} >= {"put", "get", "RateLimitedError"}


def test_token_bucket_and_rate_limit_equal_reference(clock):
    def run(pkg):
        b = pkg.sched.TokenBucket(rate=2.0, burst=3)
        waits = []
        for dt in (0, 0, 0, 0, 0.25, 0.1, 1.0, 0, 0, 0, 0):
            clock[0] += dt
            waits.append(round(b.take(), 9))
        q = pkg.sched.TenantQueue(tenancy=pkg.sched.parse_tenant_config(
            "alice:rate=1,burst=2"))
        out = []
        for _ in range(4):
            try:
                q.put(_req(pkg, "a", "alice"))
                out.append("ok")
            except pkg.sched.RateLimitedError as e:
                out.append((str(e), e.retry_after_s, e.tenant))
        return waits, out

    got = _both(run)
    assert got["port"] == got["ref"] and got["ref"][0] == "ok"
    assert got["ref"][1][0][:4] == [0.0, 0.0, 0.0, 0.5]


COALESCE_CASES = [
    # (config kwargs, [(nbytes, njobs, group)], upstream idle)
    ({"max_batch_bytes": 4096, "flush_timeout_s": 10.0,
      "eager_idle_flush": False},
     [(1500, 0, "a"), (1500, 0, "a"), (1500, 3, "a"), (100, 0, "b")],
     False),
    ({"max_batch_items": 2}, [(0, 5, "a")] * 5, True),
    ({"max_batch_jobs": 600, "flush_timeout_s": 10.0,
      "eager_idle_flush": False},
     [(0, 400, "a"), (0, 300, "a"), (70000, 10, "a")], False),
]


@pytest.mark.parametrize("case", range(len(COALESCE_CASES)))
def test_coalescer_batches_equal_reference(case, clock):
    kw, vols, idle = COALESCE_CASES[case]

    def run(pkg):
        cfg = pkg.sched.SchedConfig(**kw)
        c = pkg.sched.Coalescer(cfg)
        out = []
        for k, (nb, nj, g) in enumerate(vols):
            c.add(_req(pkg, f"r{k}", nbytes=nb, njobs=nj, group=g))
            out.append(("ready", c.ready_group(idle), c.pending()))
        clock[0] += 20.0            # every group's wait is over
        while True:
            g = c.ready_group(idle)
            if g is None:
                break
            b = c.take(g)
            out.append(([r.name for r in b.requests], b.group,
                        b.candidate_bytes, b.jobs, b.bucket_bytes,
                        b.bucket_jobs, round(b.occupancy, 6)))
        out.append([r.name for r in c.drain()])
        return out

    got = _both(run)
    assert got["port"] == got["ref"] and got["ref"][0] == "ok"


def test_histogram_and_sched_metrics_equal_reference(clock):
    rng = random.Random(5)
    vals = [rng.lognormvariate(-4, 2) for _ in range(400)]

    def run(pkg):
        h = pkg.sched.LatencyHistogram()
        for v in vals:
            h.observe(v)
        m = pkg.sched.SchedMetrics()
        for k, v in enumerate(vals[:40]):
            m.observe(m.PHASES[k % 5], v)
            m.inc("submitted")
        m.note_batch(3, 5000, 700, 65536, 2048)
        return ([round(h.quantile(q), 9) for q in (0.1, 0.5, 0.9,
                                                   0.99, 1.0)],
                h.to_dict(), h.raw()["counts"],
                {k: v for k, v in m.snapshot().items()
                 if k in ("counters", "batch", "latency")})

    got = _both(run)
    assert got["port"] == got["ref"] and got["ref"][0] == "ok"


TENANT_SPECS = [
    "", "alice:weight=4,rate=100,burst=200,max_queued=64;bob:weight=1",
    "default:rate=50,max_inflight=128", "alice", "alice:colour=red",
    "alice:weight=heavy", ":weight=1", "a:weight=2;;b:rate=1,",
]
BUDGET_SPECS = [
    "", "alice:device_s=2.5,window_s=60,action=throttle;bob:device_s=1",
    "a:device_s=1,action=deprioritize,floor=-5", "a:window_s=60",
    "a:device_s=0", "a:device_s=1,action=shout", "a:device_s=x",
    "a:cost=1", "a",
]
SLO_SPECS = [
    "", "avail:kind=availability,objective=0.999;"
    "lat:kind=latency,objective=0.95,threshold_s=2.5,tenant=alice",
    "eff:kind=efficiency,objective=0.5", "x:kind=speed",
    "x:objective=1.5", "lat:kind=latency", "a:objective=0.9;a:kind=latency,"
    "threshold_s=1", "x:objective=high", "  ;  ",
]


@pytest.mark.parametrize("text", TENANT_SPECS)
def test_parse_tenant_config_equals_reference(text):
    got = _both(lambda p: repr(p.sched.parse_tenant_config(text)))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("text", BUDGET_SPECS)
def test_parse_budget_config_equals_reference(text):
    got = _both(lambda p: repr(p.cost.parse_budget_config(text)))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("text", SLO_SPECS)
def test_parse_slo_config_equals_reference(text):
    got = _both(lambda p: repr(p.slo.parse_slo_config(text)))
    assert got["port"] == got["ref"]


def test_config_files_equal_reference(tmp_path):
    good = tmp_path / "tenants.json"
    good.write_text(json.dumps({"alice": {"weight": 3, "rate": 9},
                                "default": {"max_queued": 4}}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"alice": {"weight": 3, "speed": 1}}))
    budget = tmp_path / "budget.json"
    budget.write_text(json.dumps({"bob": {"device_s": 2,
                                          "action": "deprioritize"}}))
    for path in (good, bad, budget):
        for parse in (lambda p, s=str(path):
                      repr(p.sched.parse_tenant_config(s)),
                      lambda p, s=str(path):
                      repr(p.cost.parse_budget_config(s))):
            got = _both(parse)
            assert got["port"] == got["ref"]


def test_cost_ledger_and_slo_engine_equal_reference(clock):
    rng = random.Random(11)
    charges = [(rng.choice(["alice", "bob", ""]), rng.random(),
                rng.random(), rng.randrange(9)) for _ in range(60)]
    outcomes = [(rng.choice(["ok", "degraded", "failed", "timed_out",
                             "cancelled"]), rng.random() * 40,
                 rng.choice(["alice", "bob"])) for _ in range(200)]

    def run(pkg):
        led = pkg.cost.CostLedger(max_tenants=2)
        for k, (t, a, b, n) in enumerate(charges):
            clock[0] += 3.0
            led.charge(t, device_interval_s=a, device_dfa_s=b,
                       bytes_in=n, requests=1)
        snap = led.snapshot(aot_compile_s=1.5)
        win = led.window_device_s("alice", 60.0)
        try:
            led.charge("x", gpu_s=1)
        except ValueError as e:
            bad = str(e)
        eng = pkg.slo.SloEngine(pkg.slo.parse_slo_config(
            "avail:objective=0.9;lat:kind=latency,objective=0.9,"
            "threshold_s=20,tenant=alice;eff:kind=efficiency,"
            "objective=0.8"))
        for k, (o, lat, t) in enumerate(outcomes):
            clock[0] += 1.0
            eng.record(o, latency_s=lat, tenant=t, trace_id=f"{k:032x}")
            eng.record_device(0.01 * (k % 7), idle_s=0.004 * (k % 5))
        return (snap, round(win, 9), bad,
                pkg.cost.balance(snap["device_s"], snap["device_s"] * 1.01),
                pkg.cost.balance(1.0, 2.0), eng.snapshot())

    got = _both(run)
    assert got["port"] == got["ref"] and got["ref"][0] == "ok"
    tenants = got["ref"][1][0]["tenants"]
    assert len(tenants) == 3 and "other" in tenants


# --- the scheduler itself ----------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_close_and_drain_strand_nothing(pkg):
    """drain() lets queued and in-flight requests finish; close()
    racing a request mid-analyze still resolves it; submit after
    close raises SchedulerClosed and revives no thread."""
    s = PKGS[pkg].sched

    def slow(req):
        time.sleep(0.05)
        return s.AnalyzedWork(finish=lambda f, d: req.name)

    sched = s.ScanScheduler(config=s.SchedConfig(workers=2),
                            backend="cpu")
    reqs = [sched.submit(s.ScanRequest(f"r{i}", slow)) for i in range(6)]
    assert sched.drain(timeout_s=20) is True
    assert [r.result(timeout=1) for r in reqs] == \
        [f"r{i}" for i in range(6)]
    with pytest.raises(s.SchedulerClosed):
        sched.submit(s.ScanRequest("late", slow))
    assert not sched._threads

    sched = s.ScanScheduler(config=s.SchedConfig(workers=1),
                            backend="cpu")
    req = sched.submit(s.ScanRequest("mid", slow))
    time.sleep(0.02)
    sched.close()
    try:
        assert req.result(timeout=5) == "mid"
    except s.SchedulerClosed:
        pass
    assert req.done
    with pytest.raises(s.SchedulerClosed, match="scheduler is closed"):
        sched.submit(s.ScanRequest("late", slow))
    snap = sched.stats()
    assert snap["counters"]["submitted"] == 1
    assert sched.metrics.in_flight() == 0


# --- the runner's scheduled route on the fleet --------------------------

_SCHED: dict = {}


def _sched_cfg(pkg, depth: int = 2):
    # two requests per batch at most: 8 targets form several batches
    return PKGS[pkg].sched.SchedConfig(max_batch_items=2,
                                       flush_timeout_s=0.01,
                                       dispatch_depth=depth)


def _ref_runs(fleet, db: str) -> tuple:
    """The reference's scheduled and ``--sched off`` results, once per
    store kind."""
    if db not in _SCHED:
        store = fleet["stores"][db][0]
        off = _norm(RRunner(store=store, backend="tpu", sched="off")
                    .scan_paths(fleet["plan"]["paths"]))
        runner = RRunner(store=store, backend="tpu",
                         sched=_sched_cfg("ref"))
        try:
            on = _norm(runner.scan_paths(fleet["plan"]["paths"]))
        finally:
            runner.close()
        _SCHED[db] = (_untraced(on), off)
    return _SCHED[db]


SCAN_CASES = [(db, backend, depth)
              for db, depths in (("compiled", (1, 2, 4)),
                                 ("fixtures", (2,)))
              for backend in ("cpu", "cpu-ref") for depth in depths]


@pytest.mark.parametrize("db,backend,depth", SCAN_CASES)
def test_scan_paths_scheduled_equals_reference(fleet, db, backend,
                                               depth):
    want_on, want_off = _ref_runs(fleet, db)
    runner = TRunner(store=fleet["stores"][db][1], backend=backend,
                     sched=_sched_cfg("port", depth))
    try:
        res = runner.scan_paths(fleet["plan"]["paths"])
    finally:
        runner.close()
    got = _norm(res)
    assert _untraced(got) == want_on
    broken = fleet["plan"]["broken"]
    # the scheduled slots equal --sched off's but for the broken tar's
    # trailing obs/trace cause (the direct path traces nothing)
    assert got[:broken] + got[broken + 1:] == \
        want_off[:broken] + want_off[broken + 1:]
    assert got[broken][4][:-1] == want_off[broken][4]
    assert got[broken][4][-1]["Kind"] == "trace"
    counters = runner.last_stats["sched"]["counters"]
    assert counters["batches"] >= 3 and counters["completed"] == 7
    assert counters["failed"] == 1
    assert not counters.get("quarantined")
    assert runner.last_stats["images"] == N_IMAGES
    assert runner.last_stats["sched"]["config"]["max_batch_items"] == 2


@pytest.mark.parametrize("backend", ["cpu", "cpu-ref"])
def test_scan_boms_scheduled_equals_reference(fleet, backend):
    store = fleet["stores"]["compiled"]
    want = RRunner(store=store[0], backend="tpu",
                   sched="off").scan_boms(fleet["boms"])
    rr = RRunner(store=store[0], backend="tpu", sched=_sched_cfg("ref"))
    tr = TRunner(store=store[1], backend=backend,
                 sched=_sched_cfg("port"))
    try:
        rres, tres = rr.scan_boms(fleet["boms"]), tr.scan_boms(
            fleet["boms"])
    finally:
        rr.close()
        tr.close()
    assert _norm(tres) == _norm(rres) == _norm(want)
    assert [r.status for r in tres] == ["ok", "failed", "ok", "ok"]
    assert tr.last_stats["sboms"] == 4


def test_poison_image_is_quarantined_alone(fleet):
    """One image's device dispatch always fails: bisect and quarantine
    corner it (the reference's ``poison-image`` scenario), its report
    completes on the host path marked degraded, and every other slot
    equals the healthy run."""
    paths = fleet["plan"]["paths"]
    victim = paths[2]
    marker = victim.rsplit("/", 1)[-1]
    store = fleet["stores"]["compiled"]
    rr = RRunner(store=store[0], backend="tpu", sched=_sched_cfg("ref"),
                 fault_injector=FaultInjector(
                     f"poison-image:poison={marker}"))
    inj = TFaultInjector(f"poison-image:poison={marker}")
    tr = TRunner(store=store[1], backend="cpu", sched=_sched_cfg("port"),
                 fault_injector=inj)
    try:
        rres = rr.scan_paths(paths)
        tres = tr.scan_paths(paths)
        rstats, tstats = rr.last_stats["sched"], tr.last_stats["sched"]
    finally:
        rr.close()
        tr.close()
    assert _untraced(_norm(tres)) == _untraced(_norm(rres))
    degraded = [r for r in tres if r.status == "degraded"]
    assert [r.name for r in degraded] == [victim]
    assert [c.kind for c in degraded[0].causes] == ["quarantined", "trace"]
    assert tstats["counters"]["quarantined"] == 1
    assert tstats["counters"]["host_fallbacks"] == 1
    assert tstats["counters"]["quarantined"] == \
        rstats["counters"]["quarantined"]
    assert inj.counters["device_dispatches"] > \
        tstats["counters"]["batches"]
    healthy = _ref_runs(fleet, "compiled")[1]
    for i, (r, want) in enumerate(zip(_norm(tres), healthy)):
        if i == 2:
            assert _strip_status(r[1]) == want[1]
        elif i != fleet["plan"]["broken"]:
            assert r == want


class _BrokenSieve:
    """A secret scanner whose device dispatch raises an error that no
    fault injector raised; its whole-file host scanner finds nothing."""

    scanner = SimpleNamespace(
        scan=lambda path, content: SimpleNamespace(findings=[]))

    def dispatch_files(self, files):
        raise RuntimeError("CUDA error: an illegal memory access")


def _broken_sieve_run(pkg, backend: str, injector) -> tuple:
    """Three one-file requests through ``pkg``'s scheduler over
    ``_BrokenSieve``: (each result or (error type, message, type of its
    cause)), counters)."""
    s = PKGS[pkg].sched

    def analyze(req):
        return s.AnalyzedWork(candidates=[("/f", b"x")],
                              finish=lambda found, detected: req.name)

    sched = s.ScanScheduler(config=s.SchedConfig(workers=1),
                            backend=backend,
                            secret_scanner=_BrokenSieve())
    sched.fault_injector = injector
    try:
        reqs = [sched.submit(s.ScanRequest(f"r{i}", analyze))
                for i in range(3)]
        out = []
        for r in reqs:
            try:
                out.append(r.result(timeout=20))
            except Exception as e:   # noqa: BLE001 — compared below
                out.append((type(e).__name__, str(e),
                            type(e.__cause__).__name__))
        counters = sched.stats()["counters"]
    finally:
        sched.close()
    return out, counters


@pytest.mark.parametrize("backend,injected",
                         [("cuda", False), ("cuda", True), ("cpu", False)])
def test_only_injected_faults_finish_on_the_host_on_the_card(backend,
                                                             injected):
    """On the card the isolation ladder takes only what the fault
    injector raised: any other dispatch error fails each request with
    a ``DeviceDispatchError`` caused by it, and nothing is quarantined
    or finished on the host. The CPU groups keep the reference's
    ladder for every error. Nothing here launches on a card: the
    dispatch fails before any tensor is made."""
    injector = TFaultInjector("poison-image:poison=r") if injected \
        else None
    out, c = _broken_sieve_run("port", backend, injector)
    fallbacks = c.get("host_fallbacks", 0)
    if backend == "cuda" and not injected:
        assert out == [("DeviceDispatchError", "device dispatch failed: "
                        "CUDA error: an illegal memory access",
                        "RuntimeError")] * 3
        assert (c["failed"], c["device_failures"]) == (3, 3)
        assert fallbacks == c.get("quarantined", 0) == 0
        return
    assert out == ["r0", "r1", "r2"]
    assert fallbacks == c["quarantined"] == c["completed"] == 3
    want_out, want = _broken_sieve_run("ref", backend, injector)
    assert want_out == out
    assert {k: want.get(k) for k in ("quarantined", "host_fallbacks",
                                     "completed", "failed")} == \
        {k: c.get(k) for k in ("quarantined", "host_fallbacks",
                               "completed", "failed")}


def test_deadline_fleet_fails_every_slot_typed(fleet):
    paths = fleet["plan"]["paths"][:3]
    out = {}
    for name, runner, opts in (
            ("ref", RRunner(store=fleet["stores"]["compiled"][0],
                            backend="tpu", sched=_sched_cfg("ref")),
             RScanOptions(backend="tpu")),
            ("port", TRunner(store=fleet["stores"]["compiled"][1],
                             backend="cpu", sched=_sched_cfg("port")),
             TScanOptions(backend="cpu"))):
        opts.deadline_s = 1e-9       # expires immediately
        t0 = time.monotonic()
        try:
            out[name] = runner.scan_paths(paths, opts)
        finally:
            runner.close()
        assert time.monotonic() - t0 < 30
    assert _untraced(_norm(out["port"])) == _untraced(_norm(out["ref"]))
    for r in out["port"]:
        assert "deadline exceeded" in r.error
        assert [c.kind for c in r.causes] == ["deadline_exceeded", "trace"]


class _Gate:
    """Holds every host analyze until opened (the three hooks)."""

    def __init__(self):
        self.open = threading.Event()

    def on_host_analyze(self, name: str) -> None:
        self.open.wait(20)

    def on_image_load(self, name: str) -> None:
        pass

    def on_device_dispatch(self, names: list) -> None:
        pass


def test_submit_path_raises_typed_backpressure(fleet):
    """A tenant over its rate gets ``RateLimitedError`` (the 429), a
    full queue ``QueueFullError`` (the 503); admitted requests still
    resolve to their targets' reports."""
    paths = fleet["plan"]["paths"]
    gate = _Gate()
    cfg = tsched.SchedConfig(
        max_queue=1, workers=1, flush_timeout_s=0.01,
        tenancy=tsched.parse_tenant_config("alice:rate=0.001,burst=1"))
    runner = TRunner(store=fleet["stores"]["compiled"][1],
                     backend="cpu", sched=cfg, fault_injector=gate)
    try:
        first = runner.submit_path(paths[0], tenant="alice")
        with pytest.raises(tsched.RateLimitedError,
                           match=r"tenant 'alice' over rate limit"):
            runner.submit_path(paths[1], tenant="alice")
        admitted = [first]
        with pytest.raises(tsched.QueueFullError,
                           match=r"scan queue full \(1 pending\)"):
            for p in paths[1:6]:
                admitted.append(runner.submit_path(p, tenant="bob"))
        gate.open.set()
        got = [_norm([r.result(timeout=120)]) for r in admitted]
        stats = runner.scheduler.stats()
    finally:
        gate.open.set()
        runner.close()
    want = _ref_runs(fleet, "compiled")[1]
    assert got == [[want[i]] for i in range(len(admitted))]
    assert stats["counters"]["rejected"] >= 2
    assert stats["counters"]["rate_limited"] == 1
    assert stats["tenants"]["alice"]["counters"]["rejected_rate"] == 1


def test_concurrent_submitters_get_their_own_reports(fleet,
                                                    torch_lock_witness):
    """Four clients through one runner, under the port's lock-order
    witness: each gets its own report, and no lock-order cycle or
    pool self-join is seen."""
    paths = fleet["plan"]["paths"][:4]
    runner = TRunner(store=fleet["stores"]["compiled"][1],
                     backend="cpu", sched=tsched.SchedConfig(
                         flush_timeout_s=0.02))
    got = {}

    def client(i):
        got[i] = _norm([runner.submit_path(paths[i]).result(timeout=120)])

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        runner.close()
    want = _ref_runs(fleet, "compiled")[1]
    assert [got[i] for i in range(4)] == [[want[i]] for i in range(4)]
    assert_witnessed_clean(torch_lock_witness)


def test_a_blob_put_meanwhile_keeps_its_patch(fleet):
    """Two scheduled requests whose images share the secret layer both
    find its blob missing; the first puts it and patches its secret in
    before the second puts its own analysis of it. The second put is
    skipped, so the patched blob stays the one the first request's
    finish reads (a second, unpatched copy replaced it, and a report
    lost the shared secret, now and then on a busy host)."""
    from trivy_tpu_torch.artifact import MemoryCache
    from trivy_tpu_torch.artifact.image import load_image
    from trivy_tpu_torch.runtime.batch import _SchedImageArtifact
    paths = fleet["plan"]["paths"][:2]
    runner = TRunner(store=fleet["stores"]["compiled"][1], backend="cpu",
                     sched=_sched_cfg("port"))
    cache, sched = MemoryCache(), runner.scheduler
    opt = runner._image_opt(True)

    def artifact(path):
        a = _SchedImageArtifact(load_image(path), cache, opt)
        a._sched = sched
        a._sched_req = tsched.ScanRequest(path, analyze=lambda r: None)
        return a

    first, second = artifact(paths[0]), artifact(paths[1])
    missing_blobs = cache.missing_blobs
    patched: list = []
    turns = iter([True])

    def first_runs_meanwhile(artifact_id, blob_ids):
        out = missing_blobs(artifact_id, blob_ids)
        if next(turns, False):
            # the second request has taken its missing blobs; the
            # first analyzes, puts and patches the shared layers
            ref = first.inspect()
            shared = set(ref.blob_ids) & set(out[1])
            for blob_id in shared:
                cache.get_blob(blob_id).secrets = ["patched"]
            patched.extend(shared)
        return out

    cache.missing_blobs = first_runs_meanwhile
    try:
        ref = second.inspect()
    finally:
        runner.close()
    assert len(patched) >= 2      # the base, the secret layer, the corpus
    assert set(patched) <= set(ref.blob_ids)
    assert all(cache.get_blob(b).secrets == ["patched"] for b in patched)
    # the log of puts empties once no inspect is in flight
    assert sched._analysis_puts == {} and sched._inspects == []


def test_scheduler_books_balance_under_a_storm(torch_lock_witness):
    """Many submitters, more host workers than cores and a short
    switch interval: every request resolves to its own result exactly
    once, and the counters and tenant books balance (a lost update in
    any of them breaks an equality below). Under the port's lock-order
    witness: no order cycle, no pool self-join."""
    import os
    import sys
    s = tsched
    workers = (os.cpu_count() or 2) + 2
    sched = s.ScanScheduler(config=s.SchedConfig(
        workers=workers, max_batch_items=3, flush_timeout_s=0.001),
        backend="cpu")
    got, reqs = {}, []
    lock = threading.Lock()

    def analyze(req):
        return s.AnalyzedWork(finish=lambda f, d, n=req.name: n)

    def submitter(k):
        for i in range(40):
            r = sched.submit(s.ScanRequest(f"{k}-{i}", analyze,
                                           tenant=f"t{k % 3}"),
                             block=True)
            with lock:
                reqs.append(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        for r in reqs:
            got[r.name] = r.result(timeout=60)
        assert sched.drain(timeout_s=30)
    finally:
        sys.setswitchinterval(old)
        sched.close()
    assert len(reqs) == 240 and all(got[n] == n for n in got)
    snap = sched.stats()
    c = snap["counters"]
    assert c["submitted"] == c["completed"] == 240
    assert sched.metrics.in_flight() == 0
    assert snap["batch"]["items_total"] == 240
    books = snap["tenants"]
    assert sum(b["counters"]["admitted"] for b in books.values()) == 240
    assert all(b["counters"]["admitted"] == b["counters"]["ok"]
               and b["inflight"] == 0 for b in books.values())
    assert_witnessed_clean(torch_lock_witness)


# --- the CLI at its defaults ----------------------------------------------

CLI_CASES = [
    # (format, flags)
    ("json", []),
    ("table", []),
    ("json", ["--tenant-config", "alice:weight=4;default:rate=1000",
              "--sched-workers", "2", "--sched-flush-ms", "5"]),
    ("table", ["--tenant-budget", "anon:device_s=100,window_s=60",
               "--sched-queue", "3", "--dispatch-depth", "1"]),
]


@pytest.mark.parametrize("fmt,flags", CLI_CASES)
def test_cli_default_sched_equals_reference(fleet, fmt, flags, tmp_path,
                                            monkeypatch):
    """``image a.tar b.tar ...`` with no ``--sched``: the json array
    after ``sort_keys`` and the table byte for byte, the exit code and
    the ``error:`` line (the truncated tar's), on ``cpu`` and
    ``cpu-ref``."""
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    monkeypatch.chdir(tmp_path)
    argv = ["image", *fleet["plan"]["paths"], "--format", fmt,
            "--compiled-db", fleet["compiled"], *flags]
    rcode, rout, rsaid, _ = _run(rmain, argv + [
        "--backend", "cpu", "--no-cache", "--no-memo"])
    assert rcode == 1 and len(rsaid) == 1
    assert rsaid[0].startswith(f"error: {fleet['plan']['paths'][-1]}: ")
    for backend in ("cpu", "cpu-ref"):
        code, out, said, _ = _run(tmain, argv + ["--backend", backend])
        assert (code, said) == (rcode, rsaid)
        assert _out(out, fmt) == _out(rout, fmt)


@pytest.mark.parametrize("flags", [
    ["--tenant-config", "alice:colour=red"],
    ["--tenant-config", "alice"],
    ["--tenant-budget", "bob:device_s=0"],
    ["--tenant-budget", "bob:window_s=9"],
])
def test_cli_malformed_tenancy_fails_as_reference(fleet, flags,
                                                  tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["image", *fleet["plan"]["paths"][:2], "--backend", "cpu",
            "--compiled-db", fleet["compiled"], *flags]
    want = _run(rmain, argv + ["--no-cache", "--no-memo"])
    got = _run(tmain, argv)
    assert got[:3] == want[:3]
    assert got[0] == 2 and got[1] == "" and len(got[2]) == 1
    assert got[2][0].startswith("error: --tenant-config/--tenant-budget: ")


def test_cli_sched_stats_dumps_the_scheduler(fleet, tmp_path,
                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    code, out, _, err = _run(tmain, [
        "image", *fleet["plan"]["paths"][:3], "--sched-stats",
        "--compiled-db", fleet["compiled"], "--format", "json",
        "--backend", "cpu"])
    assert code == 0 and len(json.loads(out)) == 3
    stats = json.loads(err[err.index("{"):])
    assert {"counters", "batch", "overlap_ratio", "latency", "dispatch",
            "guard", "detect", "tenants", "slo", "cost",
            "config"} <= set(stats)
    assert stats["counters"]["completed"] == 3
    assert stats["backend"] == "cpu"


def test_smoke_sched_helpers_on_the_cpu(fleet):
    """``chip_smoke.py``'s sched phase helpers, rehearsed on the CPU:
    ``run_sched`` gives the ``--sched off`` reports with every launched
    batch's candidates recorded (the plain sieve counts no launch), the
    port's ``poison-image`` injector corners its target, and the overlap
    arithmetic
    counts only a sieve beside another kernel."""
    from chip_smoke import run_fleet, run_sched, sieve_wave_overlap_us
    from trivy_tpu_torch.artifact import MemoryCache
    from trivy_tpu_torch.cli import secret_scanner
    paths = fleet["plan"]["paths"]
    store = fleet["stores"]["compiled"][1]
    scanner = secret_scanner(backend="cpu")
    off = run_fleet(paths, store, "cpu", scanner, MemoryCache(), 2)
    run = run_sched(paths, store, "cpu", scanner, MemoryCache())
    assert run["texts"] == off["texts"] and off["texts"][0]
    assert run["launches"] == 0 and len(run["batches"]) == \
        run["stats"]["counters"]["batches"] and any(run["batches"])
    assert [i for i, _, _ in run["failed"]] == [fleet["plan"]["broken"]]
    poisoned = run_sched(paths[:3], store, "cpu", scanner, MemoryCache(),
                         TFaultInjector("poison-image:poison=" +
                                        paths[1].rsplit("/", 1)[-1]))
    assert poisoned["status"] == ["ok", "degraded", "ok"]
    assert poisoned["stats"]["counters"]["quarantined"] == 1
    assert sieve_wave_overlap_us([
        ("dfa_blockmask_kernel", 0.0, 10.0), ("interval", 8.0, 12.0),
        ("Memcpy HtoD", 0.0, 10.0), ("dfa_blockmask_kernel", 20.0, 30.0),
        ("gather", 30.0, 31.0)]) == 2.0
