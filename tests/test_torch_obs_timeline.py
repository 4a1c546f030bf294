"""``trivy_tpu_torch/obs/timeline.py`` and ``obs/profiler.py`` against
the JAX package's: the same seeded span lists through both packages'
``Timeline`` give exactly equal reports (the partition, the per-batch
breakdown, coverage), with the reference's seeded partition and
translation properties held on the port; the fleet merge and the span
export round trip likewise. Then the host profiler's unit cases (the
reference's ``tests/test_obs_profiler.py``, without its wall-clock
waits) and ``device_trace`` on the CPU backends."""

from __future__ import annotations

import json
import threading
import time
from collections import namedtuple

import numpy as np
import pytest

import trivy_tpu.obs.timeline as rtl
import trivy_tpu_torch.obs.timeline as ttl
from trivy_tpu_torch.obs.profiler import (HostProfiler, device_trace,
                                          get_profiler)
from trivy_tpu_torch.obs.timeline import (CAUSE_SPANS, CAUSES,
                                          DEVICE_BUSY, Timeline)

FakeSpan = namedtuple("FakeSpan", "name start_mono end_mono attrs",
                      defaults=({},))

NAMES = tuple(DEVICE_BUSY) + tuple(
    n for _, names in CAUSE_SPANS for n in names) + ("scan", "bogus")


def _soup(seed: int, n_max: int = 80, t_max: float = 50.0) -> list:
    rng = np.random.default_rng(1000 + seed)
    spans = []
    for _ in range(int(rng.integers(1, n_max))):
        s = float(rng.uniform(0, t_max))
        d = float(rng.uniform(0, 10))
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        attrs = {"batch": int(rng.integers(1, 5))} \
            if name == "device" and rng.random() < 0.5 else {}
        spans.append(FakeSpan(name, s, s + d, attrs))
    return spans


def _check_partition(tl) -> dict:
    attr = tl.attribute()
    assert set(attr) == set(CAUSES)
    assert all(v >= 0.0 for v in attr.values())
    assert abs(tl.busy_s + tl.idle_s - tl.window_s) < 1e-6
    assert abs(sum(attr.values()) - tl.idle_s) < 1e-6
    for ivs in (tl.busy_intervals(), tl.idle_intervals()):
        for (_, e0), (s1, _) in zip(ivs, ivs[1:]):
            assert e0 <= s1
    return attr


def test_constants_equal_reference():
    assert ttl.CAUSES == rtl.CAUSES
    assert ttl.CAUSE_SPANS == rtl.CAUSE_SPANS
    assert ttl.DEVICE_BUSY == rtl.DEVICE_BUSY
    assert ttl.FLEET_CAUSES == rtl.FLEET_CAUSES


@pytest.mark.parametrize("seed", range(12))
def test_report_equals_reference_and_partitions(seed):
    """The reference's ``test_partition_invariants`` soups: both
    packages' reports are equal, and the port's partition is exact,
    per batch too."""
    spans = _soup(seed)
    tl = Timeline(spans)
    assert tl.report(per_batch=True) == \
        rtl.Timeline(spans).report(per_batch=True)
    attr = _check_partition(tl)
    per = tl.per_batch()
    assert abs(sum(b["wait_s"] for b in per) - tl.idle_s) < 1e-6
    for b in per:
        assert abs(sum(b["attribution"].values()) - b["wait_s"]) < 1e-6
    assert tl.report()["attribution"].keys() == attr.keys()


@pytest.mark.parametrize("seed", range(4))
def test_translation_invariance(seed):
    """Shifting every stamp by a constant moves no attributed
    duration, in either package."""
    spans = _soup(2000 + seed, 40, 30.0)
    shift = 12345.678
    shifted = [FakeSpan(s.name, s.start_mono + shift,
                        s.end_mono + shift) for s in spans]
    for mod in (ttl, rtl):
        a0 = mod.Timeline(spans).attribute()
        a1 = mod.Timeline(shifted).attribute()
        for c in CAUSES:
            assert a0[c] == pytest.approx(a1[c], abs=1e-6)


@pytest.mark.parametrize("seed", range(10))
def test_overlapping_uploads_equal_reference(seed):
    """Soups biased toward uploads over compute (the reference's
    ``test_partition_exact_with_overlapping_uploads``)."""
    rng = np.random.default_rng(4000 + seed)
    spans = [FakeSpan("scan", 0.0, 60.0)]
    busy = []
    for _ in range(int(rng.integers(2, 10))):
        s = float(rng.uniform(0, 50))
        e = s + float(rng.uniform(0.5, 8))
        busy.append((s, e))
        spans.append(FakeSpan("device_compute", s, e))
    for _ in range(int(rng.integers(2, 12))):
        if rng.random() < 0.5:
            b = busy[int(rng.integers(0, len(busy)))]
            s = float(rng.uniform(b[0], b[1]))
        else:
            s = float(rng.uniform(0, 55))
        spans.append(FakeSpan("h2d_upload", s,
                              s + float(rng.uniform(0.2, 6))))
    tl = Timeline(spans)
    _check_partition(tl)
    assert tl.report() == rtl.Timeline(spans).report()


def test_gap_causes_by_priority():
    spans = [FakeSpan("scan", 0.0, 10.0),
             FakeSpan("device_compute", 0.0, 1.0),
             FakeSpan("device_compute", 9.0, 10.0),
             FakeSpan("h2d_upload", 1.0, 2.0),
             FakeSpan("pack", 1.0, 3.0),
             FakeSpan("decode", 3.0, 4.0),
             FakeSpan("device", 1.0, 8.0)]
    attr = _check_partition(Timeline(spans))
    assert attr["upload_serialized"] == pytest.approx(1.0)
    assert attr["host_pack_bound"] == pytest.approx(1.0)
    assert attr["collect_bound"] == pytest.approx(1.0)
    assert attr["dispatch_gap"] == pytest.approx(4.0)
    assert attr["unknown"] == pytest.approx(1.0)


def test_window_and_unfinished_spans():
    tl = Timeline([FakeSpan("device_compute", 2.0, 4.0),
                   FakeSpan("dfa_scan", 5.0, None)], window=(0.0, 10.0))
    assert tl.window_s == 10.0 and tl.busy_s == pytest.approx(2.0)
    assert _check_partition(tl)["queue_empty"] == pytest.approx(8.0)
    assert Timeline([]).report() == rtl.Timeline([]).report()


def _tracer_spans(mod):
    """A real tracer's spans: a request with a device window, a busy
    span closed at explicit stamps (``end_at``) and a host phase."""
    tracer = mod.Tracer()
    root = tracer.start_request("r")
    dev = tracer.child(root, "device")
    busy = tracer.child(dev, "device_compute")
    t0 = time.monotonic()
    if hasattr(busy, "end_at"):
        busy.end_at(t0, t0 + 0.004)
    else:
        busy.start_mono, busy.end_mono = t0, t0 + 0.004
        busy.tracer._finish(busy)
    with dev.activate():
        with mod.phase_span("pack"):
            pass
    dev.end()
    root.end()
    return tracer


def test_export_round_trip_and_fleet_merge_equal_reference():
    """``export_tracer`` → ``load_export`` → ``MergedTimeline``: the
    port's export of a real tracer loads in both packages and merges
    to the same report; a busy span ended at explicit stamps keeps
    them."""
    import trivy_tpu.obs as robs
    import trivy_tpu_torch.obs as tobs
    tdoc = ttl.export_tracer(_tracer_spans(tobs), process="port")
    rdoc = rtl.export_tracer(_tracer_spans(robs), process="ref")
    busy = [s for s in tdoc["spans"] if s["name"] == "device_compute"]
    assert len(busy) == 1
    assert busy[0]["end_mono"] - busy[0]["start_mono"] == \
        pytest.approx(0.004)
    docs = json.loads(json.dumps([tdoc, rdoc]))
    for doc in docs:
        lite = ttl.load_export(doc, offset_s=1.5)
        ref = rtl.load_export(doc, offset_s=1.5)
        assert [(s.name, s.start_mono, s.end_mono, s.attrs, s.is_root)
                for s in lite] == \
            [(s.name, s.start_mono, s.end_mono, s.attrs, s.is_root)
             for s in ref]
    assert ttl.MergedTimeline(docs, offsets=[0.0, 0.25]).report() == \
        rtl.MergedTimeline(docs, offsets=[0.0, 0.25]).report()
    tl = ttl.Timeline(ttl.load_export(docs[0]))
    _check_partition(tl)
    assert tl.busy_s == pytest.approx(0.004)


def test_from_tracer_over_a_traced_fleet(tmp_path):
    """``from_tracer`` on the port's traced direct fleet (the
    reference's ``tests/test_sched.py::make_fleet``): an exact
    partition, busy spans from the sieve and the interval match, and
    known causes for the idle."""
    from tests.test_sched import make_fleet
    from tests.test_torch_parallel import _port_store
    from trivy_tpu_torch.db import CompiledDB
    from trivy_tpu_torch.obs import Tracer
    from trivy_tpu_torch.runtime import BatchScanRunner
    tracer = Tracer()
    runner = BatchScanRunner(store=CompiledDB.compile(_port_store()),
                             backend="cpu", tracer=tracer)
    results = runner.scan_paths(make_fleet(tmp_path, 4))
    assert all(r.error == "" for r in results)
    tl = ttl.from_tracer(tracer)
    attr = _check_partition(tl)
    assert tl.busy_s > 0 and attr["host_pack_bound"] > 0
    assert tl.report()["coverage"] > 0


# --- the host profiler ------------------------------------------------

def _recognizable_spin_loop_xyzzy(stop: threading.Event,
                                  started: threading.Event) -> None:
    started.set()
    while not stop.is_set():
        sum(i * i for i in range(300))


def test_busy_function_appears_in_collapsed():
    prof = HostProfiler()
    stop, started = threading.Event(), threading.Event()
    t = threading.Thread(target=_recognizable_spin_loop_xyzzy,
                         args=(stop, started), daemon=True)
    t.start()
    try:
        started.wait(30)
        prof.sample_once()
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    text = prof.collapsed()
    assert "_recognizable_spin_loop_xyzzy" in text
    assert prof.samples > 0 and prof.ticks == 1
    for line in text.splitlines():
        stack, _, count = line.rpartition(" ")
        assert stack and int(count) > 0


def test_sample_once_skips_requested_thread():
    prof = HostProfiler()
    prof.sample_once(skip_thread=threading.get_ident())
    assert "test_sample_once_skips_requested_thread" \
        not in prof.collapsed()


def test_seconds_window_and_bounds():
    prof = HostProfiler(max_stacks=16)
    now = int(time.monotonic())
    with prof._lock:
        prof._ring[now - 120] = {"ancient.stack": 99}
        prof._ring[now] = {f"s{i}": 1 for i in range(16)}
    prof.sample_once()
    assert "ancient.stack" not in prof.folded(seconds=30)
    assert "ancient.stack" in prof.folded()
    assert prof.folded().get("<overflow>", 0) >= 1
    ring = HostProfiler(ring_seconds=5)
    with ring._lock:
        for i in range(50):
            ring._ring[i] = {"s": 1}
    ring.sample_once()
    assert ring.stats()["buckets"] <= 6


def test_next_tick_drops_missed_ticks():
    period = 1.0 / 49.0
    assert HostProfiler._next_tick(10.0, period, 10.001) == \
        pytest.approx(10.0 + period)
    assert HostProfiler._next_tick(10.0, period, 15.0) == 15.0


def test_start_stop_idempotent(monkeypatch):
    prof = HostProfiler(hz=100)
    prof.start()
    prof.start()
    prof.stop()
    prof.stop()
    stats = prof.stats()
    assert not stats["running"] and stats["overhead_s"] >= 0.0
    monkeypatch.setenv("TRIVY_TPU_PROFILE", "off")
    p = get_profiler()
    assert p is get_profiler()


def test_dump_writes_collapsed_file(tmp_path):
    prof = HostProfiler()
    prof.sample_once()
    path = prof.dump(str(tmp_path / "sub" / "host.folded"))
    with open(path, encoding="utf-8") as f:
        assert f.read() == prof.collapsed()


@pytest.mark.parametrize("backend", ["cpu", "cpu-ref"])
def test_device_trace_on_the_cpu_backends(tmp_path, backend):
    """``device_trace`` on a CPU backend: a torch.profiler Chrome trace
    of CPU activity and the host folded stacks, written at exit."""
    import torch
    out = tmp_path / "prof"
    with device_trace(str(out), backend=backend):
        get_profiler(start=False).sample_once()
        torch.arange(8).sum()
        assert not (out / "host_profile.folded").exists()
    assert (out / "host_profile.folded").exists()
    with open(out / "torch_trace.json", encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    with device_trace(""):
        pass


def test_device_trace_on_cuda_without_a_card_raises(tmp_path):
    """On ``cuda`` no CUDA activity means an error, never a host-only
    profile: here there is no card."""
    import torch
    from trivy_tpu_torch.obs.profiler import DeviceTraceError
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py")
    with pytest.raises(DeviceTraceError):
        with device_trace(str(tmp_path / "p"), backend="cuda"):
            pass
    assert not (tmp_path / "p" / "torch_trace.json").exists()


def test_summarize_equals_reference():
    """``summarize`` of the same finished spans: the same line."""
    import trivy_tpu.obs.trace as rtrace
    import trivy_tpu_torch.obs.trace as ttrace
    spans = [FakeSpan(n, 0.0, d) for n, d in
             (("queue_wait", 0.0002), ("analyze", 0.03),
              ("device", 0.0081))]
    Lite = namedtuple("Lite", "name duration_s parent_id is_root")
    lite = [Lite("scan", 0.0421, None, True)] + [
        Lite(s.name, s.end_mono - s.start_mono, "p", False)
        for s in spans]
    assert ttrace.summarize(lite) == rtrace.summarize(lite) == \
        "scan 42.1ms: queue_wait 0.2ms, analyze 30.0ms, device 8.1ms"
    assert ttrace.summarize(lite[1:]) == rtrace.summarize(lite[1:])
