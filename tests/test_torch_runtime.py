"""The fleet runtime's pieces on the CPU: the port's ``DispatchRing``
on the ring cases of ``tests/test_async_rt.py`` (FIFO collection, the
depth bound and its override, an isolated collect error with balanced
books, ``close`` collecting or abandoning slots, a failed launch
freeing its reservation), the host pool (order kept, no deadlock from
a pool thread), and ``dispatch_jobs_async`` + ``collect_dispatch``
equal to the port's and the reference's ``dispatch_jobs`` on seeded
mixes of classic and resident jobs, at every wave size and depth
tested, with no re-upload of the resident tables."""

import threading
import time

import pytest

import trivy_tpu.db as rdb
import trivy_tpu.detect.batch as rbatch
import trivy_tpu_torch.db as tdb
import trivy_tpu_torch.detect.batch as tbatch
from tests.test_torch_compiled_db import build_store, store_ops
from tests.test_torch_detect import _mix
from trivy_tpu_torch.detect.metrics import DETECT_METRICS
from trivy_tpu_torch.runtime import hostpool
from trivy_tpu_torch.runtime.ring import (RING_METRICS, DispatchRing,
                                          RingClosed, RingMetrics,
                                          TeeRingMetrics,
                                          resolve_dispatch_depth)
from trivy_tpu_torch.utils import defer_gc


# --- the ring (tests/test_async_rt.py:32-131) -----------------------

class TestDispatchRing:
    def test_fifo_collect_order(self):
        done = []
        ring = DispatchRing(depth=4, name="t-fifo")
        slots = [ring.submit(lambda p: done.append(p) or p, k)
                 for k in range(6)]
        assert [s.wait(5) for s in slots] == list(range(6))
        ring.close()
        assert done == list(range(6))

    def test_depth_bounds_in_flight(self):
        """With depth 2 and a gated collect, the third submit must
        park until a slot drains."""
        gate = threading.Event()
        ring = DispatchRing(depth=2, name="t-depth")
        order = []

        def collect(p):
            gate.wait(5)
            order.append(p)

        ring.submit(collect, 0)
        ring.submit(collect, 1)
        t0 = time.monotonic()
        blocked = []

        def third():
            ring.submit(collect, 2)
            blocked.append(time.monotonic() - t0)

        t = threading.Thread(target=third)
        t.start()
        time.sleep(0.15)
        assert not blocked          # still parked: ring full
        assert ring.in_flight() == 2
        gate.set()
        t.join(5)
        assert not t.is_alive()
        assert blocked and blocked[0] >= 0.1
        assert ring.flush(5)
        ring.close()
        assert order == [0, 1, 2]

    def test_depth_override_shrinks_to_one(self):
        """submit(depth=1) serializes even on a deep ring."""
        ring = DispatchRing(depth=4, name="t-shrink")
        seen = []
        ring.submit(lambda p: (time.sleep(0.05), seen.append(p)),
                    "a", depth=1)
        t0 = time.monotonic()
        ring.submit(lambda p: seen.append(p), "b", depth=1)
        # the second submit had to wait for slot "a" to fully drain
        assert time.monotonic() - t0 >= 0.03
        assert ring.flush(5)
        ring.close()
        assert seen == ["a", "b"]

    def test_collect_error_isolated_and_books_balance(self):
        before = RING_METRICS.snapshot()["counters"]
        ring = DispatchRing(depth=2, name="t-err")

        def boom(p):
            raise ValueError(f"bad {p}")

        s1 = ring.submit(boom, 1)
        s2 = ring.submit(lambda p: p * 2, 21)
        with pytest.raises(ValueError, match="bad 1"):
            s1.wait(5)
        assert s2.wait(5) == 42      # the error never killed the
        ring.close()                 # drain thread
        after = RING_METRICS.snapshot()["counters"]
        assert after["slots_launched"] - before["slots_launched"] == 2
        assert after["slots_collected"] - \
            before["slots_collected"] == 2
        assert after["slot_errors"] - before["slot_errors"] == 1

    def test_close_collects_in_flight(self):
        ring = DispatchRing(depth=4, name="t-close")
        done = []
        for k in range(3):
            ring.submit(lambda p: (time.sleep(0.02), done.append(p)), k)
        ring.close(collect=True)
        assert done == [0, 1, 2]
        with pytest.raises(RingClosed):
            ring.submit(lambda p: p, 9)

    def test_close_without_collect_abandons_queued_slots(self):
        gate = threading.Event()
        rm = RingMetrics()
        ring = DispatchRing(depth=4, name="t-abandon", metrics=rm)
        first = ring.submit(lambda p: gate.wait(5) and p, "first")
        queued = [ring.submit(lambda p: p, k) for k in range(2)]
        time.sleep(0.05)            # "first" is being collected
        closer = threading.Thread(target=ring.close,
                                  kwargs={"collect": False})
        closer.start()
        for s in queued:
            with pytest.raises(RingClosed):
                s.wait(5)
        gate.set()
        closer.join(5)
        assert not closer.is_alive()
        assert first.wait(5) == "first"
        c = rm.snapshot()["counters"]
        assert c["slots_launched"] == c["slots_collected"] == 3
        assert c["slot_errors"] == 2

    def test_failed_launch_frees_reservation(self):
        ring = DispatchRing(depth=1, name="t-launch")

        def bad_launch():
            raise RuntimeError("pack failed")

        with pytest.raises(RuntimeError):
            ring.submit(lambda p: p, launch=bad_launch)
        # the reservation was released: the next submit proceeds
        assert ring.submit(lambda p: p, payload=7).wait(5) == 7
        assert ring.submit(lambda p: p + 1,
                           launch=lambda: 8).wait(5) == 9
        ring.close()

    def test_tee_books_a_scan_and_the_process(self):
        rm = RingMetrics()
        before = RING_METRICS.snapshot()["counters"]["slots_launched"]
        ring = DispatchRing(depth=2, name="t-tee",
                            metrics=TeeRingMetrics(rm, RING_METRICS))
        for k in range(5):
            ring.submit(lambda p: time.sleep(0.01), k)
        ring.close()
        snap = rm.snapshot()
        assert snap["counters"]["slots_launched"] == 5
        assert snap["counters"]["slots_collected"] == 5
        assert snap["depth"] == 0 and snap["depth_max"] <= 2
        assert 0.0 <= snap["dispatch_overlap_ratio"] <= 1.0
        assert RING_METRICS.snapshot()["counters"]["slots_launched"] \
            - before >= 5


@pytest.mark.parametrize("env,arg,want", [("", 0, 2), ("3", 0, 3),
                                          ("3", 1, 1), ("x", 0, 2),
                                          ("0", 0, 1), ("", -5, 1)])
def test_resolve_dispatch_depth(env, arg, want, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_DISPATCH_DEPTH", env)
    assert resolve_dispatch_depth(arg) == want


# --- the host pool ---------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 64])
def test_map_in_pool_keeps_order(chunk):
    items = list(range(300))
    before = DETECT_METRICS.snapshot()["pack_tasks"]
    assert hostpool.map_in_pool(lambda x: x * x, items, chunk=chunk) \
        == [x * x for x in items]
    if hostpool.get_host_pool() is not None:
        tasks = DETECT_METRICS.snapshot()["pack_tasks"] - before
        assert tasks == (300 if chunk == 1 else 5)


def test_map_in_pool_from_a_pool_thread_runs_inline(monkeypatch):
    """A pool task that maps over the pool again must not wait on its
    own pool (every worker doing so deadlocks): it runs inline."""
    monkeypatch.setattr(hostpool, "_POOL", None)
    monkeypatch.setenv("TRIVY_TPU_HOST_POOL", "2")
    pool = hostpool.get_host_pool()
    try:
        def outer(k):
            assert hostpool.on_pool_thread()
            return hostpool.map_in_pool(lambda x: x + k, list(range(50)))

        futs = [pool.submit(outer, k) for k in range(4)]
        assert [f.result(timeout=10) for f in futs] == \
            [list(range(k, k + 50)) for k in range(4)]
    finally:
        pool.shutdown(wait=True)
    assert not hostpool.on_pool_thread()


@pytest.mark.parametrize("env,want", [("0", 0), ("3", 3), ("x", None),
                                      ("", None)])
def test_pool_size_knob(env, want, monkeypatch):
    """``TRIVY_TPU_HOST_POOL`` as the reference reads it; a bad value
    is ignored for the core-count default; 0 disables the pool."""
    import os
    monkeypatch.setenv("TRIVY_TPU_HOST_POOL", env)
    default = min(8, max(0, (os.cpu_count() or 1) - 2))
    assert hostpool.pool_size() == (default if want is None else want)
    if env == "0":
        monkeypatch.setattr(hostpool, "_POOL", None)
        assert hostpool.get_host_pool() is None
        assert hostpool.map_in_pool(str, list(range(20))) == \
            [str(x) for x in range(20)]


def test_defer_gc_restores_collection():
    import gc
    assert gc.isenabled()
    with defer_gc():
        assert not gc.isenabled()
    assert gc.isenabled()


# --- async waves against the synchronous dispatcher -------------------

@pytest.fixture(scope="module")
def stores():
    ops_a, ops_b = store_ops(11), store_ops(12, n_pkgs=8)
    return ((rdb.CompiledDB.compile(build_store(rdb, ops_a)),
             rdb.CompiledDB.compile(build_store(rdb, ops_b))),
            (tdb.CompiledDB.compile(build_store(tdb, ops_a)),
             tdb.CompiledDB.compile(build_store(tdb, ops_b))))


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("wave_rows", [64, 4096])
@pytest.mark.parametrize("backend", ["cpu", "cpu-ref"])
def test_async_dispatch_equals_dispatch_jobs(stores, backend, wave_rows,
                                             depth):
    """The payload list equals the port's synchronous ``dispatch_jobs``
    and the reference's (JAX on the CPU), unsorted; so do the dedup
    counters. Depth 1 runs without a ring, as the runner does."""
    (ra, rb), (ta, tb) = stores
    seed = 20261017 + depth
    want = rbatch.dispatch_jobs(_mix(rbatch, (ra, rb), seed),
                                backend="tpu", stats={})
    jobs = _mix(tbatch, (ta, tb), seed)
    sync_stats, stats = {}, {}
    assert tbatch.dispatch_jobs(list(jobs), backend=backend,
                                stats=sync_stats) == want
    ring = DispatchRing(depth=depth, name="t-waves") if depth > 1 \
        else None
    try:
        h = tbatch.dispatch_jobs_async(list(jobs), backend=backend,
                                       stats=stats, ring=ring,
                                       max_wave_rows=wave_rows)
        got = tbatch.collect_dispatch(h)
    finally:
        if ring is not None:
            ring.close()
    assert got == want
    assert (stats["jobs_in"], stats["jobs_unique"]) == \
        (sync_stats["jobs_in"], sync_stats["jobs_unique"])
    if backend == "cpu-ref":
        assert h.waves == 1
        return
    sizes = [[len(w["groups"]) for w in seg.waves] for seg in h.segments]
    assert all(n <= wave_rows for seg in sizes for n in seg)
    assert h.waves == sum(-(-sum(seg) // wave_rows) for seg in sizes)
    assert (h.waves > len(h.segments)) == (wave_rows == 64)


def test_async_dispatch_default_wave_size_is_read_at_the_call(
        stores, monkeypatch):
    (_, _), (ta, tb) = stores
    jobs = _mix(tbatch, (ta, tb), 5)
    monkeypatch.setattr(tbatch, "_WAVE_ROWS", 32)
    h = tbatch.dispatch_jobs_async(list(jobs), backend="cpu", stats={})
    assert all(len(w["groups"]) <= 32 for s in h.segments
               for w in s.waves)
    assert tbatch.collect_dispatch(h) == \
        tbatch.dispatch_jobs(list(jobs), backend="cpu", stats={})


def test_resident_tables_survive_async_ring(stores):
    """tests/test_async_rt.py:411-430: three async dispatches through
    one ring answer as the synchronous one does, and the resident
    tables are never uploaded again."""
    (_, _), (ta, tb) = stores
    jobs = _mix(tbatch, (ta, tb), 77)
    base = tbatch.dispatch_jobs(list(jobs), backend="cpu", stats={})
    up0 = (ta.device_stats()["uploads"], tb.device_stats()["uploads"])
    ring = DispatchRing(depth=2, name="t-donate")
    try:
        for _ in range(3):
            h = tbatch.dispatch_jobs_async(list(jobs), backend="cpu",
                                           stats={}, ring=ring,
                                           max_wave_rows=64)
            assert tbatch.collect_dispatch(h) == base
    finally:
        ring.close()
    assert (ta.device_stats()["uploads"],
            tb.device_stats()["uploads"]) == up0


def test_a_failed_wave_reaches_collect_dispatch(stores, monkeypatch):
    """A wave whose collect raises fails ``collect_dispatch`` with its
    error; the ring's drain thread collects the waves behind it and
    the books balance."""
    (_, _), (ta, tb) = stores
    jobs = _mix(tbatch, (ta, tb), 3)
    calls = []
    real = tbatch._WaveSegment._collect_wave

    def flaky(self, wave):
        calls.append(wave["rows"])
        if len(calls) == 2:
            raise RuntimeError("the wave failed")
        return real(self, wave)

    monkeypatch.setattr(tbatch._WaveSegment, "_collect_wave", flaky)
    rm = RingMetrics()
    ring = DispatchRing(depth=2, name="t-fail", metrics=rm)
    try:
        h = tbatch.dispatch_jobs_async(list(jobs), backend="cpu",
                                       stats={}, ring=ring,
                                       max_wave_rows=64)
        with pytest.raises(RuntimeError, match="the wave failed"):
            tbatch.collect_dispatch(h)
        assert ring.flush(5)
    finally:
        ring.close()
    c = rm.snapshot()["counters"]
    assert c["slots_launched"] == c["slots_collected"] == h.waves > 2
    assert c["slot_errors"] == 1 and len(calls) == h.waves


def test_async_dispatch_refuses_a_mesh_and_a_missing_card(monkeypatch):
    import torch
    with pytest.raises(NotImplementedError, match="A.6"):
        tbatch.dispatch_jobs_async([], backend="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.dispatch_jobs_async([], stats={})
