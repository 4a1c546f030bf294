"""The consistent-hash ring (``router/ring.py``), the lifecycle planners
(``router/lifecycle.py``), the prewarm walk (``memo/warmth.py::
range_walk``) and the scan server's pre-join prewarm, against the JAX
package's (JAX on the CPU) in the same process.

Placement is blake2b in both packages, so a port replica and a
reference replica must agree on every key's owner; the planners and
the walk are pure functions of their inputs (the walk's ``seconds``
aside). The servers' prewarm runs over the same memo directory.
"""

import hashlib
import importlib
import json
import time
import urllib.request

import numpy as np
import pytest

PKGS = ("ref", "port")


def _mod(pkg, name):
    root = "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _keys(n: int, seed: int) -> list:
    return ["sha256:" + hashlib.sha256(f"{seed}:{i}".encode()).hexdigest()
            for i in range(n)]


def _members(rng, n: int) -> list:
    return [f"replica-{int(rng.integers(0, 10 ** 6))}" for _ in range(n)]


def _both(fn) -> dict:
    return {pkg: fn(pkg) for pkg in PKGS}


# --- the ring ---------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ring_placement_equals_reference(seed):
    """``owner``, ``walk``, ``capacity``, ``assign`` (with loads and an
    exclusion) and ``movement`` after a join and a leave equal the
    reference's for seeded members, keys and loads."""
    rng = np.random.default_rng(seed)
    members = _members(rng, 2 + seed)
    keys = _keys(300, seed)
    loads = {m: int(rng.integers(0, 6)) for m in members}
    vnodes = int(rng.integers(8, 80))

    def run(pkg):
        ring_mod = _mod(pkg, "router.ring")
        ring = ring_mod.Ring(vnodes=vnodes, capacity_factor=1.25)
        for m in members:
            ring.add(m)
        grown = ring_mod.Ring(vnodes=vnodes)
        shrunk = ring_mod.Ring(vnodes=vnodes)
        for m in members + ["joiner"]:
            grown.add(m)
        for m in members[1:]:
            shrunk.add(m)
        return {
            "nodes": ring.nodes(), "len": len(ring),
            "owner": [ring.owner(k) for k in keys],
            "walk": [ring.walk(k) for k in keys[:50]],
            "capacity": ring.capacity(loads),
            "assign": [ring.assign(k, loads) for k in keys],
            "assign_ex": [ring.assign(k, loads, exclude={members[0]})
                          for k in keys[:50]],
            "movement": [ring_mod.movement(keys, ring, grown),
                         ring_mod.movement(keys, ring, shrunk)],
        }
    out = _both(run)
    assert out["port"] == out["ref"]
    # a join moves about a 1/(N+1) share, a leave about the leaver's
    assert 0 < out["port"]["movement"][0] < 0.6
    assert 0 < out["port"]["movement"][1] < 0.8


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_arguments_and_empty_ring(pkg):
    Ring = _mod(pkg, "router.ring").Ring
    for kw in ({"vnodes": 0}, {"capacity_factor": 1.0}):
        with pytest.raises(ValueError):
            Ring(**kw)
    ring = Ring()
    assert ring.walk("k") == [] and ring.owner("k") is None
    assert ring.capacity({}) == 0 and ring.assign("k", {}) is None
    ring.add("a")
    ring.add("a")
    assert "a" in ring and len(ring) == 1
    ring.remove("a")
    ring.remove("a")
    assert ring.owner("k") is None


# --- the planners -----------------------------------------------------

@pytest.mark.parametrize("seed", [4, 5])
def test_prewarm_ranges_and_plan_handoff_equal_reference(seed):
    """``prewarm_ranges`` (the joiner's post-join keys, in input order)
    and ``plan_handoff`` (the victim's digests over the victim-less
    ring) equal the reference's, and the joiner's range is exactly the
    post-join ring's owner map."""
    rng = np.random.default_rng(seed)
    members = _members(rng, 3)
    keys = _keys(400, seed)
    victim = members[int(rng.integers(0, len(members)))]

    def run(pkg):
        lc = _mod(pkg, "router.lifecycle")
        return {"ranges": lc.prewarm_ranges(members, "joiner", keys),
                "plan": lc.plan_handoff(members, victim, keys[:120]),
                "cap": lc.HANDOFF_CAP}
    out = _both(run)
    assert out["port"] == out["ref"]
    ring = _mod("port", "router.ring").Ring()
    for m in members + ["joiner"]:
        ring.add(m)
    assert out["port"]["ranges"] == [k for k in keys
                                     if ring.owner(k) == "joiner"]
    assert victim not in out["port"]["plan"]
    assert sorted(d for v in out["port"]["plan"].values() for d in v) \
        == sorted(keys[:120])


def test_handoff_http_helpers_equal_reference():
    """``fetch_handoff`` reads a port server's ``/handoff`` and
    ``_post_json`` posts its ``/prefetch``, as the reference's do; both
    degrade to empty / None on a dead address."""
    server = _mod("port", "rpc.server")
    srv = server.ScanServer(backend="cpu")
    httpd, worker = server.serve(port=0, server=srv)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        srv.prefetch({"digests": ["sha256:aa", "sha256:bb"]})
        fetched = {pkg: _mod(pkg, "router.lifecycle").fetch_handoff(url)
                   for pkg in PKGS}
        out = {}
        for pkg in PKGS:
            lc = _mod(pkg, "router.lifecycle")
            out[pkg] = (fetched[pkg],
                        lc._post_json(url + "/prefetch",
                                      {"digests": [f"sha256:{pkg}"]}, 5.0),
                        lc.fetch_handoff("http://127.0.0.1:9", 1.0),
                        lc._post_json("http://127.0.0.1:9/prefetch", {},
                                      1.0))
    finally:
        httpd.shutdown()
        httpd.server_close()
        if worker is not None:
            worker.stop()
        srv.close()
    assert out["ref"][0] == out["port"][0] == ["sha256:aa", "sha256:bb"]
    for pkg in PKGS:
        assert out[pkg][1] == {"accepted": 1, "name": "self"}
        assert out[pkg][2:] == ([], None)


# --- the walk ---------------------------------------------------------

def _store(pkg, n: int = 40):
    store = _mod(pkg, "memo").MemoryMemoStore()
    for i in range(n):
        store.put(f"k{i:03d}", b"v" * (i + 1))
    return store


def _walk(pkg, store, owned, deadline_s, staged=None):
    res = _mod(pkg, "memo.warmth").range_walk(
        store, owned, deadline_s,
        stage=None if staged is None else
        (lambda k, v: staged.setdefault(k, v)))
    assert res.pop("seconds") >= 0.0
    return res


def test_range_walk_equals_reference():
    """Owned keys only, staged in listing order; a deadline that has
    passed cuts the walk; every result equals the reference's."""
    out = {}
    for pkg in PKGS:
        staged: dict = {}
        full = _walk(pkg, _store(pkg), lambda k: int(k[1:]) % 2 == 0, 5.0,
                     staged)
        cut = _walk(pkg, _store(pkg), lambda k: True, 1e-9)
        out[pkg] = (full, list(staged), cut)
    assert out["port"] == out["ref"]
    full, staged, cut = out["port"]
    assert full == {"keys": 20, "bytes": sum(i + 1 for i in range(0, 40, 2)),
                    "complete": True, "deadline_exceeded": False}
    assert staged == [f"k{i:03d}" for i in range(0, 40, 2)]
    assert cut == {"keys": 0, "bytes": 0, "complete": False,
                   "deadline_exceeded": True}


def test_range_walk_under_a_broken_store_equals_reference():
    """A listing that raises is a cold join, a miss mid-walk a partial
    walk that goes on; neither raises."""
    out = {}
    for pkg in PKGS:
        store = _store(pkg, 10)

        class Broken:
            def scan_keys(self, prefix="", limit=0):
                raise OSError("tier down")

            def get(self, key):
                raise OSError("tier down")

        class Flaky:
            def scan_keys(self, prefix="", limit=0):
                return store.scan_keys(prefix=prefix, limit=limit)

            def get(self, key):
                if key == "k005":
                    raise RuntimeError("shard down")
                return None if key == "k003" else store.get(key)

        out[pkg] = (_walk(pkg, Broken(), lambda k: True, 5.0),
                    _walk(pkg, Flaky(), lambda k: True, 5.0))
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"keys": 0, "bytes": 0, "complete": False,
                              "deadline_exceeded": False}
    assert out["port"][1]["keys"] == 8 and not out["port"][1]["complete"]


def test_range_walk_on_a_resilient_store_during_an_outage():
    """A resilient store whose backend goes down mid-walk answers misses
    (never errors): the walk is partial, and once the breaker opens the
    rest of the walk costs no backend call — as the reference's."""
    out = {}
    for pkg in PKGS:
        m = _mod(pkg, "memo")
        inner = _store(pkg, 20)
        calls = []

        class Outage:
            def scan_keys(self, prefix="", limit=0):
                return inner.scan_keys(prefix=prefix, limit=limit)

            def get(self, key):
                calls.append(key)
                if key >= "k008":
                    raise ConnectionError("backend down")
                return inner.get(key)

            def put(self, key, value):
                inner.put(key, value)

            def delete(self, key):
                inner.delete(key)

        res = _walk(pkg, m.ResilientMemoStore(Outage()), lambda k: True, 5.0)
        out[pkg] = (res, len(calls))
    assert out["port"] == out["ref"]
    res, n_calls = out["port"]
    assert res["keys"] == 8 and res["complete"] is False
    assert n_calls < 20


# --- the server's prewarm --------------------------------------------

def _memo_dir(tmp_path, n: int = 60) -> str:
    d = str(tmp_path / "memo")
    store = _mod("port", "memo").FSMemoStore(d)
    for i in range(n):
        store.put(hashlib.sha1(f"k{i}".encode()).hexdigest(),
                  b"verdict" * (1 + i % 5))
    return d


def _slow_tier(pkg, memo_dir):
    """The directory tier, each read 10 ms: the walk outlasts the first
    ``/healthz`` by far."""
    class Slow(_mod(pkg, "memo").FSMemoStore):
        def get(self, key):
            time.sleep(0.01)
            return super().get(key)
    return Slow(memo_dir)


def _prewarmed(pkg, memo_dir, members, deadline_s=5.0):
    m = _mod(pkg, "memo")
    lc = _mod(pkg, "router.lifecycle")
    lc.LIFECYCLE_METRICS.reset()
    kw = {"backend": "cpu"} if pkg == "port" else {}
    mkw = {"backend": "cpu"} if pkg == "port" else {}
    srv = _mod(pkg, "rpc.server").ScanServer(
        memo=m.FindingsMemo(_slow_tier(pkg, memo_dir), **mkw),
        prewarm_members=members, prewarm_deadline_s=deadline_s,
        replica_name="b", **kw)
    seen = [srv.health()["status"]]
    t0 = time.monotonic()
    while srv.health()["status"] == "warming":
        assert time.monotonic() - t0 < 30.0
        time.sleep(0.005)
    seen.append(srv.health()["status"])
    metrics = srv.metrics()["lifecycle"]
    srv.close()
    snap = lc.LIFECYCLE_METRICS.snapshot()
    lc.LIFECYCLE_METRICS.reset()
    assert snap.pop("prewarm_seconds") >= 0.0
    return seen, snap, metrics["warming"]


def test_server_prewarm_equals_reference(tmp_path):
    """A server given ``prewarm_members`` says ``warming`` until the
    walk of its post-join slice ends, then ``ok``; its lifecycle
    counters equal the reference server's over the same memo directory,
    and the keys it staged are ``prewarm_ranges`` of the listing."""
    d = _memo_dir(tmp_path)
    out = {pkg: _prewarmed(pkg, d, ["a"]) for pkg in PKGS}
    assert out["port"] == out["ref"]
    seen, snap, warming = out["port"]
    assert seen == ["warming", "ok"] and warming is False
    keys, _ = _mod("port", "memo").FSMemoStore(d).scan_keys("")
    mine = _mod("port", "router.lifecycle").prewarm_ranges(["a"], "b",
                                                            keys)
    store = _mod("port", "memo").FSMemoStore(d)
    assert snap == {
        "prewarm_runs": 1, "prewarm_keys": len(mine),
        "prewarm_bytes": sum(len(store.get(k)) for k in mine),
        "prewarm_deadline_exceeded": 0, "prewarm_cold_joins": 0,
        "handoff_published": 0, "handoff_prefetched": 0,
        "handoff_abandoned": 0}
    assert 0 < len(mine) < len(keys)


def test_server_prewarm_past_its_deadline_equals_reference(tmp_path):
    """A deadline already passed: the server still goes ready (a cold
    join), counted as such in both packages. A walk that ends at once
    may or may not be seen ``warming`` by the first probe, in either
    package; every later probe says ``ok``."""
    d = _memo_dir(tmp_path, 20)
    out = {pkg: _prewarmed(pkg, d, ["a", "c"], deadline_s=1e-9)
           for pkg in PKGS}
    for pkg in PKGS:
        assert out[pkg][0][0] in ("warming", "ok")
    assert [(seen[1:], *rest) for seen, *rest in out.values()] == \
        [(["ok"], *out["ref"][1:])] * 2
    snap = out["port"][1]
    assert snap["prewarm_deadline_exceeded"] == 1
    assert snap["prewarm_cold_joins"] == 1 and snap["prewarm_keys"] == 0


def test_server_prewarm_flags(tmp_path):
    """``--prewarm-members`` without the memo exits 2 as the
    reference's; ``/healthz`` of a prewarming server process says
    ``warming`` or ``ok``, never an error."""
    from tests.test_torch_rpc import _main
    for pkg in PKGS:
        code, _, err = _main(_mod(pkg, "cli").main, [
            "server", "--listen", "127.0.0.1:1", "--no-memo",
            "--sched", "off", "--cache-dir", str(tmp_path / pkg),
            "--prewarm-members", "a"] + (
                ["--backend", "cpu"] if pkg == "port" else []))
        assert code == 2, err
        assert "error: --prewarm-members needs the findings memo " \
            "(drop --no-memo)" in err
    server = _mod("port", "rpc.server")
    m = _mod("port", "memo")
    srv = server.ScanServer(
        backend="cpu", memo=m.FindingsMemo(
            m.FSMemoStore(_memo_dir(tmp_path, 10))),
        prewarm_members=["a"])
    httpd, worker = server.serve(port=0, server=srv)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["status"] in ("warming", "ok")
    finally:
        httpd.shutdown()
        httpd.server_close()
        if worker is not None:
            worker.stop()
        srv.close()
