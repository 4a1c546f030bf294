"""The inverted impact index (``trivy_tpu_torch.impact``), the findings
memo's impact branches, the server's ``GET /impact`` and the ``impact``
subcommand, against the JAX package's (JAX on the CPU) in the same
process.

Both packages read the same seeded inputs: an advisory store made from
a numpy seed (compiled by each package), the same image tars
(``utils/synth.py::write_image_tar`` writes them byte for byte) and
the same sequence of scans, hot swaps and corrupt entries. The port's
runner and re-match run on ``cpu`` (the torch code), the reference's on
``cpu-ref``. Snapshots, answers, image records and push events must be
equal, exactly.
"""

import contextlib
import hashlib
import importlib
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401

PKGS = ("ref", "port")
BACKEND = {"ref": "cpu-ref", "port": "cpu"}
N_PKGS = 10
TOKEN = "t"


def _mod(pkg, name):
    root = "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _canon(snapshot: dict) -> str:
    return json.dumps(snapshot, sort_keys=True)


def _random_store(pkg, rng):
    store = _mod(pkg, "db").AdvisoryStore()
    for i in range(N_PKGS):
        for a in range(1 + int(rng.integers(0, 3))):
            vid = f"CVE-2024-{1000 * i + a}"
            store.put_advisory(
                "alpine 3.16", f"pkg{i}", vid,
                {"FixedVersion": f"1.{int(rng.integers(0, 9))}."
                                 f"{int(rng.integers(0, 9))}-r0"})
            store.put_vulnerability(vid, {"Severity": "HIGH",
                                          "Title": f"adv {vid}"})
    return store


def _mutate(pkg, rng, old):
    """Some fixed versions changed and one advisory added: a ``db
    update`` delta."""
    new = _mod(pkg, "db").AdvisoryStore()
    for bucket, pkgs in old.buckets.items():
        for name, advs in pkgs.items():
            for vid, val in advs.items():
                val = dict(val)
                if rng.random() < 0.3:
                    val["FixedVersion"] = \
                        f"2.{int(rng.integers(0, 9))}.9-r0"
                new.put_advisory(bucket, name, vid, val)
    for vid, v in old.vulnerabilities.items():
        new.put_vulnerability(vid, v)
    add_to = f"pkg{int(rng.integers(0, N_PKGS))}"
    vid = f"CVE-2025-{int(rng.integers(10000, 99999))}"
    new.put_advisory("alpine 3.16", add_to, vid,
                     {"FixedVersion": "1.0.1-r0"})
    new.put_vulnerability(vid, {"Severity": "CRITICAL",
                                "Title": "hot-swap delta"})
    return new


APK = "P:{name}\nV:{version}\no:{name}\nL:MIT\n\n"


def _fleet(tmp_path, n_images: int = 3) -> list:
    """Images sharing one apk layer (the memoized, indexed one) plus a
    layer of their own; the tars are the same bytes from either
    package's writer."""
    from trivy_tpu_torch.utils.synth import write_image_tar
    apk = "".join(APK.format(name=f"pkg{i}",
                             version=f"1.{i % 7}.{i % 5}-r0")
                  for i in range(N_PKGS))
    shared = {"etc/alpine-release": b"3.16.2\n",
              "lib/apk/db/installed": apk.encode()}
    paths = []
    for n in range(n_images):
        p = str(tmp_path / f"img{n}.tar")
        write_image_tar(p, [shared, {f"srv/a{n}.txt": b"x = %d\n" % n}],
                        repo_tag=f"impact/img:{n}")
        paths.append(p)
    return paths


def _memo(pkg, store=None):
    m = _mod(pkg, "memo")
    return m.FindingsMemo(store if store is not None
                          else m.MemoryMemoStore(), backend=BACKEND[pkg])


def _scan(pkg, paths, cdb, memo):
    runner = _mod(pkg, "runtime").BatchScanRunner(
        store=cdb, backend=BACKEND[pkg], memo=memo, sched="off")
    try:
        results = runner.scan_paths(list(paths))
    finally:
        runner.close()
    assert all(not r.error for r in results), [r.error for r in results]
    return results


def _swap(pkg, cdb, new_cdb, memo):
    sw = _mod(pkg, "db.compiled").SwappableStore(cdb)
    _mod(pkg, "db.lifecycle").attach_memo(sw, memo)
    # the reference's swap stages the new tables unless told not to;
    # the port's stages them where the old ones are (nowhere, here)
    sw.swap(new_cdb, **({"stage": False} if pkg == "ref" else {}))


def _indexed(pkg, tmp_path, seed: int, n_images: int = 3, pusher=None,
             store=None):
    """A memo with an index attached, after one scan of the fleet."""
    imp = _mod(pkg, "impact")
    rng = np.random.default_rng(seed)
    paths = _fleet(tmp_path, n_images)
    adv = _random_store(pkg, rng)
    cdb = _mod(pkg, "db").CompiledDB.compile(adv)
    memo = _memo(pkg, store)
    idx = imp.ImpactIndex(store=memo.store, pusher=pusher)
    memo.attach_impact(idx)
    _scan(pkg, paths, cdb, memo)
    return {"paths": paths, "adv": adv, "cdb": cdb, "memo": memo,
            "idx": idx, "rng": rng}


# --- the property: incremental == brute force == the reference -------

def _sequence(pkg, tmp_path, seed: int) -> list:
    imp = _mod(pkg, "impact")
    st = _indexed(pkg, tmp_path, seed)
    rng, paths, memo, idx = st["rng"], st["paths"], st["memo"], st["idx"]
    adv, cdb = st["adv"], st["cdb"]
    steps = []

    def check(op):
        snap = idx.postings_snapshot()
        assert _canon(snap) == _canon(imp.brute_force_invert(memo, cdb))
        steps.append((op, _canon(snap)))

    check("scan")
    for _ in range(4):
        op = int(rng.integers(0, 3))
        if op == 0:                 # re-scan a random subset
            k = 1 + int(rng.integers(0, len(paths)))
            _scan(pkg, list(rng.choice(paths, size=k, replace=False)),
                  cdb, memo)
        elif op == 1:               # db hot swap + delta re-match
            adv = _mutate(pkg, rng, adv)
            new_cdb = _mod(pkg, "db").CompiledDB.compile(adv)
            _swap(pkg, cdb, new_cdb, memo)
            cdb = new_cdb
        else:                       # evict: corrupt one entry
            keys = sorted(k for k in memo.store.keys()
                          if not imp.is_impact_key(k))
            if keys:
                victim = keys[int(rng.integers(0, len(keys)))]
                memo.store.put(victim, b"torn-write")
                _scan(pkg, paths, cdb, memo)   # drop + recompute
        check(op)
    return steps


@pytest.mark.parametrize("seed", [11, 23])
def test_scan_swap_evict_sequence_equals_reference(tmp_path, seed):
    """After every step of a seeded scan / hot swap / evict sequence
    the port's incremental index snapshots exactly as its brute-force
    inversion of the memo tier, and as the reference's index after the
    same sequence."""
    ref = _sequence("ref", tmp_path, seed)
    port = _sequence("port", tmp_path, seed)
    assert port == ref
    assert json.loads(port[0][1])["postings"], \
        "a fleet with vulnerable packages indexed nothing"


@pytest.mark.parametrize("pkg", PKGS)
def test_set_entry_drop_and_rename_equal_reference(pkg):
    """The maintenance calls' return values and snapshots, step for
    step, in both packages."""
    idx = _mod(pkg, "impact").ImpactIndex()
    out = [idx.set_entry("k1", "b1", [("p", "CVE-1")]),
           idx.set_entry("k1", "b1", [("p", "CVE-1")]),
           idx.set_entry("k2", "b1", [("p", "CVE-1")]),
           idx.set_entry("k1", "b1", [("p", "CVE-1"), ("p", "CVE-2")])]
    assert out == [(("p", "CVE-1"),), (), (), (("p", "CVE-2"),)]
    idx.drop_entry("k1")
    assert idx.query("CVE-1")["layers"] == ["b1"]
    idx.drop_entry("k2")
    assert idx.query("CVE-1")["layers"] == []
    idx.set_entry("old", "b3", [("q", "CVE-3")])
    idx.rename_entry("old", "new")
    idx.drop_entry("old")               # no-op after the rename
    assert _canon(idx.postings_snapshot()) == _canon(
        {"postings": [["q", "CVE-3", ["b3"]]], "images": []})
    assert _mod(pkg, "impact").entry_postings(
        {"subs": {"q": {"hits": [0]}}}, _mod(pkg, "db").AdvisoryStore()) \
        == ()


# --- sharding: ring slices, the kill-one-replica rebuild ---------------

def test_kill_one_replica_rebuild_equals_reference(tmp_path):
    """Three ring slices over one memo tier; one replica killed: each
    survivor's re-armed slice equals a fresh brute-force inversion, the
    survivors' union covers the whole answer, a cold successor rebuilt
    from the tier equals the survivor it replaces, and every slice
    equals the reference's slice of the same name."""
    slices = {}
    for pkg in PKGS:
        imp = _mod(pkg, "impact")
        st = _indexed(pkg, tmp_path, 7, n_images=4)
        memo, cdb = st["memo"], st["cdb"]
        full = st["idx"].postings_snapshot()
        assert full["postings"]
        ring = _mod(pkg, "router.ring").Ring()
        names = ["r0", "r1", "r2"]
        for nm in names:
            ring.add(nm)

        def owns_for(nm):
            return lambda blob, _n=nm: (ring.walk(blob) or [None])[0] == _n

        shards = {}
        for nm in names:
            ix = imp.ImpactIndex(store=memo.store, owns=owns_for(nm),
                                 name=nm)
            assert ix.rebuild(memo, cdb)["complete"]
            shards[nm] = ix
        ring.remove("r0")
        merged: dict = {}
        for nm in names[1:]:
            shards[nm].set_owner(owns_for(nm))
            snap = shards[nm].postings_snapshot()
            assert _canon(snap) == _canon(imp.brute_force_invert(
                memo, cdb, owns=owns_for(nm)))
            for name, cve, blobs in snap["postings"]:
                merged.setdefault((name, cve), set()).update(blobs)
        assert sorted((p, c, sorted(bs)) for (p, c), bs in merged.items()) \
            == sorted((p, c, bs) for p, c, bs in full["postings"])
        successor = imp.ImpactIndex(store=memo.store, owns=owns_for("r1"))
        assert successor.rebuild(memo, cdb)["complete"]
        assert _canon(successor.postings_snapshot()) == \
            _canon(shards["r1"].postings_snapshot())
        slices[pkg] = {nm: _canon(shards[nm].postings_snapshot())
                       for nm in names}
    assert slices["port"] == slices["ref"]


@pytest.mark.parametrize("pkg", PKGS)
def test_degraded_scan_keys_flags_partial(pkg, tmp_path):
    """A tier whose key scan fails rebuilds an empty index flagged
    ``complete: false``; its answers are partial, never an error."""
    m = _mod(pkg, "memo")
    st = _indexed(pkg, tmp_path, 3, n_images=2)

    class Outage:
        def scan_keys(self, prefix="", limit=0):
            raise ConnectionError("tier down")

        def get(self, key):
            raise ConnectionError("tier down")

    degraded = _memo(pkg)
    degraded.store = m.ResilientMemoStore(Outage())
    idx = _mod(pkg, "impact").ImpactIndex()
    out = idx.rebuild(degraded, st["cdb"])
    assert out["complete"] is False and out["entries"] == 0
    q = idx.query("CVE-2024-1000")
    assert q == {"cve": "CVE-2024-1000", "packages": [], "layers": [],
                 "images": [], "complete": False}


# --- image records ---------------------------------------------------

def test_image_records_byte_equal_and_read_across():
    """Records encode to the same bytes in both packages, each decodes
    the other's, and a torn record is None in both."""
    rix = _mod("ref", "impact.index")
    tix = _mod("port", "impact.index")
    args = ("img:1", "acme", ["sha256:b", "sha256:a"])
    raw = tix.encode_image_record(*args)
    assert raw == rix.encode_image_record(*args)
    assert tix.decode_image_record(rix.encode_image_record(*args)) == \
        rix.decode_image_record(raw) == {
            "v": 1, "image": "img:1", "tenant": "acme",
            "blobs": ["sha256:a", "sha256:b"]}
    for bad in (raw[:-4] + b'xx}', b"\xff\xfe"):
        assert tix.decode_image_record(bad) is None
        assert rix.decode_image_record(bad) is None
    for name in ("img:1", "registry/x@sha256:00", ""):
        assert tix.image_key(name) == rix.image_key(name)
    assert tix.IMPACT_KEY_PREFIX == rix.IMPACT_KEY_PREFIX


@pytest.mark.parametrize("writer", PKGS)
def test_memo_tier_rebuilds_across_packages(writer, tmp_path):
    """A directory memo tier written by one package (entries and image
    records) rebuilds in the other into the same index, and the swap's
    key walk leaves the records intact in both."""
    reader = "port" if writer == "ref" else "ref"
    tier = str(tmp_path / "tier")
    w = _indexed(writer, tmp_path, 13, n_images=2,
                 store=_mod(writer, "memo").FSMemoStore(tier))
    imp_w = _mod(writer, "impact")
    rec_keys = [k for k in w["memo"].store.keys() if imp_w.is_impact_key(k)]
    assert rec_keys, "scans must persist image records"
    want = _canon(w["idx"].postings_snapshot())
    r_cdb = _mod(reader, "db").CompiledDB.compile(
        _random_store(reader, np.random.default_rng(13)))
    r_memo = _memo(reader, _mod(reader, "memo").FSMemoStore(tier))
    r_idx = _mod(reader, "impact").ImpactIndex(store=r_memo.store)
    out = r_idx.rebuild(r_memo, r_cdb)
    assert out["complete"] and out["images"] == 2 and out["entries"]
    assert _canon(r_idx.postings_snapshot()) == want
    corrupt = r_memo.stats()["corrupt"]
    new = _mod(reader, "db").CompiledDB.compile(_mutate(
        reader, np.random.default_rng(5), _random_store(
            reader, np.random.default_rng(13))))
    r_memo.attach_impact(r_idx)
    _swap(reader, r_cdb, new, r_memo)
    assert r_memo.stats()["corrupt"] == corrupt
    dec = _mod(writer, "impact.index").decode_image_record
    for k in rec_keys:
        assert dec(r_memo.store.get(k)) is not None


@pytest.mark.parametrize("pkg", PKGS)
def test_unchanged_record_skips_the_store_put(pkg):
    imp = _mod(pkg, "impact")
    imp.IMPACT_METRICS.reset()
    try:
        idx = imp.ImpactIndex(store=_mod(pkg, "memo").MemoryMemoStore())
        idx.observe_image("img", ["b1"], tenant="t")
        idx.observe_image("img", ["b1"], tenant="t")
        snap = imp.IMPACT_METRICS.snapshot()
        assert (snap["persist_puts"], snap["persist_skips"],
                snap["image_updates"]) == (1, 1, 1)
    finally:
        imp.IMPACT_METRICS.reset()


# --- the push stream -------------------------------------------------

def _drain(src) -> list:
    out = []
    while True:
        ev = src.get(timeout=0.0)
        if ev is None:
            return out
        out.append(ev)


def test_push_events_equal_reference():
    """The same pushes give the same events (priority, tenant, path,
    ref, digest, event id) and the same ``impact_rescans`` count."""
    got = {}
    for pkg in PKGS:
        watch = _mod(pkg, "watch")
        src = watch.WebhookSource()
        before = watch.WATCH_METRICS.snapshot().get("impact_rescans", 0)
        n = _mod(pkg, "impact").ImpactPusher(src).push(
            [("/img/a.tar", "acme"), ("/img/b.tar", "")])
        evs = _drain(src)
        assert n == 2 == watch.WATCH_METRICS.snapshot()["impact_rescans"] \
            - before
        got[pkg] = [(e.digest, e.ref, e.path, e.tenant, e.priority,
                     e.event_id) for e in evs]
    assert got["port"] == got["ref"]
    imp = _mod("port", "impact")
    assert got["port"][0] == (
        "sha256:" + hashlib.sha256(b"/img/a.tar").hexdigest(), "a.tar",
        "/img/a.tar", "acme", imp.IMPACT_RESCAN_PRIORITY, "impact-0")


def test_push_storm_folds_into_debounce_as_reference(tmp_path):
    """A pushed storm (one image three times, another once) scans each
    image once; the loop's stats equal the reference's."""
    stats = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        paths, store = _mod(pkg, "utils.synth").tiny_fleet(str(d), 2)
        watch = _mod(pkg, "watch")
        src = watch.WebhookSource()
        _mod(pkg, "impact").ImpactPusher(src).push(
            [(paths[0], ""), (paths[0], ""), (paths[0], ""),
             (paths[1], "")])
        src.close()
        runner = _mod(pkg, "runtime").BatchScanRunner(
            store=store, backend=BACKEND[pkg])
        try:
            st = watch.WatchLoop(runner, src,
                                 watch.WatchConfig(debounce_s=0.05)).run()
        finally:
            runner.close()
        stats[pkg] = {k: st[k] for k in ("events", "scans", "deduped",
                                         "shed", "failed")}
    assert stats["port"] == stats["ref"]
    assert stats["port"]["scans"] == 2 and stats["port"]["deduped"] == 2


def test_hot_swap_pushes_only_newly_affected_as_reference(tmp_path):
    """An identical re-compile pushes nothing; a delta that adds an
    advisory for an installed package pushes every image that shares
    the layer; both packages push the same images."""
    pushed = {}
    for pkg in PKGS:
        src = _mod(pkg, "watch").WebhookSource()
        st = _indexed(pkg, tmp_path, 29,
                      pusher=_mod(pkg, "impact").ImpactPusher(src))
        cdb = _mod(pkg, "db").CompiledDB
        first = cdb.compile(st["adv"])
        _swap(pkg, st["cdb"], first, st["memo"])
        assert _drain(src) == []
        _swap(pkg, first, cdb.compile(_mutate(pkg, st["rng"], st["adv"])),
              st["memo"])
        pushed[pkg] = sorted(e.path for e in _drain(src))
    assert pushed["port"] == pushed["ref"] == sorted(st["paths"])


# --- federation ------------------------------------------------------

def _fetch_for(answers: dict):
    def fetch(url, cve):
        a = answers[url]
        if isinstance(a, Exception):
            raise a
        return a
    return fetch


FED_CASES = {
    "all_up": ({"u1": {"cve": "CVE-1", "packages": ["p1"], "layers": ["b1"],
                       "images": [["i1", ""]], "complete": True},
                "u2": {"cve": "CVE-1", "packages": ["p2"], "layers": ["b2"],
                       "images": [["i2", "acme"]], "complete": True}},
               [("r1", "u1"), ("r2", "u2")]),
    "one_down": ({"u1": {"cve": "CVE-1", "packages": ["p1"],
                         "layers": ["b1"], "images": [["i1", ""]],
                         "complete": True},
                  "u2": ConnectionError("replica down")},
                 [("r1", "u1"), ("r2", "u2")]),
    "degraded": ({"u1": {"cve": "CVE-1", "packages": [], "layers": [],
                         "images": [], "complete": False}},
                 [("r1", "u1")]),
    "empty": ({}, []),
}


@pytest.mark.parametrize("case", sorted(FED_CASES))
def test_federated_impact_equals_reference(case):
    """All peers up: the complete union; one down or degraded: a
    partial answer with ``complete: false``, never an error."""
    answers, replicas = FED_CASES[case]
    out = {pkg: _mod(pkg, "impact").federated_impact(
        replicas, "CVE-1", fetch=_fetch_for(answers)) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert out["port"]["complete"] is (case in ("all_up", "empty"))
    if case == "all_up":
        assert out["port"]["images"] == [["i1", ""], ["i2", "acme"]]
    if case == "one_down":
        rows = {r["replica"]: r for r in out["port"]["replicas"]}
        assert rows["r1"]["up"] and not rows["r2"]["up"]
        assert out["port"]["packages"] == ["p1"]


def test_federated_impact_over_http_with_a_dead_peer(tmp_path):
    """Over sockets: a live port replica and a dead address answer
    partially, the live slice whole."""
    st = _indexed("port", tmp_path, 41, n_images=2)
    cve = sorted({c for _p, c, _b in
                  st["idx"].postings_snapshot()["postings"]})[0]
    srv, url = _serve("port", st)
    try:
        out = _mod("port", "impact").federated_impact(
            [("up", url), ("down", "http://127.0.0.1:9")], cve,
            token=TOKEN, timeout_s=2.0)
    finally:
        srv()
    ref = st["idx"].query(cve)
    assert out["complete"] is False
    assert (out["layers"], out["images"], out["packages"]) == \
        (ref["layers"], ref["images"], ref["packages"])


# --- the HTTP route and the CLI --------------------------------------

def _serve(pkg, st, **kw):
    server = _mod(pkg, "rpc.server")
    if pkg == "port":
        kw.setdefault("backend", "cpu")
    if st is not None:
        kw.update(impact=st["idx"], memo=st["memo"], store=st["cdb"])
    srv = server.ScanServer(token=TOKEN, **kw)
    httpd, worker = server.serve(port=0, server=srv)

    def stop():
        httpd.shutdown()
        httpd.server_close()
        if worker is not None:
            worker.stop()
        srv.close()
    return stop, f"http://127.0.0.1:{httpd.server_address[1]}"


def _get(url: str, token: str = TOKEN):
    req = urllib.request.Request(url)
    if token:
        req.add_header("Trivy-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            return resp.status, json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode("utf-8"))


def test_impact_route_equals_reference(tmp_path):
    """``GET /impact?cve=`` on a port server answers every CVE as the
    reference's server over the same fleet and DB; a missing ``cve=``
    is 400, a missing token 401, a server without an index 404, and
    ``/metrics`` carries the index's section and families."""
    answers, stops = {}, []
    try:
        for pkg in PKGS:
            st = _indexed(pkg, tmp_path, 41, n_images=2)
            cves = sorted({c for _p, c, _b in
                           st["idx"].postings_snapshot()["postings"]})
            assert cves
            stop, url = _serve(pkg, st)
            stops.append(stop)
            got = [_get(f"{url}/impact?cve={c}") for c in cves + ["CVE-0"]]
            got += [_get(f"{url}/impact"), _get(f"{url}/impact?cve=x", "")]
            stop_b, url_b = _serve(pkg, None)
            stops.append(stop_b)
            got.append(_get(f"{url_b}/impact?cve={cves[0]}"))
            answers[pkg] = got
            srv_metrics = _get(f"{url}/metrics")[1]
            assert srv_metrics["impact"]["entries"] >= 1
            assert srv_metrics["impact"]["complete"] is True
    finally:
        for stop in stops:
            stop()
    assert answers["port"] == answers["ref"]
    codes = [c for c, _ in answers["port"]]
    assert codes[-3:] == [400, 401, 404] and set(codes[:-3]) == {200}
    assert answers["port"][0][1]["images"]


def test_impact_prom_families(tmp_path):
    st = _indexed("port", tmp_path, 41, n_images=2)
    srv = _mod("port", "rpc.server").ScanServer(
        backend="cpu", impact=st["idx"], memo=st["memo"], store=st["cdb"])
    try:
        text = srv.metrics_text()
    finally:
        srv.close()
    for fam in ("trivy_tpu_impact_pairs", "trivy_tpu_delta_touched_total",
                "trivy_tpu_watch_impact_rescans_total"):
        assert fam in text


def _cli(pkg, argv) -> tuple:
    cli = _mod(pkg, "cli")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = cli.main(list(argv))
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue().splitlines()


def test_impact_cli_equals_reference(tmp_path, monkeypatch):
    """``impact --server URL --cve ID`` prints the route's answer with
    exit 0 in both packages, against either package's server; a dead
    server exits 1 with the same ``error:`` line; under
    ``TRIVY_TIMEOUT=200ms`` both refuse the float ``--timeout`` with
    exit 2, while the port's scans keep the duration."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TRIVY_TIMEOUT", raising=False)
    st = _indexed("port", tmp_path, 41, n_images=2)
    cve = sorted({c for _p, c, _b in
                  st["idx"].postings_snapshot()["postings"]})[0]
    stop, url = _serve("port", st)
    try:
        argv = ["impact", "--server", url, "--cve", cve, "--token", TOKEN]
        got = {pkg: _cli(pkg, argv) for pkg in PKGS}
        assert got["port"] == got["ref"]
        assert got["port"][0] == 0
        assert json.loads(got["port"][1]) == st["idx"].query(cve)
        bad = {pkg: _cli(pkg, argv[:-2]) for pkg in PKGS}
        assert bad["port"] == bad["ref"] and bad["port"][0] == 1
        assert bad["port"][2][0].startswith("error: impact query: ")
    finally:
        stop()
    dead = ["impact", "--server", "http://127.0.0.1:9", "--cve", cve]
    got = {pkg: _cli(pkg, dead) for pkg in PKGS}
    assert got["port"] == got["ref"] and got["port"][0] == 1
    monkeypatch.setenv("TRIVY_TIMEOUT", "200ms")
    got = {pkg: _cli(pkg, dead) for pkg in PKGS}
    assert got["port"] == got["ref"] == (2, "", [
        "error: invalid value for TRIVY_TIMEOUT: could not convert "
        "string to float: '200ms'"])
    # the scans' own --timeout still takes the duration in the port
    parser = _mod("port", "cli").build_parser()
    _mod("port", "flag").apply_external_defaults(parser, ["sbom", "x"])
    assert parser.parse_args(["sbom", "x"]).timeout == "200ms"
