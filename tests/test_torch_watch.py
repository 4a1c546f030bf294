"""Continuous scanning: ``trivy_tpu_torch.watch`` (source, loop,
admission), the ``k8s`` image helpers, ``utils/synth.py``, the scan
server's ``/registry/notifications`` and ``/k8s/admission`` routes and
the ``watch`` subcommand, against the JAX package's (JAX on the CPU)
in the same process.

The same seeded inputs go to both packages: notification envelopes,
refs, AdmissionReviews, event schedules and ``tiny_fleet``'s images
(whose tars both packages write byte for byte). The port's loop runs
its scans on ``cpu`` (the torch code), the reference's on ``cpu-ref``;
their results, stats and verdicts must be equal. Trace ids are random:
the ``trivy-tpu/trace-N`` annotations are left out of the review
comparisons, and nothing asserts an order that the scheduler's threads
decide."""

import contextlib
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import trivy_tpu.k8s as rk8s
import trivy_tpu.utils.synth as rsynth
import trivy_tpu.watch as rwatch
import trivy_tpu_torch.k8s as tk8s
import trivy_tpu_torch.utils.synth as tsynth
import trivy_tpu_torch.watch as twatch
from tests.torch_threads import one_torch_thread  # noqa: F401
from trivy_tpu.watch.source import MANIFEST_MEDIA_TYPES

PKGS = ("ref", "port")
WATCH = {"ref": rwatch, "port": twatch}
BACKEND = {"ref": "cpu-ref", "port": "cpu"}


def _mkdir(path) -> str:
    os.makedirs(str(path), exist_ok=True)
    return str(path)


def _root(pkg) -> str:
    return "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"


def _mod(pkg, name):
    import importlib
    return importlib.import_module(_root(pkg) + "." + name)


def _both(fn) -> dict:
    out = {}
    for pkg in PKGS:
        try:
            out[pkg] = ("ok", fn(pkg))
        except Exception as e:      # noqa: BLE001 — compared below
            out[pkg] = (type(e).__name__, str(e))
    return out


def _event(ev) -> dict:
    d = dict(vars(ev))
    d.pop("ts")
    return d


def _books_balance(stats) -> bool:
    return stats["events"] == (stats["scans"] + stats["deduped"]
                               + stats["shed"])


# --- synth -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4])
def test_tiny_fleet_tars_are_byte_identical(n, tmp_path):
    """``tiny_fleet`` writes the same tars in both packages, and its
    stores hold the same advisories."""
    rp, rstore = rsynth.tiny_fleet(_mkdir(tmp_path / "r"), n, 20)
    tp, tstore = tsynth.tiny_fleet(_mkdir(tmp_path / "t"), n, 20)
    assert [open(p, "rb").read() for p in tp] == \
        [open(p, "rb").read() for p in rp]
    # the memo keys' DB fingerprint, which the packages share
    assert _mod("port", "memo.keys").db_fingerprint(tstore) == \
        _mod("ref", "memo.keys").db_fingerprint(rstore)


@pytest.mark.parametrize("gz", [False, True])
def test_write_image_tar_is_byte_identical(gz, tmp_path):
    rng = np.random.default_rng(5)
    layers = [{f"f{i}/{j}": bytes(rng.integers(0, 256, 64,
                                               dtype=np.uint8))
               for j in range(3)} for i in range(3)]
    cfg = {"architecture": "arm64", "os": "linux",
           "config": {"Env": ["A=1"]}}
    r = rsynth.write_image_tar(str(tmp_path / "r.tar"), layers, "a/b:1",
                               config=cfg, gzipped=gz)
    t = tsynth.write_image_tar(str(tmp_path / "t.tar"), layers, "a/b:1",
                               config=cfg, gzipped=gz)
    if gz:                  # gzip's header carries the mtime
        import gzip
        assert gzip.decompress(open(t, "rb").read()) == \
            gzip.decompress(open(r, "rb").read())
    else:
        assert open(t, "rb").read() == open(r, "rb").read()
    assert tsynth.layer_tar_bytes(layers[0]) == \
        rsynth.layer_tar_bytes(layers[0])


# --- the notification parse boundary ----------------------------------------

def _push(repo, digest, tag="", media=MANIFEST_MEDIA_TYPES[0], **kw):
    target = {"mediaType": media, "repository": repo, "digest": digest}
    if tag:
        target["tag"] = tag
    return dict({"action": "push", "target": target}, **kw)


BODIES = {
    "push": {"events": [_push("acme/api", "sha256:abc", "v3", id="e1")]},
    "pulls_and_blobs": {"events": [
        {"action": "pull", "target": {"repository": "a",
                                      "digest": "sha256:1"}},
        _push("a", "sha256:2", media="application/octet-stream")]},
    "malformed_entries": {"events": [
        {"action": "push", "target": {}},
        {"action": "push", "target": {"repository": "a"}},
        "not-a-dict",
        _push("ok", "sha256:ok")]},
    "not_a_list": {"events": "nope"},
    "list_body": ["x"],
    "none": None,
    "number": 42,
    "traceparent": {"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8
                    + "-01", "events": [_push("r", "sha256:t", "1"),
                                        _push("s", "sha256:u")]},
    "oci_index": {"events": [_push("r", "sha256:i", "x",
                                   media=MANIFEST_MEDIA_TYPES[3])]},
}


def _seeded_body(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    events = []
    for i in range(int(rng.integers(1, 12))):
        kind = int(rng.integers(6))
        if kind == 0:
            events.append({"action": "delete", "target": {}})
        elif kind == 1:
            events.append([i])
        elif kind == 2:
            events.append({"action": "push", "target": {
                "repository": f"r{i}"}})
        else:
            events.append(_push(f"team/r{int(rng.integers(4))}",
                                f"sha256:{int(rng.integers(99)):04x}",
                                f"v{int(rng.integers(3))}"
                                if rng.random() < 0.7 else "",
                                media=MANIFEST_MEDIA_TYPES[
                                    int(rng.integers(4))],
                                id=f"s{seed}-{i}"))
    return {"events": events}


@pytest.mark.parametrize("case", sorted(BODIES) + [f"seed{s}" for s in
                                                   range(6)])
def test_parse_notification_equals_the_reference(case, tmp_path):
    """The same envelope gives the same events (refs, digests, ids,
    resolved paths, tenant, priority, traceparent) and the same
    malformed count in both packages, and both count the malformed
    ones in ``WATCH_METRICS``."""
    body = BODIES[case] if case in BODIES else \
        _seeded_body(int(case[4:]))
    (tmp_path / "acme_api_v3.tar").write_bytes(b"x")

    def run(pkg):
        w = WATCH[pkg]
        before = w.WATCH_METRICS.snapshot()["malformed"]
        events, malformed = w.parse_notification(
            json.loads(json.dumps(body)),
            resolver=w.dir_resolver(str(tmp_path)), tenant="t",
            priority=3)
        assert w.WATCH_METRICS.snapshot()["malformed"] == \
            before + malformed
        return [_event(e) for e in events], malformed

    got = _both(run)
    assert got["ref"][0] == "ok" and got["port"] == got["ref"]


REFS = ["acme/api:v3", "acme/api:v2", "api:v3", "unknown:ref",
        "registry.local:5000/acme/api:v3", "acme/api@sha256:feed",
        "../acme_api_v3", "../../etc/passwd", "..", "/abs/path:1",
        "acme/../../api:v3", "", "a" * 300]


@pytest.mark.parametrize("ref", REFS)
def test_resolve_image_ref_equals_the_reference(ref, tmp_path):
    """``resolve_image_ref`` and ``dir_resolver`` map each ref to the
    same tarball, or to none, in both packages; a resolved path is
    always a file directly inside the images directory, so a ref never
    resolves outside it."""
    images = tmp_path / "images"
    images.mkdir()
    for name in ("acme_api_v3.tar", "api_v3.tar", "..tar",
                 "registry.local_5000_acme_api_v3.tar",
                 "acme_api_sha256_feed.tar"):
        (images / name).write_bytes(b"x")
    (tmp_path / "passwd.tar").write_bytes(b"x")
    (tmp_path / "acme_api_v3.tar").write_bytes(b"x")
    got = {pkg: (k8s.resolve_image_ref(str(images), ref),
                 WATCH[pkg].dir_resolver(str(images))(ref))
           for pkg, k8s in (("ref", rk8s), ("port", tk8s))}
    assert got["port"] == got["ref"]
    for path in got["port"]:
        if path is not None:
            assert os.path.dirname(os.path.abspath(path)) == str(images)
    assert tk8s.resolve_image_ref("", ref) is None


def _workload(kind: str, images: list, init: list = ()) -> dict:
    pod = {"containers": [{"name": f"c{i}", "image": r}
                          for i, r in enumerate(images)]}
    if init:
        pod["initContainers"] = [{"name": "i", "image": r} for r in init]
    if kind == "Pod":
        spec = pod
    elif kind == "CronJob":
        spec = {"jobTemplate": {"spec": {"template": {"spec": pod}}}}
    else:
        spec = {"template": {"spec": pod}}
    return {"kind": kind, "metadata": {"name": "w"}, "spec": spec}


@pytest.mark.parametrize("kind", list(tk8s.WORKLOAD_KINDS) + [
    "ConfigMap", "not-a-dict"])
def test_images_from_object_equals_the_reference(kind):
    """The pod-spec images of every workload kind (init containers
    first), as the reference's cluster scanner and admission webhook
    read them."""
    doc = "x" if kind == "not-a-dict" else _workload(
        kind, ["a:1", "b@sha256:2", ""], init=["init:3"])
    if kind == "ConfigMap":
        doc = {"kind": "ConfigMap", "data": {"image": "x"}}
    assert tk8s.images_from_object(doc) == rk8s.images_from_object(doc)
    assert list(tk8s.WORKLOAD_KINDS) == list(rk8s.WORKLOAD_KINDS)


# --- the sources -----------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 11, 20260804])
def test_synthetic_source_schedule_equals_the_reference(seed, tmp_path):
    """A seeded ``SyntheticSource`` yields the same events (seq,
    digest, ref, path, ids) in the same order, and resumes from a
    position the same way."""
    paths = [str(tmp_path / f"img{i}.tar") for i in range(5)]

    def run(pkg):
        src = WATCH[pkg].SyntheticSource(paths, rate=1000.0, n_events=40,
                                         seed=seed, dup_rate=0.4,
                                         burst=5, paced=False,
                                         tenant="t", priority=2)
        src.resume_from(6)
        out = []
        while not src.exhausted:
            ev = src.get(0)
            if ev is not None:
                out.append(_event(ev))
        return out

    got = _both(run)
    assert got["port"] == got["ref"] and got["port"][1][0]["seq"] == 7


@pytest.mark.parametrize("spec", [
    "event-storm", "event-storm:storm_events=64,storm_digests=4,"
    "storm_malformed=6", "event-storm:seed=9,storm_malformed=0",
    "storm_events=5,storm_digests=20,storm_malformed=3"])
def test_event_storm_equals_the_reference(spec, tmp_path):
    """``make_event_storm``: the same seeded envelopes, malformed ones
    at the same places."""
    import trivy_tpu.faults as rfaults
    import trivy_tpu_torch.faults as tfaults
    paths = [str(tmp_path / f"img{i}.tar") for i in range(6)]
    got = _both(lambda pkg: WATCH[pkg].make_event_storm(
        (rfaults if pkg == "ref" else tfaults).parse_fault_spec(spec),
        paths))
    assert got["port"] == got["ref"]
    spec_ = tfaults.parse_fault_spec(spec)
    assert len(got["port"][1]) == spec_.storm_events + \
        spec_.storm_malformed


def test_webhook_overflow_acks_dropped_seqs():
    """A full webhook queue drops its oldest events and hands their
    seqs to the loop, so the cursor passes the hole; the same drops in
    both packages."""
    def run(pkg):
        w = WATCH[pkg]
        src = w.WebhookSource(resolver=lambda r, d: None, maxsize=16)
        out = src.push_notification({"events": [
            _push(f"r{i}", f"sha256:{i}") for i in range(24)]})
        dropped = src.take_dropped()
        cur = w.Cursor("")
        for seq in dropped:
            cur.ack(seq)
        while True:
            ev = src.get(0)
            if ev is None:
                break
            cur.ack(ev.seq)
        return out, sorted(dropped), cur.position

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][1] == ({"accepted": 24, "malformed": 0,
                               "dropped": 8}, list(range(8)), 23)


# --- the cursor -----------------------------------------------------------

def test_cursor_contiguous_advance_and_reload(tmp_path):
    for pkg in PKGS:
        p = str(tmp_path / f"{pkg}.json")
        cur = WATCH[pkg].Cursor(p)
        cur.ack(1)
        assert cur.position == -1
        cur.ack(0)
        assert cur.position == 1
        cur.ack(3)
        cur.ack(2)
        assert cur.position == 3
        assert WATCH[pkg].Cursor(p).position == 3
    assert open(str(tmp_path / "port.json")).read() == \
        open(str(tmp_path / "ref.json")).read()


def _checkpoint_corpus() -> list:
    import random
    import zlib

    def crc(pos):
        return zlib.crc32(f"position:{pos}".encode())

    rng = random.Random(20260807)
    valid = json.dumps({"position": 1000, "crc": crc(1000)}).encode()
    corpus = [
        b"", b"{", b"{torn", b"null", b"[]", b'"position"', b"\x00\xff",
        b'{"position": true}', b'{"position": "12"}',
        b'{"position": 12.5}', b'{"position": 12, "extra": 1}',
        b'{"position": 12, "crc": 0}', b'{"position": 17}',
        b'{"position": 12, "crc": 999}', valid,
        json.dumps({"position": 9000, "crc": crc(1000)}).encode()]
    for _ in range(60):
        roll = rng.random()
        if roll < 0.4:
            corpus.append(valid[:rng.randrange(len(valid))])
        elif roll < 0.8:
            b = bytearray(valid)
            for _ in range(1 + rng.randrange(3)):
                b[rng.randrange(len(b))] = rng.randrange(256)
            corpus.append(bytes(b))
        else:
            corpus.append(bytes(rng.randrange(256)
                                for _ in range(rng.randrange(40))))
    return corpus


def test_torn_checkpoints_load_as_the_reference(tmp_path):
    """Whatever bytes a checkpoint holds (truncations, flipped bytes,
    wrong types, a stale CRC, the legacy doc), the port's cursor loads
    the reference's position: replay from the start unless the CRC
    (or the legacy shape) vouches for it, never a raise."""
    p = tmp_path / "cursor.json"
    for data in _checkpoint_corpus():
        p.write_bytes(data)
        got = {pkg: WATCH[pkg].Cursor(str(p)).position for pkg in PKGS}
        assert got["port"] == got["ref"], data
    p.write_bytes(b'{"position": 12, "crc": 999}')
    cur = twatch.Cursor(str(p))
    cur.ack(0)
    assert cur.position == 0


@pytest.mark.parametrize("case", ["hole", "tiny_cap", "shuffled"])
def test_cursor_ack_window_equals_the_reference(case):
    """The bounded out-of-order window: a hole that never fills is
    abandoned at the cap (floored at 16), an ample window abandons
    nothing; the stats equal the reference's after every ack."""
    import random
    if case == "hole":
        cap, seqs = 64, [0] + list(range(2, 2 + 65))
    elif case == "tiny_cap":
        cap, seqs = 1, list(range(2, 19))
    else:
        cap, seqs = 1024, list(range(500))
        random.Random(7).shuffle(seqs)

    def run(pkg):
        cur = WATCH[pkg].Cursor(ack_window=cap)
        out = []
        for s in seqs:
            cur.ack(s)
            out.append(cur.stats())
        return out

    got = _both(run)
    assert got["port"] == got["ref"]
    last = got["port"][1][-1]
    assert last["abandoned"] == {"hole": 1, "tiny_cap": 2,
                                 "shuffled": 0}[case]


# --- the loop --------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("watch-fleet")
    paths, _ = tsynth.tiny_fleet(str(tmp), 4)
    stores = {"ref": rsynth.tiny_fleet(_mkdir(tmp / "r"), 4)[1],
              "port": tsynth.tiny_fleet(_mkdir(tmp / "t"), 4)[1]}
    batch = {}
    for pkg in PKGS:
        runner = _mod(pkg, "runtime").BatchScanRunner(
            store=stores[pkg], backend=BACKEND[pkg])
        batch[pkg] = {os.path.basename(r.name): _norm(r)
                      for r in runner.scan_paths(paths)}
    assert batch["port"] == batch["ref"]
    return {"paths": paths, "stores": stores, "batch": batch["port"]}


def _norm(result) -> str:
    return json.dumps(result.report.to_dict(), sort_keys=True)


def _runner(pkg, store, memo=None, **sched_kw):
    cfg = dict(workers=2, flush_timeout_s=0.02, max_queue=64)
    cfg.update(sched_kw)
    return _mod(pkg, "runtime").BatchScanRunner(
        store=store, backend=BACKEND[pkg],
        sched=_mod(pkg, "sched").SchedConfig(**cfg), memo=memo)


def _events(pkg, paths, n, digests=None) -> list:
    digests = digests or len(paths)
    return [WATCH[pkg].PushEvent(digest=f"sha256:{i % digests:04x}",
                                 ref=f"img{i % digests}",
                                 path=paths[i % digests], seq=i)
            for i in range(n)]


def _loop(pkg, fleet, events_fn, config, source=None, **runner_kw):
    w = WATCH[pkg]
    runner = _runner(pkg, fleet["stores"][pkg], **runner_kw)
    try:
        src = source(pkg) if source is not None else \
            w.TraceSource(events_fn(pkg))
        loop = w.WatchLoop(runner, src, w.WatchConfig(**config))
        stats = loop.run()
        results = {os.path.basename(r.name): _norm(r)
                   for r in loop.results.values()}
    finally:
        runner.close()
    return stats, results


LOOPS = {
    "burst_debounce": (lambda pkg, f: [WATCH[pkg].PushEvent(
        digest="sha256:same", ref="img0", path=f["paths"][0], seq=i)
        for i in range(5)], {"debounce_s": 0.5},
        {"scans": 1, "deduped": 4, "shed": 0}),
    "distinct_digests": (lambda pkg, f: _events(pkg, f["paths"], 8, 4),
                         {"debounce_s": 0.3},
                         {"scans": 4, "deduped": 4}),
    "unresolvable": (lambda pkg, f: [WATCH[pkg].PushEvent(
        digest="sha256:x", ref="ghost", path="", seq=0)],
        {"debounce_s": 0.0}, {"shed": 1, "unresolvable": 1}),
    "watermark": (lambda pkg, f: [WATCH[pkg].PushEvent(
        digest=f"sha256:wm{i}", ref=f"img{i}",
        path=f["paths"][i % 4], seq=i) for i in range(12)],
        {"debounce_s": 0.0, "max_inflight": 2}, {"scans": 12}),
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_watch_loop_equals_the_reference(case, fleet):
    """The same events through both loops: the same books (events,
    scans, deduped, shed, completed, failed, cursor), which balance,
    and every kept result equals the batch scan of its target."""
    events, config, want = LOOPS[case]
    config = dict(config, keep_results=True)
    got = {pkg: _loop(pkg, fleet, lambda p: events(p, fleet), config)
           for pkg in PKGS}
    keys = ("events", "scans", "deduped", "shed", "completed", "failed",
            "unresolvable", "source_errors", "pending", "inflight",
            "cursor")
    for pkg in PKGS:
        stats = got[pkg][0]
        assert _books_balance(stats)
        assert {k: stats[k] for k in want} == want
        for name, text in got[pkg][1].items():
            assert text == fleet["batch"][name]
    assert {k: got["port"][0][k] for k in keys} == \
        {k: got["ref"][0][k] for k in keys}
    if case == "watermark":
        assert got["port"][0]["inflight_peak"] <= 2


def test_zero_debounce_folds_into_inflight(fleet):
    """With no debounce the first event submits at once; followers of
    the same digest fold into the in-flight scan or scan again after
    it — the books balance either way."""
    for pkg in PKGS:
        stats, _ = _loop(pkg, fleet, lambda p: [WATCH[p].PushEvent(
            digest="sha256:one", ref="img0", path=fleet["paths"][0],
            seq=i) for i in range(3)], {"debounce_s": 0.0})
        assert stats["scans"] >= 1 and _books_balance(stats)


def test_source_errors_survive_with_backoff(fleet):
    """A source whose ``get`` raises twice: two ``source_errors``, the
    loop backs off and scans both events, as the reference's."""
    def source(pkg):
        class Flaky(WATCH[pkg].TraceSource):
            fails = 2

            def get(self, timeout=0.05):
                if self.fails:
                    self.fails -= 1
                    raise ConnectionError("injected transport drop")
                return super().get(timeout)
        return Flaky(_events(pkg, fleet["paths"], 2, 2))

    got = {pkg: _loop(pkg, fleet, None, {"debounce_s": 0.0,
                                         "source_backoff_max_s": 0.05},
                      source=source)[0] for pkg in PKGS}
    for stats in got.values():
        assert (stats["source_errors"], stats["scans"]) == (2, 2)
        assert _books_balance(stats)


def test_checkpoint_resume_skips_backlog(fleet, tmp_path):
    """A restarted loop on the same stream resumes after its
    checkpoint: no event, no scan; the checkpoint files are the
    reference's, byte for byte."""
    for pkg in PKGS:
        ckpt = str(tmp_path / f"{pkg}.json")
        cfg = {"debounce_s": 0.0, "checkpoint_path": ckpt}
        first, _ = _loop(pkg, fleet,
                         lambda p: _events(p, fleet["paths"], 6, 3), cfg)
        assert first["cursor"] == 5
        second, _ = _loop(pkg, fleet,
                          lambda p: _events(p, fleet["paths"], 6, 3), cfg)
        assert (second["events"], second["scans"], second["cursor"]) == \
            (0, 0, 5)
    assert open(str(tmp_path / "port.json")).read() == \
        open(str(tmp_path / "ref.json")).read()


def test_synthetic_events_match_batch_scan(fleet):
    """A seeded synthetic stream through a loop with the findings memo:
    nothing failed or shed, the books balance and every kept result
    is the batch scan's report of its target; the loop's books equal
    the reference's."""
    got = {}
    for pkg in PKGS:
        w = WATCH[pkg]
        memo = _mod(pkg, "memo").make_findings_memo(
            backend=BACKEND[pkg])
        runner = _runner(pkg, fleet["stores"][pkg], memo=memo)
        try:
            loop = w.WatchLoop(runner, w.SyntheticSource(
                fleet["paths"], rate=500.0, n_events=24, seed=3,
                paced=False), w.WatchConfig(debounce_s=0.02,
                                            keep_results=True))
            stats = loop.run()
            results = {os.path.basename(r.name): _norm(r)
                       for r in loop.results.values()}
        finally:
            runner.close()
        assert stats["failed"] == 0 and stats["shed"] == 0
        assert _books_balance(stats) and results
        for name, text in results.items():
            assert text == fleet["batch"][name]
        got[pkg] = (stats["events"], sorted(results))
    assert got["port"] == got["ref"]


def test_storm_books_balance(fleet):
    """The ``event-storm`` payload pushed from a thread into a webhook
    source while a small scheduler sheds: malformed envelopes counted
    and dropped, every accepted event in exactly one disposition, the
    duplicate-tag storm collapsed."""
    import trivy_tpu_torch.faults as tfaults
    spec = tfaults.parse_fault_spec(
        "event-storm:storm_events=64,storm_digests=4,storm_malformed=6")
    storm = twatch.make_event_storm(spec, fleet["paths"])
    paths = fleet["paths"]
    src = twatch.WebhookSource(resolver=lambda ref, digest: next(
        (p for p in paths if ref.split(":")[0] in p), None))
    runner = _runner("port", fleet["stores"]["port"], max_queue=8)
    loop = twatch.WatchLoop(runner, src, twatch.WatchConfig(
        debounce_s=0.02, max_inflight=4, submit_retries=1,
        backoff_max_s=0.05))
    before = twatch.WATCH_METRICS.snapshot()["malformed"]
    seen = {"accepted": 0, "malformed": 0}

    def push():
        for body in storm:
            out = src.push_notification(body)
            seen["accepted"] += out["accepted"]
            seen["malformed"] += out["malformed"]
        src.close()

    t = threading.Thread(target=push, daemon=True)
    t.start()
    try:
        stats = loop.run()
    finally:
        t.join(timeout=30)
        runner.close()
    assert seen["malformed"] == 6
    assert twatch.WATCH_METRICS.snapshot()["malformed"] >= before + 6
    assert stats["events"] == seen["accepted"] - src.dropped
    assert _books_balance(stats)
    assert stats["scans"] < stats["events"] and stats["deduped"] > 0


def test_lag_exemplars_carry_trace_ids(fleet):
    """Each completed scan observes the event lag with its trace id as
    the exemplar."""
    _loop("port", fleet, lambda p: _events(p, fleet["paths"], 2, 2),
          {"debounce_s": 0.0})
    ex = twatch.WATCH_METRICS.hist_snapshot()["watch_lag"]["exemplars"]
    trace_id = next(iter(ex.values()))[0]
    assert trace_id and all(c in "0123456789abcdef" for c in trace_id)


# --- admission -------------------------------------------------------------

@pytest.mark.parametrize("text,fail", [
    ("deny:CRITICAL,high", "open"), ("audit", "closed"), ("", "408"),
    ("deny: low , ", "open"), ("deny:BOGUS", "open"),
    ("allow:HIGH", "open"), ("deny:", "open"), ("deny:HIGH", "maybe"),
    ("deny", "open")])
def test_admission_policy_grammar_equals_the_reference(text, fail):
    got = _both(lambda pkg: (lambda p: (p.deny, p.fail, p.sig()))(
        WATCH[pkg].AdmissionPolicy.parse(text, fail=fail)))
    assert got["port"] == got["ref"]


def _review(images, uid="uid-1", kind="Pod"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "object": _workload(kind, images)}}


def _untraced(doc: dict) -> dict:
    resp = dict(doc["response"])
    resp["auditAnnotations"] = {
        k: v for k, v in resp["auditAnnotations"].items()
        if not k.startswith("trivy-tpu/trace-")}
    return dict(doc, response=resp)


@pytest.fixture(scope="module")
def adm(tmp_path_factory):
    """Per package: the tiny fleet's store compiled behind a
    ``SwappableStore``, a memo and a scheduled runner; a resolver over
    img0, img1 and a clean image."""
    tmp = tmp_path_factory.mktemp("adm")
    paths, _ = tsynth.tiny_fleet(str(tmp), 2)
    clean = tsynth.write_image_tar(str(tmp / "clean.tar"),
                                   [{"etc/motd": b"hello\n"}],
                                   "clean/img:1")
    table = {"img0": paths[0], "img1": paths[1], "clean": clean}
    env = {}
    for pkg in PKGS:
        db = _mod(pkg, "db")
        store = (rsynth if pkg == "ref" else tsynth).tiny_fleet(
            _mkdir(tmp / pkg), 2)[1]
        holder = _mod(pkg, "db.compiled").SwappableStore(
            db.CompiledDB.compile(store))
        memo = _mod(pkg, "memo").make_findings_memo(backend=BACKEND[pkg])
        env[pkg] = {"holder": holder, "memo": memo,
                    "runner": _runner(pkg, holder, memo=memo)}
    yield {"env": env, "resolver": lambda ref, digest="": table.get(
        ref.split("@")[0].split(":")[0]), "paths": paths}
    for pkg in PKGS:
        env[pkg]["runner"].close()


def _controller(pkg, adm, policy="deny:HIGH,CRITICAL", fail="open", **kw):
    e = adm["env"][pkg]
    w = WATCH[pkg]
    return w.AdmissionController(
        e["runner"], store=e["holder"], memo=e["memo"],
        policy=w.AdmissionPolicy.parse(policy, fail=fail),
        resolver=adm["resolver"], default_deadline_s=60.0, **kw)


REVIEWS = {
    "deny_pod": (["img0"], "Pod", "deny:HIGH,CRITICAL", "open"),
    "deny_deployment": (["img1"], "Deployment", "deny:CRITICAL", "open"),
    "cronjob_two_images": (["img0", "clean"], "CronJob",
                           "deny:HIGH,CRITICAL", "open"),
    "audit": (["img0"], "Pod", "audit", "open"),
    "allow_clean": (["clean"], "StatefulSet", "deny:LOW", "open"),
    "fail_open": (["ghost-image"], "Pod", "deny:CRITICAL", "open"),
    "fail_closed": (["ghost-image", "clean"], "Pod", "deny:CRITICAL",
                    "closed"),
    "stance_408": (["ghost-image"], "Pod", "deny:CRITICAL", "408"),
    "pinned_digest": (["img0@sha256:feed"], "DaemonSet", "deny:MEDIUM",
                      "open"),
}


@pytest.mark.parametrize("case", sorted(REVIEWS))
def test_admission_verdicts_equal_the_reference(case, adm):
    """Each review through both controllers: the same response
    (allowed, status, annotations but trace ids), then a second review
    of the same images answered from the verdict cache; a ``408``
    stance raises ``AdmissionUnavailable`` with the same message."""
    images, kind, policy, fail = REVIEWS[case]

    def run(pkg):
        ctl = _controller(pkg, adm, policy=policy, fail=fail)
        first = _untraced(ctl.review(_review(images, kind=kind)))
        second = _untraced(ctl.review(_review(images, uid="uid-2",
                                              kind=kind)))
        return first, second, ctl.stats()

    got = _both(run)
    assert got["port"] == got["ref"]
    if fail == "408":
        assert got["port"][0] == "AdmissionUnavailable"
        return
    first, second, _ = got["port"][1]
    resp = first["response"]
    assert first["kind"] == "AdmissionReview" and resp["uid"] == "uid-1"
    if case in ("deny_pod", "deny_deployment", "cronjob_two_images",
                "fail_closed"):
        assert resp["allowed"] is False
        assert resp["status"]["reason"] == "AdmissionDenied"
    if case in ("audit", "allow_clean", "fail_open"):
        assert resp["allowed"] is True
    if case == "fail_open":
        assert "fail-open" in resp["auditAnnotations"]["trivy-tpu/image-0"]
    resolved = [i for i, r in enumerate(images) if r != "ghost-image"]
    for i in resolved:
        assert second["response"]["auditAnnotations"][
            f"trivy-tpu/image-{i}"].endswith("[cache]")


def test_verdict_equals_the_policy_on_the_batch_report(adm):
    """A verdict's counts are ``severity_counts`` of the image's own
    batch report, and ``allowed`` is the policy applied to them."""
    ctl = _controller("port", adm, policy="deny:CRITICAL")
    report = _mod("port", "runtime").BatchScanRunner(
        store=adm["env"]["port"]["holder"], backend="cpu").scan_paths(
        [adm["paths"][0]])[0].report
    counts = twatch.severity_counts(report)
    resp = ctl.review(_review(["img0"], uid="u-p"))["response"]
    ann = resp["auditAnnotations"]["trivy-tpu/image-0"]
    want = ",".join(f"{s}:{n}" for s, n in sorted(counts.items()) if n)
    assert f"({want})" in ann
    assert resp["allowed"] is (not counts.get("CRITICAL"))
    assert counts == rwatch.severity_counts(_mod("ref", "runtime")
                                            .BatchScanRunner(
        store=adm["env"]["ref"]["holder"], backend="cpu-ref")
        .scan_paths([adm["paths"][0]])[0].report)


def test_deadline_exhaustion_fail_open_and_background(adm):
    """A deadline spent before the scan: fail open (counted), and the
    scan goes on in the background on the same runner."""
    ctl = _controller("port", adm, fail="open")
    before = twatch.WATCH_METRICS.snapshot()
    resp = ctl.review(_review(["img1"], uid="u-dl"),
                      deadline_s=1e-9)["response"]
    after = twatch.WATCH_METRICS.snapshot()
    assert resp["allowed"] is True
    assert after["admission_fail_open"] > before["admission_fail_open"]
    assert after["admission_background_scans"] == \
        before["admission_background_scans"] + 1
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and ctl.stats()[
            "background_pending"]:
        ctl._harvest_background()
        time.sleep(0.05)
    resp = ctl.review(_review(["img1"], uid="u-next"))["response"]
    assert resp["auditAnnotations"]["trivy-tpu/image-0"].endswith(
        "[cache]")


@pytest.mark.parametrize("bad", [
    {}, {"kind": "AdmissionReview"},
    {"kind": "AdmissionReview", "request": {"uid": "u"}},
    {"kind": "Other", "request": {"uid": "u"}},
    {"kind": "AdmissionReview", "request": {"uid": "", "object": {}}},
    ["AdmissionReview"]])
def test_malformed_reviews_raise_as_the_reference(bad, adm):
    got = _both(lambda pkg: _controller(pkg, adm).review(bad))
    assert got["port"] == got["ref"] and \
        got["port"][0] == "MalformedReview"


def test_tag_verdict_expires_digest_verdict_does_not(adm):
    """A mutable tag's cached verdict expires after its TTL; a
    digest-pinned ref's does not."""
    ctl = _controller("port", adm, policy="deny:CRITICAL",
                      tag_verdict_ttl_s=0.05)
    ann = "trivy-tpu/image-0"
    ctl.review(_review(["img0:latest"]))
    assert "[cache]" in ctl.review(_review(["img0:latest"]))[
        "response"]["auditAnnotations"][ann]
    time.sleep(0.08)
    assert "[cache]" not in ctl.review(_review(["img0:latest"]))[
        "response"]["auditAnnotations"][ann]
    ctl.review(_review(["img0@sha256:beef"]))
    time.sleep(0.08)
    assert "[cache]" in ctl.review(_review(["img0@sha256:beef"]))[
        "response"]["auditAnnotations"][ann]


def test_db_hot_swap_invalidates_verdicts(tmp_path):
    """A verdict cached under one advisory generation is not served
    after a hot swap: the next review keys against the new context,
    in both packages alike."""
    paths, _ = tsynth.tiny_fleet(str(tmp_path), 2)

    def run(pkg):
        db = _mod(pkg, "db")
        store = (rsynth if pkg == "ref" else tsynth).tiny_fleet(
            _mkdir(tmp_path / pkg), 2)[1]
        holder = _mod(pkg, "db.compiled").SwappableStore(
            db.CompiledDB.compile(db.AdvisoryStore()))
        memo = _mod(pkg, "memo").make_findings_memo(backend=BACKEND[pkg])
        runner = _runner(pkg, holder, memo=memo)
        w = WATCH[pkg]
        ctl = w.AdmissionController(
            runner, store=holder, memo=memo,
            policy=w.AdmissionPolicy.parse("deny:HIGH"),
            resolver=lambda ref, digest: paths[0],
            default_deadline_s=60.0, security_checks=["vuln"])
        try:
            out = [_untraced(ctl.review(_review(["img0"])))]
            out.append(_untraced(ctl.review(_review(["img0"]))))
            holder.swap(db.CompiledDB.compile(store))
            out.append(_untraced(ctl.review(_review(["img0"]))))
            return out
        finally:
            runner.close()

    got = _both(run)
    assert got["port"] == got["ref"]
    a, hit, b = got["port"][1]
    assert a["response"]["allowed"] is True
    assert "[cache]" in hit["response"]["auditAnnotations"][
        "trivy-tpu/image-0"]
    assert b["response"]["allowed"] is False
    assert "[cache]" not in b["response"]["auditAnnotations"][
        "trivy-tpu/image-0"]


# --- the server's routes ---------------------------------------------------

def _serve(pkg, request, **kw):
    server = _mod(pkg, "rpc.server")
    if pkg == "port":
        kw.setdefault("backend", "cpu")
    srv = server.ScanServer(**kw)
    httpd, _ = server.serve(port=0, server=srv)

    def stop():
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    request.addfinalizer(stop)
    return srv, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, path, data: bytes) -> tuple:
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served(adm, request):
    """Per package: a server sharing ``adm``'s runner scheduler with an
    admission controller (deny HIGH and CRITICAL, the 408 stance) and
    a webhook source over the same resolver."""
    out = {}
    for pkg in PKGS:
        e = adm["env"][pkg]
        src = WATCH[pkg].WebhookSource(resolver=adm["resolver"])
        ctl = _controller(pkg, adm, fail="408")
        out[pkg] = (_serve(pkg, request, store=e["holder"],
                           sched=e["runner"].scheduler, memo=e["memo"],
                           admission=ctl, watch_source=src)[1], src)
    return out


ROUTE_CASES = {
    "review_deny": ("/k8s/admission", lambda: _review(["img0"], uid="h1")),
    "review_allow": ("/k8s/admission",
                     lambda: _review(["clean"], uid="h2",
                                     kind="Deployment")),
    "review_cronjob": ("/k8s/admission",
                       lambda: _review(["img1"], uid="h3",
                                       kind="CronJob")),
    "review_408": ("/k8s/admission?timeout=0.000001s",
                   lambda: _review(["img0-cold-miss"], uid="h4")),
    "review_bad_timeout": ("/k8s/admission?timeout=bogus",
                           lambda: _review(["clean"])),
    "review_malformed": ("/k8s/admission", lambda: {"kind": "nope"}),
    "notification": ("/registry/notifications",
                     lambda: BODIES["malformed_entries"]),
    "notification_torn": ("/registry/notifications", b"{torn json"),
    "notification_non_envelope": ("/registry/notifications",
                                  lambda: ["x"]),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_routes_answer_as_the_reference(case, served):
    """``POST /k8s/admission`` and ``POST /registry/notifications`` on
    the port's server answer as the reference's: the same status code
    and body (trace ids left out) — 200 reviews, 408 under the 408
    stance with an impossible apiserver timeout, 400 for a bad timeout
    or a malformed review, and an always-200 notification count."""
    path, body = ROUTE_CASES[case]
    data = body if isinstance(body, bytes) else \
        json.dumps(body()).encode()
    got = {}
    for pkg in PKGS:
        code, doc = _post(served[pkg][0], path, data)
        got[pkg] = (code, _untraced(doc) if code == 200 and
                    "response" in doc else doc)
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"review_408": 408,
                              "review_bad_timeout": 400,
                              "review_malformed": 400}.get(case, 200)


def test_notifications_feed_the_source(served):
    """A push envelope on the route lands in the server's webhook
    source as resolved events, in both packages alike."""
    got = {}
    for pkg in PKGS:
        base, src = served[pkg]
        code, doc = _post(base, "/registry/notifications", json.dumps(
            {"events": [_push("img0", "sha256:n0", "v1"),
                        _push("img1", "sha256:n1")]}).encode())
        events = []
        while True:
            ev = src.get(0)
            if ev is None:
                break
            events.append(_event(ev))
        got[pkg] = (code, doc["accepted"], [
            (e["digest"], e["ref"], os.path.basename(e["path"]))
            for e in events[-2:]])
    assert got["port"] == got["ref"]
    assert got["port"][2] == [("sha256:n0", "img0:v1", "img0.tar"),
                              ("sha256:n1", "img1", "img1.tar")]


def test_routes_are_404_without_their_owners(request):
    """A server without an admission controller or a webhook source
    answers 404 on both routes, as the reference's."""
    for pkg in PKGS:
        _, base = _serve(pkg, request, sched="off")
        assert _post(base, "/k8s/admission",
                     json.dumps(_review(["x"])).encode())[0] == 404
        assert _post(base, "/registry/notifications",
                     b'{"events": []}')[0] == 404


@pytest.mark.parametrize("sched", ["off", "on"])
def test_metrics_surface_watch_and_admission(sched, request, adm):
    """``/metrics`` carries the ``watch`` counters on both sched modes
    (the reference's keys), and the admission controller's stats when
    one is mounted; the Prometheus text has the watch and admission
    families."""
    ctl = _controller("port", adm)
    srv, _ = _serve("port", request, sched=sched, admission=ctl)
    snap = srv.metrics()
    assert set(snap["watch"]) == set(rwatch.WATCH_METRICS.snapshot())
    assert snap["admission_controller"] == ctl.stats()
    text = srv.metrics_text()
    for fam in ("trivy_tpu_watch_events_total",
                "trivy_tpu_watch_shed_total",
                "trivy_tpu_admission_allow_total",
                "trivy_tpu_admission_fail_open_total",
                "trivy_tpu_watch_lag_seconds_bucket",
                "trivy_tpu_admission_latency_seconds_bucket"):
        assert fam in text, fam
    assert srv.metrics_text(openmetrics=True).rstrip().endswith("# EOF")


# --- the watch subcommand --------------------------------------------------

def _cli(pkg, argv) -> tuple:
    from trivy_tpu.cli import main as rmain
    from trivy_tpu_torch.cli import main as tmain
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = (rmain if pkg == "ref" else tmain)(argv)
    text = err.getvalue()
    stats = None
    if '{\n  "watch"' in text:
        stats = json.loads(text[text.index('{\n  "watch"'):])["watch"]
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("error:", "fault-spec:"))]
    return code, stats, lines


@pytest.fixture(scope="module")
def cli_fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("watch-cli")
    paths, store = tsynth.tiny_fleet(str(tmp), 3)
    from trivy_tpu_torch.db import CompiledDB
    CompiledDB.compile(store).save(str(tmp / "cdb"))
    return paths, str(tmp / "cdb")


@pytest.mark.parametrize("argv", [
    ["--watch-source", "synthetic:rate=1000,n=12,seed=7", "--listen", ""],
    ["--watch-source", "webhook", "--listen", "127.0.0.1:0",
     "--fault-spec", "event-storm:storm_events=24,storm_digests=3,"
     "storm_malformed=2", "--debounce-ms", "20"],
    # a route spec: nothing of it fires in watch, as in the reference
    ["--watch-source", "synthetic:rate=1000,n=12,seed=7", "--listen", "",
     "--fault-spec", "replica-kill"]])
def test_watch_cli_equals_the_reference(argv, cli_fleet, tmp_path,
                                        monkeypatch):
    """``watch`` with a seeded synthetic source, and with the
    ``event-storm`` drill on the webhook: exit 0, the ``{"watch":
    stats}`` line on stderr with balanced books, the same events and
    dispositions' total as the reference's."""
    monkeypatch.chdir(tmp_path)
    paths, cdb = cli_fleet
    got = {}
    for pkg in PKGS:
        extra = ["--backend", BACKEND[pkg], "--compiled-db", cdb]
        if pkg == "ref":
            extra += ["--no-cache"]
        code, stats, lines = _cli(pkg, ["watch", *paths] + argv + extra)
        assert code == 0 and _books_balance(stats), (pkg, lines)
        assert stats["failed"] == 0 and stats["pending"] == 0
        got[pkg] = (stats["events"], stats["cursor"], lines)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("argv", [
    ["--watch-source", "carrier-pigeon"],
    ["--watch-source", "synthetic:speed=3"],
    ["--watch-source", "synthetic:rate=fast"],
    ["--fault-spec", "event-storm", "--watch-source", "synthetic"],
    ["--listen", "nowhere"],
    ["--admission-policy", "deny:NOPE"],
])
def test_watch_cli_errors_equal_the_reference(argv, cli_fleet, tmp_path,
                                              monkeypatch):
    """A bad source, storm without the webhook, a bad listen address or
    a bad policy ends the run with the reference's exit code (2)
    before any scan."""
    import trivy_tpu_torch.cli as tcli
    monkeypatch.chdir(tmp_path)
    paths, cdb = cli_fleet

    def no_scan(*a, **k):
        raise AssertionError("a scan ran")

    monkeypatch.setattr(tcli, "BatchScanRunner", no_scan)
    common = ["watch", *paths, "--compiled-db", cdb]
    got = _cli("port", common + argv + ["--backend", "cpu"])
    want = _cli("ref", common + argv + ["--backend", "cpu-ref",
                                        "--no-cache"])
    assert got[0] == want[0] == 2
    assert got[2] == want[2] and len(got[2]) == 1


def test_watch_cli_on_cuda_without_a_card_raises_before_any_scan(
        cli_fleet, monkeypatch, tmp_path):
    import torch

    import trivy_tpu_torch.cli as tcli
    monkeypatch.chdir(tmp_path)

    def no_load(*a, **k):
        raise AssertionError("the DB was loaded")

    monkeypatch.setattr(tcli, "load_store", no_load)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["watch", *cli_fleet[0], "--watch-source",
                   "synthetic", "--listen", ""])
