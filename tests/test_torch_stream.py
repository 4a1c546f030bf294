"""Scanning straight from a registry: ``trivy_tpu_torch.artifact.stream``
and ``BatchScanRunner.scan_registry_refs`` against the JAX package's
(JAX on the CPU) on one seeded fleet served by the port's
``LocalRegistry`` on 127.0.0.1.

The fleet is ``chip_smoke.fleet_targets`` at a small scale: a shared
base, a shared secret layer, lockfiles of their own, the corpus in
parts, a twin under a second tag; one target's layers are gzipped so
the bounded inflate runs. Both packages scan the same refs, so the
names in the reports are the same: reports must be equal after
``sort_keys`` (streamed, pulled whole, ``sched`` off and on). Then the
warm re-pull (no blob GET), a probe outage, the hostile corpus and a
gzip bomb (the same causes), the per-layer budgets, the ``fetch`` /
``decompress`` spans and the timeline's ``fetch_serialized``.

The ingest counters are process-wide: a fixture resets them (and the
config memo) around every test, and the tests read them only after
the scan returned. The port's ``StreamingImageSource.close()`` cancels
the fetches still running and waits for them, so once a scan has
returned every layer is fetched, skipped or cancelled
(``test_counters_are_final_when_the_scan_returns``); in the JAX
package a fetch that outlives its source's close lands later or not
at all."""

import dataclasses
import gzip
import json
import os
import tarfile
import time
from collections import namedtuple

import numpy as np
import pytest

import trivy_tpu.artifact.stream as rstream
import trivy_tpu.db as rdb
import trivy_tpu.guard as rguard
import trivy_tpu.guard.budget as rbudget
import trivy_tpu.obs.timeline as rtimeline
import trivy_tpu_torch.artifact.stream as tstream
import trivy_tpu_torch.guard as tguard
import trivy_tpu_torch.guard.budget as tbudget
import trivy_tpu_torch.obs.timeline as ttimeline
from chip_smoke import (FS_ROOTS, RedisStub, fleet_targets,
                        gzip_docker_save, make_advisory_store, make_corpus)
from tests.test_stream import _image_tar, _layer_tar
from tests.test_torch_fleet import _norm
from tests.test_torch_sched import _untraced
from tests.torch_threads import one_torch_thread  # noqa: F401
from trivy_tpu.artifact.registry import DistributionClient as RClient
from trivy_tpu.obs import Tracer as RTracer
from trivy_tpu.obs.prom import render_prometheus as rprom
from trivy_tpu.runtime import BatchScanRunner as RRunner
from trivy_tpu.types import ScanOptions as RScanOptions
from trivy_tpu_torch.artifact import ArtifactOption as TArtifactOption
from trivy_tpu_torch.artifact.localreg import LocalRegistry
from trivy_tpu_torch.artifact.registry import DistributionClient as TClient
from trivy_tpu_torch.obs import Tracer as TTracer
from trivy_tpu_torch.obs.prom import render_prometheus as tprom
from trivy_tpu_torch.runtime import BatchScanRunner as TRunner
from trivy_tpu_torch.types import ScanOptions as TScanOptions
from trivy_tpu.artifact.artifact import ArtifactOption as RArtifactOption

STORE_ROWS = 3000
SEED = 20261018
N_TARGETS = 6           # 4 images, a twin, a truncated tar (not pushed)
GZIPPED = 1             # the target whose layers are gzipped
SCALE = 0.04

PKGS = {
    "ref": dict(stream=rstream, Runner=RRunner, Client=RClient,
                Options=RScanOptions, Option=RArtifactOption,
                guard=rguard, backend="cpu-ref"),
    "port": dict(stream=tstream, Runner=TRunner, Client=TClient,
                 Options=TScanOptions, Option=TArtifactOption,
                 guard=tguard, backend="cpu"),
}


@pytest.fixture(autouse=True)
def _fresh_ingest_state():
    """Process-wide counters and the config-blob memo of both packages
    start every test at zero."""
    for pkg in (rstream, tstream):
        pkg.INGEST_METRICS.reset()
        pkg.clear_config_memo()
    yield
    for pkg in (rstream, tstream):
        pkg.INGEST_METRICS.reset()
        pkg.clear_config_memo()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The seeded fleet in a ``LocalRegistry``: {"reg", "refs", "paths",
    "stores": {pkg: store}, "layers": layers over every ref}."""
    d = tmp_path_factory.mktemp("stream")
    rstore, n_pkgs = make_advisory_store(STORE_ROWS, SEED,
                                         store=rdb.AdvisoryStore())
    tstore, _ = make_advisory_store(STORE_ROWS, SEED)
    corpus, _ = make_corpus(32, 11)
    plan = fleet_targets(str(d), FS_ROOTS["fs"], n_pkgs, 5, corpus,
                         n_images=N_TARGETS, scale=SCALE)
    paths = [p for i, p in enumerate(plan["paths"]) if i != plan["broken"]]
    paths[GZIPPED] = gzip_docker_save(paths[GZIPPED],
                                      str(d / "fleet-gz.tar"))
    reg = LocalRegistry()
    for i, p in enumerate(paths):
        reg.add_image("smoke/fleet", str(i), p)
    reg.start()
    refs = [reg.ref("smoke/fleet", str(i)) for i in range(len(paths))]
    layers = 0
    for p in paths:
        with tarfile.open(p) as tf:
            layers += len(json.loads(
                tf.extractfile("manifest.json").read())[0]["Layers"])
    yield {"reg": reg, "refs": refs, "paths": paths, "layers": layers,
           "stores": {"ref": rstore, "port": tstore}}
    reg.stop()


def _runner(fleet, pkg: str, sched="off", limits=None, cache=None,
            tracer=None):
    p = PKGS[pkg]
    opt = None
    if limits is not None:
        opt = p["Option"](ingest_guards=True, ingest_limits=limits)
    return p["Runner"](store=fleet["stores"][pkg] if fleet else None,
                       backend=p["backend"], sched=sched,
                       artifact_option=opt, cache=cache, tracer=tracer)


def _scan(fleet, pkg: str, refs, sched="off", streaming=True,
          runner=None, **kwargs) -> list:
    p = PKGS[pkg]
    own = runner is None
    runner = runner or _runner(fleet, pkg, sched, **kwargs)
    try:
        return runner.scan_registry_refs(
            refs, p["Client"](), p["Options"](backend=p["backend"]),
            streaming=streaming)
    finally:
        if own:
            runner.close()


_REF: dict = {}


def _reference(fleet, sched: str) -> list:
    """The JAX package's streamed reports, once per sched mode."""
    if sched not in _REF:
        _REF[sched] = _norm(_scan(fleet, "ref", fleet["refs"], sched))
    return _REF[sched]


# --- streamed, pulled whole, both packages ---------------------------

@pytest.mark.parametrize("sched", ["off", "on"])
def test_streamed_equals_materialized_and_reference(fleet, sched):
    streamed = _scan(fleet, "port", fleet["refs"], sched)
    cold = tstream.INGEST_METRICS.snapshot()
    pulled = _scan(fleet, "port", fleet["refs"], sched, streaming=False)
    assert _norm(streamed) == _norm(pulled) == _reference(fleet, sched)
    assert all(r.status == "ok" for r in streamed)
    # the streaming path ran: one stream per ref, every layer fetched,
    # skipped or cancelled by the time the scan returned
    assert cold["streams"] == len(fleet["refs"])
    assert cold["layers_fetched"] >= 1
    assert cold["layers_fetched"] + cold["layers_skipped"] + \
        cold["cancelled_fetches"] == fleet["layers"]
    assert tstream.INGEST_METRICS.snapshot()["streams"] == len(
        fleet["refs"])                  # pulled whole: no stream
    doc = json.dumps([r.report.to_dict() for r in streamed])
    assert '"Class": "secret"' in doc and "VulnerabilityID" in doc
    twin = [json.loads(_norm(streamed)[i][1]) for i in (3, 4)]
    assert twin[0]["Metadata"]["RepoTags"] != twin[1]["Metadata"]["RepoTags"]


def test_counters_are_final_when_the_scan_returns(fleet):
    """The JAX package's ``test_streamed_matches_materialized[off]``
    reads ``layers_fetched + layers_skipped`` right after the scan and
    fails under load: a layer that inspect never opened (an earlier
    image put its blob) is still fetching when its source is closed,
    and then fails writing into the deleted spool. In the port the
    close cancels it and waits, so even on a slow registry the
    counters are final and the same on every run."""
    slow = LocalRegistry(throttle_bps=2 << 20, chunk=16 << 10)
    for i, p in enumerate(fleet["paths"]):
        slow.add_image("smoke/fleet", str(i), p)
    slow.start()
    seen = []
    try:
        refs = [slow.ref("smoke/fleet", str(i))
                for i in range(len(fleet["paths"]))]
        for _ in range(2):
            tstream.INGEST_METRICS.reset()
            tstream.clear_config_memo()
            _scan(fleet, "port", refs, "off")
            m = tstream.INGEST_METRICS.snapshot()
            seen.append(m["layers_fetched"] + m["layers_skipped"] +
                        m["cancelled_fetches"])
            time.sleep(0.3)
            assert tstream.INGEST_METRICS.snapshot() == m   # none late
    finally:
        slow.stop()
    assert seen == [fleet["layers"]] * 2


@pytest.mark.parametrize("sched", ["off", "on"])
def test_warm_repull_makes_no_blob_get(fleet, sched):
    reg = fleet["reg"]
    runner = _runner(fleet, "port", sched)
    try:
        cold = _scan(fleet, "port", fleet["refs"], runner=runner)
        reg.reset_counters()
        warm = _scan(fleet, "port", fleet["refs"], runner=runner)
        snap = reg.snapshot()
        if sched == "off":
            assert runner.last_stats["secret"] == {}    # no sieve
    finally:
        runner.close()
    assert snap["blob_gets"] == 0, snap
    assert snap["manifest_gets"] == len(fleet["refs"])
    m = tstream.INGEST_METRICS.snapshot()
    assert m["layers_skipped"] >= fleet["layers"]
    assert m["config_memo_hits"] >= len(fleet["refs"])   # the twin: one more
    assert _norm(warm) == _norm(cold) == _reference(fleet, sched)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_probe_outage_degrades_to_a_full_pull(fleet, pkg, monkeypatch):
    """A probe that cannot answer (the keyer raises) is a normal pull,
    never an error, in both packages."""
    def bad_keyer(_self, scan_secrets=True):
        def keyer(_img):
            raise RuntimeError("blob-cache tier down")
        return keyer

    monkeypatch.setattr(PKGS[pkg]["Runner"], "blob_keyer", bad_keyer)
    fleet["reg"].reset_counters()
    got = _scan(fleet, pkg, fleet["refs"])
    m = PKGS[pkg]["stream"].INGEST_METRICS.snapshot()
    assert m["warm_probe_outages"] == len(fleet["refs"])
    assert m["layers_skipped"] == 0
    assert fleet["reg"].snapshot()["blob_gets"] > 0
    assert _norm(got) == _reference(fleet, "off")


def test_stream_image_equals_reference(fleet):
    """The streaming source's metadata (name, id, DiffIDs, tags,
    digests) and each layer's bytes equal the JAX package's and the
    pulled image's."""
    ref = fleet["refs"][GZIPPED]
    got = {}
    for pkg in ("ref", "port"):
        p = PKGS[pkg]
        for how in ("stream", "pull"):
            client = p["Client"]()
            src = p["stream"].stream_image(client, ref) if how == "stream" \
                else client.pull(ref)
            try:
                layers = []
                for la in src.layers:
                    with la.open() as tf:
                        layers.append(sorted(
                            (m.name, tf.extractfile(m).read())
                            for m in tf.getmembers() if m.isfile()))
                got[pkg, how] = (src.name, src.id, src.diff_ids,
                                 src.repo_tags, src.repo_digests, layers)
            finally:
                src.close()
                getattr(src, "cleanup", lambda: None)()
    first = got["ref", "stream"]
    assert all(v == first for v in got.values())
    assert first[3] == [ref]
    assert first[4][0].startswith(ref.rsplit(":", 1)[0] + "@sha256:")


def test_close_cancels_inflight_fetches(tmp_path):
    """``close()`` stops both running fetches at their next chunk: they
    count as cancelled, none lands, no spool is left, and a layer
    opened after the close is fetched again. The registry serves each
    blob in about two seconds, and the close comes only once both
    fetches are running."""
    blob = _layer_tar({"data.bin": bytes(range(256)) * (8 << 10)})
    path = _image_tar(str(tmp_path / "big.tar"), [blob, blob[:-512]])
    reg = LocalRegistry(throttle_bps=1 << 20).start()
    try:
        reg.add_image("big/img", "latest", path)
        src = tstream.stream_image(TClient(), reg.ref("big/img", "latest"))
        deadline = time.monotonic() + 30
        while not all(st.running for st in src._fetches):
            assert time.monotonic() < deadline, "the fetches never ran"
            time.sleep(0.005)
        src.close()
        assert not any(st.running for st in src._fetches)
        assert not os.path.exists(src._spool_dir)
        m = tstream.INGEST_METRICS.snapshot()
        assert m["cancelled_fetches"] == 2 and m["layers_fetched"] == 0
        assert all(isinstance(st.error, tstream.FetchCancelled)
                   for st in src._fetches)
        with src.layers[0].open() as tf:
            assert tf.getnames() == ["data.bin"]
        m = tstream.INGEST_METRICS.snapshot()
        assert m["layers_fetched"] == 1 and m["cancelled_fetches"] == 2
        src.close()
    finally:
        reg.stop()


# --- hostile input through the stream --------------------------------

def _causes(results) -> list:
    """Each slot's status and causes, the ``obs/trace`` cause's random
    trace id and dump path replaced."""
    return [(r.status, json.loads(_untraced([c.to_dict()
                                             for c in r.causes])))
            for r in results]


@pytest.mark.parametrize("sched", ["off", "on"])
def test_gzip_bomb_trips_at_the_same_threshold(tmp_path, sched):
    """A small gzipped layer that inflates 300-fold, behind a plain
    layer: both packages trip the ratio tripwire on the layer's own
    bytes at the same chunk, with the same message, and the plain
    image beside it scans."""
    plain = _layer_tar({"etc/os-release": b"ID=alpine\n" * 400})
    bomb = gzip.compress(_layer_tar({"zeros.bin": b"\0" * (8 << 20)}),
                         compresslevel=9, mtime=0)
    reg = LocalRegistry().start()
    try:
        reg.add_image("bomb/img", "1", _image_tar(
            str(tmp_path / "bomb.tar"), [plain, bomb]))
        reg.add_image("plain/img", "1", _image_tar(
            str(tmp_path / "plain.tar"), [plain]))
        refs = [reg.ref("bomb/img", "1"), reg.ref("plain/img", "1")]
        lim = dataclasses.replace(rguard.ResourceLimits(),
                                  max_compression_ratio=100.0,
                                  ratio_min_bytes=1 << 20)
        tlim = dataclasses.replace(tguard.ResourceLimits(),
                                   max_compression_ratio=100.0,
                                   ratio_min_bytes=1 << 20)
        got = {pkg: _causes(_scan(None, pkg, refs, sched, limits=lm))
               for pkg, lm in (("ref", lim), ("port", tlim))}
    finally:
        reg.stop()
    assert got["port"] == got["ref"]
    (status, causes), (ok, _) = got["port"]
    assert (status, ok) == ("failed", "ok")
    assert causes[0]["Stage"] == "ingest" and \
        "compression ratio tripwire" in causes[0]["Message"]


@pytest.mark.parametrize("sched", ["off", "on"])
def test_hostile_corpus_ends_as_in_reference(hostile_corpus, sched):
    """The JAX package's hostile corpus (bombs, floods, traversal,
    truncation, corrupt rpmdb, oversize configs) streamed through both
    packages: the same status and the same typed causes, ingest first."""
    corpus, limits = hostile_corpus(scale=0.05)
    limits = dataclasses.replace(limits, ingest_deadline_s=30.0)
    tlimits = tguard.ResourceLimits(**dataclasses.asdict(limits))
    reg = LocalRegistry()
    for name, path in corpus:
        reg.add_image(f"hostile/{name}", "latest", path)
    reg.start()
    try:
        refs = [reg.ref(f"hostile/{name}", "latest") for name, _ in corpus]
        got = {pkg: _scan(None, pkg, refs, sched, limits=lm)
               for pkg, lm in (("ref", limits), ("port", tlimits))}
    finally:
        reg.stop()
    for (name, _), r, t in zip(corpus, got["ref"], got["port"]):
        assert t.status == r.status, name
        assert [(c.stage, c.kind) for c in t.causes] == \
            [(c.stage, c.kind) for c in r.causes], name
        if t.causes:
            assert t.causes[0].stage == "ingest", name


def test_midstream_trip_cancels_the_rest_of_the_blob(tmp_path):
    big = _layer_tar({"data.bin": b"\0" * (16 << 20)})
    path = _image_tar(str(tmp_path / "big.tar"), [big])
    got = {}
    reg = LocalRegistry()
    reg.add_image("big/img", "latest", path)
    reg.start()
    try:
        for pkg in ("ref", "port"):
            g = PKGS[pkg]["guard"]
            limits = dataclasses.replace(g.ResourceLimits(),
                                         max_decompressed_bytes=256 << 10)
            reg.reset_counters()
            (res,) = _scan(None, pkg, [reg.ref("big/img", "latest")],
                           limits=limits)
            served = reg.snapshot()["bytes_served"]
            got[pkg] = _causes([res])
            assert PKGS[pkg]["stream"].INGEST_METRICS.snapshot()[
                "cancelled_fetches"] >= 1
            assert served < len(big) // 2, (pkg, served)
    finally:
        reg.stop()
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == "failed"


# --- per-layer budgets --------------------------------------------------

LIM = dict(max_decompressed_bytes=1000, max_files=10,
           ratio_min_bytes=1 << 30)


def _charges(pkg, parent, child, n, compressed=0):
    if pkg == "ref":
        child.charge_decompressed(n, compressed_total=compressed)
    else:
        child.charge_decompressed(n, compressed=compressed)


BUDGET_CASES = {
    "roll_up": lambda pkg, P, a, b: (
        _charges(pkg, P, a, 400), _charges(pkg, P, b, 300),
        a.charge_entries(3), b.charge_entries(4)),
    "aggregate_bytes_trip": lambda pkg, P, a, b: (
        _charges(pkg, P, a, 600), _charges(pkg, P, b, 600)),
    "layer_alone_trips": lambda pkg, P, a, b: _charges(pkg, P, a, 1200),
    "aggregate_entries_trip": lambda pkg, P, a, b: (
        a.charge_entries(6), b.charge_entries(6)),
    "ratio_stays_with_child": lambda pkg, P, a, b: _charges(
        pkg, P, a, 100, compressed=10),
    "soft_faults_to_parent": lambda pkg, P, a, b: a.note(
        "corrupt-rpmdb", "bad pages"),
}


@pytest.mark.parametrize("case", sorted(BUDGET_CASES))
def test_layer_budget_equals_reference(case):
    """``LayerBudget`` charges roll up to the per-target budget; a layer
    trips at a materialized scan's thresholds; the ratio tripwire trips
    on the child before the parent sees the bytes; soft faults go to
    the parent. The same charges give the same trips and counts."""
    out = {}
    for pkg, mod in (("ref", rbudget), ("port", tbudget)):
        lim = dict(LIM)
        if case == "ratio_stays_with_child":
            lim = dict(max_compression_ratio=2.0, ratio_min_bytes=16)
        parent = mod.ResourceBudget(mod.ResourceLimits(**lim))
        a = mod.LayerBudget(parent, "l0")
        b = mod.LayerBudget(parent, "l1")
        try:
            BUDGET_CASES[case](pkg, parent, a, b)
            err = None
        except mod.GuardError as e:
            err = (type(e).__name__, str(e))
        out[pkg] = (err, parent.stats(), parent.soft_faults, a.soft_faults)
    assert out["port"] == out["ref"]


# --- spans, the timeline, the counters' exposition -------------------

def test_fetch_and_decompress_spans_feed_the_timeline(fleet):
    """On the scheduled path each ref is opened inside its request's
    analyze span: fetched layers record ``fetch`` and ``decompress``
    spans there, in both packages, and the port's timeline attributes
    idle to ``fetch_serialized``. Which layers inspect opens depends on
    the order in which the scheduler's workers fill the cache (a shared
    layer that another image put first is not opened, and the port
    cancels its fetch at close), so the port's spans are held to its
    own counters: an ``ok`` fetch span and a decompress span for each
    fetched layer, an ``error`` one at most for each cancelled fetch."""
    spans = {}
    for pkg, Tracer in (("ref", RTracer), ("port", TTracer)):
        PKGS[pkg]["stream"].clear_config_memo()
        tracer = Tracer()
        _scan(fleet, pkg, fleet["refs"], "on", tracer=tracer)
        spans[pkg] = [s for _, t in tracer.recorder.traces() for s in t]
        if pkg == "port":
            tl = ttimeline.from_tracer(tracer)
            attr = tl.attribute()
    parents = {}
    for pkg, v in spans.items():
        by_id = {s.span_id: s.name for s in v}
        parents[pkg] = {(s.name, by_id.get(s.parent_id)) for s in v
                        if s.name in ("fetch", "decompress")}
    assert parents["port"] == parents["ref"] == {
        ("fetch", "analyze"), ("decompress", "analyze")}
    m = tstream.INGEST_METRICS.snapshot()
    port = [s for s in spans["port"] if s.name in ("fetch", "decompress")]
    assert all(s.end_mono is not None for s in port)
    ok = sorted((s.trace_id, s.attrs["layer"]) for s in port
                if s.name == "fetch" and s.status == "ok")
    cancelled = [s for s in port if s.name == "fetch" and s.status != "ok"]
    assert len(ok) == m["layers_fetched"] > 0
    assert len(cancelled) <= m["cancelled_fetches"]
    assert sorted((s.trace_id, s.attrs["layer"]) for s in port
                  if s.name == "decompress") == ok
    assert "fetch_serialized" in attr
    assert abs(tl.busy_s + sum(attr.values()) - tl.window_s) < 1e-6


FakeSpan = namedtuple("FakeSpan", "name start_mono end_mono attrs",
                      defaults=({},))


@pytest.mark.parametrize("seed", range(4))
def test_fetch_serialized_equals_reference(seed):
    """Seeded span soups with fetches beside and between device
    compute: the port's timeline gives the reference's attribution."""
    rng = np.random.default_rng(9100 + seed)
    spans = [FakeSpan("scan", 0.0, 60.0)]
    for _ in range(int(rng.integers(2, 8))):
        s = float(rng.uniform(0, 50))
        spans.append(FakeSpan("device_compute", s,
                              s + float(rng.uniform(0.5, 8))))
    for _ in range(int(rng.integers(2, 10))):
        s = float(rng.uniform(0, 55))
        spans.append(FakeSpan(str(rng.choice(["fetch", "decompress",
                                              "pack", "h2d_upload"])),
                              s, s + float(rng.uniform(0.2, 6))))
    want = rtimeline.Timeline(spans).attribute()
    got = ttimeline.Timeline(spans).attribute()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


def test_ingest_counters_render_as_in_reference():
    for m in (rstream.INGEST_METRICS, tstream.INGEST_METRICS):
        m.inc("layers_skipped", 5)
        m.inc("bytes_skipped", 1234)
        m.inc("range_resumes", 2)
    assert tstream.INGEST_METRICS.snapshot() == \
        rstream.INGEST_METRICS.snapshot()
    assert tprom({"ingest": tstream.INGEST_METRICS.snapshot()}) == \
        rprom({"ingest": rstream.INGEST_METRICS.snapshot()})


def test_remote_blob_cache_serves_the_warm_skip(fleet):
    """The warm-layer probe asks the runner's cache, a Redis one here:
    a new runner on the same Redis makes no blob GET and the reports
    are the streamed ones."""
    from trivy_tpu_torch.artifact.redis_cache import RedisCache
    from trivy_tpu_torch.artifact.resilient import ResilientCache
    stub = RedisStub()
    try:
        cold = _scan(fleet, "port", fleet["refs"],
                     cache=ResilientCache(RedisCache(stub.url)))
        fleet["reg"].reset_counters()
        warm = _scan(fleet, "port", fleet["refs"],
                     cache=ResilientCache(RedisCache(stub.url)))
    finally:
        stub.stop()
    assert fleet["reg"].snapshot()["blob_gets"] == 0
    assert _norm(cold) == _norm(warm) == _reference(fleet, "off")
