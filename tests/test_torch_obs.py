"""The observability seams of ``trivy_tpu_torch`` against the JAX
package's (``trivy_tpu``, JAX on the CPU), on the same seeded inputs:

* span-tree parity — the same scan under both packages records the
  same multiset of (span name, parent span name, attribute keys, event
  names), ids and times aside: ``image`` (one target), ``fs`` and
  ``sbom`` through both CLIs under an active root span; the direct
  fleet at dispatch depth 1, 2 and 4 (and with a findings memo); the
  scheduled fleet; the direct fleet over a 1-, 2- and 4-shard CPU
  mesh;
* ``SECRET_METRICS`` after the same scans, but for the timers;
* ``resident_snapshot()``: the same (table, placement) rows;
* ``SchedMetrics.snapshot()``: the reference's ``secret`` and
  ``resident`` sections.

Departures, each by name:

* ``slot_wait`` spans are left out of the multiset: a ring parks only
  when its drain runs behind, so their number is a matter of timing in
  both packages; where one is recorded its parent and keys are held.
* ``deps_wait`` events (a report that waits for an earlier batch's
  blob patch) are left out for the same reason.
* ``SECRET_METRICS["dfa_upload_bytes"]`` differs: the port's DFA table
  keeps its band arrays as int64 for the plain PyTorch version; the
  number of uploads is equal.
* A device's copy of a table serves every placement that reaches it
  (``ops/resident.py``): a table asked for on a device and then on a
  mesh of that device uploads once in the port and twice in the
  reference. The metrics case drops the copies between its two fleets,
  as a hot swap does, so both upload once per fleet.

The port runs ``--backend cpu`` (torch on the CPU), the reference its
jax path on the CPU (``tpu``/``cpu``). On a card the port's busy spans
are stamped by CUDA events and the fused sieve's fetch is a
``decode(mode="fetch")`` span (``tests/test_torch_cuda.py``).
"""

import contextlib
import io
import json
import os
from collections import Counter

import pytest
import yaml

import trivy_tpu.analyzer as ranalyzer
import trivy_tpu.db as rdb
import trivy_tpu.db.compiled as rcompiled
import trivy_tpu.detect.batch as rbatch
import trivy_tpu_torch.analyzer as tanalyzer
import trivy_tpu_torch.db as tdb
import trivy_tpu_torch.detect.batch as tbatch
import trivy_tpu_torch.ops.resident as tresident
from chip_smoke import (FS_ROOTS, SBOM_IMAGES, fleet_targets,
                        make_advisory_store, make_bom, make_corpus,
                        make_fs_tree)
from tests.test_torch_scan_local import _fast_yaml
from tests.torch_threads import one_torch_thread  # noqa: F401
from trivy_tpu.cli import main as rmain
from trivy_tpu.obs import Tracer as RTracer
from trivy_tpu.runtime import BatchScanRunner as RRunner
from trivy_tpu.sched import SchedConfig as RCfg
from trivy_tpu.secret.metrics import SECRET_METRICS as RSM
from trivy_tpu_torch.cli import main as tmain
from trivy_tpu_torch.obs import Tracer as TTracer
from trivy_tpu_torch.runtime import BatchScanRunner as TRunner
from trivy_tpu_torch.sched import SchedConfig as TCfg
from trivy_tpu_torch.secret.metrics import SECRET_METRICS as TSM

STORE_ROWS = 3000
SEED = 20261017
N_IMAGES = 4
WAVE_ROWS = 64          # several interval waves per fleet
TIMING = frozenset({"slot_wait"})        # span names
TIMING_EVENTS = frozenset({"deps_wait"})


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    rstore, n_pkgs = make_advisory_store(STORE_ROWS, SEED,
                                         store=rdb.AdvisoryStore())
    tstore, _ = make_advisory_store(STORE_ROWS, SEED)
    corpus, _ = make_corpus(24, 5)
    os.makedirs(d / "fleet")
    plan = fleet_targets(str(d / "fleet"), FS_ROOTS["fs"], n_pkgs, 3,
                         corpus, n_images=N_IMAGES, scale=0.04)
    rcdb = rdb.CompiledDB.compile(rstore)
    rcdb.save(str(d / "compiled"))
    tree = d / "tree"
    make_fs_tree(str(tree), FS_ROOTS["fs"], n_pkgs, 4, 0.03,
                 files=corpus[:8])
    bom = d / "bom.cdx.json"
    bom.write_text(json.dumps(make_bom(SBOM_IMAGES["A"], n_pkgs, 6,
                                       scale=0.02)))
    return {"plan": plan, "compiled": str(d / "compiled"),
            "tree": str(tree), "bom": str(bom),
            "stores": (rcdb, tdb.CompiledDB.compile(tstore))}


def _drop_device_copies() -> None:
    for reg in (rcompiled._RESIDENT_REGISTRY,
                tresident._RESIDENT_REGISTRY):
        for t in list(reg):
            t.invalidate_device()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Every case starts with no table on any device (so both packages
    record their first upload) and zeroed sieve counters; both CLIs'
    registered secret analyzers are reset after it."""
    _drop_device_copies()
    RSM.reset()
    TSM.reset()
    # the port reads _WAVE_ROWS at the call; the reference binds it as
    # dispatch_jobs_async's default
    fn = rbatch.dispatch_jobs_async
    monkeypatch.setattr(fn, "__defaults__",
                        fn.__defaults__[:-1] + (WAVE_ROWS,))
    monkeypatch.setattr(tbatch, "_WAVE_ROWS", WAVE_ROWS)
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    yield
    for pkg in (ranalyzer, tanalyzer):
        for a in pkg.registered_analyzers():
            if a.type == "secret":
                a.config_path = ""


def _spans(tracer) -> list:
    return [s for _, trace in tracer.recorder.traces() for s in trace]


def _tree(spans) -> tuple:
    """(multiset of (name, parent name, attribute keys, event names),
    the timing-dependent spans as a set of the same tuples)."""
    by_id = {s.span_id: s for s in spans}
    shape, timing = Counter(), set()
    for s in spans:
        parent = by_id.get(s.parent_id)
        key = (s.name, parent.name if parent is not None else None,
               tuple(sorted(s.attrs)),
               tuple(sorted(name for _, name, _ in s.events
                            if name not in TIMING_EVENTS)))
        if s.name in TIMING:
            timing.add(key)
        else:
            shape[key] += 1
    return shape, timing


def _assert_same_tree(tspans, rspans) -> None:
    tshape, ttiming = _tree(tspans)
    rshape, rtiming = _tree(rspans)
    assert tshape == rshape, (
        f"port only: {tshape - rshape}\nreference only: {rshape - tshape}")
    # a slot wait, where either package parked, has one shape
    assert len(ttiming | rtiming) <= 1, (ttiming, rtiming)


def _cli(main, argv: list) -> int:
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return main(argv)


def _traced_cli(tracer, main, argv: list) -> list:
    """``main(argv)`` under an active root span of ``tracer``; its
    spans."""
    root = tracer.start_request("cli")
    with root.activate():
        code = _cli(main, argv)
    root.end()
    assert code == 0
    return tracer.recorder.get(root.trace_id)


def _entry_argv(inputs, entry: str, tmp_path) -> list:
    target = {"image": ["--input", inputs["plan"]["paths"][0]],
              "fs": [inputs["tree"]], "sbom": [inputs["bom"]]}[entry]
    return [entry] + target + ["--compiled-db", inputs["compiled"],
                               "--format", "json", "--no-memo",
                               "--no-cache", "--output",
                               str(tmp_path / "out.json")]


@pytest.mark.parametrize("entry", ["image", "fs", "sbom"])
def test_entry_span_tree_equals_reference(inputs, entry, tmp_path,
                                          monkeypatch):
    """One ``image`` target, an ``fs`` tree and an ``sbom`` through
    both CLIs under a root span: the sieve's pack / h2d_upload /
    dfa_scan / decode / verify, the join, the layer walks and their
    events, the interval match's pack / db_upload / h2d_upload /
    device_compute, and the DFA table's dfa_upload."""
    monkeypatch.chdir(tmp_path)
    argv = _entry_argv(inputs, entry, tmp_path)
    rspans = _traced_cli(RTracer(), rmain, argv + ["--backend", "cpu"])
    tspans = _traced_cli(TTracer(), tmain, argv + ["--backend", "cpu"])
    _assert_same_tree(tspans, rspans)
    names = {s.name for s in tspans}
    assert {"join", "pack", "device_compute", "db_upload"} <= names
    if entry != "sbom":
        assert {"dfa_scan", "decode", "verify", "dfa_upload",
                "h2d_upload"} <= names


def _fleet(inputs, sched, depth: int, mesh_n: int = 0, memo=False):
    """The reference's and the port's traced runs of the fleet: (port
    spans, reference spans, port runner, reference runner)."""
    from trivy_tpu.memo import FindingsMemo as RMemo
    from trivy_tpu.parallel import make_mesh as rmake
    from trivy_tpu_torch.memo import FindingsMemo as TMemo
    from trivy_tpu_torch.parallel import make_mesh as tmake
    import torch
    rcdb, tcdb = inputs["stores"]
    rt, tt = RTracer(), TTracer()
    rmesh = rmake(mesh_n) if mesh_n else None
    tmesh = tmake(devices=[torch.device("cpu")] * mesh_n) \
        if mesh_n else None
    rs = "off" if sched == "off" else RCfg(
        max_batch_items=1, flush_timeout_s=0.01, workers=1,
        dispatch_depth=depth)
    ts = "off" if sched == "off" else TCfg(
        max_batch_items=1, flush_timeout_s=0.01, workers=1,
        dispatch_depth=depth)
    rr = RRunner(store=rcdb, backend="tpu", sched=rs, mesh=rmesh,
                 dispatch_depth=depth, tracer=rt,
                 memo=RMemo(backend="cpu-ref") if memo else None)
    tr = TRunner(store=tcdb, backend="cpu", sched=ts, mesh=tmesh,
                 dispatch_depth=depth, tracer=tt,
                 memo=TMemo(backend="cpu") if memo else None)
    paths = inputs["plan"]["paths"]
    try:
        for _ in range(2 if memo else 1):
            want = [r.status for r in rr.scan_paths(paths)]
            got = [r.status for r in tr.scan_paths(paths)]
            assert got == want
    finally:
        rr.close()
        tr.close()
    return _spans(tt), _spans(rt), tr, rr


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_direct_fleet_span_tree_equals_reference(inputs, depth):
    """``--sched off`` at each dispatch depth: per image analyze (with
    the layer walks) → device (shared) → report, and the batch's
    phases under the first device span from every thread that does
    them — the sieve on the host pool, the waves' packs on the pool,
    their busy spans, the collect."""
    tspans, rspans, tr, _ = _fleet(inputs, "off", depth)
    _assert_same_tree(tspans, rspans)
    waves = tr.last_stats["interval_waves"]
    assert waves > 1
    busy = [s for s in tspans if s.name == "device_compute"]
    assert len(busy) == waves
    assert all(s.end_mono >= s.start_mono for s in busy)


def test_direct_fleet_with_memo_span_tree_equals_reference(inputs):
    """A findings memo in both runners, the fleet twice: the memo's
    lookups and stores, then a second run served from it."""
    tspans, rspans, _, _ = _fleet(inputs, "off", 2, memo=True)
    _assert_same_tree(tspans, rspans)
    assert {"memo_lookup", "memo_store"} <= {s.name for s in tspans}


def test_scheduled_fleet_span_tree_equals_reference(inputs):
    """The scheduler, one host worker and one request per batch (so
    the layer walks, the number of batches and the phases each records
    are fixed): queue_wait → analyze →
    coalesce → device → report, with the deep phases under each
    batch's device span on the device and drain threads."""
    tspans, rspans, _, _ = _fleet(inputs, "on", 2)
    _assert_same_tree(tspans, rspans)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_fleet_span_tree_equals_reference(inputs, n):
    """The direct fleet over an n-shard CPU mesh (the reference's n
    virtual devices): the sharded sieve's pack (with ``shards``) and
    its dfa_scan(fetch) at the join under decode(mode=sharded); the
    waves with no h2d_upload; the tables' uploads for the mesh."""
    tspans, rspans, _, _ = _fleet(inputs, "off", 2, mesh_n=n)
    _assert_same_tree(tspans, rspans)
    dfa = [s for s in tspans if s.name == "dfa_scan"]
    assert dfa and all(s.attrs.get("fetch") for s in dfa)


def _our_rows(rows: list, gens: set) -> set:
    return {(r["table"], r["placement"]) for r in rows
            if r["generation"] in gens}


def test_secret_metrics_and_resident_rows_equal_reference(inputs):
    """The direct fleet, then (its device copies dropped, as a hot swap
    does) the same fleet over a 2-shard mesh: ``resident_snapshot()``
    has the same (table, placement) rows for the fleet's tables after
    each, and ``SECRET_METRICS`` is equal but for its timers (and the
    upload bytes, above)."""
    from trivy_tpu.db.compiled import resident_snapshot as rsnap
    from trivy_tpu_torch.db.compiled import resident_snapshot as tsnap
    rcdb, tcdb = inputs["stores"]
    for mesh_n, placement in ((0, "default"), (2, "mesh")):
        _drop_device_copies()
        _, _, tr, rr = _fleet(inputs, "off", 2, mesh_n=mesh_n)
        rgens = {rcdb.generation, rr.secret_scanner.table.generation}
        tgens = {tcdb.generation, tr.secret_scanner.table.generation}
        trows = _our_rows(tsnap(), tgens)
        assert trows == _our_rows(rsnap(), rgens) == {
            ("advisory_db", placement), ("dfa", placement)}
        for r in tsnap():
            if r["generation"] == tcdb.generation:
                assert r["bytes"] == \
                    tcdb.device_stats()["staged_bytes"] > 0
    skip = {"sieve_s", "verify_s", "dfa_upload_bytes"}
    want = {k: v for k, v in RSM.snapshot().items() if k not in skip}
    got = {k: v for k, v in TSM.snapshot().items() if k not in skip}
    assert got == want
    assert got["dfa_uploads"] == 2 and got["shards_dispatched"] >= 1
    assert got["decode_tasks"] >= 1 and got["files_total"] > 0


def test_resident_rows_drop_on_invalidation(inputs):
    """``invalidate_device`` (a hot swap) removes a table's rows."""
    from trivy_tpu_torch.db.compiled import resident_snapshot
    _, tcdb = inputs["stores"]
    tcdb.device_tables("cpu")
    assert ("advisory_db", "default") in _our_rows(
        resident_snapshot(), {tcdb.generation})
    tcdb.invalidate_device()
    assert not _our_rows(resident_snapshot(), {tcdb.generation})


def test_prewarm_stages_every_live_table(inputs):
    """``prewarm_resident`` stages each live table on the device it is
    given, once (a second call uploads nothing)."""
    from trivy_tpu_torch.db.compiled import prewarm_resident
    _, tcdb = inputs["stores"]
    up = tcdb.device_stats()["uploads"]
    rows = prewarm_resident("cpu")
    assert {"table": "advisory_db", "generation": tcdb.generation,
            "staged": True} in rows
    assert tcdb.device_stats()["uploads"] == up + 1
    prewarm_resident("cpu")
    assert tcdb.device_stats()["uploads"] == up + 1


def test_sched_snapshot_has_reference_sections():
    """``SchedMetrics.snapshot()`` carries the reference's ``secret``,
    ``resident`` and ``watch`` sections, with its keys."""
    from trivy_tpu.sched.metrics import SchedMetrics as RM
    from trivy_tpu_torch.sched.metrics import SchedMetrics as TM
    want, got = RM().snapshot(), TM().snapshot()
    assert set(got["secret"]) == set(want["secret"])
    assert isinstance(got["resident"], list)
    row_keys = {"table", "placement", "bytes", "generation"}
    assert all(set(r) == row_keys for r in got["resident"])
    assert all(set(r) == row_keys for r in want["resident"])
    assert set(want) == set(got)
    assert set(got["watch"]) == set(want["watch"])


def test_a_failed_wait_ends_the_busy_span_as_an_error(monkeypatch):
    """A collect whose wait raises ends the wave's ``device_compute``
    span with status "error", so its trace finishes instead of
    holding an open span."""
    import numpy as np
    import trivy_tpu_torch.parallel.interval_shard as ishard
    from trivy_tpu_torch.obs.busy import open_busy
    from trivy_tpu_torch.parallel.mesh import local_mesh
    tracer = TTracer()
    root = tracer.start_request("r")
    with root.activate():
        busy = open_busy("device_compute", kind="interval", rows=4)
    rows = np.arange(4, dtype=np.int32).reshape(4, 1)
    handle = ishard._launch(local_mesh("cpu"), (rows,),
                            lambda k: (lambda t: t > 1), busy=busy)

    def lost(launched):
        raise RuntimeError("device lost")

    monkeypatch.setattr(ishard, "wait_all", lost)
    with pytest.raises(RuntimeError, match="device lost"):
        handle.collect()
    root.end()
    spans = tracer.recorder.get(root.trace_id)
    [dc] = [s for s in spans if s.name == "device_compute"]
    assert dc.status == "error" and dc.end_mono is not None


def test_a_failed_dispatch_ends_the_fleets_spans(inputs, monkeypatch):
    """The direct fleet's interval launch raises: every image's shared
    ``device`` span and its root end with status "error" (as many
    traces finish as in a run that does not fail), and the error
    reaches the caller."""
    import trivy_tpu_torch.runtime.batch as trbatch

    def traces(tracer) -> list:
        runner = TRunner(store=inputs["stores"][1], backend="cpu",
                         sched="off", tracer=tracer)
        try:
            runner.scan_paths(inputs["plan"]["paths"])
        finally:
            runner.close()
        return tracer.recorder.traces()

    clean = traces(TTracer())

    def boom(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(trbatch, "dispatch_jobs_async", boom)
    tracer = TTracer()
    with pytest.raises(RuntimeError, match="launch failed"):
        traces(tracer)
    failed = tracer.recorder.traces()
    assert len(failed) == len(clean) > 1
    for _, spans in failed:
        by_name = {s.name: s for s in spans}
        assert by_name["device"].status == "error"
        assert [s.status for s in spans if s.is_root] == ["error"]
