"""The hot swap on the port: ``db/delta.py``, ``detect/rematch.py``,
``FindingsMemo.hot_swap`` and ``db/compiled.py::SwappableStore`` against
the JAX package's on the same seeded generations.

The property of ``tests/test_memo_delta.py``, run on both packages at
1, 2 and 4 shards of a CPU mesh and with ``sched`` off and on: a memo
fleet, a hot swap to a mutated generation and a second memo fleet give
the reference's reports, a fresh no-memo scan's reports under the new
generation, and a re-match of exactly the delta-touched packages, as
many jobs as the reference re-matches. Beside it: equal delta stats,
a swap to an identical generation migrating every entry, the
journal fallback, a plain-store swap degrading as in the reference,
library (prefix-join) records, and the holder's own contract (readers
acquired and released exactly once on every runner path, nothing to
stage for a CPU generation, hooks that fail are logged)."""

import json
import threading
import time

import numpy as np
import pytest

from tests.test_memo_delta import N_PKGS, _fleet, _mutate, _random_store
from tests.test_torch_memo import port_store
from tests.torch_threads import one_torch_thread  # noqa: F401
from trivy_tpu.db import CompiledDB as RCDB
from trivy_tpu.db.compiled import SwappableStore as RSwap
from trivy_tpu.db.delta import advisory_delta as r_delta
from trivy_tpu.db.lifecycle import attach_memo as r_attach
from trivy_tpu.memo import FindingsMemo as RMemo
from trivy_tpu.memo.metrics import MEMO_METRICS as R_METRICS
from trivy_tpu.runtime import BatchScanRunner as RRunner
from trivy_tpu_torch import db as tdb
from trivy_tpu_torch.db import CompiledDB as TCDB
from trivy_tpu_torch.db.compiled import SwappableStore
from trivy_tpu_torch.db.delta import advisory_delta
from trivy_tpu_torch.db.lifecycle import attach_memo
from trivy_tpu_torch.memo import FindingsMemo, MemoryMemoStore
from trivy_tpu_torch.memo.metrics import MEMO_METRICS
from trivy_tpu_torch.runtime import BatchScanRunner

CPU = "cpu"


def _norm(results):
    out = []
    for r in results:
        if r.error:
            out.append((r.name, "error", r.error))
        else:
            out.append((r.name, r.status,
                        json.dumps(r.report.to_dict(), sort_keys=True)))
    return out


def _generations(seed: int) -> tuple:
    """(reference gen1, gen2, port gen1, gen2, touched pkg names)."""
    rng = np.random.default_rng(seed)
    s1 = _random_store(rng)
    s2, touched = _mutate(rng, s1)
    return (RCDB.compile(s1), RCDB.compile(s2),
            TCDB.compile(port_store(s1)), TCDB.compile(port_store(s2)),
            touched, s1, s2)


def _tmesh(n: int):
    from trivy_tpu_torch.parallel import make_mesh
    return make_mesh(devices=[CPU] * n) if n > 1 else None


def _rmesh(n: int):
    from trivy_tpu.parallel.mesh import make_mesh
    return make_mesh(n) if n > 1 else None


def _swap_run(Runner, Memo, Swap, attach, metrics, gen1, gen2, paths,
              backend, mesh, sched) -> dict:
    """Memo fleet on gen1, hot swap to gen2, memo fleet on gen2."""
    memo = Memo(MemoryMemoStore() if Memo is FindingsMemo else None,
                backend=backend)
    memo.mesh = mesh
    r1 = Runner(store=gen1, backend=backend, mesh=mesh, memo=memo,
                sched=sched)
    r1.scan_paths(paths)
    r1.close()
    sw = Swap(gen1)
    attach(sw, memo)
    before = metrics.snapshot()
    sw.swap(gen2)
    after = metrics.snapshot()
    r2 = Runner(store=sw, backend=backend, mesh=mesh, memo=memo,
                sched=sched)
    warm = r2.scan_paths(paths)
    r2.close()
    post = metrics.snapshot()
    cold_runner = Runner(store=gen2, backend=backend, mesh=mesh,
                         sched=sched)
    cold = cold_runner.scan_paths(paths)
    cold_runner.close()
    return {"warm": _norm(warm), "cold": _norm(cold),
            "counts": {k: after[k] - before[k] for k in (
                "rematch_jobs", "rematch_entries", "migrated_entries",
                "delta_touched", "delta_rematched",
                "delta_invalidated")},
            "post_misses": post["misses"] - after["misses"],
            "post_hits": post["hits"] - after["hits"],
            "readers": getattr(sw, "_readers", 0)}


@pytest.mark.parametrize("sched", ["off", "on"])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_delta_rematch_equals_reference(tmp_path, sched, ndev):
    seed = 77 + 13 * ndev + (1 if sched == "on" else 0)
    rg1, rg2, tg1, tg2, _, _, _ = _generations(seed)
    paths = _fleet(tmp_path, np.random.default_rng(seed))
    ref = _swap_run(RRunner, RMemo, RSwap, r_attach, R_METRICS, rg1,
                    rg2, paths, "tpu", _rmesh(ndev), sched)
    port = _swap_run(BatchScanRunner, FindingsMemo, SwappableStore,
                     attach_memo, MEMO_METRICS, tg1, tg2, paths, "cpu",
                     _tmesh(ndev), sched)
    assert port["warm"] == ref["warm"] == ref["cold"] == port["cold"]
    assert port["counts"] == ref["counts"]
    assert port["post_misses"] == 0 and port["post_hits"] > 0
    assert port["readers"] == 0
    cold_jobs = sum(len(tg2.candidate_rows("alpine 3.16", f"pkg{i}"))
                    for i in range(N_PKGS))
    assert 0 < port["counts"]["rematch_jobs"] < cold_jobs


def test_rematch_covers_exactly_the_touched_packages(tmp_path):
    """The re-matched records are the memoized queries whose package
    the delta touched, and only those."""
    _, _, tg1, tg2, touched, _, _ = _generations(5)
    paths = _fleet(tmp_path, None)
    memo = FindingsMemo(MemoryMemoStore(), backend="cpu")
    BatchScanRunner(store=tg1, backend="cpu", memo=memo).scan_paths(paths)
    # one memo entry (the shared apk layer), one query per installed
    # package with a candidate row under the old generation
    with_rows = {f"pkg{i}" for i in range(N_PKGS)
                 if tg1.candidate_rows("alpine 3.16", f"pkg{i}")}
    out = memo.hot_swap(tg1, tg2)
    assert out["rematch_entries"] == 1 and out["migrated"] == 0
    assert out["invalidated_subs"] + out["dropped_subs"] == \
        len(touched & with_rows) > 0
    assert out["rematch_jobs"] == sum(
        len(tg2.candidate_rows("alpine 3.16", p))
        for p in (touched & with_rows))
    assert set(out["split_s"]) == {"delta", "rematch", "store"}
    assert out["dispatch"]["jobs_in"] == out["rematch_jobs"]


def test_delta_stats_equal_reference():
    for seed in (5, 9, 21, 33):
        rg1, rg2, tg1, tg2, touched, _, _ = _generations(seed)
        rd, td = r_delta(rg1, rg2), advisory_delta(tg1, tg2)
        assert td.stats() == rd.stats()
        assert td.touched == rd.touched
        assert {p for _, p in td.touched} == touched
        for kind, bucket, name in (("os", "alpine 3.16", "pkg1"),
                                   ("lib", "alpine", "pkg2"),
                                   ("lib", "npm::", "pkg3")):
            assert td.touches(kind, bucket, name) == \
                rd.touches(kind, bucket, name)
        assert not advisory_delta(tg1, tg1).touched


def test_swap_to_identical_generation_migrates_everything(tmp_path):
    rng = np.random.default_rng(9)
    s1 = port_store(_random_store(rng))
    cdb1, cdb1b = TCDB.compile(s1), TCDB.compile(s1)
    paths = _fleet(tmp_path, rng)
    memo = FindingsMemo(MemoryMemoStore(), backend="cpu-ref")
    BatchScanRunner(store=cdb1, backend="cpu-ref",
                    memo=memo).scan_paths(paths)
    entries = len(memo.store.keys())
    before = MEMO_METRICS.snapshot()
    sw = SwappableStore(cdb1)
    attach_memo(sw, memo)
    sw.swap(cdb1b)
    after = MEMO_METRICS.snapshot()
    assert after["rematch_jobs"] == before["rematch_jobs"]
    assert after["migrated_entries"] - before["migrated_entries"] == \
        entries
    warm = BatchScanRunner(store=cdb1b, backend="cpu-ref",
                           memo=memo).scan_paths(paths)
    post = MEMO_METRICS.snapshot()
    assert post["misses"] == after["misses"]
    assert all(r.status == "ok" for r in warm)


def test_hot_swap_journal_fallback(tmp_path):
    class NoKeys(MemoryMemoStore):
        def keys(self):
            return None

    _, _, tg1, tg2, _, _, _ = _generations(21)
    paths = _fleet(tmp_path, None)
    memo = FindingsMemo(NoKeys(), backend="cpu-ref")
    BatchScanRunner(store=tg1, backend="cpu-ref",
                    memo=memo).scan_paths(paths)
    out = memo.hot_swap(tg1, tg2)
    assert out["rematch_entries"] + out["migrated"] > 0
    warm = BatchScanRunner(store=tg2, backend="cpu-ref",
                           memo=memo).scan_paths(paths)
    cold = BatchScanRunner(store=tg2,
                           backend="cpu-ref").scan_paths(paths)
    assert _norm(cold) == _norm(warm)


def test_failed_migration_is_counted_and_recomputed(tmp_path,
                                                    monkeypatch):
    """A re-match dispatch that raises does not break the swap: the
    failure is counted (``swap_failures``, in the stats and in
    ``MEMO_METRICS``), and the next scan recomputes the verdicts the
    migration could not carry over, to a fresh no-memo scan's reports."""
    import trivy_tpu_torch.detect.batch as detect_batch
    _, _, tg1, tg2, _, _, _ = _generations(5)
    paths = _fleet(tmp_path, None)
    memo = FindingsMemo(MemoryMemoStore(), backend="cpu")
    BatchScanRunner(store=tg1, backend="cpu", memo=memo).scan_paths(paths)

    def down(*args, **kwargs):
        raise RuntimeError("device lost")
    monkeypatch.setattr(detect_batch, "dispatch_jobs", down)
    before = MEMO_METRICS.snapshot()
    out = memo.hot_swap(tg1, tg2)
    monkeypatch.undo()
    assert out["swap_failures"] == 1 and "device lost" in out["error"]
    assert MEMO_METRICS.snapshot()["swap_failures"] == \
        before["swap_failures"] + 1
    warm = BatchScanRunner(store=tg2, backend="cpu",
                           memo=memo).scan_paths(paths)
    assert MEMO_METRICS.snapshot()["misses"] > before["misses"]
    cold = BatchScanRunner(store=tg2, backend="cpu").scan_paths(paths)
    assert _norm(cold) == _norm(warm)
    ok = FindingsMemo(MemoryMemoStore(), backend="cpu")
    BatchScanRunner(store=tg1, backend="cpu", memo=ok).scan_paths(paths)
    assert ok.hot_swap(tg1, tg2)["swap_failures"] == 0


def test_plain_store_swap_degrades_as_in_reference(tmp_path):
    """Between plain stores there is no generation to compare: no
    delta, no re-match, no error, and scans against the new store
    recompute — in both packages, with the same reports."""
    _, _, _, _, _, rs1, rs2 = _generations(33)
    ts1, ts2 = port_store(rs1), port_store(rs2)
    paths = _fleet(tmp_path, None)
    outs = {}
    for key, Runner, Memo, s1, s2, backend in (
            ("ref", RRunner, RMemo, rs1, rs2, "cpu-ref"),
            ("port", BatchScanRunner, FindingsMemo, ts1, ts2, "cpu-ref")):
        memo = Memo(backend=backend)
        Runner(store=s1, backend=backend, memo=memo).scan_paths(paths)
        out = memo.hot_swap(s1, s2)
        warm = Runner(store=s2, backend=backend,
                      memo=memo).scan_paths(paths)
        cold = Runner(store=s2, backend=backend).scan_paths(paths)
        assert _norm(cold) == _norm(warm)
        outs[key] = (out, _norm(warm))
    assert outs["port"] == outs["ref"]
    assert outs["port"][0]["rematch_jobs"] == 0


def test_sbom_lib_delta_rematch():
    """Library-ecosystem (prefix-join) records re-match too."""
    def mk(fix_lodash: str):
        st = tdb.AdvisoryStore()
        st.put_advisory("npm::Node.js", "lodash", "CVE-2021-1",
                        {"VulnerableVersions": [f"<{fix_lodash}"],
                         "PatchedVersions": [f">={fix_lodash}"]})
        st.put_advisory("npm::Node.js", "left-pad", "CVE-2021-2",
                        {"VulnerableVersions": ["<2.0.0"],
                         "PatchedVersions": [">=2.0.0"]})
        for vid in ("CVE-2021-1", "CVE-2021-2"):
            st.put_vulnerability(vid, {"Severity": "HIGH"})
        return st

    cdb1, cdb2 = TCDB.compile(mk("4.17.21")), TCDB.compile(mk("4.17.10"))
    doc = json.dumps({
        "bomFormat": "CycloneDX", "specVersion": "1.4", "version": 1,
        "components": [
            {"bom-ref": "a", "type": "library", "name": "lodash",
             "version": "4.17.20", "purl": "pkg:npm/lodash@4.17.20"},
            {"bom-ref": "b", "type": "library", "name": "left-pad",
             "version": "1.3.0", "purl": "pkg:npm/left-pad@1.3.0"}],
    }).encode()
    boms = [("app.cdx.json", doc)]
    memo = FindingsMemo(MemoryMemoStore(), backend="cpu")
    gen1 = BatchScanRunner(store=cdb1, backend="cpu",
                           memo=memo).scan_boms(boms)
    assert "CVE-2021-1" in _norm(gen1)[0][2]
    before = MEMO_METRICS.snapshot()
    out = memo.hot_swap(cdb1, cdb2)
    assert out["rematch_jobs"] >= 1
    warm = BatchScanRunner(store=cdb2, backend="cpu",
                           memo=memo).scan_boms(boms)
    assert MEMO_METRICS.snapshot()["misses"] == before["misses"]
    cold = BatchScanRunner(store=cdb2, backend="cpu").scan_boms(boms)
    assert _norm(cold) == _norm(warm)
    assert "CVE-2021-1" not in _norm(warm)[0][2]


# ------------------------------------------------- the holder's contract

class CountingStore(SwappableStore):
    def __init__(self, db):
        super().__init__(db)
        self.acquired = self.released = 0

    def acquire(self):
        self.acquired += 1
        return super().acquire()

    def release(self):
        self.released += 1
        super().release()


@pytest.mark.parametrize("sched", ["off", "on"])
def test_runner_releases_the_holder_exactly_once(tmp_path, sched):
    """Every scan of a runner over a ``SwappableStore``, a failed slot
    included, acquires the holder once and releases it once, on the
    image and the BOM paths."""
    _, _, tg1, _, _, _, _ = _generations(41)
    paths = _fleet(tmp_path, None)
    broken = tmp_path / "broken.tar"
    broken.write_bytes(open(paths[0], "rb").read()[:700])
    sw = CountingStore(tg1)
    runner = BatchScanRunner(store=sw, backend="cpu", sched=sched,
                             memo=FindingsMemo(backend="cpu"))
    try:
        res = runner.scan_paths(paths + [str(broken)])
        assert [r.status for r in res] == ["ok"] * len(paths) + ["failed"]
        boms = [("bad", b"{}"), ("ok", json.dumps({
            "bomFormat": "CycloneDX", "specVersion": "1.4",
            "version": 1, "components": []}).encode())]
        runner.scan_boms(boms)
    finally:
        runner.close()
    assert sw.acquired == sw.released > 0
    assert sw._readers == 0
    want = 1 if sched == "off" else len(paths) + 1
    assert sw.acquired >= want


def test_swap_waits_for_readers_and_runs_hooks_after():
    _, _, tg1, tg2, _, _, _ = _generations(3)
    sw = SwappableStore(tg1)
    seen = []
    sw.add_swap_hook(lambda old, new: seen.append((old, new)))

    def broken(old, new):
        raise RuntimeError("observer down")
    sw.add_swap_hook(broken)
    assert sw.acquire() is tg1
    t = threading.Thread(target=sw.swap, args=(tg2,))
    t.start()
    time.sleep(0.2)
    assert sw.current() is tg1 and not seen      # waits for the reader
    sw.release()
    t.join(5)
    assert not t.is_alive()
    assert sw.current() is tg2 and seen == [(tg1, tg2)]
    sw.remove_swap_hook(broken)
    sw.remove_swap_hook(broken)                  # twice: no error
    sw.swap(tg2)                                 # the same generation:
    assert seen == [(tg1, tg2)]                  # no hook


def test_cpu_generation_has_nothing_to_stage():
    """A generation whose predecessor lives on the CPU is not staged;
    the outgoing one's copies are dropped."""
    _, _, tg1, tg2, _, _, _ = _generations(3)
    tg1.device_tables("cpu")
    up1 = tg1.device_stats()
    sw = SwappableStore(tg1)
    sw.swap(tg2)
    assert tg2.device_stats()["uploads"] == 0
    assert tg1.device_stats()["invalidations"] == up1["invalidations"] + 1
    assert not tg1._device


def test_factory_passes_the_scan_backend(tmp_path):
    """The CLI's memo re-matches on the scan's backend: ``cuda`` by
    default, ``cpu`` or ``cpu-ref`` when asked."""
    import argparse

    from trivy_tpu_torch.cli import _memo
    from trivy_tpu_torch.memo import make_findings_memo
    assert make_findings_memo().backend == "cuda"
    assert FindingsMemo().backend == "cuda"
    for backend in ("cuda", "cpu", "cpu-ref"):
        args = argparse.Namespace(no_memo=False, security_checks="vuln",
                                  cache_dir="", memo_cache="memory",
                                  backend=backend)
        assert _memo(args, None).backend == backend


@pytest.mark.parametrize("memo_cache,cache_dir,scheduled,want", [
    ("", "", False, None),
    ("", "", True, "MemoryMemoStore"),
    ("memory", "", False, "MemoryMemoStore"),
    ("dir", "", False, "FSMemoStore"),
    ("", "blobs", False, "FSMemoStore"),
])
def test_cli_memo_only_where_an_entry_can_be_read_again(
        tmp_path, memo_cache, cache_dir, scheduled, want):
    """The CLI keeps a memo where one of its entries can be read again:
    on disk (``--cache-dir``, a ``--memo-cache`` directory), in memory
    when asked by name, or for a scheduled scan of several targets. A
    single target's memo in memory would die unread: none is built."""
    import argparse

    from trivy_tpu_torch.cli import _memo, make_cache
    if memo_cache == "dir":
        memo_cache = str(tmp_path / "memo")
    if cache_dir:
        cache_dir = str(tmp_path / cache_dir)
    args = argparse.Namespace(no_memo=False, security_checks="vuln",
                              cache_dir=cache_dir, memo_cache=memo_cache,
                              backend="cpu")
    memo = _memo(args, make_cache(cache_dir), None, scheduled)
    got = memo and type(memo.store.primary).__name__
    assert got == want
    args.no_memo = True
    assert _memo(args, make_cache(cache_dir), None, scheduled) is None
