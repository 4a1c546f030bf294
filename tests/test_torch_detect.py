"""The port's detection path against the reference's: the pair
dispatcher (``dispatch_jobs``) on seeded mixes of classic and resident
jobs with duplicates, as a list in the reference's order and, sorted,
against the naive per-pair truth; the dedup counters; the unfixed
filter; ``LibraryDriver`` on a fixture YAML; the grammar differential
property; and the CUDA default."""

import random
import zlib

import numpy as np
import pytest
import torch

import trivy_tpu.db as rdb
import trivy_tpu.detect.batch as rbatch
import trivy_tpu_torch.db as tdb
import trivy_tpu_torch.detect.batch as tbatch
from tests.test_grammar_differential import GRAMMARS, _BUCKETS
from tests.test_grammar_differential import _constraint as _gd_constraint
from tests.test_grammar_differential import _version as _gd_version
from tests.test_torch_compiled_db import (LIB_BUCKETS, OS_BUCKETS,
                                          build_store, lib_version,
                                          os_version, store_ops)

BACKENDS = ("cpu", "cpu-ref")


def _classic_jobs(mod, rng, n: int) -> list:
    """The tests/test_mesh_dispatch.py mix, plus npm prereleases (the
    host path) and unfixed OS advisories without report_unfixed."""
    jobs = []
    for k in range(n):
        grammar = ("semver", "npm", "pep440")[int(rng.integers(0, 3))]
        v = (f"{int(rng.integers(0, 3))}."
             f"{int(rng.integers(0, 5))}.{int(rng.integers(0, 5))}")
        fixed = (f"{int(rng.integers(1, 3))}."
                 f"{int(rng.integers(0, 5))}.1")
        roll = float(rng.random())
        if roll < 0.5:
            jobs.append(mod.PairJob(
                grammar=grammar, pkg_version=v,
                vulnerable=[f"<{fixed}"], patched=[f">={fixed}"],
                payload=("pj", k)))
        elif roll < 0.65:
            lo = f"{int(rng.integers(0, 2))}.0.0"
            jobs.append(mod.PairJob(
                grammar=grammar, pkg_version=v,
                vulnerable=[f">={lo}, <{fixed}"],
                patched=[f">={fixed}"], payload=("pj", k)))
        elif roll < 0.7:
            jobs.append(mod.PairJob(
                grammar="npm", pkg_version=v + "-rc.1",
                vulnerable=[f">={v}-rc.0 <{fixed}"], payload=("pj", k)))
        elif roll < 0.74:
            jobs.append(mod.PairJob(
                grammar=grammar, pkg_version=v,
                vulnerable=[f"={i}.{i}.1" for i in range(5)],
                payload=("pj", k)))
        elif roll < 0.76:
            jobs.append(mod.PairJob(
                grammar=grammar, pkg_version=v, vulnerable=[""],
                payload=("pj", k)))
        elif roll < 0.78:
            jobs.append(mod.PairJob(
                grammar=grammar, pkg_version="bad version",
                vulnerable=["<1.0.0"], payload=("pj", k)))
        else:
            jobs.append(mod.PairJob(
                grammar="deb", pkg_version=f"1.{k % 4}-1",
                kind="ospkg",
                fixed_version="" if k % 7 == 0 else f"1.{k % 3 + 1}-1",
                affected_version="1.1-1" if k % 5 == 0 else "",
                report_unfixed=k % 2 == 0, payload=("pj", k)))
    return jobs


def _resident_jobs(mod, cdb, rng, n: int, tag: str = "rj") -> list:
    jobs = []
    grammars = {**OS_BUCKETS, **LIB_BUCKETS}
    for k in range(n):
        row = int(rng.integers(0, len(cdb.rows_meta)))
        bucket = cdb.rows_meta[row][0]
        g = grammars.get(bucket, "semver")
        make = os_version if bucket in OS_BUCKETS else lib_version
        jobs.append(mod.ResidentPairJob(
            cdb=cdb, row=row, grammar=cdb.row_grammar[row],
            pkg_version=make(rng, g), report_unfixed=k % 3 != 0,
            payload=(tag, k)))
    return jobs


def _mix(mod, cdbs: tuple, seed: int) -> list:
    """Classic + resident jobs against each store in ``cdbs``, a third
    duplicated with other payloads, shuffled: the same list for either
    package, given its own classes and stores."""
    rng = np.random.default_rng(seed)
    jobs = _classic_jobs(mod, rng, 160)
    for i, cdb in enumerate(cdbs):
        jobs += _resident_jobs(mod, cdb, rng, 240, tag=f"rj{i}")
    for idx in rng.choice(len(jobs), size=len(jobs) // 3, replace=False):
        j = jobs[int(idx)]
        jobs.append(type(j)(**{**j.__dict__, "payload": ("dup", int(idx))}))
    order = rng.permutation(len(jobs))
    return [jobs[int(i)] for i in order]


def _naive_truth(mod, jobs) -> list:
    """Per-job host evaluation, no dedup, no batching (the
    tests/test_mesh_dispatch.py oracle)."""
    out = []
    for job in jobs:
        if isinstance(job, mod.PairJob):
            if job.kind == "ospkg":
                if mod.detect_pairs([job], backend="cpu-ref", stats={}):
                    out.append(job.payload)
            elif mod._host_eval(job):
                out.append(job.payload)
        elif job.cdb.host_eval(job.row, job.pkg_version):
            from trivy_tpu_torch.db.compiled import F_UNFIXED
            if not (int(job.cdb.flags[job.row]) & F_UNFIXED) or \
                    job.report_unfixed:
                out.append(job.payload)
    return sorted(out)


@pytest.fixture(scope="module")
def stores():
    ops_a, ops_b = store_ops(11), store_ops(12, n_pkgs=8)
    return ((rdb.CompiledDB.compile(build_store(rdb, ops_a)),
             rdb.CompiledDB.compile(build_store(rdb, ops_b))),
            (tdb.CompiledDB.compile(build_store(tdb, ops_a)),
             tdb.CompiledDB.compile(build_store(tdb, ops_b))))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [20260804, 1, 2])
def test_dispatch_jobs_equals_reference(stores, backend, seed):
    """The payload list, unsorted, equals the reference's dispatch_jobs
    (run as JAX on the CPU); sorted, it equals the naive truth; the
    dedup counters agree."""
    (ra, rb), (ta, tb) = stores
    rjobs = _mix(rbatch, (ra, rb), seed)
    tjobs = _mix(tbatch, (ta, tb), seed)
    rstats, tstats = {}, {}
    want = rbatch.dispatch_jobs(rjobs, backend="tpu", stats=rstats)
    got = tbatch.dispatch_jobs(tjobs, backend=backend, stats=tstats)
    assert got == want
    assert sorted(got) == _naive_truth(tbatch, tjobs)
    assert 0 < len(got) < len(tjobs)
    assert tstats["jobs_in"] == rstats["jobs_in"] == len(tjobs)
    assert tstats["jobs_unique"] == rstats["jobs_unique"] < len(tjobs)
    assert tstats["device_s"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_detect_pairs_resident_mixed_stores_equals_reference(stores,
                                                             backend):
    """A list mixing two stores evaluates per store, in the
    reference's order."""
    (ra, rb), (ta, tb) = stores
    rng_r, rng_t = (np.random.default_rng(9) for _ in range(2))
    rjobs = _resident_jobs(rbatch, ra, rng_r, 100) + \
        _resident_jobs(rbatch, rb, rng_r, 100, "b")
    tjobs = _resident_jobs(tbatch, ta, rng_t, 100) + \
        _resident_jobs(tbatch, tb, rng_t, 100, "b")
    perm = np.random.default_rng(10).permutation(200)
    rjobs = [rjobs[int(i)] for i in perm]
    tjobs = [tjobs[int(i)] for i in perm]
    want = rbatch.detect_pairs_resident(rjobs, backend="tpu", stats={})
    got = tbatch.detect_pairs_resident(tjobs, backend=backend, stats={})
    assert got == want and got


@pytest.mark.parametrize("backend", BACKENDS)
def test_result_order_device_hits_then_host_hits(backend):
    """Device hits come first, in job order, then host-path hits in job
    order, duplicates of one host group interleaved with another's."""
    def jobs(mod):
        pre = dict(grammar="npm", vulnerable=[">=1.0.0-rc.0 <2.0.0"])
        out = [mod.PairJob(pkg_version="1.0.0-rc.1", payload=0, **pre),
               mod.PairJob(grammar="semver", pkg_version="1.0.0",
                           vulnerable=["<2.0.0"], payload=1),
               mod.PairJob(pkg_version="1.0.0-rc.2", payload=2, **pre),
               mod.PairJob(pkg_version="1.0.0-rc.1", payload=3, **pre),
               mod.PairJob(grammar="semver", pkg_version="1.5.0",
                           vulnerable=["<2.0.0"], payload=4)]
        return out
    want = rbatch.dispatch_jobs(jobs(rbatch), backend="tpu", stats={})
    got = tbatch.dispatch_jobs(jobs(tbatch), backend=backend, stats={})
    assert got == want == [1, 4, 0, 2, 3]

    def resident(mod, db_mod):
        store = db_mod.AdvisoryStore()
        store.put_advisory("npm::x", "a", "CVE-1", {
            "VulnerableVersions": [f"={i}.0.0" for i in range(6)]})
        store.put_advisory("npm::x", "b", "CVE-2", {
            "VulnerableVersions": [">=1.0.0-rc.0 <2.0.0"]})
        cdb = db_mod.CompiledDB.compile(store)
        host_row, pre_row = cdb.candidate_rows("npm::x", "a")[0], \
            cdb.candidate_rows("npm::x", "b")[0]
        spec = [(host_row, "1.0.0"), (pre_row, "1.0.0"),
                (pre_row, "1.0.0-rc.1"), (host_row, "2.0.0"),
                (pre_row, "1.0.0-rc.1"), (host_row, "1.0.0"),
                (pre_row, "1.5.0")]
        return [mod.ResidentPairJob(cdb=cdb, row=r, grammar="npm",
                                    pkg_version=v, payload=k)
                for k, (r, v) in enumerate(spec)]
    want = rbatch.dispatch_jobs(resident(rbatch, rdb), backend="tpu",
                                stats={})
    got = tbatch.dispatch_jobs(resident(tbatch, tdb), backend=backend,
                               stats={})
    assert got == want == [1, 6, 0, 2, 3, 4, 5]


def test_dedup_keys_on_generation(stores):
    """Equal rows of two stores are two rows: the key carries the
    store's generation."""
    _, (ta, tb) = stores
    a = tbatch.ResidentPairJob(cdb=ta, row=0, grammar="apk",
                               pkg_version="1.0-r0")
    b = tbatch.ResidentPairJob(cdb=tb, row=0, grammar="apk",
                               pkg_version="1.0-r0")
    assert a.dedup_key() != b.dedup_key()
    assert a.dedup_key()[0] == ta.generation != tb.generation


@pytest.mark.parametrize("backend", BACKENDS)
def test_report_unfixed_false_drops_unfixed_rows(backend):
    """Unfixed OS advisories report only where the driver asks for
    them, on the classic and the resident path."""
    store = tdb.AdvisoryStore()
    store.put_advisory("debian 12", "bash", "CVE-1", {})
    store.put_advisory("debian 12", "bash", "CVE-2",
                       {"FixedVersion": "5.2-1"})
    cdb = tdb.CompiledDB.compile(store)
    jobs = []
    for report in (True, False):
        for row in cdb.candidate_rows("debian 12", "bash"):
            jobs.append(tbatch.ResidentPairJob(
                cdb=cdb, row=row, grammar="deb", pkg_version="5.1-1",
                report_unfixed=report, payload=("r", report, row)))
        jobs.append(tbatch.PairJob(
            grammar="deb", pkg_version="5.1-1", kind="ospkg",
            report_unfixed=report, payload=("c", report)))
    got = tbatch.dispatch_jobs(jobs, backend=backend, stats={})
    unfixed = cdb.candidate_rows("debian 12", "bash")[0]
    assert ("c", True) in got and ("c", False) not in got
    assert ("r", True, unfixed) in got
    assert ("r", False, unfixed) not in got
    assert ("r", False, 1 - unfixed) in got


def test_library_driver_on_fixture_yaml(tmp_path):
    """new_library_driver(...).detect on a fixture DB equals the
    reference's, DetectedVulnerability for DetectedVulnerability."""
    from trivy_tpu.detect import new_library_driver as rdriver
    from trivy_tpu_torch.detect import new_library_driver as tdriver
    fixture = tmp_path / "db.yaml"
    fixture.write_text("""
- bucket: data-source
  pairs:
    - key: "pip::GitHub Security Advisory Pip"
      value: {ID: ghsa, Name: GitHub Security Advisory Pip,
              URL: "https://github.com/advisories?query=type%3Areviewed"}
- bucket: "pip::GitHub Security Advisory Pip"
  pairs:
    - bucket: django
      pairs:
        - key: CVE-2021-44420
          value:
            PatchedVersions: ["2.2.25", "3.1.14", "3.2.10"]
            VulnerableVersions: ["<2.2.25", ">=3.0a1, <3.1.14",
                                 ">=3.2a1, <3.2.10"]
- bucket: "npm::GitHub Security Advisory Npm"
  pairs:
    - bucket: jquery
      pairs:
        - key: CVE-2020-11022
          value:
            PatchedVersions: [">=3.5.0"]
            VulnerableVersions: [">=1.2.0 <3.5.0"]
        - key: CVE-2019-11358
          value:
            VulnerableVersions: ["<3.4.0"]
- bucket: "maven::GitHub Security Advisory Maven"
  pairs:
    - bucket: "com.fasterxml.jackson.core:jackson-databind"
      pairs:
        - key: CVE-2020-9548
          value:
            VulnerableVersions: [">= 2.0.0, <= 2.9.10.3", "[2.10.0,2.10.3)"]
- bucket: vulnerability
  pairs:
    - key: CVE-2021-44420
      value: {Severity: HIGH, PublishedDate: 2021-12-08T00:15:00Z}
""")
    rstore = rdb.load_fixtures([str(fixture)])
    tstore = tdb.load_fixtures([str(fixture)])
    cases = [("pip", "Django", v) for v in ("2.2.24", "3.1.13", "3.1.14",
                                            "3.2.0", "4.0")] + \
        [("npm", "jQuery", v) for v in ("1.1.0", "3.3.9", "3.4.1",
                                       "3.5.0", "3.5.0-rc.1")] + \
        [("jar", "com.fasterxml.jackson.core:jackson-databind", v)
         for v in ("2.9.10.3", "2.9.10.4", "2.10.2", "2.10.3")]
    n = 0
    for lib_type, name, v in cases:
        want = rdriver(lib_type).detect(rstore, "id", name, v)
        got = tdriver(lib_type).detect(tstore, "id", name, v)
        assert [g.to_dict() for g in got] == [w.to_dict() for w in want]
        n += len(got)
    assert n >= 6
    assert vars(tstore.get_vulnerability("CVE-2021-44420")) == \
        vars(rstore.get_vulnerability("CVE-2021-44420"))
    with pytest.raises(ValueError):
        tdriver("no-such-type")


# --- the grammar differential property, run on the port


@pytest.mark.parametrize("grammar", GRAMMARS)
def test_host_vs_compiled_agree_on_the_port(grammar):
    """The port's host ``is_vulnerable`` and its compiled path (the
    torch interval match on the CPU, or ``host_eval`` for F_HOST rows)
    agree on generated GHSA-shaped pairs."""
    from trivy_tpu_torch.db.compiled import F_HOST
    from trivy_tpu_torch.ops.intervals import interval_hits
    from trivy_tpu_torch.vercmp import get_comparer
    from trivy_tpu_torch.vercmp.base import is_vulnerable
    rng = random.Random(zlib.crc32(grammar.encode()))
    comparer = get_comparer(grammar)
    bucket = _BUCKETS[grammar]
    cases = []
    store = tdb.AdvisoryStore()
    for i in range(120):
        vulnerable = _gd_constraint(rng, grammar)
        patched_v = f"{rng.randrange(1, 4)}.{rng.randrange(6)}." \
                    f"{rng.randrange(6)}"
        patched = [f">={patched_v}"] if rng.random() < 0.7 else []
        store.put_advisory(bucket, f"pkg{i}", f"CVE-{i}",
                           {"VulnerableVersions": vulnerable,
                            "PatchedVersions": patched})
        cases.append((i, vulnerable, patched))
    cdb = tdb.CompiledDB.compile(store)
    tables = cdb.device_tables("cpu")
    mismatches, n = [], 0
    for i, vulnerable, patched in cases:
        rows = list(cdb.candidate_rows(bucket, f"pkg{i}"))
        assert len(rows) == 1
        row = rows[0]
        for _ in range(10):
            version = _gd_version(rng)
            host = is_vulnerable(comparer, version, vulnerable, patched, [])
            if int(cdb.flags[row]) & F_HOST:
                device = cdb.host_eval(row, version)
            else:
                r = cdb.pkg_rank(grammar, version)
                if r is None:
                    continue
                idx = torch.tensor([row])
                device = bool(interval_hits(
                    torch.tensor([r], dtype=torch.int32),
                    *(t.index_select(0, idx) for t in tables))[0])
            n += 1
            if host != device:
                mismatches.append((version, vulnerable, patched, host,
                                   device))
    assert not mismatches, mismatches[:5]
    assert n >= 1000
    rate = cdb.stats["host_fallback_rate"]
    assert rate <= 0.05, f"{grammar}: fallback {rate:.2%}"


def test_dispatch_defaults_to_cuda_and_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = [tbatch.PairJob(grammar="semver", pkg_version="1.0.0",
                           vulnerable=["<2.0.0"], payload=1)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.dispatch_jobs(jobs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.detect_pairs(jobs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatch.dispatch_jobs([])
    with pytest.raises(ValueError, match="unknown backend"):
        tbatch.dispatch_jobs(jobs, backend="tpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tbatch.dispatch_jobs(jobs, backend="cpu", mesh=object())
    assert tbatch.dispatch_jobs(jobs, backend="cpu") == [1]


@pytest.mark.parametrize("n,want", [(0, 64), (1, 64), (64, 64), (65, 128),
                                    (8192, 8192), (8193, 16384),
                                    (20000, 24576)])
def test_job_bucket_ladder(n, want):
    assert tbatch._job_bucket(n) == rbatch._job_bucket(n) == want
