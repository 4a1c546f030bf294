"""The port's ``CompiledDB`` against the reference's on one seeded
store: the five resident arrays, the row metadata, the join index,
the bound universes (through ``_enc_key``), the stats, version ranks,
exact host evaluation of ``F_HOST`` rows, the npz format read in both
directions, and one counted upload per device."""

import datetime
import warnings

import numpy as np
import pytest
import torch

import trivy_tpu.db as rdb
import trivy_tpu_torch.db as tdb
from trivy_tpu.db import compiled as rcomp
from trivy_tpu_torch.db import compiled as tcomp
from trivy_tpu_torch.detect.metrics import DETECT_METRICS

# bucket → (grammar, kind)
OS_BUCKETS = {"alpine 3.16": "apk", "debian 12": "deb",
              "ubuntu 22.04": "deb", "rocky 9": "rpm"}
LIB_BUCKETS = {"npm::GitHub Security Advisory npm": "npm",
               "pip::GitHub Security Advisory pip": "pep440",
               "maven::GitHub Security Advisory Maven": "maven",
               "rubygems::GitHub Security Advisory RubyGems": "rubygems",
               "go::GitHub Security Advisory Go": "semver"}


def os_version(rng, grammar: str) -> str:
    a, b, c = (int(x) for x in rng.integers(0, 6, 3))
    r = int(rng.integers(0, 5))
    if grammar == "apk":
        return f"{a}.{b}.{c}-r{r}"
    if grammar == "deb":
        return (f"{a}.{b}.{c}-{r}", f"1:{a}.{b}-{r}",
                f"{a}.{b}.{c}-{r}ubuntu1")[int(rng.integers(0, 3))]
    return f"{a}.{b}.{c}-{r}.el9"


def lib_version(rng, grammar: str) -> str:
    a, b, c = (int(x) for x in rng.integers(0, 6, 3))
    v = f"{a}.{b}.{c}"
    roll = rng.random()
    if roll < 0.08:
        return {"npm": f"{v}-rc.1", "pep440": f"{v}rc1",
                "maven": f"{v}-SNAPSHOT", "rubygems": f"{v}.pre",
                "semver": f"v{v}-beta.2"}[grammar]
    if roll < 0.1 and grammar == "semver":
        return "v" + v
    return v


def ghsa_constraints(rng, grammar: str) -> list:
    """GHSA-shaped VulnerableVersions lists (the shapes of
    tests/test_grammar_differential.py), now and then more than four
    alternatives, an empty string or a syntax error."""
    fixed = f"{int(rng.integers(1, 4))}.{int(rng.integers(0, 6))}." \
            f"{int(rng.integers(1, 6))}"
    lo = f"{int(rng.integers(0, 2))}.{int(rng.integers(0, 6))}.0"
    roll = rng.random()
    if roll < 0.35:
        return [f"<{fixed}"]
    if roll < 0.55:
        return [f">={lo}, <{fixed}"]
    if roll < 0.7:
        return [f">= {lo}", f"<= {fixed}"]
    if roll < 0.82:
        alt = f"{int(rng.integers(2, 5))}.{int(rng.integers(0, 6))}." \
              f"{int(rng.integers(1, 6))}"
        return [f"<{fixed}", f">={fixed}, <{alt}"]
    if roll < 0.9:
        return [f"={fixed}"]
    if roll < 0.95:
        return [f"={i}.{i}.{int(rng.integers(0, 9))}" for i in range(6)]
    if roll < 0.97:
        return [""]
    return [">>" + fixed if grammar != "maven" else "[" + fixed]


def store_ops(seed: int, n_pkgs: int = 24) -> list:
    """A seeded trivy-db-shaped store as a list of put_* calls."""
    rng = np.random.default_rng(seed)
    ops = [("ds", b, {"ID": b.split()[0].split(":")[0], "Name": b,
                      "URL": "https://example.invalid/" + str(i)})
           for i, b in enumerate(list(OS_BUCKETS) + list(LIB_BUCKETS))]
    ids = []
    for bucket, grammar in OS_BUCKETS.items():
        for p in range(n_pkgs):
            for k in range(int(rng.integers(1, 4))):
                vid = f"CVE-2023-{len(ids):05d}"
                ids.append(vid)
                value = {"Severity": int(rng.integers(0, 5))}
                if rng.random() > 0.1:
                    value["FixedVersion"] = os_version(rng, grammar)
                if grammar == "apk" and rng.random() < 0.3:
                    value["AffectedVersion"] = os_version(rng, grammar)
                if rng.random() < 0.03:
                    value["FixedVersion"] = "not a version!"
                ops.append(("adv", bucket, f"os-pkg{p}", vid, value))
    for bucket, grammar in LIB_BUCKETS.items():
        for p in range(n_pkgs):
            for k in range(int(rng.integers(1, 4))):
                vid = f"GHSA-{len(ids):04d}-x"
                ids.append(vid)
                value = {"VulnerableVersions": ghsa_constraints(rng, grammar)}
                if rng.random() < 0.7:
                    value["PatchedVersions"] = [
                        f">={int(rng.integers(1, 4))}.{int(rng.integers(0, 6))}"
                        f".{int(rng.integers(0, 6))}"]
                if rng.random() < 0.1:
                    value["UnaffectedVersions"] = ["<0.1.0"]
                ops.append(("adv", bucket, f"lib-{p}", vid, value))
    ops.append(("adv", "unknownos 1", "x", "CVE-0000-0001",
                {"FixedVersion": "1.0"}))
    for i, vid in enumerate(ids):
        value = {"Title": f"issue {i}", "Severity": "HIGH" if i % 3
                 else 2, "VendorSeverity": {"nvd": i % 5},
                 "References": [f"https://example.invalid/{vid}"]}
        if i % 7 == 0:
            value["PublishedDate"] = datetime.datetime(2023, 1, 1 + i % 28,
                                                       12, 0, 0)
            value["LastModifiedDate"] = datetime.date(2023, 2, 1)
        ops.append(("vuln", vid, value))
    return ops


def build_store(db_mod, ops: list):
    store = db_mod.AdvisoryStore()
    for op in ops:
        if op[0] == "adv":
            store.put_advisory(*op[1:])
        elif op[0] == "vuln":
            store.put_vulnerability(*op[1:])
        else:
            store.put_data_source(*op[1:])
    return store


@pytest.fixture(scope="module")
def ops():
    return store_ops(20261016)


@pytest.fixture(scope="module")
def pair(ops):
    return (rdb.CompiledDB.compile(build_store(rdb, ops)),
            tdb.CompiledDB.compile(build_store(tdb, ops)))


def _universe(comp, cdb) -> dict:
    return {g: ([comp._enc_key(k) for k in keys], base)
            for g, (keys, base) in cdb.universe.items()}


def _meta(comp, cdb) -> list:
    return [(b, p, comp._adv_enc(a)) for b, p, a in cdb.rows_meta]


def assert_same_db(r, t):
    for a, b in zip(r._resident_arrays(), t._resident_arrays()):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert _meta(rcomp, r) == _meta(tcomp, t)
    assert r.row_grammar == t.row_grammar
    assert r.index == t.index
    assert _universe(rcomp, r) == _universe(tcomp, t)
    assert r.stats == t.stats
    assert r.vulnerabilities == t.vulnerabilities
    assert r.data_sources == t.data_sources


def test_compile_equals_reference(pair):
    r, t = pair
    assert_same_db(r, t)
    flags = t.flags
    assert (flags & tcomp.F_HOST).any() and (flags & tcomp.F_UNFIXED).any()
    assert (flags & tcomp.F_FORCE).any() and (flags & tcomp.F_HAS_SEC).any()
    assert set(t.universe) == {"apk", "deb", "rpm", "npm", "pep440",
                               "maven", "rubygems", "semver"}
    assert t.content_fingerprint() == r.content_fingerprint()
    assert (tcomp.F_HAS_VULN, tcomp.F_FORCE, tcomp.F_HAS_SEC, tcomp.F_HOST,
            tcomp.F_UNFIXED) == (rcomp.F_HAS_VULN, rcomp.F_FORCE,
                                 rcomp.F_HAS_SEC, rcomp.F_HOST,
                                 rcomp.F_UNFIXED)


@pytest.mark.parametrize("bucket", ["alpine 3.16", "debian 12", "ubuntu 22",
                                    "rocky 9", "npm::x", "pip::x", "go::y",
                                    "maven::z", "rubygems::g", "cargo::c",
                                    "conan::c", "unknownos 1", ""])
def test_bucket_grammar(bucket):
    assert tcomp.bucket_grammar(bucket) == rcomp.bucket_grammar(bucket)


def test_pkg_rank_equals_reference(pair):
    r, t = pair
    rng = np.random.default_rng(3)
    n = 0
    for bucket, grammar in {**OS_BUCKETS, **LIB_BUCKETS}.items():
        make = os_version if bucket in OS_BUCKETS else lib_version
        for _ in range(150):
            v = make(rng, grammar)
            assert t.pkg_rank(grammar, v) == r.pkg_rank(grammar, v), v
            n += 1
        for bad in ("", "not a version!", "1..2"):
            assert t.pkg_rank(grammar, bad) == r.pkg_rank(grammar, bad)
    assert t.pkg_rank("npm", "1.0.0") == t.pkg_rank("npm", "1.0.0")


def test_host_eval_on_host_rows(pair):
    r, t = pair
    rng = np.random.default_rng(4)
    host_rows = np.nonzero(t.flags & tcomp.F_HOST)[0]
    assert len(host_rows) >= 5
    verdicts = set()
    for row in host_rows:
        bucket = t.rows_meta[row][0]
        grammar = {**OS_BUCKETS, **LIB_BUCKETS}.get(bucket, "semver")
        make = os_version if bucket in OS_BUCKETS else lib_version
        for _ in range(20):
            v = make(rng, grammar)
            got = t.host_eval(int(row), v)
            assert got == r.host_eval(int(row), v)
            verdicts.add(got)
    assert verdicts == {True, False}


def test_candidate_rows_and_vulnerability_reads(pair):
    r, t = pair
    for bucket in list(OS_BUCKETS) + list(LIB_BUCKETS):
        for pkg in ("os-pkg3", "lib-5", "missing"):
            assert t.candidate_rows(bucket, pkg) == \
                r.candidate_rows(bucket, pkg)
    for prefix in ("npm::", "pip::", "go::", "maven::", "rubygems::",
                   "debian", "nuget::"):
        assert t.candidate_rows_prefix(prefix, "lib-7") == \
            r.candidate_rows_prefix(prefix, "lib-7")
    for vid in ("CVE-2023-00000", "CVE-2023-00007", "GHSA-0300-x", "nope"):
        got, want = t.get_vulnerability(vid), r.get_vulnerability(vid)
        assert (got is None) == (want is None)
        if got is not None:
            assert vars(got) == vars(want)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_npz_cross_load(pair, tmp_path, writer):
    """A file written by either package loads in the other with equal
    tables, universes (exact key types) and detections."""
    from trivy_tpu.detect.batch import ResidentPairJob as RJob
    from trivy_tpu.detect.batch import dispatch_jobs as rdispatch
    from trivy_tpu_torch.detect.batch import ResidentPairJob as TJob
    from trivy_tpu_torch.detect.batch import dispatch_jobs as tdispatch
    r, t = pair
    path = str(tmp_path / "cdb")
    (r if writer == "reference" else t).save(path)
    r2, t2 = rdb.CompiledDB.load(path), tdb.CompiledDB.load(path)
    assert_same_db(r, t2)
    assert_same_db(r2, t)
    for g, (keys, _) in t2.universe.items():
        assert [type(k).__name__ for k in keys] == \
            [type(k).__name__ for k in r.universe[g][0]]
    rng = np.random.default_rng(5)
    specs = []
    for row in range(len(t.rows_meta)):
        bucket = t.rows_meta[row][0]
        grammar = {**OS_BUCKETS, **LIB_BUCKETS}.get(bucket, "semver")
        make = os_version if bucket in OS_BUCKETS else lib_version
        specs += [(row, grammar, make(rng, grammar)) for _ in range(3)]
    want = rdispatch([RJob(cdb=r, row=row, grammar=g, pkg_version=v,
                           payload=k)
                      for k, (row, g, v) in enumerate(specs)],
                     backend="tpu", stats={})
    got = tdispatch([TJob(cdb=t2, row=row, grammar=g, pkg_version=v,
                          payload=k) for k, (row, g, v) in enumerate(specs)],
                    backend="cpu", stats={})
    assert got == want and 0 < len(got) < len(specs)
    assert tdispatch([TJob(cdb=t, row=row, grammar=g, pkg_version=v,
                           payload=k)
                      for k, (row, g, v) in enumerate(specs)],
                     backend="cpu-ref", stats={}) == want


def test_one_counted_upload_per_device(ops, tmp_path):
    """Three dispatches upload the tables once, count it in
    ``device_stats()`` and ``DETECT_METRICS``, and leave the resident
    tensors as they were; read-only arrays (as ``np.load`` may give)
    upload without a warning and stay the table's own."""
    from trivy_tpu_torch.detect.batch import ResidentPairJob, dispatch_jobs
    cdb = tdb.CompiledDB.compile(build_store(tdb, ops))
    cdb.save(str(tmp_path / "db"))
    loaded = tdb.CompiledDB.load(str(tmp_path / "db"))
    assert loaded.generation > cdb.generation
    for a in loaded._resident_arrays():     # as some numpy versions
        a.flags.writeable = False           # load npz members
    jobs = [ResidentPairJob(cdb=loaded, row=row, grammar=g,
                            pkg_version=v, payload=row)
            for row, g in enumerate(loaded.row_grammar)
            for v in ("1.2.3", "0.1.0-1")]
    before = DETECT_METRICS.snapshot()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        results = [dispatch_jobs(jobs, backend="cpu", stats={})
                   for _ in range(3)]
    assert results[0] == results[1] == results[2] and results[0]
    st = loaded.device_stats()
    assert st["uploads"] == 1 and st["dispatches"] == 3
    assert st["upload_bytes"] == sum(a.nbytes
                                     for a in loaded._resident_arrays())
    after = DETECT_METRICS.snapshot()
    assert after["db_uploads"] - before["db_uploads"] == 1
    assert after["resident_dispatches"] - before["resident_dispatches"] \
        == 3
    tables = loaded.device_tables("cpu")
    for t, a in zip(tables, loaded._resident_arrays()):
        np.testing.assert_array_equal(t.numpy(), a)
        assert t.dtype == torch.int32
    loaded.invalidate_device()
    assert loaded.device_tables("cpu") is not tables
    assert loaded.device_stats()["uploads"] == 2
