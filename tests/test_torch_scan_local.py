"""The port's scan path against the reference's: ``apply_layers`` on
seeded multi-layer blob stacks (whiteouts, opaque dirs, build info,
secrets, licenses), ``fill_info`` on both DB kinds, ``filter_results``,
and the whole ``sbom`` entry — ``trivy_tpu.cli.main(["sbom", ...])``
against ``trivy_tpu_torch.cli.main(["sbom", ..., "--backend", "cpu"])``
and ``cpu-ref`` on the documents of tests/test_sbom.py and on seeded
image BOMs (chip_smoke.make_bom) against a seeded 5,000-row store,
over fixture YAMLs and over a compiled npz the reference wrote, in
``json`` and ``cyclonedx``. Reports must be equal after ``sort_keys``
(the CycloneDX writer's timestamp and random serials normalized)."""

import contextlib
import copy
import datetime
import io
import json
import os
import random
import re

import numpy as np
import pytest
import torch
import yaml

import trivy_tpu.applier as rapplier
import trivy_tpu.db as rdb
import trivy_tpu.detect.enrich as renrich
import trivy_tpu.scan.filter as rfilter
import trivy_tpu.types as rtypes
import trivy_tpu.types.report as rreport
import trivy_tpu_torch.applier as tapplier
import trivy_tpu_torch.db as tdb
import trivy_tpu_torch.detect.enrich as tenrich
import trivy_tpu_torch.scan.filter as tfilter
import trivy_tpu_torch.types as ttypes
import trivy_tpu_torch.types.report as treport
from chip_smoke import SBOM_IMAGES, make_advisory_store, make_bom
from tests.test_sbom import CDX_BOM, FIXTURE_DB, SPDX_DOC
from trivy_tpu.cli import main as rmain
from trivy_tpu_torch.cli import main as tmain

STORE_ROWS = 5000
# two more images beside the smoke run's: ubuntu with an aggregated
# python-pkg app, and an EOSL alpine with go binaries and aggregated
# gemspec and node-pkg libraries
IMAGES = [SBOM_IMAGES["A"], SBOM_IMAGES["B"],
          ("ubuntu", "22.04", "ubuntu 22.04", "deb", "deb", 80, (
              ("npm", "web/package-lock.json",
               "npm::GitHub Security Advisory npm", "npm", "npm", 50),
              ("python-pkg", "usr/lib/python3/dist-packages",
               "pip::GitHub Security Advisory pip", "pep440", "pypi",
               20))),
          ("alpine", "3.16.2", "alpine 3.16", "apk", "apk", 40, (
              ("gobinary", "usr/bin/app", "go::GitHub Security Advisory Go",
               "semver", "golang", 60),
              ("gemspec", "usr/lib/ruby/gems",
               "rubygems::GitHub Security Advisory RubyGems", "rubygems",
               "gem", 40),
              ("node-pkg", "usr/lib/node_modules",
               "npm::GitHub Security Advisory npm", "npm", "npm", 10))),
          SBOM_IMAGES["A"]]
SCALES = [0.06, 0.125, 1.0, 1.0, 0.06]


# --- apply_layers -----------------------------------------------------

def _layers(mod, seed: int) -> list:
    """A seeded image as per-layer blobs: OS and repository records,
    package DBs rewritten by later layers, lockfiles, per-file
    aggregated installs, whiteouts and opaque dirs that delete some of
    them, secrets seen twice, licenses (dpkg ones merge into packages),
    custom resources, misconfigurations and Red Hat build info."""
    rng = random.Random(seed)
    layers = []
    paths = [f"{d}/{f}" for d in ("app", "app/sub", "srv", "usr/lib")
             for f in ("package-lock.json", "requirements.txt", "x.jar",
                       "METADATA")]
    for i in range(rng.randint(2, 5)):
        blob = mod.BlobInfo(digest=f"sha256:d{i}", diff_id=f"sha256:i{i}")
        if rng.random() < 0.5:
            blob.os = mod.OS(family=rng.choice(["debian", "redhat", ""]),
                             name=rng.choice(["", "12", "8.4"]),
                             extended=rng.random() < 0.3)
        if rng.random() < 0.3:
            blob.repository = mod.Repository(family="alpine",
                                             release="3.16")
        if rng.random() < 0.6:
            blob.package_infos.append(mod.PackageInfo(
                file_path=rng.choice(["var/lib/dpkg/status",
                                      "var/lib/rpm/Packages"]),
                packages=[mod.Package(name=f"p{k}",
                                      version=f"1.{rng.randint(0, 2)}",
                                      release=str(rng.randint(0, 1)))
                          for k in rng.sample(range(8), 4)]))
        for _ in range(rng.randint(0, 3)):
            atype = rng.choice(["npm", "pip", "jar", "python-pkg",
                                "gemspec", "node-pkg"])
            blob.applications.append(mod.Application(
                type=atype, file_path=rng.choice(paths),
                libraries=[mod.Package(name=f"l{k}",
                                       version=f"2.{rng.randint(0, 2)}")
                           for k in rng.sample(range(6), 3)]))
        blob.whiteout_files = rng.sample(paths, rng.randint(0, 2))
        if rng.random() < 0.3:
            blob.opaque_dirs = [rng.choice(["app/", "srv/", "usr/"])]
        for _ in range(rng.randint(0, 2)):
            blob.secrets.append(mod.Secret(
                file_path=rng.choice(["a.env", "b.pem"]),
                findings=[mod.SecretFinding(
                    rule_id=rng.choice(["aws", "gh", "pem"]),
                    start_line=rng.randint(1, 9))]))
        if rng.random() < 0.4:
            blob.licenses.append(mod.LicenseFile(
                type=rng.choice(["dpkg-license", "header"]),
                file_path=rng.choice(["usr/share/doc/p1/copyright",
                                      "LICENSE"]),
                pkg_name="p1",
                findings=[mod.LicenseFinding(name="GPL-2.0")]))
        if rng.random() < 0.3:
            blob.custom_resources.append(mod.CustomResource(
                type="digest", file_path="bin/x", data={"k": i}))
        if rng.random() < 0.3:
            blob.misconfigurations.append(mod.Misconfiguration(
                file_type="dockerfile", file_path="Dockerfile",
                failures=[mod.MisconfResult(id="DS001")]))
        if rng.random() < 0.4:
            blob.build_info = {"ContentSets": [f"cs-{i}"]}
        layers.append(blob)
    if rng.random() < 0.2:
        layers.insert(1, None)
    return layers


def _detail_view(d) -> dict:
    return {"os": d.os.to_dict() if d.os else None,
            "repo": d.repository.to_dict() if d.repository else None,
            "packages": [p.to_dict() for p in d.packages],
            "applications": [a.to_dict() for a in d.applications],
            "secrets": [s.to_dict() for s in d.secrets],
            "licenses": [lic.to_dict() for lic in d.licenses],
            "misconf": [m.to_dict() for m in d.misconfigurations],
            "custom": [c.to_dict() for c in d.custom_resources]}


@pytest.mark.parametrize("seed", range(12))
def test_apply_layers_equals_reference(seed):
    want = rapplier.apply_layers(_layers(rtypes, seed))
    got = tapplier.apply_layers(_layers(ttypes, seed))
    assert _detail_view(got) == _detail_view(want)


def test_apply_layers_single_layer_keeps_sbom_origin():
    """An SBOM's one blob: packages keep the layer the document names,
    and get the blob's own where it names none."""
    views = []
    for mod in (rtypes, ttypes):
        applier = rapplier if mod is rtypes else tapplier
        blob = mod.BlobInfo(
            digest="sha256:sbom", build_info={"ContentSets": ["a"]},
            package_infos=[mod.PackageInfo(packages=[
                mod.Package(name="a", layer=mod.Layer(diff_id="sha256:o")),
                mod.Package(name="b")])],
            applications=[mod.Application(type="npm", libraries=[
                mod.Package(name="c"),
                mod.Package(name="d", layer=mod.Layer(digest="x"))])])
        views.append(_detail_view(applier.apply_layers([blob])))
    assert views[0] == views[1]
    assert views[1]["packages"][0]["Layer"] == {"DiffID": "sha256:o"}
    assert views[1]["packages"][1]["Layer"] == {"Digest": "sha256:sbom"}


# --- fill_info and filter_results -------------------------------------

def _vuln_records(rng) -> dict:
    out = {}
    for i in range(40):
        d = {"Title": f"t{i}", "Description": f"d{i}"}
        if rng.random() < 0.8:
            d["Severity"] = rng.choice(["LOW", "HIGH", 2, 4, 9])
        if rng.random() < 0.7:
            d["VendorSeverity"] = {s: rng.randint(0, 5) for s in
                                   rng.sample(["nvd", "debian", "ghsa",
                                               "redhat"], 2)}
        if rng.random() < 0.5:
            d["References"] = rng.sample(
                ["https://www.debian.org/x", "https://access.redhat.com/y",
                 "https://example.invalid/z", "https://hackerone.com/w"], 2)
        d["CVSS"] = {"nvd": {"V3Score": 7.5}} if i % 3 == 0 else {}
        d["CweIDs"] = ["CWE-79"] if i % 4 == 0 else []
        when = rng.choice([None, "2021-01-02T03:04:05Z",
                           datetime.datetime(2020, 5, 6, 7, 8, 9),
                           datetime.datetime(2020, 5, 6, tzinfo=
                                             datetime.timezone.utc),
                           datetime.date(2019, 1, 1)])
        if when is not None:
            d["PublishedDate"] = when
        vid = rng.choice(["CVE-2020-", "GHSA-", "RUSTSEC-", "TEMP-",
                          "DSA-", "RHSA-"]) + f"{i:04d}"
        out[vid] = d
    return out


def _detected(mod, rng, ids: list) -> list:
    out = []
    for k in range(120):
        v = mod.DetectedVulnerability(
            vulnerability_id=rng.choice(ids + ["CVE-1999-0000"]),
            pkg_name=f"pkg{rng.randint(0, 5)}",
            pkg_path=rng.choice(["", "app/x.jar"]),
            installed_version=f"1.{rng.randint(0, 2)}",
            fixed_version=rng.choice(["", "1.3", "1.3-1.el8", "1.4-2.el8"]),
            vendor_ids=rng.sample(["RHSA-1", "RHSA-2", "DSA-3"],
                                  rng.randint(0, 2)))
        ds = rng.choice([None, "debian", "redhat", "redhat-oval", "ghsa",
                         "nodejs-security-wg"])
        if ds:
            v.data_source = mod.DataSource(id=ds, name=ds,
                                           url=f"https://{ds}")
        if rng.random() < 0.3:
            v.severity_source = rng.choice(["debian", "redhat"])
            v.vulnerability = mod.Vulnerability(
                severity=rng.choice(["LOW", "CRITICAL", ""]))
        out.append(v)
    return out


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["store", "compiled"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fill_info_equals_reference(seed, compiled):
    records = _vuln_records(random.Random(seed))
    views = []
    for db_mod, types_mod, enrich in ((rdb, rtypes, renrich),
                                      (tdb, ttypes, tenrich)):
        store = db_mod.AdvisoryStore()
        for vid, d in records.items():
            store.put_vulnerability(vid, copy.deepcopy(d))
        if compiled:
            store = db_mod.CompiledDB.compile(store)
        vulns = _detected(types_mod, random.Random(seed), list(records))
        enrich.fill_info(store, vulns)
        views.append([v.to_dict() for v in vulns])
    assert views[0] == views[1]
    assert any("PublishedDate" in v for v in views[1])


def _results(types_mod, report_mod, seed: int) -> list:
    rng = random.Random(seed)
    ids = list(_vuln_records(random.Random(seed)))
    out = []
    for k in range(4):
        r = types_mod.Result(target=f"t{k}",
                             class_=types_mod.ResultClass.LANGPKG)
        r.vulnerabilities = _detected(types_mod, rng, ids)[:30]
        for v in r.vulnerabilities:
            if rng.random() < 0.5:
                v.vulnerability = types_mod.Vulnerability(
                    severity=rng.choice(["LOW", "MEDIUM", "HIGH",
                                         "CRITICAL", "UNKNOWN"]))
        r.secrets = [types_mod.SecretFinding(
            rule_id=rng.choice(["aws", "gh"]),
            severity=rng.choice(["HIGH", "LOW"])) for _ in range(3)]
        r.licenses = [report_mod.DetectedLicense(
            severity=rng.choice(["HIGH", "UNKNOWN"]),
            name=rng.choice(["GPL-2.0", "MIT"])) for _ in range(3)]
        r.misconfigurations = [report_mod.DetectedMisconfiguration(
            id=rng.choice(["DS001", "DS002"]),
            severity=rng.choice(["HIGH", "LOW"]),
            status=rng.choice(["FAIL", "PASS", "EXCEPTION"]))
            for _ in range(4)]
        out.append(r)
    return out


FILTERS = [
    dict(severities=["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]),
    dict(severities=["HIGH", "CRITICAL"], ignore_unfixed=True),
    dict(severities=["LOW", "HIGH"], ignored_ids=["CVE-2020-0001",
                                                  "aws", "MIT", "DS001"]),
    dict(severities=["CRITICAL", "HIGH", "LOW", "UNKNOWN"],
         include_non_failures=True),
]


@pytest.mark.parametrize("kw", FILTERS)
@pytest.mark.parametrize("seed", [4, 5])
def test_filter_results_equals_reference(seed, kw):
    want = rfilter.filter_results(_results(rtypes, rreport, seed), **kw)
    got = tfilter.filter_results(_results(ttypes, treport, seed), **kw)
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert any(r.vulnerabilities for r in got)


def test_filter_severity_enums_and_ignore_policy(tmp_path):
    policy = tmp_path / "policy.py"
    policy.write_text("def ignore(f):\n"
                      "    return f.get('PkgName') == 'pkg1' or "
                      "f.get('RuleID') == 'gh'\n")
    views = []
    for mod, types_mod, report_mod in ((rfilter, rtypes, rreport),
                                       (tfilter, ttypes, treport)):
        results = mod.filter_results(
            _results(types_mod, report_mod, 6),
            [types_mod.Severity.HIGH, "LOW"],
            policy=mod.load_ignore_policy(str(policy)))
        views.append([r.to_dict() for r in results])
    assert views[0] == views[1]
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    with pytest.raises(tfilter.IgnorePolicyError, match="ignore"):
        tfilter.load_ignore_policy(str(bad))
    assert tfilter.load_ignore_policy("") is None


def test_load_ignore_file_equals_reference(tmp_path, monkeypatch):
    (tmp_path / ".trivyignore").write_text(
        "# comment\nCVE-1 trailing words\n\n  GHSA-2\n")
    monkeypatch.chdir(tmp_path)
    assert tfilter.load_ignore_file() == rfilter.load_ignore_file() \
        == ["CVE-1", "GHSA-2"]
    assert tfilter.load_ignore_file("missing") == []


# --- the sbom entry ---------------------------------------------------

def _run(main, argv: list) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}"
                   r"-[0-9a-f]{12}")


def _normalized(text: str, fmt: str) -> str:
    """The report as sorted JSON; for cyclonedx with the timestamp and
    tool version blanked and each random serial renamed by order of
    first appearance; a table as it is."""
    if fmt == "table":
        return text
    doc = json.loads(text)
    if fmt == "cyclonedx":
        doc["metadata"]["timestamp"] = "T"
        for tool in doc["metadata"]["tools"]:
            tool["version"] = "V"
        names: dict = {}
        out = json.dumps(doc, sort_keys=True)
        return _UUID.sub(lambda m: names.setdefault(
            m.group(0), f"uuid-{len(names)}"), out)
    return json.dumps(doc, sort_keys=True)


def _fast_yaml(load):
    """Fixture files written here are JSON, which is YAML: parse those
    with json (the pure-Python YAML parser takes ~10 s on 5,000 rows),
    everything else with ``load``."""
    def safe_load(text):
        try:
            return json.loads(text)
        except ValueError:
            return load(text)
    return safe_load


def _fixture_docs(store) -> list:
    docs = [{"bucket": b, "pairs": [
        {"bucket": p, "pairs": [{"key": k, "value": v}
                                for k, v in advs.items()]}
        for p, advs in pkgs.items()]} for b, pkgs in store.buckets.items()]
    docs.append({"bucket": "vulnerability", "pairs": [
        {"key": k, "value": v} for k, v in store.vulnerabilities.items()]})
    docs.append({"bucket": "data-source", "pairs": [
        {"key": k, "value": v} for k, v in store.data_sources.items()]})
    return docs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """BOMs and DBs on disk: tests/test_sbom.py's documents and fixture
    YAML, the seeded BOMs and the seeded store as a fixture YAML, and
    each store compiled and saved by the reference."""
    d = tmp_path_factory.mktemp("sbom")
    paths = {"cdx": d / "bom.cdx.json", "spdx": d / "bom.spdx.json",
             "small-fixtures": d / "db.yaml", "fixtures": d / "seeded.yaml"}
    paths["cdx"].write_text(json.dumps(CDX_BOM))
    paths["spdx"].write_text(json.dumps(SPDX_DOC))
    paths["small-fixtures"].write_text(FIXTURE_DB)
    small = rdb.load_fixtures([str(paths["small-fixtures"])])
    rdb.CompiledDB.compile(small).save(str(d / "small"))
    paths["small-compiled"] = d / "small"
    store, n_pkgs = make_advisory_store(STORE_ROWS, 20261016,
                                        store=rdb.AdvisoryStore())
    paths["fixtures"].write_text(json.dumps(_fixture_docs(store)))
    rdb.CompiledDB.compile(store).save(str(d / "seeded"))
    paths["compiled"] = d / "seeded"
    for i, (image, scale) in enumerate(zip(IMAGES, SCALES)):
        paths[f"bom{i}"] = d / f"seeded-{i}.cdx.json"
        paths[f"bom{i}"].write_text(json.dumps(
            make_bom(image, n_pkgs, 500 + i, scale)))
    return {k: str(v) for k, v in paths.items()}


def _db_args(inputs, kind: str, small: bool) -> list:
    key = ("small-" if small else "") + kind
    if kind == "compiled":
        return ["--compiled-db", inputs[key]]
    return ["--db-fixtures", inputs[key]]


def _compare(inputs, target: str, db_args: list, fmt: str, flags: list,
             tmp_path, monkeypatch) -> str:
    """Run both packages' ``sbom`` on one input, hold every port
    backend's report and exit code to the reference's, and return the
    normalized report."""
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    monkeypatch.chdir(tmp_path)
    common = ["sbom", target, "--format", fmt] + db_args + flags
    rout = str(tmp_path / "ref.out")
    rcode, _ = _run(rmain, common + [
        "--backend", "cpu", "--no-cache", "--output", rout,
        "--cache-dir", str(tmp_path / "cache")])
    with open(rout) as f:
        want = _normalized(f.read(), fmt)
    for backend in ("cpu", "cpu-ref"):
        tcode, out = _run(tmain, common + ["--backend", backend])
        assert tcode == rcode
        assert _normalized(out, fmt) == want
    return want


def _vuln_ids(report: dict, fmt: str) -> list:
    if fmt == "cyclonedx":
        return sorted(v["id"] for v in report.get("vulnerabilities", []))
    return sorted(v["VulnerabilityID"] for r in report.get("Results", [])
                  for v in r.get("Vulnerabilities", []))


@pytest.mark.parametrize("fmt", ["json", "cyclonedx"])
@pytest.mark.parametrize("kind", ["fixtures", "compiled"])
@pytest.mark.parametrize("doc", ["cdx", "spdx"])
def test_sbom_fixture_documents_equal_reference(inputs, doc, kind, fmt,
                                                tmp_path, monkeypatch):
    report = json.loads(_compare(inputs, inputs[doc],
                                 _db_args(inputs, kind, True), fmt, [],
                                 tmp_path, monkeypatch))
    assert _vuln_ids(report, fmt) == ["CVE-2019-14697", "CVE-2099-0001"]


@pytest.mark.parametrize("flags", [
    ["--list-all-pkgs"], ["--vuln-type", "os"],
    ["--vuln-type", "library"], ["--severity", "HIGH"],
    ["--exit-code", "4"], ["--severity", "LOW", "--exit-code", "4"],
    ["--compile-db"]])
def test_sbom_fixture_flags_equal_reference(inputs, flags, tmp_path,
                                            monkeypatch):
    _compare(inputs, inputs["cdx"], _db_args(inputs, "fixtures", True),
             "json", flags, tmp_path, monkeypatch)


SEEDED_CASES = [
    (0, "fixtures", "json", []),
    (0, "compiled", "cyclonedx", []),
    (1, "compiled", "json", ["--list-all-pkgs"]),
    (1, "fixtures", "cyclonedx", ["--vuln-type", "os"]),
    (2, "compiled", "json", ["--vuln-type", "library", "--severity",
                             "HIGH,CRITICAL"]),
    (2, "fixtures", "json", ["--ignore-unfixed", "--exit-code", "3"]),
    (3, "compiled", "cyclonedx", ["--severity", "LOW,MEDIUM",
                                  "--ignore-unfixed"]),
    (3, "fixtures", "json", ["--list-all-pkgs", "--vuln-type", "library"]),
    (4, "compiled", "json", ["--exit-code", "5", "--severity", "LOW"]),
    (4, "fixtures", "cyclonedx", ["--list-all-pkgs"]),
    (0, "compiled", "table", []),
    (2, "compiled", "table", ["--dependency-tree", "--severity",
                              "CRITICAL,LOW"]),
]


@pytest.mark.parametrize("bom,kind,fmt,flags", SEEDED_CASES)
def test_sbom_seeded_boms_equal_reference(inputs, bom, kind, fmt, flags,
                                          tmp_path, monkeypatch):
    report = _compare(inputs, inputs[f"bom{bom}"],
                      _db_args(inputs, kind, False), fmt, flags, tmp_path,
                      monkeypatch)
    if fmt == "table":
        assert "Total: " in report
    else:
        assert _vuln_ids(json.loads(report), fmt)


def test_sbom_ignorefile_is_read_from_the_current_directory(
        inputs, tmp_path, monkeypatch):
    (tmp_path / ".trivyignore").write_text("CVE-2019-14697\n")
    report = json.loads(_compare(inputs, inputs["cdx"],
                                 _db_args(inputs, "compiled", True), "json",
                                 [], tmp_path, monkeypatch))
    assert _vuln_ids(report, "json") == ["CVE-2099-0001"]


def test_sbom_entry_defaults_and_errors(inputs, tmp_path, monkeypatch):
    from trivy_tpu_torch.cli import load_store, scan_sbom
    monkeypatch.chdir(tmp_path)
    junk = tmp_path / "notbom.txt"
    junk.write_text("hello")
    for argv in (["sbom", str(junk)], ["sbom", str(tmp_path / "none")]):
        assert _run(rmain, argv + ["--no-cache", "--cache-dir",
                                   str(tmp_path / "c")])[0] == 1
        assert _run(tmain, argv + ["--backend", "cpu"])[0] == 1
    # every format is ported: a template format without a template is
    # the reference's error in both
    for main, extra in ((rmain, ["--no-cache", "--cache-dir",
                                 str(tmp_path / "c")]),
                        (tmain, [])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            code, _ = _run(main, ["sbom", inputs["cdx"], "--format",
                                  "template", "--backend", "cpu"] + extra)
        assert code == 1 and "requires '--template'" in err.getvalue()
    # the card by default: without one it raises before any work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["sbom", inputs["cdx"]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scan_sbom(inputs["cdx"], load_store())


@pytest.mark.parametrize("argv,error,code", [
    # a single target refuses --fault-spec as the reference does (its
    # id is the one it had while the option was still to be ported)
    pytest.param(["--fault-spec", "poison-image", "--backend", "cpu"],
                 "error: --fault-spec is wired into multi-target image "
                 "scans, the server, and the route command; this command "
                 "would inject nothing", 2, id="argv0-ROADMAP A.9"),
    pytest.param(["--cache-backend", "redis://127.0.0.1:9", "--backend",
                  "cpu"], "redis connect 127.0.0.1:9", 1,
                 id="argv1-redis connect 127.0.0.1:9"),
    pytest.param([], RuntimeError, None, id="argv2-RuntimeError")])
def test_sbom_entry_refuses_before_loading_the_db(inputs, argv, error,
                                                 code, monkeypatch):
    """``--fault-spec`` on this single-target entry, a blob cache that
    cannot be reached, or the card where there is none, ends the run
    before the DB is loaded."""
    import trivy_tpu_torch.cli as tcli

    def no_load(*args, **kwargs):
        raise AssertionError("the DB was loaded")

    monkeypatch.setattr(tcli, "load_store", no_load)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["sbom", inputs["cdx"], "--compiled-db",
            inputs["compiled"]] + argv
    if isinstance(error, str):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert _run(tcli.main, argv)[0] == code
        assert error in err.getvalue()
    else:
        with pytest.raises(error, match="CUDA is not available"):
            tcli.main(argv)


def test_scan_sbom_reports_its_steps(inputs):
    from trivy_tpu_torch.cli import load_store, scan_sbom
    timings, stats = {}, {}
    cdb = load_store(compiled_db=inputs["compiled"])
    report = scan_sbom(inputs["bom0"], cdb, "cpu", timings=timings,
                       stats=stats)
    assert sorted(timings) == ["decode_s", "dispatch_s", "finish_s",
                               "prepare_s"]
    assert stats["jobs_in"] >= stats["jobs_unique"] > 0
    assert {r.class_.value for r in report.results
            if r.vulnerabilities} == {"os-pkgs", "lang-pkgs"}
    assert report.to_dict()["Metadata"]["OS"] == {"Family": "debian",
                                                  "Name": "12"}
    np.testing.assert_array_equal(
        cdb.flags, tdb.CompiledDB.load(inputs["compiled"]).flags)
    assert os.path.exists(inputs["compiled"] + ".npz")
