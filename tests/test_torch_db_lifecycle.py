"""The port's advisory-DB lifecycle against the JAX package's:
``db/boltdb.py`` and ``db/boltwriter.py`` (``tests/test_boltdb.py``'s
cases; a trivy-db written by either package's writer loads into the
other to an equal store, and the two writers write the same bytes),
``guard/safetar.py::safe_extract_db_archive`` on hostile archives
(every case ends as in the reference), and ``db/lifecycle.py``
(``tests/test_db_lifecycle.py``'s cases: metadata freshness, an OCI
layout written by either package's ``write_oci_layout``, the atomic
install) with the CLI's ``db build``, ``db update`` and
``--cache-dir``."""

import contextlib
import datetime
import gzip
import io
import json
import os
import struct
import tarfile

import pytest

import trivy_tpu.cli as rcli
import trivy_tpu.db.boltwriter as rbw
import trivy_tpu.db.lifecycle as rlc
import trivy_tpu.guard as rguard
import trivy_tpu_torch.cli as tcli
import trivy_tpu_torch.db.boltwriter as bw
import trivy_tpu_torch.db.lifecycle as tlc
import trivy_tpu_torch.guard as tguard
import tests.test_e2e_image as e2e
from trivy_tpu.db.boltdb import load_trivy_db as r_load
from trivy_tpu_torch.db.boltdb import BoltDB, CorruptDB, load_trivy_db
from trivy_tpu_torch.db.lifecycle import (SCHEMA_VERSION, Metadata, db_dir,
                                          load_metadata, needs_update,
                                          pack_db_archive, read_oci_layout,
                                          save_metadata,
                                          update_from_oci_layout,
                                          write_oci_layout)

UTC = datetime.timezone.utc
NOW = datetime.datetime(2019, 10, 1, 0, 0, 0, tzinfo=UTC)

SOURCES = {
    "alpine 3.16": {
        "musl": {"CVE-2022-1": {"FixedVersion": "1.2.3-r1"}},
        "busybox": {"CVE-2022-2": {"FixedVersion": "1.35.0-r18"},
                    "CVE-2022-3": {"FixedVersion": "1.35.0-r19"}},
        # a package bucket past the inline limit: a leaf page of its own
        "big": {f"CVE-2023-{i}": {"FixedVersion": f"1.{i}.0-r0",
                                  "Note": "x" * 40}
                for i in range(60)},
    },
    "pip::Python": {"django": {"GHSA-aaaa": {
        "VulnerableVersions": ["<4.0.2"],
        "PatchedVersions": [">=4.0.2"]}}},
}
DETAILS = {"CVE-2022-1": {"Title": "musl bug", "Severity": "HIGH"},
           "CVE-2022-2": {"Title": "bb one", "Severity": "LOW"},
           "CVE-2022-3": {"Title": "bb two", "Severity": "MEDIUM"},
           "GHSA-aaaa": {"Title": "django bug", "Severity": "CRITICAL"}}


@pytest.fixture()
def tiny_db(tmp_path):
    path = str(tmp_path / "trivy.db")
    bw.write_trivy_db(path, SOURCES, DETAILS)
    return path


# ------------------------------------------------------------- boltdb

def test_writers_write_the_same_bytes(tmp_path):
    for name, mod in (("ref", rbw), ("port", bw)):
        mod.write_trivy_db(str(tmp_path / f"{name}.db"), SOURCES, DETAILS)
    assert (tmp_path / "port.db").read_bytes() == \
        (tmp_path / "ref.db").read_bytes()


def _store_dump(store) -> tuple:
    return (json.dumps(store.buckets, sort_keys=True),
            json.dumps(store.vulnerabilities, sort_keys=True))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_trivy_db_loads_alike_in_both(tmp_path, writer):
    """A BoltDB from either writer ingests into equal stores in both
    packages, with equal counts."""
    path = str(tmp_path / "t.db")
    (rbw if writer == "ref" else bw).write_trivy_db(path, SOURCES, DETAILS)
    rstore, rn, rd = r_load(path)
    tstore, tn, td = load_trivy_db(path)
    assert (tn, td) == (rn, rd) == (64, 4)
    assert _store_dump(tstore) == _store_dump(rstore)


class TestReader:
    def test_top_level_buckets(self, tiny_db):
        with BoltDB(tiny_db) as db:
            names = sorted(k.decode() for k, _ in db.buckets())
        assert names == ["alpine 3.16", "pip::Python", "vulnerability"]

    def test_nested_inline_buckets(self, tiny_db):
        with BoltDB(tiny_db) as db:
            pkgs = dict(db.bucket(b"alpine 3.16").buckets())
            assert sorted(p.decode() for p in pkgs) == \
                ["big", "busybox", "musl"]
            assert json.loads(pkgs[b"musl"].get(b"CVE-2022-1")) == \
                {"FixedVersion": "1.2.3-r1"}
            assert len(dict(pkgs[b"big"].items())) == 60

    def test_branch_page_descent(self, tmp_path):
        w = bw.Writer()
        leaf1 = w.leaf_page([(0, b"a", b"1"), (0, b"b", b"2")])
        leaf2 = w.leaf_page([(0, b"c", b"3"), (0, b"d", b"4")])
        branch = w.branch_page([(b"a", leaf1), (b"c", leaf2)])
        root = w.leaf_page([(bw.LEAF_FLAG_BUCKET, b"data",
                             w.bucket_value(branch))])
        path = str(tmp_path / "branch.db")
        w.write(path, root)
        with BoltDB(path) as db:
            items = dict(db.bucket(b"data").items())
        assert items == {b"a": b"1", b"b": b"2", b"c": b"3", b"d": b"4"}

    def test_overflow_value(self, tmp_path):
        big = b"x" * (3 * bw.PAGE_SIZE)
        w = bw.Writer()
        leaf = w.leaf_page([(0, b"big", big), (0, b"small", b"s")])
        root = w.leaf_page([(bw.LEAF_FLAG_BUCKET, b"data",
                             w.bucket_value(leaf))])
        path = str(tmp_path / "overflow.db")
        w.write(path, root)
        with BoltDB(path) as db:
            items = dict(db.bucket(b"data").items())
        assert items == {b"big": big, b"small": b"s"}

    def test_not_a_boltdb_and_missing_bucket(self, tmp_path, tiny_db):
        p = tmp_path / "x.db"
        p.write_bytes(b"hello world" * 1000)
        with pytest.raises(CorruptDB):
            BoltDB(str(p))
        with BoltDB(tiny_db) as db:
            assert db.bucket(b"nope") is None

    def test_meta_checksum_rejects_torn_meta(self, tmp_path):
        from trivy_tpu_torch.db.boltdb import PAGE_HEADER
        path = str(tmp_path / "t.db")
        bw.write_trivy_db(path, {"alpine 3.16": {"p": {"CVE-1": {
            "FixedVersion": "1.0"}}}}, {})
        with BoltDB(path) as db:
            good_root = db._root_pgid
        data = bytearray(open(path, "rb").read())
        struct.pack_into("<Q", data, 4096 + PAGE_HEADER + 16, 0xDEAD)
        open(path, "wb").write(bytes(data))
        with BoltDB(path) as db:
            assert db._root_pgid == good_root
        struct.pack_into("<Q", data, PAGE_HEADER + 56, 12345)
        open(path, "wb").write(bytes(data))
        with pytest.raises(CorruptDB):
            BoltDB(path)


def test_boltdb_to_scan_equals_reference(tiny_db, tmp_path, capsys):
    """``db build --from-boltdb`` in both CLIs, then ``sbom`` against
    each package's compiled DB: the same output lines and reports."""
    bom = tmp_path / "bom.cdx.json"
    bom.write_text(json.dumps({
        "bomFormat": "CycloneDX", "specVersion": "1.4", "version": 1,
        "metadata": {"component": {"bom-ref": "root", "type":
                                   "container", "name": "img"}},
        "components": [
            {"bom-ref": "os", "type": "operating-system",
             "name": "alpine", "version": "3.16.0"},
            {"bom-ref": "musl", "type": "library", "name": "musl",
             "version": "1.2.2-r7",
             "purl": "pkg:apk/alpine/musl@1.2.2-r7?distro=3.16.0"},
            {"bom-ref": "dj", "type": "library", "name": "django",
             "version": "4.0.1", "purl": "pkg:pypi/django@4.0.1"}],
        "dependencies": [{"ref": "root", "dependsOn": ["os"]},
                         {"ref": "os", "dependsOn": ["musl"]}]}))
    outs = {}
    for name, main, extra in (
            ("ref", rcli.main, ["--no-cache", "--cache-dir",
                                str(tmp_path / "rc")]),
            ("port", tcli.main, [])):
        prefix = str(tmp_path / f"{name}-cdb")
        assert main(["db", "build", "--from-boltdb", tiny_db,
                     "-o", prefix]) == 0
        said = capsys.readouterr().out.splitlines()
        assert main(["sbom", str(bom), "--compiled-db", prefix,
                     "--backend", "cpu", "--format", "json"] + extra) == 0
        outs[name] = ([ln.split(" in ")[0].split(" (")[0]
                       for ln in said],
                      json.loads(capsys.readouterr().out))
    assert outs["port"] == outs["ref"]
    ids = sorted(v["VulnerabilityID"] for r in outs["port"][1]["Results"]
                 for v in r.get("Vulnerabilities", []))
    assert ids == ["GHSA-aaaa"]
    for main in (rcli.main, tcli.main):
        assert main(["db", "build", "-o", str(tmp_path / "x")]) == 2
        assert main(["db", "build", "--from-boltdb",
                     str(tmp_path / "bom.cdx.json"), "-o",
                     str(tmp_path / "x")]) == 1
        assert main(["db"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert err[:3] == err[3:]


# ---------------------------------------------------- the DB archive

def _tgz(members: list) -> bytes:
    """A gzipped tar of (TarInfo kwargs, data) members."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for kw, data in members:
            ti = tarfile.TarInfo(kw.pop("name"))
            for k, v in kw.items():
                setattr(ti, k, v)
            ti.size = len(data) if ti.isfile() else 0
            tf.addfile(ti, io.BytesIO(data) if ti.isfile() else None)
    return gzip.compress(buf.getvalue())


HOSTILE = {
    "plain": _tgz([({"name": "trivy.db"}, b"bolt"),
                   ({"name": "metadata.json"}, b"{}")]),
    "traversal": _tgz([({"name": "../../etc/trivy.db"}, b"evil"),
                       ({"name": "/abs/metadata.json"}, b"{}")]),
    "symlink": _tgz([({"name": "trivy.db", "type": tarfile.SYMTYPE,
                       "linkname": "/etc/passwd"}, b"")]),
    "hardlink": _tgz([({"name": "x"}, b"1"),
                      ({"name": "metadata.json", "type": tarfile.LNKTYPE,
                        "linkname": "x"}, b"")]),
    "unwanted": _tgz([({"name": "evil.sh"}, b"rm -rf /"),
                      ({"name": "trivy.db"}, b"bolt")]),
    "directory": _tgz([({"name": "trivy.db", "type": tarfile.DIRTYPE},
                        b"")]),
    "bomb": gzip.compress(b"\0" * (8 << 20)),
    "flood": _tgz([({"name": f"f{i}"}, b"") for i in range(80)]),
    "not-gzip": b"just bytes, no archive",
    "truncated": _tgz([({"name": "trivy.db"}, b"b" * 5000)])[:60],
}


def _extract(mod, guard, blob: bytes, dest: str):
    budget = guard.ResourceBudget(guard.ResourceLimits(
        max_decompressed_bytes=1 << 20, max_file_bytes=1 << 20,
        max_files=64, ingest_deadline_s=60.0), name="db-update")
    os.makedirs(dest)
    try:
        written = mod.safe_extract_db_archive(blob, dest, budget)
    except Exception as e:      # noqa: BLE001 — the outcome compared
        return ("raised", type(e).__name__, str(e).replace(dest, "D"))
    return ("ok", written, sorted(
        (n, open(os.path.join(dest, n), "rb").read())
        for n in os.listdir(dest)))


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_hostile_db_archive_ends_as_in_reference(tmp_path, case):
    from trivy_tpu.guard import safetar as rsafe
    from trivy_tpu_torch.guard import safetar as tsafe
    blob = HOSTILE[case]
    ref = _extract(rsafe, rguard, blob, str(tmp_path / "r"))
    port = _extract(tsafe, tguard, blob, str(tmp_path / "t"))
    assert port == ref
    if case in ("plain", "unwanted", "traversal"):
        assert port[0] == "ok"
        assert all(n in ("trivy.db", "metadata.json") for n, _ in port[2])
    if case in ("symlink", "hardlink", "bomb", "flood", "not-gzip",
                "truncated"):
        assert port[0] == "raised"


# ---------------------------------------------------------- lifecycle

def _meta(version=SCHEMA_VERSION, next_update=None, downloaded_at=None):
    return dict(version=version,
                next_update=next_update or datetime.datetime(
                    2019, 9, 1, tzinfo=UTC),
                downloaded_at=downloaded_at or datetime.datetime(
                    2019, 9, 1, tzinfo=UTC))


NEEDS_UPDATE = {
    "first-run": (None, False),
    "first-run-skip": (None, True),
    "newer-schema": (dict(version=SCHEMA_VERSION + 1), False),
    "old-schema": (dict(version=SCHEMA_VERSION - 1), False),
    "old-schema-skip": (dict(version=SCHEMA_VERSION - 1), True),
    "fresh": (dict(next_update=datetime.datetime(2019, 10, 2,
                                                 tzinfo=UTC)), False),
    "stale": (dict(next_update=datetime.datetime(2019, 9, 30,
                                                 tzinfo=UTC)), False),
    "recent-download": (dict(
        next_update=datetime.datetime(2019, 9, 30, tzinfo=UTC),
        downloaded_at=datetime.datetime(2019, 9, 30, 23, 30,
                                        tzinfo=UTC)), False),
    "old-download": (dict(
        next_update=datetime.datetime(2019, 9, 30, tzinfo=UTC),
        downloaded_at=datetime.datetime(2019, 9, 30, 22, 30,
                                        tzinfo=UTC)), False),
    "skip-current": ({}, True),
}


@pytest.mark.parametrize("case", sorted(NEEDS_UPDATE))
def test_needs_update_equals_reference(tmp_path, case):
    meta, skip = NEEDS_UPDATE[case]
    got = {}
    for name, mod in (("ref", rlc), ("port", tlc)):
        d = str(tmp_path / name)
        if meta is not None:
            mod.save_metadata(d, mod.Metadata(**_meta(**meta)))
        try:
            got[name] = mod.needs_update(d, skip=skip, now=NOW)
        except ValueError as e:
            got[name] = ("error", str(e))
    assert got["port"] == got["ref"]


def test_offsetless_timestamps_read_as_utc(tmp_path):
    d = tmp_path / "db"
    d.mkdir()
    (d / "metadata.json").write_text(json.dumps({
        "Version": SCHEMA_VERSION, "NextUpdate": "2099-01-01T00:00:00",
        "DownloadedAt": "2019-09-01T00:00:00"}))
    assert needs_update(str(tmp_path), now=NOW) is False
    assert load_metadata(str(tmp_path)).to_dict() == \
        rlc.load_metadata(str(tmp_path)).to_dict()


def _archive(tmp_path, mod=bw, lc=tlc, with_meta=True) -> bytes:
    bolt = str(tmp_path / "src.db")
    mod.write_trivy_db(bolt, {"alpine 3.9": {"musl": {
        "CVE-2019-14697": {"FixedVersion": "1.1.20-r5"}}}},
        {"CVE-2019-14697": {"Title": "musl libc x87 stack imbalance",
                            "Severity": "CRITICAL",
                            "VendorSeverity": {"nvd": 4}}})
    meta = lc.Metadata(
        version=SCHEMA_VERSION,
        next_update=datetime.datetime(2019, 10, 2, tzinfo=UTC),
        updated_at=datetime.datetime(2019, 10, 1, tzinfo=UTC)) \
        if with_meta else None
    return lc.pack_db_archive(open(bolt, "rb").read(), meta)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_layouts_of_either_package_read_alike(tmp_path, writer):
    mods = {"ref": (rbw, rlc), "port": (bw, tlc)}[writer]
    archive = _archive(tmp_path, *mods)
    assert archive == _archive(tmp_path, *{"ref": (bw, tlc),
                                           "port": (rbw, rlc)}[writer])
    layout = str(tmp_path / "layout")
    mods[1].write_oci_layout(layout, archive)
    blob, title = read_oci_layout(layout)
    assert (blob, title) == rlc.read_oci_layout(layout)
    assert title == "db.tar.gz" and blob == archive
    for name, lc in (("ref", rlc), ("port", tlc)):
        cache = str(tmp_path / f"cache-{name}")
        meta = lc.update_from_oci_layout(layout, cache, now=NOW)
        assert meta.downloaded_at == NOW
    assert load_metadata(str(tmp_path / "cache-port")).to_dict() == \
        rlc.load_metadata(str(tmp_path / "cache-ref")).to_dict()
    assert open(os.path.join(db_dir(str(tmp_path / "cache-port")),
                             "trivy.db"), "rb").read() == \
        open(os.path.join(db_dir(str(tmp_path / "cache-ref")),
                          "trivy.db"), "rb").read()


@pytest.mark.parametrize("tamper", ["media-type", "no-title", "digest",
                                    "two-layers", "bad-digest-path",
                                    "empty-index"])
def test_tampered_layouts_end_as_in_reference(tmp_path, tamper):
    layout = str(tmp_path / "layout")
    write_oci_layout(layout, _archive(tmp_path))
    idx = json.load(open(os.path.join(layout, "index.json")))
    mdigest = idx["manifests"][0]["digest"].split(":")[1]
    mpath = os.path.join(layout, "blobs", "sha256", mdigest)
    manifest = json.load(open(mpath))
    layer = manifest["layers"][0]
    if tamper == "media-type":
        layer["mediaType"] = "application/foo"
    elif tamper == "no-title":
        layer["annotations"] = {}
    elif tamper == "digest":
        layer["digest"] = "sha256:" + "0" * 64
        open(os.path.join(layout, "blobs", "sha256", "0" * 64),
             "wb").write(b"other bytes")
    elif tamper == "two-layers":
        manifest["layers"].append(dict(layer))
    elif tamper == "bad-digest-path":
        layer["digest"] = "sha256:../../etc/passwd"
    open(mpath, "w").write(json.dumps(manifest))
    if tamper == "empty-index":
        json.dump({"manifests": []},
                  open(os.path.join(layout, "index.json"), "w"))
    got = {}
    for name, lc in (("ref", rlc), ("port", tlc)):
        cache = str(tmp_path / f"c-{name}")
        try:
            lc.update_from_oci_layout(layout, cache, now=NOW)
            got[name] = "ok"
        except (OSError, ValueError) as e:
            got[name] = (type(e).__name__, str(e))
        assert not os.path.exists(os.path.join(db_dir(cache), "trivy.db"))
    assert got["port"] == got["ref"] != "ok"


def test_update_keeps_the_old_db_on_a_corrupt_download(tmp_path):
    """A layer whose trivy.db is no BoltDB raises and leaves the
    installed DB, metadata and compiled tables serving."""
    layout = str(tmp_path / "good")
    write_oci_layout(layout, _archive(tmp_path))
    cache = str(tmp_path / "cache")
    update_from_oci_layout(layout, cache, now=NOW)
    compiled = os.path.join(db_dir(cache), "compiled.npz")
    open(compiled, "wb").write(b"tables")
    before = {n: open(os.path.join(db_dir(cache), n), "rb").read()
              for n in os.listdir(db_dir(cache))}
    bad = str(tmp_path / "bad")
    write_oci_layout(bad, pack_db_archive(b"not a bolt file" * 400))
    with pytest.raises(ValueError):
        update_from_oci_layout(bad, cache, now=NOW)
    assert {n: open(os.path.join(db_dir(cache), n), "rb").read()
            for n in os.listdir(db_dir(cache))} == before
    # a good update drops the compiled tables of the old trivy.db
    update_from_oci_layout(layout, cache, now=NOW)
    assert not os.path.exists(compiled)


def _cli(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue(), [
        ln for ln in err.getvalue().splitlines()
        if ln.startswith(("error:", "warning:"))]


@pytest.mark.parametrize("compile_", [False, True])
def test_cli_db_update_then_scan_equals_reference(tmp_path, compile_):
    """``db update --from-oci-layout L --cache-dir D [--compile]`` in
    both CLIs, then ``image`` and ``sbom`` with ``--cache-dir D``:
    the same lines, reports and exit codes, the stale-DB warning
    included; the port's report equals its ``--db-fixtures`` one."""
    layout = str(tmp_path / "layout")
    write_oci_layout(layout, _archive(tmp_path))
    img = e2e.make_image_tar(tmp_path, [{
        "etc/alpine-release": b"3.9.4\n",
        "lib/apk/db/installed": e2e.APK_INSTALLED}])
    fx = tmp_path / "db.yaml"
    fx.write_text(e2e.FIXTURE_DB)
    got = {}
    for name, main in (("ref", rcli.main), ("port", tcli.main)):
        cache = str(tmp_path / f"cache-{name}")
        code, out, said = _cli(main, ["db", "update", "--from-oci-layout",
                                      layout, "--cache-dir", cache]
                               + (["--compile"] if compile_ else []))
        assert code == 0 and not said
        lines = [ln.split(" in ")[0].replace(cache, "D")
                 for ln in out.splitlines()]
        # downloaded long ago, past NextUpdate: stale from here on
        meta = load_metadata(cache)
        meta.downloaded_at = NOW
        save_metadata(cache, meta)
        scans = []
        for argv in (["image", "--input", img],
                     ["sbom", str(tmp_path / "bom.json")]):
            if argv[0] == "sbom" and not os.path.exists(argv[1]):
                json.dump({"bomFormat": "CycloneDX", "specVersion": "1.4",
                           "version": 1, "components": [
                               {"bom-ref": "os", "type": "operating-system",
                                "name": "alpine", "version": "3.9.4"},
                               {"bom-ref": "m", "type": "library",
                                "name": "musl", "version": "1.1.20-r4",
                                "purl": "pkg:apk/alpine/musl@1.1.20-r4"
                                        "?distro=3.9.4"}]},
                          open(argv[1], "w"))
            for extra in ([], ["--skip-db-update"]):
                scans.append(_cli(main, argv + [
                    "--cache-dir", cache, "--no-cache", "--backend",
                    "cpu", "--format", "json"] + extra))
        got[name] = (lines, [(c, json.loads(o), s) for c, o, s in scans])
    assert got["port"] == got["ref"]
    # stale (NextUpdate 2019) without --skip-db-update: the warning
    assert got["port"][1][0][2][0].startswith("warning: advisory DB is stale")
    assert got["port"][1][1][2] == []
    vulns = [v["VulnerabilityID"] for r in got["port"][1][0][1]["Results"]
             for v in r.get("Vulnerabilities") or []]
    assert vulns == ["CVE-2019-14697"]
    fixt = _cli(tcli.main, ["image", "--input", img, "--db-fixtures",
                            str(fx), "--backend", "cpu", "--format",
                            "json", "--severity", "CRITICAL"])
    assert json.loads(fixt[1]) == got["port"][1][1][1]


@pytest.mark.parametrize("case", ["first-run-skip", "newer-schema"])
def test_cli_refuses_an_unusable_installed_db(tmp_path, case):
    cache = str(tmp_path / "cache")
    os.makedirs(db_dir(cache))
    bw.write_trivy_db(os.path.join(db_dir(cache), "trivy.db"), {}, {})
    if case == "newer-schema":
        save_metadata(cache, Metadata(version=SCHEMA_VERSION + 1))
    argv = ["sbom", str(tmp_path / "bom.json"), "--cache-dir", cache,
            "--no-cache", "--backend", "cpu"] + (
                ["--skip-db-update"] if case == "first-run-skip" else [])
    (tmp_path / "bom.json").write_text(json.dumps({
        "bomFormat": "CycloneDX", "specVersion": "1.4", "version": 1,
        "components": []}))
    rcode = None
    try:
        rcode, _, rsaid = _cli(rcli.main, argv)
    except SystemExit as e:
        rcode = e.code
    code, out, said = _cli(tcli.main, argv)
    assert code == rcode == 1 and out == ""
    assert len(said) == 1 and said[0].startswith("error: advisory DB: ")
