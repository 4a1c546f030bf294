"""The port's Rekor lookup (``rekor.py`` and the unpackaged handler)
against the reference's, driven against a stub Rekor service on
127.0.0.1 (mirrors ``tests/test_rekor.py``): entry ids, search, the
entry limit, the clean error of an unreachable log, SBOM discovery,
and an ``fs`` scan with ``TRIVY_REKOR_URL`` whose unpackaged executable
is found in the log, equal to the reference's report."""

import base64
import contextlib
import hashlib
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import trivy_tpu.rekor as rrekor
import trivy_tpu_torch.rekor as trekor
from trivy_tpu.cli import main as rmain
from trivy_tpu_torch.cli import main as tmain

BOTH = [rrekor, trekor]


def executable(seed: int) -> bytes:
    """An ELF-looking file of seeded bytes: the digest analyzer takes it,
    no package analyzer does."""
    rng = np.random.default_rng(seed)
    return b"\x7fELF" + rng.integers(0, 256, 4096, np.uint8).tobytes()


def attested_bom(n_libs: int = 3) -> dict:
    """The CycloneDX BOM that the stub log attests for the executable."""
    comps = [{"type": "library", "name": "lodash", "version": "4.17.11",
              "purl": "pkg:npm/lodash@4.17.11", "bom-ref": "lodash"}]
    comps += [{"type": "library", "name": f"lib{i}", "version": "1.0.0",
               "purl": f"pkg:npm/lib{i}@1.0.0", "bom-ref": f"lib{i}"}
              for i in range(n_libs - 1)]
    return {"bomFormat": "CycloneDX", "specVersion": "1.4", "version": 1,
            "metadata": {"component": {"type": "application",
                                       "name": "tool", "bom-ref": "root"}},
            "components": comps}


class StubRekor:
    """``/api/v1/index/retrieve`` answers ``uuid`` for the known digests
    (or any ``sha256:feed...``), ``/api/v1/log/entries/retrieve`` the
    attestation of each requested id, plus one the client never asked
    for (which it must skip)."""

    def __init__(self, digests=(), bom=None):
        self.uuid = "a" * 64
        self.digests = set(digests)
        pred = {"Data": json.dumps(bom)} if bom is not None else {}
        self.statement = json.dumps({
            "predicateType": "https://cyclonedx.org/bom",
            "predicate": pred}).encode()
        self.requests = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                stub.requests.append((self.path, body))
                if self.path == "/api/v1/index/retrieve":
                    h = body.get("hash", "")
                    out = [stub.uuid] if h in stub.digests or \
                        h.startswith("sha256:feed") else []
                else:
                    att = {"attestation": {"data": base64.b64encode(
                        stub.statement).decode()}}
                    out = [{u: att} for u in body.get("entryUUIDs", [])]
                    out.append({"b" * 64: att})
                data = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def stub():
    s = StubRekor(bom=attested_bom())
    yield s
    s.close()


@pytest.mark.parametrize("mod", BOTH, ids=["ref", "port"])
def test_entry_id_parse_forms(mod):
    long = mod.EntryID.parse("1" * 16 + "a" * 64)
    assert (long.tree_id, long.uuid) == ("1" * 16, "a" * 64)
    assert str(long) == "1" * 16 + "a" * 64
    short = mod.EntryID.parse("b" * 64)
    assert (short.tree_id, short.uuid) == ("", "b" * 64)
    with pytest.raises(mod.RekorError):
        mod.EntryID.parse("zzz")


def test_search_and_get_entries_equal_reference(stub):
    got, want = trekor.Client(stub.url), rrekor.Client(stub.url)
    for h in ("sha256:feedface", "sha256:other"):
        assert [str(e) for e in got.search(h)] == \
            [str(e) for e in want.search(h)]
    ids = got.search("sha256:feedface")
    assert len(ids) == 1
    entries = got.get_entries(ids)
    # the unrequested entry is skipped
    assert [e.statement for e in entries] == [stub.statement]
    assert [e.statement for e in want.get_entries(
        want.search("sha256:feedface"))] == [stub.statement]
    assert got.get_entries([]) == []


@pytest.mark.parametrize("mod", BOTH, ids=["ref", "port"])
def test_entry_limit(stub, mod):
    with pytest.raises(mod.RekorError, match="limit"):
        mod.Client(stub.url).get_entries(
            [mod.EntryID(uuid="c" * 64)] * (mod.MAX_GET_ENTRIES + 1))


@pytest.mark.parametrize("mod", BOTH, ids=["ref", "port"])
def test_unreachable_is_clean_error(mod):
    with pytest.raises(mod.RekorError, match="egress"):
        mod.Client("http://127.0.0.1:1", timeout_s=0.5).search("sha256:x")


def test_discover_sbom_equals_reference(stub):
    got = trekor.discover_sbom(trekor.Client(stub.url), "sha256:feedface")
    want = rrekor.discover_sbom(rrekor.Client(stub.url), "sha256:feedface")
    assert got is not None and want is not None
    assert [a.to_dict() for a in got.applications] == \
        [a.to_dict() for a in want.applications]
    assert sorted(p.name for a in got.applications
                  for p in a.libraries) == ["lib0", "lib1", "lodash"]
    assert trekor.discover_sbom(trekor.Client(stub.url),
                                "sha256:none") is None


def _fixtures(tmp_path) -> str:
    docs = [{"bucket": "npm::GitHub Security Advisory npm", "pairs": [
                {"bucket": "lodash", "pairs": [
                    {"key": "CVE-2019-10744", "value": {
                        "VulnerableVersions": ["<4.17.12"],
                        "PatchedVersions": ["4.17.12"]}}]}]},
            {"bucket": "vulnerability", "pairs": [
                {"key": "CVE-2019-10744", "value": {
                    "Title": "prototype pollution",
                    "Severity": "CRITICAL"}}]}]
    path = tmp_path / "db.yaml"
    path.write_text(json.dumps(docs))
    return str(path)


def _run(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue()


def _norm(text: str) -> str:
    return json.dumps(json.loads(text), sort_keys=True)


def test_fs_scan_finds_the_attested_sbom(tmp_path, monkeypatch):
    """``fs DIR`` with ``TRIVY_REKOR_URL``: the executable no package
    manager owns is looked up by digest, its attested BOM's packages
    join the report, and the report equals the reference's; without
    the URL neither package looks anything up."""
    tree = tmp_path / "tree"
    exe = executable(14)
    for rel, data in (("usr/local/bin/tool", exe),
                      ("usr/local/bin/other", executable(15)),
                      ("etc/alpine-release", b"3.9.4\n")):
        os.makedirs(tree / os.path.dirname(rel), exist_ok=True)
        (tree / rel).write_bytes(data)
    digest = "sha256:" + hashlib.sha256(exe).hexdigest()
    s = StubRekor(digests=[digest], bom=attested_bom())
    monkeypatch.chdir(tmp_path)
    try:
        argv = ["fs", str(tree), "--format", "json", "--backend", "cpu",
                "--db-fixtures", _fixtures(tmp_path),
                "--security-checks", "vuln"]
        monkeypatch.setenv("TRIVY_REKOR_URL", s.url)
        rcode, want = _run(rmain, argv + ["--no-cache"])
        asked = [b.get("hash") for p, b in s.requests
                 if p == "/api/v1/index/retrieve"]
        s.requests.clear()
        tcode, got = _run(tmain, argv)
        assert sorted(asked) == sorted(
            b.get("hash") for p, b in s.requests
            if p == "/api/v1/index/retrieve")
        assert len(asked) == 2 and digest in asked
        assert (tcode, _norm(got)) == (rcode, _norm(want)) == (0, _norm(want))
        ids = [v["VulnerabilityID"] for r in json.loads(got)["Results"]
               for v in r.get("Vulnerabilities") or []]
        assert ids == ["CVE-2019-10744"]
        # a log that is down costs the lookup, never the scan
        monkeypatch.setenv("TRIVY_REKOR_URL", "http://127.0.0.1:1")
        rcode, want = _run(rmain, argv + ["--no-cache"])
        tcode, got = _run(tmain, argv)
        assert (tcode, _norm(got)) == (rcode, _norm(want))
        monkeypatch.delenv("TRIVY_REKOR_URL")
        s.requests.clear()
        assert _run(tmain, argv)[0] == 0 and s.requests == []
    finally:
        s.close()
