"""The registry client and the local registry:
``trivy_tpu_torch.artifact.registry`` and ``artifact.localreg`` against
the JAX package's, each fed the same inputs on the CPU.

The JAX package's ``tests/test_registry.py::FakeRegistry`` (one repo, a
manifest list with amd64 and arm64 entries, optional Bearer auth)
serves both clients: ``parse_ref``, the token handshake, the platform
select, the digest checks of a pinned manifest, a selected one and a
blob, and the layout ``pull`` writes must give the same image, or the
same error type and message. The resumable ``fetch_blob`` runs against
both packages' ``LocalRegistry`` with a seeded chunk-drop injector
(duck-typed ``on_blob_chunk``), with and without ``Range`` support;
the retries run against a registry that answers 503 with
``Retry-After`` before it answers."""

import hashlib
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import trivy_tpu.artifact.localreg as rlocalreg
import trivy_tpu.artifact.registry as rregistry
import trivy_tpu.artifact.stream as rstream
import trivy_tpu_torch.artifact.localreg as tlocalreg
import trivy_tpu_torch.artifact.registry as tregistry
import trivy_tpu_torch.artifact.stream as tstream
from tests.test_registry import FakeRegistry

PKGS = {"ref": (rregistry, rlocalreg, rstream),
        "port": (tregistry, tlocalreg, tstream)}


@pytest.fixture(autouse=True)
def _fresh_ingest_state():
    for _, _, stream in PKGS.values():
        stream.INGEST_METRICS.reset()
    yield
    for _, _, stream in PKGS.values():
        stream.INGEST_METRICS.reset()


def _both(fn) -> dict:
    """``fn(pkg)`` per package: ("ok", value) or (error type, message)."""
    out = {}
    for name in PKGS:
        try:
            out[name] = ("ok", fn(name))
        except Exception as e:      # noqa: BLE001 — compared below
            out[name] = (type(e).__name__, str(e))
    return out


def _image(src) -> tuple:
    """What a pulled image is: its metadata and every layer's files."""
    layers = []
    for la in src.layers:
        with la.open() as tf:
            layers.append(sorted((m.name, tf.extractfile(m).read())
                                 for m in tf.getmembers() if m.isfile()))
    return (src.name, src.id, src.config, src.diff_ids, src.repo_tags,
            src.repo_digests, layers)


def _pull(pkg: str, ref: str, **kwargs) -> tuple:
    src = PKGS[pkg][0].DistributionClient(**kwargs).pull(ref)
    try:
        return _image(src)
    finally:
        src.cleanup()


@pytest.fixture
def fake():
    reg = FakeRegistry().start()
    yield reg
    reg.stop()


@pytest.fixture
def fake_auth():
    reg = FakeRegistry(require_auth=True).start()
    yield reg
    reg.stop()


@pytest.mark.parametrize("ref", [
    "alpine", "alpine:3.16", "library/alpine:3.16", "org/app:1",
    "ghcr.io/org/app", "localhost/app:2",
    "127.0.0.1:5000/org/app@sha256:" + "a" * 64,
    "127.0.0.1:5000/a/b/c:tag@sha256:" + "b" * 64, ":nope", "reg.io/"])
def test_parse_ref_equals_reference(ref):
    got = _both(lambda pkg: PKGS[pkg][0].parse_ref(ref))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("registry,repo", [
    ("index.docker.io", "library/alpine"), ("docker.io", "org/app"),
    ("127.0.0.1:5000", "org/app")])
def test_display_repo_equals_reference(registry, repo):
    assert tregistry._display_repo(registry, repo) == \
        rregistry._display_repo(registry, repo)


@pytest.mark.parametrize("tag", ["1.0", "multi", "digest"])
def test_pull_equals_reference(fake, tag):
    """A tag, a manifest list (the amd64 entry) and a digest-pinned
    manifest: the same layout, image, tags and digests."""
    if tag == "digest":
        tag = "@" + next(k for k in fake.manifests if k.startswith("sha"))
    else:
        tag = ":" + tag
    ref = f"127.0.0.1:{fake.port}/org/app{tag}"
    got = _both(lambda pkg: _pull(pkg, ref, platform="linux/amd64"))
    assert got["port"] == got["ref"] and got["port"][0] == "ok"
    name, _, _, _, tags, digests, layers = got["port"][1]
    assert name == ref and digests and layers[0]
    assert tags == ([] if "@" in ref else [ref])


def test_token_handshake_equals_reference(fake_auth):
    """A 401 with a Bearer challenge: the client fetches a token from
    the realm with its basic credentials, once per registry, and the
    pull goes on; wrong credentials end in the 401."""
    ref = f"127.0.0.1:{fake_auth.port}/org/app:1.0"
    seen = {}

    def pull(pkg):
        c = PKGS[pkg][0].DistributionClient(auth=("u", "p"))
        src = c.pull(ref)
        try:
            seen[pkg] = dict(c._bearer)
            return _image(src)
        finally:
            src.cleanup()

    got = _both(pull)
    assert got["port"] == got["ref"] and got["port"][0] == "ok"
    assert seen["port"] == seen["ref"] == {
        f"127.0.0.1:{fake_auth.port}": fake_auth.token}
    bad = _both(lambda pkg: _pull(pkg, ref, auth=("u", "wrong")))
    assert bad["port"] == bad["ref"] and "401" in bad["port"][1]


def test_platform_select_equals_reference(fake):
    ref = f"127.0.0.1:{fake.port}/org/app:multi"
    got = _both(lambda pkg: _pull(pkg, ref, platform="linux/s390x"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == "RegistryError" and "platform" in got["port"][1]


def _tamper_pinned(fake):
    bogus = "sha256:" + "b" * 64
    fake.manifests[bogus] = fake.manifests["1.0"]
    return "@" + bogus


def _tamper_selected(fake):
    mdigest = next(k for k in fake.manifests if k.startswith("sha256:"))
    ctype, body = fake.manifests[mdigest]
    fake.manifests[mdigest] = (ctype, body + b" ")
    return ":multi"


def _tamper_blob(fake):
    k = next(iter(fake.blobs))
    fake.blobs[k] = fake.blobs[k] + b"tamper"
    return ":1.0"


def _unsupported_algo(fake):
    return "@sha512:" + "c" * 128


@pytest.mark.parametrize("tamper", [_tamper_pinned, _tamper_selected,
                                    _tamper_blob, _unsupported_algo])
def test_digest_checks_equal_reference(fake, tamper):
    """A pinned manifest that does not hash to its digest, a manifest
    list's selected manifest altered, a blob altered, and a digest of
    another algorithm: each fails, with the reference's error."""
    ref = f"127.0.0.1:{fake.port}/org/app" + tamper(fake)
    got = _both(lambda pkg: _pull(pkg, ref, platform="linux/amd64"))
    assert got["port"] == got["ref"]
    assert got["port"][0] in ("RegistryError", "ValueError")


def test_layout_index_records_the_image_manifest(fake, monkeypatch,
                                                 tmp_path):
    """``pull`` writes an OCI layout whose index names the resolved
    image manifest (not the list it started from)."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref = f"127.0.0.1:{fake.port}/org/app:multi"
    idx = {}
    for pkg in PKGS:
        src = PKGS[pkg][0].DistributionClient().pull(ref)
        (layout,) = [p for p in os.listdir(tmp_path)
                     if p.startswith("trivy-tpu-pull-")]
        idx[pkg] = json.load(open(tmp_path / layout / "index.json"))
        src.cleanup()
    assert idx["port"] == idx["ref"]
    assert idx["port"]["manifests"][0]["mediaType"] == rregistry.MT_MANIFEST


class Dropper:
    """A seeded chunk-drop injector (duck-typed ``on_blob_chunk``): it
    drops the stream at the chunk offsets drawn from ``seed``, each
    once, as a registry that cuts a response mid-body would."""

    def __init__(self, size: int, seed: int, drops: int = 2):
        rng = np.random.default_rng(seed)
        self.at = sorted({int(x) for x in rng.integers(1, size, drops)})
        self.done = set()

    def on_blob_chunk(self, digest: str, offset: int) -> None:
        for a in self.at:
            if a not in self.done and offset >= a:
                self.done.add(a)
                raise ConnectionResetError(f"dropped at {offset}")


@pytest.mark.parametrize("range_support", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_resumable_fetch_equals_reference(range_support, seed):
    """Streams cut mid-body: with ``Range`` the fetch resumes from its
    offset (206), without it the sink is rewound and the blob fetched
    again from 0; the bytes, the restarts, the ingest counters and the
    registry's counters are the reference's."""
    data = np.random.default_rng(seed).integers(
        0, 256, 3 << 19, dtype=np.uint8).tobytes()
    out = {}
    for pkg, (registry, localreg, stream) in PKGS.items():
        reg = localreg.LocalRegistry(range_support=range_support)
        desc = reg.put_blob(data)
        reg.start()
        try:
            c = registry.DistributionClient(backoff_s=0.01,
                                            backoff_max_s=0.02)
            c.fault_injector = Dropper(len(data), seed)
            buf, restarts = io.BytesIO(), []

            def restart():
                restarts.append(buf.tell())
                buf.seek(0)
                buf.truncate()

            n = c.fetch_blob(reg.host, "blobs/unit", desc["digest"],
                             buf.write, restart, chunk=1 << 16)
            out[pkg] = (n, hashlib.sha256(buf.getvalue()).hexdigest(),
                        restarts, stream.INGEST_METRICS.snapshot(),
                        {k: v for k, v in reg.snapshot().items()
                         if k != "bytes_served"})
        finally:
            reg.stop()
    assert out["port"] == out["ref"]
    n, digest, restarts, metrics, counters = out["port"]
    assert n == len(data) and digest == hashlib.sha256(data).hexdigest()
    if range_support:
        assert metrics["range_resumes"] == 2 and restarts == []
    else:
        assert metrics["full_restarts"] >= 1 and restarts
        assert counters["range_rejected"] >= 1


class Flaky:
    """A registry that answers ``fail`` 503s with ``Retry-After: 0``
    before it serves a manifest (404 for anything else)."""

    def __init__(self, fail: int, status: int = 503):
        self.left, self.status, self.hits = fail, status, 0
        flaky = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):   # noqa: N802 — stdlib name
                flaky.hits += 1
                if flaky.left > 0:
                    flaky.left -= 1
                    self.send_response(flaky.status)
                    self.send_header("Retry-After", "0")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                body = b'{"schemaVersion": 2}'
                self.send_response(200 if "manifests" in self.path
                                   else 404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.host = f"127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("fail,status,retries", [
    (2, 503, 3), (4, 503, 3), (1, 429, 1), (1, 404, 3), (0, 503, 0)])
def test_retries_equal_reference(fail, status, retries):
    """Transient answers (429, 5xx) are retried with the registry's
    ``Retry-After`` until the budget runs out; any other 4xx fails on
    its first answer. The same attempts, the same result or error."""
    out = {}
    for pkg in PKGS:
        reg = Flaky(fail, status)
        try:
            c = PKGS[pkg][0].DistributionClient(retries=retries,
                                                backoff_s=0.01)
            try:
                got = ("ok", c._get(reg.host,
                                    "/v2/org/app/manifests/1")[1])
            except Exception as e:  # noqa: BLE001 — compared below
                got = (type(e).__name__, str(e))
            out[pkg] = (got, reg.hits)
        finally:
            reg.stop()
    assert out["port"] == out["ref"]
    ok = fail <= retries and status != 404
    assert (out["port"][0][0] == "ok") == ok


def test_unreachable_registry_equals_reference():
    got = _both(lambda pkg: PKGS[pkg][0].DistributionClient(
        retries=1, backoff_s=0.01).pull("127.0.0.1:9/org/app:1"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == "RegistryError" and \
        "unreachable" in got["port"][1]


def test_local_registry_serves_as_reference(tmp_path):
    """The port's ``LocalRegistry`` turns a docker-save tar into the
    same manifest and blobs as the reference's, and counts the same
    requests: a tag, a digest, a blob, a range, a bad range (416)."""
    from chip_smoke import write_docker_save
    path = write_docker_save(str(tmp_path / "img.tar"), [
        [("etc/alpine-release", b"3.16.2\n")],
        [("srv/app/a.txt", b"x" * 70000)]])
    out = {}
    for pkg, (registry, localreg, _) in PKGS.items():
        reg = localreg.LocalRegistry()
        mdigest = reg.add_image("org/app", "1", path)
        reg.start()
        try:
            c = registry.DistributionClient(retries=0)
            _, body = c._get(reg.host, "/v2/org/app/manifests/1")
            _, again = c._get(reg.host, f"/v2/org/app/manifests/{mdigest}")
            man = json.loads(body)
            blob = man["layers"][1]["digest"]
            buf = io.BytesIO()
            c.fetch_blob(reg.host, "org/app", blob, buf.write,
                         lambda: None)
            import urllib.error
            import urllib.request
            url = f"http://{reg.host}/v2/org/app/blobs/{blob}"
            req = urllib.request.Request(url,
                                         headers={"Range": "bytes=100-"})
            with urllib.request.urlopen(req) as r:
                part = (r.status, r.headers["Content-Range"], r.read())
            req = urllib.request.Request(
                url, headers={"Range": "bytes=999999999-"})
            try:
                urllib.request.urlopen(req)
                bad = None
            except urllib.error.HTTPError as e:
                bad = (e.code, e.headers["Content-Range"])
            out[pkg] = (mdigest, body, again, sorted(reg.blobs),
                        buf.getvalue() == reg.blobs[blob], part, bad,
                        reg.snapshot())
        finally:
            reg.stop()
    assert out["port"] == out["ref"]
    assert out["port"][6][0] == 416 and out["port"][4]
