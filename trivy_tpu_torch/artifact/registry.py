"""OCI Distribution (registry v2) client — the registry leg of
``resolve.py`` (reference: ``trivy_tpu/artifact/registry.py``, which
mirrors trivy's pkg/fanal/image/remote.go and its token auth).

A Bearer-token handshake driven by the registry's ``WWW-Authenticate``
challenge, manifest-list platform selection, the digest check of a
pinned manifest, and blob pulls that resume torn streams with
``Range`` and retry transient answers with full jitter
(``utils/backoff.py``). ``pull`` lands the image in a local OCI layout
directory and loads it through the same ``load_image`` as any other
layout, so the client is transport only; ``stream.py`` drives the
same ``fetch_blob`` engine to scan while pulling.

Scheme selection follows go-containerregistry: localhost /
127.0.0.0/8 registries speak plain HTTP; everything else HTTPS
(``insecure`` skips TLS verification). Without network egress only
loopback registries are reachable — the tests and ``chip_smoke.py``
serve from ``localreg.LocalRegistry`` on 127.0.0.1 — and a real
registry takes the same code path unchanged. Host only: nothing here
touches the card.
"""

from __future__ import annotations

import atexit
import base64
import hashlib
import http.client
import json
import logging
import os
import shutil
import ssl
import tempfile
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from .image import ImageSource, load_image

log = logging.getLogger("trivy_tpu_torch.artifact.registry")

MT_MANIFEST = "application/vnd.docker.distribution.manifest.v2+json"
MT_MANIFEST_LIST = \
    "application/vnd.docker.distribution.manifest.list.v2+json"
MT_OCI_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
MT_OCI_INDEX = "application/vnd.oci.image.index.v1+json"
_ACCEPT = ", ".join(
    (MT_MANIFEST, MT_MANIFEST_LIST, MT_OCI_MANIFEST, MT_OCI_INDEX))


class RegistryError(ValueError):
    pass


def _ingest_metrics():
    # lazy: stream.py imports this module at its top, so the reverse
    # edge must resolve at call time, not import time
    from .stream import INGEST_METRICS
    return INGEST_METRICS


def parse_ref(ref: str) -> tuple:
    """'host[:port]/repo[:tag][@digest]' → (registry, repository,
    reference). Docker-Hub-style shorthand gets the reference
    defaults (index.docker.io, library/ prefix)."""
    digest = ""
    if "@" in ref:
        ref, _, digest = ref.partition("@")
    tag = ""
    head, _, maybe_tag = ref.rpartition(":")
    if head and "/" not in maybe_tag:
        ref, tag = head, maybe_tag
    parts = ref.split("/")
    if len(parts) == 1 or (
            "." not in parts[0] and ":" not in parts[0]
            and parts[0] != "localhost"):
        registry = "index.docker.io"
        repo = "/".join(parts)
        if "/" not in repo:
            repo = f"library/{repo}"
    else:
        registry = parts[0]
        repo = "/".join(parts[1:])
    if not repo:
        raise RegistryError(f"no repository in image ref {ref!r}")
    return registry, repo, digest or tag or "latest"


def _display_repo(registry: str, repo: str) -> str:
    """Familiar repository name (remote.go RepositoryName /
    go-containerregistry name): the default registry is omitted and
    its library/ prefix trimmed — `alpine:3.10`, not
    `index.docker.io/library/alpine:3.10`."""
    if registry in ("index.docker.io", "docker.io",
                    "registry-1.docker.io"):
        return repo.removeprefix("library/")
    return f"{registry}/{repo}"


def _is_loopback(registry: str) -> bool:
    host = registry.split(":")[0]
    return host in ("localhost", "::1") or host.startswith("127.")


# transient statuses retried with exponential backoff + jitter
# (go-containerregistry's retry transport does the same set);
# every other 4xx is authoritative and fails fast
RETRYABLE_STATUSES = (429, 500, 502, 503, 504)


class DistributionClient:
    """Plugs into resolve_image's registry seam
    (artifact/resolve.py RegistryClient interface).

    Both HTTP legs — the token handshake and manifest/blob GETs —
    run behind bounded retries: up to ``retries`` extra attempts on
    429/5xx/URLError with exponential backoff and full jitter,
    honoring ``Retry-After`` when the registry sends one. A flaky
    registry or throttling edge therefore costs latency, not the
    scan; a 404/401 still fails on the first answer."""

    def __init__(self, platform: str = "linux/amd64",
                 insecure: bool = False,
                 auth: Optional[tuple] = None,
                 registry_token: str = "",
                 retries: int = 3,
                 backoff_s: float = 0.2,
                 backoff_max_s: float = 5.0):
        self.platform = platform
        self.insecure = insecure
        self.auth = auth                    # (user, password) or None
        self.registry_token = registry_token
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self._bearer: dict = {}             # registry → token
        # optional faults/inject.FaultInjector: consulted once per
        # blob chunk by the streaming fetch engine so the flaky-
        # registry scenario can drop streams mid-body
        self.fault_injector = None

    # ---- transport ----

    def _open_once(self, url: str, headers: dict) -> tuple:
        req = urllib.request.Request(url, headers=headers)
        ctx = None
        if url.startswith("https:") and self.insecure:
            ctx = ssl._create_unverified_context()
        try:
            resp = urllib.request.urlopen(req, timeout=30,
                                          context=ctx)
            return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()
        except (urllib.error.URLError, OSError,
                http.client.HTTPException) as e:
            # HTTPException covers IncompleteRead — a server closing
            # mid-body is a connection failure, not an HTTP answer
            raise RegistryError(f"registry unreachable: {e!r}")

    def _backoff(self, attempt: int, hdrs: Optional[dict]) -> None:
        from ..utils.backoff import (full_jitter_delay,
                                     parse_retry_after)
        retry_after = ""
        for k, v in (hdrs or {}).items():
            if k.lower() == "retry-after":
                retry_after = v
                break
        # the registry's Retry-After is honored (clamped to this
        # client's own ceiling); otherwise full jitter — a retrying
        # fleet must not re-synchronize onto the throttled registry.
        # One shared policy implementation (utils/backoff.py) for
        # this client and rpc/client.py
        hint = parse_retry_after(retry_after)
        if hint is not None:
            delay = min(hint, self.backoff_max_s)
        else:
            delay = full_jitter_delay(attempt, self.backoff_s,
                                      self.backoff_max_s)
        time.sleep(delay)

    def _open(self, url: str, headers: dict) -> tuple:
        for attempt in range(self.retries + 1):
            try:
                status, hdrs, body = self._open_once(url, headers)
            except RegistryError:
                # connection-level failure (URLError): transient
                # until the retry budget says otherwise
                if attempt >= self.retries:
                    raise
                self._backoff(attempt, None)
                continue
            if status in RETRYABLE_STATUSES and \
                    attempt < self.retries:
                log.debug("retrying %s after HTTP %d "
                          "(attempt %d/%d)", url, status,
                          attempt + 1, self.retries)
                self._backoff(attempt, hdrs)
                continue
            return status, hdrs, body
        raise RegistryError(f"retries exhausted for {url}")

    def _base(self, registry: str) -> str:
        scheme = "http" if _is_loopback(registry) else "https"
        return f"{scheme}://{registry}"

    def _auth_headers(self, registry: str, accept: str) -> dict:
        headers = {"Accept": accept}
        token = self.registry_token or self._bearer.get(registry)
        if token:
            headers["Authorization"] = f"Bearer {token}"
        elif self.auth:
            cred = base64.b64encode(
                f"{self.auth[0]}:{self.auth[1]}".encode()).decode()
            headers["Authorization"] = f"Basic {cred}"
        return headers

    def _get(self, registry: str, path: str,
             accept: str = _ACCEPT) -> tuple:
        url = self._base(registry) + path
        headers = self._auth_headers(registry, accept)
        status, hdrs, body = self._open(url, headers)
        if status == 401 and not self.registry_token:
            challenge = next(
                (v for k, v in hdrs.items()
                 if k.lower() == "www-authenticate"), "")
            token = self._fetch_token(challenge)
            if token:
                self._bearer[registry] = token
                headers["Authorization"] = f"Bearer {token}"
                status, hdrs, body = self._open(url, headers)
        if status != 200:
            raise RegistryError(
                f"GET {path}: HTTP {status}: "
                f"{body[:200].decode('utf-8', 'replace')}")
        return hdrs, body

    def _fetch_token(self, challenge: str) -> str:
        """Bearer handshake (ref pkg/fanal/image/token + go-containerregistry
        transport): parse realm/service/scope from WWW-Authenticate,
        GET the realm with optional basic credentials."""
        if not challenge.lower().startswith("bearer"):
            return ""
        params = {}
        for part in challenge[len("bearer"):].split(","):
            k, _, v = part.strip().partition("=")
            params[k.lower()] = v.strip('"')
        realm = params.get("realm")
        if not realm:
            return ""
        q = {k: v for k, v in params.items()
             if k in ("service", "scope") and v}
        url = realm + ("?" + urllib.parse.urlencode(q) if q else "")
        headers = {}
        if self.auth:
            cred = base64.b64encode(
                f"{self.auth[0]}:{self.auth[1]}".encode()).decode()
            headers["Authorization"] = f"Basic {cred}"
        status, _, body = self._open(url, headers)
        if status != 200:
            return ""
        try:
            doc = json.loads(body)
        except ValueError:
            return ""
        return doc.get("token") or doc.get("access_token") or ""

    def fetch_blob(self, registry: str, repo: str, digest: str,
                   write, restart, chunk: int = 1 << 20) -> int:
        """Resumable streaming blob GET — the engine under both the
        materialize path (:meth:`_stream_blob`) and the streaming
        ingest pipeline (``artifact/stream.py``).

        Each chunk is pushed to ``write(bytes)`` as it arrives; the
        sha256 over the compressed stream is kept incrementally and
        checked against the digest at EOF. On a retryable mid-body
        drop the retry sends ``Range: bytes={offset}-``: a 206
        answer resumes the stream with the hash state intact, while
        a 200 (or a Content-Range that doesn't match) means the
        registry rejected/ignored the range — ``restart()`` is
        called so the sink rewinds and the fetch rewrites from
        offset zero. An exception raised by ``write`` (a guard
        budget trip, typically) is NOT caught here: it propagates
        immediately, closing the response — the remaining body is
        cancelled, not drained. Returns the blob's byte size."""
        from ..guard.safetar import validate_digest
        # the digest comes from a (possibly malicious) registry's
        # manifest — validate before it touches the URL (or, in the
        # _stream_blob wrapper, the filesystem)
        validate_digest(digest)
        url = self._base(registry) + f"/v2/{repo}/blobs/{digest}"
        base_headers = self._auth_headers(
            registry, "application/octet-stream")
        ctx = None
        if url.startswith("https:") and self.insecure:
            ctx = ssl._create_unverified_context()
        want_hex = digest.partition(":")[2]
        injector = self.fault_injector
        h = hashlib.sha256()
        offset = 0
        for attempt in range(self.retries + 1):
            headers = dict(base_headers)
            resuming = offset > 0
            if resuming:
                headers["Range"] = f"bytes={offset}-"
            try:
                req = urllib.request.Request(url, headers=headers)
                with urllib.request.urlopen(req, timeout=30,
                                            context=ctx) as resp:
                    crange = resp.headers.get("Content-Range", "")
                    if resuming and (
                            resp.status != 206 or not
                            crange.startswith(f"bytes {offset}-")):
                        # range rejected/ignored → offset-0 rewrite
                        restart()
                        h = hashlib.sha256()
                        offset = 0
                        resuming = False
                        _ingest_metrics().inc("full_restarts")
                    elif resuming:
                        _ingest_metrics().inc("range_resumes")
                    while True:
                        data = resp.read(chunk)
                        if not data:
                            break
                        if injector is not None:
                            # a raised fault is the chunk being lost
                            # in transit: nothing below runs
                            injector.on_blob_chunk(digest, offset)
                        h.update(data)
                        write(data)
                        offset += len(data)
                if h.hexdigest() != want_hex:
                    raise RegistryError(
                        f"blob {digest} digest mismatch")
                return offset
            except urllib.error.HTTPError as e:
                if e.code == 416 and resuming and \
                        attempt < self.retries:
                    # Range Not Satisfiable: forget the offset and
                    # rewrite — costs one attempt like any retry
                    restart()
                    h = hashlib.sha256()
                    offset = 0
                    _ingest_metrics().inc("full_restarts")
                    self._backoff(attempt, dict(e.headers))
                    continue
                if e.code in RETRYABLE_STATUSES and \
                        attempt < self.retries:
                    self._backoff(attempt, dict(e.headers))
                    continue
                raise RegistryError(
                    f"GET blob {digest}: HTTP {e.code}")
            except (urllib.error.URLError, OSError,
                    http.client.HTTPException) as e:
                # IncompleteRead (a dropped stream mid-body) lands
                # here — retried like any other connection failure,
                # resuming from the current offset
                if attempt < self.retries:
                    self._backoff(attempt, None)
                    continue
                raise RegistryError(f"registry unreachable: {e!r}")
        raise RegistryError(f"retries exhausted for blob {digest}")

    def _stream_blob(self, registry: str, repo: str, digest: str,
                     blob_dir: str, chunk: int = 1 << 20) -> None:
        """GET a blob streaming straight into the layout's blob
        store, verifying the digest incrementally (a thin file sink
        over :meth:`fetch_blob`, which handles Range resume on torn
        streams — a drop mid-body costs one round trip, not the
        bytes already on disk)."""
        from ..guard.safetar import validate_digest
        validate_digest(digest)
        out_path = os.path.join(blob_dir, digest.partition(":")[2])
        with open(out_path, "wb") as out:
            def restart():
                out.seek(0)
                out.truncate()

            self.fetch_blob(registry, repo, digest, out.write,
                            restart, chunk=chunk)

    # ---- pull ----

    def _select_platform(self, index: dict) -> str:
        want_os, _, want_arch = self.platform.partition("/")
        for m in index.get("manifests") or []:
            p = m.get("platform") or {}
            if p.get("os") == want_os and \
                    p.get("architecture") == want_arch:
                return m["digest"]
        raise RegistryError(
            f"no manifest for platform {self.platform!r}")

    @staticmethod
    def _verify_manifest(body: bytes, reference: str) -> None:
        # A digest reference pins content: validate sha256(body)
        # before trusting any digests inside it (go-containerregistry
        # remote does the same; without this a misbehaving registry
        # can serve arbitrary content for a pinned digest).
        if ":" not in reference:
            return                       # tag reference — nothing pinned
        algo = reference.partition(":")[0]
        if algo != "sha256":
            # fail closed: skipping verification would reopen the hole
            raise RegistryError(
                f"unsupported digest algorithm {algo!r}")
        got = hashlib.sha256(body).hexdigest()
        if got != reference.partition(":")[2]:
            raise RegistryError(
                f"manifest digest mismatch: want {reference}, "
                f"got sha256:{got}")

    def resolve_manifest(self, ref: str) -> tuple:
        """``ref`` → ``(registry, repo, reference, manifest,
        served_digest, ctype, body)``: the manifest GET, digest pin
        and platform selection that :meth:`pull` and the streaming
        ingest path (``artifact/stream.py``) share."""
        registry, repo, reference = parse_ref(ref)
        hdrs, body = self._get(
            registry, f"/v2/{repo}/manifests/{reference}")
        self._verify_manifest(body, reference)
        # the digest of the manifest the registry served for the
        # ORIGINAL reference — for a multi-arch tag that is the
        # index digest, the same digest docker records
        # (remote.go:95-98 descriptor.Digest)
        served_digest = "sha256:" + hashlib.sha256(body).hexdigest()
        ctype = (hdrs.get("Content-Type") or "").split(";")[0]
        manifest = json.loads(body)
        if ctype in (MT_MANIFEST_LIST, MT_OCI_INDEX) or \
                "manifests" in manifest:
            digest = self._select_platform(manifest)
            hdrs, body = self._get(
                registry, f"/v2/{repo}/manifests/{digest}")
            self._verify_manifest(body, digest)
            manifest = json.loads(body)
            # the resolved image manifest, not the list we started
            # from, is what callers must describe/load
            ctype = (hdrs.get("Content-Type") or "").split(";")[0]
        return (registry, repo, reference, manifest, served_digest,
                ctype, body)

    def pull(self, ref: str, budget=None) -> ImageSource:
        (registry, repo, reference, manifest, served_digest, ctype,
         body) = self.resolve_manifest(ref)

        layout = tempfile.mkdtemp(prefix="trivy-tpu-pull-")
        blob_dir = os.path.join(layout, "blobs", "sha256")
        os.makedirs(blob_dir)

        def put(data: bytes) -> str:
            hexd = hashlib.sha256(data).hexdigest()
            with open(os.path.join(blob_dir, hexd), "wb") as f:
                f.write(data)
            return f"sha256:{hexd}"

        def fetch_blob(digest: str) -> None:
            # stream to disk with incremental digest — layers can be
            # multi-GB and must never be buffered whole in memory
            self._stream_blob(registry, repo, digest, blob_dir)

        fetch_blob(manifest["config"]["digest"])
        for layer in manifest.get("layers") or []:
            fetch_blob(layer["digest"])
        manifest_digest = put(body)
        with open(os.path.join(layout, "index.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"schemaVersion": 2, "manifests": [{
                "mediaType": ctype or MT_OCI_MANIFEST,
                "digest": manifest_digest, "size": len(body),
            }]}, f)

        src = load_image(layout, name=ref, budget=budget)
        # repo metadata like the reference's remote image
        # (remote.go:87-98): tags only for tag references — a
        # digest-pinned pull reports no RepoTags — and RepoDigests
        # pin the digest served for the original reference
        display = _display_repo(registry, repo)
        if "@" in ref:
            src.repo_tags = []
        else:
            src.repo_tags = [f"{display}:{reference}"]
        src.repo_digests = [f"{display}@{served_digest}"]
        src.cleanup = lambda: shutil.rmtree(layout,
                                            ignore_errors=True)
        atexit.register(src.cleanup)
        log.info("pulled %s from %s (%d layers)", ref, registry,
                 len(manifest.get("layers") or []))
        return src
