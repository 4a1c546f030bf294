"""Loopback OCI registry serving docker-save tars — the registry of
the tests and of ``chip_smoke.py`` (reference:
``trivy_tpu/artifact/localreg.py``; the port keeps its own copy).

The streaming-ingest pipeline (``stream.py``) needs a real HTTP
registry to pull from: chunked blob bodies, ``Range`` resume
semantics, tags and digest-pinned manifests. Without network egress
that registry must be in-process. :class:`LocalRegistry`
converts docker-save tarballs into Distribution-API content —

* each layer member's bytes become a blob verbatim (digest = sha256
  of the member bytes, which for the uncompressed layers our
  fixtures build equals the config's diff_id);
* the config member's bytes become the config blob, unparsed — a
  hostile config travels through HTTP intact and
  trips the SAME guard it trips on the local-tar path;
* a schema-2 image manifest references both, served under the tag
  and under its own sha256 digest.

Serving knobs: ``range_support=False`` makes
the registry reject resume (the client must fall back to an offset-0
rewrite), and ``throttle_bps`` caps per-response bandwidth so the
cold-pull arm has a network wall worth hiding host work behind.
Counters (``blob_gets``, ``bytes_served``, ``range_requests``) give
tests an exact zero-GET assertion for the warm-layer skip.
"""

from __future__ import annotations

import hashlib
import json
import logging
import tarfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import MT_MANIFEST

log = logging.getLogger("trivy_tpu_torch.artifact.localreg")

_MT_CONFIG = "application/vnd.docker.container.image.v1+json"
_MT_LAYER = "application/vnd.docker.image.rootfs.diff.tar"


def _sha256(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


class LocalRegistry:
    """One-process /v2 registry over in-memory blobs.

    Lifecycle: construct, :meth:`add_image` any number of docker-save
    tars, :meth:`start` (binds 127.0.0.1 on an ephemeral port), scan
    against :meth:`ref`, :meth:`stop`. Also a context manager.
    """

    def __init__(self, range_support: bool = True,
                 throttle_bps: int = 0, chunk: int = 1 << 16):
        self.range_support = range_support
        self.throttle_bps = int(throttle_bps)
        self.chunk = int(chunk)
        self.blobs: dict = {}          # digest -> bytes
        self.manifests: dict = {}      # (repo, ref) -> (ctype, bytes)
        self.httpd = None
        self.port = 0
        self._lock = threading.Lock()
        self.counters = {"manifest_gets": 0, "blob_gets": 0,
                         "bytes_served": 0, "range_requests": 0,
                         "range_rejected": 0}

    # ---- content ----

    def put_blob(self, data: bytes) -> dict:
        digest = _sha256(data)
        self.blobs[digest] = data
        return {"digest": digest, "size": len(data)}

    def add_image(self, repo: str, tag: str, tar_path: str) -> str:
        """Convert ONE docker-save tar (its first manifest entry)
        into served content under ``repo:tag``. Returns the manifest
        digest, which is also registered as a pullable reference."""
        with tarfile.open(tar_path) as tf:
            entry = json.loads(
                tf.extractfile("manifest.json").read())[0]
            config = tf.extractfile(entry["Config"]).read()
            layers = [tf.extractfile(m).read()
                      for m in entry.get("Layers") or []]
        cdesc = self.put_blob(config)
        cdesc["mediaType"] = _MT_CONFIG
        ldescs = []
        for data in layers:
            d = self.put_blob(data)
            d["mediaType"] = _MT_LAYER
            ldescs.append(d)
        manifest = json.dumps({
            "schemaVersion": 2, "mediaType": MT_MANIFEST,
            "config": cdesc, "layers": ldescs,
        }, sort_keys=True).encode()
        mdigest = _sha256(manifest)
        self.manifests[(repo, tag)] = (MT_MANIFEST, manifest)
        self.manifests[(repo, mdigest)] = (MT_MANIFEST, manifest)
        return mdigest

    # ---- serving ----

    @property
    def host(self) -> str:
        return f"127.0.0.1:{self.port}"

    def ref(self, repo: str, tag: str) -> str:
        return f"{self.host}/{repo}:{tag}"

    def reset_counters(self) -> None:
        with self._lock:
            for k in self.counters:
                self.counters[k] = 0

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def start(self) -> "LocalRegistry":
        reg = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # headers and each body piece are separate writes: with
            # Nagle every response would wait out the client's delayed
            # ACK (the reference's copy keeps it on)
            disable_nagle_algorithm = True

            def log_message(self, *a):   # noqa: N802 — stdlib name
                pass

            def _send_body(self, status: int, body: bytes,
                           ctype: str, extra=()):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                # chunked writes so the throttle shapes bandwidth
                # instead of bursting the whole blob in one syscall;
                # the sleep comes BEFORE each piece so the client
                # actually waits for it — sleeping after the last
                # write would throttle nothing on small bodies
                for i in range(0, len(body), reg.chunk):
                    piece = body[i:i + reg.chunk]
                    if reg.throttle_bps > 0:
                        time.sleep(len(piece) / reg.throttle_bps)
                    try:
                        self.wfile.write(piece)
                    except (BrokenPipeError, ConnectionResetError):
                        # the client hung up mid-body — a cancelled
                        # fetch (budget trip), not a server fault
                        self.close_connection = True
                        return
                    reg._inc("bytes_served", len(piece))

            def do_GET(self):   # noqa: N802 — stdlib name
                parts = self.path.split("/")
                # /v2/<repo...>/manifests/<ref> | /v2/<repo...>/blobs/<digest>
                if len(parts) >= 5 and parts[1] == "v2" and \
                        parts[-2] == "manifests":
                    repo = "/".join(parts[2:-2])
                    got = reg.manifests.get((repo, parts[-1]))
                    reg._inc("manifest_gets")
                    if got is None:
                        self._send_body(404, b"", "text/plain")
                        return
                    ctype, body = got
                    self._send_body(
                        200, body, ctype,
                        [("Docker-Content-Digest", _sha256(body))])
                    return
                if len(parts) >= 5 and parts[1] == "v2" and \
                        parts[-2] == "blobs":
                    body = reg.blobs.get(parts[-1])
                    reg._inc("blob_gets")
                    if body is None:
                        self._send_body(404, b"", "text/plain")
                        return
                    rng = self.headers.get("Range", "")
                    if rng.startswith("bytes="):
                        reg._inc("range_requests")
                        if not reg.range_support:
                            # registries without range support answer
                            # 200 with the full body — the client's
                            # restart() path
                            reg._inc("range_rejected")
                            self._send_body(
                                200, body,
                                "application/octet-stream")
                            return
                        start_s = rng[len("bytes="):].partition(
                            "-")[0]
                        try:
                            start = int(start_s)
                        except ValueError:
                            start = -1
                        total = len(body)
                        if start < 0 or start >= total:
                            self._send_body(
                                416, b"", "text/plain",
                                [("Content-Range",
                                  f"bytes */{total}")])
                            return
                        self._send_body(
                            206, body[start:],
                            "application/octet-stream",
                            [("Content-Range",
                              f"bytes {start}-{total - 1}/{total}")])
                        return
                    self._send_body(200, body,
                                    "application/octet-stream")
                    return
                self._send_body(404, b"", "text/plain")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        log.info("local registry on %s (%d blobs)", self.host,
                 len(self.blobs))
        return self

    def stop(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None

    def __enter__(self) -> "LocalRegistry":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
