"""Unpackaged-executable post-handler
(reference: pkg/fanal/handler/unpackaged/unpackaged.go).

Executables that no package manager owns get their sha256 looked up
in the Rekor transparency log; a CycloneDX SBOM attestation found
there merges into the blob, so a bare Go/Rust binary dropped into an
image still reports its dependency packages. The binary analyzers
record digests as ``executable-digest`` custom resources; this
handler consumes them, queries Rekor (when ``TRIVY_REKOR_URL`` or the
artifact option configures it — zero-egress default is off), and
folds discovered applications in.
"""

from __future__ import annotations

import logging
import os

from ..types.artifact import DIGEST_RESOURCE_TYPE as DIGEST_RESOURCE
from .handler import PostHandler, register_post_handler

log = logging.getLogger("trivy_tpu_torch.handler.unpackaged")


@register_post_handler
class UnpackagedHandler(PostHandler):
    type = "unpackaged"
    version = 1
    priority = 50        # after the system-file filter

    def __init__(self):
        self._client = None
        self._client_url = ""

    def _rekor(self):
        url = os.environ.get("TRIVY_REKOR_URL", "")
        if not url:
            return None
        if self._client is None or self._client_url != url:
            from ..rekor import Client
            self._client = Client(url)
            self._client_url = url
        return self._client

    def handle(self, blob) -> None:
        digests = [(cr.file_path, cr.data.get("digest", ""))
                   for cr in blob.custom_resources
                   if cr.type == DIGEST_RESOURCE
                   and isinstance(cr.data, dict)]
        # digests are handler plumbing, never report output
        blob.custom_resources = [
            cr for cr in blob.custom_resources
            if cr.type != DIGEST_RESOURCE]
        if not digests:
            return
        client = self._rekor()
        if client is None:
            return
        from ..rekor import RekorError, discover_sbom
        system = {f.lstrip("/") for f in blob.system_files}
        for path, digest in digests:
            if not digest or path.lstrip("/") in system:
                continue
            try:
                decoded = discover_sbom(client, digest)
            except RekorError as e:
                log.debug("rekor lookup failed for %s: %s", path, e)
                continue
            if decoded is None:
                continue
            log.info("rekor SBOM attestation found for %s", path)
            for app in decoded.applications:
                app.file_path = app.file_path or path
                blob.applications.append(app)
            blob.package_infos.extend(decoded.packages)
