"""Unpackaged-executable post-handler
(reference: pkg/fanal/handler/unpackaged/unpackaged.go).

Executables that no package manager owns get their sha256 looked up
in the Rekor transparency log; a CycloneDX SBOM attestation found
there merges into the blob. The binary analyzers record digests as
``executable-digest`` custom resources; this handler consumes them.

The Rekor lookup itself is still to be ported (ROADMAP A.9, with
``rekor.py``): the handler strips the digest resources as the
reference does, and raises when ``TRIVY_REKOR_URL`` asks for a
lookup instead of silently skipping it (``check_rekor``, which
``scan_fs`` also calls before the walk).
"""

from __future__ import annotations

import os

from ..types.artifact import DIGEST_RESOURCE_TYPE as DIGEST_RESOURCE
from .handler import PostHandler, register_post_handler


def check_rekor() -> None:
    """Raise when ``TRIVY_REKOR_URL`` asks for the unported lookup."""
    if os.environ.get("TRIVY_REKOR_URL", ""):
        raise NotImplementedError(
            "the Rekor lookup of unpackaged executables "
            "(TRIVY_REKOR_URL) is not ported yet (ROADMAP A.9: "
            "rekor.py)")


@register_post_handler
class UnpackagedHandler(PostHandler):
    type = "unpackaged"
    version = 1
    priority = 50        # after the system-file filter

    def handle(self, blob) -> None:
        # digests are handler plumbing, never report output
        blob.custom_resources = [
            cr for cr in blob.custom_resources
            if cr.type != DIGEST_RESOURCE]
        check_rekor()
