"""SBOM artifact — scan a CycloneDX/SPDX document instead of an image
(reference: pkg/fanal/artifact/sbom/sbom.go:39-94).

The decoded BOM becomes ONE BlobInfo (OS + PackageInfos +
Applications); the cache key is the sha256 of that blob, so re-scans
of an unchanged SBOM are pure cache hits and a scan is only the
name-join against the advisory tables the card holds — no tar
walking, no analyzers.
"""

from __future__ import annotations

import hashlib
import logging

from .. import sbom as sbom_mod
from ..types import ArtifactReference, BlobInfo

log = logging.getLogger("trivy_tpu_torch.artifact.sbom")


# Bump when decode semantics change: the cache key must not collide
# across decoder behaviors (reference keys on blob JSON + analyzer
# versions, sbom.go:98-111; keying on input bytes + decoder version
# gives the same rescan-hit property without serializing the blob —
# the blob-JSON round-trip was 65% of SBOM decode time at 10k scale).
DECODER_VERSION = b"sbom-decoder-v1"


def decode_to_blob(data: bytes):
    """One-pass decode of SBOM bytes into the cacheable unit:
    ``(artifact_type, decoded, blob, blob_id)``. The blob id is the
    sha256 of (decoder version, input bytes), so rescans of an
    unchanged SBOM are cache hits. Raises ValueError on unknown
    format."""
    try:
        fmt, decoded = sbom_mod.sniff_and_decode(data)
    except (KeyError, AttributeError, TypeError) as e:
        # malformed-but-sniffable documents: surface as a decode
        # error, not a crash, for every caller
        raise ValueError(f"SBOM decode error: {e!r}")
    blob = BlobInfo(
        os=decoded.os,
        package_infos=decoded.packages,
        applications=decoded.applications,
    )
    h = hashlib.sha256(DECODER_VERSION)
    h.update(data)
    blob_id = "sha256:" + h.hexdigest()
    artifact_type = "cyclonedx" if fmt in (
        sbom_mod.FORMAT_CYCLONEDX_JSON,
        sbom_mod.FORMAT_CYCLONEDX_XML,
        sbom_mod.FORMAT_ATTEST_CYCLONEDX_JSON) else "spdx"
    log.debug("decoded SBOM format %s -> %s", fmt, blob_id[:19])
    return artifact_type, decoded, blob, blob_id


class SBOMArtifact:
    def __init__(self, file_path: str, cache):
        self.file_path = file_path
        self.cache = cache

    def inspect(self) -> ArtifactReference:
        with open(self.file_path, "rb") as f:
            data = f.read()
        try:
            artifact_type, decoded, blob, blob_id = \
                decode_to_blob(data)
        except ValueError as e:
            raise ValueError(f"{e}: {self.file_path}")
        self.cache.put_blob(blob_id, blob)
        return ArtifactReference(
            name=self.file_path,
            type=artifact_type,
            id=blob_id,
            blob_ids=[blob_id],
            cyclonedx=decoded.cyclonedx,
        )
