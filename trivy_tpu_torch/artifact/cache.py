"""Blob cache (reference: pkg/fanal/cache): the in-memory backend only.

An artifact puts its decoded blobs under their ids and the scanner
reads them back. The artifact records, ``missing_blobs`` (the skip of
cached layers on a re-run), the on-disk backend and the layer cache
keys wait for the image and filesystem artifacts.
"""

from __future__ import annotations


class MemoryCache:
    """The blob half of ArtifactCache + LocalArtifactCache
    (cache.go:16-48)."""

    def __init__(self):
        self.blobs: dict = {}

    def put_blob(self, blob_id: str, blob) -> None:
        self.blobs[blob_id] = blob

    def get_blob(self, blob_id: str):
        return self.blobs.get(blob_id)
