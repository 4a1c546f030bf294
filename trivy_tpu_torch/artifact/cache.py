"""Content-addressed layer cache (reference: pkg/fanal/cache).

``missing_blobs`` is the resume mechanism: a re-run only analyzes
layers whose (diffID × analyzer versions × options) key is absent.
Keys: SHA-256 over id + sorted version map + scan options
(cache/key.go:14). Backends: in-memory and JSON-files-on-disk (the
BoltDB analog; one file per blob keeps writes atomic and debuggable).

The keys equal the JAX package's (the same analyzer and handler
versions, the same options), so a cache directory written by either
package serves the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Optional

from ..types.convert import artifact_info_from_dict, blob_info_from_dict

SCHEMA_VERSION = 2


def calc_key(id_: str, analyzer_versions: dict,
             hook_versions: Optional[dict] = None,
             options: Optional[dict] = None) -> str:
    h = hashlib.sha256()
    payload = {
        "id": id_,
        "analyzers": dict(sorted((analyzer_versions or {}).items())),
        "hooks": dict(sorted((hook_versions or {}).items())),
        "options": options or {},
        "schema": SCHEMA_VERSION,
    }
    h.update(json.dumps(payload, sort_keys=True,
                        separators=(",", ":")).encode())
    return "sha256:" + h.hexdigest()


class MemoryCache:
    """ArtifactCache + LocalArtifactCache in one (cache.go:16-48)."""

    def __init__(self):
        self.artifacts: dict = {}
        self.blobs: dict = {}

    def missing_blobs(self, artifact_id: str, blob_ids: list) -> tuple:
        """(missing_artifact, missing_blob_ids)"""
        missing = [b for b in blob_ids if b not in self.blobs]
        return artifact_id not in self.artifacts, missing

    def put_artifact(self, artifact_id: str, info) -> None:
        self.artifacts[artifact_id] = info

    def put_blob(self, blob_id: str, blob) -> None:
        self.blobs[blob_id] = blob

    def get_artifact(self, artifact_id: str):
        return self.artifacts.get(artifact_id)

    def get_blob(self, blob_id: str):
        return self.blobs.get(blob_id)

    def delete_blobs(self, blob_ids: list) -> None:
        for b in blob_ids:
            self.blobs.pop(b, None)

    def clear(self) -> None:
        self.artifacts.clear()
        self.blobs.clear()


class FSCache(MemoryCache):
    """Disk-backed cache under ``<dir>/fanal`` — JSON per entry."""

    def __init__(self, cache_dir: str):
        super().__init__()
        self.dir = os.path.join(cache_dir, "fanal")
        os.makedirs(os.path.join(self.dir, "artifact"), exist_ok=True)
        os.makedirs(os.path.join(self.dir, "blob"), exist_ok=True)

    def _path(self, kind: str, key: str) -> str:
        return os.path.join(self.dir, kind,
                            key.replace(":", "_") + ".json")

    def missing_blobs(self, artifact_id: str, blob_ids: list) -> tuple:
        missing = [b for b in blob_ids
                   if not os.path.exists(self._path("blob", b))]
        return (not os.path.exists(
            self._path("artifact", artifact_id)), missing)

    def put_artifact(self, artifact_id: str, info) -> None:
        self._write("artifact", artifact_id, info)

    def put_blob(self, blob_id: str, blob) -> None:
        self._write("blob", blob_id, blob)

    def get_artifact(self, artifact_id: str):
        raw = self._read("artifact", artifact_id)
        return None if raw is None else artifact_info_from_dict(raw)

    def get_blob(self, blob_id: str):
        raw = self._read("blob", blob_id)
        return None if raw is None else blob_info_from_dict(raw)

    def delete_blobs(self, blob_ids: list) -> None:
        for b in blob_ids:
            try:
                os.unlink(self._path("blob", b))
            except FileNotFoundError:
                pass

    def clear(self) -> None:
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)

    def _write(self, kind: str, key: str, obj) -> None:
        path = self._path(kind, key)
        # a temporary name of the writer's own: two writers of one key
        # (two sessions pushing a shared layer, or two servers on one
        # directory behind a router) must not share it
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        data = obj.to_dict() if hasattr(obj, "to_dict") else obj
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, path)

    def _read(self, kind: str, key: str):
        try:
            with open(self._path(kind, key), encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

