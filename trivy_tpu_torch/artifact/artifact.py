"""Filesystem artifact (reference: pkg/fanal/artifact/local/fs.go).

Inspect flow: walk the tree, fan every file out to the analyzers,
scan ALL secret candidates in one batched sieve dispatch (the batch
dimension replaces the reference's goroutine pool), run the post
handlers and put the one blob into the cache. The image artifact
(``ImageArtifact``) comes with ROADMAP 2c.
"""

from __future__ import annotations

import hashlib
import json

from ..analyzer import AnalyzerGroup
from ..analyzer.analyzer import AnalysisResult
from ..analyzer.config import CONFIG_ANALYZER_TYPES
from ..analyzer.licensing import LICENSE_ANALYZER_TYPES
from ..handler import post_handle
from ..types import ArtifactReference
from .walker import walk_fs

# the config and license analyzers stay off until their checks are
# ported (ROADMAP A.9): the reference disables them unless the
# misconfig or license check is on
DISABLED_ANALYZERS = CONFIG_ANALYZER_TYPES + LICENSE_ANALYZER_TYPES


class LocalFSArtifact:
    """Directory tree → ONE blob (reference: artifact/local/fs.go).

    ``secret_scanner`` is the ``BatchSecretScanner`` that scans the
    secret candidates; ``None`` scans no secrets."""

    def __init__(self, root: str, cache, *, skip_dirs=(),
                 skip_files=(), file_patterns=None,
                 secret_scanner=None):
        self.root = root
        self.cache = cache
        self.skip_dirs = list(skip_dirs)
        self.skip_files = list(skip_files)
        self.secret_scanner = secret_scanner
        self.group = AnalyzerGroup(disabled=list(DISABLED_ANALYZERS),
                                   file_patterns=dict(file_patterns or {}))

    def inspect(self) -> ArtifactReference:
        result = AnalysisResult()
        files = walk_fs(self.root, skip_dirs=self.skip_dirs,
                        skip_files=self.skip_files)
        for path, size, read in files:
            self.group.analyze_file(result, path, read, size)

        if result.secret_candidates and self.secret_scanner is not None:
            result.secrets = [s for _, s in self.secret_scanner.scan_files(
                [(p, c) for p, c in result.secret_candidates])]

        blob = result.to_blob_info()
        post_handle(blob)
        # NOTE: blob.diff_id stays empty — filesystem scans report
        # Layer: {} (reference: local artifacts have no layers); the
        # content hash is only the cache key.
        raw = json.dumps(blob.to_dict(), sort_keys=True).encode()
        blob_id = "sha256:" + hashlib.sha256(raw).hexdigest()
        self.cache.put_blob(blob_id, blob)
        return ArtifactReference(
            name=self.root, type="filesystem", id=blob_id,
            blob_ids=[blob_id])
