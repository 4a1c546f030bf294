"""Artifacts: what a scan target decodes into before detection.

The SBOM artifact (``artifact/sbom.py``) turns a CycloneDX or SPDX
document into one ``BlobInfo``; the filesystem artifact
(``artifact/artifact.py``) walks a directory tree through the
analyzers and the batched secret sieve into one. Both put it into a
``MemoryCache`` (``artifact/cache.py``); ``LocalScanner`` reads it back
by key.
"""

from .artifact import LocalFSArtifact
from .cache import MemoryCache
from .sbom import SBOMArtifact, decode_to_blob

__all__ = ["LocalFSArtifact", "MemoryCache", "SBOMArtifact",
           "decode_to_blob"]
