"""Artifacts: what a scan target decodes into before detection.

The SBOM artifact (``artifact/sbom.py``) turns a CycloneDX or SPDX
document into one ``BlobInfo`` in a ``MemoryCache``
(``artifact/cache.py``); ``LocalScanner`` reads it back by key.
"""

from .cache import MemoryCache
from .sbom import SBOMArtifact, decode_to_blob

__all__ = ["MemoryCache", "SBOMArtifact", "decode_to_blob"]
