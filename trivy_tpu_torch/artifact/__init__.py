"""Artifacts: what a scan target decodes into before detection.

The image artifact (``ImageArtifact``) loads a docker-save or OCI
image (``image.py``), walks each layer tar that its content-addressed
cache keys miss through the analyzers and scans every such layer's
secret candidates in one batched sieve; the filesystem artifact
(``LocalFSArtifact``) walks a directory tree into one blob; the SBOM
artifact (``sbom.py``) turns a CycloneDX or SPDX document into one.
Each puts its blobs into a ``MemoryCache`` or an on-disk ``FSCache``
(``cache.py``); ``LocalScanner`` reads them back by key.
"""

from .artifact import ArtifactOption, ImageArtifact, LocalFSArtifact
from .cache import FSCache, MemoryCache, calc_key
from .image import ImageSource, load_image
from .sbom import SBOMArtifact, decode_to_blob

__all__ = ["ArtifactOption", "ImageArtifact", "LocalFSArtifact",
           "FSCache", "MemoryCache", "calc_key", "ImageSource",
           "load_image", "SBOMArtifact", "decode_to_blob"]
