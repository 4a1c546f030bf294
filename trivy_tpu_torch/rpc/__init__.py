"""Client/server mode (reference: rpc/ + pkg/rpc; the JAX package's
``rpc/``).

The wire contract keeps the reference's Twirp shape — POST
``/twirp/trivy.scanner.v1.Scanner/Scan`` and
``/twirp/trivy.cache.v1.Cache/{PutArtifact,PutBlob,MissingBlobs,
DeleteBlobs}`` with JSON bodies (Twirp's JSON protocol), token-header
auth, and the same split of work: the client inspects artifacts
locally and pushes BlobInfos; the server owns the cache, the
card-resident advisory DB (hot-swappable mid-stream), and detection.
"""

from .client import RemoteCache, RemoteScanner
from .server import ScanServer, serve

__all__ = ["RemoteCache", "RemoteScanner", "ScanServer", "serve"]
