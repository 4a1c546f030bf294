"""Post-scan hook registry (reference: pkg/scanner/post/
post_scan.go:11-45).

Hooks run after every scan over the assembled results — the mount
point the reference uses for WASM post-scanners; here any object with
``name``/``version``/``post_scan(results) -> results`` registers.
"""

from __future__ import annotations

import logging

log = logging.getLogger("trivy_tpu_torch.scan.post")

_SCANNERS: dict = {}


def register_post_scanner(s) -> None:
    _SCANNERS[s.name] = s


def deregister_post_scanner(name: str) -> None:
    _SCANNERS.pop(name, None)


def post_scanner_versions() -> dict:
    return {name: s.version for name, s in _SCANNERS.items()}


def post_scan(results: list) -> list:
    """Hook errors abort the scan, like the reference's
    post.Scan (post_scan.go:35-44)."""
    for name in sorted(_SCANNERS):
        results = _SCANNERS[name].post_scan(results)
    return results
