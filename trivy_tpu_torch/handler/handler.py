"""Registry + dispatch for blob post-handlers.

Reference: pkg/fanal/handler/handler.go:21-72 — handlers are
priority-sorted (higher first) and mutate the BlobInfo in place.
"""

from __future__ import annotations

_REGISTRY: list = []


class PostHandler:
    """Subclasses set ``type``/``version``/``priority`` and implement
    ``handle(blob)`` mutating the BlobInfo."""

    type: str = ""
    version: int = 1
    priority: int = 0

    def handle(self, blob) -> None:
        raise NotImplementedError


def register_post_handler(h) -> "PostHandler":
    _REGISTRY.append(h() if isinstance(h, type) else h)
    _REGISTRY.sort(key=lambda x: -x.priority)
    return h


def registered_handlers(disabled=None) -> list:
    disabled = set(disabled or [])
    return [h for h in _REGISTRY if h.type not in disabled]


def handler_versions(disabled=None) -> dict:
    return {h.type: h.version for h in registered_handlers(disabled)}


def post_handle(blob, disabled=None) -> None:
    for h in registered_handlers(disabled):
        h.handle(blob)
