"""Misconfiguration post-handler
(reference: pkg/fanal/handler/misconf/misconf.go Handle:250-324).

Runs after analysis on each blob: evaluates the built-in policies
over the collected ConfigFiles and writes the Misconfigurations into
the BlobInfo. The raw ConfigFiles are dropped afterwards, like the
reference clears them once defsec has run.
"""

from __future__ import annotations

from ..misconf import scan_config_files
from .handler import PostHandler, register_post_handler


@register_post_handler
class MisconfPostHandler(PostHandler):
    type = "misconf"
    version = 1
    priority = 100       # reference: MisconfPostHandlerPriority

    def handle(self, blob) -> None:
        if not blob.config_files:
            return
        blob.misconfigurations = scan_config_files(blob.config_files)
        blob.config_files = []
