"""go.mod / go.sum merge post-handler.

Reference: pkg/fanal/handler/gomod/gomod.go — go.sum applications are
folded into their sibling go.mod application when the go.mod predates
Go 1.17 (detected by the absence of any ``// indirect`` marker, which
only 1.17+ writes), then dropped from the blob.
"""

from __future__ import annotations

import posixpath

from .handler import PostHandler, register_post_handler


def _less_than_go117(app) -> bool:
    return not any(lib.indirect for lib in app.libraries)


def _merge_gosum(gomod_app, gosum_app) -> None:
    uniq = {lib.name: lib for lib in gomod_app.libraries}
    for lib in gosum_app.libraries:
        if lib.name in uniq:
            continue            # go.mod is preferred
        lib.indirect = True     # absent from go.mod => indirect
        uniq[lib.name] = lib
    gomod_app.libraries = list(uniq.values())


@register_post_handler
class GoModMergeHandler(PostHandler):
    type = "gomod-merge"
    version = 1
    priority = 50

    def handle(self, blob) -> None:
        by_path = {a.file_path: a for a in blob.applications
                   if a.type == "gomod"}
        apps = []
        for app in blob.applications:
            if app.type == "gomod":
                d, f = posixpath.split(app.file_path)
                if f == "go.sum":
                    continue
                if f == "go.mod" and _less_than_go117(app):
                    gosum = by_path.get(posixpath.join(d, "go.sum"))
                    if gosum is not None:
                        _merge_gosum(app, gosum)
            apps.append(app)
        blob.applications = apps
