"""System-file filtering post-handler
(reference: pkg/fanal/handler/sysfile/filter.go).

Language packages whose files were installed by the OS package
manager (rpm/dpkg/apk installed-file lists) are dropped from the
blob's applications: the OS package database is authoritative for
their versions, and double-reporting produces false positives.
"""

from __future__ import annotations

from .handler import PostHandler, register_post_handler

# Distroless strips dpkg file lists; these are always OS-managed
# (filter.go defaultSystemFiles — factual constants)
DEFAULT_SYSTEM_FILES = (
    "usr/lib/python2.7/argparse.egg-info",
    "usr/lib/python2.7/lib-dynload/Python-2.7.egg-info",
    "usr/lib/python2.7/wsgiref.egg-info",
)

AFFECTED_TYPES = ("gemspec", "python-pkg", "node-pkg", "gobinary")


@register_post_handler
class SystemFileFilterHandler(PostHandler):
    type = "system-file-filter"
    version = 1
    priority = 100       # runs alongside misconf, before unpackaged

    def handle(self, blob) -> None:
        system = {f.lstrip("/") for f in blob.system_files
                  if f.lstrip("/")}
        system.update(DEFAULT_SYSTEM_FILES)
        apps = []
        for app in blob.applications:
            if app.file_path in system and \
                    app.type in AFFECTED_TYPES:
                continue
            if app.type in AFFECTED_TYPES:
                app.libraries = [
                    lib for lib in app.libraries
                    if lib.file_path.lstrip("/") not in system]
                if not app.libraries:
                    continue
            apps.append(app)
        blob.applications = apps
