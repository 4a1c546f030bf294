"""Filesystem walker (reference: pkg/fanal/walker/fs.go; shared skip
logic walk.go:47-62).

The layer-tar walker and the ingest budget (``guard/``) come with the
image artifact (ROADMAP 2c); ``LocalFSArtifact`` walks with no budget.
"""

from __future__ import annotations

import os
import posixpath
from typing import Callable


def _clean_skip(paths) -> set:
    """walk.go:27-38: skip paths are cleaned and matched with the
    leading '/' trimmed — against the path as WALKED (root-joined for
    fs scans), not the root-relative analysis path."""
    out = set()
    for p in paths:
        p = posixpath.normpath(p.replace(os.sep, "/")).lstrip("/")
        out.add(p)
    return out


def walk_fs(root: str, skip_dirs: list = (),
            skip_files: list = ()) -> list:
    """Directory walk → [(rel_path, size, read_fn)]. Skip lists match
    both the cwd-relative walked path (reference behavior for relative
    scan roots) and the root-relative path (convenience). Symlinks are
    never followed (``os.walk`` default + the islink filter below), so
    a link farm cannot pull the walk outside ``root``.

    A directory's files come in name order and its subdirectories in
    the order ``os.walk`` lists them, unsorted, as the reference walks
    them: the order decides which release file ``_merge_os`` sees
    last."""
    out = []
    skip_dirs = _clean_skip(skip_dirs)
    skip_files = _clean_skip(skip_files)
    root_prefix = posixpath.normpath(
        root.replace(os.sep, "/")).lstrip("/")

    def skipped(rel: str, skips: set) -> bool:
        return rel in skips or \
            posixpath.join(root_prefix, rel) in skips

    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root).replace(os.sep, "/")
        if rel_dir == ".":
            rel_dir = ""
        dirnames[:] = [
            d for d in dirnames
            if not skipped(posixpath.join(rel_dir, d), skip_dirs)]
        for name in sorted(filenames):
            rel = posixpath.join(rel_dir, name)
            if skipped(rel, skip_files):
                continue
            full = os.path.join(dirpath, name)
            if not os.path.isfile(full) or os.path.islink(full):
                continue
            size = os.path.getsize(full)
            out.append((rel, size, _file_reader(full)))
    return out


def _file_reader(full: str) -> Callable:
    def read() -> bytes:
        with open(full, "rb") as f:
            return f.read()
    return read
