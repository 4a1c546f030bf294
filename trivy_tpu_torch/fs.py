"""Filesystem walk and the secret-candidate gate (reference:
pkg/fanal/walker/fs.go, walk.go:47-62, and
pkg/fanal/analyzer/secret/secret.go:112-141).

The gate mirrors Required (size ≥ 10, skip .git / node_modules dirs,
lockfiles, binary-ish extensions, the secret config file itself) and
Analyze's binary sniff (utils.IsBinary).
"""

from __future__ import annotations

import os
import posixpath

SKIP_FILES = {"go.mod", "go.sum", "package-lock.json", "yarn.lock",
              "pnpm-lock.yaml", "Pipfile.lock", "Gemfile.lock"}
SKIP_DIRS = {".git", "node_modules"}
SKIP_EXTS = {".jpg", ".png", ".gif", ".doc", ".pdf", ".bin", ".svg",
             ".socket", ".deb", ".rpm", ".zip", ".gz", ".gzip",
             ".tar", ".pyc"}


def is_binary(content: bytes) -> bool:
    """utils.IsBinary approximation: NUL byte in the head chunk."""
    return b"\x00" in content[:8000]


def required(path: str, size: int, config_path: str = "") -> bool:
    """Whether a walked file is a secret-scan candidate by its path
    and size. The secret-rule config is never scanned; the reference
    compares basename(configPath) against the walked path
    (secret.go:135), so a top-level file merely sharing the config's
    name is skipped too."""
    if size < 10:
        return False
    dir_, name = posixpath.split(path)
    if SKIP_DIRS & set(dir_.split("/")):
        return False
    if name in SKIP_FILES:
        return False
    if posixpath.splitext(name)[1].lower() in SKIP_EXTS:
        return False
    if config_path and posixpath.basename(config_path) == path:
        return False
    return True


def _clean_skip(paths) -> set:
    """walk.go:27-38: skip paths are cleaned and matched with the
    leading '/' trimmed."""
    return {posixpath.normpath(p.replace(os.sep, "/")).lstrip("/")
            for p in paths}


def walk_fs(root: str, skip_dirs=(), skip_files=()) -> list:
    """Directory walk → [(rel_path, size, full_path)] in sorted
    order. Skip lists match both the cwd-relative walked path and the
    root-relative path. Symlinks are never followed."""
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
        dirnames[:] = sorted(
            d for d in dirnames
            if not skipped(posixpath.join(rel_dir, d), skip_dirs))
        for name in sorted(filenames):
            rel = posixpath.join(rel_dir, name)
            if skipped(rel, skip_files):
                continue
            full = os.path.join(dirpath, name)
            if not os.path.isfile(full) or os.path.islink(full):
                continue
            out.append((rel, os.path.getsize(full), full))
    return out


def secret_candidates(root: str, skip_dirs=(), skip_files=(),
                      config_path: str = "") -> list:
    """[(rel_path, content)] of the files a secret scan reads."""
    out = []
    for rel, size, full in walk_fs(root, skip_dirs, skip_files):
        if not required(rel, size, config_path):
            continue
        with open(full, "rb") as f:
            content = f.read()
        if not is_binary(content):
            out.append((rel, content))
    return out
