"""Layer-tar and filesystem walkers (reference: pkg/fanal/walker).

Tar walker semantics (tar.go:33-125): iterate entries, collect
whiteout files (``.wh.<name>``) and opaque dirs (``.wh..wh..opq``),
skip non-regular files; paths are cleaned, no leading slash.

Hostile-input posture: entry names whose normpath still contains
``..`` segments are never kept — without a budget they are skipped
(and counted), with a budget the archive is quarantined via
:class:`MalformedArchiveError`; entry counts, per-file sizes and the
ingest deadline are charged against the per-scan
:class:`ResourceBudget` when one is threaded in. The filesystem walk
(``walk_fs``, shared skip logic walk.go:47-62) runs with no budget:
``LocalFSArtifact`` has none.
"""

from __future__ import annotations

import os
import posixpath
import tarfile
from typing import Callable, Optional

from ..guard.budget import GUARD_METRICS, ResourceBudget
from ..guard.safetar import has_traversal, link_escapes, read_member

WH_PREFIX = ".wh."
OPQ = ".wh..wh..opq"

SKIP_SYSTEM_DIRS = ["proc", "sys", "dev"]


def collect_layer_tar(tf: tarfile.TarFile,
                      budget: Optional[ResourceBudget] = None) \
        -> tuple:
    """Eagerly walk a layer tar: ([(path, size, read_fn)], opq_dirs,
    wh_files)."""
    from ..guard.budget import MalformedArchiveError
    files = []
    opq_dirs: list = []
    wh_files: list = []
    # hot-loop setup: hoist the limits and keep the per-entry guard
    # cost to an increment plus gated (mostly-false) cheap checks
    lim = budget.limits if budget is not None else None
    max_file = lim.max_file_bytes if lim is not None else 0
    # every path component costs ≥2 name bytes ("a/"), so a name
    # shorter than 2·max_depth cannot exceed the depth limit —
    # count("/") only runs on names long enough to matter
    depth_gate = 2 * lim.max_depth if lim is not None else 0
    seen = 0
    members = iter(tf)
    while True:
        try:
            member = next(members)
        except StopIteration:
            break
        except tarfile.TarError as e:
            # truncated/corrupt layer surfacing mid-iteration: a
            # typed malformed-archive trip, never a raw tarfile
            # error past the artifact boundary
            if budget is not None:
                budget.malformed(
                    f"truncated or corrupt layer tar: {e}")
            raise MalformedArchiveError(
                f"truncated or corrupt layer tar: {e}") from e
        nm = member.name
        # strip the leading "./" / "/" PREFIX only — lstrip would eat
        # the dot of dotfiles (./.env → env) and break .wh. detection
        path = posixpath.normpath(nm)
        if path.startswith("/"):
            path = path.lstrip("/")
        if budget is not None:
            seen += 1
            if not (seen & 31):
                budget.charge_entries(32)
        if not path or path == ".":
            continue
        if ".." in path and has_traversal(path):
            GUARD_METRICS.inc("traversal_rejected")
            if budget is not None:
                budget.malformed(f"path traversal in entry {nm!r}")
            continue                 # unguarded: reject, keep walking
        if lim is not None:
            if len(nm) > lim.max_name_bytes:
                budget.malformed(
                    f"entry name longer than "
                    f"{lim.max_name_bytes} bytes")
            if not nm.isascii():
                try:
                    nm.encode("utf-8")
                except UnicodeEncodeError:
                    # tarfile decodes undecodable bytes with
                    # surrogateescape; such names cannot round-trip
                    # into reports — structurally hostile
                    budget.malformed(
                        f"undecodable (non-UTF-8) entry name {nm!r}")
            if len(nm) > depth_gate and \
                    path.count("/") + 1 > lim.max_depth:
                budget.exceeded(
                    f"entry {nm!r} deeper than "
                    f"{lim.max_depth} components")
        file_dir, file_name = posixpath.split(path)
        if file_name == OPQ:
            opq_dirs.append(file_dir)
            continue
        if file_name.startswith(WH_PREFIX):
            target = posixpath.normpath(posixpath.join(
                file_dir, file_name[len(WH_PREFIX):]))
            if target == "." or \
                    (".." in target and has_traversal(target)):
                # a whiteout that "deletes" a path outside the
                # archive root is as hostile as a traversal entry
                GUARD_METRICS.inc("traversal_rejected")
                if budget is not None:
                    budget.malformed(
                        f"path traversal in whiteout {path!r}")
                continue
            wh_files.append(target)
            continue
        if member.isreg():
            if _skip_system(path):
                continue
            size = member.size
            if budget is not None and \
                    (size < 0 or size > max_file):
                budget.check_file_size(size, path)
            files.append((path, size,
                          _tar_reader(tf, member, budget)))
            continue
        if member.issym() or member.islnk():
            if link_escapes(member):
                # never followed (only regular files are read), but
                # worth surfacing: count, and report the slot
                # degraded when a budget is watching
                GUARD_METRICS.inc("link_escapes")
                if budget is not None:
                    budget.note(
                        "malformed-archive",
                        f"link member {path!r} escapes the "
                        f"archive root ({member.linkname!r})")
    if budget is not None:
        budget.charge_entries(seen & 31)
    return files, opq_dirs, wh_files


def _tar_reader(tf: tarfile.TarFile, member,
                budget: Optional[ResourceBudget] = None) -> Callable:
    def read() -> bytes:
        if budget is not None:
            return read_member(tf, member, budget)
        f = tf.extractfile(member)
        return f.read() if f is not None else b""
    return read


def _skip_system(path: str) -> bool:
    top = path.split("/", 1)[0]
    return top in SKIP_SYSTEM_DIRS


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
