"""Bounded tar/gzip primitives for hostile archives.

Everything here assumes the input is attacker-controlled and trades
a little ceremony for three invariants:

1. **no unbounded materialization** — gzip output is produced in
   64 KiB chunks and every chunk is charged against the budget
   before the next is read, so a decompression bomb trips the byte
   budget (usually the ratio tripwire) instead of OOMing the host;
2. **no path escapes** — entry names are normalized with posix
   ``normpath`` and anything that still reaches outside the archive
   root (``..`` segments) or cannot be represented (undecodable
   bytes, absurd length/depth) is rejected;
3. **typed failure** — every malformed/truncated stream surfaces as
   :class:`MalformedArchiveError` (a ValueError), never a raw
   ``tarfile``/``gzip``/``struct`` exception, so the per-slot
   degraded-mode handling stays uniform.

With ``budget=None`` (``--no-ingest-guards``) the helpers fall back
to the historical unbounded behavior — the differential baseline.

``safe_extract_db_archive`` unpacks the advisory-DB archive of ``db
update`` (``db/lifecycle.py``) through the same bounded readers.
"""

from __future__ import annotations

import gzip
import io
import os
import posixpath
import re
import tarfile
import zlib
from typing import Optional

from .budget import MalformedArchiveError, ResourceBudget

GZIP_MAGIC = b"\x1f\x8b"
_CHUNK = 1 << 16

# OCI digest shape: algorithm + hex. Digests name blob FILES in a
# layout ("blobs/<algo>/<hex>"), so anything looser is a path — a
# manifest carrying "sha256:../../../etc/secret" must die here, not
# become an arbitrary host-file read
_DIGEST_RE = re.compile(r"^[a-z0-9]+:[0-9a-fA-F]{32,128}$")


def validate_digest(digest: str) -> str:
    """Reject OCI digest strings that could not be a plain
    ``algo:hex`` pair (traversal, separators, empty)."""
    if not _DIGEST_RE.match(digest or ""):
        raise MalformedArchiveError(
            f"invalid OCI digest {digest!r}")
    return digest

# exception classes that mean "the archive bytes are broken", to be
# re-raised as MalformedArchiveError with context
_ARCHIVE_ERRORS = (tarfile.TarError, gzip.BadGzipFile, zlib.error,
                   EOFError)


def is_gzip(data: bytes) -> bool:
    return data[:2] == GZIP_MAGIC


def decompress_bounded(data: bytes,
                       budget: Optional[ResourceBudget]) -> bytes:
    """Gzip-decompress ``data`` chunk-wise, charging the budget per
    chunk and holding this stream's inflated bytes against its
    compressed size (the ratio tripwire). Truncated or corrupt streams
    raise MalformedArchiveError."""
    if budget is None:
        try:
            return gzip.decompress(data)
        except _ARCHIVE_ERRORS as e:
            raise MalformedArchiveError(
                f"corrupt gzip stream: {e}") from e
    out = io.BytesIO()
    try:
        with gzip.GzipFile(fileobj=io.BytesIO(data)) as gz:
            while True:
                budget.check_deadline()
                chunk = gz.read(_CHUNK)
                if not chunk:
                    break
                budget.charge_decompressed(len(chunk))
                budget.check_ratio(out.tell() + len(chunk), len(data))
                out.write(chunk)
    except _ARCHIVE_ERRORS as e:
        budget.malformed(f"truncated or corrupt gzip stream: {e}")
    return out.getvalue()


def open_layer_bytes(data: bytes,
                     budget: Optional[ResourceBudget] = None) \
        -> tarfile.TarFile:
    """Layer blob bytes (tar or tar.gz) → TarFile, bounded. A plain
    (uncompressed) tar is charged at face value; a gzip member is
    streamed through :func:`decompress_bounded`."""
    if is_gzip(data):
        data = decompress_bounded(data, budget)
    elif budget is not None:
        budget.charge_decompressed(len(data))
    try:
        return tarfile.open(fileobj=io.BytesIO(data))
    except _ARCHIVE_ERRORS as e:
        if budget is not None:
            budget.malformed(f"unreadable layer tar: {e}")
        raise MalformedArchiveError(
            f"unreadable layer tar: {e}") from e


def has_traversal(path: str) -> bool:
    """True when the already-normpath'd path still escapes the
    archive root."""
    return path == ".." or path.startswith("../") or \
        "/../" in path or path.endswith("/..")


def link_escapes(member: tarfile.TarInfo) -> bool:
    """True when a symlink/hardlink member points outside the
    archive root. Absolute *symlink* targets are normal in real
    images (``/usr/bin/sh → /bin/busybox``) and are resolved
    in-archive by readers, so only relative ``..`` escapes and
    absolute *hardlink* targets count."""
    if not (member.issym() or member.islnk()):
        return False
    target = member.linkname or ""
    if member.islnk() and target.startswith("/"):
        return True
    if target.startswith("/"):
        return False
    base = posixpath.dirname(
        posixpath.normpath(member.name).lstrip("/"))
    joined = posixpath.normpath(posixpath.join(base, target))
    return has_traversal(joined)


def read_member(tf: tarfile.TarFile, member: tarfile.TarInfo,
                budget: Optional[ResourceBudget] = None,
                checked: bool = True) -> bytes:
    """Read one member's payload; truncated data raises
    MalformedArchiveError instead of a raw tarfile error. Pass
    ``checked=False`` when the caller has NOT already size-checked
    the member (the walker checks at collect time)."""
    if budget is not None and not checked:
        budget.check_deadline()
        budget.check_file_size(member.size, member.name)
    try:
        f = tf.extractfile(member)
        data = f.read() if f is not None else b""
    except _ARCHIVE_ERRORS + (OSError,) as e:
        raise MalformedArchiveError(
            f"truncated archive reading {member.name!r}: {e}") from e
    if len(data) != member.size:
        raise MalformedArchiveError(
            f"truncated member {member.name!r}: "
            f"{len(data)} of {member.size} bytes")
    return data


def safe_extract_db_archive(blob: bytes, dest_dir: str,
                            budget: Optional[ResourceBudget] = None,
                            wanted: tuple = ("trivy.db",
                                             "metadata.json")) -> list:
    """Extract the advisory-DB tgz into ``dest_dir``: only regular
    files whose *basename* is in ``wanted`` (flattened — traversal
    is impossible by construction), link members rejected, reads
    bounded. Returns the basenames written."""
    raw = decompress_bounded(blob, budget)
    try:
        tf = tarfile.open(fileobj=io.BytesIO(raw))
    except _ARCHIVE_ERRORS as e:
        raise MalformedArchiveError(
            f"unreadable DB archive: {e}") from e
    written = []
    with tf:
        for member in tf:
            if budget is not None:
                budget.charge_entry()
            name = os.path.basename(member.name)
            if name not in wanted:
                continue
            if member.issym() or member.islnk():
                raise MalformedArchiveError(
                    f"DB archive member {member.name!r} is a link")
            if not member.isfile():
                continue
            data = read_member(tf, member, budget, checked=False)
            with open(os.path.join(dest_dir, name), "wb") as out:
                out.write(data)
            written.append(name)
    return written
