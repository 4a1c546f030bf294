"""Pure-Python BoltDB (bbolt) reader — read-only, mmap-based (copied
from ``trivy_tpu/db/boltdb.py``).

trivy-db ships as a single BoltDB file inside an OCI artifact
(reference: pkg/db/db.go:90-120 downloads it; trivy-db's schema is
top-level buckets per source → nested bucket per package → key=CVE,
value=JSON advisory; usage pkg/detector/library/driver.go:83-91).
This reader implements the on-disk format directly — meta pages,
branch/leaf pages, inline buckets, overflow pages — so advisory
ingestion needs no Go toolchain.

Format (bbolt db.go / page.go):
  page header:  id u64 | flags u16 | count u16 | overflow u32
  meta page:    header + magic 0xED0CDAED u32 | version u32 |
                pageSize u32 | flags u32 | root bucket{pgid u64,
                sequence u64} | freelist u64 | pgid u64 | txid u64 |
                checksum u64
  branch elem:  pos u32 | ksize u32 | pgid u64
  leaf elem:    flags u32 | pos u32 | ksize u32 | vsize u32
  bucket value: root pgid u64 | sequence u64 [+ inline page if root=0]
"""

from __future__ import annotations

import mmap
import struct
from typing import Iterator, Optional

MAGIC = 0xED0CDAED
PAGE_HEADER = 16          # id(8) flags(2) count(2) overflow(4)
LEAF_ELEM = 16            # flags(4) pos(4) ksize(4) vsize(4)
BRANCH_ELEM = 16          # pos(4) ksize(4) pgid(8)
BUCKET_HEADER = 16        # root(8) sequence(8)

FLAG_BRANCH = 0x01
FLAG_LEAF = 0x02
FLAG_META = 0x04
FLAG_FREELIST = 0x10

LEAF_FLAG_BUCKET = 0x01


class CorruptDB(ValueError):
    pass


def _fnv64a(data: bytes) -> int:
    """FNV-64a (bbolt meta.sum64) — validates meta checksums."""
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _unpack(fmt: str, buf, off: int) -> tuple:
    try:
        return struct.unpack_from(fmt, buf, off)
    except struct.error as e:
        raise CorruptDB(f"truncated page data at {off}: {e}")


class Bucket:
    """Read-only view of one bucket."""

    def __init__(self, db: "BoltDB", root_pgid: int,
                 inline: Optional[tuple] = None):
        self.db = db
        self.root_pgid = root_pgid
        self._inline = inline          # (buf, offset) for root==0

    # -- page access --

    def _page(self, pgid: int) -> tuple:
        return self.db._page(pgid)

    def _root_page(self) -> tuple:
        if self._inline is not None:
            return self._inline
        return self._page(self.root_pgid)

    # -- iteration --

    def _iter_page(self, buf, off) -> Iterator[tuple]:
        """Yields (key, value, leaf_flags), descending branches."""
        _, flags, count, _ = self.db._header(buf, off)
        if flags & FLAG_LEAF:
            base = off + PAGE_HEADER
            for i in range(count):
                eoff = base + i * LEAF_ELEM
                lf, pos, ksize, vsize = _unpack(
                    "<IIII", buf, eoff)
                kstart = eoff + pos
                key = bytes(buf[kstart:kstart + ksize])
                val = bytes(buf[kstart + ksize:
                                kstart + ksize + vsize])
                yield key, val, lf
        elif flags & FLAG_BRANCH:
            base = off + PAGE_HEADER
            for i in range(count):
                eoff = base + i * BRANCH_ELEM
                _pos, _ksize, pgid = _unpack(
                    "<IIQ", buf, eoff)
                cbuf, coff = self._page(pgid)
                yield from self._iter_page(cbuf, coff)
        else:
            raise CorruptDB(f"page is neither branch nor leaf "
                            f"(flags={flags:#x})")

    def items(self) -> Iterator[tuple]:
        """(key, value) pairs; nested buckets are skipped."""
        buf, off = self._root_page()
        for key, val, lf in self._iter_page(buf, off):
            if not (lf & LEAF_FLAG_BUCKET):
                yield key, val

    def buckets(self) -> Iterator[tuple]:
        """(name, Bucket) for nested buckets."""
        buf, off = self._root_page()
        for key, val, lf in self._iter_page(buf, off):
            if lf & LEAF_FLAG_BUCKET:
                yield key, self.db._open_bucket(val)

    def bucket(self, name: bytes) -> Optional["Bucket"]:
        for key, b in self.buckets():
            if key == name:
                return b
        return None

    def get(self, key: bytes) -> Optional[bytes]:
        for k, v in self.items():
            if k == key:
                return v
        return None


class BoltDB:
    """Read-only BoltDB file. Use as a context manager."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except ValueError:
            self._f.close()
            raise CorruptDB(f"empty or unmappable file: {path}")
        try:
            self.page_size, self._root_pgid = self._read_meta()
        except Exception:
            self.close()
            raise

    # -- low level --

    def _meta_at(self, off: int):
        """Decode + validate one meta page; None if invalid.

        Field layout mirrors bbolt's meta struct (magic, version,
        pageSize, flags, root bucket{pgid, seq}, freelist, pgid,
        txid, checksum — txid at +48). A nonzero checksum must equal
        FNV-64a over the first 56 meta bytes (bbolt meta.validate);
        on a torn write the corrupt meta is skipped so the older
        valid meta wins instead of a garbage tree."""
        if off + PAGE_HEADER + 64 > len(self._mm):
            return None
        base = off + PAGE_HEADER
        magic, version, page_size = struct.unpack_from(
            "<III", self._mm, base)
        if magic != MAGIC or version != 2:
            return None
        root_pgid = struct.unpack_from("<Q", self._mm, base + 16)[0]
        txid, checksum = struct.unpack_from(
            "<QQ", self._mm, base + 48)
        if checksum and checksum != _fnv64a(
                self._mm[base:base + 56]):
            return None
        return (page_size, root_pgid, txid)

    def _read_meta(self) -> tuple:
        # try both meta pages (0 and 1), prefer the valid one with
        # the highest txid (bbolt picks the newer valid meta)
        best = None
        # meta1 sits at page_size; probe the common page sizes so a
        # torn meta0 on a 16K-page host is still recoverable
        for off in (0, 4096, 8192, 16384, 32768, 65536):
            m = self._meta_at(off)
            if m is None:
                continue
            if off not in (0, m[0]):
                continue   # not a real meta page for this db
            if best is None or m[2] > best[2]:
                best = m
            # meta1 actually lives at page_size, not 4096 — re-probe
            # when the first meta reports a different page size
            if off == 0 and m[0] != 4096:
                m2 = self._meta_at(m[0])
                if m2 is not None and m2[2] > best[2]:
                    best = m2
        if best is None:
            raise CorruptDB(f"not a boltdb file: {self.path}")
        return best[0], best[1]

    def _header(self, buf, off) -> tuple:
        pid, flags, count = _unpack("<QHH", buf, off)
        overflow = _unpack("<I", buf, off + 12)[0]
        return pid, flags, count, overflow

    def _page(self, pgid: int) -> tuple:
        off = pgid * self.page_size
        if off + PAGE_HEADER > len(self._mm):
            raise CorruptDB(f"page {pgid} out of bounds")
        return self._mm, off

    def _open_bucket(self, value: bytes) -> Bucket:
        if len(value) < BUCKET_HEADER:
            raise CorruptDB("short bucket value")
        root, _seq = _unpack("<QQ", value, 0)
        if root == 0:
            # inline bucket: page embedded after the header
            return Bucket(self, 0, inline=(value, BUCKET_HEADER))
        return Bucket(self, root)

    # -- public --

    def root(self) -> Bucket:
        return Bucket(self, self._root_pgid)

    def buckets(self) -> Iterator[tuple]:
        yield from self.root().buckets()

    def bucket(self, name: bytes) -> Optional[Bucket]:
        return self.root().bucket(name)

    def close(self) -> None:
        try:
            self._mm.close()
        finally:
            self._f.close()

    def __enter__(self) -> "BoltDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_trivy_db(path: str, store=None):
    """Ingest a trivy-db BoltDB file into an AdvisoryStore.

    Schema (trivy-db): top-level buckets per source
    (``alpine 3.16``, ``pip::Python``, ...) → nested bucket per
    package → key=vuln id, value=JSON advisory; plus a flat
    ``vulnerability`` bucket keyed by vuln id with the detail record.
    """
    import json
    import logging

    from .compiled import gc_paused
    from .store import AdvisoryStore

    log = logging.getLogger("trivy_tpu_torch.db.boltdb")
    if store is None:
        store = AdvisoryStore()
    with gc_paused():      # same object volume as compile
        return _load(path, store, log, json)


def _load(path, store, log, json):
    n_adv = n_detail = n_skipped = 0
    with BoltDB(path) as db:
        for bname, bucket in db.buckets():
            name = bname.decode("utf-8", "replace")
            if name == "vulnerability":
                for key, val in bucket.items():
                    try:
                        # bytes→str first: json.loads(bytes) pays a
                        # detect_encoding pass per value
                        store.put_vulnerability(
                            key.decode("utf-8", "replace"),
                            json.loads(val.decode("utf-8")))
                        n_detail += 1
                    except ValueError:   # UnicodeDecodeError included
                        n_skipped += 1
                        continue
                continue
            if name == "trivy":          # metadata bucket
                continue
            for pkg_name, pkg_bucket in bucket.buckets():
                pname = pkg_name.decode("utf-8", "replace")
                for vuln_id, val in pkg_bucket.items():
                    try:
                        store.put_advisory(
                            name, pname,
                            vuln_id.decode("utf-8", "replace"),
                            json.loads(val.decode("utf-8")))
                        n_adv += 1
                    except ValueError:   # UnicodeDecodeError included
                        n_skipped += 1
                        continue
    if n_skipped:
        log.warning("boltdb ingest skipped %d unparseable rows "
                    "(corrupt values?)", n_skipped)
    return store, n_adv, n_detail
