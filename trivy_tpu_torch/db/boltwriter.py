"""Minimal BoltDB file writer — fixture generator (copied from
``trivy_tpu/db/boltwriter.py``).

Produces structurally valid bbolt files (meta pages, leaf/branch
pages, inline buckets, overflow pages) so the pure-Python reader
(boltdb.py) and the advisory-ingest path can be exercised and
benchmarked without a Go toolchain. This is a fixture generator, not
a database: no freelist management, no transactions, write-once.
"""

from __future__ import annotations

import struct

# the on-disk layout is defined once, by the reader
from .boltdb import (BRANCH_ELEM, BUCKET_HEADER, FLAG_BRANCH,
                     FLAG_FREELIST, FLAG_LEAF, FLAG_META,
                     LEAF_ELEM, LEAF_FLAG_BUCKET, MAGIC,
                     PAGE_HEADER)

PAGE_SIZE = 4096


def _page_header(pgid, flags, count, overflow=0) -> bytes:
    return struct.pack("<QHHI", pgid, flags, count, overflow)


def _leaf_page_body(items, pgid=0) -> bytes:
    """items: list of (flags, key, value). Returns a full page image
    (may exceed PAGE_SIZE for overflow values)."""
    n = len(items)
    elems = b""
    data = b""
    data_start = PAGE_HEADER + n * LEAF_ELEM
    for i, (lf, key, val) in enumerate(items):
        elem_off = PAGE_HEADER + i * LEAF_ELEM
        pos = data_start + len(data) - elem_off
        elems += struct.pack("<IIII", lf, pos, len(key), len(val))
        data += key + val
    total = data_start + len(data)
    n_pages = (total + PAGE_SIZE - 1) // PAGE_SIZE
    body = _page_header(pgid, FLAG_LEAF, n, n_pages - 1) + \
        elems + data
    return body.ljust(n_pages * PAGE_SIZE, b"\x00")


def inline_bucket_value(items) -> bytes:
    """Bucket value with root=0 and an embedded leaf page (same
    element packing as a real leaf page, unpadded)."""
    total = PAGE_HEADER + sum(LEAF_ELEM + len(k) + len(v)
                              for _, k, v in items)
    return struct.pack("<QQ", 0, 0) + _leaf_page_body(items)[:total]


class Writer:
    def __init__(self):
        self.pages = {}            # pgid -> bytes (multiple of PAGE)
        self.next_pgid = 4         # 0,1 meta; 2 freelist; 3 root

    def alloc(self, body: bytes) -> int:
        pgid = self.next_pgid
        n_pages = max(1, (len(body) + PAGE_SIZE - 1) // PAGE_SIZE)
        # rewrite the page id inside the header
        body = struct.pack("<Q", pgid) + body[8:]
        self.pages[pgid] = body.ljust(n_pages * PAGE_SIZE, b"\x00")
        self.next_pgid += n_pages
        return pgid

    def leaf_page(self, items) -> int:
        return self.alloc(_leaf_page_body(items))

    def tree_page(self, items, chunk: int = 4096) -> int:
        """Leaf page, or branch-of-leaves when the element count
        would overflow the page header's u16 count."""
        if len(items) <= chunk:
            return self.leaf_page(items)
        children = []
        for i in range(0, len(items), chunk):
            part = items[i:i + chunk]
            children.append((part[0][1], self.leaf_page(part)))
        return self.branch_page(children)

    def branch_page(self, children) -> int:
        """children: list of (key, child_pgid)."""
        n = len(children)
        elems = b""
        data = b""
        data_start = PAGE_HEADER + n * BRANCH_ELEM
        for i, (key, pgid) in enumerate(children):
            elem_off = PAGE_HEADER + i * BRANCH_ELEM
            pos = data_start + len(data) - elem_off
            elems += struct.pack("<IIQ", pos, len(key), pgid)
            data += key
        body = _page_header(0, FLAG_BRANCH, n) + elems + data
        return self.alloc(body)

    def bucket_value(self, root_pgid: int) -> bytes:
        return struct.pack("<QQ", root_pgid, 0)

    def write(self, path: str, root_pgid: int) -> None:
        high = self.next_pgid
        out = bytearray(high * PAGE_SIZE)

        def meta(pgid, txid) -> bytes:
            m = _page_header(pgid, FLAG_META, 0)
            body = struct.pack("<III", MAGIC, 2, PAGE_SIZE)
            body += struct.pack("<I", 0)               # meta flags
            body += struct.pack("<QQ", root_pgid, 0)   # root bucket
            body += struct.pack("<Q", 2)               # freelist
            body += struct.pack("<Q", high)            # pgid high water
            body += struct.pack("<Q", txid)
            from .boltdb import _fnv64a                # bbolt sum64
            body += struct.pack("<Q", _fnv64a(body))
            return (m + body).ljust(PAGE_SIZE, b"\x00")

        out[0:PAGE_SIZE] = meta(0, 1)
        out[PAGE_SIZE:2 * PAGE_SIZE] = meta(1, 2)
        out[2 * PAGE_SIZE:3 * PAGE_SIZE] = _page_header(
            2, FLAG_FREELIST, 0).ljust(PAGE_SIZE, b"\x00")
        for pgid, body in self.pages.items():
            out[pgid * PAGE_SIZE:pgid * PAGE_SIZE + len(body)] = body
        with open(path, "wb") as f:
            f.write(out)


def write_trivy_db(path: str, sources: dict, details: dict) -> None:
    """sources: {bucket: {pkg: {vuln_id: advisory-dict}}};
    details: {vuln_id: detail-dict}."""
    import json
    w = Writer()
    root_items = []
    for bucket_name in sorted(sources):
        pkg_items = []
        for pkg in sorted(sources[bucket_name]):
            kv = [(0, vid.encode(), json.dumps(adv).encode())
                  for vid, adv in sorted(
                      sources[bucket_name][pkg].items())]
            # inline the package bucket when it's small
            if sum(len(k) + len(v) for _, k, v in kv) < 1024:
                pkg_items.append((LEAF_FLAG_BUCKET, pkg.encode(),
                                  inline_bucket_value(kv)))
            else:
                pgid = w.leaf_page(kv)
                pkg_items.append((LEAF_FLAG_BUCKET, pkg.encode(),
                                  w.bucket_value(pgid)))
        pgid = w.tree_page(pkg_items)
        root_items.append((LEAF_FLAG_BUCKET, bucket_name.encode(),
                           w.bucket_value(pgid)))
    detail_items = [(0, vid.encode(), json.dumps(d).encode())
                    for vid, d in sorted(details.items())]
    pgid = w.tree_page(detail_items)
    root_items.append((LEAF_FLAG_BUCKET, b"vulnerability",
                       w.bucket_value(pgid)))
    root_items.sort(key=lambda it: it[1])
    root_pgid = w.tree_page(root_items)
    w.write(path, root_pgid)
