"""NDB ("Packages.db") reader — SUSE's rpm backend
(rpm/lib/backend/ndb/rpmpkg.c).

File layout (all u32 little-endian):
  header (16 bytes): magic 'RpmP', ndb version (0), generation,
    slot-page count N
  slot area: pages 1..N of 4096 bytes (the header occupies the first
    16 bytes of page area; slots follow), each slot 16 bytes:
    magic 'Slot', package index, block offset, block count
  blob area: at block offset × 16: blob header (16 bytes): magic
    'BlbS', package index, generation, data length — followed by the
    header blob, padding, and a 16-byte tail.
"""

from __future__ import annotations

import struct

NDB_MAGIC = 0x50_6D_70_52      # 'R','p','m','P' little-endian
SLOT_MAGIC = 0x74_6F_6C_53     # 'S','l','o','t'
BLOB_MAGIC = 0x53_62_6C_42     # 'B','l','b','S'

SLOT_SIZE = 16
BLK_SIZE = 16
PAGE_SIZE = 4096


def is_ndb(data: bytes) -> bool:
    return len(data) >= 16 and \
        struct.unpack_from("<I", data, 0)[0] == NDB_MAGIC


def ndb_blobs(data: bytes) -> list:
    if not is_ndb(data):
        raise ValueError("not an NDB Packages.db")
    _magic, _ver, _gen, slot_npages = struct.unpack_from(
        "<IIII", data, 0)
    if slot_npages == 0 or slot_npages * PAGE_SIZE > len(data):
        raise ValueError("bad NDB slot page count")

    blobs = []
    # slots start right after the 16-byte header, filling the slot
    # pages
    slot_off = SLOT_SIZE
    end = slot_npages * PAGE_SIZE
    while slot_off + SLOT_SIZE <= end:
        magic, pkgidx, blkoff, blkcnt = struct.unpack_from(
            "<IIII", data, slot_off)
        slot_off += SLOT_SIZE
        if magic != SLOT_MAGIC or pkgidx == 0 or blkoff == 0:
            continue
        boff = blkoff * BLK_SIZE
        if boff + 16 > len(data):
            continue
        bmagic, bpkg, _bgen, blen = struct.unpack_from(
            "<IIII", data, boff)
        if bmagic != BLOB_MAGIC or bpkg != pkgidx:
            continue
        if boff + 16 + blen > len(data):
            continue
        blobs.append(data[boff + 16:boff + 16 + blen])
    return blobs
