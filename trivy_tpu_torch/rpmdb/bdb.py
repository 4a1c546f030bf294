"""Berkeley DB hash file reader — just enough for rpm's "Packages".

Layout (libdb db_page.h):
  page 0: hash metadata — generic meta header (lsn 8, pgno 4,
    magic 4 @12, version @16, pagesize @20, ..., last_pgno @32);
    hash magic = 0x061561, byte order detected from it.
  pages 1..last_pgno: 26-byte page header (lsn 8, pgno 4, prev 4,
    next 4, entries 2, hf_offset 2, level 1, type 1) then content.
  hash pages (type 2 unsorted / 13 sorted): `entries` uint16 offsets
    follow the header; entries alternate key/data; each entry starts
    with a type byte — H_KEYDATA (1) inline bytes, H_OFFPAGE (3)
    points at an overflow chain (pgno @4, total length @8).
  overflow pages (type 7): hf_offset bytes of data each, chained by
    next_pgno.

rpm keys are 4-byte package numbers; values are header blobs. Only
values are returned.
"""

from __future__ import annotations

import struct

HASH_MAGIC = 0x061561
P_OVERFLOW = 7
_HASH_PAGE_TYPES = (2, 13)
H_KEYDATA = 1
H_DUPLICATE = 2
H_OFFPAGE = 3

_META_KEY = 0x88       # metadata page type (not needed, kept for doc)


def is_bdb(data: bytes) -> bool:
    if len(data) < 512:
        return False
    magic = struct.unpack_from("<I", data, 12)[0]
    magic_be = struct.unpack_from(">I", data, 12)[0]
    return HASH_MAGIC in (magic, magic_be)


def bdb_blobs(data: bytes) -> list:
    if not is_bdb(data):
        raise ValueError("not a Berkeley DB hash file")
    lit = struct.unpack_from("<I", data, 12)[0] == HASH_MAGIC
    u32 = (lambda off: struct.unpack_from("<I", data, off)[0]) \
        if lit else (lambda off: struct.unpack_from(">I", data, off)[0])
    u16 = (lambda off: struct.unpack_from("<H", data, off)[0]) \
        if lit else (lambda off: struct.unpack_from(">H", data, off)[0])

    page_size = u32(20)
    if page_size < 512 or page_size > 64 * 1024 or \
            page_size & (page_size - 1):
        raise ValueError(f"bad bdb page size {page_size}")
    last_pgno = u32(32)

    def page(pgno: int) -> int:
        off = pgno * page_size
        if off + page_size > len(data):
            raise ValueError(f"page {pgno} out of range")
        return off

    def overflow_chain(pgno: int, total: int) -> bytes:
        # hostile-input bounds: a crafted chain that cycles (or
        # chains zero-payload pages forever) must raise, not spin —
        # every page can legitimately appear at most once
        if total > len(data):
            raise ValueError(
                f"overflow length {total} exceeds file size")
        out = bytearray()
        seen = set()
        while pgno != 0 and len(out) < total:
            if pgno in seen:
                raise ValueError("cyclic overflow chain")
            seen.add(pgno)
            off = page(pgno)
            ptype = data[off + 25]
            if ptype != P_OVERFLOW:
                raise ValueError("broken overflow chain")
            nxt = u32(off + 16)
            hf_offset = u16(off + 22)
            if hf_offset == 0:
                raise ValueError("empty overflow page in chain")
            out += data[off + 26:off + 26 + hf_offset]
            pgno = nxt
        return bytes(out[:total])

    blobs = []
    for pgno in range(1, last_pgno + 1):
        off = page(pgno)
        ptype = data[off + 25]
        if ptype not in _HASH_PAGE_TYPES:
            continue
        entries = u16(off + 20)
        offsets = [u16(off + 26 + 2 * i) for i in range(entries)]
        # entries alternate key (even index) / value (odd index)
        for i in range(1, entries, 2):
            eoff = off + offsets[i]
            etype = data[eoff]
            if etype == H_KEYDATA:
                # libdb LEN_HITEM: item i spans from its offset up to
                # the previous item's offset (page end for item 0) —
                # data is allocated from the page end downward
                prev_end = offsets[i - 1] if i > 0 else page_size
                blobs.append(data[eoff + 1:off + prev_end])
            elif etype == H_OFFPAGE:
                ov_pgno = u32(eoff + 4)
                ov_len = u32(eoff + 8)
                blobs.append(overflow_chain(ov_pgno, ov_len))
            # H_DUPLICATE and others: not produced by rpm
    return blobs
