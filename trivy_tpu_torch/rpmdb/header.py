"""RPM header blob parser.

A header blob (as stored in every rpmdb backend) is:

  int32be index_count | int32be data_size |
  index_count × (tag int32be, type uint32be, offset int32be,
                 count uint32be) |
  data_size bytes of data

Values are decoded per type: 6/9 NUL-terminated string, 8 count
NUL-terminated strings, 2/3/4/5 integer arrays, 7 raw bin. Region
entries (tags 61-63) are metadata and are skipped. Reference fields:
``rpm -qa --qf "%{NAME} %{EPOCHNUM} %{VERSION} %{RELEASE} %{SOURCERPM}
%{ARCH}"`` (rpm.go:96-99).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

# rpm tag numbers (rpmtag.h)
TAG_NAME = 1000
TAG_VERSION = 1001
TAG_RELEASE = 1002
TAG_EPOCH = 1003
TAG_SUMMARY = 1004
TAG_SIZE = 1009
TAG_VENDOR = 1011
TAG_LICENSE = 1014
TAG_ARCH = 1022
TAG_SOURCERPM = 1044
TAG_PROVIDENAME = 1047
TAG_DIRINDEXES = 1116
TAG_BASENAMES = 1117
TAG_DIRNAMES = 1118
TAG_MODULARITYLABEL = 5096

_REGION_TAGS = {61, 62, 63}

# type ids
_T_CHAR, _T_INT8, _T_INT16, _T_INT32, _T_INT64 = 1, 2, 3, 4, 5
_T_STRING, _T_BIN, _T_STRING_ARRAY, _T_I18NSTRING = 6, 7, 8, 9


@dataclass
class RpmPackage:
    name: str = ""
    version: str = ""
    release: str = ""
    epoch: int = 0
    arch: str = ""
    source_rpm: str = ""
    vendor: str = ""
    license: str = ""
    size: int = 0
    modularity_label: str = ""
    provides: list = field(default_factory=list)
    installed_files: list = field(default_factory=list)

    @property
    def src_fields(self) -> tuple:
        """SOURCERPM 'name-ver-rel.src.rpm' → (name, ver, rel);
        reference splitFileName (rpm.go:167-188)."""
        s = self.source_rpm
        if not s or s == "(none)":
            return ("", "", "")
        if s.endswith(".rpm"):
            s = s[:-4]
        s, _, _arch = s.rpartition(".")
        if not s:
            return ("", "", "")
        rest, _, rel = s.rpartition("-")
        if not rest:
            return ("", "", "")
        name, _, ver = rest.rpartition("-")
        if not name:
            return ("", "", "")
        return (name, ver, rel)


def _decode_str(data: bytes, off: int) -> str:
    end = data.find(b"\x00", off)
    if end < 0:
        end = len(data)
    return data[off:end].decode("utf-8", "replace")


def _decode(data: bytes, typ: int, off: int, count: int):
    if typ in (_T_STRING, _T_I18NSTRING):
        return _decode_str(data, off)
    if typ == _T_STRING_ARRAY:
        out = []
        pos = off
        for _ in range(count):
            end = data.find(b"\x00", pos)
            if end < 0:
                end = len(data)
            out.append(data[pos:end].decode("utf-8", "replace"))
            pos = end + 1       # advance by RAW bytes, not re-encoded
        return out
    if typ == _T_INT32:
        return list(struct.unpack_from(f">{count}i", data, off))
    if typ == _T_INT16:
        return list(struct.unpack_from(f">{count}h", data, off))
    if typ == _T_INT64:
        return list(struct.unpack_from(f">{count}q", data, off))
    if typ in (_T_CHAR, _T_INT8, _T_BIN):
        return data[off:off + count]
    return None


def parse_header_tags(blob: bytes) -> dict:
    if len(blob) < 8:
        raise ValueError("header blob too short")
    il, dl = struct.unpack_from(">ii", blob, 0)
    if il < 0 or dl < 0 or len(blob) < 8 + 16 * il + dl:
        raise ValueError("header blob size mismatch")
    data = blob[8 + 16 * il:8 + 16 * il + dl]
    tags: dict = {}
    for i in range(il):
        tag, typ, off, count = struct.unpack_from(
            ">iIiI", blob, 8 + 16 * i)
        if tag in _REGION_TAGS or off < 0 or off > len(data):
            continue
        try:
            val = _decode(data, typ, off, count)
        except struct.error:
            continue
        if val is not None and tag not in tags:
            tags[tag] = val
    return tags


def parse_header_blob(blob: bytes):
    try:
        tags = parse_header_tags(blob)
    except ValueError:
        return None

    def s(tag):
        v = tags.get(tag, "")
        return v if isinstance(v, str) else ""

    def i(tag):
        v = tags.get(tag)
        if isinstance(v, list) and v and isinstance(v[0], int):
            return int(v[0])
        return 0

    pkg = RpmPackage(
        name=s(TAG_NAME),
        version=s(TAG_VERSION),
        release=s(TAG_RELEASE),
        epoch=i(TAG_EPOCH),
        arch=s(TAG_ARCH),
        source_rpm=s(TAG_SOURCERPM),
        vendor=s(TAG_VENDOR),
        license=s(TAG_LICENSE),
        size=i(TAG_SIZE),
        modularity_label=s(TAG_MODULARITYLABEL),
        provides=list(tags.get(TAG_PROVIDENAME) or [])
        if isinstance(tags.get(TAG_PROVIDENAME), list) else [],
    )
    # installed files: dirnames[dirindexes[i]] + basenames[i]
    basenames = tags.get(TAG_BASENAMES)
    dirnames = tags.get(TAG_DIRNAMES)
    dirindexes = tags.get(TAG_DIRINDEXES)
    if isinstance(basenames, list) and isinstance(dirnames, list) \
            and isinstance(dirindexes, list) \
            and len(basenames) == len(dirindexes):
        try:
            pkg.installed_files = [
                dirnames[di] + bn
                for di, bn in zip(dirindexes, basenames)]
        except (IndexError, TypeError):
            pass
    return pkg
