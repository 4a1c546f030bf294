"""Compiled-binary analyzers: gobinary, rustbinary
(reference: go-dep-parser golang/binary + rust/binary fed by
pkg/fanal/analyzer/language/{golang,rust}/binary).

* gobinary — Go ≥1.12 embeds build info behind the
  ``\\xff Go buildinf:`` magic; ≥1.18 stores the module graph inline
  as length-prefixed text (``path``/``mod``/``dep`` lines).
* rustbinary — cargo-auditable embeds zlib-compressed JSON
  (``{"packages": [{name, version, ...}]}``) in a ``.dep-v0``
  section; we locate it by scanning for the zlib stream.
"""

from __future__ import annotations

import json
import logging
import re
import zlib
from typing import Optional

from ..types import Package
from .analyzer import AnalysisResult, Analyzer, register_analyzer
from .language import _app

log = logging.getLogger("trivy_tpu_torch.analyzer.binary")

_ELF = b"\x7fELF"
_MACHO = (b"\xfe\xed\xfa\xce", b"\xfe\xed\xfa\xcf",
          b"\xce\xfa\xed\xfe", b"\xcf\xfa\xed\xfe")
_PE = b"MZ"

GO_BUILDINF_MAGIC = b"\xff Go buildinf:"

MAX_BINARY_SIZE = 200 << 20


def _looks_executable(content: bytes) -> bool:
    return content.startswith(_ELF) or content.startswith(_PE) or \
        content[:4] in _MACHO


def _binary_required(path: str, size) -> bool:
    if size is not None and (size < 64 or size > MAX_BINARY_SIZE):
        return False
    base = path.rsplit("/", 1)[-1]
    # extension-less files and Windows executables; magic is checked
    # on content before any parsing
    return "." not in base or base.endswith(".exe")


def _read_var_string(data: bytes, off: int):
    """uvarint length + bytes (Go ≥1.18 inline strings)."""
    shift = length = 0
    while True:
        if off >= len(data):
            return None, off
        b = data[off]
        off += 1
        length |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if off + length > len(data):
        return None, off
    return data[off:off + length], off + length


def parse_go_buildinfo(content: bytes):
    """→ (go_version, mod_text) or None. Handles the ≥1.18 inline
    layout (flags bit 0x2 at magic+15, strings follow at +32)."""
    idx = content.find(GO_BUILDINF_MAGIC)
    if idx < 0 or idx + 33 > len(content):
        return None
    flags = content[idx + 15]
    if not flags & 0x2:
        # pre-1.18 layout stores pointers into data sections; without
        # a full ELF reader the module text is still discoverable by
        # its sentinel markers below
        mod = _find_modinfo(content)
        return ("", mod) if mod else None
    off = idx + 32
    go_version, off = _read_var_string(content, off)
    mod_raw, off = _read_var_string(content, off)
    if go_version is None:
        return None
    mod = mod_raw.decode("utf-8", "replace") if mod_raw else ""
    if len(mod) >= 33:                # strip the sentinel bytes
        mod = mod[16:-16]
    return go_version.decode("utf-8", "replace"), mod


# pre-1.18 module info is delimited by two 16-byte sentinels
_MOD_SENTINEL_START = b"\x30\x77\xaf\x0c\x92\x74\x08\x02\x41\xe1\xc1\x07\xe6\xd6\x18\xe6"
_MOD_SENTINEL_END = b"\xf9\x32\x43\x39\x71\xe6\x4b\x0f\x37\x1c\xd0\x8d\xb1\x36\x2c\x30"


def _find_modinfo(content: bytes):
    start = content.find(_MOD_SENTINEL_START)
    if start < 0:
        return ""
    end = content.find(_MOD_SENTINEL_END, start)
    if end < 0:
        return ""
    return content[start + 16:end].decode("utf-8", "replace")


def parse_go_modules(mod_text: str) -> list:
    """``dep\\t<path>\\t<version>\\t<sum>`` lines → packages; the main
    module (``mod`` line) is included without a version pin."""
    pkgs = []
    for line in mod_text.splitlines():
        parts = line.split("\t")
        if len(parts) >= 3 and parts[0] in ("dep", "mod"):
            name, version = parts[1], parts[2]
            if parts[0] == "mod" and version.startswith("(devel"):
                continue
            pkgs.append(Package(name=name,
                                version=version.lstrip("v")))
        elif len(parts) >= 3 and parts[0] == "=>" and pkgs:
            # replacement line: the shipped module is the
            # replacement, not the dep line above it
            pkgs[-1].name = parts[1]
            pkgs[-1].version = parts[2].lstrip("v")
    return pkgs


@register_analyzer
class GoBinaryAnalyzer(Analyzer):
    type = "gobinary"
    version = 1

    def required(self, path: str, size: Optional[int] = None) -> bool:
        return _binary_required(path, size)

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        if not _looks_executable(content):
            return AnalysisResult()
        info = parse_go_buildinfo(content)
        if info is None:
            return AnalysisResult()
        _, mod_text = info
        pkgs = parse_go_modules(mod_text)
        for p in pkgs:
            p.file_path = path
        if not pkgs:
            return AnalysisResult()
        return _app("gobinary", path, pkgs)


_AUDIT_ZLIB_RE = re.compile(rb"\x78[\x01\x5e\x9c\xda]")


def parse_rust_audit(content: bytes):
    """cargo-auditable: zlib-compressed {"packages": [...]} JSON.
    Scan candidate zlib headers near the '.dep-v0' section name."""
    anchor = content.find(b".dep-v0")
    search_from = max(0, anchor - (8 << 20)) if anchor >= 0 else 0
    hay = content[search_from:] if anchor >= 0 else content
    for m in _AUDIT_ZLIB_RE.finditer(hay):
        try:
            raw = zlib.decompress(hay[m.start():])
        except zlib.error:
            continue
        try:
            doc = json.loads(raw)
        except ValueError:
            continue
        if isinstance(doc, dict) and isinstance(
                doc.get("packages"), list):
            return doc["packages"]
    return None


@register_analyzer
class RustBinaryAnalyzer(Analyzer):
    type = "rustbinary"
    version = 1

    def required(self, path: str, size: Optional[int] = None) -> bool:
        return _binary_required(path, size)

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        if not _looks_executable(content):
            return AnalysisResult()
        if b".dep-v0" not in content:
            return AnalysisResult()
        packages = parse_rust_audit(content)
        if not packages:
            return AnalysisResult()
        pkgs = []
        for entry in packages:
            name = entry.get("name", "")
            version = entry.get("version", "")
            if not name or not version:
                continue
            if entry.get("kind") == "build":
                continue             # build-only deps aren't shipped
            pkgs.append(Package(name=name, version=version,
                                file_path=path))
        if not pkgs:
            return AnalysisResult()
        return _app("rustbinary", path, pkgs)


@register_analyzer
class ExecutableDigestAnalyzer(Analyzer):
    """Digests for unpackaged executables (reference: the executable
    analyzer feeding AnalysisResult.Digests for the unpackaged
    handler's Rekor lookups). Active only when a Rekor URL is
    configured — hashing every binary costs real time otherwise."""

    type = "executable-digest"
    version = 1

    def required(self, path: str, size: Optional[int] = None) -> bool:
        import os
        if not os.environ.get("TRIVY_REKOR_URL"):
            return False
        return _binary_required(path, size)

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        r = AnalysisResult()
        if not _looks_executable(content):
            return r
        import hashlib

        from ..types.artifact import (DIGEST_RESOURCE_TYPE,
                                      CustomResource)
        r.custom_resources.append(CustomResource(
            type=DIGEST_RESOURCE_TYPE, file_path=path,
            data={"digest":
                  "sha256:" + hashlib.sha256(content).hexdigest()}))
        return r
