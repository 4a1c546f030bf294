"""Java archive analyzer (reference: go-dep-parser java/jar fed by
pkg/fanal/analyzer/language/java/jar/jar.go).

Identity resolution order per archive:
1. ``META-INF/maven/*/*/pom.properties`` — groupId/artifactId/version
   (one per bundled artifact; shaded/fat jars carry several),
2. ``META-INF/MANIFEST.MF`` — Implementation-/Bundle- headers,
3. the ``artifact-1.2.3.jar`` filename.
Nested ``*.jar`` entries recurse (uber-jars)."""

from __future__ import annotations

import io
import logging
import posixpath
import re
import zipfile
from typing import Optional

from ..types import Package
from .analyzer import AnalysisResult, Analyzer, register_analyzer
from .language import _app

log = logging.getLogger("trivy_tpu_torch.analyzer.jar")

_EXTS = (".jar", ".war", ".ear", ".par")
_FILENAME_RE = re.compile(r"^(.+?)-(\d[\w.]*(?:-[\w.]+)*)$")
MAX_NESTED_DEPTH = 2


def _parse_properties(data: bytes) -> dict:
    props = {}
    for line in data.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "!")):
            continue
        key, sep, value = line.partition("=")
        if sep:
            props[key.strip()] = value.strip()
    return props


def _parse_manifest(data: bytes) -> dict:
    """MANIFEST.MF: RFC-822-ish with 72-byte line folding."""
    headers: dict = {}
    last = None
    for raw in data.decode("utf-8", "replace").splitlines():
        if raw.startswith(" ") and last:
            headers[last] += raw[1:]
            continue
        key, sep, value = raw.partition(":")
        if sep:
            last = key.strip()
            headers[last] = value.strip()
    return headers


def _from_manifest(headers: dict):
    name = headers.get("Implementation-Title") or \
        headers.get("Bundle-SymbolicName", "").split(";")[0]
    version = headers.get("Implementation-Version") or \
        headers.get("Bundle-Version", "")
    group = headers.get("Implementation-Vendor-Id", "")
    if not name or not version:
        return None
    full = f"{group}:{name}" if group else name
    return full, version


def _from_filename(path: str):
    base = posixpath.basename(path)
    base = base.rsplit(".", 1)[0]
    m = _FILENAME_RE.match(base)
    if m:
        return m.group(1), m.group(2)
    return None


_ZIP_ERRORS = (zipfile.BadZipFile, ValueError, RuntimeError,
               NotImplementedError, OSError)


def _read_entry(zf, entry, path):
    """Corrupt/encrypted entries skip, never abort the scan."""
    try:
        return zf.read(entry)
    except _ZIP_ERRORS as e:
        log.debug("unreadable entry %s!%s: %s", path, entry, e)
        return None


def _scan_zip(path: str, data: bytes, depth: int,
              pkgs: list, seen: set,
              top_path: str = "") -> None:
    """``top_path`` is the file the walker saw; every package —
    including ones found in nested jars — reports it as FilePath
    (ref analyzer/language/java/jar passes input.FilePath to the
    parser for the whole tree; spring4shell goldens carry the .war
    path for the nested spring-beans jar). ``path`` tracks the
    nesting chain for identity-from-filename and logging."""
    top_path = top_path or path
    try:
        zf = zipfile.ZipFile(io.BytesIO(data))
    except _ZIP_ERRORS as e:
        log.debug("bad archive %s: %s", path, e)
        return
    with zf:
        names = zf.namelist()
        found_pom = False
        for entry in names:
            if entry.startswith("META-INF/maven/") and \
                    entry.endswith("/pom.properties"):
                raw = _read_entry(zf, entry, path)
                if raw is None:
                    continue
                props = _parse_properties(raw)
                group = props.get("groupId", "")
                artifact = props.get("artifactId", "")
                version = props.get("version", "")
                if artifact and version:
                    found_pom = True
                    key = (f"{group}:{artifact}" if group
                           else artifact, version)
                    if key not in seen:
                        seen.add(key)
                        pkgs.append(Package(
                            name=key[0], version=version,
                            file_path=top_path))
        if not found_pom:
            identity = None
            if "META-INF/MANIFEST.MF" in names:
                raw = _read_entry(zf, "META-INF/MANIFEST.MF", path)
                if raw is not None:
                    identity = _from_manifest(_parse_manifest(raw))
            identity = identity or _from_filename(path)
            if identity and identity not in seen:
                seen.add(identity)
                pkgs.append(Package(name=identity[0],
                                    version=identity[1],
                                    file_path=top_path))
        if depth < MAX_NESTED_DEPTH:
            for entry in names:
                if entry.endswith(_EXTS):
                    inner = _read_entry(zf, entry, path)
                    if inner is None:
                        continue
                    _scan_zip(f"{path}!{entry}", inner,
                              depth + 1, pkgs, seen,
                              top_path=top_path)


@register_analyzer
class JarAnalyzer(Analyzer):
    type = "jar"
    version = 1

    def required(self, path: str, size: Optional[int] = None) -> bool:
        return path.endswith(_EXTS)

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        pkgs: list = []
        _scan_zip(path, content, 0, pkgs, set())
        if not pkgs:
            return AnalysisResult()
        return _app("jar", path, pkgs)
