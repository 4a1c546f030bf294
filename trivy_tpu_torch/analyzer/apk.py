"""Alpine apk installed-DB parser (reference:
pkg/fanal/analyzer/pkg/apk/apk.go:32-120 — the paragraph format at
lib/apk/db/installed, building the dependency graph from provides).
"""

from __future__ import annotations

import posixpath

from ..types import Package, PackageInfo
from ..vercmp import get_comparer
from .analyzer import AnalysisResult, Analyzer, register_analyzer

_REQUIRED = "lib/apk/db/installed"


def _valid_version(v: str) -> bool:
    try:
        get_comparer("apk").parse(v)
        return True
    except ValueError:
        return False


@register_analyzer
class ApkAnalyzer(Analyzer):
    type = "apk"
    version = 2

    exact_paths = frozenset({_REQUIRED})

    def analyze(self, path, content):
        pkgs, installed_files = self._parse(content)
        return AnalysisResult(
            package_infos=[PackageInfo(file_path=path, packages=pkgs)],
            system_files=installed_files,
        )

    def _parse(self, content: bytes) -> tuple:
        pkgs: list = []
        pkg = Package()
        version = ""
        dir_ = ""
        installed_files: list = []
        provides: dict = {}

        def flush():
            nonlocal pkg
            if pkg.name and pkg.version:
                pkgs.append(pkg)
            pkg = Package()

        for raw in content.decode("utf-8", "replace").splitlines():
            line = raw.rstrip("\n")
            if len(line) < 2:
                flush()
                continue
            tag, value = line[:2], line[2:]
            if tag == "P:":
                pkg.name = value
            elif tag == "V:":
                version = value
                if not _valid_version(version):
                    continue
                pkg.version = version
            elif tag == "o:":
                pkg.src_name = value
                pkg.src_version = version
            elif tag == "L:":
                pkg.licenses = self._parse_license(value)
            elif tag == "F:":
                dir_ = value
            elif tag == "R:":
                installed_files.append(posixpath.join(dir_, value))
            elif tag == "p:":
                self._parse_provides(value, pkg, provides)
            elif tag == "D:":
                pkg.depends_on = self._parse_depends(value)
            if pkg.name and pkg.version:
                pkg.id = f"{pkg.name}@{pkg.version}"
                provides[pkg.name] = pkg.id
        flush()

        pkgs = self._unique(pkgs)
        self._consolidate(pkgs, provides)
        return pkgs, installed_files

    @staticmethod
    def _parse_license(value: str) -> list:
        # "GPL-2.0-only AND MIT" / "GPL2+ MIT" → individual names
        out = []
        for tok in value.replace(" AND ", " ").replace(" OR ", " ") \
                .split():
            if tok not in ("AND", "OR"):
                out.append(tok)
        return out

    @staticmethod
    def _trim_requirement(s: str) -> str:
        # so:libssl.so.1.1=1.1 → so:libssl.so.1.1
        return s.split("=")[0] if "=" in s else s

    def _parse_provides(self, value: str, pkg: Package,
                        provides: dict) -> None:
        pkg_id = f"{pkg.name}@{pkg.version}" if pkg.name else ""
        for p in value.split():
            provides[self._trim_requirement(p)] = pkg_id

    def _parse_depends(self, value: str) -> list:
        out = []
        for d in value.split():
            if d.startswith("!"):       # conflict, not a dependency
                continue
            out.append(self._trim_requirement(d))
        return out

    @staticmethod
    def _unique(pkgs: list) -> list:
        seen = set()
        out = []
        for p in pkgs:
            k = (p.name, p.version)
            if k not in seen:
                seen.add(k)
                out.append(p)
        return out

    @staticmethod
    def _consolidate(pkgs: list, provides: dict) -> None:
        for p in pkgs:
            resolved = sorted({provides[d] for d in p.depends_on
                               if d in provides})
            p.depends_on = resolved
