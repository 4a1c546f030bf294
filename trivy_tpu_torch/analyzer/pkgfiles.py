"""Installed-package analyzers: python-pkg, node-pkg, gemspec
(reference: go-dep-parser's python/packaging, nodejs/packagejson,
ruby/gemspec parsers fed by pkg/fanal/analyzer/language/*).

These find packages INSTALLED in an image (eggs/wheels, node_modules,
gem specifications) rather than declared in lockfiles; the applier
aggregates them per type across layers.
"""

from __future__ import annotations

import json
import posixpath
import re
from typing import Optional

from ..types import Package
from .analyzer import AnalysisResult, Analyzer, register_analyzer
from .language import _app


@register_analyzer
class PythonPkgAnalyzer(Analyzer):
    """*.dist-info/METADATA (wheels) and *.egg-info/PKG-INFO (eggs):
    email-style headers with Name/Version/License."""

    type = "python-pkg"
    version = 1

    def required(self, path: str, size: Optional[int] = None) -> bool:
        return path.endswith((".dist-info/METADATA",
                              ".egg-info/PKG-INFO",
                              ".egg-info"))

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        headers = {}
        for line in content.decode("utf-8", "replace").splitlines():
            if not line or line.startswith((" ", "\t")):
                if not line:
                    break           # headers end at the blank line
                continue
            key, sep, value = line.partition(":")
            if sep and key not in headers:
                headers[key.strip()] = value.strip()
        name = headers.get("Name", "")
        version = headers.get("Version", "")
        if not name or not version:
            return AnalysisResult()
        lic = headers.get("License", "")
        pkg = Package(name=name, version=version, file_path=path,
                      licenses=[lic] if lic and lic != "UNKNOWN"
                      else [])
        return _app("python-pkg", path, [pkg])


@register_analyzer
class NodePkgAnalyzer(Analyzer):
    """Installed package.json files (reference: node-pkg analyzer —
    any package.json; lockfiles go to the npm analyzer)."""

    type = "node-pkg"
    version = 1

    basenames = frozenset({"package.json"})

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        try:
            doc = json.loads(content)
        except ValueError:
            return AnalysisResult()
        if not isinstance(doc, dict):
            return AnalysisResult()
        name = doc.get("name") or ""
        version = doc.get("version") or ""
        if not name or not version:
            return AnalysisResult()
        lic = doc.get("license")
        if isinstance(lic, dict):
            lic = lic.get("type", "")
        licenses = [lic] if isinstance(lic, str) and lic else []
        pkg = Package(name=name, version=version, file_path=path,
                      licenses=licenses)
        return _app("node-pkg", path, [pkg])


_GEMSPEC_STR = r"""['"]([^'"]+)['"]"""
_GEMSPEC_NAME_RE = re.compile(
    r"""\.name\s*=\s*""" + _GEMSPEC_STR)
_GEMSPEC_VERSION_RE = re.compile(
    r"""\.version\s*=\s*(?:Gem::Version\.new\(\s*)?""" + _GEMSPEC_STR)
_GEMSPEC_LICENSE_RE = re.compile(
    r"""\.licenses?\s*=\s*\[?\s*""" + _GEMSPEC_STR)
_FREEZE_RE = re.compile(r"\.freeze$")


@register_analyzer
class GemspecAnalyzer(Analyzer):
    """specifications/*.gemspec — installed ruby gems (reference:
    go-dep-parser ruby/gemspec: regex extraction of the DSL fields)."""

    type = "gemspec"
    version = 1

    def required(self, path: str, size: Optional[int] = None) -> bool:
        return "specifications/" in path and \
            path.endswith(".gemspec")

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        text = content.decode("utf-8", "replace")
        name = _GEMSPEC_NAME_RE.search(text)
        version = _GEMSPEC_VERSION_RE.search(text)
        if not name or not version:
            return AnalysisResult()
        lic = _GEMSPEC_LICENSE_RE.search(text)
        pkg = Package(
            name=name.group(1), version=version.group(1),
            file_path=path,
            licenses=[lic.group(1)] if lic else [])
        return _app("gemspec", path, [pkg])
