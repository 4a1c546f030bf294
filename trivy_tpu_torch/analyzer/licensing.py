"""License analyzers (reference:
pkg/fanal/analyzer/licensing/license.go + analyzer/pkg/dpkg/
copyright.go).

* ``license-file``: classifies LICENSE/COPYING-named files fully and
  source-file headers, producing LicenseFiles for the loose-file
  result class.
* ``dpkg-license``: parses /usr/share/doc/*/copyright (machine-
  readable ``License:`` headers + common-licenses references); the
  applier merges these into dpkg package records.

Both are gated behind ``--security-checks license``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from ..licensing import normalize
from ..licensing.classifier import classify, is_human_readable
from ..types import LicenseFile, LicenseFinding
from .analyzer import AnalysisResult, Analyzer, register_analyzer

LICENSE_ANALYZER_TYPES = ("license-file", "dpkg-license")

# matched on path-segment boundaries: "usr/lib" skips usr/lib/... but
# not usr/libexec/...
_SKIP_DIRS = (
    "node_modules", "usr/share/doc", "usr/lib", "usr/local/include",
    "usr/include", "usr/local/go", "opt/yarn", "usr/src/wordpress",
)


def _in_skip_dir(path: str) -> bool:
    padded = "/" + path
    return any(f"/{d}/" in padded for d in _SKIP_DIRS)

_ACCEPTED_EXTENSIONS = (
    ".asp", ".aspx", ".bas", ".bat", ".b", ".c", ".cue", ".cgi",
    ".cs", ".css", ".fish", ".html", ".h", ".ini", ".java", ".js",
    ".jsx", ".markdown", ".md", ".py", ".php", ".pl", ".r", ".rb",
    ".sh", ".sql", ".ts", ".tsx", ".txt", ".vue", ".zsh",
)

_ACCEPTED_NAMES = ("license", "licence", "copyright", "copying",
                   "notice")

MAX_LICENSE_SIZE = 1 << 20


def _is_license_filename(path: str) -> bool:
    base = os.path.basename(path).lower()
    return base in _ACCEPTED_NAMES or \
        base.rsplit(".", 1)[0] in _ACCEPTED_NAMES


@register_analyzer
class LicenseFileAnalyzer(Analyzer):
    type = "license-file"
    version = 1

    def required(self, path: str, size: Optional[int] = None) -> bool:
        if size is not None and size > MAX_LICENSE_SIZE:
            return False
        if _in_skip_dir(path):
            return False
        if _is_license_filename(path):
            return True
        ext = os.path.splitext(path)[1].lower()
        return ext in _ACCEPTED_EXTENSIONS

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        r = AnalysisResult()
        if not is_human_readable(content):
            return r
        lf = classify(path, content,
                      full=_is_license_filename(path))
        if lf.findings:
            r.licenses.append(lf)
        return r


_COMMON_LICENSE_RE = re.compile(
    r"/?usr/share/common-licenses/([0-9A-Za-z_.+-]+[0-9A-Za-z+])")
_LICENSE_SPLIT_RE = re.compile(
    r"(?:,?[_ ]+or[_ ]+)|(?:,?[_ ]+and[_ ])|(?:,[ ]*)")
_COPYRIGHT_PATH_RE = re.compile(
    r"^usr/share/doc/([^/]+)/copyright$")


@register_analyzer
class DpkgLicenseAnalyzer(Analyzer):
    type = "dpkg-license"
    version = 1

    def required(self, path: str, size: Optional[int] = None) -> bool:
        return _COPYRIGHT_PATH_RE.match(path) is not None

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        r = AnalysisResult()
        licenses: list = []
        for line in content.decode("utf-8", "replace").splitlines():
            if line.startswith("License:"):
                val = line[len("License:"):].strip()
                for lic in _LICENSE_SPLIT_RE.split(val):
                    lic = normalize((lic or "").strip())
                    if lic and lic not in licenses:
                        licenses.append(lic)
            elif "/usr/share/common-licenses/" in line:
                m = _COMMON_LICENSE_RE.search(line)
                if m:
                    lic = normalize(m.group(1))
                    if lic not in licenses:
                        licenses.append(lic)
        if not licenses:
            return r
        pkg_name = _COPYRIGHT_PATH_RE.match(path).group(1)
        r.licenses.append(LicenseFile(
            type="dpkg-license",
            file_path=path,
            pkg_name=pkg_name,
            findings=[LicenseFinding(name=lic) for lic in licenses],
        ))
        return r
