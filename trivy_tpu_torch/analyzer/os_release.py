"""OS detection analyzers (reference: pkg/fanal/analyzer/os/*).

Per-distro release files win over the generic /etc/os-release
fallback; apk repositories yield the alpine Repository stream.
"""

from __future__ import annotations

import re
from typing import Optional

from ..types import OS, Repository
from .analyzer import AnalysisResult, Analyzer, register_analyzer


def _decode(content: bytes) -> str:
    return content.decode("utf-8", "replace")


@register_analyzer
class AlpineReleaseAnalyzer(Analyzer):
    type = "alpine"
    version = 1

    exact_paths = frozenset({"etc/alpine-release"})

    def analyze(self, path, content):
        ver = _decode(content).strip()
        if not ver:
            return None
        return AnalysisResult(os=OS(family="alpine", name=ver))


@register_analyzer
class AlpineRepoAnalyzer(Analyzer):
    """etc/apk/repositories → Repository release stream
    (reference: analyzer/repo/apk)."""

    type = "apk-repo"
    version = 1

    _URL = re.compile(
        r"/(v?(?P<ver>[0-9]+\.[0-9]+|edge))/(?P<repo>main|community)")

    exact_paths = frozenset({"etc/apk/repositories"})

    def analyze(self, path, content):
        release = None
        for line in _decode(content).splitlines():
            m = self._URL.search(line.strip())
            if m:
                ver = m.group("ver").lstrip("v")
                # the highest stream listed wins; edge beats numbers
                if release is None or _stream_newer(ver, release):
                    release = ver
        if release is None:
            return None
        return AnalysisResult(
            repository=Repository(family="alpine", release=release))


def _stream_newer(a: str, b: str) -> bool:
    if a == "edge":
        return True
    if b == "edge":
        return False
    try:
        return tuple(map(int, a.split("."))) > \
            tuple(map(int, b.split(".")))
    except ValueError:
        return False


@register_analyzer
class DebianVersionAnalyzer(Analyzer):
    type = "debian"
    version = 1

    exact_paths = frozenset({"etc/debian_version"})

    def analyze(self, path, content):
        ver = _decode(content).strip()
        if not ver:
            return None
        return AnalysisResult(os=OS(family="debian", name=ver))


@register_analyzer
class LsbReleaseAnalyzer(Analyzer):
    """etc/lsb-release (Ubuntu sets DISTRIB_ID/RELEASE)."""

    type = "ubuntu"
    version = 1

    exact_paths = frozenset({"etc/lsb-release"})

    def analyze(self, path, content):
        distrib, release = "", ""
        for line in _decode(content).splitlines():
            k, _, v = line.partition("=")
            if k == "DISTRIB_ID":
                distrib = v.strip().strip('"')
            elif k == "DISTRIB_RELEASE":
                release = v.strip().strip('"')
        if distrib.lower() == "ubuntu" and release:
            return AnalysisResult(os=OS(family="ubuntu", name=release))
        return None


_REDHAT_FILES = {
    "etc/oracle-release": "oracle",
    "etc/fedora-release": "fedora",
    "etc/centos-release": "centos",   # ref redhatbase/centos.go:51
    "etc/rocky-release": "rocky",     # ref redhatbase/rocky.go:51
    "etc/almalinux-release": "alma",  # ref redhatbase/alma.go:51
    "etc/redhat-release": None,       # family parsed from content
    "etc/system-release": None,
    # Amazon Linux 2022 moved the release file
    # (ref os/amazonlinux requiredFiles)
    "usr/lib/system-release": None,
    "usr/lib/fedora-release": "fedora",
}

_REDHAT_PATTERNS = [
    ("centos", re.compile(r"centos", re.I)),
    ("rocky", re.compile(r"rocky", re.I)),
    ("alma", re.compile(r"alma", re.I)),
    ("oracle", re.compile(r"oracle", re.I)),
    ("fedora", re.compile(r"fedora", re.I)),
    ("redhat", re.compile(r"red hat", re.I)),
    ("amazon", re.compile(r"amazon", re.I)),
]
_VERSION_RE = re.compile(r"(\d+(?:\.\d+)*)")


@register_analyzer
class RedHatBaseAnalyzer(Analyzer):
    """Red-Hat-family release files (reference: os/redhatbase)."""

    type = "redhatbase"
    version = 1

    exact_paths = frozenset(_REDHAT_FILES)

    def analyze(self, path, content):
        text = _decode(content).strip()
        family = _REDHAT_FILES.get(path)
        if family is None:
            for fam, pat in _REDHAT_PATTERNS:
                if pat.search(text):
                    family = fam
                    break
        if family is None:
            return None
        if family == "amazon":
            # the full suffix is the name (ref amazonlinux.go
            # parseRelease): "Amazon Linux release 2 (Karoo)" →
            # "2 (Karoo)"; AL1 "Amazon Linux AMI release 2018.03"
            # → "AMI release 2018.03" (fields[2:])
            first = text.splitlines()[0]
            fields = first.split()
            if first.startswith("Amazon Linux release 2") and \
                    len(fields) >= 5:
                return AnalysisResult(os=OS(
                    family="amazon", name=" ".join(fields[3:])))
            if first.startswith("Amazon Linux") and \
                    len(fields) > 2:
                return AnalysisResult(os=OS(
                    family="amazon", name=" ".join(fields[2:])))
        m = _VERSION_RE.search(text)
        name = m.group(1) if m else ""
        return AnalysisResult(os=OS(family=family, name=name))


_OS_RELEASE_IDS = {
    "alpine": "alpine", "debian": "debian", "ubuntu": "ubuntu",
    "opensuse-leap": "opensuse.leap", "opensuse": "opensuse.leap",
    "sles": "suse linux enterprise server", "photon": "photon",
    "mariner": "cbl-mariner", "ol": "oracle", "rhel": "redhat",
    "centos": "centos", "rocky": "rocky", "almalinux": "alma",
    "amzn": "amazon", "fedora": "fedora",
}


@register_analyzer
class OsReleaseAnalyzer(Analyzer):
    """Generic etc/os-release fallback (reference: os/release)."""

    type = "os-release"
    version = 1

    exact_paths = frozenset({"etc/os-release",
                             "usr/lib/os-release"})

    def analyze(self, path, content):
        fields = {}
        for line in _decode(content).splitlines():
            k, _, v = line.partition("=")
            fields[k.strip()] = v.strip().strip('"').strip("'")
        os_id = fields.get("ID", "")
        family = _OS_RELEASE_IDS.get(os_id)
        if family is None:
            return None
        version = fields.get("VERSION_ID", "")
        if not version:
            return None
        return AnalysisResult(os=OS(family=family, name=version))
