"""Comparer registry — ecosystem → grammar, mirroring the reference's
driver table (pkg/detector/library/driver.go:24-67: maven/gradle →
maven, npm/yarn/pnpm → npm, pip/pipenv/poetry → pep440, gems →
rubygems, everything else → generic semver) and the OS schemes
(pkg/detector/ospkg: apk, deb, rpm)."""

from __future__ import annotations

from .apk import ApkComparer
from .base import Comparer
from .deb import DebComparer
from .maven import MavenComparer
from .npm import NpmComparer
from .pep440 import Pep440Comparer
from .rpm import RpmComparer
from .rubygems import GemComparer
from .semver import SemverComparer

_BY_NAME = {
    "semver": SemverComparer,
    "generic": SemverComparer,
    "apk": ApkComparer,
    "deb": DebComparer,
    "rpm": RpmComparer,
    "pep440": Pep440Comparer,
    "npm": NpmComparer,
    "maven": MavenComparer,
    "rubygems": GemComparer,
}

# ecosystem (trivy-db bucket prefix) → grammar name
ECOSYSTEM_GRAMMAR = {
    "maven": "maven", "gradle": "maven",
    "npm": "npm", "yarn": "npm", "pnpm": "npm", "node.js": "npm",
    "pip": "pep440", "pipenv": "pep440", "poetry": "pep440",
    "python": "pep440",
    "rubygems": "rubygems", "bundler": "rubygems", "gemspec": "rubygems",
    "cargo": "semver", "composer": "semver", "go": "semver",
    "gomod": "semver", "gobinary": "semver", "conan": "semver",
    "nuget": "semver", "dotnet-core": "semver", "pub": "semver",
    "hex": "semver", "swift": "semver", "cocoapods": "semver",
}

_instances: dict = {}


def get_comparer(name: str) -> Comparer:
    """Grammar or ecosystem name → comparer instance (cached)."""
    key = ECOSYSTEM_GRAMMAR.get(name.lower(), name.lower())
    cls = _BY_NAME.get(key)
    if cls is None:
        cls = SemverComparer          # reference default: generic
    if key not in _instances:
        _instances[key] = cls()
    return _instances[key]
