"""Language-package detection (reference: pkg/detector/library).

Driver per lockfile/application type: ecosystem bucket prefix +
version grammar (driver.go:22-67). ``detect`` mirrors
DetectVulnerabilities (driver.go:83-110): prefix bucket scan on the
normalized package name, constraint match, FixedVersion synthesis
(createFixedVersions: patched versions verbatim, else the upper bounds
of ``<`` comparators among vulnerable versions)."""

from __future__ import annotations

from dataclasses import dataclass

from ..db import AdvisoryStore
from ..types import DetectedVulnerability
from ..vercmp import get_comparer
from ..vercmp.base import is_vulnerable

# application/lockfile type → (ecosystem, grammar); mirrors
# driver.go:27-58 (ftypes constants → vulnerability ecosystems)
_TYPES = {
    "bundler": ("rubygems", "rubygems"),
    "gemspec": ("rubygems", "rubygems"),
    "cargo": ("cargo", "semver"),
    "rustbinary": ("cargo", "semver"),
    "composer": ("composer", "semver"),
    "gobinary": ("go", "semver"),
    "gomod": ("go", "semver"),
    "jar": ("maven", "maven"),
    "pom": ("maven", "maven"),
    "gradle": ("maven", "maven"),
    "npm": ("npm", "npm"),
    "yarn": ("npm", "npm"),
    "pnpm": ("npm", "npm"),
    "node-pkg": ("npm", "npm"),
    "javascript": ("npm", "npm"),
    "nuget": ("nuget", "semver"),
    "dotnet-core": ("nuget", "semver"),
    "pip": ("pip", "pep440"),
    "pipenv": ("pip", "pep440"),
    "poetry": ("pip", "pep440"),
    "python-pkg": ("pip", "pep440"),
    "conan": ("conan", "semver"),
}


def normalize_pkg_name(ecosystem: str, name: str) -> str:
    """vulnerability.NormalizePkgName: pip names are lowercased with
    ``_``→``-`` (PEP 503-ish); maven keeps group:artifact as-is."""
    if ecosystem == "pip":
        return name.lower().replace("_", "-")
    if ecosystem == "npm":
        return name.lower()
    return name


@dataclass
class LibraryDriver:
    ecosystem: str
    grammar: str

    def detect(self, store: AdvisoryStore, pkg_id: str, pkg_name: str,
               pkg_ver: str) -> list:
        comparer = get_comparer(self.grammar)
        prefix = f"{self.ecosystem}::"
        name = normalize_pkg_name(self.ecosystem, pkg_name)
        out = []
        for adv in store.get_advisories(prefix, name):
            if not is_vulnerable(comparer, pkg_ver,
                                 adv.vulnerable_versions,
                                 adv.patched_versions,
                                 adv.unaffected_versions):
                continue
            out.append(DetectedVulnerability(
                vulnerability_id=adv.vulnerability_id,
                pkg_id=pkg_id,
                pkg_name=pkg_name,
                installed_version=pkg_ver,
                fixed_version=_fixed_versions(adv),
                data_source=adv.data_source,
            ))
        return out


def new_library_driver(lib_type: str) -> LibraryDriver:
    key = lib_type.lower()
    if key not in _TYPES:
        raise ValueError(f"unsupported library type: {lib_type}")
    eco, grammar = _TYPES[key]
    return LibraryDriver(ecosystem=eco, grammar=grammar)


def _fixed_versions(adv) -> str:
    if adv.patched_versions:
        return ", ".join(adv.patched_versions)
    out = []
    for version in adv.vulnerable_versions:
        for s in version.split(","):
            s = s.strip()
            if s.startswith("<") and not s.startswith("<="):
                out.append(s[1:].strip())
    return ", ".join(out)
