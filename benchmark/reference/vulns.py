"""The plain vulnerability match: every advisory row of every package,
one comparison at a time, with the frozen version grammars.

The rules are trivy's (``pkg/detector/ospkg``, ``pkg/detector/library``):
- debian and alpine look an OS package up by its source package name
  (a dpkg ``Source:`` field names another package) and compare its
  source version; rocky looks up the binary name and compares the
  binary version;
- an alpine advisory with an AffectedVersion above the installed
  version does not apply; one without a FixedVersion applies where the
  distro reports unfixed advisories (alpine, debian; not rocky), and
  otherwise the installed version has to be below the fixed one;
- a library advisory applies where the version matches one of its
  vulnerable ranges and none of its patched ones; its FixedVersion is
  the patched ranges, or else the bounds of its ``<`` comparators.
- a Go module's version read from a ``go.mod`` is reported without its
  leading ``v`` (trivy's go.mod parser trims it; a BOM's purl keeps
  it).
A finding is (package kind, package name, installed version,
vulnerability id, fixed version), the kind being ``os`` or the
lockfile's type.
"""

from __future__ import annotations

from ..traffic.advisories import rows_of
from .vercmp import get_comparer, is_vulnerable

# distro family → (looks up the source name, reports unfixed)
OS_RULES = {"debian": (True, True), "alpine": (True, True),
            "rocky": (False, False)}
# lockfile or application type → ecosystem
APP_ECOSYSTEM = {"npm": "npm", "pip": "pip", "gomod": "go",
                 "jar": "maven", "bundler": "rubygems"}


def _os_findings(plans, family: str, bucket: str, grammar: str,
                 pkgs: list, src_names: dict) -> set:
    by_source, unfixed_too = OS_RULES[family]
    cmp = get_comparer(grammar)
    out = set()
    for name, ver, p in pkgs:
        lookup = src_names.get(name, name) if by_source else name
        if lookup != name:
            continue        # the source package has no advisories
        installed = cmp.parse(ver)
        for cve, value in rows_of(plans, bucket, p):
            affected = value.get("AffectedVersion", "")
            if affected and cmp.parse(affected) > installed:
                continue
            fixed = value.get("FixedVersion", "")
            if not fixed:
                hit = unfixed_too
            else:
                hit = installed < cmp.parse(fixed)
            if hit:
                out.add(("os", name, ver, cve, fixed))
    return out


def _fixed(value: dict) -> str:
    if value.get("PatchedVersions"):
        return ", ".join(value["PatchedVersions"])
    bounds = []
    for v in value.get("VulnerableVersions", []):
        for s in v.split(","):
            s = s.strip()
            if s.startswith("<") and not s.startswith("<="):
                bounds.append(s[1:].strip())
    return ", ".join(bounds)


def _lib_findings(plans, atype: str, bucket: str, grammar: str,
                  libs: list) -> set:
    cmp = get_comparer(grammar)
    out = set()
    for name, ver, p in libs:
        for cve, value in rows_of(plans, bucket, p):
            if is_vulnerable(cmp, ver, value.get("VulnerableVersions", []),
                             value.get("PatchedVersions", []), []):
                out.add((atype, name, ver, cve, _fixed(value)))
    return out


def expected(plans, os_shape: dict, truth: dict, src_names: dict,
             lockfiles: bool = True) -> tuple:
    """({(kind, name, version, source package or "")} of the packages,
    {findings}) of one
    target: ``os_shape`` has the OS ``family``, ``bucket`` and
    ``grammar``; ``truth`` is what the generator wrote (``os``:
    [(name, version, p)], ``apps``: [(type, path, bucket, grammar,
    [(name, version, p)])]); ``src_names``: {package: source package}
    where the two differ; ``lockfiles``: the libraries were read from
    lockfiles (not from a BOM)."""
    pkgs = {("os", n, v, src_names.get(n, n)) for n, v, _ in truth["os"]}
    found = _os_findings(plans, os_shape["family"], os_shape["bucket"],
                         os_shape["grammar"], truth["os"], src_names)
    for atype, _path, bucket, grammar, libs in truth["apps"]:
        if atype == "gomod" and lockfiles:
            libs = [(n, v[1:] if v.startswith("v") else v, p)
                    for n, v, p in libs]
        pkgs |= {(atype, n, v, "") for n, v, _ in libs}
        found |= _lib_findings(plans, atype, bucket, grammar, libs)
    return pkgs, found
