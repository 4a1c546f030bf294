"""SPDX 2.2 decoder — JSON and tag-value.

Decode (ref pkg/sbom/spdx/unmarshal.go): reconstruct the OS /
application / package tree from SPDX relationships; package identity
comes from the purl external reference, source packages from
"built package from:" sourceInfo, trivy metadata from attribution
texts. The SPDX writer waits with the other report formats.
"""

from __future__ import annotations

from .. import purl as purl_mod
from ..types.artifact import OS, Application, PackageInfo
from .cyclonedx import DecodedSBOM

SOURCE_PACKAGE_PREFIX = "built package from"

# element SPDXID prefixes; the decoder ignores relationship types
EL_OS = "OperatingSystem"
EL_APP = "Application"


# per-file installed-package types whose FilePath is a target label,
# not a lockfile path (unmarshal.go:139-151)
_NO_FILE_PATH_TYPES = ("node-pkg", "python-pkg", "gemspec", "jar")


def unmarshal(doc: dict) -> DecodedSBOM:
    out = DecodedSBOM()
    packages = {p.get("SPDXID", ""): p
                for p in doc.get("packages") or []}
    os_pkgs = []
    apps = {}

    for rel in doc.get("relationships") or []:
        ref_a = rel.get("spdxElementId", "")
        ref_b = rel.get("relatedSpdxElement", "")
        pkg_a = packages.get(ref_a, {})
        pkg_b = packages.get(ref_b, {})
        if ref_b.startswith(f"SPDXRef-{EL_OS}"):
            out.os = OS(family=pkg_b.get("name", ""),
                        name=pkg_b.get("versionInfo", ""))
        elif ref_a.startswith(f"SPDXRef-{EL_OS}"):
            pkg = _parse_pkg(pkg_b)
            if pkg is not None:
                os_pkgs.append(pkg)
        elif ref_b.startswith(f"SPDXRef-{EL_APP}"):
            pass
        elif ref_a.startswith(f"SPDXRef-{EL_APP}"):
            app = apps.get(ref_a)
            if app is None:
                app = _init_application(pkg_a)
                apps[ref_a] = app
            lib = _parse_pkg(pkg_b)
            if lib is not None:
                app.libraries.append(lib)

    if os_pkgs:
        out.packages = [PackageInfo(packages=os_pkgs)]
    out.applications = [apps[k] for k in sorted(apps)]
    out.spdx = doc
    return out


def _init_application(pkg: dict) -> Application:
    app = Application(type=pkg.get("name", ""),
                      file_path=pkg.get("sourceInfo", ""))
    if app.type in _NO_FILE_PATH_TYPES:
        app.file_path = ""
    return app


def _attr(pkg: dict, key: str) -> str:
    for text in pkg.get("attributionTexts") or []:
        if text.startswith(key + ": "):
            return text[len(key) + 2:]
    return ""


def _parse_pkg(spdx_pkg: dict):
    pkg = None
    ptype = ""
    for ref in spdx_pkg.get("externalRefs") or []:
        if ref.get("referenceType") == "purl" and \
                ref.get("referenceCategory") == "PACKAGE-MANAGER":
            try:
                p = purl_mod.from_string(ref.get("referenceLocator", ""))
            except ValueError:
                return None
            pkg = p.package()
            pkg.ref = ref.get("referenceLocator", "")
            ptype = p.type
            break
    if pkg is None:
        return None

    declared = spdx_pkg.get("licenseDeclared", "")
    if declared and declared != "NONE":
        pkg.licenses = [s.strip() for s in declared.split(",")]

    src = spdx_pkg.get("sourceInfo", "")
    if src.startswith(SOURCE_PACKAGE_PREFIX):
        src_nv = src[len(SOURCE_PACKAGE_PREFIX) + 2:]
        parts = src_nv.split(" ")
        if len(parts) == 2:
            pkg.src_name, ver = parts
            if ptype == "rpm":
                epoch, v, rel = purl_mod._split_rpm_evr(ver)
                pkg.src_epoch, pkg.src_version, pkg.src_release = \
                    epoch, v, rel
            else:
                pkg.src_version = ver

    for f in spdx_pkg.get("hasFiles") or []:
        # file SPDXIDs resolve at document level; keep the raw name if
        # the package carries it inline (tools-golang keeps both)
        pkg.file_path = pkg.file_path or ""
    pkg.id = _attr(spdx_pkg, "PkgID") or pkg.id
    pkg.layer.digest = _attr(spdx_pkg, "LayerDigest")
    pkg.layer.diff_id = _attr(spdx_pkg, "LayerDiffID")
    return pkg


# --------------------------------------------------------- tag-value


def parse_tag_value(text: str) -> dict:
    """Tag-value document → the same dict shape the JSON loader uses."""
    doc = {"packages": [], "relationships": []}
    cur = doc          # top-level until the first PackageName
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        tag, _, value = line.partition(":")
        value = value.strip()
        if value.startswith("<text>"):
            value = value[len("<text>"):]
            while "</text>" not in value and i < len(lines):
                value += "\n" + lines[i]
                i += 1
            value = value.split("</text>")[0]
        tag = tag.strip()
        if tag == "PackageName":
            cur = {"name": value}
            doc["packages"].append(cur)
        elif tag == "SPDXID":
            if cur is doc:
                doc["SPDXID"] = value
            else:
                cur["SPDXID"] = value
        elif tag == "PackageVersion":
            cur["versionInfo"] = value
        elif tag == "PackageSourceInfo":
            cur["sourceInfo"] = value
        elif tag == "PackageLicenseDeclared":
            cur["licenseDeclared"] = value
        elif tag == "PackageLicenseConcluded":
            cur["licenseConcluded"] = value
        elif tag == "PackageAttributionText":
            cur.setdefault("attributionTexts", []).append(value)
        elif tag == "ExternalRef":
            parts = value.split(" ", 2)
            if len(parts) == 3:
                cur.setdefault("externalRefs", []).append({
                    "referenceCategory": parts[0],
                    "referenceType": parts[1],
                    "referenceLocator": parts[2]})
        elif tag == "Relationship":
            parts = value.split(" ")
            if len(parts) == 3:
                doc["relationships"].append({
                    "spdxElementId": parts[0],
                    "relationshipType": parts[1],
                    "relatedSpdxElement": parts[2]})
        elif tag == "DocumentName":
            doc["name"] = value
        elif tag == "SPDXVersion":
            doc["spdxVersion"] = value
    return doc
