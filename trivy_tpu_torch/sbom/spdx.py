"""SPDX 2.2 codec — JSON and tag-value, both directions.

Decode (ref pkg/sbom/spdx/unmarshal.go): reconstruct the OS /
application / package tree from SPDX relationships; package identity
comes from the purl external reference, source packages from
"built package from:" sourceInfo, trivy metadata from attribution
texts.

Encode (ref pkg/sbom/spdx/marshal.go): report → document with one
package per result (OperatingSystem / Application element) containing
its packages, root package DESCRIBEd by the document.
"""

from __future__ import annotations

import hashlib
import json
import uuid as _uuid
from datetime import datetime, timezone

from .. import purl as purl_mod
from ..types import Report
from ..types.artifact import OS, Application, PackageInfo
from ..types.common import (class_str as _class_str,
                            format_src_version as _fmt_src_version)
from .cyclonedx import DecodedSBOM

SPDX_VERSION = "SPDX-2.2"
DATA_LICENSE = "CC0-1.0"
DOC_ID = "SPDXRef-DOCUMENT"
DOC_NAMESPACE = "http://aquasecurity.github.io/trivy"
SOURCE_PACKAGE_PREFIX = "built package from"

REL_CONTAINS = "CONTAINS"
# The SPDX spec spells this DESCRIBES; the reference emits "DESCRIBE"
# (marshal.go:49) and its committed goldens contain it — parity with
# the reference wins. The decoder ignores relationship types, so both
# spellings round-trip.
REL_DESCRIBE = "DESCRIBE"

EL_OS = "OperatingSystem"
EL_APP = "Application"
EL_PKG = "Package"


# per-file installed-package types whose FilePath is a target label,
# not a lockfile path (unmarshal.go:139-151)
_NO_FILE_PATH_TYPES = ("node-pkg", "python-pkg", "gemspec", "jar")


# ---------------------------------------------------------------- decode


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


# ---------------------------------------------------------------- encode


def _pkg_id(*parts) -> str:
    raw = json.dumps(parts, sort_keys=True, default=str).encode()
    return hashlib.sha256(raw).hexdigest()[:16]


class Marshaler:
    """Report → SPDX 2.2 document dict (marshal.go:107-158)."""

    def __init__(self, timestamp: str = "", uuid_fn=None):
        self.timestamp = timestamp
        self.uuid_fn = uuid_fn or (lambda: str(_uuid.uuid4()))

    def marshal(self, report: Report) -> dict:
        packages = []
        relationships = []

        root = self._root_package(report)
        packages.append(root)
        relationships.append(_rel(DOC_ID, root["SPDXID"], REL_DESCRIBE))

        for result in report.results:
            parent = self._result_package(result, report.metadata.os)
            if parent is None:
                continue
            packages.append(parent)
            relationships.append(
                _rel(root["SPDXID"], parent["SPDXID"], REL_CONTAINS))
            for pkg in result.packages:
                sp = self._package(result.type, _class_str(result.class_),
                                   report.metadata.os, pkg)
                packages.append(sp)
                relationships.append(
                    _rel(parent["SPDXID"], sp["SPDXID"], REL_CONTAINS))

        created = self.timestamp or datetime.now(timezone.utc)\
            .strftime("%Y-%m-%dT%H:%M:%SZ")
        packages.sort(key=lambda p: p["SPDXID"])
        creation_info = {
            "creators": ["Organization: aquasecurity",
                         "Tool: trivy"],
            "created": created,
        }
        status = getattr(report, "status", "")
        if status and status != "ok":
            # degraded-mode annotation; omitted on fault-free scans
            creation_info["comment"] = f"scan status: {status}"
        return {
            "SPDXID": DOC_ID,
            "spdxVersion": SPDX_VERSION,
            "dataLicense": DATA_LICENSE,
            "name": report.artifact_name,
            "documentNamespace": (
                f"{DOC_NAMESPACE}/{report.artifact_type}/"
                f"{report.artifact_name}-{self.uuid_fn()}"),
            "creationInfo": creation_info,
            "packages": packages,
            "relationships": relationships,
        }

    def marshal_tv(self, report: Report) -> str:
        doc = self.marshal(report)
        lines = [
            f"SPDXVersion: {doc['spdxVersion']}",
            f"DataLicense: {doc['dataLicense']}",
            f"SPDXID: {doc['SPDXID']}",
            f"DocumentName: {doc['name']}",
            f"DocumentNamespace: {doc['documentNamespace']}",
            "Creator: Organization: aquasecurity",
            "Creator: Tool: trivy",
            f"Created: {doc['creationInfo']['created']}",
        ]
        for p in doc["packages"]:
            lines.append("")
            lines.append(f"##### Package: {p['name']}")
            lines.append("")
            lines.append(f"PackageName: {p['name']}")
            lines.append(f"SPDXID: {p['SPDXID']}")
            if p.get("versionInfo"):
                lines.append(f"PackageVersion: {p['versionInfo']}")
            lines.append("FilesAnalyzed: false")
            if p.get("sourceInfo"):
                lines.append("PackageSourceInfo: <text>"
                             f"{p['sourceInfo']}</text>")
            if p.get("licenseConcluded"):
                lines.append("PackageLicenseConcluded: "
                             f"{p['licenseConcluded']}")
            if p.get("licenseDeclared"):
                lines.append("PackageLicenseDeclared: "
                             f"{p['licenseDeclared']}")
            for ref in p.get("externalRefs") or []:
                lines.append(
                    f"ExternalRef: {ref['referenceCategory']} "
                    f"{ref['referenceType']} "
                    f"{ref['referenceLocator']}")
            for text in p.get("attributionTexts") or []:
                lines.append(
                    f"PackageAttributionText: <text>{text}</text>")
        lines.append("")
        for rel in doc["relationships"]:
            lines.append(
                f"Relationship: {rel['spdxElementId']} "
                f"{rel['relationshipType']} "
                f"{rel['relatedSpdxElement']}")
        return "\n".join(lines) + "\n"

    def _root_package(self, report: Report) -> dict:
        attrs = [f"SchemaVersion: {report.schema_version}"]
        meta = report.metadata
        ext_refs = []
        if report.artifact_type == "container_image":
            try:
                p = purl_mod.oci_package_url(
                    meta.repo_digests,
                    (meta.image_config or {}).get("architecture", ""))
                if p.type:
                    ext_refs.append(_purl_ref(p.to_string()))
            except ValueError:
                pass
        if meta.image_id:
            attrs.append(f"ImageID: {meta.image_id}")
        if meta.size:
            attrs.append(f"Size: {meta.size}")
        for d in meta.repo_digests:
            attrs.append(f"RepoDigest: {d}")
        for d in meta.diff_ids:
            attrs.append(f"DiffID: {d}")
        for t in meta.repo_tags:
            attrs.append(f"RepoTag: {t}")
        element = "".join(w.capitalize() for w in
                          report.artifact_type.split("_")) or "Artifact"
        pid = _pkg_id(report.artifact_name, report.artifact_type)
        pkg = {
            "name": report.artifact_name,
            "SPDXID": f"SPDXRef-{element}-{pid}",
            "filesAnalyzed": False,
            "attributionTexts": attrs,
        }
        if ext_refs:
            pkg["externalRefs"] = ext_refs
        return pkg

    def _result_package(self, result, os_found):
        if _class_str(result.class_) == "os-pkgs":
            if os_found is None:
                return None
            return {
                "name": os_found.family,
                "versionInfo": os_found.name,
                "SPDXID": f"SPDXRef-{EL_OS}-"
                          f"{_pkg_id(os_found.family, os_found.name)}",
                "filesAnalyzed": False,
            }
        if _class_str(result.class_) == "lang-pkgs":
            return {
                "name": result.type,
                "sourceInfo": result.target,
                "SPDXID": f"SPDXRef-{EL_APP}-"
                          f"{_pkg_id(result.target, result.type)}",
                "filesAnalyzed": False,
            }
        return None

    def _package(self, pkg_type: str, result_class: str, os_found,
                 pkg) -> dict:
        license_str = ", ".join(pkg.licenses) if pkg.licenses \
            else "NONE"
        pu = purl_mod.new_package_url(pkg_type, pkg, os=os_found)
        sp = {
            "name": pkg.name,
            "SPDXID": f"SPDXRef-{EL_PKG}-"
                      f"{_pkg_id(pkg.name, pkg.version, pkg.release, pkg.file_path)}",
            "filesAnalyzed": False,
            "licenseConcluded": license_str,
            "licenseDeclared": license_str,
            "externalRefs": [_purl_ref(pu.to_string())],
        }
        if pkg.version:
            sp["versionInfo"] = pkg.version
        if result_class == "os-pkgs" and pkg.src_name:
            sp["sourceInfo"] = (f"{SOURCE_PACKAGE_PREFIX}: "
                                f"{pkg.src_name} "
                                f"{_fmt_src_version(pkg)}")
        attrs = []
        if pkg.id:
            attrs.append(f"PkgID: {pkg.id}")
        if pkg.layer.digest:
            attrs.append(f"LayerDigest: {pkg.layer.digest}")
        if pkg.layer.diff_id:
            attrs.append(f"LayerDiffID: {pkg.layer.diff_id}")
        if attrs:
            sp["attributionTexts"] = attrs
        return sp


def _rel(ref_a: str, ref_b: str, op: str) -> dict:
    return {"spdxElementId": ref_a, "relationshipType": op,
            "relatedSpdxElement": ref_b}


def _purl_ref(locator: str) -> dict:
    return {"referenceCategory": "PACKAGE-MANAGER",
            "referenceType": "purl",
            "referenceLocator": locator}
