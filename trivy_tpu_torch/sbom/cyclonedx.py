"""CycloneDX JSON codec, both directions.

Decode (ref pkg/sbom/cyclonedx/unmarshal.go): walk the dependency
graph from each typed component — operating-system components carry OS
packages, application components carry lockfile packages, orphan
library components aggregate by ecosystem — and back-convert each
library's purl into a fanal Package.

Encode (ref pkg/sbom/cyclonedx/marshal.go): report → component tree
with purls, trivy properties, license expressions, vulnerability
ratings per vendor severity source.
"""

from __future__ import annotations

import logging
import uuid as _uuid
from datetime import datetime, timezone

from .. import purl as purl_mod
from ..types import Report
from ..types.artifact import OS, Application, Package, PackageInfo
from ..types.common import (class_str as _class_str,
                            format_pkg_version as _fmt_version,
                            format_src_version as _fmt_src_version)

log = logging.getLogger("trivy_tpu_torch.sbom.cyclonedx")

NAMESPACE = "aquasecurity:trivy:"

PROP_SCHEMA_VERSION = "SchemaVersion"
PROP_TYPE = "Type"
PROP_CLASS = "Class"
PROP_SIZE = "Size"
PROP_IMAGE_ID = "ImageID"
PROP_REPO_DIGEST = "RepoDigest"
PROP_DIFF_ID = "DiffID"
PROP_REPO_TAG = "RepoTag"
PROP_PKG_ID = "PkgID"
PROP_PKG_TYPE = "PkgType"
PROP_SRC_NAME = "SrcName"
PROP_SRC_VERSION = "SrcVersion"
PROP_SRC_RELEASE = "SrcRelease"
PROP_SRC_EPOCH = "SrcEpoch"
PROP_MODULARITYLABEL = "Modularitylabel"
PROP_FILE_PATH = "FilePath"
PROP_LAYER_DIGEST = "LayerDigest"
PROP_LAYER_DIFF_ID = "LayerDiffID"

TIME_LAYOUT = "%Y-%m-%dT%H:%M:%S+00:00"


# per-file installed-package types hang off the metadata component
_AGGREGATE_TYPES = ("node-pkg", "python-pkg", "gobinary", "gemspec",
                    "jar", "rustbinary")


def _prop(props, key: str, default: str = "") -> str:
    for p in props or []:
        if p.get("name") == NAMESPACE + key:
            return p.get("value", "")
    return default


# ---------------------------------------------------------------- decode


class DecodedSBOM:
    """What an SBOM file decodes into (ref pkg/types SBOM struct)."""

    def __init__(self):
        self.os = None                 # Optional[OS]
        self.packages = []             # [PackageInfo]
        self.applications = []         # [Application]
        self.cyclonedx = None          # original doc header (dict)
        self.spdx = None               # original SPDX doc (dict)


def unmarshal(doc: dict) -> DecodedSBOM:
    """Decode a CycloneDX JSON document (unmarshal.go:26-113)."""
    out = DecodedSBOM()
    components = {}
    for comp in doc.get("components") or []:
        components[comp.get("bom-ref", "")] = comp
    meta = doc.get("metadata") or {}
    if meta.get("component"):
        components[meta["component"].get("bom-ref", "")] = \
            meta["component"]

    dependencies = {}
    for dep in doc.get("dependencies") or []:
        dependencies.setdefault(dep.get("ref", ""),
                                dep.get("dependsOn") or [])

    def walk(root_ref, acc, seen_walk):
        for ref in dependencies.get(root_ref, []):
            comp = components.get(ref)
            if comp is None or ref in seen_walk:
                continue
            seen_walk.add(ref)
            if comp.get("type") == "library":
                acc.append(comp)
            walk(ref, acc, seen_walk)
        return acc

    seen = set()
    for bom_ref in dependencies:
        comp = components.get(bom_ref)
        if comp is None:
            continue
        ctype = comp.get("type")
        if ctype == "operating-system":
            out.os = OS(family=comp.get("name", ""),
                        name=comp.get("version", ""))
            pkgs = _parse_pkgs(walk(bom_ref, [], set()), seen)
            out.packages.append(PackageInfo(packages=pkgs))
        elif ctype == "application":
            if not _prop(comp.get("properties"), PROP_TYPE):
                continue   # foreign BOM; packages aggregate below
            libs = _parse_pkgs(walk(bom_ref, [], set()), seen)
            out.applications.append(Application(
                type=_prop(comp.get("properties"), PROP_TYPE),
                file_path=comp.get("name", ""),
                libraries=libs))

    # Orphan libraries (not reachable from any typed component, e.g. a
    # BOM from another tool): language packages aggregate per
    # ecosystem; OS purl types (apk/deb/rpm) join the OS package set
    # so they still reach the ospkg detector.
    orphans = [c for ref, c in components.items()
               if ref not in seen and c.get("type") == "library"]
    by_type = {}
    orphan_os_pkgs = []
    for comp in orphans:
        purl_str = comp.get("purl", "")
        app_type, pkg = _to_package(comp)
        if pkg is None:
            continue
        if purl_str.startswith(("pkg:apk/", "pkg:deb/", "pkg:rpm/")):
            # foreign BOMs carry no Src* properties; the ospkg
            # drivers key on them, so default to the binary package
            if not pkg.src_name:
                pkg.src_name = pkg.name
                pkg.src_version = pkg.version
                pkg.src_release = pkg.release
                pkg.src_epoch = pkg.epoch
            orphan_os_pkgs.append(pkg)
        else:
            by_type.setdefault(app_type, []).append(pkg)
    if orphan_os_pkgs:
        out.packages.append(PackageInfo(
            packages=sorted(orphan_os_pkgs, key=lambda p: p.name)))
    for app_type in sorted(by_type):
        pkgs = sorted(by_type[app_type], key=lambda p: p.name)
        out.applications.append(Application(type=app_type,
                                            libraries=pkgs))

    out.applications.sort(key=lambda a: (a.type, a.file_path))

    mc = meta.get("component") or {}
    out.cyclonedx = {
        "bomFormat": doc.get("bomFormat", ""),
        "specVersion": doc.get("specVersion", ""),
        "serialNumber": doc.get("serialNumber", ""),
        "version": doc.get("version", 0),
        "metadata": {"component": {
            "bom-ref": mc.get("bom-ref", ""),
            "type": mc.get("type", ""),
            "name": mc.get("name", ""),
            "version": mc.get("version", ""),
        }},
    }
    return out


def _parse_pkgs(comps: list, seen: set) -> list:
    pkgs = []
    for comp in comps:
        seen.add(comp.get("bom-ref", ""))
        _, pkg = _to_package(comp)
        if pkg is not None:
            pkgs.append(pkg)
    return pkgs


def _to_package(comp: dict):
    """library component → (app_type, Package) (unmarshal.go:255-303)."""
    purl_str = comp.get("purl", "")
    if not purl_str:
        return "", None
    try:
        p = purl_mod.from_string(purl_str)
    except ValueError as e:
        log.debug("skipping component with bad purl %r: %s",
                  purl_str, e)
        return "", None
    pkg = p.package()
    pkg.ref = comp.get("bom-ref", "")
    for lic in comp.get("licenses") or []:
        if lic.get("expression"):
            pkg.licenses.append(lic["expression"])
        elif lic.get("license", {}).get("name"):
            pkg.licenses.append(lic["license"]["name"])
    props = comp.get("properties")
    if props:
        # one pass over the props list instead of one scan per key
        # (8 _prop scans per component dominated SBOM decode)
        pd = {}
        nlen = len(NAMESPACE)
        for pr in props:
            n = pr.get("name") or ""
            if n.startswith(NAMESPACE):
                # setdefault: duplicate property names resolve
                # first-wins, matching _prop's early return
                pd.setdefault(n[nlen:], pr.get("value", ""))
        if pd:
            g = pd.get
            pkg.id = g(PROP_PKG_ID, pkg.id)
            pkg.src_name = g(PROP_SRC_NAME, pkg.src_name)
            pkg.src_version = g(PROP_SRC_VERSION, pkg.src_version)
            pkg.src_release = g(PROP_SRC_RELEASE, pkg.src_release)
            epoch = g(PROP_SRC_EPOCH, "")
            if epoch:
                try:
                    pkg.src_epoch = int(epoch)
                except ValueError:
                    pass
            pkg.modularity_label = g(PROP_MODULARITYLABEL,
                                     pkg.modularity_label)
            pkg.layer.diff_id = g(PROP_LAYER_DIFF_ID, "")
            fp = g(PROP_FILE_PATH, "")
            if fp:
                pkg.file_path = fp
    return p.app_type(), pkg


# ---------------------------------------------------------------- encode


def _now_ts() -> str:
    return datetime.now(timezone.utc).strftime(TIME_LAYOUT)


_CDX_SEVERITY = {"LOW": "low", "MEDIUM": "medium", "HIGH": "high",
                 "CRITICAL": "critical"}


class Marshaler:
    """Report → CycloneDX 1.4 JSON document (marshal.go:96-432)."""

    def __init__(self, app_version: str = "dev", timestamp: str = "",
                 uuid_fn=None):
        self.app_version = app_version
        self.timestamp = timestamp
        self.uuid_fn = uuid_fn or (lambda: str(_uuid.uuid4()))

    def marshal(self, report: Report) -> dict:
        serial = f"urn:uuid:{self.uuid_fn()}"
        meta_comp = self._report_component(report)
        components, dependencies, vulns = self._components(
            report, meta_comp["bom-ref"])
        bom = {
            "bomFormat": "CycloneDX",
            "specVersion": "1.4",
            "serialNumber": serial,
            "version": 1,
            "metadata": {
                "timestamp": self.timestamp or _now_ts(),
                "tools": [{"vendor": "aquasecurity",
                           "name": "trivy",
                           "version": self.app_version}],
                "component": meta_comp,
            },
            "components": components,
            "dependencies": dependencies,
            "vulnerabilities": vulns,
        }
        status = getattr(report, "status", "")
        if status and status != "ok":
            # degraded-mode annotation (docs/robustness.md); only
            # emitted on faulted scans so fault-free BOMs keep golden
            # parity
            bom["metadata"]["properties"] = [
                {"name": "aquasecurity:trivy:ScanStatus",
                 "value": status}]
        return bom

    def marshal_vulnerabilities(self, report: Report) -> dict:
        """Vuln-only BOM referring to an external SBOM
        (marshal.go:115-165)."""
        src = report.cyclonedx or {}
        serial = src.get("serialNumber", "")
        version = src.get("version", 0)
        vuln_map = {}
        for result in report.results:
            for v in result.vulnerabilities:
                ref = v.ref
                if serial:
                    ref = (f"{serial.replace('urn:uuid:', 'urn:cdx:')}"
                           f"/{version}#{v.ref}")
                if v.vulnerability_id in vuln_map:
                    vuln_map[v.vulnerability_id]["affects"].append(
                        _affects(ref, v.installed_version))
                else:
                    vuln_map[v.vulnerability_id] = \
                        _vulnerability(ref, v)
        vulns = sorted(vuln_map.values(), key=lambda v: v["id"],
                       reverse=True)
        mc = (src.get("metadata") or {}).get("component") or {}
        comp = {"name": mc.get("name", ""),
                "type": mc.get("type", "")}
        if mc.get("version"):
            comp["version"] = mc["version"]
        if serial:
            comp["bom-ref"] = f"{serial}/{version}"
        return {
            "bomFormat": "CycloneDX",
            "specVersion": "1.4",
            "version": 1,
            "metadata": {
                "timestamp": self.timestamp or _now_ts(),
                "tools": [{"vendor": "aquasecurity",
                           "name": "trivy",
                           "version": self.app_version}],
                "component": comp,
            },
            "vulnerabilities": vulns,
        }

    def _report_component(self, report: Report) -> dict:
        comp = {"name": report.artifact_name}
        props = [_cdx_prop(PROP_SCHEMA_VERSION,
                           str(report.schema_version))]
        meta = report.metadata
        if meta.size:
            props.append(_cdx_prop(PROP_SIZE, str(meta.size)))
        if report.artifact_type == "container_image":
            comp["type"] = "container"
            if meta.image_id:
                props.append(_cdx_prop(PROP_IMAGE_ID, meta.image_id))
            try:
                p = purl_mod.oci_package_url(
                    meta.repo_digests,
                    (meta.image_config or {}).get("architecture", ""))
            except ValueError:
                p = purl_mod.PackageURL()
            if p.type:
                comp["bom-ref"] = p.to_string()
                comp["purl"] = p.to_string()
            else:
                comp["bom-ref"] = self.uuid_fn()
        else:
            comp["type"] = "application"
            comp["bom-ref"] = self.uuid_fn()
        for d in meta.repo_digests:
            props.append(_cdx_prop(PROP_REPO_DIGEST, d))
        for d in meta.diff_ids:
            props.append(_cdx_prop(PROP_DIFF_ID, d))
        for t in meta.repo_tags:
            props.append(_cdx_prop(PROP_REPO_TAG, t))
        comp["properties"] = props
        return comp

    def _components(self, report: Report, root_ref: str):
        components, dependencies, meta_deps = [], [], []
        vuln_map, lib_seen = {}, set()
        os_found = report.metadata.os
        for result in report.results:
            ref_by_pkg = {}
            comp_deps = []
            for pkg in result.packages:
                comp = _pkg_component(result.type, pkg, os_found)
                # detectors report InstalledVersion from the SOURCE
                # package for some OS families, so index under both
                # the binary and source version strings
                ref_by_pkg.setdefault(
                    (pkg.name, _fmt_version(pkg), pkg.file_path),
                    comp["bom-ref"])
                if pkg.src_version:
                    ref_by_pkg.setdefault(
                        (pkg.name, _fmt_src_version(pkg),
                         pkg.file_path), comp["bom-ref"])
                if comp["bom-ref"] not in lib_seen:
                    lib_seen.add(comp["bom-ref"])
                    components.append(comp)
                comp_deps.append(comp["bom-ref"])
            for v in result.vulnerabilities:
                key = (v.pkg_name, v.installed_version, v.pkg_path)
                ref = ref_by_pkg.get(key, "")
                if v.vulnerability_id in vuln_map:
                    vuln_map[v.vulnerability_id]["affects"].append(
                        _affects(ref, v.installed_version))
                else:
                    vuln_map[v.vulnerability_id] = \
                        _vulnerability(ref, v)
            if result.type in _AGGREGATE_TYPES:
                # per-file packages hang directly off the metadata
                # component (marshal.go:250-263)
                meta_deps.extend(comp_deps)
            elif _class_str(result.class_) in ("os-pkgs", "lang-pkgs"):
                rcomp = self._result_component(result, os_found)
                components.append(rcomp)
                dependencies.append({"ref": rcomp["bom-ref"],
                                     "dependsOn": comp_deps})
                meta_deps.append(rcomp["bom-ref"])
        vulns = sorted(vuln_map.values(), key=lambda v: v["id"],
                       reverse=True)
        dependencies.append({"ref": root_ref, "dependsOn": meta_deps})
        return components, dependencies, vulns

    def _result_component(self, result, os_found) -> dict:
        comp = {
            "bom-ref": self.uuid_fn(),
            "name": result.target,
            "properties": [_cdx_prop(PROP_TYPE, result.type),
                           _cdx_prop(PROP_CLASS, _class_str(result.class_))],
        }
        if _class_str(result.class_) == "os-pkgs":
            comp["type"] = "operating-system"
            if os_found is not None:
                comp["name"] = os_found.family
                comp["version"] = os_found.name
        else:
            comp["type"] = "application"
        return comp


def _cdx_prop(key: str, value: str) -> dict:
    return {"name": NAMESPACE + key, "value": value}


def _pkg_component(pkg_type: str, pkg: Package, os_found) -> dict:
    pu = purl_mod.new_package_url(pkg_type, pkg, os=os_found)
    props = []
    for key, value in [
            (PROP_PKG_ID, pkg.id), (PROP_PKG_TYPE, pkg_type),
            (PROP_FILE_PATH, pkg.file_path),
            (PROP_SRC_NAME, pkg.src_name),
            (PROP_SRC_VERSION, pkg.src_version),
            (PROP_SRC_RELEASE, pkg.src_release),
            (PROP_SRC_EPOCH, str(pkg.src_epoch)
             if pkg.src_epoch else ""),
            (PROP_MODULARITYLABEL, pkg.modularity_label),
            (PROP_LAYER_DIGEST, pkg.layer.digest),
            (PROP_LAYER_DIFF_ID, pkg.layer.diff_id)]:
        if value:
            props.append(_cdx_prop(key, value))
    comp = {
        "bom-ref": pu.bom_ref(),
        "type": "library",
        "name": pkg.name,
        "version": pu.version,
        "purl": pu.to_string(),
    }
    if pkg.licenses:
        comp["licenses"] = [{"expression": lic}
                            for lic in pkg.licenses]
    if props:
        comp["properties"] = props
    return comp


def _offset_ts(ts: str) -> str:
    """RFC3339 with an explicit +00:00 offset — Go's cdx encoder
    renders UTC times that way, not with Z."""
    return ts[:-1] + "+00:00" if ts.endswith("Z") else ts


def _affects(ref: str, version: str) -> dict:
    # CycloneDX 1.4 key is "versions" (cdx-go affects.Range maps to
    # it; centos-7-cyclonedx.json.golden)
    return {"ref": ref,
            "versions": [{"version": version,
                          "status": "affected"}]}


def _vulnerability(ref: str, v) -> dict:
    vuln = {
        "id": v.vulnerability_id,
        "description": getattr(v.vulnerability, "description", "")
        if v.vulnerability else "",
        "affects": [_affects(ref, v.installed_version)],
    }
    if v.data_source is not None:
        vuln["source"] = {"name": v.data_source.id,
                          "url": v.data_source.url}
    detail = v.vulnerability
    if detail is not None:
        ratings = _ratings(detail)
        if ratings:
            vuln["ratings"] = ratings
        cwes = []
        for cwe in detail.cwe_ids or []:
            num = cwe.lower().removeprefix("cwe-")
            if num.isdigit():
                cwes.append(int(num))
        if detail.cwe_ids is not None and cwes:
            vuln["cwes"] = cwes
        if detail.references:
            vuln["advisories"] = [{"url": r}
                                  for r in detail.references]
        if detail.published_date:
            vuln["published"] = _offset_ts(detail.published_date)
        if detail.last_modified_date:
            vuln["updated"] = _offset_ts(detail.last_modified_date)
    return vuln


def _nvd_severity_v2(score) -> str:
    if score < 4.0:
        return "info"
    if score < 7.0:
        return "medium"
    return "high"


def _ratings(detail) -> list:
    rates = []
    for source, severity in (detail.vendor_severity or {}).items():
        sev = _CDX_SEVERITY.get(str(severity), "unknown")
        cvss = (detail.cvss or {}).get(source)
        if cvss:
            v2s = cvss.get("V2Score", 0) or 0
            v2v = cvss.get("V2Vector", "") or ""
            v3s = cvss.get("V3Score", 0) or 0
            v3v = cvss.get("V3Vector", "") or ""
            if v2s or v2v:
                rates.append({
                    "source": {"name": source},
                    "score": v2s,
                    "severity": _nvd_severity_v2(v2s)
                    if source == "nvd" else sev,
                    "method": "CVSSv2",
                    "vector": v2v})
            if v3s or v3v:
                rates.append({
                    "source": {"name": source},
                    "score": v3s,
                    "severity": sev,
                    "method": "CVSSv31"
                    if v3v.startswith("CVSS:3.1") else "CVSSv3",
                    "vector": v3v})
        else:
            rates.append({"source": {"name": source},
                          "severity": sev})
    rates.sort(key=lambda r: (r["source"]["name"],
                              r.get("method", ""),
                              r.get("score", 0.0),
                              r.get("vector", "")))
    return rates
