"""JSON dict → domain type deserialization.

The analog of the reference's pkg/rpc/convert.go (domain ⇄ proto):
every type that crosses a process boundary — the blob cache on disk
(``artifact/cache.py FSCache``), the client/server wire (``rpc/``:
blobs and artifacts on the Cache service, the ``Result`` list of a
Scan reply) — reads back here, inverse of each type's ``to_dict``/
``asdict_omitempty`` Go-style JSON.

A blob's ``BuildInfo`` (Red Hat content sets) and ``CustomResources``
are read back too, so a scan from the disk cache reports what the
in-memory cache does, and a detected vulnerability's ``Custom`` field
crosses the wire; the JAX package's readers drop all three.
"""

from __future__ import annotations

from typing import Optional

from . import (OS, Application, ConfigFile, DataSource,
               DetectedVulnerability, Package, PackageInfo, Repository,
               Result, Secret, SecretFinding, Vulnerability)
from .artifact import ArtifactInfo, BlobInfo
from .common import Code, Layer, Line
from .report import (CauseMetadata, DetectedLicense,
                     DetectedMisconfiguration, MisconfSummary, ResultClass)

SCHEMA_VERSION = 2


def layer_from_dict(x: Optional[dict]) -> Layer:
    if not x:
        return Layer()
    return Layer(digest=x.get("Digest", ""),
                 diff_id=x.get("DiffID", ""))


def os_from_dict(x: Optional[dict]) -> Optional[OS]:
    if not x:
        return None
    return OS(family=x.get("Family", ""), name=x.get("Name", ""),
              eosl=x.get("EOSL", x.get("Eosl", False)),
              extended=x.get("Extended", False))


def package_from_dict(x: dict) -> Package:
    return Package(
        id=x.get("ID", ""), name=x.get("Name", ""),
        version=x.get("Version", ""), release=x.get("Release", ""),
        epoch=x.get("Epoch", 0), arch=x.get("Arch", ""),
        src_name=x.get("SrcName", ""),
        src_version=x.get("SrcVersion", ""),
        src_release=x.get("SrcRelease", ""),
        src_epoch=x.get("SrcEpoch", 0),
        licenses=x.get("Licenses") or [],
        modularity_label=x.get("Modularitylabel", ""),
        build_info=x.get("BuildInfo"),
        indirect=x.get("Indirect", False),
        depends_on=x.get("DependsOn") or [],
        layer=layer_from_dict(x.get("Layer")),
        file_path=x.get("FilePath", ""),
        locations=x.get("Locations") or [],
        ref=x.get("Ref", ""),
    )


def code_from_dict(x: Optional[dict]) -> Code:
    return Code(lines=[
        Line(number=ln.get("Number", 0),
             content=ln.get("Content", ""),
             is_cause=ln.get("IsCause", False),
             annotation=ln.get("Annotation", ""),
             truncated=ln.get("Truncated", False),
             highlighted=ln.get("Highlighted", ""),
             first_cause=ln.get("FirstCause", False),
             last_cause=ln.get("LastCause", False))
        for ln in (x or {}).get("Lines") or []])


def secret_finding_from_dict(x: dict) -> SecretFinding:
    return SecretFinding(
        rule_id=x.get("RuleID", ""),
        category=x.get("Category", ""),
        severity=x.get("Severity", ""),
        title=x.get("Title", ""),
        start_line=x.get("StartLine", 0),
        end_line=x.get("EndLine", 0),
        code=code_from_dict(x.get("Code")),
        match=x.get("Match", ""),
        layer=layer_from_dict(x.get("Layer")))


def secret_from_dict(x: dict) -> Secret:
    return Secret(file_path=x.get("FilePath", ""),
                  findings=[secret_finding_from_dict(f)
                            for f in x.get("Findings") or []])


def cause_metadata_from_dict(x: Optional[dict]) -> CauseMetadata:
    x = x or {}
    return CauseMetadata(
        resource=x.get("Resource", ""),
        provider=x.get("Provider", ""),
        service=x.get("Service", ""),
        start_line=x.get("StartLine", 0),
        end_line=x.get("EndLine", 0),
        code=x.get("Code"),
    )


def misconf_result_from_dict(x: dict) -> "MisconfResult":
    from .report import MisconfResult
    return MisconfResult(
        namespace=x.get("Namespace", ""),
        query=x.get("Query", ""),
        message=x.get("Message", ""),
        id=x.get("ID", ""),
        avd_id=x.get("AVDID", ""),
        type=x.get("Type", ""),
        title=x.get("Title", ""),
        description=x.get("Description", ""),
        severity=x.get("Severity", ""),
        recommended_actions=x.get("RecommendedActions", ""),
        references=x.get("References") or [],
        status=x.get("Status", ""),
        cause_metadata=cause_metadata_from_dict(
            x.get("CauseMetadata")),
    )


def misconfiguration_from_dict(x: dict):
    from . import Misconfiguration
    return Misconfiguration(
        file_type=x.get("FileType", ""),
        file_path=x.get("FilePath", ""),
        successes=[misconf_result_from_dict(r)
                   for r in x.get("Successes") or []],
        warnings=[misconf_result_from_dict(r)
                  for r in x.get("Warnings") or []],
        failures=[misconf_result_from_dict(r)
                  for r in x.get("Failures") or []],
        exceptions=[misconf_result_from_dict(r)
                    for r in x.get("Exceptions") or []],
        layer=layer_from_dict(x.get("Layer")),
        traces=x.get("Traces") or [],
    )


def license_file_from_dict(x: dict):
    from . import LicenseFile, LicenseFinding
    return LicenseFile(
        type=x.get("Type", ""),
        file_path=x.get("FilePath", ""),
        pkg_name=x.get("PkgName", ""),
        findings=[LicenseFinding(
            category=f.get("Category", ""),
            name=f.get("Name", ""),
            confidence=f.get("Confidence", 0.0),
            link=f.get("Link", ""))
            for f in x.get("Findings") or []],
        layer=layer_from_dict(x.get("Layer")),
    )


def data_source_from_dict(x: Optional[dict]) -> Optional[DataSource]:
    if not x:
        return None
    return DataSource(id=x.get("ID", ""), name=x.get("Name", ""),
                      url=x.get("URL", ""))


def detected_vulnerability_from_dict(x: dict) \
        -> DetectedVulnerability:
    """Inverse of DetectedVulnerability.to_dict, which embeds the
    Vulnerability detail inline the way Go embeds the struct."""
    detail = Vulnerability(
        title=x.get("Title", ""),
        description=x.get("Description", ""),
        severity=x.get("Severity", ""),
        cwe_ids=x.get("CweIDs") or [],
        vendor_severity=x.get("VendorSeverity") or {},
        cvss=x.get("CVSS") or {},
        references=x.get("References") or [],
        published_date=x.get("PublishedDate"),
        last_modified_date=x.get("LastModifiedDate"),
    )
    return DetectedVulnerability(
        vulnerability_id=x.get("VulnerabilityID", ""),
        vendor_ids=x.get("VendorIDs") or [],
        pkg_id=x.get("PkgID", ""),
        pkg_name=x.get("PkgName", ""),
        pkg_path=x.get("PkgPath", ""),
        installed_version=x.get("InstalledVersion", ""),
        fixed_version=x.get("FixedVersion", ""),
        layer=layer_from_dict(x.get("Layer")),
        severity_source=x.get("SeveritySource", ""),
        primary_url=x.get("PrimaryURL", ""),
        ref=x.get("Ref", ""),
        data_source=data_source_from_dict(x.get("DataSource")),
        custom=x.get("Custom"),
        vulnerability=detail,
    )


def detected_misconfiguration_from_dict(x: dict) \
        -> DetectedMisconfiguration:
    return DetectedMisconfiguration(
        type=x.get("Type", ""),
        id=x.get("ID", ""),
        avd_id=x.get("AVDID", ""),
        title=x.get("Title", ""),
        description=x.get("Description", ""),
        message=x.get("Message", ""),
        namespace=x.get("Namespace", ""),
        query=x.get("Query", ""),
        resolution=x.get("Resolution", ""),
        severity=x.get("Severity", ""),
        primary_url=x.get("PrimaryURL", ""),
        references=x.get("References") or [],
        status=x.get("Status", ""),
        layer=layer_from_dict(x.get("Layer")),
        cause_metadata=cause_metadata_from_dict(
            x.get("CauseMetadata")),
        traces=x.get("Traces") or [],
    )


def detected_license_from_dict(x: dict) -> DetectedLicense:
    return DetectedLicense(
        severity=x.get("Severity", ""),
        category=x.get("Category", ""),
        pkg_name=x.get("PkgName", ""),
        file_path=x.get("FilePath", ""),
        name=x.get("Name", ""),
        confidence=x.get("Confidence", 0.0),
        link=x.get("Link", ""),
    )


def result_from_dict(x: dict) -> Result:
    """One ``Result`` of a Scan reply (ref ``types/convert.py``)."""
    summary = None
    if x.get("MisconfSummary"):
        ms = x["MisconfSummary"]
        summary = MisconfSummary(
            successes=ms.get("Successes", 0),
            failures=ms.get("Failures", 0),
            exceptions=ms.get("Exceptions", 0))
    try:
        class_ = ResultClass(x.get("Class", "os-pkgs"))
    except ValueError:
        class_ = x.get("Class", "")
    return Result(
        target=x.get("Target", ""),
        class_=class_,
        type=x.get("Type", ""),
        packages=[package_from_dict(p)
                  for p in x.get("Packages") or []],
        vulnerabilities=[detected_vulnerability_from_dict(v)
                         for v in x.get("Vulnerabilities") or []],
        misconf_summary=summary,
        misconfigurations=[detected_misconfiguration_from_dict(m)
                           for m in
                           x.get("Misconfigurations") or []],
        secrets=[secret_finding_from_dict(s)
                 for s in x.get("Secrets") or []],
        licenses=[detected_license_from_dict(lic)
                  for lic in x.get("Licenses") or []],
        custom_resources=x.get("CustomResources") or [],
    )


def blob_info_from_dict(d: dict) -> BlobInfo:
    repo = None
    if d.get("Repository"):
        repo = Repository(
            family=d["Repository"].get("Family", ""),
            release=d["Repository"].get("Release", ""))
    return BlobInfo(
        schema_version=d.get("SchemaVersion", SCHEMA_VERSION),
        digest=d.get("Digest", ""),
        diff_id=d.get("DiffID", ""),
        os=os_from_dict(d.get("OS")),
        repository=repo,
        package_infos=[
            PackageInfo(file_path=pi.get("FilePath", ""),
                        packages=[package_from_dict(p) for p in
                                  pi.get("Packages") or []])
            for pi in d.get("PackageInfos") or []],
        applications=[
            Application(type=ap.get("Type", ""),
                        file_path=ap.get("FilePath", ""),
                        libraries=[package_from_dict(p) for p in
                                   ap.get("Libraries") or []])
            for ap in d.get("Applications") or []],
        config_files=[
            ConfigFile(type=cf.get("Type", ""),
                       file_path=cf.get("FilePath", ""),
                       content=(cf.get("Content") or "").encode())
            for cf in d.get("ConfigFiles") or []],
        misconfigurations=[misconfiguration_from_dict(m)
                           for m in
                           d.get("Misconfigurations") or []],
        secrets=[secret_from_dict(s)
                 for s in d.get("Secrets") or []],
        licenses=[license_file_from_dict(lf)
                  for lf in d.get("Licenses") or []],
        opaque_dirs=d.get("OpaqueDirs") or [],
        whiteout_files=d.get("WhiteoutFiles") or [],
        system_files=d.get("SystemFiles") or [],
        custom_resources=d.get("CustomResources") or [],
        build_info=d.get("BuildInfo"),
    )


def artifact_info_from_dict(d: dict) -> ArtifactInfo:
    return ArtifactInfo(
        schema_version=d.get("SchemaVersion", SCHEMA_VERSION),
        architecture=d.get("Architecture", ""),
        created=d.get("Created", ""),
        docker_version=d.get("DockerVersion", ""),
        os=d.get("OS", ""),
        history_packages=[package_from_dict(p) for p in
                          d.get("HistoryPackages") or []],
    )
