"""Report-level types: what the scan pipeline emits.

Reference shapes: pkg/types/report.go (Report/Result), pkg/types/vulnerability
(DetectedVulnerability + trivy-db Vulnerability detail record).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .common import DataSource, Layer, ResultClass, asdict_omitempty, jfield
from .artifact import ImageMetadata, OS


@dataclass
class Vulnerability:
    """Detail record from the vulnerability DB (trivy-db `vulnerability`
    bucket; reference: pkg/vulnerability/vulnerability.go FillInfo)."""

    title: str = jfield("Title", default="")
    description: str = jfield("Description", default="")
    severity: str = jfield("Severity", default="")
    cwe_ids: list = jfield("CweIDs", default_factory=list)
    vendor_severity: dict = jfield("VendorSeverity", default_factory=dict)
    cvss: dict = jfield("CVSS", default_factory=dict)
    references: list = jfield("References", default_factory=list)
    published_date: Optional[str] = jfield("PublishedDate", default=None)
    last_modified_date: Optional[str] = jfield("LastModifiedDate", default=None)

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        # trivy-db tags VendorSeverity json:"-": internal only
        d.pop("VendorSeverity", None)
        return d


@dataclass
class DetectedVulnerability:
    vulnerability_id: str = jfield("VulnerabilityID", default="")
    vendor_ids: list = jfield("VendorIDs", default_factory=list)
    pkg_id: str = jfield("PkgID", default="")
    pkg_name: str = jfield("PkgName", default="")
    pkg_path: str = jfield("PkgPath", default="")
    installed_version: str = jfield("InstalledVersion", default="")
    fixed_version: str = jfield("FixedVersion", default="")
    layer: Layer = jfield("Layer", default_factory=Layer)
    severity_source: str = jfield("SeveritySource", default="")
    primary_url: str = jfield("PrimaryURL", default="")
    ref: str = jfield("Ref", default="")
    data_source: Optional[DataSource] = jfield("DataSource", default=None)
    custom: object = jfield("Custom", default=None)
    # Embedded Vulnerability detail (filled by enrichment)
    vulnerability: Vulnerability = field(default_factory=Vulnerability)

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        d.pop("vulnerability", None)
        if self.layer.empty():
            d.pop("Layer", None)
        # Go embeds the Vulnerability struct inline in JSON.
        d.update(self.vulnerability.to_dict())
        return d

    @property
    def severity(self) -> str:
        return self.vulnerability.severity or "UNKNOWN"


@dataclass
class CauseMetadata:
    resource: str = jfield("Resource", default="")
    provider: str = jfield("Provider", default="")
    service: str = jfield("Service", default="")
    start_line: int = jfield("StartLine", default=0)
    end_line: int = jfield("EndLine", default=0)
    code: object = jfield("Code", default=None, keep=True)

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        if d.get("Code") is None:
            # Go marshals the zero Code struct, not null
            # (ftypes.Code has no omitempty: {"Lines": null})
            d["Code"] = {"Lines": None}
        return d


@dataclass
class MisconfResult:
    """One policy evaluation result inside a collected config file."""

    namespace: str = jfield("Namespace", default="")
    query: str = jfield("Query", default="")
    message: str = jfield("Message", default="")
    id: str = jfield("ID", default="")
    avd_id: str = jfield("AVDID", default="")
    type: str = jfield("Type", default="")
    title: str = jfield("Title", default="")
    description: str = jfield("Description", default="")
    severity: str = jfield("Severity", default="")
    recommended_actions: str = jfield("RecommendedActions", default="")
    references: list = jfield("References", default_factory=list)
    status: str = jfield("Status", default="")
    cause_metadata: CauseMetadata = jfield(
        "CauseMetadata", default_factory=CauseMetadata)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class Misconfiguration:
    """Per-file misconfig evaluation results (blob-level)."""

    file_type: str = jfield("FileType", default="")
    file_path: str = jfield("FilePath", default="")
    successes: list = jfield("Successes", default_factory=list)
    warnings: list = jfield("Warnings", default_factory=list)
    failures: list = jfield("Failures", default_factory=list)
    exceptions: list = jfield("Exceptions", default_factory=list)
    layer: Layer = jfield("Layer", default_factory=Layer)
    # --trace evaluation visibility lines (rego-trace analog)
    traces: list = jfield("Traces", default_factory=list)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class MisconfSummary:
    successes: int = jfield("Successes", default=0, keep=True)
    failures: int = jfield("Failures", default=0, keep=True)
    exceptions: int = jfield("Exceptions", default=0, keep=True)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)

    def empty(self) -> bool:
        return self.successes == 0 and self.failures == 0 and \
            self.exceptions == 0


@dataclass
class DetectedMisconfiguration:
    """Report-level misconfiguration entry."""

    type: str = jfield("Type", default="")
    id: str = jfield("ID", default="")
    avd_id: str = jfield("AVDID", default="")
    title: str = jfield("Title", default="")
    description: str = jfield("Description", default="")
    message: str = jfield("Message", default="")
    namespace: str = jfield("Namespace", default="")
    query: str = jfield("Query", default="")
    resolution: str = jfield("Resolution", default="")
    severity: str = jfield("Severity", default="")
    primary_url: str = jfield("PrimaryURL", default="")
    references: list = jfield("References", default_factory=list)
    status: str = jfield("Status", default="")
    layer: Layer = jfield("Layer", default_factory=Layer)
    cause_metadata: CauseMetadata = jfield(
        "CauseMetadata", default_factory=CauseMetadata)
    traces: list = jfield("Traces", default_factory=list)

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        if self.layer.empty():
            d.pop("Layer", None)
        return d


@dataclass
class DetectedLicense:
    severity: str = jfield("Severity", default="")
    category: str = jfield("Category", default="")
    pkg_name: str = jfield("PkgName", default="")
    file_path: str = jfield("FilePath", default="")
    name: str = jfield("Name", default="")
    confidence: float = jfield("Confidence", default=0.0)
    link: str = jfield("Link", default="")

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class Result:
    """One scan result group (reference: pkg/types/report.go Result)."""

    target: str = jfield("Target", default="", keep=True)
    class_: ResultClass = jfield("Class", default=ResultClass.OSPKG)
    type: str = jfield("Type", default="")
    packages: list = jfield("Packages", default_factory=list)
    vulnerabilities: list = jfield("Vulnerabilities", default_factory=list)
    misconf_summary: Optional[MisconfSummary] = jfield(
        "MisconfSummary", default=None)
    misconfigurations: list = jfield("Misconfigurations",
                                     default_factory=list)
    secrets: list = jfield("Secrets", default_factory=list)
    licenses: list = jfield("Licenses", default_factory=list)
    custom_resources: list = jfield("CustomResources", default_factory=list)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)

    def empty(self) -> bool:
        # a summary of all-passing checks is still a reportable
        # result (ref: MisconfSummary emitted with no failures)
        if self.misconf_summary is not None:
            return False
        return not (self.packages or self.vulnerabilities or
                    self.misconfigurations or self.secrets or self.licenses or
                    self.custom_resources)

    def failed(self) -> bool:
        """Does this result carry actionable findings (exit-code gate)?
        Reference: pkg/types/report.go Results.Failed()."""
        if self.vulnerabilities or self.secrets:
            return True
        for m in self.misconfigurations:
            if getattr(m, "status", "") == "FAIL":
                return True
        return bool(self.licenses)


# --- degraded-mode scan status (docs/robustness.md) ---

STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_FAILED = "failed"


@dataclass
class FailureCause:
    """Machine-readable cause attached to a degraded/failed target:
    which failure domain broke (stage), how it was handled (kind),
    and the underlying error text."""

    stage: str = jfield("Stage", default="")    # cache|host|device|rpc|sched
    kind: str = jfield("Kind", default="")      # quarantined|circuit_open|...
    message: str = jfield("Message", default="")

    def to_dict(self) -> dict:
        return asdict_omitempty(self)

    @classmethod
    def coerce(cls, c) -> "FailureCause":
        if isinstance(c, cls):
            return c
        return cls(stage=c.get("stage", ""), kind=c.get("kind", ""),
                   message=c.get("message", ""))


# Go's encoding/json cannot omit an empty struct: Metadata.ImageConfig
# (a v1.ConfigFile value) always serializes, as this zero value for
# non-image scans (see any fs golden, e.g. integration/testdata/
# pip.json.golden Metadata).
EMPTY_IMAGE_CONFIG = {
    "architecture": "",
    "created": "0001-01-01T00:00:00Z",
    "os": "",
    "rootfs": {"type": "", "diff_ids": None},
    "config": {},
}


@dataclass
class Metadata:
    size: int = jfield("Size", default=0)
    os: Optional[OS] = jfield("OS", default=None)
    image_id: str = jfield("ImageID", default="")
    diff_ids: list = jfield("DiffIDs", default_factory=list)
    repo_tags: list = jfield("RepoTags", default_factory=list)
    repo_digests: list = jfield("RepoDigests", default_factory=list)
    image_config: dict = jfield("ImageConfig", default_factory=dict)

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        d["ImageConfig"] = self.image_config or \
            dict(EMPTY_IMAGE_CONFIG)
        return d


@dataclass
class Report:
    schema_version: int = jfield("SchemaVersion", default=2, keep=True)
    artifact_name: str = jfield("ArtifactName", default="", keep=True)
    artifact_type: str = jfield("ArtifactType", default="")
    metadata: Metadata = jfield("Metadata", default_factory=Metadata,
                                keep=True)
    results: list = jfield("Results", default_factory=list)
    # degraded-mode annotations: "" means ok and is omitted from the
    # JSON, so fault-free reports stay byte-identical to the goldens
    status: str = jfield("Status", default="")
    failure_causes: list = jfield("FailureCauses",
                                  default_factory=list)
    # original CycloneDX header kept for SBOM rescans — never
    # serialized (ref pkg/types Report.CycloneDX `json:"-"`)
    cyclonedx: Optional[dict] = field(default=None)

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        d.pop("cyclonedx", None)
        return d

    def mark_degraded(self, causes,
                      status: str = STATUS_DEGRADED) -> None:
        """Attach failure causes; failed never downgrades back to
        degraded."""
        if self.status != STATUS_FAILED:
            self.status = status
        self.failure_causes.extend(
            FailureCause.coerce(c) for c in causes)


@dataclass
class ScanOptions:
    """Options threaded from the runner down to the driver
    (reference: pkg/types ScanOptions)."""

    vuln_type: list = field(default_factory=lambda: ["os", "library"])
    security_checks: list = field(default_factory=lambda: ["vuln", "secret"])
    list_all_packages: bool = False
    scan_removed_packages: bool = False
    # license category -> names, overriding the defaults
    # (``licensing.LicenseScanner``; empty = the default categories)
    license_categories: dict = field(default_factory=dict)
    # dispatch_jobs backend: "cuda" (default), "cpu" or "cpu-ref"
    backend: str = "cuda"
