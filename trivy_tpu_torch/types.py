"""The report types the port's scans return, with the JSON field names
and Go ``omitempty`` behaviour of the reference shapes (pkg/fanal/types
Layer, Code/Line, SecretFinding, Secret; the severity enum, trivy-db
DataSource and pkg/types DetectedVulnerability + Vulnerability)."""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class Severity(enum.IntEnum):
    """Severity ordered low→high; string forms match the reference enum."""

    UNKNOWN = 0
    LOW = 1
    MEDIUM = 2
    HIGH = 3
    CRITICAL = 4

    def __str__(self) -> str:  # JSON uses the name
        return self.name

    @classmethod
    def parse(cls, s: str) -> "Severity":
        try:
            return cls[s.strip().upper()]
        except KeyError:
            raise ValueError(f"unknown severity: {s}")


SEVERITIES = [Severity.UNKNOWN, Severity.LOW, Severity.MEDIUM, Severity.HIGH,
              Severity.CRITICAL]


def omitempty(v: Any) -> bool:
    """Go encoding/json omitempty predicate."""
    if v is None:
        return True
    if isinstance(v, (str, bytes, list, tuple, dict)) and len(v) == 0:
        return True
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)) and not isinstance(v, enum.Enum) \
            and v == 0:
        return True
    return False


def _convert(v: Any) -> Any:
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        if hasattr(v, "to_dict"):
            return v.to_dict()
        return asdict_omitempty(v)
    if isinstance(v, (list, tuple)):
        return [_convert(x) for x in v]
    if isinstance(v, dict):
        return {k: _convert(x) for k, x in v.items()}
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


def asdict_omitempty(obj: Any) -> dict:
    """Serialize a dataclass to a JSON-ready dict.

    Field metadata keys honored:
      - ``json``: output key name (default: field name as-is)
      - ``keep``: always emit, even when empty (Go fields without omitempty)
    """
    out: dict = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if not f.metadata.get("keep", False) and omitempty(v):
            continue
        out[f.metadata.get("json", f.name)] = _convert(v)
    return out


def jfield(json_name: str, *, default: Any = dataclasses.MISSING,
           default_factory: Any = dataclasses.MISSING, keep: bool = False):
    """Dataclass field with a JSON name (and optional always-emit)."""
    kwargs: dict = {"metadata": {"json": json_name, "keep": keep}}
    if default is not dataclasses.MISSING:
        kwargs["default"] = default
    if default_factory is not dataclasses.MISSING:
        kwargs["default_factory"] = default_factory
    return field(**kwargs)


@dataclass
class Layer:
    """Origin layer of a finding (reference: pkg/fanal/types Layer)."""

    digest: str = jfield("Digest", default="")
    diff_id: str = jfield("DiffID", default="")

    def to_dict(self) -> dict:
        return asdict_omitempty(self)

    def empty(self) -> bool:
        return not self.digest and not self.diff_id


@dataclass
class Line:
    """One rendered code line (reference: pkg/fanal/types Code/Line)."""

    number: int = jfield("Number", default=0)
    content: str = jfield("Content", default="", keep=True)
    is_cause: bool = jfield("IsCause", default=False, keep=True)
    annotation: str = jfield("Annotation", default="", keep=True)
    truncated: bool = jfield("Truncated", default=False, keep=True)
    highlighted: str = jfield("Highlighted", default="")
    first_cause: bool = jfield("FirstCause", default=False, keep=True)
    last_cause: bool = jfield("LastCause", default=False, keep=True)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class Code:
    lines: list = jfield("Lines", default_factory=list)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class SecretFinding:
    rule_id: str = jfield("RuleID", default="")
    category: str = jfield("Category", default="")
    severity: str = jfield("Severity", default="")
    title: str = jfield("Title", default="")
    start_line: int = jfield("StartLine", default=0, keep=True)
    end_line: int = jfield("EndLine", default=0, keep=True)
    code: Code = jfield("Code", default_factory=Code, keep=True)
    match: str = jfield("Match", default="", keep=True)
    deleted: bool = jfield("Deleted", default=False, keep=True)
    layer: Layer = jfield("Layer", default_factory=Layer)

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        if self.layer.empty():
            d.pop("Layer", None)
        return d


@dataclass
class Secret:
    file_path: str = jfield("FilePath", default="")
    findings: list = jfield("Findings", default_factory=list)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class DataSource:
    """Advisory data source (reference: trivy-db types.DataSource)."""

    id: str = jfield("ID", default="")
    name: str = jfield("Name", default="")
    url: str = jfield("URL", default="")

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


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
    last_modified_date: Optional[str] = jfield("LastModifiedDate",
                                               default=None)

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
