"""Core domain types shared across the port.

Shapes mirror the reference's report/artifact schema so JSON output is
golden-comparable (reference: pkg/types/report.go, pkg/fanal/types/artifact.go).
All dataclasses serialize via ``to_dict()`` with Go ``omitempty`` semantics:
empty strings / lists / dicts / None are dropped.
"""

from .common import (
    Severity,
    SEVERITIES,
    ResultClass,
    Layer,
    Line,
    Code,
    DataSource,
    omitempty,
    asdict_omitempty,
)
from .artifact import (
    OS,
    Repository,
    Package,
    PackageInfo,
    Application,
    ConfigFile,
    SecretFinding,
    Secret,
    LicenseFinding,
    LicenseFile,
    CustomResource,
    BlobInfo,
    ArtifactInfo,
    ArtifactReference,
    ArtifactDetail,
    ImageMetadata,
)
from .report import (
    DetectedVulnerability,
    Vulnerability,
    CauseMetadata,
    MisconfResult,
    Misconfiguration,
    MisconfSummary,
    DetectedMisconfiguration,
    DetectedLicense,
    Result,
    Metadata,
    Report,
    ScanOptions,
    FailureCause,
    STATUS_OK,
    STATUS_DEGRADED,
    STATUS_FAILED,
)

__all__ = [
    "Severity", "SEVERITIES", "ResultClass", "Layer", "Line", "Code",
    "DataSource", "omitempty", "asdict_omitempty",
    "OS", "Repository", "Package", "PackageInfo", "Application", "ConfigFile",
    "SecretFinding", "Secret", "LicenseFinding", "LicenseFile",
    "CustomResource", "BlobInfo", "ArtifactInfo", "ArtifactReference",
    "ArtifactDetail", "ImageMetadata",
    "DetectedVulnerability", "Vulnerability", "CauseMetadata", "MisconfResult",
    "Misconfiguration", "MisconfSummary", "DetectedMisconfiguration",
    "DetectedLicense", "Result", "Metadata", "Report", "ScanOptions",
    "FailureCause", "STATUS_OK", "STATUS_DEGRADED", "STATUS_FAILED",
]
