"""Artifact-level types: what analyzers produce per blob/layer.

Reference shapes: pkg/fanal/types/artifact.go:26-174 (Package, BlobInfo,
ArtifactInfo), pkg/fanal/types/secret.go (Secret/SecretFinding).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .common import Code, Layer, asdict_omitempty, jfield


@dataclass
class OS:
    # Family/Name marshal unconditionally — no omitempty on either
    # (ref fanal/types/artifact.go:9-13); alpine-39-skip.json.golden
    # carries {"Family": "none", "Name": ""}
    family: str = jfield("Family", default="", keep=True)
    name: str = jfield("Name", default="", keep=True)
    # ref fanal/types/artifact.go:12 — tag is EOSL, not Eosl
    eosl: bool = jfield("EOSL", default=False)
    extended: bool = jfield("Extended", default=False)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)

    def empty(self) -> bool:
        return not self.family

    def merge(self, other: "OS") -> "OS":
        """Later layers win; `extended` support flags are sticky
        (reference: pkg/fanal/types/artifact.go OS.Merge semantics)."""
        if other.empty():
            return self
        merged = OS(family=other.family or self.family,
                    name=other.name or self.name,
                    eosl=other.eosl or self.eosl,
                    extended=other.extended or self.extended)
        return merged


@dataclass
class Repository:
    """OS package repository stream, e.g. alpine repo release."""

    family: str = jfield("Family", default="")
    release: str = jfield("Release", default="")

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class Location:
    start_line: int = jfield("StartLine", default=0)
    end_line: int = jfield("EndLine", default=0)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class Package:
    """One installed/declared package (reference: fanal types Package)."""

    id: str = jfield("ID", default="")
    name: str = jfield("Name", default="")
    version: str = jfield("Version", default="")
    release: str = jfield("Release", default="")
    epoch: int = jfield("Epoch", default=0)
    arch: str = jfield("Arch", default="")
    src_name: str = jfield("SrcName", default="")
    src_version: str = jfield("SrcVersion", default="")
    src_release: str = jfield("SrcRelease", default="")
    src_epoch: int = jfield("SrcEpoch", default=0)
    licenses: list = jfield("Licenses", default_factory=list)
    modularity_label: str = jfield("Modularitylabel", default="")
    build_info: Optional[dict] = jfield("BuildInfo", default=None)
    indirect: bool = jfield("Indirect", default=False)
    depends_on: list = jfield("DependsOn", default_factory=list)
    layer: Layer = jfield("Layer", default_factory=Layer)
    file_path: str = jfield("FilePath", default="")
    locations: list = jfield("Locations", default_factory=list)
    ref: str = jfield("Ref", default="")

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        if self.layer.empty():
            d.pop("Layer", None)
        return d

    def key(self) -> tuple:
        return (self.name, self.version, self.release, self.src_name,
                self.src_version, self.file_path)


@dataclass
class PackageInfo:
    """OS packages found at one path (e.g. lib/apk/db/installed)."""

    file_path: str = jfield("FilePath", default="")
    packages: list = jfield("Packages", default_factory=list)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class Application:
    """Language-ecosystem packages found at one path (lockfile etc.)."""

    type: str = jfield("Type", default="")
    file_path: str = jfield("FilePath", default="")
    libraries: list = jfield("Libraries", default_factory=list)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class ConfigFile:
    """Collected IaC config file awaiting misconfig evaluation
    (reference: fanal config analyzers collect; defsec evaluates)."""

    type: str = jfield("Type", default="")
    file_path: str = jfield("FilePath", default="")
    content: bytes = field(default=b"", metadata={"json": "Content"})

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
class LicenseFinding:
    category: str = jfield("Category", default="")
    name: str = jfield("Name", default="")
    confidence: float = jfield("Confidence", default=0.0)
    link: str = jfield("Link", default="")

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class LicenseFile:
    type: str = jfield("Type", default="")
    file_path: str = jfield("FilePath", default="")
    pkg_name: str = jfield("PkgName", default="")
    findings: list = jfield("Findings", default_factory=list)
    layer: Layer = jfield("Layer", default_factory=Layer)

    def to_dict(self) -> dict:
        d = asdict_omitempty(self)
        if self.layer.empty():
            d.pop("Layer", None)
        return d


@dataclass
class CustomResource:
    type: str = jfield("Type", default="")
    file_path: str = jfield("FilePath", default="")
    layer: Layer = jfield("Layer", default_factory=Layer)
    data: object = jfield("Data", default=None)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class BlobInfo:
    """Per-layer analysis result, the unit stored in the blob cache
    (reference: pkg/fanal/types/artifact.go:147-174)."""

    schema_version: int = jfield("SchemaVersion", default=2)
    digest: str = jfield("Digest", default="")
    diff_id: str = jfield("DiffID", default="")
    os: Optional[OS] = jfield("OS", default=None)
    repository: Optional[Repository] = jfield("Repository", default=None)
    package_infos: list = jfield("PackageInfos", default_factory=list)
    applications: list = jfield("Applications", default_factory=list)
    config_files: list = jfield("ConfigFiles", default_factory=list)
    misconfigurations: list = jfield("Misconfigurations", default_factory=list)
    secrets: list = jfield("Secrets", default_factory=list)
    licenses: list = jfield("Licenses", default_factory=list)
    opaque_dirs: list = jfield("OpaqueDirs", default_factory=list)
    whiteout_files: list = jfield("WhiteoutFiles", default_factory=list)
    system_files: list = jfield("SystemFiles", default_factory=list)
    custom_resources: list = jfield("CustomResources", default_factory=list)
    build_info: Optional[dict] = jfield("BuildInfo", default=None)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class ImageMetadata:
    id: str = jfield("ID", default="")
    diff_ids: list = jfield("DiffIDs", default_factory=list)
    repo_tags: list = jfield("RepoTags", default_factory=list)
    repo_digests: list = jfield("RepoDigests", default_factory=list)
    image_config: dict = jfield("ImageConfig", default_factory=dict)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


@dataclass
class ArtifactInfo:
    """Artifact-level record stored in the artifact cache."""

    schema_version: int = jfield("SchemaVersion", default=2)
    architecture: str = jfield("Architecture", default="")
    created: str = jfield("Created", default="")
    docker_version: str = jfield("DockerVersion", default="")
    os: str = jfield("OS", default="")
    history_packages: list = jfield("HistoryPackages", default_factory=list)

    def to_dict(self) -> dict:
        return asdict_omitempty(self)


# the type string the executable-digest analyzer emits and the
# unpackaged post-handler consumes — shared so producer/consumer
# can't drift
DIGEST_RESOURCE_TYPE = "executable-digest"


@dataclass
class ArtifactReference:
    """What Artifact.Inspect returns (reference: fanal artifact.go:44-47)."""

    name: str = ""
    type: str = ""
    id: str = ""
    blob_ids: list = field(default_factory=list)
    image_metadata: Optional[ImageMetadata] = None
    # original BOM header for SBOM artifacts (ref artifact.go:44-47
    # ArtifactReference.CycloneDX)
    cyclonedx: Optional[dict] = None


@dataclass
class ArtifactDetail:
    """Squashed final state after ApplyLayers (reference: applier)."""

    os: Optional[OS] = None
    repository: Optional[Repository] = None
    packages: list = field(default_factory=list)
    applications: list = field(default_factory=list)
    misconfigurations: list = field(default_factory=list)
    secrets: list = field(default_factory=list)
    licenses: list = field(default_factory=list)
    config_files: list = field(default_factory=list)
    custom_resources: list = field(default_factory=list)
    history_packages: list = field(default_factory=list)
