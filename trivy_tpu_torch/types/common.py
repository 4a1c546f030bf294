"""Shared primitives: severities, result classes, layers, code snippets.

Reference shapes: pkg/fanal/types/artifact.go (Layer), pkg/types (severity
ordering in pkg/report + dbtypes severity enum).
"""

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


class ResultClass(str, enum.Enum):
    """Result classes (reference: pkg/types/report.go ResultClass)."""

    OSPKG = "os-pkgs"
    LANGPKG = "lang-pkgs"
    CONFIG = "config"
    SECRET = "secret"
    LICENSE = "license"
    LICENSE_FILE = "license-file"
    CUSTOM = "custom"


def class_str(c) -> str:
    """ResultClass (or plain string) → its JSON value."""
    return getattr(c, "value", None) or str(c)


def format_evr(epoch, version, release) -> str:
    """``[epoch:]version[-release]`` (reference:
    pkg/scanner/utils FormatVersion core)."""
    v = version or ""
    if release:
        v = f"{v}-{release}"
    if epoch:
        v = f"{epoch}:{v}"
    return v


def format_pkg_version(pkg) -> str:
    """Binary package version string (utils.FormatVersion)."""
    return format_evr(pkg.epoch, pkg.version, pkg.release)


def format_src_version(pkg) -> str:
    """Source package version string (utils.FormatSrcVersion)."""
    return format_evr(pkg.src_epoch, pkg.src_version, pkg.src_release)


def omitempty(v: Any) -> bool:
    """Go encoding/json omitempty predicate."""
    if v is None:
        return True
    if isinstance(v, (str, bytes, list, tuple, dict)) and len(v) == 0:
        return True
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)) and not isinstance(v, enum.Enum) and v == 0:
        return True
    return False


def _convert(v: Any) -> Any:
    if isinstance(v, enum.Enum):
        return str(v) if isinstance(v, Severity) else v.value
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


# per-class (attr, json name, keep) specs — dataclasses.fields() and
# metadata mappingproxy lookups dominate serialization on the SBOM
# fleet path otherwise
_FIELD_SPECS: dict = {}


def _field_spec(cls) -> list:
    spec = _FIELD_SPECS.get(cls)
    if spec is None:
        spec = [(f.name, f.metadata.get("json", f.name),
                 f.metadata.get("keep", False))
                for f in dataclasses.fields(cls)]
        _FIELD_SPECS[cls] = spec
    return spec


def asdict_omitempty(obj: Any) -> dict:
    """Serialize a dataclass to a JSON-ready dict.

    Field metadata keys honored:
      - ``json``: output key name (default: field name as-is)
      - ``keep``: always emit, even when empty (Go fields without omitempty)
    """
    out: dict = {}
    for attr, name, keep in _field_spec(type(obj)):
        v = getattr(obj, attr)
        if not keep and omitempty(v):
            continue
        out[name] = _convert(v)
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
class DataSource:
    """Advisory data source (reference: trivy-db types.DataSource)."""

    id: str = jfield("ID", default="")
    name: str = jfield("Name", default="")
    url: str = jfield("URL", default="")

    def to_dict(self) -> dict:
        return asdict_omitempty(self)
