"""The report types a secret scan needs, with the JSON field names and
Go ``omitempty`` behaviour of the reference shapes
(pkg/fanal/types Layer, Code/Line, SecretFinding, Secret)."""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any


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
