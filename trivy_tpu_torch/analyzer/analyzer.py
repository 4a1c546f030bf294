"""Registry + group + result merging."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..types import OS, BlobInfo, Repository

_REGISTRY: list = []


class Analyzer:
    """Base analyzer. Subclasses set ``type``/``version`` and implement
    ``required(path, size)`` + ``analyze(path, content)``.

    Analyzers whose gate is a fixed path or basename set may declare
    ``exact_paths`` / ``basenames`` instead of implementing
    ``required`` — the group then dispatches them via dict lookups
    rather than calling every analyzer's gate on every file (the
    per-file required() fan-out was a measurable slice of fleet-scan
    host time). ``required`` is derived from the declared sets so
    there is a single source of truth."""

    type: str = ""
    version: int = 1
    exact_paths: frozenset = frozenset()
    basenames: frozenset = frozenset()

    def required(self, path: str, size: Optional[int] = None) -> bool:
        if self.exact_paths or self.basenames:
            return path in self.exact_paths or \
                path.rpartition("/")[2] in self.basenames
        raise NotImplementedError

    def analyze(self, path: str, content: bytes)\
            -> "AnalysisResult":
        raise NotImplementedError


def register_analyzer(a) -> "Analyzer":
    """Usable as ``@register_analyzer`` on a class (instantiates it)
    or called with an instance."""
    _REGISTRY.append(a() if isinstance(a, type) else a)
    return a


def registered_analyzers() -> list:
    return list(_REGISTRY)


@dataclass
class AnalysisResult:
    """Mergeable fragment (reference: analyzer.go AnalysisResult)."""

    os: Optional[OS] = None
    repository: Optional[Repository] = None
    package_infos: list = field(default_factory=list)
    applications: list = field(default_factory=list)
    config_files: list = field(default_factory=list)
    secrets: list = field(default_factory=list)
    licenses: list = field(default_factory=list)
    system_files: list = field(default_factory=list)
    custom_resources: list = field(default_factory=list)
    secret_candidates: list = field(default_factory=list)  # (path, data)
    build_info: Optional[dict] = None      # Red Hat only

    def merge(self, other: "AnalysisResult") -> None:
        if other is None:
            return
        if other.os is not None:
            self.os = _merge_os(self.os, other.os)
        if other.build_info:
            # content-manifest and buildinfo-Dockerfile analyzers
            # contribute different keys of the same record
            self.build_info = {**(self.build_info or {}),
                               **other.build_info}
        if other.repository is not None:
            self.repository = other.repository
        self.package_infos.extend(other.package_infos)
        self.applications.extend(other.applications)
        self.config_files.extend(other.config_files)
        self.secrets.extend(other.secrets)
        self.licenses.extend(other.licenses)
        self.system_files.extend(other.system_files)
        self.custom_resources.extend(other.custom_resources)
        self.secret_candidates.extend(other.secret_candidates)

    def sort(self) -> None:
        """Reference AnalysisResult.Sort (analyzer.go:175-230):
        deterministic ordering before the blob is written."""
        self.package_infos.sort(key=lambda p: p.file_path)
        for pi in self.package_infos:
            pi.packages.sort(key=lambda p: p.name)
        self.applications.sort(key=lambda a: a.file_path)
        for app in self.applications:
            app.libraries.sort(key=lambda p: (p.name, p.version))
        self.custom_resources.sort(key=lambda c: c.file_path)
        self.secrets.sort(key=lambda s: s.file_path)
        for sec in self.secrets:
            sec.findings.sort(key=lambda f: (f.rule_id, f.start_line))
        self.licenses.sort(
            key=lambda lf: (lf.type, lf.file_path))

    def to_blob_info(self, diff_id: str = "", digest: str = "")\
            -> BlobInfo:
        self.sort()
        return BlobInfo(
            diff_id=diff_id,
            digest=digest,
            os=self.os,
            repository=self.repository,
            package_infos=self.package_infos,
            applications=self.applications,
            config_files=self.config_files,
            secrets=self.secrets,
            licenses=self.licenses,
            system_files=self.system_files,
            custom_resources=self.custom_resources,
            build_info=self.build_info,
        )


def _merge_os(old: Optional[OS], new: OS) -> OS:
    """OS.Merge semantics (fanal types): later analyzers fill gaps;
    the 'release' file never overrides a specific family; ubuntu wins
    over debian (ubuntu ships /etc/debian_version too)."""
    if old is None:
        return new
    if old.family and new.family and old.family != new.family:
        # specific families beat the generic os-release fallback;
        # the version must come from the WINNING family's analyzer
        # (ubuntu 22.04 + debian bookworm/sid must not mix)
        if new.family == "ubuntu" or (old.family == "debian"
                                      and new.family != "debian"):
            family, name = new.family, (new.name or old.name)
        else:
            family, name = old.family, (old.name or new.name)
        return OS(family=family, name=name, eosl=old.eosl or new.eosl)
    return OS(family=new.family or old.family,
              name=new.name or old.name,
              eosl=old.eosl or new.eosl,
              extended=old.extended or new.extended)


class AnalyzerGroup:
    """Fans a file out to all matching analyzers
    (analyzer.go:393-447; the goroutine pool becomes a plain loop —
    parallelism lives in the batched kernels, not host threads)."""

    def __init__(self, disabled: Optional[list] = None,
                 file_patterns: Optional[dict] = None):
        self.disabled = set(disabled or [])
        # --file-patterns TYPE:regex overrides (analyzer.go:464)
        self.patterns = {t: re.compile(p)
                         for t, p in (file_patterns or {}).items()}
        self.analyzers = [a for a in registered_analyzers()
                          if a.type not in self.disabled]
        # dispatch tables for declared-gate analyzers; anything with
        # a --file-patterns override stays in the probe loop so the
        # override can force it on arbitrary paths
        self._by_path: dict = {}
        self._by_base: dict = {}
        self._probe: list = []
        for a in self.analyzers:
            declared = a.exact_paths or a.basenames
            if not declared or a.type in self.patterns:
                self._probe.append(a)
                continue
            for p in a.exact_paths:
                self._by_path.setdefault(p, []).append(a)
            for b in a.basenames:
                self._by_base.setdefault(b, []).append(a)

    def versions(self) -> dict:
        return {a.type: a.version for a in self.analyzers}

    def analyze_file(self, result: AnalysisResult, path: str,
                     content_fn: Callable, size: int) -> None:
        content = None          # read once, shared by all analyzers
        matched = list(self._by_path.get(path, ()))
        for a in self._by_base.get(path.rpartition("/")[2], ()):
            if a not in matched:   # declared in both tables
                matched.append(a)
        for a in matched:
            if content is None:
                content = content_fn()
            result.merge(a.analyze(path, content))
        for a in self._probe:
            pat = self.patterns.get(a.type)
            if pat is not None and pat.search(path):
                pass                      # forced by --file-patterns
            elif not a.required(path, size):
                continue
            if content is None:
                content = content_fn()
            result.merge(a.analyze(path, content))
