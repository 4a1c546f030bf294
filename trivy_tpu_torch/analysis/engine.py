"""AST lint engine: rule registry, typed findings, inline
suppressions (reference: ``trivy_tpu/analysis/engine.py``; the
grammar and the report are the reference's, byte for byte).

Rules are small objects with three hooks — ``collect`` (build
cross-module facts), ``check`` (per-module findings) and
``finalize`` (whole-tree findings, e.g. lock-order cycles) — run by
one :class:`Engine` over parsed :class:`ModuleInfo` records. Every
finding is typed (rule id, ``path:line``, message) and the report is
stable-sorted so ``--json`` diffs are reviewable.

Suppression grammar (FAILS closed):

    # lint: disable=<rule>[,<rule2>...] -- <reason>

* a suppression without a reason is itself a finding
  (``bad-suppression``) and suppresses nothing;
* a suppression naming an unknown rule is ``bad-suppression``;
* a suppression that matched no finding is ``unused-suppression`` —
  stale suppressions rot into lies, so they fail the run too.

The comment rides the flagged line or the line directly above it.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

# one comment per line; rule ids are kebab-case
SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Za-z0-9_,\s-]+?)"
    r"(?:\s+--\s+(.+?))?\s*$")

# meta-rule ids the engine itself emits; not suppressible
BAD_SUPPRESSION = "bad-suppression"
UNUSED_SUPPRESSION = "unused-suppression"


@dataclass
class Suppression:
    """One parsed ``# lint: disable=...`` comment."""

    rules: tuple
    reason: str
    line: int
    used: set = field(default_factory=set)

    @property
    def valid(self) -> bool:
        return bool(self.reason.strip())


@dataclass
class Finding:
    """One typed lint finding anchored at ``path:line``."""

    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    @property
    def sort_key(self) -> tuple:
        return (self.path, self.line, self.rule, self.message)

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path,
             "line": self.line, "message": self.message}
        if self.suppressed:
            d["suppressed"] = True
            d["reason"] = self.reason
        return d

    def __str__(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return (f"{self.path}:{self.line}: {self.rule}: "
                f"{self.message}{tag}")


def parse_suppressions(lines) -> dict:
    """``{line_number: Suppression}`` over raw source lines.

    Malformed comments (no reason, empty rule list) still parse —
    with ``reason == ""`` — so the engine can fail them loudly
    instead of silently honoring or ignoring them."""
    out: dict = {}
    for i, text in enumerate(lines, 1):
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",")
                      if r.strip())
        out[i] = Suppression(rules=rules,
                             reason=(m.group(2) or "").strip(),
                             line=i)
    return out


class ModuleInfo:
    """One parsed source file: path, dotted name, lines, AST,
    suppressions, and a lazily built AST parent map."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        # trivy_tpu_torch/obs/prom.py -> trivy_tpu_torch.obs.prom
        base = self.rel[:-3] if self.rel.endswith(".py") else self.rel
        self.name = base.replace("/", ".")
        # a package __init__'s dotted name IS the package — relative
        # imports resolve against it, not against a phantom leaf
        self.is_package = self.name.endswith(".__init__") or \
            self.name == "__init__"
        if self.name.endswith(".__init__"):
            self.name = self.name[:-len(".__init__")]
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        self.suppressions = parse_suppressions(self.lines)
        self._parents: Optional[dict] = None

    @property
    def parents(self) -> dict:
        """child AST node -> parent node (built on first use)."""
        if self._parents is None:
            p: dict = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    p[child] = node
            self._parents = p
        return self._parents


class Rule:
    """Base rule: subclasses set ``name``/``summary`` and override
    any of the three hooks."""

    name = ""
    summary = ""

    def collect(self, mi: ModuleInfo, ctx: dict) -> None:
        """First pass over every module: build cross-module facts
        into ``ctx`` before any ``check`` runs."""

    def check(self, mi: ModuleInfo,
              ctx: dict) -> Iterable[Finding]:
        return ()

    def finalize(self, ctx: dict) -> Iterable[Finding]:
        """After every module checked: whole-tree findings (the
        lock-order cycle scan lives here)."""
        return ()


class Report:
    """Stable-sorted analysis result."""

    def __init__(self, findings: List[Finding],
                 suppressed: List[Finding], rules: List[str],
                 files: int):
        self.findings = sorted(findings, key=lambda f: f.sort_key)
        self.suppressed = sorted(suppressed,
                                 key=lambda f: f.sort_key)
        self.rules = sorted(rules)
        self.files = files

    @property
    def ok(self) -> bool:
        return not self.findings

    def counts(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "files": self.files,
            "rules": self.rules,
            "counts": self.counts(),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
        }

    def to_json(self) -> str:
        # sort_keys + sorted findings: byte-stable across runs, so
        # a CI artifact diff shows exactly the new findings
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def text(self) -> str:
        lines = [str(f) for f in self.findings]
        n = len(self.findings)
        lines.append(
            f"{n} finding{'s' if n != 1 else ''} "
            f"({len(self.suppressed)} suppressed) across "
            f"{self.files} files")
        return "\n".join(lines)


class Engine:
    """Runs a rule set over a module set and applies suppressions."""

    def __init__(self, rules: List[Rule]):
        names = [r.name for r in rules]
        assert len(names) == len(set(names)), "duplicate rule names"
        self.rules = rules
        self.rule_names = set(names)

    # --- module loading ---

    @staticmethod
    def load_module(path: str, root: str) -> ModuleInfo:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        rel = os.path.relpath(path, root)
        return ModuleInfo(path, rel, source)

    @staticmethod
    def tree_paths(root: str) -> list:
        """Every ``*.py`` under ``root``, sorted, skipping caches and
        the kernels' build directory (``ops/cuda_build.py``'s
        ``_build``: libraries, and work files of the smoke run, never
        the package's source)."""
        out = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in ("__pycache__", "_build")
                and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
        return out

    # --- analysis ---

    def analyze(self, modules: List[ModuleInfo]) -> Report:
        ctx: dict = {"modules": modules}
        for rule in self.rules:
            for mi in modules:
                rule.collect(mi, ctx)
        raw: List[Finding] = []
        for rule in self.rules:
            for mi in modules:
                for f in rule.check(mi, ctx):
                    raw.append(f)
            for f in rule.finalize(ctx):
                raw.append(f)
        return self._apply_suppressions(modules, raw)

    def _apply_suppressions(self, modules: List[ModuleInfo],
                            raw: List[Finding]) -> Report:
        by_rel = {mi.rel: mi for mi in modules}
        findings: List[Finding] = []
        suppressed: List[Finding] = []
        for f in raw:
            sup = self._match_suppression(by_rel.get(f.path), f)
            if sup is not None:
                sup.used.add(f.rule)
                f.suppressed = True
                f.reason = sup.reason
                suppressed.append(f)
            else:
                findings.append(f)
        # the suppression grammar fails closed: reason-less or
        # unknown-rule comments and stale (unused) suppressions are
        # findings themselves
        for mi in modules:
            for sup in mi.suppressions.values():
                unknown = [r for r in sup.rules
                           if r not in self.rule_names]
                if not sup.valid:
                    findings.append(Finding(
                        BAD_SUPPRESSION, mi.rel, sup.line,
                        "suppression without a reason (grammar: "
                        "# lint: disable=<rule> -- <reason>)"))
                elif not sup.rules:
                    findings.append(Finding(
                        BAD_SUPPRESSION, mi.rel, sup.line,
                        "suppression with an empty rule list"))
                elif unknown:
                    findings.append(Finding(
                        BAD_SUPPRESSION, mi.rel, sup.line,
                        "suppression names unknown rule(s): "
                        + ", ".join(sorted(unknown))))
                else:
                    stale = [r for r in sup.rules
                             if r not in sup.used]
                    if stale:
                        findings.append(Finding(
                            UNUSED_SUPPRESSION, mi.rel, sup.line,
                            "suppression matched no finding for: "
                            + ", ".join(sorted(stale))))
        return Report(findings, suppressed,
                      list(self.rule_names), len(modules))

    # how far a suppression comment block may sit above its finding
    _BLOCK_MAX = 8

    @classmethod
    def _match_suppression(cls, mi: Optional[ModuleInfo],
                           f: Finding) -> Optional[Suppression]:
        """Same-line suppression, or one anywhere in the contiguous
        comment block ending directly above the finding (multi-line
        reasons wrap naturally in a 72-column tree). A trailing
        comment on a previous STATEMENT never leaks downward — only
        comment-only lines join the block."""
        if mi is None:
            return None
        sup = mi.suppressions.get(f.line)
        if sup is not None and sup.valid and f.rule in sup.rules:
            return sup
        line = f.line - 1
        steps = 0
        while line >= 1 and steps < cls._BLOCK_MAX:
            text = mi.lines[line - 1].lstrip()
            if not text.startswith("#"):
                break
            sup = mi.suppressions.get(line)
            if sup is not None and sup.valid \
                    and f.rule in sup.rules:
                return sup
            line -= 1
            steps += 1
        return None


# --- front doors ---


def default_engine() -> Engine:
    from .rules import default_rules
    return Engine(default_rules())


def package_root() -> str:
    """The repo root (parent of the ``trivy_tpu_torch`` package)."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def analyze_tree(root: str = "",
                 engine: Optional[Engine] = None) -> Report:
    """Analyze every ``*.py`` under ``root`` (default: the
    ``trivy_tpu_torch`` package) with the default rule set."""
    eng = engine or default_engine()
    base = package_root()
    root = root or os.path.join(base, "trivy_tpu_torch")
    modules = [eng.load_module(p, base)
               for p in eng.tree_paths(root)]
    return eng.analyze(modules)


def analyze_source(source: str, rel: str = "fixture.py",
                   engine: Optional[Engine] = None,
                   extra: Optional[dict] = None) -> Report:
    """Analyze in-memory source (rule unit fixtures). ``extra``
    maps additional ``rel`` paths to sources analyzed together —
    cross-module rules (hostpool reachability, lock graphs) see the
    whole set."""
    eng = engine or default_engine()
    modules = [ModuleInfo(rel, rel, source)]
    for other_rel, other_src in (extra or {}).items():
        modules.append(ModuleInfo(other_rel, other_rel, other_src))
    return eng.analyze(modules)
