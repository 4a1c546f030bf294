"""A frozen copy of the port's secret rule model
(``trivy_tpu_torch/secret/model.py``, without the config file loader).

Secret rule model.

Behavioral contract mirrors the reference rule schema
(pkg/fanal/secret/scanner.go:83-94: Rule{ID, Category, Severity, Regex,
Keywords, Path, AllowRules, ExcludeBlock, SecretGroupName}) and the
`trivy-secret.yaml` config format (ParseConfig, scanner.go:267-291).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

@dataclass(frozen=True)
class Location:
    start: int
    end: int

    def contains(self, other: "Location") -> bool:
        return self.start <= other.start and other.end <= self.end


@dataclass
class AllowRule:
    id: str = ""
    description: str = ""
    regex: Optional[re.Pattern] = None
    path: Optional[re.Pattern] = None


@dataclass
class ExcludeBlock:
    description: str = ""
    regexes: list = field(default_factory=list)


@dataclass
class Rule:
    id: str
    category: str = ""
    title: str = ""
    severity: str = ""
    regex: Optional[re.Pattern] = None
    keywords: list = field(default_factory=list)
    path: Optional[re.Pattern] = None
    allow_rules: list = field(default_factory=list)
    exclude_block: ExcludeBlock = field(default_factory=ExcludeBlock)
    secret_group_name: str = ""

    # --- gating helpers (reference: scanner.go:160-184) ---

    def match_path(self, path: str) -> bool:
        return self.path is None or self.path.search(path) is not None

    def match_keywords(self, lowered: bytes) -> bool:
        """Substring prefilter over the lowercased content.
        Caller passes content.lower() once per file (reference lowercases
        per rule; hoisting it is behavior-identical)."""
        if not self.keywords:
            return True
        return any(kw.lower().encode() in lowered for kw in self.keywords)

    def allow_path(self, path: str) -> bool:
        return _allow_path(self.allow_rules, path)

    def allow(self, match: str) -> bool:
        return _allow_match(self.allow_rules, match)


def _allow_path(rules: list, path: str) -> bool:
    return any(r.path is not None and r.path.search(path) for r in rules)


def _allow_match(rules: list, match: str) -> bool:
    return any(r.regex is not None and r.regex.search(match) for r in rules)


def _icase_scope_end(tail: str) -> int:
    """Index in ``tail`` of the first ``)`` that closes an ENCLOSING
    group — the point where a spliced ``(?i:`` scope must end so group
    nesting survives. Skips escapes and char classes."""
    depth = 0
    i = 0
    n = len(tail)
    while i < n:
        c = tail[i]
        if c == "\\":
            i += 2
            continue
        if c == "[":
            i += 1
            if i < n and tail[i] == "^":
                i += 1
            if i < n and tail[i] == "]":  # literal ] first in class
                i += 1
            while i < n and tail[i] != "]":
                i += 2 if tail[i] == "\\" else 1
            i += 1
            continue
        if c == "(":
            depth += 1
        elif c == ")":
            if depth == 0:
                return i
            depth -= 1
        i += 1
    return n


def compile_rx(pattern: str) -> re.Pattern:
    """Compile a rule regex.

    Rules are authored in a Python/RE2-common subset. Mid-pattern global
    ``(?i)`` (legal in RE2, rejected by Python ≥3.11) is normalized to a
    scoped ``(?i:…)`` group closing at the end of the enclosing group,
    so nesting is preserved (RE2 would extend the flag to the very end
    of the pattern; the difference is immaterial for case-invariant
    trailing context, which is all the builtin rules use)."""
    try:
        return re.compile(pattern)
    except re.error:
        idx = pattern.find("(?i)")
        if idx > 0:
            head, tail = pattern[:idx], pattern[idx + 4:]
            end = _icase_scope_end(tail)
            return re.compile(
                f"{head}(?i:{tail[:end]}){tail[end:]}")
        raise
