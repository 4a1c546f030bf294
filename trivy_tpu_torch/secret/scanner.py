"""CPU-exact secret scanner.

Scan-loop semantics mirror the reference engine precisely
(pkg/fanal/secret/scanner.go:341-502):

  global allow-path → per rule: path match → rule allow-path → keyword
  prefilter → regex findall (whole match, or named submatch group when
  ``secret_group_name`` set) → allow-rules on match text → exclude blocks
  → censor match bytes into a shared censored copy → findings with line
  numbers and ±2-line code context, sorted by (RuleID, Match).

Censoring quirks preserved: all matched spans are censored into ONE copy
before findings render, so overlapping/multi-line secrets show as ``*``
runs in every finding's Match/Code; newlines inside a censored span are
replaced too (merging those lines in the rendered output).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..types import Code, Line, Secret, SecretFinding
from .builtin_rules import BUILTIN_ALLOW_RULES, BUILTIN_RULES
from .model import (
    ExcludeBlock,
    Location,
    Rule,
    SecretConfig,
    _allow_match,
    _allow_path,
)

HIGHLIGHT_RADIUS = 2  # lines of context above/below each secret


class _Blocks:
    """Lazily-located exclude blocks (reference: scanner.go:227-265)."""

    def __init__(self, content: bytes, regexes: list):
        self._content = content
        self._regexes = regexes
        self._locs: Optional[list[Location]] = None

    def match(self, loc: Location) -> bool:
        if self._locs is None:
            self._locs = [
                Location(m.start(), m.end())
                for rx in self._regexes
                for m in rx.finditer(self._content.decode("utf-8",
                                                          "surrogateescape"))
            ]
        return any(b.contains(loc) for b in self._locs)


@dataclass
class _Match:
    rule: Rule
    loc: Location


class Scanner:
    def __init__(self, rules: list, allow_rules: list,
                 exclude_block: Optional[ExcludeBlock] = None):
        self.rules = rules
        self.allow_rules = allow_rules
        self.exclude_block = exclude_block or ExcludeBlock()

    # --- global allow helpers ---

    def allow_path(self, path: str) -> bool:
        return _allow_path(self.allow_rules, path)

    def allow(self, match: str) -> bool:
        return _allow_match(self.allow_rules, match)

    # --- core scan ---

    def find_locations(self, rule: Rule, text: str,
                       spans=None) -> list[Location]:
        """All disallowed match locations for one rule.

        With a secret group: locations are the named submatch spans of
        matches whose WHOLE text passes allow-rules (scanner.go:122-141).

        ``spans``: optional sorted disjoint (start, end) byte regions —
        when the rule's anchor analysis proved extraction-exactness
        (rx.anchor RuleAnchor.exact), restricting finditer to them
        yields the identical match sequence at a fraction of the cost.
        ``finditer(text, a, b)`` (pos/endpos, no slicing) keeps ``\\b``
        look-back across the region edge correct.
        """
        if rule.regex is None:
            return []
        locs: list[Location] = []
        for m in (m for a, b in spans
                  for m in rule.regex.finditer(text, a, b)) \
                if spans is not None else rule.regex.finditer(text):
            whole = Location(m.start(), m.end())
            if self._allowed(rule, text, whole):
                continue
            if rule.secret_group_name:
                try:
                    s, e = m.span(rule.secret_group_name)
                except IndexError:
                    continue
                if s >= 0:
                    locs.append(Location(s, e))
            else:
                locs.append(whole)
        return locs

    def _allowed(self, rule: Rule, text: str, loc: Location) -> bool:
        matched = text[loc.start:loc.end]
        return self.allow(matched) or rule.allow(matched)

    def scan(self, file_path: str, content: bytes,
             regions=None) -> Secret:
        """``regions``: optional list aligned with ``self.rules`` —
        per rule either None (whole-file scan, reference behavior) or
        sorted merged (start, end) BYTE spans from the device sieve's
        anchor hits, valid only when the rule's window proof is
        extraction-exact. Byte spans equal char spans only for 1:1
        decodes, so any multibyte file falls back whole-file."""
        self.used_regions = False
        if self.allow_path(file_path):
            return Secret(file_path=file_path)

        # Match offsets must index the original bytes for censoring; decode
        # with surrogateescape so the text round-trips byte-identically.
        text = content.decode("utf-8", "surrogateescape")
        to_bytes = _offset_converter(text, content)
        if regions is not None and len(text) != len(content):
            regions = None
        self.used_regions = regions is not None
        lowered = content.lower()
        global_blocks = _Blocks(content, self.exclude_block.regexes)

        matched: list[_Match] = []
        censored: Optional[bytearray] = None
        for ri, rule in enumerate(self.rules):
            if not rule.match_path(file_path):
                continue
            if rule.allow_path(file_path):
                continue
            if not rule.match_keywords(lowered):
                continue
            locs = self.find_locations(
                rule, text,
                regions[ri] if regions is not None else None)
            if not locs:
                continue
            local_blocks = _Blocks(content, rule.exclude_block.regexes)
            for loc in locs:
                if global_blocks.match(loc) or local_blocks.match(loc):
                    continue
                bloc = Location(to_bytes(loc.start), to_bytes(loc.end))
                matched.append(_Match(rule, bloc))
                if censored is None:
                    censored = bytearray(content)
                censored[bloc.start:bloc.end] = \
                    b"*" * (bloc.end - bloc.start)

        if not matched:
            return Secret()

        rendered = bytes(censored) if censored is not None else content
        findings = [
            _to_finding(m.rule, m.loc, rendered) for m in matched
        ]
        findings.sort(key=lambda f: (f.rule_id, f.match))
        return Secret(file_path=file_path, findings=findings)


def _offset_converter(text: str, content: bytes):
    """char offset → byte offset. Identity for the (overwhelmingly
    common) case where every char encodes one byte."""
    if len(text) == len(content):
        return lambda i: i

    def conv(i: int) -> int:
        return len(text[:i].encode("utf-8", "surrogateescape"))
    return conv


def _to_finding(rule: Rule, loc: Location, content: bytes) -> SecretFinding:
    start_line, end_line, code, match_line = find_location(
        loc.start, loc.end, content)
    return SecretFinding(
        rule_id=rule.id,
        category=rule.category,
        severity=rule.severity or "UNKNOWN",
        title=rule.title,
        match=match_line,
        start_line=start_line,
        end_line=end_line,
        code=code,
    )


def find_location(start: int, end: int, content: bytes):
    """Line numbers + surrounding code snippet for a byte span
    (reference: scanner.go findLocation:445-502)."""
    start_line_num = content[:start].count(b"\n")

    line_start = content[:start].rfind(b"\n")
    line_start = 0 if line_start == -1 else line_start + 1
    line_end = content.find(b"\n", start)
    line_end = len(content) if line_end == -1 else line_end

    match = content[start:end]
    match_line = content[line_start:line_end]
    if len(match_line) > 100:
        t_start = max(start - 30, 0)
        t_end = min(end + 20, len(content))
        match_line = content[t_start:t_end]
    end_line_num = start_line_num + match.count(b"\n")

    lines = content.split(b"\n")
    code_start = max(start_line_num - HIGHLIGHT_RADIUS, 0)
    code_end = min(end_line_num + HIGHLIGHT_RADIUS, len(lines))

    code = Code()
    found_first = False
    for i, raw in enumerate(lines[code_start:code_end]):
        real_line = code_start + i
        in_cause = start_line_num <= real_line <= end_line_num
        raw_s = raw.decode("utf-8", "replace")
        code.lines.append(Line(
            number=code_start + i + 1,
            content=raw_s,
            is_cause=in_cause,
            highlighted=raw_s,
            first_cause=in_cause and not found_first,
            last_cause=False,
        ))
        found_first = found_first or in_cause
    for ln in reversed(code.lines):
        if ln.is_cause:
            ln.last_cause = True
            break

    return (start_line_num + 1, end_line_num + 1, code,
            match_line.decode("utf-8", "replace"))


def new_scanner(config: Optional[SecretConfig] = None) -> Scanner:
    """Build a scanner from builtins + optional trivy-secret.yaml config
    (reference: NewScanner, scanner.go:293-329)."""
    if config is None:
        return Scanner(list(BUILTIN_RULES), list(BUILTIN_ALLOW_RULES))

    enabled = list(BUILTIN_RULES)
    if config.enable_builtin_rule_ids:
        want = set(config.enable_builtin_rule_ids)
        enabled = [r for r in enabled if r.id in want]
    enabled = enabled + list(config.custom_rules)
    rules = [r for r in enabled if r.id not in set(config.disable_rule_ids)]

    allow = list(BUILTIN_ALLOW_RULES) + list(config.custom_allow_rules)
    disable_allow = set(config.disable_allow_rule_ids)
    allow = [a for a in allow if a.id not in disable_allow]

    return Scanner(rules, allow, config.exclude_block)
