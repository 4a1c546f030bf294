"""RubyGems versions + requirements (go-gem-version semantics, used by
pkg/detector/library/compare/rubygems).

Gem::Version: dot-separated segments, letters mark prereleases; a
prerelease sorts before the release it prefixes. Gem::Requirement
operators: ``=, !=, >, <, >=, <=, ~>``.
"""

from __future__ import annotations

import re

from .base import ALWAYS, Comparer, Interval, intersect_unions

_SEG_RE = re.compile(r"[0-9]+|[a-z]+", re.IGNORECASE)
# Gem::Version::VERSION_PATTERN — the dash prerelease may itself be
# dotted ("3.4.4-beta.1")
_VALID_RE = re.compile(
    r"^\s*([0-9]+(\.[0-9a-zA-Z]+)*"
    r"(-[0-9A-Za-z-]+(\.[0-9A-Za-z-]+)*)?)?\s*$")


class _GemKey:
    """Segment list; comparison mirrors Gem::Version.<=>: trailing
    zero/null segments trimmed per type-run, missing numeric segments
    are 0, missing string segments make the shorter version GREATER
    (a string segment marks a prerelease)."""

    __slots__ = ("segs",)

    def __init__(self, segs: tuple):
        self.segs = segs

    def _cmp(self, other: "_GemKey") -> int:
        a, b = self.segs, other.segs
        for i in range(max(len(a), len(b))):
            x = a[i] if i < len(a) else 0
            y = b[i] if i < len(b) else 0
            if isinstance(x, str) and not isinstance(y, str):
                return -1
            if isinstance(y, str) and not isinstance(x, str):
                return 1
            if x != y:
                return -1 if x < y else 1
        return 0

    def __eq__(self, o):
        return isinstance(o, _GemKey) and self._cmp(o) == 0

    def __lt__(self, o):
        return self._cmp(o) < 0

    def __le__(self, o):
        return self._cmp(o) <= 0

    def __gt__(self, o):
        return self._cmp(o) > 0

    def __ge__(self, o):
        return self._cmp(o) >= 0

    def __hash__(self):
        return hash(self.segs)

    def __repr__(self):
        return f"_GemKey({self.segs!r})"


class GemComparer(Comparer):
    name = "rubygems"

    def parse(self, s: str):
        s = s.strip()
        if not _VALID_RE.match(s) or s == "":
            if s == "":
                s = "0"
            elif not _VALID_RE.match(s):
                raise ValueError(f"invalid gem version: {s!r}")
        s = s.replace("-", ".pre.")
        segs = []
        for tok in _SEG_RE.findall(s):
            segs.append(int(tok) if tok.isdigit() else tok.lower())
        while segs and segs[-1] == 0:
            segs.pop()
        return _GemKey(tuple(segs))

    def constraint_intervals(self, constraint: str) -> list:
        text = constraint.strip()
        if not text:
            return [ALWAYS]
        union = [ALWAYS]
        for clause in text.split(","):
            clause = clause.strip()
            if not clause:
                continue
            union = intersect_unions(union, self._comparator(clause))
        return union

    def _comparator(self, clause: str) -> list:
        m = re.match(r"^(~>|!=|<=|>=|<|>|=|)\s*(.+)$", clause)
        op, ver = m.group(1), m.group(2).strip()
        key = self.parse(ver)
        if op in ("", "="):
            return [Interval(lo=key, hi=key)]
        if op == "!=":
            return [Interval(hi=key, hi_incl=False),
                    Interval(lo=key, lo_incl=False)]
        if op == ">":
            return [Interval(lo=key, lo_incl=False)]
        if op == ">=":
            return [Interval(lo=key)]
        if op == "<":
            return [Interval(hi=key, hi_incl=False)]
        if op == "<=":
            return [Interval(hi=key)]
        if op == "~>":
            # ~> 1.4.2 ⇒ >=1.4.2, <1.5 (prereleases of 1.5 compare
            # below the bare release and stay included, as in Gem)
            nums = [s for s in key.segs if isinstance(s, int)]
            if len(nums) <= 1:
                hi = _GemKey(((nums[0] + 1) if nums else 1,))
            else:
                hi = _GemKey(tuple(nums[:-2] + [nums[-2] + 1]))
            return [Interval(lo=key, hi=hi, hi_incl=False)]
        raise ValueError(f"invalid gem requirement {clause!r}")
