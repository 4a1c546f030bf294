"""Generic semver-style grammar + constraints.

Mirrors the behavior of ``aquasecurity/go-version`` as used by the
reference's GenericComparer (pkg/detector/library/compare/compare.go:
58-79) and by most language drivers (driver.go:24-67): lenient semver
(any number of numeric segments, optional ``-prerelease`` and
``+build``), constraints as comma/space-ANDed comparators with
``=, ==, !=, >, <, >=, <=, ~>, ~, ^`` and ``*``/``x`` wildcards.
"""

from __future__ import annotations

import re
from typing import Optional

from .base import ALWAYS, Comparer, Interval, intersect_unions

_NUM_PAD = 8          # numeric segments padded for tuple comparison

_VERSION_RE = re.compile(
    r"^v?(?P<nums>[0-9xX*]+(?:\.[0-9xX*]+)*)"
    r"(?:-(?P<pre>[0-9A-Za-z.-]+))?"
    r"(?:\+(?P<build>[0-9A-Za-z.-]+))?$")

_COMPARATOR_RE = re.compile(
    r"(?P<op>~>|[=!<>~^]=?=?|)\s*(?P<ver>[0-9a-zA-Z.*+_-]+)")


def _encode_pre_id(s: str) -> tuple:
    if s.isdigit():
        return (0, int(s), "")
    return (1, 0, s)


class SemverKey(tuple):
    """(nums, is_release, pre_ids) — plain tuple ordering is the
    semver order once identifiers are type-tagged."""
    __slots__ = ()


def _make_key(nums: list, pre: Optional[str]) -> SemverKey:
    nums = tuple((nums + [0] * _NUM_PAD)[:_NUM_PAD])
    if pre is None or pre == "":
        return SemverKey((nums, 1, ()))
    ids = tuple(_encode_pre_id(x) for x in pre.split("."))
    return SemverKey((nums, 0, ids))


class SemverComparer(Comparer):
    name = "semver"

    def parse(self, s: str) -> SemverKey:
        s = s.strip()
        m = _VERSION_RE.match(s)
        if not m:
            raise ValueError(f"invalid semver: {s!r}")
        nums = []
        for part in m.group("nums").split("."):
            if part in ("x", "X", "*"):
                nums.append(0)      # wildcard parses as 0 in a version
            else:
                nums.append(int(part))
        return _make_key(nums, m.group("pre"))

    # --- constraints ---

    def constraint_intervals(self, constraint: str) -> list:
        text = constraint.replace(",", " ").strip()
        if text in ("", "*"):
            return [ALWAYS]
        union = [ALWAYS]
        pos = 0
        found = False
        for m in _COMPARATOR_RE.finditer(text):
            if m.start() < pos:
                continue
            pos = m.end()
            found = True
            union = intersect_unions(union, self._comparator(
                m.group("op"), m.group("ver")))
        if not found:
            raise ValueError(f"invalid constraint: {constraint!r}")
        return union

    def _comparator(self, op: str, ver: str) -> list:
        wild = _wildcard_prefix(ver)
        if wild is not None:
            return self._wildcard(op, wild)
        key = self.parse(ver)
        if op in ("", "=", "==", "==="):
            return [Interval(lo=key, hi=key)]
        if op in ("!=", "!=="):
            return [Interval(hi=key, hi_incl=False),
                    Interval(lo=key, lo_incl=False)]
        if op in (">", ">="):
            return [Interval(lo=key, lo_incl=(op == ">="))]
        if op in ("<", "<="):
            return [Interval(hi=key, hi_incl=(op == "<="))]
        if op in ("=>",):
            return [Interval(lo=key)]
        if op in ("=<",):
            return [Interval(hi=key)]
        if op == "~>":
            return [Interval(lo=key, hi=_bump_pessimistic(ver),
                             hi_incl=False)]
        if op == "~":
            return [Interval(lo=key, hi=_bump_tilde(ver),
                             hi_incl=False)]
        if op == "^":
            return [Interval(lo=key, hi=_bump_caret(ver),
                             hi_incl=False)]
        raise ValueError(f"unknown operator {op!r}")

    def _wildcard(self, op: str, prefix: list) -> list:
        """``1.2.*`` style: [1.2.0, 1.3.0) for =; bounds for others."""
        lo = _make_key(list(prefix), None)
        if not prefix:
            return [ALWAYS]
        hi_nums = prefix[:-1] + [prefix[-1] + 1]
        hi = _make_key(hi_nums, "0")     # -0 sorts before any release
        if op in ("", "=", "=="):
            return [Interval(lo=lo, hi=hi, hi_incl=False)]
        if op in (">=", "=>"):
            return [Interval(lo=lo)]
        if op == ">":
            return [Interval(lo=hi, lo_incl=True)]
        if op in ("<=", "=<"):
            return [Interval(hi=hi, hi_incl=False)]
        if op == "<":
            return [Interval(hi=lo, hi_incl=False)]
        if op in ("!=", "!=="):
            return [Interval(hi=lo, hi_incl=False),
                    Interval(lo=hi, lo_incl=True)]
        raise ValueError(f"wildcard with operator {op!r}")


def _wildcard_prefix(ver: str) -> Optional[list]:
    """[1, 2] for '1.2.*'; None if not a wildcard version."""
    parts = ver.lstrip("v").split(".")
    if not any(p in ("*", "x", "X") for p in parts):
        return None
    out = []
    for p in parts:
        if p in ("*", "x", "X"):
            break
        if not p.isdigit():
            return None
        out.append(int(p))
    return out


def _nums_of(ver: str) -> list:
    m = _VERSION_RE.match(ver.strip())
    if not m:
        raise ValueError(f"invalid semver: {ver!r}")
    return [0 if p in ("x", "X", "*") else int(p)
            for p in m.group("nums").split(".")]


def _upper(nums: list) -> SemverKey:
    # "-0" lower bound of the bumped release excludes its prereleases
    return _make_key(nums, "0")


def _bump_pessimistic(ver: str) -> SemverKey:
    """~> 1.2.3 → <1.3.0; ~> 1.2 → <2.0 (bump second-to-last)."""
    nums = _nums_of(ver)
    if len(nums) == 1:
        return _upper([nums[0] + 1])
    return _upper(nums[:-2] + [nums[-2] + 1])


def _bump_tilde(ver: str) -> SemverKey:
    """~1.2.3 → <1.3.0; ~1.2 → <1.3.0; ~1 → <2.0.0."""
    nums = _nums_of(ver)
    if len(nums) == 1:
        return _upper([nums[0] + 1])
    return _upper([nums[0], nums[1] + 1])


def _bump_caret(ver: str) -> SemverKey:
    """^1.2.3 → <2; ^0.2.3 → <0.3; ^0.0.3 → <0.0.4."""
    nums = _nums_of(ver)
    nums = nums + [0] * max(0, 3 - len(nums))
    for i, n in enumerate(nums):
        if n != 0:
            return _upper(nums[:i] + [n + 1])
    return _upper(nums[:-1] + [nums[-1] + 1])
