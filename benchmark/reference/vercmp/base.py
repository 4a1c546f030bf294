"""Shared comparer interface + the reference's IsVulnerable semantics.

Reference: pkg/detector/library/compare/compare.go:21-56 —
  - any empty string among vulnerable/patched versions ⇒ vulnerable;
  - with VulnerableVersions given: vulnerable iff the version matches
    their ``||``-join AND does NOT match the Patched+Unaffected join;
  - with VulnerableVersions empty: ``matched`` stays false — returned
    as-is when no secure versions exist, else ¬matched(secure);
  - parse/constraint errors ⇒ not vulnerable (warn).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Optional

log = logging.getLogger("trivy_tpu_torch.vercmp")


@dataclass(frozen=True)
class Interval:
    """Half-bounded interval over a grammar's total order. ``lo``/``hi``
    are parsed version keys or None (unbounded)."""

    lo: Optional[Any] = None
    lo_incl: bool = True
    hi: Optional[Any] = None
    hi_incl: bool = True

    def contains(self, key: Any) -> bool:
        if self.lo is not None:
            if key < self.lo or (key == self.lo and not self.lo_incl):
                return False
        if self.hi is not None:
            if key > self.hi or (key == self.hi and not self.hi_incl):
                return False
        return True


ALWAYS = Interval()                      # matches every version
NEVER: list = []                         # empty union matches nothing


def intersect_two(x: Interval, y: Interval) -> Optional[Interval]:
    lo, lo_incl = x.lo, x.lo_incl
    if y.lo is not None and (lo is None or y.lo > lo
                             or (y.lo == lo and not y.lo_incl)):
        lo, lo_incl = y.lo, y.lo_incl
    hi, hi_incl = x.hi, x.hi_incl
    if y.hi is not None and (hi is None or y.hi < hi
                             or (y.hi == hi and not y.hi_incl)):
        hi, hi_incl = y.hi, y.hi_incl
    if lo is not None and hi is not None:
        if lo > hi or (lo == hi and not (lo_incl and hi_incl)):
            return None
    return Interval(lo=lo, lo_incl=lo_incl, hi=hi, hi_incl=hi_incl)


def intersect_unions(a: list, b: list) -> list:
    """Intersection of two interval unions."""
    out = []
    for x in a:
        for y in b:
            iv = intersect_two(x, y)
            if iv is not None:
                out.append(iv)
    return out


class Comparer:
    """One version grammar. Subclasses implement ``parse`` and
    ``constraint_intervals``; everything else is shared."""

    name = "generic"

    def parse(self, s: str):
        """Version string → totally-ordered key. Raises ValueError."""
        raise NotImplementedError

    def constraint_intervals(self, constraint: str) -> list:
        """One ``||``-free constraint (comma/space = AND of comparators)
        → list of Intervals whose UNION is the matched set.
        Raises ValueError on syntax errors."""
        raise NotImplementedError

    # --- shared machinery ---

    def match(self, version: str, constraint: str) -> bool:
        """Reference matchVersion: does ``version`` satisfy the
        ``||``-joined constraint expression? An empty alternative is a
        constraint-parse error (go-version errors on it, which
        IsVulnerable turns into not-vulnerable)."""
        key = self.parse(version)
        result = False
        for part in constraint.split("||"):
            if not part.strip():
                raise ValueError(
                    f"empty constraint alternative in {constraint!r}")
            if any(iv.contains(key)
                   for iv in self.constraint_intervals(part)):
                result = True
        return result

    def compare(self, a: str, b: str) -> int:
        ka, kb = self.parse(a), self.parse(b)
        return (ka > kb) - (ka < kb)


def is_vulnerable(comparer: Comparer, pkg_ver: str,
                  vulnerable: list, patched: list,
                  unaffected: list) -> bool:
    """compare.go IsVulnerable, with grammar errors → False + warn."""
    for v in list(vulnerable) + list(patched):
        if v == "":
            return True

    matched = False
    if vulnerable:
        try:
            matched = comparer.match(pkg_ver, " || ".join(vulnerable))
        except ValueError as e:
            log.warning("version match error: %s", e)
            return False
        if not matched:
            return False

    secure = list(patched) + list(unaffected)
    if not secure:
        return matched
    try:
        return not comparer.match(pkg_ver, " || ".join(secure))
    except ValueError as e:
        log.warning("version match error: %s", e)
        return False
