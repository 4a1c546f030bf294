"""node-semver versions + ranges (go-npm-version semantics, used by
pkg/detector/library/compare/npm).

Versions are strict 3-part semver with optional prerelease/build.
Ranges: space-ANDed comparators within a clause, ``||`` unions handled
by the base class; supports ``^ ~ = < <= > >=``, x-ranges (``1.2.x``,
``1.2``, ``*``) and hyphen ranges (``1.2.3 - 2.0.0``).
"""

from __future__ import annotations

import re
from typing import Optional

from .base import ALWAYS, Comparer, Interval, intersect_unions

_VERSION_RE = re.compile(
    r"^v?(?P<maj>\d+)(?:\.(?P<min>\d+))?(?:\.(?P<pat>\d+))?"
    r"(?:-(?P<pre>[0-9A-Za-z.-]+))?"
    r"(?:\+(?P<build>[0-9A-Za-z.-]+))?$")

_XCHARS = ("x", "X", "*")


def _encode_pre_id(s: str) -> tuple:
    if s.isdigit():
        return (0, int(s), "")
    return (1, 0, s)


def _make_key(maj: int, minor: int, pat: int,
              pre: Optional[str]) -> tuple:
    if pre is None or pre == "":
        return ((maj, minor, pat), 1, ())
    ids = tuple(_encode_pre_id(x) for x in pre.split("."))
    return ((maj, minor, pat), 0, ids)


class NpmComparer(Comparer):
    name = "npm"

    def parse(self, s: str):
        m = _VERSION_RE.match(s.strip())
        if not m:
            raise ValueError(f"invalid npm version: {s!r}")
        return _make_key(int(m.group("maj")),
                         int(m.group("min") or 0),
                         int(m.group("pat") or 0),
                         m.group("pre"))

    def is_prerelease(self, s: str) -> bool:
        try:
            return self.parse(s)[1] == 0
        except ValueError:
            return False

    # --- ranges ---

    @staticmethod
    def _tokens(text: str) -> list:
        """node-semver tolerates whitespace between an operator and
        its version ("< 3.4.0"); rejoin such split tokens. Commas are
        AND separators in the advisory feeds' range syntax
        (">=1.0.0, <1.4.2" — go-npm-version's constraint regex skips
        them the same way)."""
        raw = text.replace(",", " ").split()
        out: list = []
        i = 0
        while i < len(raw):
            tok = raw[i]
            if tok in ("^", "~", "=", "<", "<=", ">", ">=") and \
                    i + 1 < len(raw) and raw[i + 1] != "-":
                tok += raw[i + 1]
                i += 1
            out.append(tok)
            i += 1
        return out

    def constraint_intervals(self, constraint: str) -> list:
        text = constraint.strip()
        if text in ("", "*", "x", "X"):
            return [ALWAYS]
        # comma-AND clauses (advisory-feed syntax) intersect, each
        # parsed on its own so hyphen ranges survive inside them
        # (same per-clause split as the pep440/rubygems grammars)
        clauses = [c.strip() for c in text.split(",") if c.strip()]
        if len(clauses) > 1:
            union = [ALWAYS]
            for clause in clauses:
                union = intersect_unions(
                    union, self.constraint_intervals(clause))
            return union
        if clauses:
            text = clauses[0]    # drop stray commas ("1.0 - 2.0,")
        # hyphen range: "1.2.3 - 2.0.0"
        hm = re.match(r"^(\S+)\s+-\s+(\S+)$", text)
        if hm:
            lo = self._xparse(hm.group(1))
            hi = self._xparse(hm.group(2))
            # _xparse yields bounds only for x-ranges ("1.2.x"); a
            # full version is its own inclusive lower bound
            if lo[0] is not None:
                lo_iv = Interval(lo=lo[0])
            else:
                lo_iv = Interval(lo=self.parse(hm.group(1)))
            if hi[1] is not None:          # partial: <= upper fill
                hi_iv = Interval(hi=hi[1], hi_incl=False)
            else:
                hi_iv = Interval(hi=self.parse(hm.group(2)))
            return intersect_unions([lo_iv], [hi_iv])

        union = [ALWAYS]
        for tok in self._tokens(text):
            union = intersect_unions(union, self._comparator(tok))
        return union

    # --- node-semver prerelease exclusion ---

    def match(self, version: str, constraint: str) -> bool:
        """node-semver: a prerelease version only satisfies a range
        alternative if some comparator in it carries a prerelease on
        the same major.minor.patch (go-npm-version follows this; the
        reference's npm compare inherits it)."""
        key = self.parse(version)
        is_pre = key[1] == 0
        result = False
        for part in constraint.split("||"):
            if not part.strip():
                raise ValueError(
                    f"empty constraint alternative in {constraint!r}")
            if not any(iv.contains(key)
                       for iv in self.constraint_intervals(part)):
                continue
            if is_pre and not self._pre_allowed(key[0], part):
                continue
            result = True
        return result

    def _pre_allowed(self, tuple3, part: str) -> bool:
        for tok in re.split(r"[\s,]+", part.strip()):
            ver = tok.lstrip("^~=<>")
            m = _VERSION_RE.match(ver)
            if m and m.group("pre") is not None:
                t = (int(m.group("maj")), int(m.group("min") or 0),
                     int(m.group("pat") or 0))
                if t == tuple3:
                    return True
        return False

    def _comparator(self, tok: str) -> list:
        m = re.match(r"^(\^|~|<=|>=|<|>|=|)\s*(.*)$", tok)
        op, ver = m.group(1), m.group(2)
        if ver == "" or ver in _XCHARS:
            return [ALWAYS]
        lo, hi = self._xparse(ver)        # x-range bounds
        if lo is None:                    # plain full version
            key = self.parse(ver)
            if op in ("", "="):
                return [Interval(lo=key, hi=key)]
            if op == ">":
                return [Interval(lo=key, lo_incl=False)]
            if op == ">=":
                return [Interval(lo=key)]
            if op == "<":
                return [Interval(hi=key, hi_incl=False)]
            if op == "<=":
                return [Interval(hi=key)]
            if op == "~":
                return [Interval(lo=key, hi=self._tilde_upper(ver),
                                 hi_incl=False)]
            if op == "^":
                return [Interval(lo=key, hi=self._caret_upper(ver),
                                 hi_incl=False)]
            raise ValueError(f"bad comparator {tok!r}")
        # x-range version (1.2.x / 1.2): behaves like the equivalent
        # range per node-semver
        if op in ("", "=", "~"):
            return [Interval(lo=lo, hi=hi, hi_incl=False)]
        if op == "^":
            nums = self._nums(ver)
            key = _make_key(*(nums + [0] * (3 - len(nums)))[:3], None)
            return [Interval(lo=key, hi=self._caret_upper_nums(nums),
                             hi_incl=False)]
        if op == ">=":
            return [Interval(lo=lo)]
        if op == ">":
            return [Interval(lo=hi)]
        if op == "<":
            return [Interval(hi=lo, hi_incl=False)]
        if op == "<=":
            return [Interval(hi=hi, hi_incl=False)]
        raise ValueError(f"bad comparator {tok!r}")

    def _nums(self, ver: str) -> list:
        out = []
        for p in ver.lstrip("v").split("."):
            if p in _XCHARS:
                break
            if not re.match(r"^\d+$", p):
                raise ValueError(f"invalid npm range version {ver!r}")
            out.append(int(p))
        return out

    def _xparse(self, ver: str):
        """'1.2' / '1.2.x' → (lo_key, hi_key); full version → (None,
        None)."""
        base = ver.split("-")[0].split("+")[0]
        parts = base.lstrip("v").split(".")
        if len(parts) >= 3 and not any(p in _XCHARS for p in parts):
            return (None, None)
        nums = self._nums(ver)
        lo = _make_key(*(nums + [0, 0, 0])[:3], None)
        if not nums:
            return (lo, None)
        bumped = nums[:-1] + [nums[-1] + 1]
        hi = _make_key(*(bumped + [0, 0, 0])[:3], "0")
        return (lo, hi)

    def _tilde_upper(self, ver: str):
        nums = self._nums(ver.split("-")[0])
        if len(nums) == 1:
            return _make_key(nums[0] + 1, 0, 0, "0")
        return _make_key(nums[0], nums[1] + 1, 0, "0")

    def _caret_upper(self, ver: str):
        return self._caret_upper_nums(self._nums(ver.split("-")[0]))

    def _caret_upper_nums(self, nums: list):
        nums = (nums + [0, 0, 0])[:3]
        if nums[0] != 0:
            return _make_key(nums[0] + 1, 0, 0, "0")
        if nums[1] != 0:
            return _make_key(0, nums[1] + 1, 0, "0")
        return _make_key(0, 0, nums[2] + 1, "0")
