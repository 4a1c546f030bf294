"""Maven version ordering + ranges (go-mvn-version semantics, used by
pkg/detector/library/compare/maven).

Ordering follows Maven's ComparableVersion: tokens split on ``.``,
``-`` and digit↔alpha transitions; known qualifiers rank
``alpha < beta < milestone < rc=cr < snapshot < '' (release) < sp``;
unknown qualifiers sort after ``sp`` lexically; trailing null tokens
(0 / '' / 'final' / 'ga' / 'release') are trimmed.

Constraints accept both comparator lists (``>=1.0, <2.0`` — what
trivy-db GHSA entries use) and Maven range syntax (``[1.0,2.0)``,
``(,1.5]``).
"""

from __future__ import annotations

import re

from .base import ALWAYS, Comparer, Interval, intersect_unions

_Q_ORDER = {"alpha": 1, "a": 1, "beta": 2, "b": 2, "milestone": 3,
            "m": 3, "rc": 4, "cr": 4, "snapshot": 5, "": 6, "final": 6,
            "ga": 6, "release": 6, "sp": 7}

_NULL_TOKENS = {(1, 0, ""), (0, 6, "")}


def _tokenize(s: str) -> list:
    s = s.lower()
    toks = []
    for part in re.split(r"[.-]", s):
        if part == "":
            toks.append("")
            continue
        # split digit↔alpha transitions
        for run in re.findall(r"\d+|[^\d]+", part):
            toks.append(run)
    return toks


def _tok_key(tok: str) -> tuple:
    """(kind, rank, text): numbers (kind 1) sort after qualifiers
    (kind 0); release '' is rank 6 among qualifiers; unknown
    qualifiers rank 8, lexical."""
    if tok.isdigit():
        return (1, int(tok), "")
    rank = _Q_ORDER.get(tok)
    if rank is None:
        return (0, 8, tok)
    return (0, rank, "")


class MavenComparer(Comparer):
    name = "maven"

    def parse(self, s: str):
        s = s.strip()
        if not s:
            raise ValueError("empty maven version")
        keys = [_tok_key(t) for t in _tokenize(s)]
        # trim trailing null tokens ("1.0.0" == "1", "1-ga" == "1")
        while keys and (keys[-1] == (1, 0, "")
                        or keys[-1] == (0, 6, "")):
            keys.pop()
        # pad with release-null so "1.1" > "1-sp" > "1" > "1-rc":
        # comparison against a shorter version sees (0, 6, "") — the
        # null/release element Maven uses for padding
        return _PaddedKey(tuple(keys))

    def constraint_intervals(self, constraint: str) -> list:
        text = constraint.strip()
        if not text:
            return [ALWAYS]
        if text[0] in "[(":
            return self._range(text)
        union = [ALWAYS]
        # ">= 2.0.0, <= 2.9.10.3": comma/space-separated comparator
        # AND-list; whitespace between operator and version is legal
        raw = [t for t in re.split(r"[,\s]+", text) if t]
        clauses: list = []
        i = 0
        while i < len(raw):
            tok = raw[i]
            if tok in ("==", "!=", "<=", ">=", "<", ">", "=") and \
                    i + 1 < len(raw):
                tok += raw[i + 1]
                i += 1
            clauses.append(tok)
            i += 1
        for clause in clauses:
            union = intersect_unions(union, self._comparator(clause))
        return union

    def _comparator(self, clause: str) -> list:
        m = re.match(r"^(==|!=|<=|>=|<|>|=|)\s*(.+)$", clause)
        op, ver = m.group(1), m.group(2)
        key = self.parse(ver)
        if op in ("", "=", "=="):
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
        raise ValueError(f"invalid maven comparator {clause!r}")

    def _range(self, text: str) -> list:
        """Maven range set: ``[1.0,2.0)``, ``(,1.5]``, ``[1.0]`` —
        comma-separated alternatives union."""
        out = []
        for m in re.finditer(
                r"([\[(])\s*([^,\[\]()]*)\s*(?:,\s*([^,\[\]()]*))?"
                r"\s*([\])])", text):
            lo_b, lo_s, hi_s, hi_b = m.groups()
            if hi_s is None:               # [1.0] exact
                key = self.parse(lo_s)
                out.append(Interval(lo=key, hi=key))
                continue
            lo = self.parse(lo_s) if lo_s.strip() else None
            hi = self.parse(hi_s) if hi_s.strip() else None
            out.append(Interval(
                lo=lo, lo_incl=(lo_b == "["),
                hi=hi, hi_incl=(hi_b == "]")))
        if not out:
            raise ValueError(f"invalid maven range {text!r}")
        return out


class _PaddedKey:
    """Maven token list with null-padding comparison: missing tokens
    compare as the release-null (0, 6, "")."""

    __slots__ = ("toks",)
    _NULL = (0, 6, "")

    def __init__(self, toks: tuple):
        self.toks = toks

    def _cmp(self, other: "_PaddedKey") -> int:
        a, b = self.toks, other.toks
        for i in range(max(len(a), len(b))):
            x = a[i] if i < len(a) else self._NULL
            y = b[i] if i < len(b) else self._NULL
            if x != y:
                return -1 if x < y else 1
        return 0

    def __eq__(self, o):
        return isinstance(o, _PaddedKey) and self._cmp(o) == 0

    def __lt__(self, o):
        return self._cmp(o) < 0

    def __le__(self, o):
        return self._cmp(o) <= 0

    def __gt__(self, o):
        return self._cmp(o) > 0

    def __ge__(self, o):
        return self._cmp(o) >= 0

    def __hash__(self):
        return hash(self.toks)

    def __repr__(self):
        return f"_PaddedKey({self.toks!r})"
