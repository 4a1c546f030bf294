"""Debian package version ordering (knqyf263/go-deb-version semantics,
used by pkg/detector/ospkg/{debian,ubuntu}).

Grammar: ``[epoch:]upstream[-revision]``. Comparison per Debian
policy §5.6.12: alternating non-digit/digit parts; non-digit parts
compare with letters before non-letters and ``~`` before everything
(including end-of-string).
"""

from __future__ import annotations

from .base import Comparer, Interval


def _char_order(c: str) -> int:
    if c == "~":
        return -1
    if c.isalpha():
        return ord(c)
    return ord(c) + 256        # non-alphanumeric after letters


def _lex_key(s: str) -> tuple:
    """Debian non-digit part → comparable tuple. '~' < '' (end)."""
    # end-of-string sentinel 0 sorts after '~' (-1) but before chars
    return tuple(_char_order(c) for c in s) + (0,)


def _part_key(s: str) -> tuple:
    """Full upstream/revision string → alternating (lex, num) tuple."""
    out = []
    i, n = 0, len(s)
    while i < n:
        j = i
        while j < n and not s[j].isdigit():
            j += 1
        out.append(_lex_key(s[i:j]))
        i = j
        while j < n and s[j].isdigit():
            j += 1
        out.append(int(s[i:j] or 0))
        i = j
    out.append(_lex_key(""))      # trailing empty non-digit part
    return tuple(out)


class DebComparer(Comparer):
    name = "deb"

    def parse(self, s: str):
        s = s.strip()
        if not s:
            raise ValueError("empty deb version")
        epoch = 0
        if ":" in s:
            e, _, rest = s.partition(":")
            if not e.isdigit():
                raise ValueError(f"invalid deb epoch in {s!r}")
            epoch, s = int(e), rest
        upstream, _, revision = s.rpartition("-")
        if not upstream:
            upstream, revision = revision, ""
        # Debian policy: a missing revision compares as "0"
        # ("1.0" == "1.0-0", go-deb-version behavior)
        return (epoch, _part_key(upstream),
                _part_key(revision or "0"))

    def constraint_intervals(self, constraint: str) -> list:
        c = constraint.strip()
        if c.startswith("<"):
            return [Interval(hi=self.parse(c[1:].strip()),
                             hi_incl=False)]
        return [Interval(lo=self.parse(c), hi=self.parse(c))]
