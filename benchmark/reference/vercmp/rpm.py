"""RPM version ordering (knqyf263/go-rpm-version semantics, used by
pkg/detector/ospkg/{redhat,amazon,oracle,suse,photon,mariner,...}).

Grammar: ``[epoch:]version[-release]`` with rpmvercmp segment rules:
alphanumeric runs compare numerically/lexically, digits beat alphas,
``~`` sorts before everything, ``^`` sorts after the base but before
a longer continuation.
"""

from __future__ import annotations

import re

from .base import Comparer, Interval

_TOKEN_RE = re.compile(r"(\d+|[a-zA-Z]+|~|\^)")


def _rpmvercmp_key(s: str) -> tuple:
    """Encode a version string so tuple comparison == rpmvercmp.

    Tokens: (kind, value) with kind ordering
      tilde(-2) < end(-1)/shorter < caret(0 after end? see below)
      alpha(1) < digit(2).
    rpmvercmp details honored: '~' sorts before end-of-string; '^'
    sorts after end-of-string but before any other token; separators
    only delimit tokens.
    """
    out = []
    for tok in _TOKEN_RE.findall(s):
        if tok == "~":
            out.append((-2, 0, ""))
        elif tok == "^":
            out.append((0, 0, ""))
        elif tok.isdigit():
            out.append((2, int(tok), ""))
        else:
            out.append((1, 0, tok))
    # end sentinel: after '~' (-2), before '^' (0), alpha, digit
    out.append((-1, 0, ""))
    return tuple(out)


class RpmComparer(Comparer):
    name = "rpm"

    def parse(self, s: str):
        s = s.strip()
        if not s:
            raise ValueError("empty rpm version")
        epoch = 0
        if ":" in s:
            e, _, rest = s.partition(":")
            epoch = int(e) if e.isdigit() else 0
            s = rest
        version, _, release = s.partition("-")
        return (epoch, _rpmvercmp_key(version), _rpmvercmp_key(release))

    def constraint_intervals(self, constraint: str) -> list:
        c = constraint.strip()
        if c.startswith("<"):
            return [Interval(hi=self.parse(c[1:].strip()),
                             hi_incl=False)]
        return [Interval(lo=self.parse(c), hi=self.parse(c))]
