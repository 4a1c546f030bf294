"""Alpine apk version ordering (knqyf263/go-apk-version semantics,
used by pkg/detector/ospkg/alpine — compare vs FixedVersion,
alpine.go:120-140).

Grammar: ``digits{.digits}[letter]{_suffix[num]}[-r#]`` where suffix ∈
{alpha, beta, pre, rc} sort before release and {cvs, svn, git, hg, p}
after; ``-r<n>`` is the package revision.
"""

from __future__ import annotations

import re

from .base import Comparer, Interval

_PRE = {"alpha": -4, "beta": -3, "pre": -2, "rc": -1}
_POST = {"cvs": 1, "svn": 2, "git": 3, "hg": 4, "p": 5}
_SUFFIX_RE = re.compile(
    r"_(alpha|beta|pre|rc|cvs|svn|git|hg|p)(\d*)")
_VERSION_RE = re.compile(
    r"^(?P<nums>\d+(?:\.\d+)*)"
    r"(?P<letter>[a-z])?"
    r"(?P<suffixes>(?:_(?:alpha|beta|pre|rc|cvs|svn|git|hg|p)\d*)*)"
    r"(?:-r(?P<rev>\d+))?$")


class ApkComparer(Comparer):
    name = "apk"

    def parse(self, s: str):
        m = _VERSION_RE.match(s.strip())
        if not m:
            raise ValueError(f"invalid apk version: {s!r}")
        # numeric parts: first compares numerically; later parts with
        # leading zeros compare as strings per apk rules — model the
        # common case (numeric) exactly; leading-zero fractional parts
        # are encoded as (0, digits-as-fraction-string)
        nums = []
        for i, p in enumerate(m.group("nums").split(".")):
            if i > 0 and p.startswith("0"):
                nums.append((0, -1, p.rstrip("0") or "0"))
            else:
                nums.append((1, int(p), ""))
        letter = m.group("letter") or ""
        sufs = []
        for name, num in _SUFFIX_RE.findall(m.group("suffixes") or ""):
            order = _PRE.get(name) or _POST[name]
            sufs.append((order, int(num or 0)))
        # no suffix sorts between pre (negative) and post (positive)
        sufs = tuple(sufs) or ((0, 0),)
        rev = int(m.group("rev") or 0)
        return (tuple(nums), letter, sufs, rev)

    def constraint_intervals(self, constraint: str) -> list:
        # OS detectors compare against a single fixed version: the
        # vulnerable set is [None, fixed)
        c = constraint.strip()
        if c.startswith("<"):
            return [Interval(hi=self.parse(c[1:].strip()),
                             hi_incl=False)]
        return [Interval(lo=self.parse(c), hi=self.parse(c))]
