"""PEP 440 versions + specifiers (go-pep440-version semantics, used by
pkg/detector/library/compare/pep440).

Key order: epoch → release → (dev < pre < release < post) with the
full dev/pre/post interleaving PEP 440 defines. Local versions break
ties (compared segment-wise, numeric before alpha).
Specifiers: ``==, !=, <=, >=, <, >, ~=, ===`` and ``==X.*`` wildcards,
comma-ANDed.
"""

from __future__ import annotations

import re
from typing import Optional

from .base import ALWAYS, Comparer, Interval, intersect_unions

_VERSION_RE = re.compile(
    r"^v?(?:(?P<epoch>\d+)!)?"
    r"(?P<release>\d+(?:\.\d+)*)"
    r"(?:[._-]?(?P<pre_l>a|alpha|b|beta|rc|c|pre|preview)[._-]?"
    r"(?P<pre_n>\d*))?"
    r"(?:[._-]?(?:(?P<post_l>post|rev|r)[._-]?(?P<post_n>\d*)"
    r"|-(?P<post_implicit>\d+)))?"
    r"(?:[._-]?dev[._-]?(?P<dev_n>\d*))?"
    r"(?:\+(?P<local>[a-z0-9]+(?:[._-][a-z0-9]+)*))?$",
    re.IGNORECASE)

_PRE_MAP = {"a": 0, "alpha": 0, "b": 1, "beta": 1,
            "rc": 2, "c": 2, "pre": 2, "preview": 2}

_REL_PAD = 8
_INF = (9, 0)        # above every pre stage (a=0, b=1, rc=2)
_NEG_INF = (-1, 0)


class Pep440Comparer(Comparer):
    name = "pep440"

    def parse(self, s: str):
        m = _VERSION_RE.match(s.strip().lower())
        if not m:
            raise ValueError(f"invalid pep440 version: {s!r}")
        epoch = int(m.group("epoch") or 0)
        release = tuple(int(x) for x in m.group("release").split("."))
        release = (release + (0,) * _REL_PAD)[:_REL_PAD]

        # ordering tag: dev-of-pre < pre < pre-post … modelled as a
        # chain of (stage, num) pairs per PEP 440 §Summary of permitted
        # suffixes and relative ordering
        pre = None
        if m.group("pre_l"):
            pre = (_PRE_MAP[m.group("pre_l")],
                   int(m.group("pre_n") or 0))
        post = None
        if m.group("post_l") or m.group("post_implicit"):
            post = int(m.group("post_n") or m.group("post_implicit")
                       or 0)
        dev = None
        if m.group("dev_n") is not None:
            dev = int(m.group("dev_n") or 0)

        # (pre_key, post_key, dev_key) with sentinels replicating PEP
        # 440: X.dev < X.aN.dev < X.aN < X.aN.postM < X < X.postM
        pre_key = pre if pre is not None else _INF
        if pre is None and post is None and dev is not None:
            pre_key = _NEG_INF            # bare .devN sorts first
        post_key = (1, post) if post is not None else (0, 0)
        dev_key = (0, dev) if dev is not None else (1, 0)

        local = ()
        if m.group("local"):
            parts = re.split(r"[._-]", m.group("local"))
            local = tuple((1, int(p), "") if p.isdigit() else (0, 0, p)
                          for p in parts)
        return (epoch, release, pre_key, post_key, dev_key, local)

    # --- specifiers ---

    def constraint_intervals(self, constraint: str) -> list:
        text = constraint.strip()
        if not text:
            return [ALWAYS]
        union = [ALWAYS]
        for clause in text.split(","):
            clause = clause.strip()
            if not clause:
                continue
            union = intersect_unions(union, self._clause(clause))
        return union

    def _clause(self, clause: str) -> list:
        m = re.match(r"^(===|==|!=|<=|>=|<|>|~=|=)\s*(.+)$", clause)
        if not m:
            # bare version means exact match
            op, ver = "==", clause
        else:
            op, ver = m.group(1), m.group(2).strip()

        if ver.endswith(".*"):
            return self._wildcard(op, ver[:-2])
        key = self.parse(ver)
        if op in ("==", "=", "==="):
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
        if op == "~=":
            nums = [int(x) for x in
                    _VERSION_RE.match(ver.lower()).group("release")
                    .split(".")]
            if len(nums) < 2:
                raise ValueError(f"~= needs two segments: {ver!r}")
            hi = self._release_upper(nums[:-1])
            return [Interval(lo=key, hi=hi, hi_incl=False)]
        raise ValueError(f"invalid specifier {clause!r}")

    def _wildcard(self, op: str, prefix: str) -> list:
        nums = [int(x) for x in prefix.lstrip("v").split(".")]
        lo = self.parse(".".join(map(str, nums)) + ".dev0")
        hi = self._release_upper(nums)
        if op in ("==", "=", "==="):
            return [Interval(lo=lo, hi=hi, hi_incl=False)]
        if op == "!=":
            return [Interval(hi=lo, hi_incl=False),
                    Interval(lo=hi, lo_incl=True)]
        raise ValueError(f"wildcard with operator {op!r}")

    def _release_upper(self, nums: list):
        bumped = nums[:-1] + [nums[-1] + 1]
        return self.parse(".".join(map(str, bumped)) + ".dev0")
