"""The comparison that decides ``correct``.

After the window, a sample of the targets the program finished, drawn
from the seed with the largest of each kind in it, is held against the
plain reference (``benchmark/reference``): the packages, the
vulnerabilities and the secrets of each report must equal the
reference's exactly. Each number compared is a count of findings that
one side has and the other lacks, and its limit is 0.
"""

from __future__ import annotations

import json

import numpy as np


def report_sets(text: str) -> dict:
    """{"packages": {(kind, name, version, source package)}, "vulns":
    {(kind, package,
    installed version, vulnerability id, fixed version)}, "secrets":
    {(path, rule id, first line, last line, layer DiffID)}} of one
    report written by the program; a package's kind is ``os`` or its
    lockfile's type."""
    doc = json.loads(text)
    pkgs, vulns, secrets = set(), set(), set()
    for r in doc.get("Results") or []:
        cls = r.get("Class")
        if cls == "secret":
            for s in r.get("Secrets") or []:
                secrets.add((r["Target"].lstrip("/"), s["RuleID"],
                             s["StartLine"], s["EndLine"],
                             (s.get("Layer") or {}).get("DiffID", "")))
            continue
        kind = "os" if cls == "os-pkgs" else r.get("Type", "")
        for p in r.get("Packages") or []:
            evr = (f"{p['Epoch']}:" if p.get("Epoch") else "") + \
                p["Version"] + (f"-{p['Release']}" if p.get("Release")
                                else "")
            pkgs.add((kind, p["Name"], evr, p.get("SrcName", "")))
        for v in r.get("Vulnerabilities") or []:
            vulns.add((kind, v["PkgName"], v["InstalledVersion"],
                       v["VulnerabilityID"], v.get("FixedVersion", "")))
    return {"packages": pkgs, "vulns": vulns, "secrets": secrets}


def draw_sample(done: list, n: int, seed: int, kind_key: str) -> list:
    """``n`` of the finished ``(entry, text, at)`` triples, drawn from
    ``seed``: the largest of each kind first (the kind with index 0 is
    the largest by construction of the workloads), then the rest at
    random."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
    order = [int(i) for i in rng.permutation(len(done))]
    first, seen = [], set()
    for i in order:
        k = done[i][0][kind_key]
        if k not in seen:
            seen.add(k)
            first.append(i)
    rest = [i for i in order if i not in first]
    first.sort(key=lambda i: done[i][0][kind_key])
    return [done[i] for i in (first + rest)[:n]]


def mismatches(got: dict, want: dict) -> dict:
    """{class: findings in one and not the other} over the classes of
    ``want``."""
    return {k: len(got.get(k, set()) ^ want[k]) for k in want}


def judge(sample: list, expect) -> tuple:
    """({number name: (value, limit, "max" or "min")}, first
    differences): every class's mismatches over the sample, each at
    most 0, and the targets checked, at least 1. ``expect(entry)``
    gives the reference's sets of one target."""
    totals: dict = {}
    diffs = []
    for entry, text, _ in sample:
        got = report_sets(text)
        want = expect(entry)
        for k, n in mismatches(got, want).items():
            totals[k] = totals.get(k, 0) + n
            if n and len(diffs) < 6:
                extra = sorted(got.get(k, set()) - want[k])[:2]
                missing = sorted(want[k] - got.get(k, set()))[:2]
                diffs.append(f"{entry['path']}: {k}: program only "
                             f"{extra}, reference only {missing}")
    checks = {f"{k}_mismatched": (float(v), 0.0, "max")
              for k, v in sorted(totals.items())}
    checks["targets_checked"] = (float(len(sample)), 1.0, "min")
    return checks, diffs


def holds(checks: dict) -> bool:
    """Does every number keep its limit?"""
    return all(v <= lim if side == "max" else v >= lim
               for v, lim, side in checks.values())
