"""Result filtering (reference: pkg/result/filter.go:31-).

Severity filter, --ignore-unfixed, .trivyignore id list, and the
uniqueness pass (filter.go shouldOverwrite: for duplicate
(ID, pkg, path, version) keep the entry that has a fixed version).
OPA Rego ignore policies are handled by the policy hook when provided.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ..types import SEVERITIES, Severity


class IgnorePolicyError(Exception):
    """A user ignore-policy failed to load or raised while
    evaluating a finding."""


def load_ignore_policy(path: str):
    """--ignore-policy: a Python file defining ``ignore(finding) ->
    bool`` over the finding's JSON dict (the analog of the
    reference's Rego ``data.trivy.ignore`` query, filter.go:162-219;
    Python predicate instead of OPA — same contract, same hook).

    TRUST DIFFERENCE vs the reference: Rego is evaluated in a
    sandbox; this policy file is ``exec``ed with full interpreter
    rights (as is a module loaded by module/__init__.py). Treat
    policy files like code you run, not like configuration."""
    if not path:
        return None
    import types as _types
    with open(path, encoding="utf-8") as f:
        source = f.read()
    mod = _types.ModuleType("trivy_ignore_policy")
    try:
        exec(compile(source, path, "exec"), mod.__dict__)
    except Exception as e:               # noqa: BLE001
        raise IgnorePolicyError(f"{path}: {e!r}")
    fn = getattr(mod, "ignore", None)
    if not callable(fn):
        raise IgnorePolicyError(
            f"ignore policy {path} must define ignore(finding)")

    def predicate(finding):
        try:
            return bool(fn(finding.to_dict()))
        except Exception as e:           # noqa: BLE001
            raise IgnorePolicyError(f"ignore() raised: {e!r}")
    return predicate


def load_ignore_file(path: str = ".trivyignore") -> list:
    if not path or not os.path.exists(path):
        return []
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line.split()[0])
    return out


def filter_results(results: list, severities: list,
                   ignore_unfixed: bool = False,
                   ignored_ids: Optional[list] = None,
                   policy: Optional[Callable] = None,
                   include_non_failures: bool = False) -> list:
    sev_names = {str(s) if isinstance(s, Severity) else s
                 for s in severities}
    ignored = set(ignored_ids or [])
    sev_rank = {str(s): i for i, s in enumerate(SEVERITIES)}

    for r in results:
        r.vulnerabilities = _filter_vulns(
            r.vulnerabilities, sev_names, ignore_unfixed, ignored,
            policy)
        # BySeverity ordering (ref types/vulnerability.go:44-57,
        # applied after filtering at filter.go:47): package, then
        # installed version, then severity DESCENDING, then id
        r.vulnerabilities.sort(
            key=lambda v: (v.pkg_name, v.installed_version,
                           -sev_rank.get(v.severity, 0),
                           v.vulnerability_id))
        r.misconf_summary, r.misconfigurations = _filter_misconfs(
            r.misconfigurations, sev_names, ignored,
            include_non_failures, policy)
        r.secrets = [s for s in r.secrets
                     if s.severity in sev_names
                     and s.rule_id not in ignored
                     and not (policy is not None and policy(s))]
        r.licenses = [lic for lic in r.licenses
                      if lic.severity in sev_names
                      and lic.name not in ignored
                      and not (policy is not None and policy(lic))]
    return results


def _filter_misconfs(misconfs: list, sev_names: set, ignored: set,
                     include_non_failures: bool,
                     policy=None) -> tuple:
    """filterMisconfigurations (filter.go:124-154): severity/id
    filter, PASS/EXCEPTION dropped unless requested, and a
    pass/fail/exception summary."""
    from ..types.report import MisconfSummary
    summary = MisconfSummary()
    filtered = []
    for m in misconfs:
        if getattr(m, "severity", "") not in sev_names:
            continue
        if getattr(m, "id", "") in ignored or \
                getattr(m, "avd_id", "") in ignored:
            continue
        if policy is not None and policy(m):
            continue
        status = getattr(m, "status", "")
        if status == "FAIL":
            summary.failures += 1
        elif status == "PASS":
            summary.successes += 1
        elif status == "EXCEPTION":
            summary.exceptions += 1
        if status != "FAIL" and not include_non_failures:
            continue
        filtered.append(m)
    if not (summary.failures or summary.successes or
            summary.exceptions):
        return None, []
    return summary, filtered


def _filter_vulns(vulns: list, sev_names: set, ignore_unfixed: bool,
                  ignored: set, policy) -> list:
    unique: dict = {}
    for v in vulns:
        if v.severity not in sev_names:
            continue
        if ignore_unfixed and not v.fixed_version:
            continue
        if v.vulnerability_id in ignored:
            continue
        if policy is not None and policy(v):
            continue
        key = (v.vulnerability_id, v.pkg_name, v.pkg_path,
               v.installed_version)
        old = unique.get(key)
        unique[key] = v if old is None else _merge_duplicate(old, v)
    return list(unique.values())


_REDHAT_SOURCES = {"redhat", "redhat-oval"}


def _is_redhat(v) -> bool:
    if getattr(v, "severity_source", "") == "redhat":
        return True
    ds = getattr(v, "data_source", None)
    return ds is not None and \
        getattr(ds, "id", "") in _REDHAT_SOURCES


def _merge_duplicate(old, new):
    """Duplicate (ID, pkg, path, version) handling. Red Hat pairs
    get the reference detector's same-CVE merge (redhat.go uniqVulns:
    several RHSAs can fix one CVE — report the NEWEST FixedVersion
    per the rpm comparer and the UNION of vendor ids, so neither
    advisory's RHSA link is dropped); everything else keeps
    shouldOverwrite semantics — prefer the entry carrying a fix."""
    if _is_redhat(old) and _is_redhat(new):
        winner, loser = old, new
        if old.fixed_version != new.fixed_version:
            if not old.fixed_version:
                winner, loser = new, old
            elif new.fixed_version:
                try:
                    from ..vercmp import get_comparer
                    rpm = get_comparer("rpm")
                    if rpm.parse(new.fixed_version) > \
                            rpm.parse(old.fixed_version):
                        winner, loser = new, old
                except ValueError:
                    pass            # unparseable: keep first
        if loser.vendor_ids:
            winner.vendor_ids = sorted(
                set(winner.vendor_ids) | set(loser.vendor_ids))
        return winner
    # shouldOverwrite: prefer the entry carrying a fix
    if not old.fixed_version and new.fixed_version:
        return new
    return old
