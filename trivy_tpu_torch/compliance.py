"""Compliance reporting (copied from ``trivy_tpu/compliance.py``;
reference: pkg/compliance/{spec,report}).

A YAML spec maps controls to check IDs (misconfig rule IDs or
vulnerability IDs); scan results group under each control, producing
an ``all`` report (per-control findings) or a ``summary`` (pass/fail
totals per control). The built-in ``nsa`` spec covers the NSA/CISA
Kubernetes hardening controls the reference embeds.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

log = logging.getLogger("trivy_tpu_torch.compliance")

try:
    import yaml as yaml_mod
except ImportError:              # pragma: no cover
    yaml_mod = None


@dataclass
class Control:
    id: str = ""
    name: str = ""
    description: str = ""
    checks: list = field(default_factory=list)      # check ids
    severity: str = ""
    default_status: str = ""


@dataclass
class Spec:
    id: str = ""
    title: str = ""
    description: str = ""
    version: str = ""
    related_resources: list = field(default_factory=list)
    controls: list = field(default_factory=list)


@dataclass
class ControlResult:
    """One control's outcome (ref ControlCheck + per-control
    findings)."""

    control: Control = None
    status: str = "PASS"
    pass_total: int = 0
    fail_total: int = 0
    findings: list = field(default_factory=list)   # dicts

    def to_dict(self) -> dict:
        d = {"ID": self.control.id, "Name": self.control.name,
             "Severity": self.control.severity,
             "Status": self.status,
             "PassTotal": self.pass_total,
             "FailTotal": self.fail_total}
        if self.findings:
            d["Findings"] = self.findings
        return d


@dataclass
class ComplianceReport:
    spec: Spec = None
    controls: list = field(default_factory=list)   # ControlResult

    def to_dict(self) -> dict:
        return {"ID": self.spec.id, "Title": self.spec.title,
                "Version": self.spec.version,
                "Controls": [c.to_dict() for c in self.controls]}


# NSA/CISA Kubernetes Hardening Guidance v1.0 — the subset whose
# checks this framework's policy set implements (the reference embeds
# the full spec; controls whose checks are absent report via
# defaultStatus, same as the reference's FAIL/WARN defaults).
NSA_SPEC = {
    "spec": {
        "id": "nsa",
        "title": "National Security Agency - Kubernetes Hardening "
                 "Guidance v1.0",
        "description": "National Security Agency - Kubernetes "
                       "Hardening Guidance",
        "version": "1.0",
        "controls": [
            {"id": "1.0", "name": "Non-root containers",
             "checks": [{"id": "KSV012"}], "severity": "MEDIUM"},
            {"id": "1.2", "name": "Immutable container file systems",
             "checks": [{"id": "KSV014"}], "severity": "LOW"},
            {"id": "1.4", "name": "Privileged",
             "checks": [{"id": "KSV017"}], "severity": "HIGH"},
            {"id": "1.6", "name": "Run with root privileges or with "
             "root group membership",
             "checks": [{"id": "KSV029"}], "severity": "LOW"},
            {"id": "1.7", "name": "hostPath mount",
             "checks": [{"id": "KSV006"}], "severity": "MEDIUM"},
            {"id": "1.9", "name": "Privilege escalation",
             "checks": [{"id": "KSV001"}], "severity": "MEDIUM"},
        ],
    },
}


def load_spec(name_or_path: str) -> Spec:
    """Built-in spec name or a YAML file (ref spec/compliance.go
    GetComplianceSpec)."""
    if name_or_path == "nsa":
        doc = NSA_SPEC
    else:
        try:
            with open(name_or_path, encoding="utf-8") as f:
                doc = yaml_mod.safe_load(f) or {}
        except yaml_mod.YAMLError as e:
            raise ValueError(f"invalid spec yaml: {e}")
    if not isinstance(doc, dict):
        raise ValueError("spec yaml must be a mapping with a "
                         "top-level 'spec' key")
    raw = doc.get("spec") or {}
    controls = []
    for c in raw.get("controls") or []:
        controls.append(Control(
            id=str(c.get("id", "")),
            name=c.get("name", ""),
            description=c.get("description", ""),
            checks=[chk.get("id", "") for chk in
                    c.get("checks") or []],
            severity=c.get("severity", ""),
            default_status=c.get("defaultStatus", "")))
    return Spec(id=raw.get("id", ""), title=raw.get("title", ""),
                description=raw.get("description", ""),
                version=str(raw.get("version", "")),
                related_resources=raw.get("relatedResources") or [],
                controls=controls)


def _collect_findings(results) -> tuple:
    """→ ({check_id: [finding dicts]}, {check_id: pass_count})."""
    fails: dict = {}
    passes: dict = {}
    for r in results:
        for m in r.misconfigurations:
            cid = getattr(m, "id", "")
            if getattr(m, "status", "") == "FAIL":
                fails.setdefault(cid, []).append(
                    {"Target": r.target, "ID": cid,
                     "Severity": getattr(m, "severity", ""),
                     "Message": getattr(m, "message", "")})
            else:
                passes[cid] = passes.get(cid, 0) + 1
        for v in r.vulnerabilities:
            fails.setdefault(v.vulnerability_id, []).append(
                {"Target": r.target, "ID": v.vulnerability_id,
                 "Severity": v.severity,
                 "Message": v.pkg_name})
    return fails, passes


def build_report(spec: Spec, results: list) -> ComplianceReport:
    """Map scan results onto the spec's controls
    (ref spec/mapper.go)."""
    fails, passes = _collect_findings(results)
    out = ComplianceReport(spec=spec)
    for control in spec.controls:
        cr = ControlResult(control=control)
        matched = False
        for cid in control.checks:
            if cid in fails:
                cr.findings.extend(fails[cid])
                cr.fail_total += len(fails[cid])
                matched = True
            if cid in passes:
                cr.pass_total += passes[cid]
                matched = True
        if cr.fail_total:
            cr.status = "FAIL"
        elif not matched and control.default_status:
            cr.status = control.default_status
            if control.default_status == "FAIL":
                cr.fail_total = 1
        out.controls.append(cr)
    return out


def render_summary(report: ComplianceReport) -> str:
    from .report.writer import _table
    lines = [f"Summary Report for compliance: {report.spec.title}",
             ""]
    rows = [("ID", "Severity", "Control Name", "Status", "Issues")]
    for cr in report.controls:
        rows.append((cr.control.id, cr.control.severity,
                     cr.control.name, cr.status,
                     str(cr.fail_total)))
    lines.extend(_table(rows))
    return "\n".join(lines) + "\n"


def write_compliance(report: ComplianceReport, fmt: str = "table",
                     output=None) -> None:
    import json
    import sys
    out = output or sys.stdout
    if fmt == "json":
        json.dump(report.to_dict(), out, indent=2)
        out.write("\n")
    else:
        out.write(render_summary(report))
