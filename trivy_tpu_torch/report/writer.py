"""Report format dispatch (reference: pkg/report/writer.go:58-98;
the JAX package's ``report/writer.py``).

Formats: table, json, sarif, cyclonedx, spdx, spdx-json, github,
cosign-vuln, template (``output_template``: the template inline, or
``@path``).
"""

from __future__ import annotations

import json
import sys
from datetime import datetime, timezone
from typing import Optional

from ..types import Report, Severity

_SEV_ORDER = ["CRITICAL", "HIGH", "MEDIUM", "LOW", "UNKNOWN"]

FORMATS = ["table", "json", "sarif", "cyclonedx", "spdx", "spdx-json",
           "github", "cosign-vuln", "template"]


def check_format(fmt: str) -> None:
    """Raise ``ValueError`` unless ``write_report`` can write ``fmt``."""
    if fmt not in FORMATS:
        raise ValueError(f"unknown format: {fmt}")


def write_report(report: Report, fmt: str = "table",
                 output=None, severities: Optional[list] = None,
                 app_version: str = "dev",
                 output_template: str = "",
                 dependency_tree: bool = False) -> None:
    out = output or sys.stdout
    if fmt == "json":
        json.dump(report.to_dict(), out, indent=2)
        out.write("\n")
    elif fmt == "table":
        out.write(render_table(report, severities,
                               dependency_tree=dependency_tree))
    elif fmt == "sarif":
        from .sarif import SarifWriter
        SarifWriter(out, version=app_version).write(report)
    elif fmt == "cyclonedx":
        from ..sbom.cyclonedx import Marshaler
        m = Marshaler(app_version=app_version)
        # an SBOM rescan exports only vulnerabilities referencing the
        # original BOM (ref report/cyclonedx/cyclonedx.go:36-41)
        if report.artifact_type == "cyclonedx" and report.cyclonedx:
            bom = m.marshal_vulnerabilities(report)
        else:
            bom = m.marshal(report)
        json.dump(bom, out, indent=2)
        out.write("\n")
    elif fmt in ("spdx", "spdx-json"):
        from ..sbom.spdx import Marshaler
        m = Marshaler()
        if fmt == "spdx":
            out.write(m.marshal_tv(report))
        else:
            json.dump(m.marshal(report), out, indent=2)
            out.write("\n")
    elif fmt == "github":
        from .github import GithubWriter
        GithubWriter(out, version=app_version).write(report)
    elif fmt == "cosign-vuln":
        now = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        predicate = {
            "invocation": {"parameters": None, "uri": "",
                           "event_id": "", "builder.id": ""},
            "scanner": {
                "uri": f"pkg:github/aquasecurity/trivy@{app_version}",
                "version": app_version,
                "db": {"uri": "", "version": ""},
                "result": report.to_dict(),
            },
            "metadata": {"scanStartedOn": now, "scanFinishedOn": now},
        }
        json.dump(predicate, out, indent=2)
        out.write("\n")
    elif fmt == "template":
        from .template import TemplateWriter
        TemplateWriter(out, output_template).write(report)
    else:
        raise ValueError(f"unknown format: {fmt}")


def render_table(report: Report,
                 severities: Optional[list] = None,
                 dependency_tree: bool = False) -> str:
    sevs = [str(s) if isinstance(s, Severity) else s
            for s in (severities or _SEV_ORDER)]
    lines = []
    status = getattr(report, "status", "")
    if status and status != "ok":
        # degraded-mode banner (docs/robustness.md): the scan
        # completed with survivable faults — say which, up front
        lines.append("")
        lines.append(f"!! scan {status.upper()}: "
                     f"{report.artifact_name}")
        for c in report.failure_causes:
            lines.append(f"   - {c.stage}/{c.kind}: {c.message}")
    for result in report.results:
        header = result.target
        if result.vulnerabilities:
            counts = {s: 0 for s in _SEV_ORDER}
            for v in result.vulnerabilities:
                counts[v.severity if v.severity in counts
                       else "UNKNOWN"] += 1
            total = sum(counts.values())
            summary = ", ".join(
                f"{s}: {counts[s]}" for s in sevs if s in counts)
            lines.append("")
            lines.append(header)
            lines.append("=" * len(header))
            lines.append(f"Total: {total} ({summary})")
            lines.append("")
            rows = [("Library", "Vulnerability", "Severity",
                     "Installed Version", "Fixed Version", "Title")]
            for v in sorted(result.vulnerabilities,
                            key=lambda v: (_sev_rank(v.severity),
                                           v.pkg_name)):
                title = v.vulnerability.title or ""
                if len(title) > 48:
                    title = title[:45] + "..."
                rows.append((v.pkg_name, v.vulnerability_id,
                             v.severity, v.installed_version,
                             v.fixed_version, title))
            lines.extend(_table(rows))
            if dependency_tree:
                lines.extend(_dependency_tree(result))
        if result.secrets:
            lines.append("")
            lines.append(header + " (secrets)")
            lines.append("=" * (len(header) + 10))
            rows = [("Category", "Severity", "Title", "Lines")]
            for s in result.secrets:
                rows.append((s.category, s.severity, s.title,
                             f"{s.start_line}-{s.end_line}"))
            lines.extend(_table(rows))
        if result.licenses:
            lines.append("")
            lines.append(header + " (license)")
            lines.append("=" * (len(header) + 10))
            rows = [("Package/File", "License", "Category",
                     "Severity")]
            for lic in result.licenses:
                rows.append((lic.pkg_name or lic.file_path,
                             lic.name, lic.category, lic.severity))
            lines.extend(_table(rows))
        if result.misconfigurations:
            lines.append("")
            lines.append(header + " (misconfigurations)")
            lines.append("=" * (len(header) + 20))
            rows = [("ID", "Severity", "Status", "Title")]
            for m in result.misconfigurations:
                rows.append((getattr(m, "id", ""),
                             getattr(m, "severity", ""),
                             getattr(m, "status", ""),
                             getattr(m, "title", "")))
            lines.extend(_table(rows))
    if not lines:
        return "\n"
    return "\n".join(lines) + "\n"


def _dependency_tree(result) -> list:
    """Reversed dependency-origin tree under the vulnerability table
    (ref pkg/report/table/vulnerability.go:130
    renderDependencyTree): each vulnerable package prints once with
    its severity tally, then the chain of packages that depend on
    it, so the user can see which direct dependency pulled the
    vulnerable one in."""
    parents: dict = {}
    for pkg in result.packages:
        for dep in pkg.depends_on:
            parents.setdefault(dep, []).append(pkg.id)
    if not parents:
        return []

    sev_count: dict = {}
    for v in result.vulnerabilities:
        counts = sev_count.setdefault(v.pkg_id, {})
        counts[v.severity] = counts.get(v.severity, 0) + 1

    lines = ["", "Dependency Origin Tree (Reversed)",
             "=================================", result.target]

    def add(pkg_id, prefix, seen):
        seen = seen | {pkg_id}
        ps = [p for p in parents.get(pkg_id, []) if p not in seen]
        for i, parent in enumerate(ps):
            last = i == len(ps) - 1
            lines.append(prefix + ("└── " if last else "├── ")
                         + parent)
            add(parent, prefix + ("    " if last else "│   "), seen)

    top = []
    seen_top = set()
    for v in result.vulnerabilities:
        if v.pkg_id and v.pkg_id not in seen_top:
            seen_top.add(v.pkg_id)
            top.append(v.pkg_id)
    for i, pkg_id in enumerate(top):
        counts = sev_count.get(pkg_id, {})
        summary = ", ".join(
            f"{s}: {counts[s]}" for s in _SEV_ORDER if s in counts)
        last = i == len(top) - 1
        lines.append(("└── " if last else "├── ")
                     + f"{pkg_id}, ({summary})")
        add(pkg_id, "    " if last else "│   ", set())
    lines.append("")
    return lines


def _sev_rank(s: str) -> int:
    try:
        return _SEV_ORDER.index(s)
    except ValueError:
        return len(_SEV_ORDER)


def _table(rows: list) -> list:
    widths = [max(len(str(r[i])) for r in rows)
              for i in range(len(rows[0]))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    for i, row in enumerate(rows):
        out.append("| " + " | ".join(
            str(c).ljust(w) for c, w in zip(row, widths)) + " |")
        if i == 0:
            out.append(sep)
    out.append(sep)
    return out
