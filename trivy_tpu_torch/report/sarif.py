"""SARIF 2.1.0 writer (reference: pkg/report/sarif.go).

One rule per distinct finding id, one result per finding occurrence;
vulnerability results point at the package path, misconfig/secret
results carry line regions.
"""

from __future__ import annotations

import html
import json
import re

from ..types import Report
from ..types.common import class_str

_RULE_NAMES = {
    "os-pkgs": "OsPackageVulnerability",
    "lang-pkgs": "LanguageSpecificPackageVulnerability",
    "config": "Misconfiguration",
    "secret": "Secret",
}

_BUILTIN_RULES_URL = ("https://github.com/aquasecurity/trivy/blob/main/"
                      "pkg/fanal/secret/builtin-rules.go")

# strip a trailing " (distro:version)" suffix from scan targets
_PATH_RE = re.compile(r"(?P<path>.+?)(?:\s*\((?:.*?)\).*?)?$")


def _level(severity: str) -> str:
    if severity in ("CRITICAL", "HIGH"):
        return "error"
    if severity == "MEDIUM":
        return "warning"
    if severity in ("LOW", "UNKNOWN"):
        return "note"
    return "none"


def _severity_score(severity: str) -> str:
    return {"CRITICAL": "9.5", "HIGH": "8.0", "MEDIUM": "5.5",
            "LOW": "2.0"}.get(severity, "0.0")


def _cvss_score(vuln) -> str:
    detail = vuln.vulnerability
    if detail is not None:
        cvss = (detail.cvss or {}).get(vuln.severity_source)
        if cvss and cvss.get("V3Score"):
            return f"{cvss['V3Score']:.1f}"
    return _severity_score(vuln.severity)


def to_path_uri(target: str) -> str:
    m = _PATH_RE.match(target)
    if m:
        target = m.group("path")
    # image refs: keep only the repository part (drop the tag; a ':'
    # followed by '/' is a registry port, not a tag)
    head, sep, tail = target.rpartition(":")
    if sep and "/" not in tail:
        target = head
    return target.replace("\\", "/")


class SarifWriter:
    def __init__(self, output, version: str = "dev"):
        self.output = output
        self.version = version
        self._rules = []
        self._rule_index = {}
        self._results = []

    def _add(self, *, rule_id, rule_name, severity, score, url,
             short_desc, full_desc, help_text, help_md, title,
             location, location_msg, message, start_line=0,
             end_line=0):
        if rule_id not in self._rule_index:
            self._rule_index[rule_id] = len(self._rules)
            rule = {
                "id": rule_id,
                "name": rule_name,
                "shortDescription": {"text": short_desc},
                "fullDescription": {"text": full_desc},
                "defaultConfiguration": {"level": _level(severity)},
                "help": {"text": help_text, "markdown": help_md},
                "properties": {
                    "precision": "very-high",
                    "security-severity": score,
                    "tags": [title, "security", severity],
                },
            }
            if url:
                rule["helpUri"] = url
            self._rules.append(rule)
        region = {"startLine": start_line or 1,
                  "endLine": end_line or start_line or 1,
                  "startColumn": 1, "endColumn": 1}
        self._results.append({
            "ruleId": rule_id,
            "ruleIndex": self._rule_index[rule_id],
            "level": _level(severity),
            "message": {"text": message},
            "locations": [{
                "message": {"text": location_msg},
                "physicalLocation": {
                    "artifactLocation": {"uri": location,
                                         "uriBaseId": "ROOTPATH"},
                    "region": region,
                },
            }],
        })

    def write(self, report: Report) -> None:
        for result in report.results:
            target = to_path_uri(result.target)
            rule_name = _RULE_NAMES.get(class_str(result.class_),
                                        "UnknownIssue")
            for v in result.vulnerabilities:
                detail = v.vulnerability
                title = detail.title if detail else ""
                desc = (detail.description if detail else "") or title
                path = to_path_uri(v.pkg_path) if v.pkg_path \
                    else target
                self._add(
                    rule_id=v.vulnerability_id, rule_name=rule_name,
                    severity=v.severity, score=_cvss_score(v),
                    url=v.primary_url, title="vulnerability",
                    short_desc=html.escape(title, quote=False),
                    full_desc=html.escape(desc, quote=False),
                    help_text=(
                        f"Vulnerability {v.vulnerability_id}\n"
                        f"Severity: {v.severity}\n"
                        f"Package: {v.pkg_name}\n"
                        f"Fixed Version: {v.fixed_version}\n"
                        f"Link: [{v.vulnerability_id}]"
                        f"({v.primary_url})\n{desc}"),
                    help_md=(
                        f"**Vulnerability {v.vulnerability_id}**\n"
                        "| Severity | Package | Fixed Version | Link |"
                        "\n| --- | --- | --- | --- |\n"
                        f"|{v.severity}|{v.pkg_name}|"
                        f"{v.fixed_version}|[{v.vulnerability_id}]"
                        f"({v.primary_url})|\n\n{desc}"),
                    location=path,
                    location_msg=(f"{path}: {v.pkg_name}@"
                                  f"{v.installed_version}"),
                    message=(
                        f"Package: {v.pkg_name}\n"
                        f"Installed Version: {v.installed_version}\n"
                        f"Vulnerability {v.vulnerability_id}\n"
                        f"Severity: {v.severity}\n"
                        f"Fixed Version: {v.fixed_version}\n"
                        f"Link: [{v.vulnerability_id}]"
                        f"({v.primary_url})"))
            for m in result.misconfigurations:
                self._add(
                    rule_id=m.id, rule_name=rule_name,
                    severity=m.severity,
                    score=_severity_score(m.severity),
                    url=m.primary_url, title="misconfiguration",
                    short_desc=html.escape(m.title, quote=False),
                    full_desc=html.escape(m.description, quote=False),
                    help_text=(
                        f"Misconfiguration {m.id}\nType: {m.type}\n"
                        f"Severity: {m.severity}\nCheck: {m.title}\n"
                        f"Message: {m.message}\n"
                        f"Link: [{m.id}]({m.primary_url})\n"
                        f"{m.description}"),
                    help_md=(
                        f"**Misconfiguration {m.id}**\n"
                        "| Type | Severity | Check | Message | Link |"
                        "\n| --- | --- | --- | --- | --- |\n"
                        f"|{m.type}|{m.severity}|{m.title}|"
                        f"{m.message}|[{m.id}]({m.primary_url})|"
                        f"\n\n{m.description}"),
                    location=target, location_msg=target,
                    start_line=m.cause_metadata.start_line,
                    end_line=m.cause_metadata.end_line,
                    message=(
                        f"Artifact: {result.target}\n"
                        f"Type: {result.type}\n"
                        f"Vulnerability {m.id}\n"
                        f"Severity: {m.severity}\n"
                        f"Message: {m.message}\n"
                        f"Link: [{m.id}]({m.primary_url})"))
            for s in result.secrets:
                self._add(
                    rule_id=s.rule_id, rule_name=rule_name,
                    severity=s.severity,
                    score=_severity_score(s.severity),
                    url=_BUILTIN_RULES_URL, title="secret",
                    short_desc=html.escape(s.title, quote=False),
                    full_desc=html.escape(s.match, quote=False),
                    help_text=(f"Secret {s.title}\n"
                               f"Severity: {s.severity}\n"
                               f"Match: {s.match}"),
                    help_md=(f"**Secret {s.title}**\n"
                             "| Severity | Match |\n| --- | --- |\n"
                             f"|{s.severity}|{s.match}|"),
                    location=target, location_msg=target,
                    start_line=s.start_line, end_line=s.end_line,
                    message=(f"Artifact: {result.target}\n"
                             f"Type: {result.type}\n"
                             f"Secret {s.title}\n"
                             f"Severity: {s.severity}\n"
                             f"Match: {s.match}"))

        doc = {
            "version": "2.1.0",
            "$schema": ("https://json.schemastore.org/sarif-2.1.0-"
                        "rtm.5.json"),
            "runs": [{
                "tool": {"driver": {
                    "fullName": "Trivy Vulnerability Scanner",
                    "informationUri":
                        "https://github.com/aquasecurity/trivy",
                    "name": "Trivy",
                    "rules": self._rules,
                    "version": self.version,
                }},
                "results": self._results,
                "columnKind": "utf16CodeUnits",
                "originalUriBaseIds": {
                    "ROOTPATH": {"uri": "file:///"},
                },
            }],
        }
        status = getattr(report, "status", "")
        if status and status != "ok":
            # degraded-mode annotation: run-level properties, so a
            # partially-failed fleet scan is machine-detectable
            doc["runs"][0]["properties"] = {
                "scanStatus": status,
                "failureCauses": [c.to_dict()
                                  for c in report.failure_causes],
            }
        json.dump(doc, self.output, indent=2)
        self.output.write("\n")
