"""Vulnerability enrichment — severity precedence + primary URL.

Reference: pkg/vulnerability/vulnerability.go FillInfo (44-93):
package-specific vendor severity (SeveritySource set by the detector)
wins; else the datasource's vendor severity; else NVD; else the record
severity; else UNKNOWN. Primary URL by id prefix, then per-source
reference prefixes (16-24, 96-).
"""

from __future__ import annotations

import logging

from ..types import Vulnerability
from ..types.common import SEVERITIES

log = logging.getLogger("trivy_tpu_torch.detect.enrich")

_PRIMARY_URL_PREFIXES = {
    "debian": ["http://www.debian.org", "https://www.debian.org"],
    "ubuntu": ["http://www.ubuntu.com", "https://usn.ubuntu.com"],
    "redhat": ["https://access.redhat.com"],
    "suse-cvrf": ["http://lists.opensuse.org",
                  "https://lists.opensuse.org"],
    "oracle-oval": ["http://linux.oracle.com/errata",
                    "https://linux.oracle.com/errata"],
    "nodejs-security-wg": ["https://www.npmjs.com",
                           "https://hackerone.com"],
    "ruby-advisory-db": ["https://groups.google.com"],
}


def _sev_name(v) -> str:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        i = int(v)
        return str(SEVERITIES[i]) if 0 <= i < len(SEVERITIES) \
            else "UNKNOWN"
    return str(v)


def _rfc3339(v):
    """YAML fixture dates parse to datetime; Go marshals time.Time as
    RFC3339 with a Z suffix for UTC."""
    if v is None or isinstance(v, str):
        return v or None
    s = v.isoformat()
    if s.endswith("+00:00"):
        s = s[:-6] + "Z"
    elif getattr(v, "tzinfo", None) is None:
        # naive datetimes and bare dates both marshal as UTC
        if "T" not in s:
            s += "T00:00:00"
        s += "Z"
    return s


def fill_info(store, vulns: list) -> None:
    """Mutates DetectedVulnerability list in place."""
    for v in vulns:
        detail = store.get_vulnerability(v.vulnerability_id)
        if detail is None:
            continue
        source = v.data_source.id if v.data_source else ""
        severity, severity_source = _vendor_severity(detail, source)
        if v.severity_source:
            # package-specific severity from the detector wins
            severity = v.vulnerability.severity or "UNKNOWN"
            severity_source = v.severity_source

        v.vulnerability = Vulnerability(
            title=detail.title,
            description=detail.description,
            severity=severity,
            cwe_ids=detail.cwe_ids,
            vendor_severity={k: _sev_name(s) for k, s in
                             detail.vendor_severity.items()},
            cvss=detail.cvss,
            references=detail.references,
            published_date=_rfc3339(detail.published_date),
            last_modified_date=_rfc3339(detail.last_modified_date),
        )
        v.severity_source = severity_source
        v.primary_url = _primary_url(v.vulnerability_id,
                                     detail.references, source)


def _vendor_severity(detail, source: str) -> tuple:
    vs = detail.vendor_severity
    if source in vs:
        return _sev_name(vs[source]), source
    if "nvd" in vs:
        return _sev_name(vs["nvd"]), "nvd"
    if not detail.severity:
        return "UNKNOWN", ""
    return detail.severity, ""


def _primary_url(vuln_id: str, refs: list, source: str) -> str:
    if vuln_id.startswith("CVE-"):
        return "https://avd.aquasec.com/nvd/" + vuln_id.lower()
    if vuln_id.startswith("RUSTSEC-"):
        return "https://osv.dev/vulnerability/" + vuln_id
    if vuln_id.startswith("GHSA-"):
        return "https://github.com/advisories/" + vuln_id
    if vuln_id.startswith("TEMP-"):
        return "https://security-tracker.debian.org/tracker/" + vuln_id
    for pre in _PRIMARY_URL_PREFIXES.get(source, []):
        for ref in refs:
            if ref.startswith(pre):
                return ref
    return ""
