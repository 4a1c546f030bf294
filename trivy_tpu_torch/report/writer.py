"""Report format dispatch (reference: pkg/report/writer.go:58-98).

``json`` and ``cyclonedx`` (the full BOM, or for an SBOM rescan the
vulnerabilities-only BOM that refers back to the scanned document).
The table, sarif, spdx, spdx-json, github, cosign-vuln and template
writers are still to be ported: asking for one raises ``ValueError``.
"""

from __future__ import annotations

import json
import sys

from ..types import Report

FORMATS = ["json", "cyclonedx"]
UNPORTED_FORMATS = ["table", "sarif", "spdx", "spdx-json", "github",
                    "cosign-vuln", "template"]


def check_format(fmt: str) -> None:
    """Raise ``ValueError`` unless ``write_report`` can write ``fmt``."""
    if fmt in UNPORTED_FORMATS:
        raise ValueError(f"format {fmt!r} is not ported yet "
                         "(ROADMAP A.9: report writers)")
    if fmt not in FORMATS:
        raise ValueError(f"unknown format: {fmt}")


def write_report(report: Report, fmt: str = "json", output=None,
                 app_version: str = "dev") -> None:
    check_format(fmt)
    out = output or sys.stdout
    if fmt == "json":
        json.dump(report.to_dict(), out, indent=2)
        out.write("\n")
    else:
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
