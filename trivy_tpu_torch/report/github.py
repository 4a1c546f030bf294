"""GitHub dependency-snapshot writer
(reference: pkg/report/github/github.go)."""

from __future__ import annotations

import json
import os
from datetime import datetime, timezone

from .. import purl as purl_mod
from ..types import Report
from ..types.common import class_str


class GithubWriter:
    def __init__(self, output, version: str = "dev", now=None):
        self.output = output
        self.version = version
        self.now = now

    def write(self, report: Report) -> None:
        scanned = self.now or datetime.now(timezone.utc)\
            .strftime("%Y-%m-%dT%H:%M:%SZ")
        metadata = {}
        status = getattr(report, "status", "")
        if status and status != "ok":
            metadata["aquasecurity:trivy:ScanStatus"] = status
        if report.metadata.repo_tags:
            metadata["aquasecurity:trivy:RepoTag"] = \
                ", ".join(report.metadata.repo_tags)
        if report.metadata.repo_digests:
            metadata["aquasecurity:trivy:RepoDigest"] = \
                ", ".join(report.metadata.repo_digests)

        manifests = {}
        for result in report.results:
            if not result.packages:
                continue
            manifest = {"name": result.type}
            if class_str(result.class_) == "lang-pkgs":
                manifest["file"] = {"source_location": result.target}
            resolved = {}
            for pkg in result.packages:
                entry = {
                    "package_url": purl_mod.new_package_url(
                        result.type, pkg,
                        os=report.metadata.os).to_string(),
                    "relationship": "indirect" if pkg.indirect
                    else "direct",
                    "scope": "runtime",
                }
                if pkg.depends_on:
                    entry["dependencies"] = pkg.depends_on
                resolved[pkg.name] = entry
            manifest["resolved"] = resolved
            manifests[result.target] = manifest

        snapshot = {
            "version": 0,
            "detector": {
                "name": "trivy",
                "version": self.version,
                "url": "https://github.com/aquasecurity/trivy",
            },
            "scanned": scanned,
        }
        if metadata:
            snapshot["metadata"] = metadata
        ref = os.environ.get("GITHUB_REF", "")
        sha = os.environ.get("GITHUB_SHA", "")
        if ref:
            snapshot["ref"] = ref
        if sha:
            snapshot["sha"] = sha
        correlator = (f"{os.environ.get('GITHUB_WORKFLOW', '')}_"
                      f"{os.environ.get('GITHUB_JOB', '')}")
        snapshot["job"] = {"correlator": correlator,
                           "id": os.environ.get("GITHUB_RUN_ID", "")}
        if manifests:
            snapshot["manifests"] = manifests
        json.dump(snapshot, self.output, indent=2)
        self.output.write("\n")
