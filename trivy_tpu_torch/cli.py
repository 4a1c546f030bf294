"""Command line: ``python -m trivy_tpu_torch fs DIR``.

Scans a directory tree for secrets (the reference's
``trivy fs DIR --security-checks secret``) and prints the report as
JSON: ``SchemaVersion``, ``ArtifactName``, ``ArtifactType`` and
``Results`` — one ``{Target, Class: "secret", Secrets}`` per file
with findings, sorted by path.
"""

from __future__ import annotations

import argparse
import json
import sys

from .fs import secret_candidates
from .secret.batch import BatchSecretScanner
from .secret.model import load_config
from .secret.scanner import new_scanner

SCHEMA_VERSION = 2


def _split(s: str) -> list:
    return [x for x in s.split(",") if x]


def scan_fs(root: str, device=None,
            secret_config: str = "trivy-secret.yaml",
            skip_dirs=(), skip_files=(),
            scanner: BatchSecretScanner = None) -> dict:
    """Secret-scan the tree under ``root`` and return the report as a
    JSON-ready dict. ``scanner`` reuses a built BatchSecretScanner
    (its rules and device win over ``secret_config`` and
    ``device``)."""
    if scanner is None:
        scanner = BatchSecretScanner(
            scanner=new_scanner(load_config(secret_config)),
            device=device)
    files = secret_candidates(root, skip_dirs, skip_files,
                              config_path=secret_config)
    secrets = [s for _, s in scanner.scan_files(files)]
    secrets.sort(key=lambda s: s.file_path)
    results = []
    for s in secrets:
        s.findings.sort(key=lambda f: (f.rule_id, f.start_line))
        results.append({"Target": s.file_path, "Class": "secret",
                        "Secrets": [f.to_dict() for f in s.findings]})
    report = {"SchemaVersion": SCHEMA_VERSION, "ArtifactName": root,
              "ArtifactType": "filesystem"}
    if results:
        report["Results"] = results
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trivy_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    fs = sub.add_parser("fs", aliases=["filesystem"],
                        help="scan a directory tree for secrets")
    fs.add_argument("target")
    fs.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    fs.add_argument("--secret-config", default="trivy-secret.yaml")
    fs.add_argument("--skip-dirs", default="")
    fs.add_argument("--skip-files", default="")
    fs.add_argument("--format", "-f", default="json", choices=["json"])
    args = ap.parse_args(argv)
    report = scan_fs(args.target, device=args.device,
                     secret_config=args.secret_config,
                     skip_dirs=_split(args.skip_dirs),
                     skip_files=_split(args.skip_files))
    json.dump(report, sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0
