"""Command line: ``python -m trivy_tpu_torch fs DIR`` and
``python -m trivy_tpu_torch sbom BOM``.

``fs`` scans a directory tree for secrets (the reference's
``trivy fs DIR --security-checks secret``) and prints the report as
JSON: ``SchemaVersion``, ``ArtifactName``, ``ArtifactType`` and
``Results`` — one ``{Target, Class: "secret", Secrets}`` per file
with findings, sorted by path.

``sbom`` scans a CycloneDX (JSON, XML, in-toto attestation) or SPDX
(JSON, tag-value) document for vulnerabilities (the reference's
``trivy sbom BOM``): decode into one blob, ``LocalScanner`` prepare
(apply + advisory name-join), one ``dispatch_jobs`` of the interval
match on ``--backend`` (``cuda`` unless asked otherwise), finish,
filter, and write ``json`` or ``cyclonedx``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import __version__, resolve_device
from .artifact import MemoryCache, SBOMArtifact
from .db import AdvisoryStore, CompiledDB, load_fixtures
from .detect.batch import dispatch_jobs
from .fs import secret_candidates
from .report.writer import (FORMATS, UNPORTED_FORMATS, check_format,
                            write_report)
from .scan import LocalScanner, ScanTarget, filter_results
from .scan.filter import (IgnorePolicyError, load_ignore_file,
                          load_ignore_policy)
from .secret.batch import BatchSecretScanner
from .secret.model import load_config
from .secret.scanner import new_scanner
from .types import Metadata, Report, ScanOptions, Severity

SCHEMA_VERSION = 2
DEFAULT_SEVERITIES = "UNKNOWN,LOW,MEDIUM,HIGH,CRITICAL"
BACKENDS = ("cuda", "cpu", "cpu-ref")
# interchange formats carry the full package inventory (ref
# pkg/commands/artifact/run.go ListAllPkgs override)
_SBOM_FORMATS = ("cyclonedx", "spdx", "spdx-json", "github")


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


def load_store(db_fixtures: str = "", compiled_db: str = "",
               compile_db: bool = False):
    """The advisory source of a scan (ref cli.py ``_store``): a
    ``CompiledDB`` npz (``--compiled-db`` path prefix), else an
    ``AdvisoryStore`` from fixture YAMLs, compiled when asked."""
    if compiled_db:
        return CompiledDB.load(compiled_db)
    store = AdvisoryStore()
    if db_fixtures:
        load_fixtures(_split(db_fixtures), store)
    if compile_db:
        return CompiledDB.compile(store)
    return store


def scan_sbom(path: str, store, backend: str = "cuda", *,
              vuln_type=("os", "library"),
              list_all_packages: bool = False,
              timings: dict = None, stats: dict = None) -> Report:
    """Vulnerability-scan the SBOM at ``path`` against ``store`` and
    return the unfiltered report (ref cli.py ``run_sbom``).

    ``timings`` (optional) receives the seconds of each step:
    ``decode_s``, ``prepare_s`` (apply + name-join), ``dispatch_s``
    and ``finish_s`` (results, enrichment, post-scan hooks);
    ``stats`` receives ``dispatch_jobs``' ``device_s``, ``jobs_in``
    and ``jobs_unique``, and the number of ``hits``. Raises
    ``ValueError`` for a document that is not an SBOM."""
    if backend == "cuda":
        resolve_device(backend)          # fail before the host work
    t = {} if timings is None else timings
    t0 = time.perf_counter()
    cache = MemoryCache()
    ref = SBOMArtifact(path, cache).inspect()
    t1 = time.perf_counter()
    options = ScanOptions(vuln_type=list(vuln_type),
                          security_checks=["vuln"],
                          list_all_packages=list_all_packages,
                          backend=backend)
    scanner = LocalScanner(cache, store)
    prepared = scanner.prepare(
        ScanTarget(name=ref.name, artifact_id=ref.id,
                   blob_ids=ref.blob_ids), options)
    t2 = time.perf_counter()
    detected = dispatch_jobs(prepared.jobs, backend=backend,
                             stats=stats)
    t3 = time.perf_counter()
    if stats is not None:
        stats["hits"] = len(detected)
    results, os_found = scanner.finish(prepared, detected)
    t4 = time.perf_counter()
    t.update(decode_s=t1 - t0, prepare_s=t2 - t1, dispatch_s=t3 - t2,
             finish_s=t4 - t3)
    return Report(artifact_name=path, artifact_type=ref.type,
                  metadata=Metadata(os=os_found), results=results,
                  cyclonedx=ref.cyclonedx)


def filter_report(report: Report, severity: str = DEFAULT_SEVERITIES,
                  ignore_unfixed: bool = False,
                  ignorefile: str = ".trivyignore",
                  ignore_policy: str = "") -> Report:
    """Severity, unfixed, ``.trivyignore`` (read from the current
    directory unless a path is given) and ignore-policy filters, in
    place (ref cli.py ``_finish``). Emptied results stay."""
    report.results = filter_results(
        report.results,
        [Severity.parse(s) for s in severity.split(",") if s.strip()],
        ignore_unfixed=ignore_unfixed,
        ignored_ids=load_ignore_file(ignorefile),
        policy=load_ignore_policy(ignore_policy))
    return report


def _run_sbom(args) -> int:
    if not os.path.isfile(args.target):
        print(f"error: no such file: {args.target}", file=sys.stderr)
        return 1
    # refuse what cannot run before the DB load and the scan
    try:
        check_format(args.format)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.backend == "cuda":
        resolve_device(args.backend)
    store = load_store(args.db_fixtures, args.compiled_db,
                       args.compile_db)
    try:
        report = scan_sbom(
            args.target, store, args.backend,
            vuln_type=_split(args.vuln_type),
            list_all_packages=args.list_all_pkgs
            or args.format in _SBOM_FORMATS)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        filter_report(report, args.severity, args.ignore_unfixed,
                      args.ignorefile, args.ignore_policy)
    except (OSError, IgnorePolicyError) as e:
        print(f"error: ignore policy failed: {e}", file=sys.stderr)
        return 1
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        write_report(report, fmt=args.format, output=out,
                     app_version=__version__)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if args.output:
            out.close()
    if args.exit_code and any(r.failed() for r in report.results):
        return args.exit_code
    return 0


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

    sb = sub.add_parser("sbom", help="scan an SBOM document "
                        "(CycloneDX/SPDX) for vulnerabilities")
    sb.add_argument("target")
    sb.add_argument("--format", "-f", default="json",
                    choices=FORMATS + UNPORTED_FORMATS)
    sb.add_argument("--output", "-o", default="")
    sb.add_argument("--severity", "-s", default=DEFAULT_SEVERITIES)
    sb.add_argument("--vuln-type", default="os,library")
    sb.add_argument("--ignore-unfixed", action="store_true")
    sb.add_argument("--ignorefile", default=".trivyignore")
    sb.add_argument("--ignore-policy", default="",
                    help="Python file defining ignore(finding); "
                    "executed with full interpreter rights")
    sb.add_argument("--exit-code", type=int, default=0)
    sb.add_argument("--list-all-pkgs", action="store_true")
    sb.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="where the interval match runs: cuda "
                    "(default), cpu (the same torch code) or cpu-ref "
                    "(numpy)")
    sb.add_argument("--db-fixtures", default="",
                    help="comma-separated advisory fixture YAMLs")
    sb.add_argument("--compile-db", action="store_true",
                    help="compile the fixture store into resident "
                    "tables before scanning")
    sb.add_argument("--compiled-db", default="",
                    help="load a compiled advisory DB (npz path "
                    "prefix)")
    sb.add_argument("--no-cache", action="store_true",
                    help="accepted for compatibility: the blob cache "
                    "is always in memory")
    args = ap.parse_args(argv)
    if args.command == "sbom":
        return _run_sbom(args)
    report = scan_fs(args.target, device=args.device,
                     secret_config=args.secret_config,
                     skip_dirs=_split(args.skip_dirs),
                     skip_files=_split(args.skip_files))
    json.dump(report, sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0
