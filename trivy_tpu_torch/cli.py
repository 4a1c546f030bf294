"""Command line: ``python -m trivy_tpu_torch fs|rootfs DIR`` and
``python -m trivy_tpu_torch sbom BOM``.

``fs`` (alias ``filesystem``) and ``rootfs`` scan a directory tree
(the reference's ``trivy fs DIR``, by default for vulnerabilities and
secrets): ``LocalFSArtifact`` walks it through the analyzers (OS
release, apk/dpkg/rpm databases, language lockfiles, jars, binaries)
and scans every secret candidate in one batched sieve, then
``LocalScanner`` prepares the advisory pair jobs, one
``dispatch_jobs`` runs the interval match, and the results are
finished, filtered and written.

``sbom`` scans a CycloneDX (JSON, XML, in-toto attestation) or SPDX
(JSON, tag-value) document for vulnerabilities (the reference's
``trivy sbom BOM``): decode into one blob, the same prepare, dispatch
and finish.

Both write ``table`` (the default), ``json`` or ``cyclonedx``, and
run on ``--backend cuda`` unless asked for ``cpu`` (the same torch
code on the CPU) or ``cpu-ref`` (numpy).
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

from . import __version__, resolve_device
from .artifact import LocalFSArtifact, MemoryCache, SBOMArtifact
from .db import AdvisoryStore, CompiledDB, load_fixtures
from .detect.batch import dispatch_jobs
from .handler.unpackaged import check_rekor
from .report.writer import (FORMATS, UNPORTED_FORMATS, check_format,
                            write_report)
from .scan import LocalScanner, ScanTarget, filter_results
from .scan.filter import (IgnorePolicyError, load_ignore_file,
                          load_ignore_policy)
from .scan.local import check_security_checks
from .types import Metadata, Report, ScanOptions, Severity

DEFAULT_SEVERITIES = "UNKNOWN,LOW,MEDIUM,HIGH,CRITICAL"
BACKENDS = ("cuda", "cpu", "cpu-ref")
# interchange formats carry the full package inventory (ref
# pkg/commands/artifact/run.go ListAllPkgs override)
_SBOM_FORMATS = ("cyclonedx", "spdx", "spdx-json", "github")


def _split(s: str) -> list:
    return [x for x in s.split(",") if x]


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


def _scan(scanner: LocalScanner, ref, options: ScanOptions,
          t: dict, stats: dict) -> tuple:
    """prepare → one ``dispatch_jobs`` → finish (ref LocalScanner
    ``scan``), timing each step into ``t``."""
    t0 = time.perf_counter()
    prepared = scanner.prepare(
        ScanTarget(name=ref.name, artifact_id=ref.id,
                   blob_ids=ref.blob_ids), options)
    t1 = time.perf_counter()
    detected = dispatch_jobs(prepared.jobs, backend=options.backend,
                             stats=stats)
    t2 = time.perf_counter()
    if stats is not None:
        stats["hits"] = len(detected)
    out = scanner.finish(prepared, detected)
    t.update(prepare_s=t1 - t0, dispatch_s=t2 - t1,
             finish_s=time.perf_counter() - t2)
    return out


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
    t["decode_s"] = time.perf_counter() - t0
    options = ScanOptions(vuln_type=list(vuln_type),
                          security_checks=["vuln"],
                          list_all_packages=list_all_packages,
                          backend=backend)
    results, os_found = _scan(LocalScanner(cache, store), ref, options,
                              t, stats)
    return Report(artifact_name=path, artifact_type=ref.type,
                  metadata=Metadata(os=os_found), results=results,
                  cyclonedx=ref.cyclonedx)


def secret_scanner(secret_config: str = "trivy-secret.yaml",
                   backend: str = "cuda"):
    """The batched secret scanner of a filesystem scan on
    ``backend``, with the rules of ``secret_config`` (the builtin
    rules when the file does not exist)."""
    from .secret.batch import BatchSecretScanner
    from .secret.model import load_config
    from .secret.scanner import new_scanner
    return BatchSecretScanner(
        scanner=new_scanner(load_config(secret_config)),
        backend=backend)


def scan_fs(root: str, store=None, backend: str = "cuda", *,
            security_checks=("vuln", "secret"),
            vuln_type=("os", "library"),
            list_all_packages: bool = False,
            secret_config: str = "trivy-secret.yaml",
            skip_dirs=(), skip_files=(), file_patterns=None,
            scanner=None, timings: dict = None,
            stats: dict = None) -> Report:
    """Scan the directory tree under ``root`` and return the
    unfiltered report (ref cli.py ``run_fs``): ``LocalFSArtifact``
    inspect (walk, analyzers, one batched secret sieve) →
    ``LocalScanner`` prepare → one ``dispatch_jobs`` → finish.

    ``store`` is the advisory source (``load_store``); a scan without
    the ``vuln`` check needs none. ``scanner`` reuses a built
    ``BatchSecretScanner`` (``secret_scanner``) on the same
    ``backend``, whose rules then win over ``secret_config``.
    ``timings`` receives the seconds of ``inspect_s`` and, inside it,
    ``secret_s`` (the batched secret scan) and ``walk_analyze_s`` (the
    rest), then ``prepare_s``, ``dispatch_s`` and ``finish_s``;
    ``stats`` receives ``dispatch_jobs``' counters, ``hits`` and the
    secret scanner's ``secret`` stats. Raises before any host work
    when ``cuda`` has no card, ``scanner`` runs on another backend,
    or a check or the Rekor lookup is still to be ported."""
    if backend == "cuda":
        resolve_device(backend)          # fail before the host work
    check_security_checks(security_checks)
    check_rekor()
    t = {} if timings is None else timings
    checks = list(security_checks)
    if "secret" not in checks:
        scanner = None
    elif scanner is None:
        scanner = secret_scanner(secret_config, backend)
    elif scanner.backend != backend:
        raise ValueError(f"secret scanner on {scanner.backend!r}, "
                         f"scan on {backend!r}")
    if scanner is not None:
        # the rule config itself is never scanned: the registered
        # secret analyzer is told its path (ref cli.py:1684-1687;
        # process-global, as in the reference)
        from .analyzer import registered_analyzers
        for a in registered_analyzers():
            if a.type == "secret":
                a.config_path = secret_config
        scanner.stats = {}
    cache = MemoryCache()
    t0 = time.perf_counter()
    ref = LocalFSArtifact(root, cache, skip_dirs=skip_dirs,
                          skip_files=skip_files,
                          file_patterns=file_patterns,
                          secret_scanner=scanner).inspect()
    t["inspect_s"] = time.perf_counter() - t0
    sstats = scanner.stats if scanner is not None else {}
    t["secret_s"] = sstats.get("sieve_s", 0.0) + \
        sstats.get("verify_s", 0.0)
    t["walk_analyze_s"] = t["inspect_s"] - t["secret_s"]
    if stats is not None:
        stats["secret"] = dict(sstats)
    options = ScanOptions(vuln_type=list(vuln_type),
                          security_checks=checks,
                          list_all_packages=list_all_packages,
                          backend=backend)
    results, os_found = _scan(LocalScanner(cache, store), ref, options,
                              t, stats)
    return Report(artifact_name=root, artifact_type="filesystem",
                  metadata=Metadata(os=os_found), results=results)


def filter_report(report: Report, severity: str = DEFAULT_SEVERITIES,
                  ignore_unfixed: bool = False,
                  ignorefile: str = ".trivyignore",
                  ignore_policy: str = "") -> Report:
    """Severity, unfixed, ``.trivyignore`` (read from the current
    directory unless a path is given) and ignore-policy filters, in
    place (ref cli.py ``_finish``). Emptied results stay."""
    report.results = filter_results(
        report.results, _severities(severity),
        ignore_unfixed=ignore_unfixed,
        ignored_ids=load_ignore_file(ignorefile),
        policy=load_ignore_policy(ignore_policy))
    return report


def _severities(arg: str) -> list:
    return [Severity.parse(s) for s in arg.split(",") if s.strip()]


def _file_patterns(pairs) -> dict:
    """--file-patterns TYPE:REGEX pairs → {analyzer type: regex}
    (ref analyzer.go:451-469 CreateFilePatterns: split on the first
    colon, reject malformed pairs, compile eagerly so a bad regex
    fails the run up front). Repeats for one type OR with '|'."""
    out: dict = {}
    for pair in pairs:
        atype, sep, pattern = pair.partition(":")
        if not sep or not atype or not pattern:
            raise ValueError(
                f"invalid file pattern {pair!r} "
                "(want TYPE:REGEX, e.g. dockerfile:Customfile)")
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(
                f"invalid file pattern regex {pattern!r}: {e}")
        # non-capturing groups keep each alternative self-contained
        # (a bare '|' join would let an inline flag in one pattern
        # leak into — or break compilation of — the others)
        out[atype] = f"{out[atype]}|(?:{pattern})" \
            if atype in out else f"(?:{pattern})"
    for combined in out.values():
        re.compile(combined)        # the joined form must compile too
    return out


def _list_all(args) -> bool:
    # SBOM interchange formats need the full package inventory, and
    # the dependency tree renders from Result.Packages (ref
    # report_flags.go ListAllPkgs override)
    return args.list_all_pkgs or args.dependency_tree or \
        args.format in _SBOM_FORMATS


def _finish(args, report: Report) -> int:
    """Filter, write and pick the exit code (ref cli.py ``_finish``)."""
    try:
        filter_report(report, args.severity, args.ignore_unfixed,
                      args.ignorefile, args.ignore_policy)
    except (OSError, IgnorePolicyError) as e:
        print(f"error: ignore policy failed: {e}", file=sys.stderr)
        return 1
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        write_report(report, fmt=args.format, output=out,
                     severities=[str(s) for s in
                                 _severities(args.severity)],
                     app_version=__version__,
                     dependency_tree=args.dependency_tree)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if args.output:
            out.close()
    if args.exit_code and any(r.failed() for r in report.results):
        return args.exit_code
    return 0


def _refuse_early(args) -> bool:
    """Refuse what cannot run before the DB load and the scan: an
    unported format, and ``cuda`` without a card (which raises)."""
    try:
        check_format(args.format)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return True
    if args.backend == "cuda":
        resolve_device(args.backend)
    return False


def _run_sbom(args) -> int:
    if not os.path.isfile(args.target):
        print(f"error: no such file: {args.target}", file=sys.stderr)
        return 1
    if _refuse_early(args):
        return 1
    store = load_store(args.db_fixtures, args.compiled_db,
                       args.compile_db)
    try:
        report = scan_sbom(args.target, store, args.backend,
                           vuln_type=_split(args.vuln_type),
                           list_all_packages=_list_all(args))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return _finish(args, report)


def _run_fs(args) -> int:
    if not os.path.isdir(args.target):
        print(f"error: no such directory: {args.target}",
              file=sys.stderr)
        return 1
    if _refuse_early(args):
        return 1
    checks = _split(args.security_checks)
    check_security_checks(checks)
    try:
        patterns = _file_patterns(args.file_patterns)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    # a scan without the vuln check loads no DB (ref cli.py:1895-1898)
    store = load_store(args.db_fixtures, args.compiled_db,
                       args.compile_db) if "vuln" in checks else None
    report = scan_fs(args.target, store, args.backend,
                     security_checks=checks,
                     vuln_type=_split(args.vuln_type),
                     list_all_packages=_list_all(args),
                     secret_config=args.secret_config,
                     skip_dirs=_split(args.skip_dirs),
                     skip_files=_split(args.skip_files),
                     file_patterns=patterns)
    return _finish(args, report)


def _scan_flags(sp) -> None:
    """The reference's ``scan_flags`` that the port reads."""
    sp.add_argument("target")
    sp.add_argument("--format", "-f", default="table",
                    choices=FORMATS + UNPORTED_FORMATS)
    sp.add_argument("--output", "-o", default="")
    sp.add_argument("--severity", "-s", default=DEFAULT_SEVERITIES)
    sp.add_argument("--vuln-type", default="os,library")
    sp.add_argument("--ignore-unfixed", action="store_true")
    sp.add_argument("--ignorefile", default=".trivyignore")
    sp.add_argument("--ignore-policy", default="",
                    help="Python file defining ignore(finding); "
                    "executed with full interpreter rights")
    sp.add_argument("--exit-code", type=int, default=0)
    sp.add_argument("--list-all-pkgs", action="store_true")
    sp.add_argument("--dependency-tree", action="store_true",
                    help="show a reversed dependency origin tree "
                    "under the vulnerability table (table format "
                    "only)")
    sp.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="where the device stages run: cuda "
                    "(default), cpu (the same torch code) or cpu-ref "
                    "(numpy)")
    sp.add_argument("--db-fixtures", default="",
                    help="comma-separated advisory fixture YAMLs")
    sp.add_argument("--compile-db", action="store_true",
                    help="compile the fixture store into resident "
                    "tables before scanning")
    sp.add_argument("--compiled-db", default="",
                    help="load a compiled advisory DB (npz path "
                    "prefix)")
    sp.add_argument("--no-cache", action="store_true",
                    help="accepted for compatibility: the blob cache "
                    "is always in memory")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trivy_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    for name, aliases, what in (
            ("fs", ["filesystem"], "a directory tree"),
            ("rootfs", [], "an unpacked root filesystem")):
        fs = sub.add_parser(name, aliases=aliases,
                            help=f"scan {what} for vulnerabilities "
                            "and secrets")
        _scan_flags(fs)
        fs.add_argument("--security-checks", default="vuln,secret")
        fs.add_argument("--skip-dirs", default="")
        fs.add_argument("--skip-files", default="")
        fs.add_argument("--file-patterns", action="append",
                        default=[], metavar="TYPE:REGEX",
                        help="force files matching REGEX through the "
                        "TYPE analyzer, e.g. pip:deps.txt; repeatable")
        fs.add_argument("--secret-config", default="trivy-secret.yaml")

    sb = sub.add_parser("sbom", help="scan an SBOM document "
                        "(CycloneDX/SPDX) for vulnerabilities")
    _scan_flags(sb)
    args = ap.parse_args(argv)
    if args.command == "sbom":
        return _run_sbom(args)
    return _run_fs(args)
