"""Command line: ``python -m trivy_tpu_torch image X.tar``,
``python -m trivy_tpu_torch fs|rootfs DIR`` and
``python -m trivy_tpu_torch sbom BOM``.

``image`` scans a container image (the reference's ``trivy image
--input X.tar``, by default for vulnerabilities and secrets): a
docker-save tar, an OCI layout tar or an OCI layout directory is
loaded under a per-target ingest budget, ``ImageArtifact`` walks every
layer its cache keys miss (whiteouts, opaque dirs, the guards) through
the analyzers and scans the secret candidates of every missing,
non-base layer in one batched sieve, then ``LocalScanner`` prepares
the advisory pair jobs, one ``dispatch_jobs`` runs the interval match,
and the results are finished, filtered and written.

``image a.tar b.tar ...`` scans a fleet in one batch (the reference's
``--sched off`` direct path, ``runtime/batch.py``): every image's
missing layers are walked, ONE sieve runs over every secret candidate
of every image, and the interval match over every image's pairs runs
in waves kept in flight by a dispatch ring (``--dispatch-depth``).
``json`` writes one array of reports, ``table`` one table after
another; a target that fails prints ``error: NAME: ...`` and the run
exits 1. The continuous-batching scheduler (``--sched on``, the
reference's default for several targets) is ROADMAP A.5 and refused.

``fs`` (alias ``filesystem``) and ``rootfs`` scan a directory tree
(the reference's ``trivy fs DIR``): ``LocalFSArtifact`` walks it
through the same analyzers into one blob and one batched sieve, then
the same prepare, dispatch and finish.

``sbom`` scans a CycloneDX (JSON, XML, in-toto attestation) or SPDX
(JSON, tag-value) document for vulnerabilities (the reference's
``trivy sbom BOM``): decode into one blob, the same prepare, dispatch
and finish.

All write ``table`` (the default), ``json`` or ``cyclonedx``, and run
on ``--backend cuda`` unless asked for ``cpu`` (the same torch code on
the CPU) or ``cpu-ref`` (numpy). Blobs go to an in-memory cache unless
``--cache-dir`` names a directory for the on-disk one (``--no-cache``
keeps them in memory all the same); the findings memo is ROADMAP A.7,
so every scan behaves as the reference's ``--no-memo``.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import re
import sys
import time
from tarfile import TarError

from . import __version__, resolve_device
from .artifact import (ArtifactOption, FSCache, ImageArtifact,
                       LocalFSArtifact, MemoryCache, SBOMArtifact,
                       load_image)
from .db import AdvisoryStore, CompiledDB, load_fixtures
from .detect.batch import dispatch_jobs
from .guard import DEFAULT_LIMITS, make_budget
from .handler.unpackaged import check_rekor
from .report.writer import (FORMATS, UNPORTED_FORMATS, check_format,
                            write_report)
from .runtime import BatchScanRunner
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
    """The batched secret scanner of a filesystem or image scan on
    ``backend``, with the rules of ``secret_config`` (the builtin
    rules when the file does not exist)."""
    from .secret.batch import BatchSecretScanner
    from .secret.model import load_config
    from .secret.scanner import new_scanner
    return BatchSecretScanner(
        scanner=new_scanner(load_config(secret_config)),
        backend=backend)


def make_cache(cache_dir: str = "", no_cache: bool = False):
    """The blob cache of a scan (ref cli.py ``_cache``): the on-disk
    ``FSCache`` under ``cache_dir``, else (or with ``no_cache``) a
    ``MemoryCache``."""
    if cache_dir and not no_cache:
        return FSCache(cache_dir)
    return MemoryCache()


def _artifact_option(backend: str, security_checks, secret_config: str,
                     scanner, skip_dirs, skip_files, file_patterns,
                     ingest_guards: bool = True,
                     ingest_limits=None) -> ArtifactOption:
    """The artifact options of a scan (ref cli.py ``_artifact_option``):
    with the ``secret`` check, ``scanner`` (built from
    ``secret_config`` when None, on ``backend``) and the registered
    secret analyzer told the rule config's path, which it never
    scans (process-global, as in the reference)."""
    checks = list(security_checks)
    if "secret" not in checks:
        scanner = None
    elif scanner is None:
        scanner = secret_scanner(secret_config, backend)
    elif scanner.backend != backend:
        raise ValueError(f"secret scanner on {scanner.backend!r}, "
                         f"scan on {backend!r}")
    if scanner is not None:
        from .analyzer import registered_analyzers
        for a in registered_analyzers():
            if a.type == "secret":
                a.config_path = secret_config
        scanner.stats = {}
    return ArtifactOption(
        skip_dirs=list(skip_dirs), skip_files=list(skip_files),
        file_patterns=dict(file_patterns or {}),
        secret_scanner=scanner,
        scan_secrets="secret" in checks,
        ingest_guards=ingest_guards, ingest_limits=ingest_limits)


def _secret_timings(t: dict, option: ArtifactOption,
                    stats: dict) -> None:
    """Split ``inspect_s`` into the batched secret scan (``secret_s``)
    and the rest (``walk_analyze_s``)."""
    scanner = option.secret_scanner
    sstats = scanner.stats if scanner is not None else {}
    t["secret_s"] = sstats.get("sieve_s", 0.0) + \
        sstats.get("verify_s", 0.0)
    t["walk_analyze_s"] = t["inspect_s"] - t["secret_s"]
    if stats is not None:
        stats["secret"] = dict(sstats)


def scan_fs(root: str, store=None, backend: str = "cuda", *,
            security_checks=("vuln", "secret"),
            vuln_type=("os", "library"),
            list_all_packages: bool = False,
            secret_config: str = "trivy-secret.yaml",
            skip_dirs=(), skip_files=(), file_patterns=None,
            scanner=None, cache=None, timings: dict = None,
            stats: dict = None) -> Report:
    """Scan the directory tree under ``root`` and return the
    unfiltered report (ref cli.py ``run_fs``): ``LocalFSArtifact``
    inspect (walk, analyzers, one batched secret sieve) →
    ``LocalScanner`` prepare → one ``dispatch_jobs`` → finish.

    ``store`` is the advisory source (``load_store``); a scan without
    the ``vuln`` check needs none. ``scanner`` reuses a built
    ``BatchSecretScanner`` (``secret_scanner``) on the same
    ``backend``, whose rules then win over ``secret_config``.
    ``cache`` is the blob cache (``make_cache``; a new ``MemoryCache``
    when None). ``timings`` receives the seconds of ``inspect_s`` and,
    inside it, ``secret_s`` (the batched secret scan) and
    ``walk_analyze_s`` (the rest), then ``prepare_s``, ``dispatch_s``
    and ``finish_s``; ``stats`` receives ``dispatch_jobs``' counters,
    ``hits`` and the secret scanner's ``secret`` stats. Raises before
    any host work when ``cuda`` has no card, ``scanner`` runs on
    another backend, or a check or the Rekor lookup is still to be
    ported."""
    if backend == "cuda":
        resolve_device(backend)          # fail before the host work
    check_security_checks(security_checks)
    check_rekor()
    t = {} if timings is None else timings
    option = _artifact_option(backend, security_checks, secret_config,
                              scanner, skip_dirs, skip_files,
                              file_patterns)
    cache = MemoryCache() if cache is None else cache
    t0 = time.perf_counter()
    ref = LocalFSArtifact(root, cache, option).inspect()
    t["inspect_s"] = time.perf_counter() - t0
    _secret_timings(t, option, stats)
    options = ScanOptions(vuln_type=list(vuln_type),
                          security_checks=list(security_checks),
                          list_all_packages=list_all_packages,
                          backend=backend)
    results, os_found = _scan(LocalScanner(cache, store), ref, options,
                              t, stats)
    return Report(artifact_name=root, artifact_type="filesystem",
                  metadata=Metadata(os=os_found), results=results)


class ImageLoadError(ValueError):
    """The image could not be loaded (a missing, unreadable or
    malformed archive, or a guard trip while reading its metadata)."""


def scan_image(path: str, store=None, backend: str = "cuda", *,
               security_checks=("vuln", "secret"),
               vuln_type=("os", "library"),
               list_all_packages: bool = False,
               scan_removed_packages: bool = False,
               secret_config: str = "trivy-secret.yaml",
               skip_dirs=(), skip_files=(), file_patterns=None,
               scanner=None, ingest_guards: bool = True,
               ingest_limits=None, cache=None, name: str = "",
               timings: dict = None, stats: dict = None) -> Report:
    """Scan the container image at ``path`` (a docker-save tar, an OCI
    layout tar or an OCI layout directory) and return the unfiltered
    report (ref cli.py ``run_image``): ``load_image`` under a
    per-target ingest budget (none with ``ingest_guards=False``) →
    ``ImageArtifact`` inspect (the layers the cache misses: walk,
    analyzers, one batched secret sieve over every missing, non-base
    layer) → ``LocalScanner`` prepare → one ``dispatch_jobs`` →
    finish. A report whose budget noted soft faults is marked
    ``degraded`` with ``ingest`` causes.

    ``store``, ``scanner`` and ``cache`` are as ``scan_fs`` takes
    them; ``name`` is the report's artifact name (``path`` when
    empty). ``timings`` receives ``load_s``, ``inspect_s`` with
    ``secret_s`` and ``walk_analyze_s`` inside it, ``prepare_s``,
    ``dispatch_s`` and ``finish_s``; ``stats`` receives
    ``dispatch_jobs``' counters, ``hits``, the secret scanner's
    ``secret`` stats and the ``missing`` layer count. Raises
    ``ImageLoadError`` when the image cannot be loaded, and a
    ``GuardError`` (a ``ValueError``) when a layer trips a guard.
    Raises before any host work when ``cuda`` has no card,
    ``scanner`` runs on another backend, or a check or the Rekor
    lookup is still to be ported."""
    if backend == "cuda":
        resolve_device(backend)          # fail before the host work
    check_security_checks(security_checks)
    check_rekor()
    t = {} if timings is None else timings
    option = _artifact_option(backend, security_checks, secret_config,
                              scanner, skip_dirs, skip_files,
                              file_patterns, ingest_guards,
                              ingest_limits)
    budget = make_budget(option.ingest_limits,
                         enabled=option.ingest_guards, name=path)
    t0 = time.perf_counter()
    try:
        image = load_image(path, name=name or path, budget=budget)
    except (OSError, ValueError, TarError) as e:
        raise ImageLoadError(
            f"failed to load image {path!r}: {e}") from e
    t["load_s"] = time.perf_counter() - t0
    cache = MemoryCache() if cache is None else cache
    artifact = ImageArtifact(image, cache, option=option, budget=budget)
    t0 = time.perf_counter()
    ref = artifact.inspect()
    t["inspect_s"] = time.perf_counter() - t0
    if stats is not None:
        stats["missing"] = artifact.missing_layers
    _secret_timings(t, option, stats)
    options = ScanOptions(vuln_type=list(vuln_type),
                          security_checks=list(security_checks),
                          list_all_packages=list_all_packages,
                          scan_removed_packages=scan_removed_packages,
                          backend=backend)
    results, os_found = _scan(LocalScanner(cache, store), ref, options,
                              t, stats)
    meta = ref.image_metadata
    report = Report(
        artifact_name=ref.name, artifact_type="container_image",
        metadata=Metadata(os=os_found, image_id=meta.id,
                          diff_ids=meta.diff_ids,
                          repo_tags=meta.repo_tags,
                          repo_digests=meta.repo_digests,
                          image_config=meta.image_config),
        results=results)
    if budget is not None and budget.soft_faults:
        # survivable hostile input: the scan is reported degraded
        # with ingest-stage causes
        report.mark_degraded(
            [{"stage": "ingest", "kind": k, "message": m}
             for k, m in budget.soft_faults])
    return report


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
                     file_patterns=patterns,
                     cache=make_cache(args.cache_dir, args.no_cache))
    return _finish(args, report)


def _ingest_limits(args):
    """--max-decompressed-bytes/--max-files/--ingest-deadline-s →
    ResourceLimits (None = pure defaults; zero values keep each
    default; ref cli.py ``_ingest_limits``)."""
    overrides = {}
    if args.max_decompressed_bytes:
        overrides["max_decompressed_bytes"] = \
            args.max_decompressed_bytes
    if args.max_files:
        overrides["max_files"] = args.max_files
    if args.ingest_deadline_s:
        overrides["ingest_deadline_s"] = args.ingest_deadline_s
    if not overrides:
        return None
    return dataclasses.replace(DEFAULT_LIMITS, **overrides)


def _refuse_image(args) -> str:
    """The image options still to be ported, by ROADMAP item: each is
    refused before any host work."""
    if len(args.target) > 1:
        refused = _refuse_batch(args)
        if refused:
            return refused
    elif args.target and not args.input and \
            not os.path.exists(args.target[0]):
        return (f"{args.target[0]!r} is not an existing path: daemon, "
                "containerd and registry resolution are not ported yet "
                "(ROADMAP A.9)")
    for flag, value in (("--server", args.server),
                        ("--fault-spec", args.fault_spec)):
        if value:
            return f"{flag} is not ported yet (ROADMAP A.9)"
    if args.cache_backend != "fs":
        return (f"--cache-backend {args.cache_backend!r} is not ported "
                "yet (ROADMAP A.9); only 'fs' is")
    return ""


def _refuse_batch(args) -> str:
    """The fleet options still to be ported: the scheduler (the
    reference's default for several targets) and its tenancy, the
    multi-host pod."""
    if args.sched == "on":
        return ("several image targets with --sched on run through the "
                "continuous-batching scheduler, which is not ported yet "
                "(ROADMAP A.5); pass --sched off for the direct batch "
                "path")
    for flag, value in (("--tenant-config", args.tenant_config),
                        ("--tenant-budget", args.tenant_budget)):
        if value:
            return f"{flag} is not ported yet (ROADMAP A.5)"
    for flag, value in (("--coordinator", args.coordinator),
                        ("--num-processes", args.num_processes),
                        ("--process-id", args.process_id >= 0)):
        if value:
            return (f"{flag}: the multi-host pod is not ported yet "
                    "(ROADMAP A.6)")
    return ""


def _run_image(args) -> int:
    if len(args.target) > 1 and args.input:
        # silently dropping --input next to a target list would scan
        # a different fleet than the user asked for
        print("error: --input cannot be combined with multiple "
              "image targets; list the archive as a target "
              "instead", file=sys.stderr)
        return 2
    refused = _refuse_image(args)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 1
    if len(args.target) > 1:
        return _run_image_batch(args)
    target = args.target[0] if args.target else ""
    path = args.input or target
    if not path:
        print("error: image target or --input required",
              file=sys.stderr)
        return 2
    if _refuse_early(args):
        return 1
    checks = _split(args.security_checks)
    check_security_checks(checks)
    try:
        patterns = _file_patterns(args.file_patterns)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    store = load_store(args.db_fixtures, args.compiled_db,
                       args.compile_db) if "vuln" in checks else None
    try:
        report = scan_image(
            path, store, args.backend, security_checks=checks,
            vuln_type=_split(args.vuln_type),
            list_all_packages=_list_all(args),
            scan_removed_packages=args.removed_pkgs,
            secret_config=args.secret_config,
            skip_dirs=_split(args.skip_dirs),
            skip_files=_split(args.skip_files), file_patterns=patterns,
            ingest_guards=not args.no_ingest_guards,
            ingest_limits=_ingest_limits(args),
            cache=make_cache(args.cache_dir, args.no_cache),
            name=target or path)
    except ValueError as e:
        # a load failure, or a guard trip while walking the layers
        # (ref cli.py ``main``: the typed trips are ValueErrors)
        print(f"error: {e}", file=sys.stderr)
        return 1
    for c in report.failure_causes:
        print(f"warning: {report.artifact_name}: degraded "
              f"({c.stage}/{c.kind}): {c.message}", file=sys.stderr)
    return _finish(args, report)


def _run_image_batch(args) -> int:
    """``image a.tar b.tar ...`` on the direct path (ref cli.py
    ``_run_image_batch`` with ``--sched off``): one
    ``BatchScanRunner.scan_paths`` over every target, then
    ``_finish_many``."""
    if args.format not in ("table", "json", "template"):
        # per-slot writers would concatenate complete documents into
        # one stream — invalid SBOM output; refuse up front (the
        # template writer is refused below, ROADMAP A.9)
        print(f"error: multi-image scans support table/json/"
              f"template output, not {args.format}", file=sys.stderr)
        return 2
    if _refuse_early(args):
        return 1
    checks = _split(args.security_checks)
    check_security_checks(checks)
    check_rekor()
    try:
        patterns = _file_patterns(args.file_patterns)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    store = load_store(args.db_fixtures, args.compiled_db,
                       args.compile_db) if "vuln" in checks else None
    opt = _artifact_option(args.backend, checks, args.secret_config,
                           None, _split(args.skip_dirs),
                           _split(args.skip_files), patterns,
                           not args.no_ingest_guards,
                           _ingest_limits(args))
    runner = BatchScanRunner(
        store=store, cache=make_cache(args.cache_dir, args.no_cache),
        backend=args.backend, secret_scanner=opt.secret_scanner,
        artifact_option=opt, dispatch_depth=args.dispatch_depth)
    options = ScanOptions(vuln_type=_split(args.vuln_type),
                          security_checks=checks,
                          list_all_packages=_list_all(args),
                          scan_removed_packages=args.removed_pkgs,
                          backend=args.backend)
    results = runner.scan_paths(args.target, options)
    if args.sched_stats:
        print(json.dumps(runner.last_stats, indent=2), file=sys.stderr)
    return _finish_many(args, results)


def _finish_many(args, results) -> int:
    """Render one report per batch slot (ref cli.py ``_finish_many``):
    ``json`` emits a single array, other formats append to the same
    stream. A failed slot reports on stderr and exits 1; a degraded
    slot warns and keeps its exit code."""
    try:
        policy = load_ignore_policy(args.ignore_policy)
    except (OSError, IgnorePolicyError) as e:
        print(f"error: ignore policy failed: {e}", file=sys.stderr)
        return 1
    ignored = load_ignore_file(args.ignorefile)
    severities = _severities(args.severity)
    code = 0
    docs = []
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for res in results:
            if res.error:
                print(f"error: {res.name}: {res.error}",
                      file=sys.stderr)
                code = max(code, 1)
                continue
            if res.status == "degraded":
                causes = "; ".join(f"{c.stage}/{c.kind}"
                                   for c in res.causes)
                print(f"warning: {res.name}: degraded ({causes})",
                      file=sys.stderr)
            report = res.report
            try:
                report.results = filter_results(
                    report.results, severities,
                    ignore_unfixed=args.ignore_unfixed,
                    ignored_ids=ignored, policy=policy)
            except IgnorePolicyError as e:
                print(f"error: ignore policy failed: {e}",
                      file=sys.stderr)
                return 1
            if args.format == "json":
                buf = io.StringIO()
                write_report(report, fmt="json", output=buf,
                             severities=[str(s) for s in severities],
                             app_version=__version__)
                docs.append(json.loads(buf.getvalue()))
            else:
                write_report(report, fmt=args.format, output=out,
                             severities=[str(s) for s in severities],
                             app_version=__version__,
                             dependency_tree=args.dependency_tree)
            if args.exit_code and \
                    any(r.failed() for r in report.results):
                code = args.exit_code
        if args.format == "json":
            json.dump(docs, out, indent=2)
            out.write("\n")
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if args.output:
            out.close()
    return code


def _scan_flags(sp) -> None:
    """The reference's ``scan_flags`` that the port reads."""
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
                    help="keep blobs in memory, even with --cache-dir "
                    "(sbom always does)")


def _tree_flags(sp) -> None:
    """The flags of the scans that walk files (``fs``, ``image``)."""
    sp.add_argument("--security-checks", default="vuln,secret")
    sp.add_argument("--skip-dirs", default="")
    sp.add_argument("--skip-files", default="")
    sp.add_argument("--file-patterns", action="append",
                    default=[], metavar="TYPE:REGEX",
                    help="force files matching REGEX through the "
                    "TYPE analyzer, e.g. pip:deps.txt; repeatable")
    sp.add_argument("--secret-config", default="trivy-secret.yaml")
    sp.add_argument("--cache-dir", default="",
                    help="keep analyzed blobs on disk under "
                    "DIR/fanal (default: in memory, for this run "
                    "only); not shared with the JAX package")


def _image_flags(sp) -> None:
    """``image``'s own flags (ref cli.py ``build_parser``)."""
    sp.add_argument("target", nargs="*", default=[])
    sp.add_argument("--input", default="",
                    help="image tarball path (docker save / OCI)")
    sp.add_argument("--removed-pkgs", action="store_true",
                    help="also scan packages installed and later "
                    "removed in the Dockerfile (reconstructed from RUN "
                    "history; alpine only, needs "
                    "TRIVY_APK_INDEX_ARCHIVE_URL)")
    sp.add_argument("--no-memo", action="store_true",
                    help="accepted: the findings memo is not ported "
                    "yet, every scan runs without it")
    sp.add_argument("--no-ingest-guards", action="store_true",
                    help="disable the ingest resource budgets and "
                    "safe-tar checks (unsafe on untrusted images)")
    sp.add_argument("--max-decompressed-bytes", type=int, default=0,
                    help="ingest guard: per-target decompressed-byte "
                    "budget (default 1 GiB)")
    sp.add_argument("--max-files", type=int, default=0,
                    help="ingest guard: per-target archive entry "
                    "budget (default 100000)")
    sp.add_argument("--ingest-deadline-s", type=float, default=0.0,
                    help="ingest guard: per-target wall-clock "
                    "deadline for image load + layer walking "
                    "(default 300s)")
    sp.add_argument("--sched", default="on", choices=["on", "off"],
                    help="several targets: off = the direct batch "
                    "path; on (the default, the continuous-batching "
                    "scheduler) is not ported yet and is refused")
    sp.add_argument("--sched-stats", action="store_true",
                    help="several targets: dump the batch's phase "
                    "timings and dispatch counters to stderr")
    sp.add_argument("--dispatch-depth", type=int, default=0,
                    help="several targets: interval waves in flight "
                    "(2 uploads wave N+1 while N computes, 1 restores "
                    "the synchronous ladder; 0 = "
                    "TRIVY_TPU_DISPATCH_DEPTH or 2)")
    # refused by name (ROADMAP A.5, A.6)
    sp.add_argument("--tenant-config", default="",
                    help=argparse.SUPPRESS)
    sp.add_argument("--tenant-budget", default="",
                    help=argparse.SUPPRESS)
    sp.add_argument("--coordinator", default="", help=argparse.SUPPRESS)
    sp.add_argument("--num-processes", type=int, default=0,
                    help=argparse.SUPPRESS)
    sp.add_argument("--process-id", type=int, default=-1,
                    help=argparse.SUPPRESS)
    # refused by name (ROADMAP A.9)
    sp.add_argument("--server", default="", help=argparse.SUPPRESS)
    sp.add_argument("--fault-spec", default="", help=argparse.SUPPRESS)
    sp.add_argument("--cache-backend", default="fs",
                    help=argparse.SUPPRESS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trivy_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    img = sub.add_parser("image", help="scan a container image "
                         "(docker-save or OCI tarball, OCI layout "
                         "directory) for vulnerabilities and secrets")
    _image_flags(img)
    _scan_flags(img)
    _tree_flags(img)
    for name, aliases, what in (
            ("fs", ["filesystem"], "a directory tree"),
            ("rootfs", [], "an unpacked root filesystem")):
        fs = sub.add_parser(name, aliases=aliases,
                            help=f"scan {what} for vulnerabilities "
                            "and secrets")
        fs.add_argument("target")
        _scan_flags(fs)
        _tree_flags(fs)

    sb = sub.add_parser("sbom", help="scan an SBOM document "
                        "(CycloneDX/SPDX) for vulnerabilities")
    sb.add_argument("target")
    _scan_flags(sb)
    args = ap.parse_args(argv)
    if args.command == "image":
        return _run_image(args)
    if args.command == "sbom":
        return _run_sbom(args)
    return _run_fs(args)
