"""Command line: ``python -m trivy_tpu_torch image X.tar``,
``python -m trivy_tpu_torch fs|rootfs DIR`` and
``python -m trivy_tpu_torch sbom BOM``.

``image`` scans a container image (the reference's ``trivy image``,
by default for vulnerabilities and secrets): a docker-save tar, an OCI
layout tar or an OCI layout directory (``--input`` takes only these),
or a reference that the daemon, containerd or a registry resolves
(``artifact/resolve.py``; a registry's image is pulled whole first),
is loaded under a per-target ingest budget, ``ImageArtifact`` walks every
layer its cache keys miss (whiteouts, opaque dirs, the guards) through
the analyzers and scans the secret candidates of every missing,
non-base layer in one batched sieve, then ``LocalScanner`` prepares
the advisory pair jobs, one ``dispatch_jobs`` runs the interval match,
and the results are finished, filtered and written.

``image a.tar b.tar ...`` scans a fleet (``runtime/batch.py``). By
default (``--sched on``) every target is one request of the
continuous-batching scheduler (``sched/``): loaded, analyzed and
joined on its host workers (``--sched-workers``), coalesced into
device batches by volume or after ``--sched-flush-ms``, each batch
one sieve launch and its interval waves, collected on a dispatch ring
(``--dispatch-depth``), with tenancy and budgets from
``--tenant-config`` and ``--tenant-budget``. ``--sched off`` is the
direct path: every image's missing layers are walked, ONE sieve runs
over every secret candidate of every image, and the interval match
over every image's pairs runs in waves kept in flight by a dispatch
ring. ``json`` writes one array of reports, ``table`` one table after
another; a target that fails prints ``error: NAME: ...`` and the run
exits 1. ``--fault-spec`` (``faults/``) injects a seeded fault scenario
into the fleet: a cache outage under the circuit breaker, device
faults that the scheduler bisects and quarantines, corrupt layers,
stalls, a deadline storm, and the hostile ingest corpus appended to
the targets. Every single-target entry refuses it (exit 2).

``watch`` keeps a fleet scanned from registry push events
(``watch/``): Docker Distribution notifications on ``POST
/registry/notifications`` (``--listen``, refs resolved to tarballs
under ``--images-dir``) or a seeded synthetic source over the listed
tarballs, debounced per digest, each scan a request of the scheduler;
``--fault-spec event-storm`` pushes a seeded storm and drains. Its
HTTP plane, and the ``server``'s, also answers ``POST /k8s/admission``
(``--admission-policy``, ``--admission-fail``,
``--admission-deadline``).

``fs`` (alias ``filesystem``) and ``rootfs`` scan a directory tree
(the reference's ``trivy fs DIR``): ``LocalFSArtifact`` walks it
through the same analyzers into one blob and one batched sieve, then
the same prepare, dispatch and finish. ``config`` (alias ``conf``) is
``fs`` with the checks pinned to ``config``.

``--security-checks`` takes ``vuln``, ``secret``, ``config`` (the
misconfiguration policies over Dockerfiles, Kubernetes manifests,
Terraform, CloudFormation and Helm charts; ``--config-policy``,
``--helm-values``, ``--helm-set``, ``--trace``,
``--include-non-failures``) and ``license`` (license classification).

``repo URL|DIR`` clones a git repository (``--branch``, ``--tag``,
``--commit``; a plain directory is scanned where it is) and scans the
checkout as ``fs`` does. ``k8s DIR`` scans exported manifests
(``k8s/``): each object's manifest for misconfigurations, every
workload image found under ``--images-dir`` as one fleet on the card,
rendered as a summary, in full or as JSON, or mapped onto a compliance
spec (``--compliance nsa|FILE``, ``compliance.py``). ``aws`` evaluates
the built-in AWS checks over an exported account state (``cloud/``).
``soak`` runs a soak scenario against a routed fleet of CPU sim
replicas (``soak/``). ``module`` and ``plugin`` manage extension
modules (loaded before every scan entry) and subprocess plugins (an
unknown first word runs the plugin of that name); ``version`` (or no
subcommand) prints the version.

``sbom`` scans a CycloneDX (JSON, XML, in-toto attestation) or SPDX
(JSON, tag-value) document for vulnerabilities (the reference's
``trivy sbom BOM``): decode into one blob, the same prepare, dispatch
and finish.

All write ``table`` (the default), ``json`` or ``cyclonedx``, and run
on ``--backend cuda`` unless asked for ``cpu`` (the same torch code on
the CPU) or ``cpu-ref`` (numpy). Blobs go to an in-memory cache unless
``--cache-dir`` names a directory for the on-disk one (``--no-cache``
keeps them in memory all the same) or ``--cache-backend`` a Redis or
S3 one (behind a circuit breaker that degrades to memory). A scan
with the ``vuln`` check keeps its detection verdicts in the findings
memo (``memo/``) where an entry can be read again: under
``--cache-dir`` beside the blobs, on a Redis or S3 blob cache, where
``--memo-cache`` says, or in memory for a scheduled scan of several
images; ``--no-memo`` turns it off. Without
``--db-fixtures`` or ``--compiled-db``, ``--cache-dir`` names the
advisory DB that ``db update`` installed there.

``db build --from-fixtures|--from-boltdb -o PREFIX`` compiles an
advisory DB into the npz that ``--compiled-db`` loads; ``db update
--from-oci-layout L --cache-dir D [--compile]`` installs the trivy-db
archive of a local OCI layout under ``D/db`` (``db/lifecycle.py``).

Every flag's default comes from ``TRIVY_<FLAG>`` in the environment,
else from ``trivy.yaml`` in the working directory or the file
``--config`` names (``flag.py``); ``--timeout`` bounds the run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import time
from tarfile import TarError

# opt-in runtime lock-order witness (analysis/witness.py):
# TRIVY_TPU_LOCK_WITNESS=1 must install BEFORE the heavy submodule
# imports below construct the metric-singleton locks
# (DETECT/RING/SECRET_METRICS...), as the reference's CLI does —
# witness.py itself imports only the standard library
from .analysis.witness import maybe_install_from_env

maybe_install_from_env()

from . import __version__, resolve_device  # noqa: E402
from .artifact import (ArtifactOption, FSCache, ImageArtifact,
                       LocalFSArtifact, MemoryCache, SBOMArtifact,
                       load_image)
from .artifact.redis_cache import RedisCache, RedisError
from .artifact.resilient import ResilientCache
from .artifact.resolve import resolve_image
from .artifact.s3_cache import S3Cache, S3Error
from .db import AdvisoryStore, CompiledDB, load_fixtures
from .db.lifecycle import db_dir, needs_update
from .detect.batch import dispatch_jobs
from .guard import DEFAULT_LIMITS, make_budget
from .misconf import configure
from .report.writer import FORMATS, check_format, write_report
from .obs.cost import parse_budget_config
from .obs.trace import get_tracer
from .runtime import BatchScanRunner
from .runtime.ring import resolve_dispatch_depth
from .scan import LocalScanner, ScanTarget, filter_results
from .scan.filter import (IgnorePolicyError, load_ignore_file,
                          load_ignore_policy)
from .sched import SchedConfig, parse_tenant_config
from .types import Metadata, Report, ScanOptions, Severity

DEFAULT_SEVERITIES = "UNKNOWN,LOW,MEDIUM,HIGH,CRITICAL"
BACKENDS = ("cuda", "cpu", "cpu-ref")
# interchange formats carry the full package inventory (ref
# pkg/commands/artifact/run.go ListAllPkgs override)
_SBOM_FORMATS = ("cyclonedx", "spdx", "spdx-json", "github")


def _split(s: str) -> list:
    return [x for x in s.split(",") if x]


def load_store(db_fixtures: str = "", compiled_db: str = "",
               compile_db: bool = False, cache_dir: str = "",
               skip_db_update: bool = False):
    """The advisory source of a scan (ref cli.py ``_store``): a
    ``CompiledDB`` npz (``--compiled-db`` path prefix), else an
    ``AdvisoryStore`` from fixture YAMLs, else the DB that ``db
    update`` installed under ``cache_dir`` (its compiled tables when
    ``db update --compile`` made them, else its ``trivy.db``; a stale
    one warns on stderr unless ``skip_db_update``), compiled when
    asked. Raises ``ValueError`` where the installed DB's metadata
    forbids its use (a newer schema; ``skip_db_update`` on a first
    run or an old schema)."""
    if compiled_db:
        return CompiledDB.load(compiled_db)
    store = AdvisoryStore()
    if db_fixtures:
        load_fixtures(_split(db_fixtures), store)
    elif cache_dir:
        bolt = os.path.join(db_dir(cache_dir), "trivy.db")
        if os.path.exists(bolt):
            try:
                stale = needs_update(cache_dir, skip=skip_db_update)
            except ValueError as e:
                raise ValueError(f"advisory DB: {e}") from e
            if stale:
                print("warning: advisory DB is stale (past "
                      "NextUpdate); run 'db update' or pass "
                      "--skip-db-update to silence", file=sys.stderr)
            compiled = os.path.join(db_dir(cache_dir), "compiled")
            if os.path.exists(compiled + ".npz"):
                return CompiledDB.load(compiled)
            from .db.boltdb import load_trivy_db
            load_trivy_db(bolt, store)
    if compile_db:
        return CompiledDB.compile(store)
    return store


def _scan(scanner, ref, options: ScanOptions, t: dict,
          stats: dict) -> tuple:
    """prepare → one ``dispatch_jobs`` → finish (ref LocalScanner
    ``scan``), timing each step into ``t``; or, for a
    ``rpc.RemoteScanner``, one Scan RPC (``remote_s``)."""
    target = ScanTarget(name=ref.name, artifact_id=ref.id,
                        blob_ids=ref.blob_ids)
    t0 = time.perf_counter()
    if not isinstance(scanner, LocalScanner):
        out = scanner.scan(target, options)
        t["remote_s"] = time.perf_counter() - t0
        return out
    prepared = scanner.prepare(target, options)
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
              list_all_packages: bool = False, cache=None, memo=None,
              remote=None, timings: dict = None,
              stats: dict = None) -> Report:
    """Vulnerability-scan the SBOM at ``path`` against ``store`` and
    return the unfiltered report (ref cli.py ``run_sbom``).

    ``cache`` is the blob cache (``make_cache``; a new
    ``MemoryCache`` when None); ``memo`` a ``memo.FindingsMemo`` (or
    None). ``timings`` (optional) receives the seconds of each step:
    ``decode_s``, ``prepare_s`` (apply + name-join), ``dispatch_s``
    and ``finish_s`` (results, enrichment, post-scan hooks);
    ``stats`` receives ``dispatch_jobs``' ``device_s``, ``jobs_in``
    and ``jobs_unique``, and the number of ``hits``. Raises
    ``ValueError`` for a document that is not an SBOM.

    ``remote`` (an ``rpc.RemoteScanner``, with ``cache`` its
    ``RemoteCache``) scans on a server instead (``--server``): the
    blob goes to the server's cache and the server runs the prepare,
    the dispatch (on ``backend``) and the finish; ``store`` and
    ``memo`` are unused and ``timings`` gets ``remote_s``."""
    if backend == "cuda" and remote is None:
        resolve_device(backend)          # fail before the host work
    t = {} if timings is None else timings
    t0 = time.perf_counter()
    cache = MemoryCache() if cache is None else cache
    ref = SBOMArtifact(path, cache).inspect()
    t["decode_s"] = time.perf_counter() - t0
    options = ScanOptions(vuln_type=list(vuln_type),
                          security_checks=["vuln"],
                          list_all_packages=list_all_packages,
                          backend=backend)
    results, os_found = _scan(remote or LocalScanner(cache, store,
                                                     memo=memo),
                              ref, options, t, stats)
    return Report(artifact_name=path, artifact_type=ref.type,
                  metadata=Metadata(os=os_found), results=results,
                  cyclonedx=ref.cyclonedx)


def _local_card(backend: str, security_checks, remote) -> bool:
    """Does this scan run device work here on ``cuda``: the dispatch,
    unless a server runs it, and the secret sieve?"""
    return backend == "cuda" and (remote is None or
                                  "secret" in security_checks)


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


def make_cache(cache_dir: str = "", no_cache: bool = False,
               backend: str = "fs"):
    """The blob cache of a scan (ref cli.py ``_cache``): for
    ``backend`` ``fs``, the on-disk ``FSCache`` under ``cache_dir``,
    else (or with ``no_cache``) a ``MemoryCache``; for
    ``redis://host:port`` or ``s3://bucket/prefix?endpoint=...``, that
    remote cache behind a ``ResilientCache`` (a mid-scan outage
    degrades to a local fallback, counted in its ``breaker_stats``).
    Raises ``RedisError`` when Redis cannot be reached now, and
    ``ValueError`` for another backend."""
    if backend.startswith("redis://"):
        return ResilientCache(RedisCache(backend))
    if backend.startswith("s3://"):
        return ResilientCache(S3Cache(backend))
    if backend != "fs":
        raise ValueError(
            f"unsupported --cache-backend {backend!r} "
            "(use 'fs', redis://host:port, or "
            "s3://bucket/prefix?endpoint=...)")
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
    scans (process-global, as in the reference); the config
    collectors with the ``config`` check, the license analyzers with
    the ``license`` check."""
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
        scan_misconfig="config" in checks,
        scan_licenses="license" in checks,
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
            scanner=None, cache=None, memo=None, remote=None,
            timings: dict = None, stats: dict = None,
            artifact=LocalFSArtifact) -> Report:
    """Scan the directory tree under ``root`` and return the
    unfiltered report (ref cli.py ``run_fs``): ``LocalFSArtifact``
    inspect (walk, analyzers, one batched secret sieve) →
    ``LocalScanner`` prepare → one ``dispatch_jobs`` → finish.

    ``store`` is the advisory source (``load_store``); a scan without
    the ``vuln`` check needs none. ``scanner`` reuses a built
    ``BatchSecretScanner`` (``secret_scanner``) on the same
    ``backend``, whose rules then win over ``secret_config``.
    ``cache`` is the blob cache (``make_cache``; a new ``MemoryCache``
    when None); ``memo`` a ``memo.FindingsMemo`` (or None).
    ``timings`` receives the seconds of ``inspect_s`` and,
    inside it, ``secret_s`` (the batched secret scan) and
    ``walk_analyze_s`` (the rest), then ``prepare_s``, ``dispatch_s``
    and ``finish_s``; ``stats`` receives ``dispatch_jobs``' counters,
    ``hits`` and the secret scanner's ``secret`` stats. The ``config``
    check evaluates the misconfiguration policies that
    ``misconf.configure`` installed. ``remote`` (an
    ``rpc.RemoteScanner``, with ``cache`` its ``RemoteCache``) runs
    the detection on a server, as ``scan_sbom`` takes it; the walk
    and the secret sieve stay here. ``artifact(root, cache, option)``
    makes the artifact that is inspected (``scan_repo`` passes the
    git one). Raises before any host work when
    the sieve or the dispatch would run on ``cuda`` and there is no
    card, or ``scanner`` runs on another backend."""
    if _local_card(backend, security_checks, remote):
        resolve_device(backend)          # fail before the host work
    t = {} if timings is None else timings
    option = _artifact_option(backend, security_checks, secret_config,
                              scanner, skip_dirs, skip_files,
                              file_patterns)
    cache = MemoryCache() if cache is None else cache
    t0 = time.perf_counter()
    ref = artifact(root, cache, option).inspect()
    t["inspect_s"] = time.perf_counter() - t0
    _secret_timings(t, option, stats)
    options = ScanOptions(vuln_type=list(vuln_type),
                          security_checks=list(security_checks),
                          list_all_packages=list_all_packages,
                          backend=backend)
    results, os_found = _scan(remote or LocalScanner(cache, store,
                                                     memo=memo),
                              ref, options, t, stats)
    return Report(artifact_name=root, artifact_type="filesystem",
                  metadata=Metadata(os=os_found), results=results)


def scan_repo(url: str, store=None, backend: str = "cuda", *,
              branch: str = "", tag: str = "", commit: str = "",
              **kwargs) -> Report:
    """Scan a git repository and return the unfiltered report (ref
    cli.py ``run_repo``): ``artifact/remote.py::RemoteRepoArtifact``
    clones ``url`` (a plain directory is scanned where it is), then the
    ``fs`` path runs on the checkout (``scan_fs``, which takes
    ``kwargs``): one secret sieve, one ``dispatch_jobs``. The clone is
    removed afterwards. Raises ``artifact.remote.GitError`` when the
    clone or the checkout fails."""
    from .artifact.remote import RemoteRepoArtifact
    made = []

    def clone(root, cache, option):
        made.append(RemoteRepoArtifact(root, cache, option=option,
                                       branch=branch, tag=tag,
                                       commit=commit))
        return made[0]

    try:
        report = scan_fs(url, store, backend, artifact=clone, **kwargs)
    finally:
        for art in made:
            art.clean()
    report.artifact_type = "repository"
    return report


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
               ingest_limits=None, cache=None, memo=None, remote=None,
               name: str = "", resolve: bool = True, timings: dict = None,
               stats: dict = None) -> Report:
    """Scan the container image at ``path`` and return the unfiltered
    report (ref cli.py ``run_image``). ``path`` is a docker-save tar,
    an OCI layout tar or an OCI layout directory, or with ``resolve``
    any image reference ``artifact/resolve.py::resolve_image`` takes:
    the daemon's, containerd's, then a registry's
    (``host[:port]/repo[:tag][@digest]``, pulled whole).
    ``resolve=False`` loads ``path`` as a file and nothing else (the
    CLI's ``--input``). The image is loaded under a per-target ingest
    budget (none with ``ingest_guards=False``) →
    ``ImageArtifact`` inspect (the layers the cache misses: walk,
    analyzers, one batched secret sieve over every missing, non-base
    layer) → ``LocalScanner`` prepare → one ``dispatch_jobs`` →
    finish. A report whose budget noted soft faults is marked
    ``degraded`` with ``ingest`` causes.

    ``store``, ``scanner``, ``cache`` and ``memo`` are as ``scan_fs``
    takes them; ``name`` is the report's artifact name (``path`` when
    empty). ``timings`` receives ``load_s``, ``inspect_s`` with
    ``secret_s`` and ``walk_analyze_s`` inside it, ``prepare_s``,
    ``dispatch_s`` and ``finish_s``; ``stats`` receives
    ``dispatch_jobs``' counters, ``hits``, the secret scanner's
    ``secret`` stats and the ``missing`` layer count. Raises
    ``ImageLoadError`` when the image cannot be loaded, and a
    ``GuardError`` (a ``ValueError``) when a layer trips a guard.
    ``remote`` runs the detection on a server, as ``scan_fs`` takes
    it. Raises before any host work when the sieve or the dispatch
    would run on ``cuda`` and there is no card, or ``scanner`` runs on
    another backend."""
    if _local_card(backend, security_checks, remote):
        resolve_device(backend)          # fail before the host work
    t = {} if timings is None else timings
    option = _artifact_option(backend, security_checks, secret_config,
                              scanner, skip_dirs, skip_files,
                              file_patterns, ingest_guards,
                              ingest_limits)
    budget = make_budget(option.ingest_limits,
                         enabled=option.ingest_guards, name=path)
    t0 = time.perf_counter()
    load = resolve_image if resolve else load_image
    try:
        image = load(path, name=name or path, budget=budget)
    except (OSError, ValueError, TarError) as e:
        raise ImageLoadError(
            f"failed to load image {path!r}: {e}") from e
    t["load_s"] = time.perf_counter() - t0
    cache = MemoryCache() if cache is None else cache
    artifact = ImageArtifact(image, cache, option=option, budget=budget)
    t0 = time.perf_counter()
    try:
        ref = artifact.inspect()
    finally:
        # a pulled or exported image's layout or archive goes now
        getattr(image, "cleanup", lambda: None)()
    t["inspect_s"] = time.perf_counter() - t0
    if stats is not None:
        stats["missing"] = artifact.missing_layers
    _secret_timings(t, option, stats)
    options = ScanOptions(vuln_type=list(vuln_type),
                          security_checks=list(security_checks),
                          list_all_packages=list_all_packages,
                          scan_removed_packages=scan_removed_packages,
                          backend=backend)
    results, os_found = _scan(remote or LocalScanner(cache, store,
                                                     memo=memo),
                              ref, options, t, stats)
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
                  ignore_policy: str = "",
                  include_non_failures: bool = False) -> Report:
    """Severity, unfixed, ``.trivyignore`` (read from the current
    directory unless a path is given) and ignore-policy filters, in
    place (ref cli.py ``_finish``); misconfiguration checks that passed
    stay only with ``include_non_failures``. Emptied results stay."""
    report.results = filter_results(
        report.results, _severities(severity),
        ignore_unfixed=ignore_unfixed,
        ignored_ids=load_ignore_file(ignorefile),
        policy=load_ignore_policy(ignore_policy),
        include_non_failures=include_non_failures)
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
                      args.ignorefile, args.ignore_policy,
                      args.include_non_failures)
    except (OSError, IgnorePolicyError) as e:
        print(f"error: ignore policy failed: {e}", file=sys.stderr)
        return 1
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        write_report(report, fmt=args.format, output=out,
                     severities=[str(s) for s in
                                 _severities(args.severity)],
                     app_version=__version__,
                     output_template=args.template,
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


def _refuse_early(args, checks=("vuln",)) -> bool:
    """Refuse what cannot run before the DB load and the scan: an
    unknown format, and ``cuda`` without a card (which raises) where
    this process would use the card (``_local_card``)."""
    try:
        check_format(args.format)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return True
    if _local_card(args.backend, checks, args.server or None):
        resolve_device(args.backend)
    return False


def _memo(args, cache, option=None, scheduled: bool = False,
          injector=None):
    """The findings memo of a scan (ref cli.py ``_memo``): None under
    ``--no-memo`` or without the ``vuln`` check, else one on the blob
    cache's tier (``--memo-cache`` overrides it) whose hot-swap
    re-match runs on the scan's backend. Raises ``RedisError`` for a
    Redis memo store that cannot be reached.

    Unlike the reference, a memo in memory is built only for a
    ``scheduled`` run of several targets, where a request can read
    what an earlier one recorded: a single target, or the direct
    fleet, partitions every query before any verdict is recorded, so
    its memory memo would die with the process unread. The reports
    are the same either way. On a remote blob cache (``ResilientCache``
    over Redis or S3) the memo rides the same connection."""
    if args.no_memo:
        return None
    if "vuln" not in _split(getattr(args, "security_checks", "vuln")):
        return None
    if not (args.memo_cache or scheduled or
            isinstance(cache, (FSCache, ResilientCache))):
        return None
    from .memo import make_findings_memo
    return make_findings_memo(cache=cache, cache_dir=args.cache_dir,
                              uri=args.memo_cache,
                              artifact_option=option,
                              fault_injector=injector,
                              backend=args.backend)


def _rpc_error():
    from .rpc.client import RPCError
    return RPCError


def _rpc_options(args) -> dict:
    """The client options of ``--token``, ``--token-header`` and
    ``--custom-headers k=v,k=v``."""
    headers = {}
    for pair in (args.custom_headers or "").split(","):
        if "=" in pair:
            k, _, v = pair.partition("=")
            headers[k.strip()] = v.strip()
    return dict(token=args.auth_token, token_header=args.token_header,
                custom_headers=headers)


def _remote_scanner(args):
    """The ``RemoteScanner`` of ``--server`` (the reference's
    ``_scanner``), or None for a local scan."""
    if not args.server:
        return None
    from .rpc.client import RemoteScanner
    return RemoteScanner(args.server, **_rpc_options(args))


def _sources(args, checks, option=None, scheduled: bool = False,
             injector=None):
    """``(cache, memo, store)`` of a scan from the flags — the store
    only with the ``vuln`` check (ref cli.py:1895-1898) — or None after
    an ``error:`` line (a ``--cache-backend`` or ``--memo-cache`` that
    is malformed or cannot be reached, an installed DB that cannot be
    used). ``scheduled``: a run of several targets
    through the scheduler (``_memo``). An ``injector``
    (``faults.FaultInjector``) wraps the blob cache
    (``wrap_cache``) and reaches the memo. With ``--server`` it is
    ``(RemoteCache, None, None)``: blobs go to the server's cache and
    the server owns the DB and the memo (ref cli.py ``_cache``)."""
    if args.server:
        from .rpc.client import RemoteCache
        return RemoteCache(args.server, **_rpc_options(args)), None, None
    try:
        cache = make_cache(args.cache_dir, args.no_cache,
                           getattr(args, "cache_backend", "fs"))
        if injector is not None:
            cache = injector.wrap_cache(cache)
        memo = _memo(args, cache, option, scheduled, injector)
        store = load_store(args.db_fixtures, args.compiled_db,
                           args.compile_db, args.cache_dir,
                           args.skip_db_update) \
            if "vuln" in checks else None
    except (RedisError, S3Error, ValueError) as e:
        # a bad backend value or one that cannot be reached fails the
        # run cleanly, never with a traceback (ref cli.py ``main``)
        print(f"error: {e}", file=sys.stderr)
        return None
    return cache, memo, store


def _configure_misconf(args, checks) -> bool:
    """With the ``config`` check, install the misconfiguration engine's
    options from the flags (ref cli.py ``_artifact_option``:
    ``--config-policy``, ``--helm-values``, ``--helm-set``,
    ``--trace``); False after an ``error:`` line for a policy module
    that cannot be loaded."""
    if "config" not in checks:
        return True
    try:
        configure(policy_dirs=_split(args.config_policy),
                  helm_value_files=_split(args.helm_values),
                  helm_set_values=_split(args.helm_set),
                  trace=args.trace)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return False
    return True


def _fault_injector(args):
    """--fault-spec → ``faults.FaultInjector``, or None. A malformed
    spec raises ``ValueError`` (the callers print it and exit 1, as
    the reference's ``main`` does). Route faults drill the scan
    router (``route``); the fleet, ``server`` and ``watch`` take them
    and inject nothing at their own sites, as the reference's do."""
    spec = getattr(args, "fault_spec", "")
    if not spec:
        return None
    from .faults import FaultInjector, parse_fault_spec
    return FaultInjector(parse_fault_spec(spec))


def _reject_unwired_fault_spec(args) -> bool:
    """True (and the reference's ``error:`` line printed) when
    --fault-spec was given on an entry that has no injection sites — a
    clean run there would be false confidence, not a passed drill
    (docs/robustness.md)."""
    if getattr(args, "fault_spec", ""):
        print("error: --fault-spec is wired into multi-target "
              "image scans, the server, and the route command; "
              "this command would inject nothing", file=sys.stderr)
        return True
    return False


def _run_sbom(args) -> int:
    if _reject_unwired_fault_spec(args):
        return 2
    if not os.path.isfile(args.target):
        print(f"error: no such file: {args.target}", file=sys.stderr)
        return 1
    if _refuse_early(args):
        return 1
    sources = _sources(args, ["vuln"])
    if sources is None:
        return 1
    cache, memo, store = sources
    try:
        report = scan_sbom(args.target, store, args.backend,
                           vuln_type=_split(args.vuln_type),
                           list_all_packages=_list_all(args),
                           cache=cache, memo=memo,
                           remote=_remote_scanner(args))
    except (ValueError, _rpc_error()) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return _finish(args, report)


def _run_fs(args) -> int:
    """``fs``, ``rootfs``, ``config`` and ``repo`` (ref cli.py
    ``run_fs``, ``run_repo``): ``repo`` clones its target first
    (``scan_repo``) and ends a failed clone with its ``error:`` line."""
    from .artifact.remote import GitError
    if _reject_unwired_fault_spec(args):
        return 2
    repo = args.command == "repo"
    if not repo and not os.path.isdir(args.target):
        print(f"error: no such directory: {args.target}",
              file=sys.stderr)
        return 1
    checks = _split(args.security_checks)
    if _refuse_early(args, checks):
        return 1
    if not _configure_misconf(args, checks):
        return 1
    try:
        patterns = _file_patterns(args.file_patterns)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    opt = _artifact_option(args.backend, checks, args.secret_config,
                           None, _split(args.skip_dirs),
                           _split(args.skip_files), patterns)
    sources = _sources(args, checks, opt)
    if sources is None:
        return 1
    cache, memo, store = sources
    kwargs = dict(security_checks=checks,
                  vuln_type=_split(args.vuln_type),
                  list_all_packages=_list_all(args),
                  secret_config=args.secret_config,
                  skip_dirs=opt.skip_dirs, skip_files=opt.skip_files,
                  file_patterns=patterns, scanner=opt.secret_scanner,
                  cache=cache, memo=memo, remote=_remote_scanner(args))
    try:
        if repo:
            report = scan_repo(args.target, store, args.backend,
                               branch=args.branch, tag=args.tag,
                               commit=args.commit, **kwargs)
        else:
            report = scan_fs(args.target, store, args.backend, **kwargs)
    except (GitError, _rpc_error()) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
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


def _run_image(args) -> int:
    if len(args.target) > 1 and args.input:
        # silently dropping --input next to a target list would scan
        # a different fleet than the user asked for
        print("error: --input cannot be combined with multiple "
              "image targets; list the archive as a target "
              "instead", file=sys.stderr)
        return 2
    if len(args.target) > 1:
        return _run_image_batch(args)
    if _reject_unwired_fault_spec(args):
        return 2
    target = args.target[0] if args.target else ""
    path = args.input or target
    if not path:
        print("error: image target or --input required",
              file=sys.stderr)
        return 2
    checks = _split(args.security_checks)
    if _refuse_early(args, checks):
        return 1
    if not _configure_misconf(args, checks):
        return 1
    try:
        patterns = _file_patterns(args.file_patterns)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    opt = _artifact_option(args.backend, checks, args.secret_config,
                           None, _split(args.skip_dirs),
                           _split(args.skip_files), patterns,
                           not args.no_ingest_guards,
                           _ingest_limits(args))
    sources = _sources(args, checks, opt)
    if sources is None:
        return 1
    cache, memo, store = sources
    try:
        report = scan_image(
            path, store, args.backend, security_checks=checks,
            vuln_type=_split(args.vuln_type),
            list_all_packages=_list_all(args),
            scan_removed_packages=args.removed_pkgs,
            secret_config=args.secret_config,
            skip_dirs=opt.skip_dirs, skip_files=opt.skip_files,
            file_patterns=patterns, scanner=opt.secret_scanner,
            ingest_guards=opt.ingest_guards,
            ingest_limits=opt.ingest_limits, cache=cache, memo=memo,
            remote=_remote_scanner(args), name=target or path,
            # an explicit archive path must fail as a file error,
            # never fall through to daemon or registry resolution
            resolve=not args.input)
    except (ValueError, _rpc_error()) as e:
        # a load failure, or a guard trip while walking the layers
        # (ref cli.py ``main``: the typed trips are ValueErrors), or
        # the server's answer
        print(f"error: {e}", file=sys.stderr)
        return 1
    for c in report.failure_causes:
        print(f"warning: {report.artifact_name}: degraded "
              f"({c.stage}/{c.kind}): {c.message}", file=sys.stderr)
    return _finish(args, report)


def _sched_config(args):
    """The scheduler's knobs from the flags (ref cli.py
    ``_sched_config``); a malformed tenant table or budget raises
    ``ValueError``."""
    tenancy = None
    if getattr(args, "tenant_config", ""):
        # a typo'd tenant table must fail the run up front — a
        # malformed QoS config silently granting unlimited service
        # is exactly the overload hole tenancy exists to close
        tenancy = parse_tenant_config(args.tenant_config)
    budgets = None
    if getattr(args, "tenant_budget", ""):
        # same eager-validation contract: a typo'd budget silently
        # metering nothing would defeat the admission gate
        budgets = parse_budget_config(args.tenant_budget)
    return SchedConfig(
        max_queue=getattr(args, "sched_queue", 256),
        workers=getattr(args, "sched_workers", 4),
        flush_timeout_s=getattr(args, "sched_flush_ms", 50.0)
        / 1000.0,
        dispatch_depth=resolve_dispatch_depth(
            getattr(args, "dispatch_depth", 0) or 0),
        tenancy=tenancy,
        budgets=budgets)


def _init_multihost(args) -> int:
    """Join the pod when ``--coordinator``/``--num-processes``/
    ``--process-id`` or the ``TRIVY_TPU_*`` env describe one
    (``parallel/multihost.py``). Returns 0, or 2 on a malformed
    topology (ref cli.py ``_init_multihost``)."""
    from .parallel.multihost import initialize, topology_from_env
    try:
        topo = topology_from_env(coordinator=args.coordinator,
                                 num_processes=args.num_processes or 0,
                                 process_id=args.process_id)
        if topo.multi_host:
            # nccl only for a process that drives a card
            initialize(topo, device_type="cuda"
                       if args.backend == "cuda" else "cpu")
            print(f"multi-host: process {topo.process_id}/"
                  f"{topo.num_processes} joined via "
                  f"{topo.coordinator}", file=sys.stderr)
    except (ValueError, RuntimeError) as e:
        print(f"error: multi-host topology: {e}", file=sys.stderr)
        return 2
    return 0


def _run_image_batch(args) -> int:
    """``image a.tar b.tar ...`` (ref cli.py ``_run_image_batch``):
    one ``BatchScanRunner.scan_paths`` over every target, through the
    scheduler (``--sched on``, the default) or the direct path, then
    ``_finish_many``. ``--fault-spec`` injects its scenario: the blob
    cache behind ``wrap_cache``, the runner's and the scheduler's
    hooks, the seeded hostile corpus appended to the targets, and the
    ``deadline-storm`` deadline on every request."""
    if args.server:
        print("error: multi-image batch scan is local-only; scan "
              "one target at a time against --server",
              file=sys.stderr)
        return 2
    if args.format not in ("table", "json", "template"):
        # per-slot writers would concatenate complete documents into
        # one stream — invalid SARIF or SBOM output; refuse up front
        print(f"error: multi-image scans support table/json/"
              f"template output, not {args.format}", file=sys.stderr)
        return 2
    checks = _split(args.security_checks)
    if _refuse_early(args, checks):
        return 1
    if not _configure_misconf(args, checks):
        return 1
    try:
        patterns = _file_patterns(args.file_patterns)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    opt = _artifact_option(args.backend, checks, args.secret_config,
                           None, _split(args.skip_dirs),
                           _split(args.skip_files), patterns,
                           not args.no_ingest_guards,
                           _ingest_limits(args))
    try:
        injector = _fault_injector(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    sources = _sources(args, checks, opt, scheduled=args.sched == "on",
                       injector=injector)
    if sources is None:
        return 1
    cache, memo, store = sources
    targets = list(args.target)
    hostile_dir = ""
    if injector is not None and injector.spec.hostile:
        # hostile-ingest drill (docs/robustness.md): materialize the
        # seeded adversarial corpus and append it to the fleet — the
        # guard layer must quarantine each hostile slot per-target
        # while the listed targets complete untouched
        import tempfile
        from .faults.hostile import build_corpus
        hostile_dir = tempfile.mkdtemp(prefix="trivy-tpu-hostile-")
        try:
            extra = build_corpus(hostile_dir, seed=injector.spec.seed,
                                 only=list(injector.spec.hostile))
        except ValueError as e:
            import shutil
            shutil.rmtree(hostile_dir, ignore_errors=True)
            print(f"error: {e}", file=sys.stderr)
            return 1
        targets += [p for _, p in extra]
        print(f"fault-spec: added {len(extra)} hostile artifacts "
              f"to the fleet (seed={injector.spec.seed})",
              file=sys.stderr)
    try:
        sched_config = _sched_config(args)
    except ValueError as e:
        print(f"error: --tenant-config/--tenant-budget: {e}",
              file=sys.stderr)
        return 2
    rc = _init_multihost(args)
    if rc:
        return rc
    trace_out = _trace_out(args)
    runner = BatchScanRunner(
        store=store, cache=cache, backend=args.backend,
        secret_scanner=opt.secret_scanner, sched=args.sched,
        sched_config=sched_config, artifact_option=opt,
        fault_injector=injector,
        dispatch_depth=args.dispatch_depth, memo=memo)
    options = _scan_options(args, checks)
    if injector is not None and injector.spec.deadline_s > 0:
        # deadline-storm scenario: the spec carries the per-request
        # deadline, the harness applies it
        options.deadline_s = injector.spec.deadline_s
    try:
        results = runner.scan_paths(targets, options)
        stats = runner.last_stats
    finally:
        runner.close()
        if hostile_dir:
            import shutil
            shutil.rmtree(hostile_dir, ignore_errors=True)
    if args.sched_stats:
        dump = stats.get("sched", stats)
        if injector is not None:
            dump = dict(dump)
            dump["faults"] = injector.stats()
        print(json.dumps(dump, indent=2), file=sys.stderr)
    if trace_out:
        print(f"traces written to {trace_out} "
              f"({get_tracer().n_exported} total this process)",
              file=sys.stderr)
    return _finish_many(args, results)


def _scan_options(args, checks) -> ScanOptions:
    """The ``ScanOptions`` of a runner's requests from the flags."""
    return ScanOptions(vuln_type=_split(args.vuln_type),
                       security_checks=checks,
                       list_all_packages=_list_all(args),
                       scan_removed_packages=getattr(args, "removed_pkgs",
                                                     False),
                       backend=args.backend)


def _trace_out(args) -> str:
    """--trace-out: point the process tracer's exporter at the
    directory (created if missing); every completed request trace
    lands there as Perfetto-loadable trace-event JSON (ref cli.py
    ``_trace_out``: a scan of several images, where every target is a
    traced request; a single scan is not one and writes nothing)."""
    trace_out = getattr(args, "trace_out", "")
    if trace_out:
        os.makedirs(trace_out, exist_ok=True)
        get_tracer().export_dir = trace_out
    return trace_out


@contextlib.contextmanager
def _profiled(profile_dir: str, backend: str):
    """--profile-out / --profile-dir: a ``torch.profiler`` trace of
    the scan plus the host profiler's collapsed stacks
    (``obs/profiler.py::device_trace``). On ``cuda`` a profiler that
    cannot record CUDA activity raises ``DeviceTraceError`` before the
    scan starts; it never drops to a host-only profile."""
    if not profile_dir:
        yield
        return
    from .obs.profiler import device_trace
    with device_trace(profile_dir, backend=backend):
        try:
            yield
        finally:
            # the trace flushes even when the scan errors or times
            # out — exactly when it is most wanted
            print(f"profile trace written to {profile_dir}",
                  file=sys.stderr)


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
                    ignored_ids=ignored, policy=policy,
                    include_non_failures=args.include_non_failures)
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
                             output_template=args.template,
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


def _global_flags(sp) -> None:
    """The reference's global flags, on every scan subcommand."""
    sp.add_argument("--config", "-c", default="",
                    help="config file (default: trivy.yaml)")
    sp.add_argument("--quiet", "-q", action="store_true")
    sp.add_argument("--debug", "-d", action="store_true")
    sp.add_argument("--timeout", default="5m0s",
                    help="scan timeout (e.g. 5m0s)")
    sp.add_argument("--log-format", default="text",
                    choices=["text", "json"],
                    help="log line format; json lines carry "
                    "trace_id/request_id so logs correlate with traces")
    sp.add_argument("--generate-default-config", action="store_true",
                    help="write the resolved flag values to "
                    "trivy-default.yaml and exit (ref run.go:354)")


def _scan_flags(sp) -> None:
    """The reference's ``scan_flags`` that the port reads."""
    sp.add_argument("--format", "-f", default="table",
                    choices=FORMATS)
    sp.add_argument("--template", "-t", default="",
                    help="output template ('@path' or inline), used "
                    "with --format template")
    sp.add_argument("--output", "-o", default="")
    sp.add_argument("--severity", "-s", default=DEFAULT_SEVERITIES)
    sp.add_argument("--vuln-type", default="os,library")
    sp.add_argument("--ignore-unfixed", action="store_true")
    sp.add_argument("--ignorefile", default=".trivyignore")
    sp.add_argument("--ignore-policy", default="",
                    help="Python file defining ignore(finding); "
                    "executed with full interpreter rights")
    sp.add_argument("--include-non-failures", action="store_true",
                    help="include passed/excepted misconfig checks in "
                    "the results")
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
    sp.add_argument("--skip-db-update", action="store_true",
                    help="use the installed advisory DB even if its "
                    "metadata says it is stale (ref --skip-db-update)")
    sp.add_argument("--cache-dir", default="",
                    help="keep analyzed blobs and the findings memo on "
                    "disk under DIR (default: in memory, for this run "
                    "only) and, without --db-fixtures/--compiled-db, "
                    "scan against the advisory DB 'db update' "
                    "installed there")
    sp.add_argument("--no-cache", action="store_true",
                    help="keep blobs in memory, even with --cache-dir")
    sp.add_argument("--no-memo", action="store_true",
                    help="disable the findings memo: every layer's "
                    "detection re-dispatches even when the same "
                    "question was answered before")
    sp.add_argument("--memo-cache", default="",
                    help="findings-memo backend override: 'memory', a "
                    "directory, redis://host:port or "
                    "s3://bucket/prefix?endpoint=... — default rides "
                    "the blob cache's tier (--cache-backend); in "
                    "memory, only a scheduled scan of several images "
                    "keeps one")
    sp.add_argument("--config-policy", default="",
                    help="comma-separated directories of custom "
                    "misconfig policy modules (Python files defining "
                    "POLICIES, importing Policy and Cause from "
                    "trivy_tpu_torch.misconf.policies); executed with "
                    "full interpreter rights")
    sp.add_argument("--helm-values", default="",
                    help="comma-separated helm values files overriding "
                    "chart values.yaml")
    sp.add_argument("--helm-set", default="",
                    help="comma-separated helm key=value overrides "
                    "(--set analog)")
    sp.add_argument("--trace", action="store_true",
                    help="record misconfig evaluation traces in the "
                    "results: which attributes the HCL subset could "
                    "not evaluate, so 'no findings' is "
                    "distinguishable from 'couldn't evaluate'")
    sp.add_argument("--trace-out", default="",
                    help="write one Perfetto-loadable trace-event JSON "
                    "per request into this directory (multi-target "
                    "image scans)")
    sp.add_argument("--profile-dir", default="",
                    help="older spelling of --profile-out "
                    "(--profile-out wins when both are set)")
    sp.add_argument("--profile-out", default="",
                    help="write a torch.profiler trace of the scan "
                    "(torch_trace.json: CPU and CUDA activity on "
                    "--backend cuda, CPU activity otherwise) and the "
                    "host profiler's collapsed stacks "
                    "(host_profile.folded) for flamegraphs")
    sp.add_argument("--server", default="",
                    help="server URL for client/server mode (detection "
                    "runs on the server; no local DB)")
    sp.add_argument("--token", dest="auth_token", default="",
                    help="server auth token")
    sp.add_argument("--token-header", default="Trivy-Token")
    sp.add_argument("--custom-headers", default="",
                    help="comma-separated k=v headers sent to the "
                    "server")
    sp.add_argument("--cache-backend", default="fs",
                    help="layer cache backend: fs (--cache-dir, else "
                    "memory), redis://host:port or "
                    "s3://bucket/prefix?endpoint=...&region=... (a "
                    "remote cache degrades to memory while it is "
                    "down)")
    sp.add_argument("--fault-spec", default="",
                    help="inject deterministic faults "
                    "(docs/robustness.md): a scenario name "
                    "(cache-outage, poison-image, "
                    "device-transient, rpc-flaky, slow-host, "
                    "standard-outage, hostile-ingest ...) "
                    "optionally followed by :key=value "
                    "overrides, e.g. "
                    "poison-image:poison=img7.tar; several "
                    "targets of image, watch and the server "
                    "take it")
    _global_flags(sp)


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


def _image_flags(sp, target_nargs: str = "*") -> None:
    """``image``'s own flags (ref cli.py ``build_parser``)."""
    sp.add_argument("target", nargs=target_nargs,
                    default=[] if target_nargs == "*" else "")
    sp.add_argument("--input", default="",
                    help="image tarball path (docker save / OCI)")
    sp.add_argument("--removed-pkgs", action="store_true",
                    help="also scan packages installed and later "
                    "removed in the Dockerfile (reconstructed from RUN "
                    "history; alpine only, needs "
                    "TRIVY_APK_INDEX_ARCHIVE_URL)")
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
                    help="continuous-batching scheduler for "
                    "multi-image scans (docs/serving.md); off = the "
                    "direct single-batch path")
    sp.add_argument("--sched-stats", action="store_true",
                    help="dump scheduler metrics (queue depth, batch "
                    "occupancy, host/device overlap, latency "
                    "histograms) to stderr after the scan; with "
                    "--sched off, the batch's phase timings and "
                    "dispatch counters")
    _sched_flags(sp)
    sp.add_argument("--coordinator", default="",
                    help="multi-host pod: host:port of process 0 "
                    "(TRIVY_TPU_COORDINATOR); requires "
                    "--num-processes/--process-id")
    sp.add_argument("--num-processes", type=int, default=0,
                    help="multi-host pod: total scanner processes "
                    "(TRIVY_TPU_NUM_PROCESSES)")
    sp.add_argument("--process-id", type=int, default=-1,
                    help="multi-host pod: this process's id "
                    "(TRIVY_TPU_PROCESS_ID)")


def _sched_flags(sp) -> None:
    """The scheduler's knobs (``_sched_config``), on ``image`` and
    ``watch``."""
    sp.add_argument("--sched-flush-ms", type=float, default=50.0,
                    help="coalescer flush timeout in ms")
    sp.add_argument("--sched-queue", type=int, default=256,
                    help="admission queue bound (backpressure)")
    sp.add_argument("--sched-workers", type=int, default=4,
                    help="host worker pool size")
    sp.add_argument("--dispatch-depth", type=int, default=0,
                    help="device slots in flight (2 uploads batch N+1 "
                    "while N computes, 1 restores the synchronous "
                    "ladder; 0 = TRIVY_TPU_DISPATCH_DEPTH or 2)")
    sp.add_argument("--tenant-config", default="",
                    help="multi-tenant QoS table (docs/serving.md): a "
                    "JSON file path or an inline spec like "
                    "'alice:weight=4,rate=100;default:rate=50' — "
                    "per-tenant WFQ weights, max_queued/max_inflight "
                    "quotas, and token-bucket rate/burst limits "
                    "(429 + Retry-After)")
    sp.add_argument("--tenant-budget", default="",
                    help="per-tenant device-second budgets "
                    "(docs/observability.md 'Cost attribution & "
                    "goodput'): JSON file or inline "
                    "'alice:device_s=2.5,window_s=60,action=throttle;"
                    "bob:device_s=1' — a tenant over its windowed "
                    "spend is throttled (429 + Retry-After) or "
                    "deprioritized to the budget's priority floor")


def _admission_flags(sp) -> None:
    """K8s validating-admission webhook knobs (ref cli.py
    ``_admission_flags``; docs/serving.md 'Continuous scanning &
    admission control') — shared by the server and the watch command
    (both mount POST /k8s/admission)."""
    sp.add_argument("--admission-policy", default="deny:CRITICAL",
                    help="severity policy for POST /k8s/admission: "
                    "'deny:SEV[,SEV...]' denies pods whose images "
                    "carry findings at those severities; 'audit' "
                    "never denies (annotations only)")
    sp.add_argument("--admission-fail", default="open",
                    choices=["open", "closed", "408"],
                    help="stance when a verdict cannot resolve "
                    "inside the deadline: open = allow + annotate, "
                    "closed = deny, 408 = surface HTTP 408 and let "
                    "the webhook's K8s failurePolicy decide")
    sp.add_argument("--admission-deadline", type=float, default=10.0,
                    help="default verdict deadline in seconds "
                    "(the apiserver's ?timeout= overrides per "
                    "request)")


def _watch_flags(sp) -> None:
    """``watch``'s own flags (ref cli.py ``build_parser``)."""
    sp.add_argument("target", nargs="*", default=[],
                    help="image tarballs the synthetic source "
                    "draws push events from (webhook sources "
                    "resolve refs via --images-dir instead)")
    sp.add_argument("--watch-source", default="webhook",
                    help="event source: 'webhook' (serve "
                    "POST /registry/notifications on --listen) "
                    "or 'synthetic[:rate=5,n=64,seed=7]' "
                    "(seeded Poisson replay over the targets)")
    sp.add_argument("--listen", default="127.0.0.1:4956",
                    help="host:port for the HTTP plane "
                    "(notification webhook, /metrics, "
                    "/k8s/admission); synthetic runs skip it "
                    "with --listen ''")
    sp.add_argument("--images-dir", default="",
                    help="resolve pushed image refs to local "
                    "tarballs named <ref with /:@ as _>.tar "
                    "(the k8s --images-dir contract)")
    sp.add_argument("--debounce-ms", type=float, default=250.0,
                    help="per-digest debounce window: a tag "
                    "repushed in a burst scans once")
    sp.add_argument("--max-inflight", type=int, default=32,
                    help="in-flight watermark: stop pulling the "
                    "event source at this many outstanding scans")
    sp.add_argument("--checkpoint", default="",
                    help="cursor checkpoint file: a restarted "
                    "watch resumes after the last resolved event "
                    "instead of re-scanning the backlog")
    sp.add_argument("--watch-tenant", default="watch",
                    help="tenant identity watch submissions "
                    "carry (QoS/SLO scoping, docs/serving.md)")
    sp.add_argument("--watch-priority", type=int, default=0)
    sp.add_argument("--max-events", type=int, default=0,
                    help="stop after this many events "
                    "(0 = run until SIGTERM / source exhausted)")
    _admission_flags(sp)
    _sched_flags(sp)


def _server_flags(srv) -> None:
    """``server``'s flags (ref cli.py ``build_parser``), with the
    port's ``--backend``."""
    srv.add_argument("--listen", default="127.0.0.1:4954")
    srv.add_argument("--token", dest="auth_token", default="")
    srv.add_argument("--token-header", default="Trivy-Token")
    srv.add_argument("--cache-dir", default="",
                     help="keep pushed blobs and the findings memo on "
                     "disk under DIR (default: in memory)")
    srv.add_argument("--db-fixtures", default="")
    srv.add_argument("--compiled-db", default="",
                     help="compiled advisory DB path prefix; the "
                     "server hot-swaps when the file changes")
    srv.add_argument("--db-watch-interval", type=float, default=60.0)
    srv.add_argument("--no-memo", action="store_true",
                     help="disable the findings memo")
    srv.add_argument("--memo-cache", default="",
                     help="findings-memo backend override: 'memory', a "
                     "directory, redis:// or s3:// (default: under "
                     "--cache-dir, else in memory)")
    srv.add_argument("--impact-index", action="store_true",
                     help="maintain the inverted (package, CVE) -> "
                     "layers -> images findings index as a write-"
                     "through side effect of the memo tier, rebuild "
                     "it from the shared tier on boot, and serve "
                     "GET /impact?cve=; requires the memo")
    srv.add_argument("--backend", default="cuda", choices=BACKENDS,
                     help="where the scheduler's dispatch and the boot "
                     "warm-up run: cuda (default), cpu or cpu-ref; a "
                     "request runs on its body's backend")
    srv.add_argument("--sched", default="on", choices=["on", "off"],
                     help="coalesce concurrent Scan RPCs through the "
                     "continuous-batching scheduler; metrics at GET "
                     "/metrics")
    srv.add_argument("--sched-flush-ms", type=float, default=50.0)
    srv.add_argument("--sched-queue", type=int, default=256)
    srv.add_argument("--sched-workers", type=int, default=4)
    srv.add_argument("--dispatch-depth", type=int, default=0,
                     help="device slots in flight; 0 = "
                     "TRIVY_TPU_DISPATCH_DEPTH or 2")
    srv.add_argument("--coordinator", default="")
    srv.add_argument("--num-processes", type=int, default=0)
    srv.add_argument("--process-id", type=int, default=-1)
    srv.add_argument("--tenant-config", default="",
                     help="multi-tenant QoS table (as image's)")
    srv.add_argument("--tenant-budget", default="",
                     help="per-tenant device-second budgets (as "
                     "image's)")
    srv.add_argument("--sched-deadline", default="",
                     help="default per-request deadline (Go duration, "
                     "e.g. 30s; a request's body deadline_s overrides "
                     "it)")
    srv.add_argument("--drain-timeout", type=float, default=30.0,
                     help="SIGTERM graceful-drain bound in seconds "
                     "(in-flight scans finish, new work gets 503)")
    srv.add_argument("--trace-out", default="",
                     help="export every completed request trace as "
                     "Perfetto-loadable JSON into this directory "
                     "(traces are also served at GET /trace/<id>)")
    srv.add_argument("--slo-config", default="",
                     help="service-level objectives (burn-rate "
                     "verdicts at GET /slo)")
    srv.add_argument("--federate-peers", default="",
                     help="metrics/SLO federation: "
                     "'name=http://host:port,...' (or bare URLs); "
                     "this replica then serves the merged fleet "
                     "exposition at GET /metrics/federate and fleet "
                     "burn-rate verdicts under GET /slo 'fleet'")
    srv.add_argument("--federate-timeout", type=float, default=2.0,
                     help="per-peer snapshot-pull timeout in seconds; "
                     "a slow peer is marked stale, never awaited past "
                     "this")
    srv.add_argument("--federate-stale-after", type=float, default=60.0,
                     help="seconds after which a peer's last-good "
                     "snapshot stops counting as fresh (the peer is "
                     "exported with trivy_tpu_federate_peer_stale=1)")
    srv.add_argument("--replica-name", default="",
                     help="this replica's name: its ring identity and "
                     "its value of the federated 'replica' label "
                     "(default: the --listen address)")
    srv.add_argument("--compile-cache", default="",
                     help="build (or load) both kernels into DIR/kernels "
                     "and warm-launch them at boot, before the server "
                     "listens; a later boot on DIR builds nothing")
    srv.add_argument("--prewarm-members", default="",
                     help="comma-separated names of the replicas "
                     "already on the routing ring: before /healthz "
                     "reports ready this replica computes its post-"
                     "join key ranges, walks the shared memo tier "
                     "for them, and stages its resident tables on "
                     "--backend; requires the memo")
    srv.add_argument("--prewarm-deadline", type=float, default=5.0,
                     help="prewarm walk bound in seconds — past it the "
                     "replica joins cold instead of wedging the "
                     "scale-up")
    srv.add_argument("--profile-out", default="",
                     help="torch.profiler trace of the server's first "
                     "TRIVY_TPU_PROFILE_SECONDS (default 60) plus the "
                     "host profiler's collapsed stacks; the host "
                     "profiler is also served at GET "
                     "/debug/profile?seconds=N")
    srv.add_argument("--fault-spec", default="",
                     help="inject deterministic faults into the "
                     "server (docs/robustness.md): the RPC drop / 500 "
                     "/ lost-response decisions and the memo's")
    _admission_flags(srv)
    srv.add_argument("--images-dir", default="",
                     help="resolve admission-webhook image refs to "
                     "local tarballs named <ref with /:@ as _>.tar; "
                     "without it admission misses apply the fail "
                     "stance")
    # the global flags but --timeout (a server runs until stopped)
    srv.add_argument("--config", "-c", default="",
                     help="config file (default: trivy.yaml)")
    srv.add_argument("--quiet", "-q", action="store_true")
    srv.add_argument("--debug", "-d", action="store_true")
    srv.add_argument("--log-format", default="text",
                     choices=["text", "json"])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m trivy_tpu_torch")
    ap.add_argument("--version", action="version",
                    version=f"trivy-tpu {__version__}")
    # read by the config pre-pass (flag.py) wherever it stands; the
    # subcommands' own flags override the rest of a top-level flag
    ap.add_argument("--config", "-c", default="",
                    help="config file (default: trivy.yaml when "
                    "present); flags also bind TRIVY_* env vars")
    sub = ap.add_subparsers(dest="command")
    img = sub.add_parser("image", help="scan a container image "
                         "(docker-save or OCI tarball, OCI layout "
                         "directory) for vulnerabilities and secrets")
    _image_flags(img)
    _scan_flags(img)
    _tree_flags(img)
    cl = sub.add_parser("client", aliases=["c"],
                        help="DEPRECATED: image scan in client/server "
                        "mode (use 'image --server' instead)")
    cl.add_argument("--remote", default="http://localhost:4954",
                    help="server address (the deprecated spelling of "
                    "--server)")
    _image_flags(cl, target_nargs="?")
    _scan_flags(cl)
    _tree_flags(cl)
    for name, aliases, what in (
            ("fs", ["filesystem"], "a directory tree"),
            ("rootfs", [], "an unpacked root filesystem")):
        fs = sub.add_parser(name, aliases=aliases,
                            help=f"scan {what} for vulnerabilities "
                            "and secrets")
        fs.add_argument("target")
        _scan_flags(fs)
        _tree_flags(fs)
    repo = sub.add_parser("repo", help="scan a remote or local git "
                          "repository")
    repo.add_argument("target", help="repo URL or local path")
    repo.add_argument("--branch", default="")
    repo.add_argument("--tag", default="")
    repo.add_argument("--commit", default="")
    _scan_flags(repo)
    _tree_flags(repo)
    conf = sub.add_parser("config", aliases=["conf"],
                          help="scan the config files of a directory "
                          "tree for misconfigurations only")
    conf.add_argument("target")
    _scan_flags(conf)
    _tree_flags(conf)
    k8s = sub.add_parser(
        "k8s", help="scan kubernetes manifests/cluster state "
        "(misconfigs on workloads; image vulns via --images-dir)")
    k8s.add_argument("target",
                     help="manifest file or directory of exported "
                     "cluster manifests")
    k8s.add_argument("--report", default="summary",
                     choices=["summary", "all"])
    k8s.add_argument("--images-dir", default="",
                     help="directory of image tarballs named "
                     "<ref with /:@ as _>.tar")
    k8s.add_argument("--compliance", default="",
                     help="compliance spec: built-in name (nsa) or "
                     "a YAML spec file")
    _scan_flags(k8s)
    _tree_flags(k8s)
    aws = sub.add_parser(
        "aws", help="scan AWS account state (exported account-state "
        "JSON; live API walk is a seam)")
    aws.add_argument("--account-state", required=True,
                     help="exported account state JSON (the "
                     "account-state cache shape)")
    aws.add_argument("--service", default="",
                     help="comma-separated service filter "
                     "(s3,ec2,iam,cloudtrail)")
    _scan_flags(aws)
    _tree_flags(aws)

    sb = sub.add_parser("sbom", help="scan an SBOM document "
                        "(CycloneDX/SPDX) for vulnerabilities")
    sb.add_argument("target")
    _scan_flags(sb)

    db = sub.add_parser("db", help="advisory DB operations")
    dbsub = db.add_subparsers(dest="db_command")
    build = dbsub.add_parser(
        "build", help="compile fixtures or a trivy-db into persistent "
        "resident advisory tables")
    build.add_argument("--from-fixtures", default="",
                       help="comma-separated advisory fixture YAMLs")
    build.add_argument("--from-boltdb", default="",
                       help="trivy-db BoltDB file (the reference's "
                       "native advisory store format)")
    build.add_argument("--output", "-o", required=True,
                       help="output path prefix (.npz)")
    upd = dbsub.add_parser(
        "update", help="install an advisory DB distribution into "
        "the cache dir (ref pkg/db/db.go Download)")
    upd.add_argument("--from-oci-layout", default="", required=True,
                     help="local OCI image layout dir holding the "
                     "trivy-db layer (what a registry pull yields; "
                     "there is no network transport)")
    upd.add_argument("--cache-dir", required=True,
                     help="the cache dir to install into (DIR/db)")
    upd.add_argument("--compile", action="store_true",
                     help="also compile the installed DB into "
                     "resident tables at <cache>/db/compiled")
    _server_flags(sub.add_parser(
        "server", help="run in server mode (owns the blob cache, the "
        "advisory DB and the card's dispatch)"))
    watch = sub.add_parser(
        "watch", help="continuous scanning: subscribe to registry "
        "push events (Docker Registry v2 notification webhooks, or "
        "a seeded synthetic source) and keep the fleet scanned "
        "(docs/serving.md 'Continuous scanning & admission "
        "control')")
    _watch_flags(watch)
    _scan_flags(watch)
    _tree_flags(watch)
    _route_flags(sub.add_parser(
        "route", help="run the scan-router front: consistent-hash "
        "sharding over N server replicas with zero-loss failover and "
        "SLO-driven autoscaling (docs/serving.md)"))
    imp = sub.add_parser(
        "impact", help="ask a replica server or the router fleet "
        "front which layers and images a CVE affects "
        "(GET /impact?cve=)")
    imp.add_argument("--server", required=True,
                     help="server or router base URL")
    imp.add_argument("--cve", required=True)
    imp.add_argument("--token", dest="auth_token", default="")
    imp.add_argument("--token-header", default="Trivy-Token")
    # seconds, a float as the reference's; TRIVY_TIMEOUT reaches it
    # only when `impact` runs, so the scans keep their duration
    imp.add_argument("--timeout", type=float, default=5.0).env_local = True
    _soak_flags(sub.add_parser(
        "soak", help="run a registry-scale soak scenario against a "
        "routed CPU-sim fleet: seeded synthetic registry, scripted "
        "chaos on a compressed clock, fleet SLO + books + leak "
        "verdicts (docs/robustness.md 'Soak & chaos testing')"))
    plug = sub.add_parser("plugin", help="manage plugins")
    plugsub = plug.add_subparsers(dest="plugin_command")
    plugsub.add_parser("install", help="install from a local "
                       "directory or archive").add_argument("source")
    plugsub.add_parser("uninstall").add_argument("name")
    plugsub.add_parser("list")
    plugsub.add_parser("info").add_argument("name")
    prun = plugsub.add_parser("run")
    prun.add_argument("name")
    prun.add_argument("plugin_args", nargs=argparse.REMAINDER)
    mod = sub.add_parser("module", aliases=["m"],
                         help="manage extension modules (ref "
                         "app.go:693 NewModuleCommand)")
    modsub = mod.add_subparsers(dest="module_command")
    modsub.add_parser("install", aliases=["i"],
                      help="install a module from a local .py file or "
                      "a directory of them (the reference pulls from "
                      "an OCI repo; the registry fetch is the egress "
                      "seam)").add_argument("source")
    modsub.add_parser("uninstall", aliases=["u"]).add_argument("name")
    modsub.add_parser("list")
    sub.add_parser("version", help="print version")
    return ap


def _soak_flags(soak) -> None:
    """The ``soak`` subcommand's flags (ref cli.py ``soak``). The fleet
    is sim replicas on the host: it takes no ``--backend``."""
    soak.add_argument("--scenario", default="soak-smoke",
                      help="preset name (soak, soak-smoke) or a "
                      "JSON ScenarioSpec file")
    soak.add_argument("--replicas", type=int, default=3)
    soak.add_argument("--seed", type=int, default=0,
                      help="override the scenario seed (0 = keep)")
    soak.add_argument("--duration", type=float, default=0.0,
                      help="override virtual duration seconds")
    soak.add_argument("--compression", type=float, default=0.0,
                      help="override virtual-seconds-per-real-"
                      "second")
    soak.add_argument("--mode", default="inproc",
                      choices=["inproc", "subprocess"],
                      help="replica isolation: in-process sims or "
                      "one OS process each")
    soak.add_argument("--report", default="",
                      help="write the full JSON report here "
                      "(sort_keys; same-seed runs diff cleanly)")
    soak.add_argument("--epoch", type=float, default=0.5,
                      help="audit/verdict sampling period, real "
                      "seconds")
    soak.add_argument("--service-ms", type=float, default=3.0)


def _route_flags(rt) -> None:
    """The ``route`` subcommand's flags (ref cli.py ``route``). It
    serves no device itself: the replicas hold the cards, so it takes
    no ``--backend``."""
    rt.add_argument("--listen", default="127.0.0.1:4955")
    rt.add_argument("--replicas", default="",
                    help="backend replicas, "
                    "'name=http://host:port,...' (or bare URLs) — "
                    "same syntax as --federate-peers; may be empty "
                    "when --scaler brings the fleet up")
    rt.add_argument("--token", dest="auth_token", default="",
                    help="shared fleet token: required from "
                    "clients AND presented to replicas")
    rt.add_argument("--token-header", default="Trivy-Token")
    rt.add_argument("--vnodes", type=int, default=64,
                    help="virtual nodes per replica on the hash "
                    "ring")
    rt.add_argument("--capacity-factor", type=float, default=1.25,
                    help="bounded-load cap: a replica takes at "
                    "most ceil(cf * (inflight+1) / n) requests "
                    "before the hot digest spills to the next "
                    "ring owner")
    rt.add_argument("--probe-interval", type=float, default=1.0,
                    help="seconds between /healthz probes of each "
                    "replica (drain visibility, breaker recovery)")
    rt.add_argument("--upstream-timeout", type=float, default=300.0,
                    help="per-forward upstream timeout in seconds; "
                    "a timed-out replica is failed over with the "
                    "same idempotency key")
    rt.add_argument("--scaler", default="off",
                    choices=["off", "sim", "subprocess"],
                    help="SLO-driven autoscaler: 'subprocess' "
                    "spawns sim replicas as child processes "
                    "(python -m trivy_tpu_torch.router.sim); "
                    "production wires its own ReplicaController")
    rt.add_argument("--scaler-min", type=int, default=1)
    rt.add_argument("--scaler-max", type=int, default=8)
    rt.add_argument("--scaler-interval", type=float, default=2.0)
    rt.add_argument("--fault-spec", default="",
                    help="inject deterministic router faults "
                    "(replica-flaky response drops; "
                    "docs/robustness.md)")


def main(argv=None) -> int:
    """The command line (ref cli.py ``main``): the parser's defaults
    from ``TRIVY_<FLAG>`` and the config file, then the scan under
    ``--timeout``. A scan that runs past it ends with ``error: scan
    timeout of ... exceeded`` and exit 1; a malformed duration exits
    2. A first word that names no subcommand runs the installed
    plugin of that name (``plugin/``, app.go:96), if there is one."""
    from .flag import (ScanTimeout, apply_external_defaults,
                       parse_duration, scan_deadline)
    from .utils.log import set_format, set_level
    raw_argv = list(sys.argv[1:] if argv is None else argv)
    if raw_argv and not raw_argv[0].startswith("-") and \
            raw_argv[0] not in _KNOWN_COMMANDS:
        from .plugin import run_with_args
        code = run_with_args(raw_argv[0], raw_argv[1:])
        if code is not None:
            return code
    parser = build_parser()
    if raw_argv[:1] != ["plugin"]:
        # plugin argv (its REMAINDER passthrough included) is never
        # read for --config or rewritten by env defaults
        apply_external_defaults(parser, raw_argv)
    args = parser.parse_args(raw_argv)
    set_level(debug=getattr(args, "debug", False),
              quiet=getattr(args, "quiet", False))
    set_format(getattr(args, "log_format", "") or "text")
    timeout_s = 0.0
    if getattr(args, "timeout", ""):
        try:
            timeout_s = parse_duration(args.timeout)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    from .obs.profiler import DeviceTraceError
    # --profile-out supersedes --profile-dir; one trace, never two.
    # The server steps its own bounded window (run_server).
    profile_dir = "" if args.command == "server" else \
        getattr(args, "profile_out", "") or getattr(args, "profile_dir", "")
    try:
        with scan_deadline(timeout_s), \
                _profiled(profile_dir, getattr(args, "backend", "cpu")):
            return _dispatch(args)
    except DeviceTraceError as e:
        print(f"error: --profile-out: {e}", file=sys.stderr)
        return 1
    except ScanTimeout:
        print(f"error: scan timeout of {args.timeout} exceeded "
              "(raise with --timeout)", file=sys.stderr)
        return 1


_KNOWN_COMMANDS = ("image", "filesystem", "fs", "rootfs", "repo",
                   "sbom", "k8s", "aws", "db", "server", "route",
                   "watch", "plugin", "config", "conf", "module",
                   "m", "client", "c", "impact", "soak",
                   "version")

# the entries before which the installed modules load (ref cli.py
# ``_dispatch``)
_MODULE_ENTRIES = ("image", "filesystem", "fs", "rootfs", "repo", "sbom",
                   "k8s", "config", "conf", "client", "c")


def _dispatch(args) -> int:
    if args.command in (None, "version"):
        print(f"trivy-tpu {__version__}")
        return 0
    if args.command == "db":
        return _run_db(args)
    if args.command == "server":
        return run_server(args)
    if args.command == "route":
        return run_route(args)
    if args.command == "impact":
        return run_impact(args)
    if args.command == "soak":
        return run_soak_cmd(args)
    if args.command in ("module", "m"):
        return run_module(args)
    if args.command == "plugin":
        return run_plugin(args)
    if args.generate_default_config:
        return _generate_default_config(args)
    if args.command in _MODULE_ENTRIES:
        from .module import Manager
        Manager().load()
    if args.command == "aws":
        return run_aws(args)
    if args.command == "k8s":
        return run_k8s(args)
    if args.command in ("client", "c"):
        # deprecated alias for `image --server` (ref app.go:441-447:
        # --remote replaces --server; an explicit --server wins)
        print("WARN: 'client' is deprecated; use 'image --server' "
              "instead", file=sys.stderr)
        args.server = args.server or args.remote
        args.target = [args.target] if args.target else []
        return _run_image(args)
    if args.command == "image":
        return _run_image(args)
    if args.command == "watch":
        return run_watch(args)
    if args.command == "sbom":
        return _run_sbom(args)
    if args.command in ("config", "conf"):
        # the fs pipeline with the checks pinned to config (ref cli.py
        # ``_dispatch``, app.go:533)
        args.security_checks = "config"
        args.vuln_type = ""
    return _run_fs(args)


def run_impact(args) -> int:
    """``impact --server URL --cve ID`` (ref cli.py ``run_impact``): one
    HTTP query against a replica's slice. A partial answer
    (``complete: false``) still exits 0 — Federator semantics; the
    flag is the caller's signal."""
    import urllib.error
    from .impact.federate import fetch_impact
    try:
        out = fetch_impact(args.server, args.cve,
                           token=args.auth_token,
                           token_header=args.token_header,
                           timeout_s=args.timeout)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"error: impact query: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def run_soak_cmd(args) -> int:
    """``soak --scenario NAME|FILE`` (ref cli.py ``run_soak_cmd``): one
    scenario, one routed fleet of CPU sim replicas, one verdict. Exit
    0 iff books balance, designed trips trip exactly, and the leak
    audit passes; a scenario that cannot be loaded is an ``error:``
    line and exit 1, as the reference's ``main`` prints it."""
    from .soak import load_scenario, run_soak
    try:
        scenario = load_scenario(args.scenario, seed=args.seed,
                                 duration_s=args.duration,
                                 compression=args.compression)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    report = run_soak(scenario, replicas=args.replicas,
                      mode=args.mode, report_path=args.report,
                      epoch_s=args.epoch,
                      service_ms=args.service_ms)
    stable = report["stable"]
    trip = report["slo"]["trip"]
    print(f"scenario {stable['scenario']} seed {stable['seed']} "
          f"({stable['arrivals']} arrivals, "
          f"{stable['steps']} steps, "
          f"{report['wall']['duration_s']}s wall)")
    print(f"  books: lost={stable['lost']} "
          f"balanced={stable['books_balanced']}")
    print(f"  slo:   trips_exact={stable['trips_exact']} "
          f"dumps={trip['dumps']}")
    print(f"  leak:  audit_ok={stable['audit_ok']}")
    sustained = report["throughput"]["sustained"]
    if sustained["seconds"]:
        print(f"  ips:   {sustained['ips']} sustained over "
              f"{sustained['seconds']}s steady state")
    if args.report:
        print(f"  report: {args.report}")
    ok = (stable["books_balanced"] and stable["trips_exact"]
          and stable["audit_ok"])
    return 0 if ok else 1


def run_aws(args) -> int:
    """``aws --account-state FILE [--service s3,...]`` (ref cli.py
    ``run_aws``): the built-in AWS checks over an exported account
    state, on the host (no device work), written as every report is."""
    from .cloud import KNOWN_SERVICES, load_account_state, scan_account
    if _reject_unwired_fault_spec(args):
        return 2
    try:
        state = load_account_state(args.account_state)
    except (OSError, ValueError) as e:
        print(f"error: account state: {e}", file=sys.stderr)
        return 1
    services = [s.strip().lower()
                for s in args.service.split(",") if s.strip()]
    unknown = [s for s in services if s not in KNOWN_SERVICES]
    if unknown:
        print(f"error: unknown service(s) {', '.join(unknown)}; "
              f"choose from {', '.join(KNOWN_SERVICES)}",
              file=sys.stderr)
        return 2
    report = Report(artifact_name=args.account_state,
                    artifact_type="aws_account", metadata=Metadata(),
                    results=scan_account(state, services or None))
    return _finish(args, report)


def run_module(args) -> int:
    """``module install|uninstall|list`` (ref cli.py ``run_module``,
    app.go:693) over ``TRIVY_MODULE_DIR``."""
    from . import module as module_mod
    cmd = args.module_command
    if cmd in ("install", "i"):
        try:
            names = module_mod.install(args.source)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        for name in names:
            print(f"installed module {name}")
        return 0
    if cmd in ("uninstall", "u"):
        if not module_mod.uninstall(args.name):
            print(f"error: no such module: {args.name}",
                  file=sys.stderr)
            return 1
        print(f"uninstalled module {args.name}")
        return 0
    if cmd == "list":
        for stem, name, version in module_mod.list_installed():
            print(f"{stem}\t{name}\t{version}")
        return 0
    print("usage: trivy-tpu module {install,uninstall,list}",
          file=sys.stderr)
    return 2


def run_plugin(args) -> int:
    """``plugin install|uninstall|list|info|run`` (ref cli.py
    ``run_plugin``) over ``TRIVY_PLUGIN_DIR``; a plugin's exit code is
    the command's."""
    from . import plugin as plugin_mod
    cmd = args.plugin_command
    if cmd == "install":
        try:
            p = plugin_mod.install(args.source)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"installed plugin {p.name} {p.version}")
        return 0
    if cmd == "uninstall":
        if not plugin_mod.uninstall(args.name):
            print(f"error: no such plugin: {args.name}",
                  file=sys.stderr)
            return 1
        print(f"uninstalled plugin {args.name}")
        return 0
    if cmd == "list":
        for p in plugin_mod.load_all():
            print(f"{p.name}\t{p.version}\t{p.usage or p.description}")
        return 0
    if cmd == "info":
        p = plugin_mod.load(args.name)
        if p is None:
            print(f"error: no such plugin: {args.name}",
                  file=sys.stderr)
            return 1
        print(f"name: {p.name}\nversion: {p.version}\n"
              f"usage: {p.usage}\ndescription: {p.description}")
        return 0
    if cmd == "run":
        code = plugin_mod.run_with_args(args.name, args.plugin_args)
        if code is None:
            print(f"error: no such plugin: {args.name}",
                  file=sys.stderr)
            return 1
        return code
    print("error: unknown plugin subcommand", file=sys.stderr)
    return 2


def run_k8s(args) -> int:
    """``k8s MANIFESTS [--images-dir DIR] [--compliance nsa|FILE]`` (ref
    cli.py ``run_k8s``): ``k8s.ManifestClient`` enumerates the
    manifests, ``K8sScanner`` scans each object's manifest for
    misconfigurations and every workload image as one fleet
    (``BatchScanRunner.scan_paths``: one ``dfa_blockmask`` launch for
    the fleet's secret candidates and the interval match's waves, on
    ``--backend``), then the filters, and the summary, full or JSON
    report, or the compliance report of the unfiltered results."""
    import copy
    from .k8s import K8sScanner, ManifestClient
    from .k8s.report import k8s_failed, write_k8s_report
    if _reject_unwired_fault_spec(args):
        return 2
    if not os.path.exists(args.target):
        print(f"error: no such path: {args.target}", file=sys.stderr)
        return 1
    if args.compliance and args.format not in ("table", "json"):
        print(f"error: compliance reports support table/json, not "
              f"{args.format}", file=sys.stderr)
        return 2
    checks = [c for c in args.security_checks.split(",") if c]
    if args.backend == "cuda" and ("vuln" in checks or "secret" in checks):
        resolve_device(args.backend)     # the images' scan needs the card
    try:
        store = load_store(args.db_fixtures, args.compiled_db,
                           args.compile_db, args.cache_dir,
                           args.skip_db_update) \
            if "vuln" in checks else None
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    scanner = K8sScanner(store=store, backend=args.backend,
                         images_dir=args.images_dir,
                         security_checks=checks)
    report = scanner.scan(ManifestClient(args.target))
    compliance_results = [copy.deepcopy(res) for group in
                          (report.misconfigurations,
                           report.vulnerabilities)
                          for r in group for res in r.results] \
        if args.compliance else []
    try:
        policy = load_ignore_policy(args.ignore_policy)
        for res in report.vulnerabilities + report.misconfigurations:
            filter_results(
                res.results, _severities(args.severity),
                ignore_unfixed=args.ignore_unfixed,
                ignored_ids=load_ignore_file(args.ignorefile),
                policy=policy,
                include_non_failures=args.include_non_failures)
    except (OSError, IgnorePolicyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        if args.compliance:
            # compliance maps the RAW scan outcome — severity and
            # non-failure filtering must not blank out controls
            from .compliance import (build_report, load_spec,
                                     write_compliance)
            try:
                spec = load_spec(args.compliance)
            except (OSError, ValueError) as e:
                print(f"error: compliance spec: {e}", file=sys.stderr)
                return 1
            write_compliance(build_report(spec, compliance_results),
                             fmt=args.format, output=out)
        else:
            write_k8s_report(report, fmt=args.format, mode=args.report,
                             output=out)
    finally:
        if args.output:
            out.close()
    if args.exit_code and k8s_failed(report):
        return args.exit_code
    return 0


def run_route(args) -> int:
    """``route`` (ref cli.py ``run_route``): the fleet front
    (docs/serving.md "Scan router & autoscaling") — consistent-hash
    sharding by layer digest across the --replicas set, /healthz
    probing, breaker ejection, zero-loss failover, optional SLO-driven
    autoscaling. SIGTERM shuts the listener and the prober (and the
    scaler) and exits 0. One departure: the sim replicas a ``--scaler
    subprocess`` started are stopped on the way out (the reference's
    outlive it)."""
    import signal
    import threading

    from .obs.federate import parse_peers
    from .router import (Autoscaler, HealthProber, RouterServer,
                         ScalerPolicy, ScanRouter,
                         SimReplicaController,
                         SubprocessReplicaController, serve_router)
    from .router.scaler import federated_verdicts

    host, _, port = args.listen.rpartition(":")
    if not port.isdigit():
        print(f"error: --listen needs host:port, got "
              f"{args.listen!r}", file=sys.stderr)
        return 2
    try:
        replicas = parse_peers(args.replicas) \
            if args.replicas else []
    except ValueError as e:
        print(f"error: --replicas: {e}", file=sys.stderr)
        return 2
    if not replicas and args.scaler == "off":
        print("error: --replicas is empty and --scaler off: "
              "nothing to route to", file=sys.stderr)
        return 2
    try:
        injector = _fault_injector(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if injector is not None and \
            not injector.spec.wants_route_faults():
        print("error: --fault-spec on the route command wants a "
              "router scenario (replica-flaky / replica-kill)",
              file=sys.stderr)
        return 2
    try:
        router = ScanRouter(
            replicas, token=args.auth_token,
            token_header=args.token_header,
            vnodes=args.vnodes,
            capacity_factor=args.capacity_factor,
            timeout_s=args.upstream_timeout,
            fault_injector=injector)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    prober = HealthProber(router, interval_s=args.probe_interval)
    prober.start()
    scaler = controller = None
    if args.scaler != "off":
        controller = SimReplicaController() \
            if args.scaler == "sim" \
            else SubprocessReplicaController()
        policy = ScalerPolicy(
            min_replicas=max(0, args.scaler_min),
            max_replicas=max(1, args.scaler_max),
            interval_s=args.scaler_interval)
        scaler = Autoscaler(
            router, controller, policy=policy,
            verdict_fn=federated_verdicts(
                router, token=args.auth_token))
        # bring the fleet to the floor before serving
        while len(router.replicas()) < policy.min_replicas:
            name, url = controller.start()
            router.add_replica(name, url)
        scaler.start()
    front = RouterServer(router, token=args.auth_token,
                         token_header=args.token_header,
                         prober=prober, scaler=scaler)
    httpd, _ = serve_router(front, host or "127.0.0.1", int(port))
    print(f"trivy-tpu router listening on {args.listen} "
          f"(fronting {len(router.replicas())} replicas)", flush=True)
    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass                    # not the main thread (tests)
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        front.close()
        if controller is not None:
            # the replicas this front's scaler started go with it
            live = getattr(controller, "procs", None)
            for name in sorted(controller.replicas if live is None
                               else live):
                controller.stop(name)
    return 0


def run_server(args) -> int:
    """``server`` (ref cli.py ``run_server``): the blob cache, the
    advisory store behind a ``SwappableStore`` (hot-swapped when the
    ``--compiled-db`` file changes), the findings memo and the
    scheduler on ``--backend`` (with a secret sieve, for the admission
    webhook's image scans), served over HTTP until SIGTERM, which
    drains (``rpc/server.py::serve_forever``). ``--fault-spec`` reaches
    the RPC handler and the memo; ``POST /k8s/admission`` answers
    from ``--admission-policy`` with images resolved under
    ``--images-dir``. ``--impact-index`` rebuilds the index from the
    memo tier at boot and serves ``GET /impact``; ``--prewarm-members``
    walks this replica's post-join slice of the tier before
    ``/healthz`` says ``ok``; ``--federate-peers`` serves ``GET
    /metrics/federate`` and the fleet verdicts under ``/slo``. ``cuda``
    without a card, and a kernel that does not build at
    ``--compile-cache``, fail the boot."""
    from .rpc.server import ScanServer, serve_forever
    host, _, port = args.listen.rpartition(":")
    if not port.isdigit():
        print(f"error: --listen needs host:port, got {args.listen!r}",
              file=sys.stderr)
        return 2
    try:
        injector = _fault_injector(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        _admission_policy(args)
    except ValueError as e:
        print(f"error: --admission-policy: {e}", file=sys.stderr)
        return 2
    from .obs.federate import Federator, parse_peers
    try:
        peers = parse_peers(args.federate_peers)
    except ValueError as e:
        print(f"error: --federate-peers: {e}", file=sys.stderr)
        return 2
    prewarm_members = [m.strip() for m in args.prewarm_members.split(",")
                       if m.strip()]
    for flag, wanted in (("--impact-index", args.impact_index),
                         ("--prewarm-members", prewarm_members)):
        if wanted and args.no_memo:
            print(f"error: {flag} needs the findings memo (drop "
                  "--no-memo)", file=sys.stderr)
            return 2
    if args.backend == "cuda":
        resolve_device(args.backend)     # no card: fail the boot
    t0 = time.perf_counter()
    try:
        store = load_store(args.db_fixtures, args.compiled_db)
    except (OSError, ValueError) as e:
        # a missing compiled DB is fine — the watch worker swaps it
        # in when `db build` produces it
        if not args.compiled_db:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"advisory db not loadable yet ({e}); waiting for "
              f"{args.compiled_db}.npz", file=sys.stderr)
        store = AdvisoryStore()
    db_load_s = time.perf_counter() - t0
    _trace_out(args)
    slos = None
    if args.slo_config:
        from .obs.slo import parse_slo_config
        try:
            slos = parse_slo_config(args.slo_config)
        except ValueError as e:
            print(f"error: --slo-config: {e}", file=sys.stderr)
            return 2
    rc = _init_multihost(args)
    if rc:
        return rc
    scheduler = None
    if args.sched == "on":
        try:
            cfg = _sched_config(args)
        except ValueError as e:
            print(f"error: --tenant-config/--tenant-budget: {e}",
                  file=sys.stderr)
            return 2
        if args.sched_deadline:
            from .flag import parse_duration
            try:
                cfg.default_deadline_s = parse_duration(
                    args.sched_deadline)
            except ValueError as e:
                print(f"error: --sched-deadline: {e}", file=sys.stderr)
                return 2
        if slos is not None:
            cfg.slos = slos
        # the scheduler carries a secret sieve: blob-only RPC scans
        # never need one, the admission webhook's image scans do
        from .sched import ScanScheduler
        from .secret.batch import BatchSecretScanner
        scheduler = ScanScheduler(
            config=cfg, backend=args.backend,
            secret_scanner=BatchSecretScanner(backend=args.backend))
    cache = make_cache(args.cache_dir)
    federator = Federator(
        peers, token=args.auth_token, token_header=args.token_header,
        timeout_s=args.federate_timeout,
        stale_after_s=args.federate_stale_after) if peers else None
    try:
        memo = None if args.no_memo else _server_memo(args, cache,
                                                      injector)
    except (RedisError, S3Error, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        if scheduler is not None:
            scheduler.close()
        return 1
    impact = None
    if args.impact_index:
        from .impact import ImpactIndex
        impact = ImpactIndex(store=memo.store,
                             name=args.replica_name or args.listen)
        # a restarted / rescheduled replica recovers its slice from
        # the shared memo tier before taking queries
        impact.rebuild(memo, store)
    from .obs.profiler import DeviceTraceError, device_trace
    window = float(os.environ.get("TRIVY_TPU_PROFILE_SECONDS", "60"))
    adm_runner = None
    try:
        with device_trace(args.profile_out, backend=args.backend,
                          max_seconds=window) as trace:
            t0 = time.perf_counter()
            server = ScanServer(
                store=store, cache=cache, token=args.auth_token,
                token_header=args.token_header,
                sched=scheduler if scheduler is not None else "off",
                slos=None if scheduler is not None else slos,
                memo=memo, replica_name=args.replica_name or args.listen,
                compile_cache_dir=args.compile_cache,
                backend=args.backend, federator=federator, impact=impact,
                prewarm_members=prewarm_members,
                prewarm_deadline_s=args.prewarm_deadline)
            server.fault_injector = injector
            server.admission, adm_runner = _admission_controller(
                args, server)
            if server.compile_cache:
                # the boot's split, one JSON line (the DB load, the
                # kernels' build and load, the warm launches, manifest
                # hits and misses)
                print("boot split: " + json.dumps(
                    dict(server.compile_cache,
                         db_load_s=round(db_load_s, 4),
                         boot_s=round(time.perf_counter() - t0, 4))),
                      file=sys.stderr, flush=True)
            print(f"trivy-tpu server listening on {args.listen}",
                  flush=True)
            try:
                serve_forever(host or "127.0.0.1", int(port), server,
                              db_watch_prefix=args.compiled_db,
                              db_watch_interval_s=args.db_watch_interval,
                              drain_timeout_s=args.drain_timeout,
                              on_tick=trace.step)
            finally:
                if adm_runner is not None:
                    adm_runner.close()
                if scheduler is not None:
                    scheduler.close()
    except DeviceTraceError as e:
        print(f"error: --profile-out: {e}", file=sys.stderr)
        return 1
    return 0


def _admission_policy(args):
    """The ``AdmissionPolicy`` of ``--admission-policy`` and
    ``--admission-fail``; ``ValueError`` for a malformed one."""
    from .watch import AdmissionPolicy
    return AdmissionPolicy.parse(args.admission_policy,
                                 fail=args.admission_fail)


def _admission_controller(args, server) -> tuple:
    """Mount POST /k8s/admission (ref cli.py ``_admission_controller``):
    an ``AdmissionController`` whose scans ride the server's scheduler
    (a runner with a scheduler of its own on a ``--sched off``
    server), store (hot-swap aware), cache and findings memo, on
    ``--backend``. Returns (controller, runner); the caller closes the
    runner."""
    from .watch import AdmissionController, dir_resolver
    resolver = dir_resolver(args.images_dir) if args.images_dir else None
    runner = BatchScanRunner(
        store=server.store, cache=server.cache, backend=args.backend,
        sched=(server.scheduler if server.scheduler is not None
               else "on"),
        # honored when this runner builds its own scheduler (the
        # --sched off server case); a shared scheduler already
        # carries the flag via _sched_config
        dispatch_depth=args.dispatch_depth, memo=server.memo)
    controller = AdmissionController(
        runner, store=server.store, memo=server.memo,
        policy=_admission_policy(args), resolver=resolver,
        default_deadline_s=args.admission_deadline)
    return controller, runner


def run_watch(args) -> int:
    """``watch`` (ref cli.py ``run_watch``): the event-driven
    continuous-scanning runtime (docs/serving.md "Continuous scanning &
    admission control") — an event source feeds the debounced watch
    loop, scans ride the continuous-batching scheduler on
    ``--backend`` with the watch tenant identity, and (when listening)
    the HTTP plane serves the registry-notification webhook,
    /metrics and /k8s/admission. ``--fault-spec event-storm`` pushes
    the seeded storm over the targets and drains. SIGTERM closes the
    loop, which drains; the ``{"watch": stats}`` line goes to
    stderr. ``cuda`` without a card raises before any scan."""
    import signal

    from .db.compiled import SwappableStore
    from .watch import (SyntheticSource, WatchConfig, WatchLoop,
                        WebhookSource, dir_resolver, make_event_storm)

    checks = _split(args.security_checks)
    if args.backend == "cuda":
        resolve_device(args.backend)     # no card: no scan at all
    try:
        injector = _fault_injector(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not _configure_misconf(args, checks):
        return 1
    try:
        patterns = _file_patterns(args.file_patterns)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    opt = _artifact_option(args.backend, checks, args.secret_config,
                           None, _split(args.skip_dirs),
                           _split(args.skip_files), patterns)
    sources = _sources(args, checks, opt, scheduled=True,
                       injector=injector)
    if sources is None:
        return 1
    cache, memo, store = sources
    holder = SwappableStore(store if store is not None
                            else AdvisoryStore())
    _trace_out(args)
    try:
        sched_config = _sched_config(args)
    except ValueError as e:
        print(f"error: --tenant-config/--tenant-budget: {e}",
              file=sys.stderr)
        return 2
    targets = list(args.target)
    resolver = dir_resolver(args.images_dir) if args.images_dir else None
    spec_text = (args.watch_source or "webhook").strip()
    kind, _, rest = spec_text.partition(":")
    if kind == "synthetic":
        if not targets:
            print("error: the synthetic source needs image-tarball "
                  "targets", file=sys.stderr)
            return 2
        kw = {"rate": 5.0, "n": 0, "seed": 20260804, "dup": 0.25}
        for pair in rest.split(","):
            pair = pair.strip()
            if not pair:
                continue
            k, eq, v = pair.partition("=")
            if not eq or k not in kw:
                print(f"error: bad --watch-source entry {pair!r}",
                      file=sys.stderr)
                return 2
            try:
                kw[k] = type(kw[k])(v)
            except (TypeError, ValueError):
                print(f"error: bad --watch-source value {v!r}",
                      file=sys.stderr)
                return 2
        source = SyntheticSource(
            targets, rate=kw["rate"], n_events=int(kw["n"]),
            seed=int(kw["seed"]), dup_rate=kw["dup"],
            tenant=args.watch_tenant, priority=args.watch_priority)
    elif kind == "webhook":
        source = WebhookSource(resolver=resolver,
                               tenant=args.watch_tenant,
                               priority=args.watch_priority)
    else:
        print(f"error: unknown --watch-source {spec_text!r} "
              "(want webhook or synthetic[:k=v,...])", file=sys.stderr)
        return 2
    if injector is not None and injector.spec.wants_event_storm() and \
            (not isinstance(source, WebhookSource) or not targets):
        print("error: event-storm needs the webhook source and "
              "image-tarball targets", file=sys.stderr)
        return 2
    host, _, port = args.listen.rpartition(":")
    if args.listen and not port.isdigit():
        print(f"error: --listen needs host:port, got {args.listen!r}",
              file=sys.stderr)
        return 2
    if args.listen:
        try:
            _admission_policy(args)
        except ValueError as e:
            print(f"error: --admission-policy: {e}", file=sys.stderr)
            return 2

    runner = BatchScanRunner(
        store=holder, cache=cache, backend=args.backend,
        secret_scanner=opt.secret_scanner, sched=sched_config,
        artifact_option=opt, fault_injector=injector, memo=memo)
    loop = WatchLoop(runner, source, WatchConfig(
        debounce_s=max(0.0, args.debounce_ms) / 1000.0,
        max_inflight=max(1, args.max_inflight),
        tenant=args.watch_tenant, priority=args.watch_priority,
        checkpoint_path=args.checkpoint),
        options=_scan_options(args, checks))
    httpd = worker = adm_runner = server = None
    try:
        if args.listen:
            from .rpc.server import ScanServer, serve
            server = ScanServer(store=holder, cache=cache,
                                token=args.auth_token,
                                token_header=args.token_header,
                                sched=runner.scheduler, memo=memo,
                                backend=args.backend)
            if isinstance(source, WebhookSource):
                server.watch_source = source
            server.admission, adm_runner = _admission_controller(
                args, server)
            httpd, worker = serve(host or "127.0.0.1", int(port), server,
                                  db_watch_prefix=args.compiled_db)
            print(f"trivy-tpu watch listening on {args.listen}",
                  file=sys.stderr, flush=True)
        elif memo is not None:
            # no HTTP plane attached the memo to the store's hot
            # swap: attach it here so a swap still re-matches
            from .db.lifecycle import attach_memo
            attach_memo(holder, memo)
        if injector is not None and injector.spec.wants_event_storm():
            storm = make_event_storm(injector.spec, targets)
            # storm repositories are the target tarballs' basenames —
            # resolve them back to the listed targets (falling through
            # to the --images-dir resolver for anything else), or every
            # storm event would shed unresolvable and the drill would
            # prove nothing about debounce/backpressure
            by_ref = {os.path.basename(p): p for p in targets}
            outer = source.resolver

            def storm_resolver(ref, digest="", _outer=outer):
                hit = by_ref.get(ref.split(":")[0])
                if hit is not None:
                    return hit
                return _outer(ref, digest) if _outer else None

            source.resolver = storm_resolver
            for body in storm:
                source.push_notification(body)
            print(f"fault-spec: pushed {len(storm)} storm "
                  f"notifications (seed={injector.spec.seed})",
                  file=sys.stderr)
            source.close()       # the storm IS the stream: drain + exit
        stop = []
        try:
            signal.signal(signal.SIGTERM,
                          lambda *_: (stop.append(1), loop.close()))
        except ValueError:
            pass                 # not the main thread (tests)
        try:
            while loop.step():
                if args.max_events and \
                        loop.counters["events"] >= args.max_events:
                    break
                if stop:
                    break
        except KeyboardInterrupt:
            pass
        stats = loop.drain()
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if worker is not None:
            worker.stop()
        if adm_runner is not None:
            adm_runner.close()
        if server is not None:
            server.close()
        runner.close()
    print(json.dumps({"watch": stats}, indent=2), file=sys.stderr)
    return 0


def _server_memo(args, cache, injector=None):
    """The server's findings memo: on the blob cache's tier
    (``--cache-dir``), where ``--memo-cache`` says, else in memory —
    every request of a server can read what an earlier one recorded
    (ref cli.py ``_memo``)."""
    from .memo import make_findings_memo
    return make_findings_memo(cache=cache, cache_dir=args.cache_dir,
                              uri=args.memo_cache or (
                                  "" if args.cache_dir else "memory"),
                              fault_injector=injector,
                              backend=args.backend)


def _generate_default_config(args) -> int:
    """--generate-default-config: dump the resolved flag values (CLI >
    env > config-file layering already applied) to trivy-default.yaml,
    refusing to overwrite — viper's SafeWriteConfigAs (ref
    run.go:354). Keys are the FLAG names, exactly what
    ``apply_external_defaults`` reads back, so the file round-trips
    through --config."""
    from .flag import import_yaml, walk_parsers
    out = "trivy-default.yaml"
    yaml = import_yaml(out)
    dest_to_flag = {}
    for p in walk_parsers(build_parser()):
        for action in p._actions:
            longs = [o for o in action.option_strings
                     if o.startswith("--")]
            if longs:
                dest_to_flag.setdefault(action.dest, longs[0][2:])
    skip = {"command", "target", "input", "generate_default_config",
            "help", "version", "config"}
    doc = {dest_to_flag[k]: v for k, v in vars(args).items()
           if k in dest_to_flag and k not in skip}
    try:
        with open(out, "x", encoding="utf-8") as f:
            yaml.safe_dump(doc, f, sort_keys=True,
                           default_flow_style=False)
    except FileExistsError:
        print(f"error: {out} already exists", file=sys.stderr)
        return 1
    print(f"wrote {out}")
    return 0


def _run_db(args) -> int:
    """``db build`` and ``db update`` (ref cli.py ``run_db``)."""
    if args.db_command == "update":
        return _run_db_update(args)
    if args.db_command != "build":
        print("error: unknown db subcommand", file=sys.stderr)
        return 2
    if not args.from_fixtures and not args.from_boltdb:
        print("error: --from-fixtures or --from-boltdb required",
              file=sys.stderr)
        return 2
    store = AdvisoryStore()
    if args.from_fixtures:
        load_fixtures(_split(args.from_fixtures), store)
    if args.from_boltdb:
        from .db.boltdb import CorruptDB, load_trivy_db
        t0 = time.perf_counter()
        try:
            _, n_adv, n_detail = load_trivy_db(args.from_boltdb, store)
        except (OSError, CorruptDB) as e:
            print(f"error: failed to read boltdb: {e}", file=sys.stderr)
            return 1
        print(f"ingested {n_adv} advisories + {n_detail} detail "
              f"records from {args.from_boltdb} "
              f"in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    cdb = CompiledDB.compile(store)
    compile_s = time.perf_counter() - t0
    cdb.save(args.output)
    print(f"compiled {cdb.stats['rows']} advisories "
          f"({cdb.stats['host_fallback_rows']} host-fallback, "
          f"{compile_s:.2f}s) -> {args.output}.npz")
    return 0


def _run_db_update(args) -> int:
    """``db update --from-oci-layout`` (ref pkg/db/db.go:146-184)."""
    from .db.boltdb import load_trivy_db
    from .db.lifecycle import update_from_oci_layout
    t0 = time.perf_counter()
    try:
        meta = update_from_oci_layout(args.from_oci_layout,
                                      args.cache_dir)
    except (OSError, ValueError) as e:
        print(f"error: db update: {e}", file=sys.stderr)
        return 1
    print(f"installed advisory DB schema v{meta.version} -> "
          f"{db_dir(args.cache_dir)} "
          f"in {time.perf_counter() - t0:.2f}s")
    if args.compile:
        store = AdvisoryStore()
        _, n_adv, _ = load_trivy_db(
            os.path.join(db_dir(args.cache_dir), "trivy.db"), store)
        cdb = CompiledDB.compile(store)
        out = os.path.join(db_dir(args.cache_dir), "compiled")
        cdb.save(out)
        print(f"compiled {n_adv} advisories -> {out}.npz")
    return 0
