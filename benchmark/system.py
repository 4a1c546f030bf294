"""The system under test: ``trivy_tpu_torch``, built as its CLI builds it.

Everything of the program that the harness touches goes through this
module: the advisory database (built once per checkout into an npz,
then loaded with ``CompiledDB.load`` as ``--compiled-db`` loads it),
the runners of the two entries (``image`` over several targets through
the scheduler, and the batch SBOM scan), and the JSON writer. The
runners are made from the CLI's own parser and helpers, so a run has
the defaults a user of the command gets.
"""

from __future__ import annotations

import os
import time

from .traffic import advisories


def db_prefix(cache_root: str, db: dict) -> str:
    """The npz path prefix of a configuration's database: one per
    (rows, seed), shared by the configurations that name the same."""
    return os.path.join(cache_root, "db",
                        f"advisories-{db['rows']}-{db['seed']}")


def build_db(prefix: str, db: dict) -> float:
    """Generate the advisory rows, compile them and save the npz.
    Returns the seconds it took."""
    from trivy_tpu_torch.db import AdvisoryStore, CompiledDB
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    store = AdvisoryStore()
    advisories.fill_store(store, advisories.plan(db["rows"], db["seed"]))
    CompiledDB.compile(store).save(prefix)
    return time.perf_counter() - t0


def build_db_apart(prefix: str, db: dict, root: str) -> float:
    """``build_db`` in a child process from the checkout's ``root``,
    waited for: the compile fills process-wide caches (the constraint
    intervals among them) that a process which only loads the npz
    finds empty, so the measuring process must not build. Returns the
    seconds it took."""
    import subprocess
    import sys
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "benchmark.system", prefix,
                    str(db["rows"]), str(db["seed"])], cwd=root,
                   check=True)
    return time.perf_counter() - t0


def cli_args(entry: str, cfg: dict, cache_dir: str, backend: str,
             npz_prefix: str, targets=("-",)):
    """The parsed command line of ``entry`` (``image`` or ``sbom``)
    with the configuration's ``flags``."""
    from trivy_tpu_torch.cli import build_parser
    argv = [entry, "--backend", backend, "--cache-dir", cache_dir,
            "--compiled-db", npz_prefix, "--format", "json"]
    argv += list(cfg.get("flags", []))
    return build_parser().parse_args(argv + list(targets))


def load_db(args):
    """The advisory source the command loads (``--compiled-db``)."""
    from trivy_tpu_torch.cli import load_store
    return load_store(compiled_db=args.compiled_db)


def image_runner(args, store, scanner=None) -> tuple:
    """(runner, scan options, secret scanner) of ``image`` over several
    targets, built as ``cli.py::_run_image_batch`` builds it: the
    artifact option, the blob cache under ``--cache-dir``, the memo a
    scheduled run gets, the scheduler's configuration from the flags.
    ``scanner``: a secret scanner to reuse (its table stays resident);
    a new one is built when None."""
    from trivy_tpu_torch import cli
    from trivy_tpu_torch.runtime import BatchScanRunner
    checks = cli._split(args.security_checks)
    opt = cli._artifact_option(args.backend, checks, args.secret_config,
                               scanner, cli._split(args.skip_dirs),
                               cli._split(args.skip_files),
                               cli._file_patterns(args.file_patterns),
                               not args.no_ingest_guards,
                               cli._ingest_limits(args))
    cache = cli.make_cache(args.cache_dir, args.no_cache,
                           getattr(args, "cache_backend", "fs"))
    memo = cli._memo(args, cache, opt, scheduled=args.sched == "on")
    runner = BatchScanRunner(
        store=store, cache=cache, backend=args.backend,
        secret_scanner=opt.secret_scanner, sched=args.sched,
        sched_config=cli._sched_config(args), artifact_option=opt,
        dispatch_depth=args.dispatch_depth, memo=memo)
    return runner, cli._scan_options(args, checks), opt.secret_scanner


def bom_runner(args, store) -> tuple:
    """(runner, scan options) of a batch SBOM service: one scheduled
    ``BatchScanRunner`` whose ``scan_boms`` every client calls, with
    the ``sbom`` command's checks and no memo."""
    from trivy_tpu_torch import cli
    from trivy_tpu_torch.artifact.cache import MemoryCache
    from trivy_tpu_torch.runtime import BatchScanRunner
    from trivy_tpu_torch.types import ScanOptions
    runner = BatchScanRunner(store=store, cache=MemoryCache(),
                             backend=args.backend, sched="on",
                             sched_config=cli._sched_config(args))
    # as cli.py::scan_sbom sets them
    options = ScanOptions(vuln_type=cli._split(args.vuln_type),
                          security_checks=["vuln"],
                          list_all_packages=cli._list_all(args),
                          backend=args.backend)
    return runner, options


def render(report) -> str:
    """``report`` as the command writes it with ``--format json``: the
    default filters, then the JSON writer."""
    import io
    from trivy_tpu_torch import __version__
    from trivy_tpu_torch.cli import filter_report
    from trivy_tpu_torch.report.writer import write_report
    filter_report(report)
    buf = io.StringIO()
    write_report(report, fmt="json", output=buf, app_version=__version__)
    return buf.getvalue()


if __name__ == "__main__":
    import sys
    build_db(sys.argv[1], {"rows": int(sys.argv[2]),
                           "seed": int(sys.argv[3])})
