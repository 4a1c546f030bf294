"""Memo key anatomy (copied from ``trivy_tpu/memo/keys.py``; the two
packages key alike, so a memo store written by either validates in
the other).

Every component that can change a layer's detection verdicts is in
the key or validated inside the entry:

* **context** (``context_sig``): advisory-DB content fingerprint,
  secret rule-set hash (``secret/batch.py::rules_fingerprint``),
  ingest-guard config hash, scanner/schema version — two configs can
  never share an entry;
* **layer** (``blob id``): the content-addressed blob key already
  folds layer digest × analyzer versions × walk options;
* **scan options** (``opts_sig``): the option fields that shape job
  construction (vuln types, removed-package merge);
* **per-package question** (inside the entry): the package's own
  signature plus the ordered advisory-content signature of its
  candidate rows — validated on every lookup, so a hit is only
  served when the exact detection question was answered before.

Advisory signatures are CONTENT-based (never row ids), so an entry
written under one compiled generation validates unchanged against the
next for every package the advisory delta did not touch.
"""

from __future__ import annotations

import hashlib
import json

MEMO_SCHEMA = 1


def cjson(obj) -> str:
    """Canonical JSON for hashing: sorted keys, no whitespace, and
    the compiled-DB datetime tagging for YAML-fixture values."""
    from ..db.compiled import _json_default
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=_json_default)


def _sha(payload: str, n: int = 24) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()[:n]


# ---- context components ------------------------------------------------

def db_fingerprint(store) -> str:
    """Content fingerprint of an advisory source — the "DB
    generation" key component, stable across processes (unlike the
    process-monotonic ``ResidentTables.generation``)."""
    from ..db.compiled import CompiledDB
    if store is None:
        return "none"
    if isinstance(store, CompiledDB):
        return store.content_fingerprint()
    # plain AdvisoryStore (fixtures): hash the raw bucket map, cached
    # per mutation count so repeated scans pay the walk once
    mutations = getattr(store, "mutations", None)
    cached = getattr(store, "_memo_fp", None)
    if cached is not None and mutations is not None and \
            cached[0] == mutations:
        return cached[1]
    try:
        fp = _sha(json.dumps(getattr(store, "buckets", {}),
                             sort_keys=True, default=str), 32)
    except (TypeError, ValueError):
        fp = _sha(repr(sorted(getattr(store, "buckets", {}))), 32)
    if mutations is not None:
        try:
            store._memo_fp = (mutations, fp)
        except AttributeError:
            pass
    return fp


def guard_fingerprint(artifact_option) -> str:
    """Ingest-guard config hash: enabled flag + resource limits. A
    guard trip changes which entries of a hostile layer survive the
    walk, so guarded and unguarded scans never share findings."""
    if artifact_option is None:
        return _sha(cjson(["guards", True, None]), 16)
    limits = getattr(artifact_option, "ingest_limits", None)
    return _sha(cjson(["guards",
                       bool(getattr(artifact_option,
                                    "ingest_guards", True)),
                       repr(limits) if limits is not None
                       else None]), 16)


def context_sig(db_fp: str, rules_fp: str, guard_fp: str,
                scanner_version: str) -> str:
    return _sha(cjson([MEMO_SCHEMA, db_fp, rules_fp, guard_fp,
                       scanner_version]))


def opts_sig(options) -> str:
    """The scan-option fields that shape vuln job construction."""
    return _sha(cjson([
        sorted(getattr(options, "vuln_type", []) or []),
        bool(getattr(options, "scan_removed_packages", False)),
    ]), 16)


def make_key(ctx: str, blob_id: str, opts: str) -> str:
    return _sha(cjson([ctx, blob_id, opts]), 40)


# ---- per-query signatures ----------------------------------------------

def adv_sig(cdb, row: int) -> str:
    """Content signature of one compiled advisory row, cached per
    CompiledDB instance (rows are read-only after compile)."""
    cache = getattr(cdb, "_memo_adv_sigs", None)
    if cache is None:
        cache = cdb._memo_adv_sigs = {}
    sig = cache.get(row)
    if sig is None:
        from ..db.compiled import _adv_enc
        bucket, pkg, adv = cdb.rows_meta[row]
        sig = _sha(cjson([bucket, pkg, _adv_enc(adv)]))
        cache[row] = sig
    return sig


def eval_sig(job) -> list:
    """Everything that determines one job's verdict, content-stable
    across compiled generations (advisory content, never row ids)."""
    from ..detect.batch import ResidentPairJob
    if isinstance(job, ResidentPairJob):
        return ["r", adv_sig(job.cdb, job.row), job.grammar,
                job.pkg_version, bool(job.report_unfixed)]
    return ["p", job.kind, job.grammar, job.pkg_version,
            list(job.vulnerable), list(job.patched),
            list(job.unaffected), job.fixed_version,
            job.affected_version, bool(job.report_unfixed)]


def advs_sig(jobs) -> str:
    """Ordered signature of a query's candidate-job list."""
    return _sha(cjson([eval_sig(j) for j in jobs]))


def pkg_record(pkg) -> dict:
    """Wire record of one package. ``types.convert``'s schema
    predates BuildInfo, and the Red Hat content-set gate needs it on
    both sides of the memo — every serialization (query signatures,
    stored sub-records) must go through this one graft."""
    d = pkg.to_dict()
    if pkg.build_info is not None:
        d["BuildInfo"] = pkg.build_info
    return d


def pkg_from_record(d: dict):
    """Inverse of :func:`pkg_record` (the delta re-match rebuilds
    driver-gating packages from stored sub-records)."""
    from ..types.convert import package_from_dict
    d = d or {}
    pkg = package_from_dict(d)
    if d.get("BuildInfo") is not None:
        pkg.build_info = d["BuildInfo"]
    return pkg


def query_sig(q) -> str:
    """Signature of the package side of one query: join identity,
    grammar, installed version, and the FULL package record — the
    payload a hit serves is rebuilt from the live package, so two
    packages may only share verdict indices, never identities."""
    pkg_d = pkg_record(q.pkg)
    return _sha(cjson([q.kind, q.bucket, q.name, q.grammar,
                       q.installed, bool(q.report_unfixed),
                       q.os_name, q.family, pkg_d]))


def entry_checksum(entry: dict) -> str:
    return _sha(cjson(entry), 32)


def verdict_sig(ctx: str, image: str, policy: str) -> str:
    """Admission-verdict cache key (``watch/admission.py``): the memo
    context signature folds the advisory generation (and rule-set /
    guard-config / scanner-version) in, so a ``db update`` hot swap
    strands cached admission verdicts exactly like findings entries —
    the new generation keys differently and recomputes."""
    return _sha(cjson(["admission", ctx, image, policy]), 40)
