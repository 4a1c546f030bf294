"""The findings memo (copied from ``trivy_tpu/memo/findings.py``):
per-layer detection-verdict memoization plus incremental delta
re-scan.

How a lookup stays byte-identical to a cold scan
------------------------------------------------

The memo never stores findings objects. At prepare time the scanner
has already built every job — (package, candidate advisory) pairs
whose payloads ARE the cold path's findings. The memo partitions the
job list by origin layer and, per package query, compares the exact
detection question (package signature + ordered advisory-content
signature) against the stored answer. On a hit it serves the LIVE
jobs' payloads at the stored verdict indices and drops those jobs
from the device dispatch; on a miss the jobs dispatch normally and
the verdict indices are stored afterwards. Served findings are
therefore this scan's own objects — exactly the ones the device
would have returned — so reports are byte-identical by construction,
and a validation mismatch (different image suffix, mutated layer
attribution, new advisory content) falls back to dispatch, never to
a stale answer.

Outages degrade to recompute (ResilientMemoStore); corrupt entries
fail the checksum on deserialize, are dropped, and the scan proceeds
cold. On a ``db update`` hot swap, ``hot_swap`` computes the advisory
delta between generations, migrates untouched entries to the new
context, and re-matches ONLY delta-touched packages against the new
generation's resident tables in one dispatch (``detect/rematch.py``)
on the memo's ``backend``: ``cuda`` unless the caller asked for
``cpu`` or ``cpu-ref``.

The lookup, the store and the hot swap's re-match record the
reference's ``memo_lookup``, ``memo_store`` and ``delta_rematch``
phase spans on the active span. ``attach_impact`` wires the
inverted impact index (``impact/index.py``): every entry store,
corrupt drop and hot-swap migration maintains it as a side effect,
and a swap's newly affected images go out as push events.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..obs.trace import phase_span
from . import keys as K
from .metrics import MEMO_METRICS
from .store import MemoryMemoStore, ResilientMemoStore

log = logging.getLogger("trivy_tpu_torch.memo")


@dataclass
class MemoQuery:
    """One package's candidate-advisory question, recorded by
    scan/local._vuln_jobs while it builds the job list. ``start`` /
    ``end`` index the contiguous job slice this query produced."""

    kind: str                  # "os" | "lib"
    bucket: str                # concrete bucket, or "eco::" prefix
    name: str                  # join name (src name / normalized)
    grammar: str
    installed: str
    report_unfixed: bool
    pkg: object                # live Package — payloads serve from it
    start: int
    end: int
    os_name: str = ""
    family: str = ""


@dataclass
class MemoPlan:
    """Partition result carried on PreparedScan between prepare and
    finish."""

    hits: list = field(default_factory=list)       # served payloads
    pending: dict = field(default_factory=dict)    # key -> pend rec
    owner: dict = field(default_factory=dict)      # id(payload) -> loc
    refs: list = field(default_factory=list)       # keep ids stable
    queries_hit: int = 0
    queries_miss: int = 0
    # the generation this partition keyed against — resolve derives
    # impact-index postings from stored entries under the SAME db
    db: object = None


class FindingsMemo:
    """One memo instance serves every scanner in a process; all
    methods are thread-safe (the store backends lock internally, the
    journal has its own lock, entries are read-modify-write with
    last-writer-wins — both writers hold identical answers).

    ``backend`` (and ``mesh``) is where the hot-swap re-match
    dispatch runs: ``cuda`` (the default), ``cpu`` or ``cpu-ref``."""

    def __init__(self, store=None, rules_fp: str = "",
                 guard_fp: str = "", scanner_version: str = "",
                 fault_injector=None, backend: str = "cuda",
                 mesh=None):
        if store is None:
            store = MemoryMemoStore()
        if not isinstance(store, ResilientMemoStore):
            store = ResilientMemoStore(store,
                                       fault_injector=fault_injector)
        elif fault_injector is not None and \
                store.fault_injector is None:
            store.fault_injector = fault_injector
        self.store = store
        self.rules_fp = rules_fp or "builtin"
        self.guard_fp = guard_fp or K.guard_fingerprint(None)
        if not scanner_version:
            from .. import __version__
            scanner_version = __version__
        self.scanner_version = scanner_version
        self.fault_injector = fault_injector
        self.backend = backend
        self.mesh = mesh
        self._lock = threading.Lock()
        self._journal: set = set()
        self._ctx_cache: dict = {}
        # optional inverted impact index (impact/index.py): memo
        # stores/evictions/migrations mirror into it write-through
        self.impact = None

    def attach_impact(self, index) -> None:
        """Wire an :class:`impact.index.ImpactIndex`: every entry
        store, corrupt drop, and hot-swap migration from here on
        maintains the inverted (package, CVE) → layers index as a
        side effect."""
        self.impact = index

    # ---- context ----

    def ctx_for(self, db) -> str:
        """Context signature bound to one advisory source. Cached per
        (store identity, mutation epoch) so concurrent scans against
        a hot-swapping holder each key against THEIR generation."""
        epoch = (id(db), getattr(db, "mutations",
                                 getattr(db, "generation", 0)))
        with self._lock:
            ctx = self._ctx_cache.get(epoch)
        if ctx is None:
            ctx = K.context_sig(K.db_fingerprint(db), self.rules_fp,
                                self.guard_fp, self.scanner_version)
            with self._lock:
                if len(self._ctx_cache) > 64:
                    self._ctx_cache.clear()
                self._ctx_cache[epoch] = ctx
        return ctx

    # ---- entry codec ----

    def _load(self, key: str):
        raw = self.store.get(key)
        if raw is None:
            return None
        inj = self.fault_injector
        if inj is not None:
            raw = inj.on_memo_load(key, raw)
        try:
            doc = json.loads(raw.decode("utf-8"))
            entry = doc["entry"]
            if doc.get("sum") != K.entry_checksum(entry):
                raise ValueError("memo checksum mismatch")
            if entry.get("v") != K.MEMO_SCHEMA:
                raise ValueError("memo schema mismatch")
        except (ValueError, KeyError, TypeError,
                UnicodeDecodeError) as e:
            # a corrupted or truncated entry is detected here,
            # dropped, and transparently recomputed — the scan
            # completes cold for this layer, never errors
            MEMO_METRICS.inc("corrupt")
            MEMO_METRICS.inc("invalidations")
            log.warning("dropping corrupt memo entry %s: %r",
                        key[:16], e)
            self.store.delete(key)
            if self.impact is not None:
                self.impact.drop_entry(key)
            return None
        with self._lock:
            self._journal.add(key)
        return entry

    def _store(self, key: str, entry: dict) -> None:
        doc = {"entry": entry, "sum": K.entry_checksum(entry)}
        data = json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()
        self.store.put(key, data)
        MEMO_METRICS.inc("stores")
        MEMO_METRICS.inc("bytes", len(data))
        with self._lock:
            self._journal.add(key)

    # ---- scan-time API (called from scan/local.LocalScanner) ----

    def partition(self, prepared, blobs: list, detail, options,
                  db) -> Optional[MemoPlan]:
        """Split the prepared job list into memo-hits (verdicts
        served from the store, jobs dropped from dispatch) and novel
        queries (dispatched, then recorded). Mutates
        ``prepared.jobs``; returns the plan ``resolve`` consumes, or
        None when nothing was memoizable."""
        queries = getattr(prepared, "queries", None)
        if not queries:
            return None
        target = prepared.target
        diff2blob = {}
        for blob, bid in zip(blobs, target.blob_ids):
            if blob is not None and getattr(blob, "diff_id", ""):
                diff2blob[blob.diff_id] = bid
        # single-blob targets (SBOM / fs): every query derives from
        # the one content-addressed blob, whatever origin layer its
        # packages claim — EXCEPT under --removed-pkgs, where
        # history packages ride the artifact record, not the blob
        single = None
        if len(target.blob_ids) == 1 and \
                not getattr(options, "scan_removed_packages", False):
            single = target.blob_ids[0]

        groups: dict = {}
        for q in queries:
            if q.end <= q.start:
                continue
            diff = getattr(q.pkg.layer, "diff_id", "") \
                if q.pkg.layer is not None else ""
            bid = diff2blob.get(diff) if diff else None
            if bid is None:
                bid = single
            if bid is None:
                continue         # residual: always dispatched
            groups.setdefault(bid, []).append(q)
        if not groups:
            return None

        ctx = self.ctx_for(db)
        opts = K.opts_sig(options)
        jobs = prepared.jobs
        plan = MemoPlan()
        plan.db = db
        drop: set = set()
        if self.impact is not None:
            # image → memoizable-layer edge for the inverted index
            # (tenant rides PreparedScan from the server's scope)
            self.impact.observe_image(
                getattr(target, "name", "")
                or getattr(target, "artifact_id", ""),
                sorted(groups),
                tenant=getattr(prepared, "tenant", ""))
        with phase_span("memo_lookup", layers=len(groups),
                        queries=len(queries)):
            for bid, qs in groups.items():
                key = K.make_key(ctx, bid, opts)
                entry = self._load(key)
                subs = entry.get("subs", {}) if entry else {}
                served_all = bool(qs)
                pend = None
                for q in qs:
                    q_jobs = jobs[q.start:q.end]
                    qsig = K.query_sig(q)
                    advs = K.advs_sig(q_jobs)
                    sub = subs.get(qsig)
                    if sub is not None \
                            and sub.get("advs") == advs \
                            and all(isinstance(i, int)
                                    and 0 <= i < len(q_jobs)
                                    for i in sub.get("hits", ())):
                        plan.hits.extend(q_jobs[i].payload
                                         for i in sub["hits"])
                        drop.update(range(q.start, q.end))
                        plan.queries_hit += 1
                        continue
                    served_all = False
                    plan.queries_miss += 1
                    if pend is None:
                        pend = plan.pending.setdefault(key, {
                            "ctx": ctx, "blob": bid, "opts": opts,
                            "base": entry, "subs": []})
                    pend["subs"].append((qsig, self._sub_record(q),
                                         advs, len(q_jobs)))
                    for li, j in enumerate(q_jobs):
                        plan.owner[id(j.payload)] = (key, qsig, li)
                        plan.refs.append(j)
                if served_all:
                    MEMO_METRICS.inc("layer_hits")
        MEMO_METRICS.inc("hits", plan.queries_hit)
        MEMO_METRICS.inc("misses", plan.queries_miss)
        if drop:
            prepared.jobs = [j for i, j in enumerate(jobs)
                             if i not in drop]
        if not plan.hits and not plan.pending:
            return None
        return plan

    def _sub_record(self, q: MemoQuery) -> dict:
        """The stored half of one query: everything the delta
        re-match needs to rebuild the job list under a future
        generation (detect/rematch.py)."""
        return {"kind": q.kind, "bucket": q.bucket, "name": q.name,
                "grammar": q.grammar, "installed": q.installed,
                "unfixed": bool(q.report_unfixed), "os": q.os_name,
                "family": q.family, "pkg": K.pkg_record(q.pkg)}

    def resolve(self, plan: MemoPlan, detected: list) -> list:
        """Finish-time hook: record each missed query's verdict
        indices from the dispatch results, then append the served
        hit payloads."""
        detected = list(detected)
        if plan.pending:
            hit_idx: dict = {}
            for p in detected:
                loc = plan.owner.get(id(p))
                if loc is not None:
                    hit_idx.setdefault(loc[:2], set()).add(loc[2])
            with phase_span("memo_store", entries=len(plan.pending)):
                for key, pend in plan.pending.items():
                    entry = pend["base"]
                    if entry is None:
                        entry = {"v": K.MEMO_SCHEMA,
                                 "ctx": pend["ctx"],
                                 "blob": pend["blob"],
                                 "opts": pend["opts"], "subs": {}}
                    for qsig, sub, advs, n_jobs in pend["subs"]:
                        sub = dict(sub)
                        sub["advs"] = advs
                        sub["hits"] = sorted(
                            hit_idx.get((key, qsig), ()))
                        sub["n"] = n_jobs
                        entry["subs"][qsig] = sub
                    self._store(key, entry)
                    if self.impact is not None and \
                            plan.db is not None:
                        from ..impact.index import entry_postings
                        self.impact.set_entry(
                            key, entry["blob"],
                            entry_postings(entry, plan.db))
        return detected + plan.hits

    # ---- db hot swap ----

    def hot_swap(self, old_db, new_db) -> dict:
        """Advisory-delta migration: re-key untouched entries to the
        new generation, re-match delta-touched packages against the
        new resident tables in ONE dispatch, update their verdicts in
        place. Any failure degrades to dropping the affected entries
        (recompute on next scan) — never an error.

        The returned stats carry, beside the reference's counters,
        ``split_s`` (the seconds of the delta, the re-match — job
        build and dispatch — and the store writes), the re-match
        dispatch's own ``dispatch`` counters (``device_s``,
        ``jobs_in``, ``jobs_unique``) and ``swap_failures``: 1, with
        the ``error``, when the migration failed (also counted in
        ``MEMO_METRICS``), else 0."""
        from ..db.compiled import CompiledDB
        MEMO_METRICS.inc("swaps")
        out = {"migrated": 0, "rematch_entries": 0,
               "rematch_jobs": 0, "dropped_subs": 0,
               "invalidated_subs": 0}
        if not isinstance(old_db, CompiledDB) or \
                not isinstance(new_db, CompiledDB):
            # no content-comparable generations: old entries simply
            # stop matching the new context and age out
            return out
        try:
            with phase_span("delta_rematch") as sp:
                out = self._hot_swap(old_db, new_db)
                delta_stats = out.get("delta") or {}
                sp.set("touched_keys",
                       delta_stats.get("touched_keys", 0))
                sp.set("rematch_entries", out["rematch_entries"])
                sp.set("rematch_jobs", out["rematch_jobs"])
        except Exception as e:      # noqa: BLE001 — a failed
            # migration must never break the swap; the store is
            # still correct (old-ctx entries are unreachable under
            # the new context). Counted, so a failed re-match on the
            # card is never silent.
            MEMO_METRICS.inc("swap_failures")
            out.update(swap_failures=1, error=repr(e))
            log.error("memo hot-swap migration failed on %s: %r",
                      self.backend, e)
        return out

    def _hot_swap(self, old_db, new_db) -> dict:
        from ..db.delta import advisory_delta
        from ..detect.batch import dispatch_jobs
        from ..detect.rematch import build_rematch_jobs

        t0 = time.perf_counter()
        delta = advisory_delta(old_db, new_db)
        MEMO_METRICS.inc("delta_touched", len(delta.touched))
        old_ctx = self.ctx_for(old_db)
        new_ctx = self.ctx_for(new_db)
        out = {"migrated": 0, "rematch_entries": 0,
               "rematch_jobs": 0, "dropped_subs": 0,
               "invalidated_subs": 0, "swap_failures": 0,
               "delta": delta.stats()}
        t_delta = time.perf_counter() - t0
        t_store = 0.0

        keys = self.store.keys()
        if keys is None:
            with self._lock:
                keys = sorted(self._journal)
        jobs: list = []
        updates: list = []          # (new_key, old_key, entry)
        t0 = time.perf_counter()
        for key in keys:
            if key.startswith("impact-"):
                # impact-index image records ride the same store
                # (impact.index.IMPACT_KEY_PREFIX) but are not memo
                # entries — _load would reject their envelope as
                # corrupt and DELETE them
                continue
            entry = self._load(key)
            if entry is None or entry.get("ctx") != old_ctx:
                continue
            new_key = K.make_key(new_ctx, entry["blob"],
                                 entry["opts"])
            entry["ctx"] = new_ctx
            touched = [qsig for qsig, sub in entry["subs"].items()
                       if delta.touches(sub.get("kind", ""),
                                        sub.get("bucket", ""),
                                        sub.get("name", ""))]
            if not touched:
                t1 = time.perf_counter()
                self._store(new_key, entry)
                if self.impact is not None:
                    # delta-untouched: same advisory content, same
                    # verdicts — postings carry over by rename
                    self.impact.rename_entry(key, new_key)
                self._drop_old(key, new_key)
                t_store += time.perf_counter() - t1
                out["migrated"] += 1
                continue
            ui = len(updates)
            for qsig in touched:
                sub = entry["subs"][qsig]
                sub_jobs, advs = build_rematch_jobs(
                    new_db, sub, (ui, qsig))
                if sub_jobs is None:
                    del entry["subs"][qsig]
                    out["dropped_subs"] += 1
                    continue
                sub["advs"] = advs
                sub["hits"] = []
                sub["n"] = len(sub_jobs)
                jobs.extend(sub_jobs)
                out["invalidated_subs"] += 1
            updates.append((new_key, key, entry))
        MEMO_METRICS.inc("invalidations", out["invalidated_subs"])

        dstats: dict = {}
        if jobs:
            detected = dispatch_jobs(jobs, backend=self.backend,
                                     mesh=self.mesh, stats=dstats)
            for ui, qsig, li in detected:
                updates[ui][2]["subs"][qsig]["hits"].append(li)
        t_rematch = time.perf_counter() - t0 - t_store
        t1 = time.perf_counter()
        new_blobs: set = set()
        for new_key, old_key, entry in updates:
            for sub in entry["subs"].values():
                sub["hits"] = sorted(sub.get("hits", []))
            self._store(new_key, entry)
            if self.impact is not None:
                from ..impact.index import entry_postings
                # rename first so the set_entry diff runs against
                # the old postings — only genuinely NEW (pkg, CVE)
                # pairs trigger the push stream
                self.impact.rename_entry(old_key, new_key)
                added = self.impact.set_entry(
                    new_key, entry["blob"],
                    entry_postings(entry, new_db))
                if added:
                    new_blobs.add(entry["blob"])
            self._drop_old(old_key, new_key)
        t_store += time.perf_counter() - t1
        out["rematch_entries"] = len(updates)
        out["rematch_jobs"] = len(jobs)
        out["dispatch"] = dstats
        out["split_s"] = {"delta": t_delta, "rematch": t_rematch,
                          "store": t_store}
        MEMO_METRICS.inc("rematch_jobs", len(jobs))
        MEMO_METRICS.inc("rematch_entries", len(updates))
        MEMO_METRICS.inc("migrated_entries", out["migrated"])
        MEMO_METRICS.inc("delta_rematched", out["invalidated_subs"])
        MEMO_METRICS.inc("delta_invalidated", out["dropped_subs"])
        if self.impact is not None and new_blobs:
            # each shard emits its newly-affected image set as
            # high-priority, tenant-scoped re-scans (impact/push.py)
            out["push_images"] = self.impact.emit_push(new_blobs)
        if updates or out["migrated"]:
            log.info("memo hot-swap: %d migrated, %d re-matched "
                     "entries (%d jobs), %d subs invalidated",
                     out["migrated"], len(updates), len(jobs),
                     out["invalidated_subs"])
        return out

    def _drop_old(self, old_key: str, new_key: str) -> None:
        """A migrated entry's old-generation key can never match
        again (its context signature is gone) — delete it so the
        store and every future swap's key walk stay bounded."""
        if old_key == new_key:
            return
        self.store.delete(old_key)
        if self.impact is not None:
            # no-op when the entry was renamed first — covers any
            # future caller that drops without migrating
            self.impact.drop_entry(old_key)
        with self._lock:
            self._journal.discard(old_key)

    def stats(self) -> dict:
        out = MEMO_METRICS.snapshot()
        out["backend"] = self.store.breaker_stats()
        return out


def make_findings_memo(cache=None, cache_dir: str = "",
                       uri: str = "", secret_scanner=None,
                       artifact_option=None, fault_injector=None,
                       backend: str = "cuda",
                       mesh=None) -> FindingsMemo:
    """CLI factory: the backend mirrors the blob-cache tier
    (memo/store.py), the context components derive from the live
    secret scanner (rule-set hash) and artifact option (guard
    config), and the hot-swap re-match runs on ``backend`` — the
    scan's own: ``cuda`` unless the caller asked for ``cpu`` or
    ``cpu-ref``. A ``redis://`` or ``s3://`` URI connects now and
    raises ``RedisError`` or ``S3Error`` (``ConnectionError``) when
    the backend cannot be reached, ``ValueError`` when it is
    malformed."""
    from ..secret.batch import rules_fingerprint
    from .store import make_memo_store
    store = make_memo_store(cache=cache, cache_dir=cache_dir,
                            uri=uri)
    if artifact_option is not None and secret_scanner is None:
        secret_scanner = getattr(artifact_option, "secret_scanner",
                                 None)
    return FindingsMemo(
        store=store,
        rules_fp=rules_fingerprint(secret_scanner),
        guard_fp=K.guard_fingerprint(artifact_option),
        fault_injector=fault_injector,
        backend=backend, mesh=mesh)
