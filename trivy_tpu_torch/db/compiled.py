"""Compiled, persistent, device-resident advisory tables.

Flatten the advisory store ONCE at DB-load time into

  - per-grammar sorted bound-key universes (every constraint parsed
    exactly once, at compile time);
  - int32 interval tables [N, MAX_INTERVALS] in a doubled rank space
    (bound = 2·rank + grammar band offset, exclusivity = ±1);
  - a host-side name-join index bucket → package → row span;
  - per-row metadata for DetectedVulnerability assembly;
  - host-fallback rows for constraints the interval form can't carry
    (> MAX_INTERVALS alternatives, parse errors, npm prereleases).

At scan time, per-dispatch host work is O(packages): parse each
distinct installed version once, binary-search its rank, gather
candidate rows via the dict join — then ONE resident-table dispatch
(``ops.intervals.interval_hits_resident``) evaluates every (package,
advisory) pair. The tables go to the device once per device
(``ResidentTables``) and serve every later scan.

Persistence: ``save``/``load`` round-trip the arrays plus the
indexes/universes as ONE npz file whose ``meta`` member is tagged
JSON — a data-only format (no pickle: a compiled DB may arrive over
the network, so deserialization must not be code execution), written
to a temp name and atomically renamed. The format is the reference
package's (``trivy_tpu/db/compiled.py``): each package loads the
other's files.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import logging
import os
import threading
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..ops.intervals import MAX_INTERVALS, NEG_INF, POS_INF
# resident_snapshot, prewarm_resident and _placement_label live with
# ResidentTables; the reference's callers import them from here
from ..ops.resident import (ResidentTables, _placement_label,  # noqa: F401
                            prewarm_resident, resident_snapshot)
from ..vercmp import get_comparer
from ..vercmp.maven import _PaddedKey
from ..vercmp.rubygems import _GemKey
from ..vercmp.semver import SemverKey
from .store import Advisory, AdvisoryStore

log = logging.getLogger("trivy_tpu_torch.db.compiled")


@contextlib.contextmanager
def gc_paused():
    """Pause the cyclic collector across bulk object construction,
    restoring the caller's setting."""
    import gc
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


def _eco_grammar() -> dict:
    """ecosystem prefix (before ::) → version grammar, derived from
    the single source of truth in detect.library._TYPES (lazy to
    avoid a circular import through the db package)."""
    from ..detect.library import _TYPES
    return {eco: grammar for eco, grammar in _TYPES.values()}


# OS bucket leading token → distro version grammar (detect/ospkg)
_OS_GRAMMAR = {
    "alpine": "apk",
    "debian": "deb",
    "ubuntu": "deb",
    "amazon": "rpm",
    "oracle": "rpm",
    "alma": "rpm",
    "rocky": "rpm",
    "red": "rpm",           # "Red Hat"
    "centos": "rpm",
    "fedora": "rpm",
    "cbl-mariner": "rpm",
    "photon": "rpm",
    "opensuse": "rpm",
    "suse": "rpm",
}

# row flag bits (0-2 shared with ops.intervals)
F_HAS_VULN = 1
F_FORCE = 2
F_HAS_SEC = 4
F_HOST = 8            # evaluate on host (exact fallback)
F_UNFIXED = 16        # os advisory without FixedVersion


def bucket_grammar(bucket: str) -> Optional[str]:
    if "::" in bucket:
        return _eco_grammar().get(bucket.split("::", 1)[0])
    return _OS_GRAMMAR.get(bucket.split()[0].lower()) if bucket \
        else None


@dataclass
class _Row:
    bucket: str
    pkg: str
    advisory: Advisory
    grammar: str
    vuln_ivs: list = field(default_factory=list)
    sec_ivs: list = field(default_factory=list)
    flags: int = 0


class CompiledDB(ResidentTables):
    """Flattened advisory tables + join index. Read-only after
    ``compile`` / ``load``."""

    def __init__(self):
        self.rows_meta: list = []       # per row: (bucket, pkg, Advisory)
        self.row_grammar: list = []
        self.v_lo = self.v_hi = self.s_lo = self.s_hi = None
        self.flags = None               # np.int32 [N]
        self.index: dict = {}           # bucket → {pkg → [row ids]}
        self.universe: dict = {}        # grammar → (keys list, base)
        self.vulnerabilities: dict = {}
        self.data_sources: dict = {}
        self.stats: dict = {}
        self._init_resident()
        self._parse_cache: dict = {}

    # ---- compile ----

    @classmethod
    def compile(cls, store: AdvisoryStore) -> "CompiledDB":
        # millions of long-lived row/interval objects make the cyclic
        # collector quadratic-ish; nothing cyclic is created here
        with gc_paused():
            return cls._compile(store)

    @classmethod
    def _compile(cls, store: AdvisoryStore) -> "CompiledDB":
        self = cls()
        self.vulnerabilities = dict(store.vulnerabilities)
        self.data_sources = dict(store.data_sources)

        rows: list = []
        n_host = 0
        for bucket in sorted(store.buckets):
            grammar = bucket_grammar(bucket)
            for pkg in sorted(store.buckets[bucket]):
                for adv in store.get(bucket, pkg):
                    row = self._compile_row(bucket, pkg, adv, grammar)
                    n_host += bool(row.flags & F_HOST)
                    rows.append(row)

        # per-grammar bound universes with disjoint band offsets
        bounds: dict = {}
        for row in rows:
            for iv in row.vuln_ivs + row.sec_ivs:
                b = bounds.setdefault(row.grammar, set())
                if iv.lo is not None:
                    b.add(iv.lo)
                if iv.hi is not None:
                    b.add(iv.hi)
        base = 1
        for grammar in sorted(bounds):
            keys = sorted(bounds[grammar])
            self.universe[grammar] = (keys, base)
            base += 2 * len(keys) + 4

        N = len(rows)
        self.v_lo = np.full((N, MAX_INTERVALS), POS_INF, np.int32)
        self.v_hi = np.full((N, MAX_INTERVALS), NEG_INF, np.int32)
        self.s_lo = np.full((N, MAX_INTERVALS), POS_INF, np.int32)
        self.s_hi = np.full((N, MAX_INTERVALS), NEG_INF, np.int32)
        self.flags = np.zeros(N, np.int32)
        for i, row in enumerate(rows):
            self.flags[i] = row.flags
            if row.flags & F_HOST:
                continue
            for j, iv in enumerate(row.vuln_ivs):
                self.v_lo[i, j], self.v_hi[i, j] = \
                    self._encode(row.grammar, iv)
            for j, iv in enumerate(row.sec_ivs):
                self.s_lo[i, j], self.s_hi[i, j] = \
                    self._encode(row.grammar, iv)
        self.rows_meta = [(r.bucket, r.pkg, r.advisory) for r in rows]
        self.row_grammar = [r.grammar for r in rows]
        for i, row in enumerate(rows):
            self.index.setdefault(row.bucket, {}) \
                .setdefault(row.pkg, []).append(i)

        self.stats = {
            "rows": N,
            "host_fallback_rows": n_host,
            "host_fallback_rate": (n_host / N) if N else 0.0,
            "grammars": {g: len(k)
                         for g, (k, _) in self.universe.items()},
        }
        log.info("compiled advisory db: %d rows, %d host-fallback "
                 "(%.3f%%)", N, n_host,
                 100.0 * self.stats["host_fallback_rate"])
        return self

    def _compile_row(self, bucket: str, pkg: str, adv: Advisory,
                     grammar: Optional[str]) -> _Row:
        row = _Row(bucket=bucket, pkg=pkg, advisory=adv,
                   grammar=grammar or "generic")
        is_ospkg = not (adv.vulnerable_versions or
                        adv.patched_versions or
                        adv.unaffected_versions)
        # the unfixed marker survives host fallback so the driver's
        # report_unfixed filter still applies (detect_pairs_resident)
        unfixed = F_UNFIXED if is_ospkg and \
            adv.fixed_version == "" else 0
        if grammar is None:
            row.flags = F_HOST | unfixed
            return row
        comparer = get_comparer(grammar)
        try:
            if is_ospkg:
                self._compile_ospkg(row, comparer)
            else:
                self._compile_library(row, comparer)
        except ValueError:
            row.vuln_ivs, row.sec_ivs = [], []
            row.flags = F_HOST | unfixed
        return row

    def _compile_library(self, row: _Row, comparer) -> None:
        adv = row.advisory
        if any(v == "" for v in
               list(adv.vulnerable_versions) +
               list(adv.patched_versions)):
            row.flags = F_FORCE
            return
        from ..detect.ccache import INTERVAL_CACHE
        if adv.vulnerable_versions:
            row.flags |= F_HAS_VULN
            for c in " || ".join(adv.vulnerable_versions).split("||"):
                if not c.strip():
                    raise ValueError("empty constraint alternative")
                row.vuln_ivs.extend(INTERVAL_CACHE.intervals(
                    row.grammar, comparer, c))
        secure = list(adv.patched_versions) + \
            list(adv.unaffected_versions)
        if secure:
            row.flags |= F_HAS_SEC
            for c in " || ".join(secure).split("||"):
                if not c.strip():
                    raise ValueError("empty constraint alternative")
                row.sec_ivs.extend(INTERVAL_CACHE.intervals(
                    row.grammar, comparer, c))
        if len(row.vuln_ivs) > MAX_INTERVALS or \
                len(row.sec_ivs) > MAX_INTERVALS:
            row.vuln_ivs, row.sec_ivs = [], []
            row.flags = F_HOST

    def _compile_ospkg(self, row: _Row, comparer) -> None:
        from ..vercmp.base import Interval
        adv = row.advisory
        lo = comparer.parse(adv.affected_version) \
            if adv.affected_version else None
        if adv.fixed_version == "":
            row.vuln_ivs = [Interval(lo=lo)]
            row.flags = F_HAS_VULN | F_UNFIXED
        else:
            row.vuln_ivs = [Interval(
                lo=lo, hi=comparer.parse(adv.fixed_version),
                hi_incl=False)]
            row.flags = F_HAS_VULN

    def _encode(self, grammar: str, iv) -> tuple:
        keys, base = self.universe[grammar]
        if iv.lo is None:
            lo = NEG_INF
        else:
            lo = base + 2 * bisect_left(keys, iv.lo) + \
                (0 if iv.lo_incl else 1)
        if iv.hi is None:
            hi = POS_INF
        else:
            hi = base + 2 * bisect_left(keys, iv.hi) - \
                (0 if iv.hi_incl else 1)
        return lo, hi

    # ---- scan-time API ----

    def pkg_rank(self, grammar: str, version: str) -> Optional[int]:
        """Rank an installed version in its grammar band. Bound keys
        sit at even offsets; a version strictly between bounds gets
        the odd offset below the next bound — containment is then
        EXACT for bounds-only universes. None on parse failure."""
        cached = self._parse_cache.get((grammar, version))
        if cached is not None:
            return cached if cached != -1 else None
        keys, base = self.universe.get(grammar, ([], 1))
        try:
            key = get_comparer(grammar).parse(version)
        except ValueError:
            self._parse_cache[(grammar, version)] = -1
            return None
        i = bisect_left(keys, key)
        if i < len(keys) and keys[i] == key:
            r = base + 2 * i
        else:
            r = base + 2 * i - 1
        self._parse_cache[(grammar, version)] = r
        return r

    def candidate_rows(self, bucket: str, pkg: str) -> list:
        return self.index.get(bucket, {}).get(pkg, [])

    def _prefix_index(self) -> dict:
        """ecosystem prefix ("pip::") → bucket list, built lazily so
        prefix joins are O(1) per package, not O(buckets)."""
        if not hasattr(self, "_prefixes"):
            prefixes: dict = {}
            for bucket in self.index:
                if "::" in bucket:
                    pre = bucket.split("::", 1)[0] + "::"
                    prefixes.setdefault(pre, []).append(bucket)
            self._prefixes = prefixes
        return self._prefixes

    def candidate_rows_prefix(self, prefix: str, pkg: str) -> list:
        buckets = self._prefix_index().get(prefix)
        if buckets is None:               # non-ecosystem prefix query
            buckets = [b for b in self.index if b.startswith(prefix)]
        out = []
        for bucket in buckets:
            out.extend(self.index[bucket].get(pkg, []))
        return out

    def host_eval(self, row: int, version: str) -> bool:
        """Exact host evaluation for F_HOST rows — must mirror the
        classic paths (base.is_vulnerable / the OS drivers'
        fixed-version compare)."""
        from ..vercmp.base import is_vulnerable
        bucket, _pkg, adv = self.rows_meta[row]
        grammar = self.row_grammar[row]
        if grammar == "generic":
            grammar = bucket_grammar(bucket) or "semver"
        comparer = get_comparer(grammar)
        if adv.vulnerable_versions or adv.patched_versions or \
                adv.unaffected_versions:
            return is_vulnerable(comparer, version,
                                 adv.vulnerable_versions,
                                 adv.patched_versions,
                                 adv.unaffected_versions)
        # ospkg: affected-version gate first (alpine "introduced in");
        # a parse error rejects, as in the OS drivers
        if adv.affected_version:
            try:
                if comparer.parse(adv.affected_version) > \
                        comparer.parse(version):
                    return False
            except ValueError:
                return False
        if adv.fixed_version == "":
            return True
        try:
            return comparer.compare(version, adv.fixed_version) < 0
        except ValueError:
            return False

    # ---- device residency (ResidentTables hooks) ----
    #
    # device_tables(device) uploads (v_lo, v_hi, s_lo, s_hi, flags)
    # ONCE per device (a mesh: once per distinct device of it, one
    # tuple per flat shard); invalidate_device drops the copies.

    def _resident_arrays(self) -> tuple:
        return (self.v_lo, self.v_hi, self.s_lo, self.s_hi,
                self.flags)

    def _span_attrs(self) -> dict:
        return {"rows": int(len(self.flags))}

    def _note_upload(self, nbytes: int) -> None:
        from ..detect.metrics import DETECT_METRICS
        DETECT_METRICS.note_db_upload(nbytes)

    def _note_dispatch(self) -> None:
        from ..detect.metrics import DETECT_METRICS
        DETECT_METRICS.inc("resident_dispatches")

    def _note_invalidation(self) -> None:
        from ..detect.metrics import DETECT_METRICS
        DETECT_METRICS.inc("db_invalidations")

    # ---- content identity ----

    def content_fingerprint(self) -> str:
        """Content hash of the compiled tables + advisory records — the
        cross-process identity of a DB (``generation`` is
        process-monotonic and says nothing about content). Cached: a
        CompiledDB is read-only after compile/load."""
        fp = getattr(self, "_content_fp", None)
        if fp is None:
            import hashlib
            h = hashlib.sha256()
            for a in (self.v_lo, self.v_hi, self.s_lo, self.s_hi,
                      self.flags):
                if a is not None:
                    h.update(np.ascontiguousarray(a).tobytes())
            h.update(json.dumps(
                [[b, p, _adv_enc(a)] for b, p, a in self.rows_meta],
                sort_keys=True, default=_json_default).encode())
            fp = self._content_fp = h.hexdigest()[:32]
        return fp

    # ---- enrichment reads (db.Config parity) ----

    def get_vulnerability(self, vuln_id: str):
        from .store import VulnerabilityDetail
        v = self.vulnerabilities.get(vuln_id)
        if v is None:
            return None
        return VulnerabilityDetail.from_dict(vuln_id, v)

    # ---- persistence ----
    # (tagged-JSON helpers for save/load live at module scope below)

    def save(self, path: str) -> None:
        """Write ``path + ".npz"`` atomically (temp file + rename).

        Everything non-array rides in the ``meta`` member as tagged
        JSON (see ``_enc_key``); a single file means a reader can never
        pair new arrays with stale metadata."""
        meta = {
            "rows_meta": [(b, p, _adv_enc(a))
                          for b, p, a in self.rows_meta],
            "row_grammar": self.row_grammar,
            "index": self.index,
            "universe": {g: [[_enc_key(k) for k in keys], base]
                         for g, (keys, base) in self.universe.items()},
            "vulnerabilities": self.vulnerabilities,
            "data_sources": self.data_sources,
            "stats": self.stats,
        }
        blob = np.frombuffer(
            json.dumps(meta, default=_json_default).encode(),
            np.uint8)
        tmp = path + ".npz.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f, v_lo=self.v_lo, v_hi=self.v_hi,
                s_lo=self.s_lo, s_hi=self.s_hi, flags=self.flags,
                meta=blob)
        os.replace(tmp, path + ".npz")

    @classmethod
    def load(cls, path: str) -> "CompiledDB":
        self = cls()
        arrs = np.load(path + ".npz")
        self.v_lo, self.v_hi = arrs["v_lo"], arrs["v_hi"]
        self.s_lo, self.s_hi = arrs["s_lo"], arrs["s_hi"]
        self.flags = arrs["flags"]
        if "meta" not in arrs:
            raise ValueError(
                f"{path}.npz has no meta member — rebuild it with "
                f"CompiledDB.save (pre-data-only-format file?)")
        d = json.loads(arrs["meta"].tobytes().decode(),
                       object_hook=_json_hook)
        self.rows_meta = [(b, p, _adv_dec(a))
                          for b, p, a in d["rows_meta"]]
        self.row_grammar = d["row_grammar"]
        self.index = d["index"]
        self.universe = {g: ([_dec_key(k) for k in keys], base)
                         for g, (keys, base) in d["universe"].items()}
        self.vulnerabilities = d["vulnerabilities"]
        self.data_sources = d["data_sources"]
        self.stats = d["stats"]
        return self


# ---- data-only persistence helpers ---------------------------------
#
# Version-grammar parse keys are nested tuples, sometimes wrapped in a
# grammar's own comparable class (SemverKey, maven _PaddedKey,
# rubygems _GemKey). bisect at scan time compares freshly parsed keys
# against persisted ones, so the round-trip must restore EXACT types —
# hence a tagged encoding over a closed class set that fails loudly on
# anything new instead of silently pickling it.

def _enc_key(v):
    if isinstance(v, SemverKey):
        return ["sv"] + [_enc_key(x) for x in v]
    if isinstance(v, _PaddedKey):
        return ["mv", _enc_key(v.toks)]
    if isinstance(v, _GemKey):
        return ["gem", _enc_key(v.segs)]
    if isinstance(v, tuple):
        return ["t"] + [_enc_key(x) for x in v]
    if isinstance(v, list):
        return ["l"] + [_enc_key(x) for x in v]
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    raise TypeError(f"unencodable universe key part: {type(v)}")


def _dec_key(v):
    if not isinstance(v, list):
        return v
    tag, rest = v[0], v[1:]
    if tag == "sv":
        return SemverKey(tuple(_dec_key(x) for x in rest))
    if tag == "mv":
        return _PaddedKey(_dec_key(rest[0]))
    if tag == "gem":
        return _GemKey(_dec_key(rest[0]))
    if tag == "t":
        return tuple(_dec_key(x) for x in rest)
    if tag == "l":
        return [_dec_key(x) for x in rest]
    raise ValueError(f"bad universe key tag: {tag!r}")


def _json_default(o):
    """Vulnerability detail dicts come from YAML fixtures, which parse
    ISO timestamps into datetime (and unquoted day-only values into
    date) — tag both for the round-trip."""
    if isinstance(o, _dt.datetime):
        return {"$dt": o.isoformat()}
    if isinstance(o, _dt.date):
        return {"$d": o.isoformat()}
    raise TypeError(f"unencodable compiled-db value: {type(o)}")


def _json_hook(d: dict):
    if len(d) == 1:
        if "$dt" in d:
            return _dt.datetime.fromisoformat(d["$dt"])
        if "$d" in d:
            return _dt.date.fromisoformat(d["$d"])
    return d


def _adv_enc(a: Advisory) -> list:
    ds = a.data_source
    return [a.vulnerability_id, a.fixed_version, a.affected_version,
            a.vulnerable_versions, a.patched_versions,
            a.unaffected_versions, a.arches, a.severity, a.vendor_ids,
            [ds.id, ds.name, ds.url] if ds is not None else None,
            a.content_sets]


def _adv_dec(v: list) -> Advisory:
    from ..types import DataSource
    ds = DataSource(id=v[9][0], name=v[9][1], url=v[9][2]) \
        if v[9] is not None else None
    return Advisory(
        vulnerability_id=v[0], fixed_version=v[1],
        affected_version=v[2], vulnerable_versions=v[3],
        patched_versions=v[4], unaffected_versions=v[5],
        arches=v[6], severity=v[7], vendor_ids=v[8], data_source=ds,
        content_sets=v[10] if len(v) > 10 else [])


class SwappableStore:
    """Double-buffered advisory DB holder (ref
    ``trivy_tpu/db/compiled.py:769``; the reference's Go analog is the
    RW-waitgroup pair gating the server's DB update, listen.go:54-83).

    Readers take ``acquire()`` / ``release()`` around a scan (the
    runner's ``_store_view``); ``swap`` installs a freshly compiled DB
    after in-flight scans drain. Before it waits, ``swap`` stages the
    new generation's tables on every card the outgoing one is resident
    on, so the first scan after the swap does not wait on the upload;
    a generation that lives on the CPU has nothing to stage, and on a
    card a failed upload raises (the old generation stays installed).
    The outgoing generation's device copies are then dropped
    (``invalidate_device``): a dispatch already holding its tensors
    finishes on them, and the memory frees when the last one lets go.
    Swap hooks (``db/lifecycle.py::attach_memo``) run after the new
    generation is in, with ``(old, new)``."""

    def __init__(self, db: Optional[CompiledDB] = None):
        self._db = db
        self._lock = threading.Lock()
        self._readers = 0
        self._no_readers = threading.Condition(self._lock)
        self._swap_hooks: list = []

    def add_swap_hook(self, fn) -> "SwappableStore":
        """Register ``fn(old_db, new_db)`` to run after every swap.
        Hook failures are logged, never raised — a broken observer
        must not wedge the DB update."""
        self._swap_hooks.append(fn)
        return self

    def remove_swap_hook(self, fn) -> None:
        try:
            self._swap_hooks.remove(fn)
        except ValueError:
            pass

    def acquire(self) -> CompiledDB:
        with self._lock:
            self._readers += 1
            return self._db

    def release(self) -> None:
        with self._lock:
            self._readers -= 1
            if self._readers == 0:
                self._no_readers.notify_all()

    def current(self) -> CompiledDB:
        with self._lock:
            return self._db

    def _staging_devices(self) -> list:
        """The cards the current generation's tables are on."""
        placed = getattr(self._db, "_device", None) or {}
        return sorted(k for k in list(placed)
                      if isinstance(k, str) and k.startswith("cuda"))

    def swap(self, new_db: CompiledDB) -> None:
        if getattr(new_db, "v_lo", None) is not None and len(new_db.v_lo):
            for device in self._staging_devices():
                new_db.device_tables(device)    # raises on a failure
        with self._lock:
            while self._readers:
                self._no_readers.wait()
            old, self._db = self._db, new_db
        # getattr: the holder also fronts plain AdvisoryStores (no
        # device residency)
        drop = getattr(old, "invalidate_device", None)
        if drop is not None and old is not new_db:
            drop()
        if old is not new_db:
            for fn in list(self._swap_hooks):
                try:
                    fn(old, new_db)
                except Exception as e:      # noqa: BLE001
                    log.warning("swap hook %r failed: %r", fn, e)
