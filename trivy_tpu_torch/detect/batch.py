"""Batch vulnerability detection: rank-encode versions, compile
constraints to intervals, one device dispatch for every (package,
advisory) pair across every ecosystem in the batch.

Parity: results are identical to the host drivers (``library.py``) —
guaranteed because interval compilation is exact over the finite rank
universe, pairs whose constraints exceed MAX_INTERVALS or fail to
parse take the exact host path, and the doubled rank space captures
bound exclusivity exactly.

Dispatch shape: jobs are DEDUPED before any compilation — fleets
repeat (version, constraint) pairs massively (every SBOM in a batch
depends on the same lodash), so the device evaluates each distinct
pair once and the hit fans back out to every duplicate's payload. Row
tables are packed with bulk fancy-index stores into buffers padded to
a small bucket ladder.

``backend`` is ``"cuda"`` (the default: the torch functions of
``ops/intervals.py`` on the card, through ``resolve_device``, so it
raises without one), ``"cpu"`` (the same torch functions on the CPU)
or ``"cpu-ref"`` (numpy). The result is a list of payloads: device
hits in job order, then host-path hits in job order. ``mesh=`` waits
for the multi-GPU port and raises.

``dispatch_jobs`` is the synchronous ladder (upload, match, copy back,
then the next store); ``dispatch_jobs_async`` + ``collect_dispatch``
split the same work into bounded waves on a CUDA side stream that a
``runtime.ring.DispatchRing`` keeps in flight while the host packs the
next one (the fleet runtime's path, ``runtime/batch.py``).
"""

from __future__ import annotations

import logging
import time
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.intervals import (MAX_INTERVALS, NEG_INF, POS_INF,
                             interval_hits, interval_hits_host,
                             interval_hits_resident)
from ..vercmp import get_comparer
from ..vercmp.base import Interval
from .ccache import INTERVAL_CACHE
from .metrics import DETECT_METRICS

log = logging.getLogger("trivy_tpu_torch.detect.batch")


@dataclass
class PairJob:
    """One (package, advisory) candidate pair after the name join."""

    grammar: str
    pkg_version: str
    vulnerable: list = field(default_factory=list)  # constraint strings
    patched: list = field(default_factory=list)
    unaffected: list = field(default_factory=list)
    payload: object = None          # opaque — returned with hits
    # ospkg-style single bounds:
    fixed_version: str = ""
    affected_version: str = ""
    report_unfixed: bool = True
    kind: str = "library"           # "library" | "ospkg"

    def dedup_key(self) -> tuple:
        """Everything that affects evaluation — NOT the payload.
        Jobs sharing a key are provably equivalent, so one device
        row serves all of them."""
        return (self.kind, self.grammar, self.pkg_version,
                tuple(self.vulnerable), tuple(self.patched),
                tuple(self.unaffected), self.fixed_version,
                self.affected_version, self.report_unfixed)


class _RankSpace:
    """Per-grammar rank universe over the batch's version strings."""

    def __init__(self, grammar: str):
        self.comparer = get_comparer(grammar)
        self.keys: dict = {}
        self.extra: list = []           # constraint bound keys

    def key(self, version: str):
        if version not in self.keys:
            self.keys[version] = self.comparer.parse(version)
        return self.keys[version]

    def add_key(self, key) -> None:
        self.extra.append(key)

    def finalize(self):
        self.sorted_keys = sorted(
            set(self.keys.values()) | set(self.extra))

    def rank(self, key) -> int:
        return 2 * bisect_left(self.sorted_keys, key)

    def encode(self, iv: Interval) -> tuple:
        lo = NEG_INF if iv.lo is None else \
            self.rank(iv.lo) + (0 if iv.lo_incl else 1)
        hi = POS_INF if iv.hi is None else \
            self.rank(iv.hi) - (0 if iv.hi_incl else 1)
        return lo, hi


# device wall time and dedup counters of the most recent dispatch_jobs
# call. Callers that dispatch from several threads pass their own
# ``stats`` sink instead of sharing this module global.
last_dispatch_stats: dict = {"device_s": 0.0}


def _job_bucket(n: int) -> int:
    """Pair-row shape ladder: powers of two from 64 up to 8192, then
    8192-steps (the shared ops.keywords ladder with pair-row
    constants). Pad rows are inert (flags=0 → never hit) and the
    caller trims the output."""
    from ..ops.keywords import _bucket
    return _bucket(n, base=64, cap=8192)


def _device(backend: str) -> Optional[torch.device]:
    """The torch device of ``backend``; None for numpy (``cpu-ref``)."""
    if backend == "cpu-ref":
        return None
    if backend == "cpu":
        return torch.device("cpu")
    if backend == "cuda":
        return resolve_device("cuda")
    raise ValueError(f"unknown backend {backend!r}")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "interval dispatch over a mesh waits for the multi-GPU "
            "port (ROADMAP Queue A.6)")


def _dedup(jobs: list, key_fn) -> tuple:
    """(representatives, members): one representative job per
    distinct key, plus the original job index list behind each."""
    index: dict = {}
    reps: list = []
    members: list = []
    for i, job in enumerate(jobs):
        k = key_fn(job)
        gi = index.get(k)
        if gi is None:
            index[k] = len(reps)
            reps.append(job)
            members.append([i])
        else:
            members[gi].append(i)
    return reps, members


def _prep_classic(jobs: list, sink: dict) -> tuple:
    """Dedup + per-grammar compile: ``(reps, members, spaces, rows,
    host_groups)`` where ``rows`` holds the device-path
    representatives in group order. Rank spaces are not finalized
    yet."""
    reps, members = _dedup(jobs, PairJob.dedup_key)
    sink["jobs_in"] = sink.get("jobs_in", 0) + len(jobs)
    sink["jobs_unique"] = sink.get("jobs_unique", 0) + len(reps)
    DETECT_METRICS.note_dispatch(len(jobs), len(reps))

    spaces: dict = {}
    rows = []          # (group idx, job, pkg_key, vuln, sec, flags)
    host_groups = []   # fallback: group indices
    for gi, job in enumerate(reps):
        sp = spaces.setdefault(job.grammar, _RankSpace(job.grammar))
        try:
            pkg_key = sp.key(job.pkg_version)
        except ValueError as e:
            log.debug("package version parse error: %s", e)
            continue                      # reference: skip the package
        try:
            vuln_ivs, sec_ivs, flags = _compile(job, sp)
        except _HostFallback:
            host_groups.append(gi)
            continue
        except ValueError as e:
            log.debug("constraint error: %s", e)
            continue                      # reference: warn + not vuln
        if flags is None:
            continue                      # statically not vulnerable
        rows.append((gi, job, pkg_key, vuln_ivs, sec_ivs, flags))
    return reps, members, spaces, rows, host_groups


def _pack_classic(rows: list, spaces: dict, Pp: int) -> tuple:
    """Pack rows into padded [Pp] / [Pp, M] tables (pad rows inert:
    flags=0), one fancy-index store per table."""
    pkg_rank = np.zeros(Pp, np.int32)
    v_lo = np.full((Pp, MAX_INTERVALS), POS_INF, np.int32)
    v_hi = np.full((Pp, MAX_INTERVALS), NEG_INF, np.int32)
    s_lo = np.full((Pp, MAX_INTERVALS), POS_INF, np.int32)
    s_hi = np.full((Pp, MAX_INTERVALS), NEG_INF, np.int32)
    flags_arr = np.zeros(Pp, np.int32)
    vi: list = []
    vj: list = []
    vb: list = []
    si: list = []
    sj: list = []
    sb: list = []
    for i, (gi, job, pkg_key, vuln_ivs, sec_ivs, flags) in \
            enumerate(rows):
        sp = spaces[job.grammar]
        pkg_rank[i] = sp.rank(pkg_key)
        flags_arr[i] = flags
        for j, iv in enumerate(vuln_ivs):
            vi.append(i)
            vj.append(j)
            vb.append(sp.encode(iv))
        for j, iv in enumerate(sec_ivs):
            si.append(i)
            sj.append(j)
            sb.append(sp.encode(iv))
    if vb:
        b = np.asarray(vb, np.int32)
        v_lo[vi, vj] = b[:, 0]
        v_hi[vi, vj] = b[:, 1]
    if sb:
        b = np.asarray(sb, np.int32)
        s_lo[si, sj] = b[:, 0]
        s_hi[si, sj] = b[:, 1]
    return pkg_rank, v_lo, v_hi, s_lo, s_hi, flags_arr


def detect_pairs(jobs: list, backend: str = "cuda", mesh=None,
                 stats: Optional[dict] = None) -> list:
    """Payloads of the vulnerable pairs among classic ``PairJob``s:
    device hits in job order, then host-path hits in job order."""
    _no_mesh(mesh)
    if not jobs:
        return []
    dev = _device(backend)
    sink = stats if stats is not None else last_dispatch_stats
    reps, members, spaces, rows, host_groups = \
        _prep_classic(jobs, sink)

    hit_jobs: list = []          # original job indices that hit
    if rows:
        for sp in spaces.values():
            sp.finalize()
        P = len(rows)
        Pp = P if dev is None else _job_bucket(P)
        arrs = _pack_classic(rows, spaces, Pp)
        t0 = time.perf_counter()
        if dev is None:
            hits = np.asarray(interval_hits_host(*arrs))
        else:
            # fresh per-dispatch payload tensors; the copy back waits
            # for the device
            hits = interval_hits(*(torch.from_numpy(a).to(dev)
                                   for a in arrs)).cpu().numpy()
        sink["device_s"] = sink.get("device_s", 0.0) + \
            time.perf_counter() - t0
        for i in np.nonzero(hits[:P])[0]:
            hit_jobs.extend(members[rows[i][0]])

    out = [jobs[i].payload for i in sorted(hit_jobs)]

    # host fallback pairs: exact per-pair evaluation, once per
    # distinct key — the verdict fans out to every duplicate
    host_hits: list = []
    for gi in host_groups:
        if _host_eval(reps[gi]):
            host_hits.extend(members[gi])
    out.extend(jobs[i].payload for i in sorted(host_hits))
    return out


class _HostFallback(Exception):
    pass


def _compile(job: PairJob, sp: _RankSpace):
    """job → (vuln intervals, secure intervals, flags) or None when
    statically not vulnerable. Raises _HostFallback on complexity."""
    if job.kind == "ospkg":
        return _compile_ospkg(job, sp)

    flags = 0
    if any(v == "" for v in list(job.vulnerable) + list(job.patched)):
        return [], [], 2                  # force-vulnerable
    # node-semver's prerelease-exclusion rule is not an interval
    # property; prerelease npm versions take the exact host path
    if getattr(sp.comparer, "is_prerelease",
               lambda v: False)(job.pkg_version):
        raise _HostFallback

    vuln_ivs: list = []
    if job.vulnerable:
        flags |= 1
        for constraint in " || ".join(job.vulnerable).split("||"):
            if not constraint.strip():
                raise ValueError("empty constraint alternative")
            vuln_ivs.extend(INTERVAL_CACHE.intervals(
                job.grammar, sp.comparer, constraint))
    secure = list(job.patched) + list(job.unaffected)
    sec_ivs: list = []
    if secure:
        flags |= 4
        for constraint in " || ".join(secure).split("||"):
            if not constraint.strip():
                raise ValueError("empty constraint alternative")
            sec_ivs.extend(INTERVAL_CACHE.intervals(
                job.grammar, sp.comparer, constraint))
    if len(vuln_ivs) > MAX_INTERVALS or len(sec_ivs) > MAX_INTERVALS:
        raise _HostFallback
    for iv in vuln_ivs + sec_ivs:
        _intern_bounds(iv, sp)
    return vuln_ivs, sec_ivs, flags


def _compile_ospkg(job: PairJob, sp: _RankSpace):
    """OS advisory → vulnerable interval [affected, fixed)."""
    lo = None
    if job.affected_version:
        lo = sp.key(job.affected_version)    # may raise ValueError
    if job.fixed_version == "":
        if not job.report_unfixed:
            return [], [], None       # statically not vulnerable
        iv = Interval(lo=lo)
    else:
        iv = Interval(lo=lo, hi=sp.key(job.fixed_version),
                      hi_incl=False)
    return [iv], [], 1


def _intern_bounds(iv: Interval, sp: _RankSpace) -> None:
    """Constraint bounds are parsed keys — register them in the rank
    universe so ``finalize`` covers them."""
    if iv.lo is not None:
        sp.add_key(iv.lo)
    if iv.hi is not None:
        sp.add_key(iv.hi)


def _host_eval(job: PairJob) -> bool:
    from ..vercmp.base import is_vulnerable
    comparer = get_comparer(job.grammar)
    return is_vulnerable(comparer, job.pkg_version, job.vulnerable,
                         job.patched, job.unaffected)


# ---- compiled-store path (device-resident advisory tables) ----

@dataclass
class ResidentPairJob:
    """(package, advisory-row) pair against a CompiledDB — no
    constraint strings, no per-dispatch compilation."""

    cdb: object                 # CompiledDB
    row: int
    grammar: str
    pkg_version: str
    report_unfixed: bool = True
    payload: object = None

    def dedup_key(self) -> tuple:
        # the DB identity is part of the key: row N of one compiled
        # generation says nothing about row N of another
        return (getattr(self.cdb, "generation", id(self.cdb)),
                self.row, self.grammar, self.pkg_version,
                self.report_unfixed)


def _prep_resident(jobs: list, cdb, sink: dict) -> tuple:
    """Dedup + row triage: ``(reps, members, kept, ranks, rows,
    host)``."""
    from ..db.compiled import F_HOST, F_UNFIXED
    reps, members = _dedup(jobs, ResidentPairJob.dedup_key)
    sink["jobs_in"] = sink.get("jobs_in", 0) + len(jobs)
    sink["jobs_unique"] = sink.get("jobs_unique", 0) + len(reps)
    DETECT_METRICS.note_dispatch(len(jobs), len(reps))

    kept: list = []              # group indices on the device path
    ranks: list = []
    rows: list = []
    host: list = []              # group indices on the host path
    for gi, job in enumerate(reps):
        flags = int(cdb.flags[job.row])
        if (flags & F_UNFIXED) and not job.report_unfixed:
            continue
        comparer = get_comparer(job.grammar)
        if (flags & F_HOST) or getattr(
                comparer, "is_prerelease",
                lambda v: False)(job.pkg_version):
            host.append(gi)
            continue
        r = cdb.pkg_rank(job.grammar, job.pkg_version)
        if r is None:
            continue                 # version parse error: skip
        kept.append(gi)
        ranks.append(r)
        rows.append(job.row)
    return reps, members, kept, ranks, rows, host


def detect_pairs_resident(jobs: list, backend: str = "cuda",
                          mesh=None,
                          stats: Optional[dict] = None) -> list:
    """Evaluate ResidentPairJobs in one gather-dispatch against the
    resident tables. Host work is O(distinct jobs): duplicates are
    folded before rank lookup, rank lookups are cached per
    (grammar, version), and the advisory universe is never touched."""
    _no_mesh(mesh)
    if not jobs:
        return []
    dev = _device(backend)
    sink = stats if stats is not None else last_dispatch_stats

    cdb = jobs[0].cdb
    if any(j.cdb is not cdb for j in jobs):
        # the device path below gathers from ONE store's tables; a
        # mixed list evaluates per store
        by_db: dict = {}
        for j in jobs:
            by_db.setdefault(id(j.cdb), []).append(j)
        out = []
        for js in by_db.values():
            out.extend(detect_pairs_resident(
                js, backend=backend, stats=stats))
        return out
    reps, members, kept, ranks, rows, host = \
        _prep_resident(jobs, cdb, sink)

    hit_jobs: list = []
    if kept:
        P = len(kept)
        Pp = P if dev is None else _job_bucket(P)
        pkg_rank = np.zeros(Pp, np.int32)
        row_idx = np.zeros(Pp, np.int32)
        pkg_rank[:P] = ranks
        row_idx[:P] = rows
        t0 = time.perf_counter()
        if dev is None:
            hits = interval_hits_host(
                pkg_rank, cdb.v_lo[row_idx], cdb.v_hi[row_idx],
                cdb.s_lo[row_idx], cdb.s_hi[row_idx],
                cdb.flags[row_idx])
        else:
            tables = cdb.device_tables(dev)
            # the ranks and row indices are fresh per dispatch; the
            # resident tables serve every dispatch and are only read
            hits = interval_hits_resident(
                torch.from_numpy(pkg_rank).to(dev),
                torch.from_numpy(row_idx).to(dev),
                *tables).cpu().numpy()
        sink["device_s"] = sink.get("device_s", 0.0) + \
            time.perf_counter() - t0
        for i in np.nonzero(hits[:P])[0]:
            hit_jobs.extend(members[kept[i]])
    out = [jobs[i].payload for i in sorted(hit_jobs)]

    host_hits: list = []
    for gi in host:
        job = reps[gi]
        if job.cdb.host_eval(job.row, job.pkg_version):
            host_hits.extend(members[gi])
    out.extend(jobs[i].payload for i in sorted(host_hits))
    return out


def dispatch_jobs(jobs: list, backend: str = "cuda", mesh=None,
                  stats: Optional[dict] = None) -> list:
    """Mixed-job dispatcher: classic PairJobs (per-dispatch compile)
    and ResidentPairJobs (compiled store, one dispatch per store).
    ``stats`` (optional) receives this call's device_s and the dedup
    counters (``jobs_in`` / ``jobs_unique``) instead of the shared
    module global — pass one per thread."""
    _no_mesh(mesh)
    _device(backend)
    sink = stats if stats is not None else last_dispatch_stats
    sink["device_s"] = 0.0
    sink["jobs_in"] = 0
    sink["jobs_unique"] = 0
    plain = [j for j in jobs if isinstance(j, PairJob)]
    resident = [j for j in jobs if isinstance(j, ResidentPairJob)]
    out = detect_pairs(plain, backend=backend, stats=sink) \
        if plain else []
    by_db: dict = {}
    for j in resident:
        by_db.setdefault(id(j.cdb), []).append(j)
    for js in by_db.values():
        out.extend(detect_pairs_resident(js, backend=backend,
                                         stats=sink))
    return out


# ---- async slot dispatch (reference detect/batch.py:565-852) ----
#
# dispatch_jobs_async() splits the kernel rows into bounded WAVES and
# launches every wave without waiting for it; collect_dispatch() — or,
# when a DispatchRing is passed, the ring's drain thread — waits for
# wave N while the submitting thread packs and launches wave N+1.
#
# On the card each segment owns a side stream. A wave's launch runs on
# the submitting thread: the side stream first waits for that thread's
# current stream (so it sees whatever was enqueued before it, the
# resident tables' upload included), then the wave's operands are
# staged in pinned host buffers, copied up without blocking, matched,
# and the hit vector is copied back into a pinned buffer, all on the
# side stream; an event recorded there closes the wave. Its collect
# waits on that event alone and reads the pinned hits: a plain
# ``.cpu()`` on the drain thread would run on that thread's current
# stream, which does not wait for the side stream. Every buffer of a
# wave (pinned and on the card) stays referenced by the wave until its
# event has completed, so neither the caching allocator nor the pinned
# host allocator hands it to the next wave early; the resident tables
# are only read, and the wave keeps them referenced too. On the CPU
# the same segments run with the same ring and waves, in plain torch:
# a wave's work is done when its launch returns.

_WAVE_ROWS = 4096      # max kernel rows launched per wave


class _EagerSegment:
    """Backend with no async device path (cpu-ref): the synchronous
    ladder already ran at dispatch; collect replays its output."""

    def __init__(self, out: list):
        self.out = out

    def collect(self) -> list:
        return self.out


class _WaveSegment:
    """Shared wave bookkeeping for the classic and resident async
    paths: launch waves, collect them FIFO, fan hits back out
    through the dedup members exactly like the synchronous path."""

    def __init__(self, jobs: list, dev: torch.device, sink: dict, ring):
        self.jobs = jobs
        self.dev = dev
        self.sink = sink
        self.ring = ring
        self.stream = torch.cuda.Stream(device=dev) \
            if dev.type == "cuda" else None
        self.waves: list = []
        self.members: list = []
        self.reps: list = []

    def _launch_wave(self, k: int, build) -> None:
        """``build()`` stages, uploads and enqueues one wave and
        returns its dict. With a ring it runs as the submit's
        ``launch`` callable, AFTER capacity is acquired — so a full
        ring parks before wave k+1 stages any buffer (the depth bound
        covers staged buffers, not just bookkeeping)."""
        if self.ring is not None:
            built: dict = {}

            def _launch():
                built["wave"] = build()
                return built["wave"]

            slot = self.ring.submit(self._collect_wave, launch=_launch,
                                    label=f"interval:w{k}")
            wave = built["wave"]
            wave["slot"] = slot
        else:
            wave = build()
        self.waves.append(wave)

    def _enqueue(self, arrays: list, compute, rows: int, groups: list,
                 keep=()) -> dict:
        """One wave: ``compute(*tensors)`` → [Pp] bool hits over the
        numpy ``arrays``. ``keep`` holds what the wave reads and must
        outlive it (the resident tables)."""
        if self.stream is None:
            t0 = time.perf_counter()
            out = compute(*(torch.from_numpy(a) for a in arrays))
            return {"out": out, "rows": rows, "groups": groups,
                    "compute_s": time.perf_counter() - t0}
        stream = self.stream
        stream.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(stream):
            pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
            dev_in = [t.to(self.dev, non_blocking=True) for t in pinned]
            hits = compute(*dev_in)
            out = torch.empty(hits.shape, dtype=hits.dtype,
                              pin_memory=True)
            out.copy_(hits, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return {"out": out, "event": event, "rows": rows,
                "groups": groups, "buffers": (pinned, dev_in, hits, keep)}

    def _collect_wave(self, wave: dict) -> None:
        t0 = time.perf_counter()
        event = wave.get("event")
        if event is not None:
            # the wave's own event: its copy back has landed
            event.synchronize()
        wave["hits"] = wave["out"].numpy()
        # the wave's buffers may go back to their allocators only now
        wave["buffers"] = wave["event"] = None
        self.sink["device_s"] = self.sink.get("device_s", 0.0) + \
            wave.get("compute_s", 0.0) + time.perf_counter() - t0

    def _kernel_hits(self) -> list:
        hit_jobs: list = []
        for wave in self.waves:
            slot = wave.get("slot")
            if slot is not None:
                slot.wait()
            elif "hits" not in wave:
                self._collect_wave(wave)
            for i in np.nonzero(wave["hits"][:wave["rows"]])[0]:
                hit_jobs.extend(self.members[wave["groups"][i]])
        return hit_jobs

    def _host_hits(self, host_groups: list, eval_fn) -> list:
        host_hits: list = []
        for gi in host_groups:
            if eval_fn(self.reps[gi]):
                host_hits.extend(self.members[gi])
        return host_hits


class _ClassicSegment(_WaveSegment):
    def __init__(self, jobs: list, dev: torch.device, sink: dict, ring,
                 max_wave_rows: int):
        super().__init__(jobs, dev, sink, ring)
        (self.reps, self.members, spaces, rows,
         self.host_groups) = _prep_classic(jobs, sink)
        for sp in spaces.values():
            sp.finalize()
        if not rows:
            return
        w = max(1, int(max_wave_rows))
        slices = [rows[a:a + w] for a in range(0, len(rows), w)]

        def _pack(sl):
            return _pack_classic(sl, spaces, _job_bucket(len(sl)))

        # pool-parallel wave packing: the fancy-index fills of every
        # wave run on the host pool while this thread uploads and
        # enqueues the waves in order
        # (imported here: the runtime package imports this module)
        from ..runtime.hostpool import get_host_pool, on_pool_thread
        futs = None
        if len(slices) > 1 and not on_pool_thread():
            pool = get_host_pool()
            if pool is not None:
                futs = [pool.submit(_pack, sl) for sl in slices]
        for k, sl in enumerate(slices):

            def build(k=k, sl=sl):
                arrays = futs[k].result() if futs is not None \
                    else _pack(sl)
                return self._enqueue(list(arrays), interval_hits,
                                     len(sl), [r[0] for r in sl])

            self._launch_wave(k, build)

    def collect(self) -> list:
        hit_jobs = self._kernel_hits()
        out = [self.jobs[i].payload for i in sorted(hit_jobs)]
        host_hits = self._host_hits(self.host_groups, _host_eval)
        out.extend(self.jobs[i].payload for i in sorted(host_hits))
        return out


class _ResidentSegment(_WaveSegment):
    def __init__(self, jobs: list, cdb, dev: torch.device, sink: dict,
                 ring, max_wave_rows: int):
        super().__init__(jobs, dev, sink, ring)
        (self.reps, self.members, kept, ranks, rows,
         self.host_groups) = _prep_resident(jobs, cdb, sink)
        if not kept:
            return
        w = max(1, int(max_wave_rows))
        # uploaded (once per device) on this thread's current stream,
        # which every wave's side stream waits for
        tables = cdb.device_tables(dev)

        def match(pkg_rank, row_idx):
            return interval_hits_resident(pkg_rank, row_idx, *tables)

        for k, a in enumerate(range(0, len(kept), w)):

            def build(a=a):
                sl_kept = kept[a:a + w]
                P = len(sl_kept)
                Pp = _job_bucket(P)
                pkg_rank = np.zeros(Pp, np.int32)
                row_idx = np.zeros(Pp, np.int32)
                pkg_rank[:P] = ranks[a:a + w]
                row_idx[:P] = rows[a:a + w]
                # the gather operands are this wave's alone; the
                # resident tables are shared and only read
                return self._enqueue([pkg_rank, row_idx], match, P,
                                     sl_kept, keep=tables)

            self._launch_wave(k, build)

    def collect(self) -> list:
        hit_jobs = self._kernel_hits()
        out = [self.jobs[i].payload for i in sorted(hit_jobs)]
        host_hits = self._host_hits(
            self.host_groups,
            lambda job: job.cdb.host_eval(job.row, job.pkg_version))
        out.extend(self.jobs[i].payload for i in sorted(host_hits))
        return out


class IntervalDispatch:
    """Handle returned by :func:`dispatch_jobs_async`; pass it to
    :func:`collect_dispatch` (exactly once) to fetch results."""

    def __init__(self):
        self.segments: list = []

    @property
    def waves(self) -> int:
        # eager (cpu-ref) segments count as one synchronous dispatch;
        # wave segments count their actual launches — a segment whose
        # jobs all took the host path launched ZERO waves
        return sum(len(s.waves) if hasattr(s, "waves") else 1
                   for s in self.segments)


def dispatch_jobs_async(jobs: list, backend: str = "cuda", mesh=None,
                        stats: Optional[dict] = None, ring=None,
                        max_wave_rows: Optional[int] = None) \
        -> IntervalDispatch:
    """Async half of :func:`dispatch_jobs`: dedup + compile + pack,
    then launch every wave without waiting for it. ``ring`` (a
    ``runtime.ring.DispatchRing``) bounds in-flight waves and collects
    them on its drain thread; without one the waves collect inside
    :func:`collect_dispatch` on the calling thread. Output (via
    collect_dispatch) is identical to dispatch_jobs for any wave size
    and ring depth. ``max_wave_rows`` defaults to ``_WAVE_ROWS``, read
    at the call. ``cpu-ref`` runs the synchronous numpy ladder now."""
    _no_mesh(mesh)
    dev = _device(backend)
    if max_wave_rows is None:
        max_wave_rows = _WAVE_ROWS
    sink = stats if stats is not None else last_dispatch_stats
    sink["device_s"] = 0.0
    sink["jobs_in"] = 0
    sink["jobs_unique"] = 0
    handle = IntervalDispatch()
    if dev is None:
        # the exact host reference engine has no device work to
        # overlap (the differential baseline stays the baseline)
        handle.segments.append(_EagerSegment(dispatch_jobs(
            jobs, backend=backend, stats=sink)))
        return handle
    plain = [j for j in jobs if isinstance(j, PairJob)]
    resident = [j for j in jobs if isinstance(j, ResidentPairJob)]
    if plain:
        handle.segments.append(_ClassicSegment(
            plain, dev, sink, ring, max_wave_rows))
    by_db: dict = {}
    for j in resident:
        by_db.setdefault(id(j.cdb), []).append(j)
    for js in by_db.values():
        handle.segments.append(_ResidentSegment(
            js, js[0].cdb, dev, sink, ring, max_wave_rows))
    return handle


def collect_dispatch(handle: IntervalDispatch) -> list:
    """Blocking half: wait for every wave (FIFO), fan hits out to the
    duplicate payloads, evaluate host-fallback pairs — the same
    output, in the same order, as the synchronous dispatcher. A
    wave's error is re-raised here."""
    out: list = []
    for seg in handle.segments:
        out.extend(seg.collect())
    return out
