"""Circuit-broken cache: a backend outage costs throughput, never
availability (reference: ``trivy_tpu/artifact/resilient.py``).

``ResilientCache`` wraps a remote cache backend (``redis_cache``,
``s3_cache``) with a :class:`CircuitBreaker` and a local
``MemoryCache`` fallback. Semantics:

* every WRITE mirrors into the fallback first, so anything this
  process has produced stays readable through an outage that starts
  mid-scan (the scheduled pipeline puts blobs in one phase and reads
  them in a later one);
* successful primary READS are mirrored too (read-through, LRU-capped
  at ``MIRROR_CAP``), so a layer served from the remote cache before
  the outage remains served after it;
* when the breaker is open, every op answers from the fallback —
  ``missing_blobs`` reports anything the fallback lacks as missing,
  which degrades a cache hit into a re-analysis (throughput cost),
  never into an error or a silently dropped layer;
* each failed primary op is a ``cache_degraded`` event on the active
  span and a count in ``breaker_stats()``;
* after ``cooldown_s`` the breaker goes half-open and lets exactly
  one probe op through to the primary; success closes the circuit
  (and records the outage duration), failure re-opens it.

The one case that cannot be answered correctly — a read the fallback
has never seen while the primary is down — returns the "miss" answer
(None / missing), which re-analysis upstream makes correct. A degrade
moves only where blobs are stored: the walk, the sieve and the
interval match run where they run without it. The memo store
(``memo/store.py``) reuses the breaker.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Optional

from ..obs.trace import add_event
from .cache import MemoryCache

log = logging.getLogger("trivy_tpu_torch.cache.resilient")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Consecutive-failure trip, cooldown, half-open single probe."""

    def __init__(self, fail_threshold: int = 3,
                 cooldown_s: float = 5.0,
                 clock=time.monotonic):
        self.fail_threshold = max(1, fail_threshold)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        self.trips: list = []        # [{"opened_at", "recovered_s"}]

    def allow(self) -> bool:
        """May the caller try the primary right now? In half-open,
        only one concurrent probe gets True."""
        with self._lock:
            if self.state == CLOSED:
                return True
            now = self._clock()
            if self.state == OPEN and \
                    now - self._opened_at >= self.cooldown_s:
                self.state = HALF_OPEN
                self._probe_inflight = False
            if self.state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self.state != CLOSED:
                recovered = self._clock() - self._opened_at
                self.trips.append({"opened_at": self._opened_at,
                                   "recovered_s": round(recovered, 4)})
                log.info("circuit closed after %.2fs outage",
                         recovered)
            self.state = CLOSED
            self._probe_inflight = False
            self._opened_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == HALF_OPEN:
                # failed probe: back to open, re-arm the cooldown
                self.state = OPEN
                self._opened_at = self._clock()
                self._probe_inflight = False
            elif self.state == CLOSED and \
                    self._failures >= self.fail_threshold:
                self.state = OPEN
                self._opened_at = self._clock()
                log.warning("circuit OPEN after %d consecutive "
                            "failures", self._failures)

    def stats(self) -> dict:
        with self._lock:
            out = {"state": self.state,
                   "consecutive_failures": self._failures,
                   "trips": len(self.trips) +
                   (1 if self.state != CLOSED and
                    self._opened_at is not None else 0),
                   "recoveries": list(self.trips)}
            if self.state != CLOSED and self._opened_at is not None:
                out["open_for_s"] = round(
                    self._clock() - self._opened_at, 4)
            return out


class ResilientCache:
    """The cache interface, degraded-not-down over a flaky primary."""

    # RedisError and S3Error subclass ConnectionError
    FAILURES = (ConnectionError, TimeoutError, OSError)

    # read-through mirrors are disposable insurance; cap them so a
    # warm-cache fleet scan does not duplicate its whole working set
    # in process RAM. Local WRITES are pinned (read-your-writes).
    MIRROR_CAP = 4096

    def __init__(self, primary, breaker: Optional[CircuitBreaker] = None,
                 name: str = ""):
        self.primary = primary
        self.fallback = MemoryCache()
        self.breaker = breaker or CircuitBreaker()
        # the log's name of the primary (the fault injector's wrap
        # says "fault-injected")
        self.name = name or type(primary).__name__
        self._lock = threading.Lock()
        self._pinned: set = set()          # blob ids written locally
        self._mirrored: OrderedDict = OrderedDict()  # LRU of mirrors
        self.counters = {"primary_ops": 0, "fallback_ops": 0,
                         "primary_errors": 0}

    def _inc(self, k: str) -> None:
        with self._lock:
            self.counters[k] += 1

    def _try_primary(self, op: str, *args):
        """(ok, value) — ok False means "use the fallback"."""
        if not self.breaker.allow():
            return False, None
        self._inc("primary_ops")
        try:
            v = getattr(self.primary, op)(*args)
        except self.FAILURES as e:
            if getattr(e, "integrity", False):
                # cache INCONSISTENCY (e.g. S3IntegrityError), not
                # an outage: surfacing it loudly is the point —
                # tripping the breaker would hide it and take a
                # healthy backend offline
                raise
            self._inc("primary_errors")
            self.breaker.record_failure()
            # visible in the request's trace
            add_event("cache_degraded", op=op, error=repr(e),
                      breaker=self.breaker.state)
            log.warning("%s %s failed (%r); degrading to %s",
                        self.name, op, e,
                        type(self.fallback).__name__)
            return False, None
        self.breaker.record_success()
        return True, v

    # --- writes: fallback first, then best-effort primary ---

    def put_artifact(self, artifact_id: str, info) -> None:
        self.fallback.put_artifact(artifact_id, info)
        ok, _ = self._try_primary("put_artifact", artifact_id, info)
        if not ok:
            self._inc("fallback_ops")

    def put_blob(self, blob_id: str, blob) -> None:
        self.fallback.put_blob(blob_id, blob)
        with self._lock:
            self._pinned.add(blob_id)
            self._mirrored.pop(blob_id, None)
        ok, _ = self._try_primary("put_blob", blob_id, blob)
        if not ok:
            self._inc("fallback_ops")

    def _mirror_blob(self, blob_id: str, blob) -> None:
        """LRU-capped read-through: keeps outage coverage for hot
        blobs without duplicating the whole remote working set."""
        with self._lock:
            if blob_id in self._pinned:
                return
            self._mirrored[blob_id] = None
            self._mirrored.move_to_end(blob_id)
            evict = []
            while len(self._mirrored) > self.MIRROR_CAP:
                evict.append(self._mirrored.popitem(last=False)[0])
        self.fallback.put_blob(blob_id, blob)
        if evict:
            self.fallback.delete_blobs(evict)

    # --- reads: primary with read-through mirror, else fallback ---

    def get_artifact(self, artifact_id: str):
        ok, v = self._try_primary("get_artifact", artifact_id)
        if ok and v is not None:
            self.fallback.put_artifact(artifact_id, v)
            return v
        if not ok:
            self._inc("fallback_ops")
        # a healthy-primary MISS still consults the fallback: a
        # record written during an outage lives only there, and
        # read-your-writes must hold across the recovery boundary
        return self.fallback.get_artifact(artifact_id)

    def get_blob(self, blob_id: str):
        ok, v = self._try_primary("get_blob", blob_id)
        if ok and v is not None:
            self._mirror_blob(blob_id, v)
            return v
        if not ok:
            self._inc("fallback_ops")
        return self.fallback.get_blob(blob_id)

    def missing_blobs(self, artifact_id: str, blob_ids: list) -> tuple:
        ok, v = self._try_primary("missing_blobs", artifact_id,
                                  blob_ids)
        if not ok:
            # degraded answer: anything the local fallback lacks gets
            # re-analyzed — correctness preserved, throughput paid
            self._inc("fallback_ops")
            return self.fallback.missing_blobs(artifact_id, blob_ids)
        missing_artifact, missing = v
        if missing or missing_artifact:
            # union view: a record written during an outage lives
            # only in the fallback; it is PRESENT (get falls through
            # to it), so do not force a pointless re-analysis
            fb_art, fb_missing = self.fallback.missing_blobs(
                artifact_id, missing)
            missing = list(fb_missing)
            missing_artifact = missing_artifact and fb_art
        return missing_artifact, missing

    def delete_blobs(self, blob_ids: list) -> None:
        with self._lock:
            for b in blob_ids:
                self._pinned.discard(b)
                self._mirrored.pop(b, None)
        self.fallback.delete_blobs(blob_ids)
        ok, _ = self._try_primary("delete_blobs", blob_ids)
        if not ok:
            self._inc("fallback_ops")

    def clear(self) -> None:
        clear = getattr(self.fallback, "clear", None)
        if clear is not None:
            clear()
        if hasattr(self.primary, "clear"):
            self._try_primary("clear")

    def breaker_stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        return {"backend": self.name, **counters,
                "breaker": self.breaker.stats()}
