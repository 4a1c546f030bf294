"""Warm-state tracking for the elastic lifecycle (reference:
``trivy_tpu/memo/warmth.py``; docs/serving.md "Elastic lifecycle").

:class:`HotSet` — the bounded recency/refcount book of digests a
replica has served warm. The scan server touches it on every Scan RPC
and a draining replica exports it on ``GET /handoff`` so its ring
successors prefetch exactly the working set that is about to move.

:func:`range_walk` — the prewarm walk: iterate a shared memo tier's
keys (``scan_keys``, the bounded listing every memo store
implements), keep the ones a predicate says the post-join ring
assigns to the joining replica, fetch and stage each, all under a
monotonic deadline. A degraded memo tier (outage mid-walk,
breaker-open resilient store, deadline hit) returns a PARTIAL
summary — prewarm is an optimization, so the caller degrades to a
cold join rather than wedging the scale-up.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional

DEFAULT_HOT_CAP = 4096


class HotSet:
    """Bounded recency-ordered digest book with refcounts.

    ``touch`` on every warm-path hit/insert keeps the order LRU-ish
    (oldest first, hottest last); eviction beyond ``cap`` drops the
    coldest entry, so ``export()`` is always the replica's current
    working set, never an unbounded history. Refcounts ride along
    for observability and break the capping tie when two digests
    share a recency window.
    """

    def __init__(self, cap: int = DEFAULT_HOT_CAP):
        self.cap = max(1, cap)
        self._lock = threading.Lock()
        self._d: OrderedDict = OrderedDict()  # digest -> refcount

    def touch(self, digest: str) -> None:
        if not digest:
            return
        with self._lock:
            self._d[digest] = self._d.get(digest, 0) + 1
            self._d.move_to_end(digest)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)

    def discard(self, digest: str) -> None:
        with self._lock:
            self._d.pop(digest, None)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, digest: str) -> bool:
        with self._lock:
            return digest in self._d

    def export(self, limit: int = 0) -> List[str]:
        """Recency order, coldest first / hottest last (the
        ``/handoff`` payload contract). ``limit`` keeps the hottest
        tail."""
        with self._lock:
            out = list(self._d)
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    def snapshot(self) -> dict:
        with self._lock:
            n = len(self._d)
            refs = sum(self._d.values())
        return {"entries": n, "cap": self.cap, "touches": refs}


def range_walk(store, owned: Callable[[str], bool],
               deadline_s: float,
               stage: Optional[Callable[[str, bytes], None]] = None,
               prefix: str = "",
               limit: int = 0) -> dict:
    """Walk a shared memo tier for the keys ``owned`` selects,
    staging each via ``stage(key, payload)``, bounded by
    ``deadline_s`` of monotonic wall time.

    Returns ``{"keys", "bytes", "seconds", "complete",
    "deadline_exceeded"}``. ``complete`` is False when the listing
    was partial (backend outage — the resilient store's
    miss-never-error contract), a fetch failed, or the deadline cut
    the walk short; the caller treats partial as "join colder than
    planned", never as an error.
    """
    t0 = time.monotonic()
    out = {"keys": 0, "bytes": 0, "seconds": 0.0,
           "complete": True, "deadline_exceeded": False}

    def _expired() -> bool:
        return (deadline_s > 0
                and time.monotonic() - t0 >= deadline_s)

    try:
        keys, complete = store.scan_keys(prefix=prefix, limit=limit)
    except (OSError, ValueError, RuntimeError):
        # a raw (non-resilient) backend mid-outage: degrade to the
        # cold join, exactly like an empty listing
        keys, complete = [], False
    out["complete"] = bool(complete)
    for key in keys:
        if _expired():
            out["deadline_exceeded"] = True
            out["complete"] = False
            break
        if not owned(key):
            continue
        try:
            payload = store.get(key)
        except (OSError, ValueError, RuntimeError):
            payload = None
        if payload is None:
            # resilient stores answer outage with a miss; count the
            # walk as partial but keep going — later keys may live
            # on a healthy shard
            out["complete"] = False
            continue
        if stage is not None:
            stage(key, payload)
        out["keys"] += 1
        out["bytes"] += len(payload)
    out["seconds"] = round(time.monotonic() - t0, 6)
    return out
