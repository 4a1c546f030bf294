"""Warm-state tracking for the elastic lifecycle (reference:
``trivy_tpu/memo/warmth.py``; docs/serving.md "Elastic lifecycle").

:class:`HotSet` — the bounded recency/refcount book of digests a
replica has served warm. The scan server touches it on every Scan RPC
and a draining replica exports it on ``GET /handoff`` so its ring
successors prefetch exactly the working set that is about to move.
The prewarm walk (``range_walk``) comes with the memo stores' bounded
key listing (ROADMAP A.9g).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List

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
