"""Consistent-hash ring with bounded loads (reference:
``trivy_tpu/router/ring.py``; docs/serving.md "Scan router &
autoscaling").

Plain consistent hashing gives minimal key movement on membership
change (≤ K/N keys move when one of N replicas joins or leaves) but
no load guarantee: a hot layer digest — one base image shared by a
whole fleet push — lands on one replica and melts it. The
bounded-load variant (Mirrokni et al., "Consistent Hashing with
Bounded Loads") caps every node at

    capacity = ceil(capacity_factor * (total_load + 1) / n_nodes)

and walks the ring clockwise past saturated nodes, so the hot digest
spills to the NEXT ring owner instead of queueing. ``walk()`` exposes
the full clockwise owner order for a key, which is also the failover
order: the replay of a request whose owner died goes to exactly the
replica the spill would have chosen.

Hashing is ``blake2b`` (stdlib, stable across processes and runs —
ring placement must be deterministic so two router fronts sharded
over the same replica set agree on ownership without coordination,
and a replica of either package places every key where the other
does).
"""

from __future__ import annotations

import bisect
import hashlib
import math
import threading
from typing import Dict, List, Optional

DEFAULT_VNODES = 64
DEFAULT_CAPACITY_FACTOR = 1.25


def _point(data: str) -> int:
    h = hashlib.blake2b(data.encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class Ring:
    """Consistent-hash ring over named nodes, bounded-load aware.

    The ring itself is load-agnostic storage plus deterministic
    placement; the bounded-load decision takes the caller's live
    load view (``loads``) at lookup time so the router can pass its
    in-flight book without the ring holding mutable request state.
    """

    def __init__(self, vnodes: int = DEFAULT_VNODES,
                 capacity_factor: float = DEFAULT_CAPACITY_FACTOR):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        if capacity_factor <= 1.0:
            raise ValueError("capacity_factor must be > 1.0")
        self.vnodes = vnodes
        self.capacity_factor = capacity_factor
        self._lock = threading.Lock()
        self._points: List[int] = []      # sorted vnode hash points
        self._owner: Dict[int, str] = {}  # point -> node name
        self._nodes: set = set()

    # --- membership ---

    def add(self, node: str) -> None:
        with self._lock:
            if node in self._nodes:
                return
            self._nodes.add(node)
            for i in range(self.vnodes):
                p = _point(f"{node}#{i}")
                # blake2b-64 collisions across a fleet-sized node set
                # are ~impossible; keep first owner if one happens so
                # placement stays deterministic
                if p not in self._owner:
                    self._owner[p] = node
                    bisect.insort(self._points, p)

    def remove(self, node: str) -> None:
        with self._lock:
            if node not in self._nodes:
                return
            self._nodes.discard(node)
            dead = [p for p, n in self._owner.items() if n == node]
            for p in dead:
                del self._owner[p]
            self._points = sorted(self._owner)

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        with self._lock:
            return node in self._nodes

    # --- placement ---

    def walk(self, key: str) -> List[str]:
        """Distinct nodes in clockwise ring order from the key's
        point: element 0 is the plain consistent-hash owner, the
        rest is the spill/failover order."""
        with self._lock:
            if not self._points:
                return []
            start = bisect.bisect_right(self._points, _point(key))
            seen: List[str] = []
            have: set = set()
            n = len(self._points)
            for i in range(n):
                owner = self._owner[self._points[(start + i) % n]]
                if owner not in have:
                    have.add(owner)
                    seen.append(owner)
                    if len(have) == len(self._nodes):
                        break
            return seen

    def owner(self, key: str) -> Optional[str]:
        w = self.walk(key)
        return w[0] if w else None

    def capacity(self, loads: Dict[str, int]) -> int:
        """Bounded-load per-node cap for the current membership and
        the caller's live load view (total in-flight requests)."""
        with self._lock:
            n = len(self._nodes)
        if n == 0:
            return 0
        total = sum(max(0, v) for v in loads.values())
        return max(1, math.ceil(
            self.capacity_factor * (total + 1) / n))

    def assign(self, key: str, loads: Dict[str, int],
               exclude: Optional[set] = None) -> Optional[str]:
        """Bounded-load owner: first node on the clockwise walk that
        is not excluded and is under capacity. If every eligible
        node is saturated (can happen transiently when loads are
        counted by the caller mid-flight), fall back to the least
        loaded eligible node rather than refusing — admission
        control proper lives on the replicas."""
        cap = self.capacity(loads)
        eligible = [n for n in self.walk(key)
                    if not exclude or n not in exclude]
        if not eligible:
            return None
        for n in eligible:
            if loads.get(n, 0) < cap:
                return n
        return min(eligible, key=lambda n: (loads.get(n, 0), n))


def movement(keys: List[str], before: Ring, after: Ring) -> float:
    """Fraction of keys whose plain owner changed between two rings —
    the reshard-movement metric the ≤ K/N bound is asserted on."""
    if not keys:
        return 0.0
    moved = sum(1 for k in keys if before.owner(k) != after.owner(k))
    return moved / len(keys)
