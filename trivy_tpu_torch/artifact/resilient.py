"""The circuit breaker of the memo store (copied from
``trivy_tpu/artifact/resilient.py``: ``CircuitBreaker`` alone).

Consecutive failures open the circuit; after ``cooldown_s`` it goes
half-open and lets exactly one probe through to the primary; success
closes it (and records the outage duration), failure re-opens it. The
remote blob caches that the reference puts behind it
(``ResilientCache`` over Redis, S3 and the RPC cache) are ROADMAP
A.9f.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

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
