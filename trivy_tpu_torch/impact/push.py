"""Hot-swap push re-scans (reference: ``trivy_tpu/impact/push.py``;
docs/serving.md "CVE impact queries & push re-scans").

When ``db update`` hot-swaps a new advisory generation in, the memo's
delta re-match already knows EXACTLY which layers picked up new
verdicts. This module turns that knowledge into a push stream: the
index maps the newly-affected layers to their images/tenants, and
the pusher enqueues one high-priority, tenant-scoped
:class:`watch.source.PushEvent` per image onto the watch source the
server already runs. The event digest uses the same formula as the
registry/synthetic sources (``sha256(path)``), so a swap-storm push
folds into any pending or in-flight scan of the same image via the
loop's existing debounce — no duplicate device work.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading

from ..watch.metrics import WATCH_METRICS
from ..watch.source import PushEvent

log = logging.getLogger("trivy_tpu_torch.impact.push")

# above default watch traffic (0): a swap's re-scans answer "am I
# still compliant?" and jump the queue over routine pushes
IMPACT_RESCAN_PRIORITY = 50


class ImpactPusher:
    """Feeds newly-affected images into a watch source as
    high-priority re-scan events."""

    def __init__(self, source, priority: int = IMPACT_RESCAN_PRIORITY,
                 traceparent: str = ""):
        self.source = source
        self.priority = priority
        self.traceparent = traceparent
        self._lock = threading.Lock()
        self._n = 0

    def push(self, images) -> int:
        """``[(image_path, tenant), ...]`` → events on the source.
        Returns the number enqueued; counts into
        ``trivy_tpu_watch_impact_rescans_total``."""
        events = []
        with self._lock:
            for path, tenant in images:
                events.append(PushEvent(
                    digest="sha256:" + hashlib.sha256(
                        path.encode()).hexdigest(),
                    ref=os.path.basename(str(path)),
                    path=str(path),
                    tenant=tenant,
                    priority=self.priority,
                    event_id=f"impact-{self._n}",
                    traceparent=self.traceparent))
                self._n += 1
        if not events:
            return 0
        WATCH_METRICS.inc("impact_rescans", len(events))
        self.source.push_events(events)
        log.info("impact push: %d re-scan events queued",
                 len(events))
        return len(events)
