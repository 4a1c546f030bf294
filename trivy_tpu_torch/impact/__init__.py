"""Fleet-wide inverted findings index: "which of my images did
CVE-X just break?" (reference: ``trivy_tpu/impact/``; docs/serving.md
"CVE impact queries & push re-scans").

* :mod:`impact.index` — the (package, CVE) → layers → images index,
  maintained write-through from the findings memo;
* :mod:`impact.federate` — the fan-out that unions
  replica slices into a fleet answer with Federator semantics;
* :mod:`impact.push` — hot-swap delta → high-priority re-scan
  events on the watch loop;
* :mod:`impact.metrics` — process-wide counters on ``GET /metrics``.
"""

from .federate import federated_impact, fetch_impact
from .index import (IMPACT_KEY_PREFIX, ImpactIndex,
                    brute_force_invert, entry_postings,
                    image_key, is_impact_key)
from .metrics import IMPACT_METRICS
from .push import IMPACT_RESCAN_PRIORITY, ImpactPusher

__all__ = [
    "IMPACT_KEY_PREFIX", "IMPACT_METRICS", "IMPACT_RESCAN_PRIORITY",
    "ImpactIndex", "ImpactPusher", "brute_force_invert",
    "entry_postings", "federated_impact", "fetch_impact",
    "image_key", "is_impact_key",
]
