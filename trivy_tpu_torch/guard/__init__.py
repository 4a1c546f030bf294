"""Resource governance for the untrusted-input ingest path.

A scan target is attacker-controlled bytes: a single
decompression-bomb layer, a million-entry tar, or a truncated gzip
must never hang a scan or OOM the host. This package is the budget
half of that contract:

* :mod:`budget` — per-scan :class:`ResourceBudget` (decompressed
  bytes with a compression-ratio tripwire, entry count, per-file
  size, path depth, per-stage wall-clock deadline) plus the typed
  :class:`GuardError` hierarchy every trip raises, and the
  process-wide :data:`GUARD_METRICS` counters;
* :mod:`safetar` — bounded tar/gzip readers (traversal and link
  escapes rejected after normpath, absurd/negative sizes rejected,
  streams decompressed chunk-wise so a bomb trips the byte budget
  instead of materializing) adopted by ``artifact/image.py`` and
  ``artifact/walker.py``.

A hard trip ends the target's scan with an ``error:`` line; a soft
fault marks its report ``degraded`` with an ``ingest``-stage cause.
``safetar.safe_extract_db_archive`` is the advisory-DB archive
extractor of ``db update`` (``db/lifecycle.py``).
"""

from .budget import (DEFAULT_LIMITS, GUARD_METRICS, GuardError,
                     GuardMetrics, IngestDeadlineExceeded,
                     MalformedArchiveError, ResourceBudget,
                     ResourceBudgetExceeded, ResourceLimits,
                     current_budget, make_budget)
from .safetar import (decompress_bounded, open_layer_bytes,
                      safe_extract_db_archive, validate_digest)

__all__ = [
    "DEFAULT_LIMITS", "GUARD_METRICS", "GuardError", "GuardMetrics",
    "IngestDeadlineExceeded", "MalformedArchiveError",
    "ResourceBudget", "ResourceBudgetExceeded", "ResourceLimits",
    "current_budget", "decompress_bounded", "make_budget",
    "open_layer_bytes", "safe_extract_db_archive", "validate_digest",
]
