"""Content-addressed findings memoization (copied from
``trivy_tpu/memo/``).

The blob cache (``artifact/cache.py``) memoizes per-layer
*analysis*; this package memoizes per-layer *detection verdicts*,
keyed by ``(layer blob id, advisory-DB fingerprint, secret rule-set
hash, ingest-guard config, scanner version)``. A fleet re-scan
dispatches only layers whose detection question was never answered;
a ``db update`` hot swap re-matches only the packages the advisory
delta touched (``db/delta.py``) against the new resident tables
instead of flushing the store.
"""

from .findings import FindingsMemo, MemoQuery, make_findings_memo
from .metrics import MEMO_METRICS
from .store import (FSMemoStore, MemoryMemoStore, RedisMemoStore,
                    ResilientMemoStore, S3MemoStore, make_memo_store)

__all__ = [
    "FindingsMemo", "MemoQuery", "make_findings_memo",
    "MEMO_METRICS", "MemoryMemoStore", "FSMemoStore",
    "RedisMemoStore", "S3MemoStore", "ResilientMemoStore",
    "make_memo_store",
]
