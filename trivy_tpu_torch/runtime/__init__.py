"""Batch scan runtime (reference: ``trivy_tpu/runtime/``): the fleet's
direct path.

The batch IS the unit: every image's secret candidates share one sieve
launch, every image's (package, advisory) pairs share one interval
dispatch, split into waves that a bounded ``DispatchRing`` keeps in
flight on a CUDA side stream while the host packs the next
(``batch.py``, ``ring.py``); packing and decode spread over a bounded
host pool (``hostpool.py``).
"""

from .batch import BatchScanResult, BatchScanRunner

__all__ = ["BatchScanRunner", "BatchScanResult"]
