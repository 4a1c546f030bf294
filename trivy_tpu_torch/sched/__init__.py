"""Continuous-batching scan scheduler (reference: ``trivy_tpu/sched/``;
docs/serving.md).

Decouples request arrival from device dispatch: a bounded admission
queue with per-request deadlines feeds a coalescer that aggregates
work into padding-bucketed device batches, executed by a two-stage
pipeline that overlaps host preprocessing of batch N+1 with device
execution of batch N: the ``dfa_blockmask`` sieve and the interval
waves of a batch are launched from the executor thread and collected
on a dispatch ring's drain thread, each behind its own CUDA event.
"""

from .coalescer import Batch, Coalescer, SchedConfig
from .metrics import LatencyHistogram, SchedMetrics
from .queue import (AnalyzedWork, DeadlineExceeded, QueueFullError,
                    RequestCancelled, ScanRequest, SchedError,
                    SchedulerClosed)
from .scheduler import ScanScheduler
from .tenant import (RateLimitedError, TenancyConfig, TenantConfig,
                     TenantQueue, TokenBucket, parse_tenant_config)

# compatibility alias: the bounded FIFO admission queue is the
# tenancy-aware queue with its default (single anonymous tenant,
# unlimited) config — exactly the old behavior
AdmissionQueue = TenantQueue

__all__ = [
    "AdmissionQueue", "AnalyzedWork", "Batch", "Coalescer",
    "DeadlineExceeded", "LatencyHistogram", "QueueFullError",
    "RateLimitedError", "RequestCancelled", "ScanRequest",
    "ScanScheduler", "SchedConfig", "SchedError", "SchedMetrics",
    "SchedulerClosed", "TenancyConfig", "TenantConfig",
    "TenantQueue", "TokenBucket", "parse_tenant_config",
]
