"""Bounded host worker pool for packing and decode work (reference:
``trivy_tpu/runtime/hostpool.py:30-92``).

One process-wide pool, sized to the host's spare cores, reserved for
tasks that NEVER block on scheduler events: segment-buffer packing
(secret/batch.py), SBOM decode (runtime/batch.py), the classic
interval waves' packing (detect/batch.py), and the direct path's
sieve enqueue. Tasks here are pure compute with no cross-task waits,
so the pool can be saturated safely from any thread. The pool starts
at its first use, never at import.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor

log = logging.getLogger("trivy_tpu_torch.runtime.hostpool")

THREAD_PREFIX = "trivy-hostpool"

_POOL = None
_LOCK = threading.Lock()


def pool_size() -> int:
    """Bounded: the spare cores past the two the device thread and
    main loop keep busy, capped at 8 — which disables the pool
    entirely on 1-2 core hosts, where extra threads only add GIL
    contention. ``TRIVY_TPU_HOST_POOL`` (the reference's knob, so a
    deployment's setting means the same in both packages) overrides;
    0 disables."""
    env = os.environ.get("TRIVY_TPU_HOST_POOL", "")
    if env:
        try:
            return max(0, int(env))
        except ValueError:
            log.warning("bad TRIVY_TPU_HOST_POOL=%r ignored", env)
    return min(8, max(0, (os.cpu_count() or 1) - 2))


def get_host_pool():
    """The shared packing/decode pool, or None when disabled."""
    global _POOL
    if _POOL is None:
        with _LOCK:
            if _POOL is None:
                n = pool_size()
                if n == 0:
                    return None
                _POOL = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix=THREAD_PREFIX)
    return _POOL


def on_pool_thread() -> bool:
    """True on a pool worker: a task that blocks on ``pool.map`` of
    its own pool deadlocks the moment every worker is such a task."""
    return threading.current_thread().name.startswith(THREAD_PREFIX)


def map_in_pool(fn, items: list, chunk: int = 1) -> list:
    """``[fn(x) for x in items]`` spread over the pool (input order
    preserved). Runs the inline loop when the pool is disabled, the
    batch is too small to amortize the hops, or the CALLER is itself
    a pool worker (the direct path's sieve enqueue runs here and then
    packs segments through here again). ``fn`` must capture its own
    errors — a raising task would abandon the batch.

    ``chunk > 1`` batches that many items per pool task, so that each
    hop amortizes over a real slab of work (decode callers pass 64)."""
    from ..detect.metrics import DETECT_METRICS
    pool = get_host_pool() \
        if len(items) > max(8, chunk) and not on_pool_thread() \
        else None
    if pool is None:
        return [fn(x) for x in items]
    if chunk > 1:
        slabs = [items[i:i + chunk]
                 for i in range(0, len(items), chunk)]
        DETECT_METRICS.inc("pack_tasks", len(slabs))
        out: list = []
        for part in pool.map(lambda slab: [fn(x) for x in slab],
                             slabs):
            out.extend(part)
        return out
    DETECT_METRICS.inc("pack_tasks", len(items))
    return list(pool.map(fn, items))
