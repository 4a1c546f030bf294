"""Shared retry-backoff policy pieces (reference:
``trivy_tpu/utils/backoff.py``).

Three clients speak the 429/503 + ``Retry-After`` language — the
registry client (``artifact/registry.py``), the RPC client
(``rpc/client.py``), and anything built on them. The policy lives
here ONCE: full jitter on an exponential base (a retrying fleet must
not re-synchronize onto the throttled server — AWS architecture-blog
"full jitter"), and a tolerant ``Retry-After`` parse (delta-seconds;
the HTTP-date form falls through to the jittered backoff).
"""

from __future__ import annotations

import random
from typing import Optional


def parse_retry_after(value) -> Optional[float]:
    """``Retry-After`` header/hint → seconds, or None when absent or
    in the HTTP-date form (callers fall back to jittered backoff)."""
    if value is None or value == "":
        return None
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        return None             # HTTP-date form: not handled here


def full_jitter_delay(attempt: int, base_s: float,
                      max_s: float) -> float:
    """One full-jitter exponential-backoff delay for ``attempt``
    (0-based): uniform in [0, min(max_s, base_s * 2**attempt))."""
    return min(max_s, base_s * (2 ** attempt)) * random.random()
