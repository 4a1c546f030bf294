"""Literal packing for the secret sieve: sliding 8-byte windows of the
ASCII-lowercased input are compared as two 32-bit words, and a
literal of up to 8 bytes is one masked compare of those words.

Each hit is reported as a 16-block position bitmask per (segment,
pattern): bit j means a hit inside block j of N_BLOCKS equal slices.
"""

from __future__ import annotations

import numpy as np

N_BLOCKS = 16          # position resolution: L/16 bytes per block
CODE_CHUNK = 8         # literal band arrays pad to this many columns
MAX_CODE_LEN = 8       # two uint32 words per window

SIEVE_CAP = 4096       # compacted-fetch capacity (hit segments)


def _truncate(literal: bytes) -> bytes:
    return literal.lower()[:MAX_CODE_LEN]


def pack_code(literal: bytes) -> tuple:
    """(lo, hi, lo_mask, hi_mask) for one ≤8-byte lowercased literal."""
    b = _truncate(literal)
    m = len(b)
    if not 0 < m <= MAX_CODE_LEN:
        raise ValueError(f"literal of {m} bytes cannot be packed")
    lo = int.from_bytes(b[:4].ljust(4, b"\0"), "little")
    hi = int.from_bytes(b[4:].ljust(4, b"\0"), "little")
    lo_mask = (1 << (8 * min(m, 4))) - 1
    hi_mask = ((1 << (8 * (m - 4))) - 1) if m > 4 else 0
    return lo, hi, lo_mask, hi_mask


def _bucket(n: int, base: int = 256, cap: int = 4096) -> int:
    """Round batch sizes up to a small set of shapes (pad rows are
    zeros — they match nothing real). Powers of two from ``base`` up
    to ``cap``, then ``cap``-steps."""
    b = base
    while b < n and b < cap:
        b *= 2
    if n <= b:
        return b
    return ((n + cap - 1) // cap) * cap


def pad_batch(segments: np.ndarray) -> np.ndarray:
    B = segments.shape[0]
    Bp = _bucket(B)
    if Bp == B:
        return segments
    return np.concatenate(
        [segments, np.zeros((Bp - B, segments.shape[1]),
                            segments.dtype)])
