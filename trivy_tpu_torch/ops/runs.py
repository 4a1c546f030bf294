"""Class-run detection — the run-gate stage of the secret sieve.

For each spec (byte class, run length R): does the segment contain R
consecutive bytes all in the class? Elementwise membership compares
plus log-doubling erosion (AND of left-shifted masks), in plain
PyTorch on whatever device the segments live on.

Segments must overlap by ≥ max run length so straddling runs appear
whole in one segment (secret.batch sizes the overlap from the plan).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RunSpec:
    ranges: tuple        # ((lo, hi), ...) inclusive byte ranges
    runlen: int

    @classmethod
    def from_byteset(cls, bs: frozenset, runlen: int) -> "RunSpec":
        ranges = []
        for b in sorted(bs):
            if ranges and b == ranges[-1][1] + 1:
                ranges[-1][1] = b
            else:
                ranges.append([b, b])
        return cls(ranges=tuple((lo, hi) for lo, hi in ranges),
                   runlen=runlen)


def shift_left(a: torch.Tensor, k: int) -> torch.Tensor:
    """a[:, i] ← a[:, i+k], zero-filled at the tail."""
    if k == 0:
        return a
    out = torch.zeros_like(a)
    out[:, :-k] = a[:, k:]
    return out


def membership(x: torch.Tensor, ranges) -> torch.Tensor:
    """[B, L] int → bool: byte lies in one of the inclusive ranges."""
    m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for lo, hi in ranges:
        m |= (x == lo) if lo == hi else ((x >= lo) & (x <= hi))
    return m


def erode(m: torch.Tensor, n: int) -> torch.Tensor:
    """e[i] = AND of m[i..i+n-1] (log-doubling shifts)."""
    e = m
    span = 1
    while span < n:
        step = min(span, n - span)
        e = e & shift_left(e, step)
        span += step
    return e


def run_hits(segments: torch.Tensor, specs: tuple) -> torch.Tensor:
    """[B, L] uint8 → [B, n_specs] bool run detector."""
    x = segments.to(torch.int32)
    cols = [erode(membership(x, spec.ranges), spec.runlen).any(dim=1)
            for spec in specs]
    if not cols:
        return torch.zeros((segments.shape[0], 0), dtype=torch.bool,
                           device=segments.device)
    return torch.stack(cols, dim=1)
