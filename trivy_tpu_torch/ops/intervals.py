"""Vectorized version-interval membership — the package→CVE match.

The host parses every version string once, ranks it within its
grammar's total order, and compiles each advisory's constraints into
≤M intervals in a DOUBLED rank space (bound = 2·rank, exclusivity =
±1). "Is version v vulnerable to advisory a" is then int32 compares
over a [P, M] table, the same for every grammar and for both the
library and the OS-package detectors.

Semantics bits per pair (flags):
  bit0 has_vulnerable_constraints
  bit1 force (empty-string constraint ⇒ always vulnerable)
  bit2 has_secure_constraints (patched + unaffected)

out = force | (has_vuln ? vuln_any & (has_sec ? ¬sec_any : 1)
                        : (has_sec ? ¬sec_any : 0))

Ported from ``trivy_tpu/ops/intervals.py``, where these are XLA-jitted
functions (no Pallas kernel). Here they are plain PyTorch on whatever
device their tensors lie on: ``interval_hits`` for per-dispatch
tables, ``interval_hits_resident`` for a gather of candidate rows from
the tables a ``CompiledDB`` keeps resident, and ``interval_hits_host``
(numpy) for the ``cpu-ref`` backend. Neither torch function writes to
its inputs: per-dispatch payloads are fresh tensors, and the resident
tables serve every dispatch of their generation unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_INTERVALS = 4          # per side; host falls back past this
NEG_INF = -(2 ** 31) + 1
POS_INF = 2 ** 31 - 1


def interval_hits(pkg_rank: torch.Tensor, vuln_lo: torch.Tensor,
                  vuln_hi: torch.Tensor, sec_lo: torch.Tensor,
                  sec_hi: torch.Tensor,
                  flags: torch.Tensor) -> torch.Tensor:
    """[P] int32 ranks × [P, M] int32 interval tables → [P] bool
    vulnerable."""
    r = pkg_rank[:, None]
    vuln_any = ((vuln_lo <= r) & (r <= vuln_hi)).any(dim=1)
    sec_any = ((sec_lo <= r) & (r <= sec_hi)).any(dim=1)
    has_vuln = (flags & 1) != 0
    force = (flags & 2) != 0
    has_sec = (flags & 4) != 0
    not_sec = ~(has_sec & sec_any)          # where(has_sec, ~sec, True)
    without_vuln = has_sec & ~sec_any       # where(has_sec, ~sec, False)
    return force | torch.where(has_vuln, vuln_any & not_sec, without_vuln)


def interval_hits_resident(pkg_rank: torch.Tensor, row_idx: torch.Tensor,
                           vuln_lo: torch.Tensor, vuln_hi: torch.Tensor,
                           sec_lo: torch.Tensor, sec_hi: torch.Tensor,
                           flags: torch.Tensor) -> torch.Tensor:
    """Resident-table variant: the [N, M] advisory tables stay on the
    device across scans; each dispatch gathers only its candidate rows
    (``row_idx``, int32 or int64). [P] ranks + [P] row indices → [P]
    bool."""
    return interval_hits(pkg_rank, vuln_lo.index_select(0, row_idx),
                         vuln_hi.index_select(0, row_idx),
                         sec_lo.index_select(0, row_idx),
                         sec_hi.index_select(0, row_idx),
                         flags.index_select(0, row_idx))


def interval_hits_host(pkg_rank, vuln_lo, vuln_hi, sec_lo, sec_hi,
                       flags) -> np.ndarray:
    """NumPy reference (the ``cpu-ref`` backend)."""
    r = pkg_rank[:, None]
    vuln_any = ((vuln_lo <= r) & (r <= vuln_hi)).any(axis=1)
    sec_any = ((sec_lo <= r) & (r <= sec_hi)).any(axis=1)
    has_vuln = (flags & 1).astype(bool)
    force = (flags & 2).astype(bool)
    has_sec = (flags & 4).astype(bool)
    not_sec = np.where(has_sec, ~sec_any, True)
    without_vuln = np.where(has_sec, ~sec_any, False)
    return force | np.where(has_vuln, vuln_any & not_sec,
                            without_vuln)
