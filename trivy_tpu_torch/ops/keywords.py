"""Literal packing and the literal-code sieve.

Sliding 8-byte windows of the ASCII-lowercased input are compared as
two 32-bit words, and a literal of up to 8 bytes is one masked compare
of those words. Each hit is reported as a 16-block position bitmask per
(segment, code): bit j means a hit that STARTS inside block j of
N_BLOCKS equal slices.

The literal-code sieve (``run_blockmask``, ``make_fused_sieve``,
``make_full_sieve``) tests a ``CodeTable`` of such codes: literals
truncated to 8 bytes, so a longer literal matches on its first 8 bytes
(a superset; host verification restores exactness). Its kernel is
``ops/keywords_cuda.py::code_blockmask``; ``code_blockmask_torch`` is
the same function in plain PyTorch, ``code_blockmask_host`` in numpy.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from .runs import run_hits, shift_left

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


# ---------------------------------------------------------------------
# the code table
# ---------------------------------------------------------------------

@dataclass(frozen=True)
class CodeTable:
    """Packed literal codes; column k of a blockmask is ``literals[k]``."""

    lo: np.ndarray        # [K] uint32 — window bytes 0-3
    hi: np.ndarray        # [K] uint32 — window bytes 4-7
    lo_mask: np.ndarray   # [K] uint32
    hi_mask: np.ndarray   # [K] uint32
    literals: tuple       # K lowercased byte-strings (≤8B, dedup, sorted)

    @property
    def n_codes(self) -> int:
        return len(self.literals)

    def index(self, literal: bytes) -> int:
        return self.literals.index(_truncate(literal))

    @property
    def codes(self) -> tuple:
        """The four arrays, padded to a multiple of CODE_CHUNK."""
        return _pad_codes((self.lo, self.hi, self.lo_mask, self.hi_mask))

    @classmethod
    def from_reference(cls, lo, hi, lo_mask, hi_mask, literals) \
            -> "CodeTable":
        """The table of another build of the same packer, from its
        arrays (numpy) and its ordered literals. The literals must be
        in table order and the arrays must fit them."""
        literals = tuple(literals)
        if build_code_table(literals).literals != literals:
            raise ValueError("literals are not a code table's: "
                             "lowercased, ≤8 bytes, deduped, sorted")
        arrs = [np.asarray(a) for a in (lo, hi, lo_mask, hi_mask)]
        if any(a.shape != (len(literals),) for a in arrs):
            raise ValueError("code arrays do not fit the literals")
        return cls(*(a.astype(np.uint32) for a in arrs),
                   literals=literals)


def build_code_table(literals) -> CodeTable:
    """Dedup + pack a set of byte-string literals."""
    uniq = sorted({_truncate(x) for x in literals if x})
    packed = [pack_code(x) for x in uniq]
    if not packed:
        packed = [(0, 0, 0xFFFFFFFF, 0xFFFFFFFF)]  # matches nothing
        uniq = [b"\x00\x00\x00\x00"]
    arr = np.array(packed, np.uint64).astype(np.uint32)
    return CodeTable(lo=arr[:, 0].copy(), hi=arr[:, 1].copy(),
                     lo_mask=arr[:, 2].copy(), hi_mask=arr[:, 3].copy(),
                     literals=tuple(uniq))


def _pad_codes(arrs: tuple) -> tuple:
    """Pad the four code arrays to a multiple of CODE_CHUNK columns.
    A pad code is 0 under full masks: it matches only a window of 8
    NULs (a NUL tail, a zero pad row), and every consumer slices its
    columns off."""
    K = arrs[0].shape[0]
    Kp = ((K + CODE_CHUNK - 1) // CODE_CHUNK) * CODE_CHUNK
    if Kp == K:
        return arrs
    out = []
    for i, a in enumerate(arrs):
        pad = np.zeros(Kp - K, a.dtype)
        if i >= 2:            # masks: full masks + code 0 ⇒ 8 NULs only
            pad = pad + np.uint32(0xFFFFFFFF)
        out.append(np.concatenate([np.asarray(a), pad]))
    return tuple(out)


def code_words(codes: tuple, device) -> torch.Tensor:
    """The kernel's code operand: the four [Kp] arrays as one
    contiguous 1-D int32 tensor (lo | hi | lo_mask | hi_mask, the
    uint32 bits unchanged) on ``device``."""
    flat = np.concatenate([np.asarray(c, np.uint32) for c in codes])
    return torch.from_numpy(flat.view(np.int32)).to(device)


# ---------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------

def window_words(segments: torch.Tensor) -> tuple:
    """[B, L] uint8 → (lo, hi) [B, L] int64: the little-endian words
    of the lowered bytes at position+0..3 and +4..7, zero past L."""
    # int64: PyTorch's uint32 has no shifts on the CPU
    x = segments.to(torch.int64)
    xl = torch.where((x >= 65) & (x <= 90), x + 32, x)
    sh = [shift_left(xl, i) for i in range(8)]
    lo = sh[0] | sh[1] << 8 | sh[2] << 16 | sh[3] << 24
    hi = sh[4] | sh[5] << 8 | sh[6] << 16 | sh[7] << 24
    return lo, hi


def block_bits(device) -> torch.Tensor:
    """[N_BLOCKS] int64: 1 << j."""
    return torch.ones(N_BLOCKS, dtype=torch.int64, device=device) \
        << torch.arange(N_BLOCKS, device=device)


def blockmask_bits(hits: torch.Tensor, bits: torch.Tensor) \
        -> torch.Tensor:
    """[B, L] bool → [B] int64 16-block position bitmask."""
    B, L = hits.shape
    hb = hits.reshape(B, N_BLOCKS, L // N_BLOCKS).any(dim=2)
    return (hb.to(torch.int64) * bits).sum(dim=1)


def _as_words(c, device) -> torch.Tensor:
    """A code array (numpy or tensor, any integer type) as int64
    holding its uint32 values."""
    t = c if isinstance(c, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(c))
    return t.to(device=device, dtype=torch.int64) & 0xFFFFFFFF


def _code_rows(segments: torch.Tensor, codes: tuple) -> torch.Tensor:
    lo, hi = window_words(segments)
    klo, khi, mlo, mhi = codes
    bits = block_bits(segments.device)
    out = torch.empty((segments.shape[0], klo.shape[0]),
                      dtype=torch.int64, device=segments.device)
    for k in range(klo.shape[0]):
        hit = ((lo & mlo[k]) == klo[k]) & ((hi & mhi[k]) == khi[k])
        out[:, k] = blockmask_bits(hit, bits)
    return out.to(torch.uint32)


def code_blockmask_torch(segments: torch.Tensor, lo_c, hi_c, lo_m, hi_m,
                         rows: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, L] uint8 segments × K
    codes → [B, K] uint32 blockmasks, on the segments' device, every
    column computed (pad codes too). ``rows`` segments at a time bound
    the int64 intermediates."""
    codes = tuple(_as_words(c, segments.device)
                  for c in (lo_c, hi_c, lo_m, hi_m))
    B = segments.shape[0]
    if B <= rows:
        return _code_rows(segments, codes)
    return torch.cat([_code_rows(segments[i:i + rows], codes)
                      for i in range(0, B, rows)])


def code_blockmask_host(segments, lo_c, hi_c, lo_m, hi_m):
    """NumPy version (the ``cpu-ref`` backend)."""
    B, L = segments.shape
    x = segments.astype(np.uint32)
    x = np.where((x >= 65) & (x <= 90), x + 32, x)
    pads = [np.pad(x[:, i:], ((0, 0), (0, i))) for i in range(8)]
    lo = pads[0] | pads[1] << 8 | pads[2] << 16 | pads[3] << 24
    hi = pads[4] | pads[5] << 8 | pads[6] << 16 | pads[7] << 24
    K = lo_c.shape[0]
    blk = L // N_BLOCKS
    out = np.zeros((B, K), np.uint32)
    for k in range(K):
        hit = (((lo & lo_m[k]) == lo_c[k])
               & ((hi & hi_m[k]) == hi_c[k]))         # [B, L]
        hb = hit.reshape(B, N_BLOCKS, blk).any(axis=2)
        out[:, k] = (hb.astype(np.uint32)
                     << np.arange(N_BLOCKS, dtype=np.uint32)).sum(axis=1)
    return out


# ---------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------

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


def run_blockmask(segments: np.ndarray, table: CodeTable,
                  backend: str = "cuda", device=None,
                  mesh=None) -> np.ndarray:
    """[B, L] uint8 segments → [B, K] uint32 blockmasks of ``table``.
    Pads the codes to the chunk size and the batch to a shape bucket,
    and slices the padding back off. ``backend`` is ``cuda`` (the
    kernel, on ``device`` or the current card), ``cpu`` (its plain
    PyTorch version) or ``cpu-ref`` (numpy). ``mesh`` (a
    ``DeviceMesh`` of ``backend``'s devices) runs one launch per (data,
    rules) block (``parallel.secret_shard.sharded_blockmask``);
    ``cpu-ref`` ignores it."""
    K = table.n_codes
    codes = table.codes
    if backend == "cpu-ref":
        return code_blockmask_host(segments, *codes)[:, :K]
    if mesh is not None:
        from ..parallel.mesh import check_mesh
        from ..parallel.secret_shard import sharded_blockmask
        if backend not in ("cuda", "cpu"):
            raise ValueError(f"unknown backend {backend!r}")
        check_mesh(mesh, backend)
        B = segments.shape[0]
        return sharded_blockmask(mesh, pad_batch(segments), codes)[:B, :K]
    if backend == "cpu":
        dev = torch.device("cpu")
    elif backend == "cuda":
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"backend 'cuda' on device {dev}")
    else:
        raise ValueError(f"unknown backend {backend!r}")
    from .keywords_cuda import code_blockmask
    B = segments.shape[0]
    seg = torch.from_numpy(np.ascontiguousarray(pad_batch(segments)))
    out = code_blockmask(seg.to(dev), code_words(codes, dev))
    return out[:B, :K].cpu().numpy()


def _sieve_blockmask_fn(literals: tuple, device: str):
    """Shared setup of the sieve factories: the code table, padded and
    staged on the device once, so the compacted and the full variant
    cannot drift apart. Returns (n_codes, blockmask_fn), the function
    giving [B, n_codes] uint16 masks (pad columns sliced off)."""
    from .keywords_cuda import code_blockmask
    table = build_code_table(literals)
    cdev = code_words(table.codes, resolve_device(device))
    n = table.n_codes

    def blockmask(segments: torch.Tensor) -> torch.Tensor:
        return code_blockmask(segments, cdev)[:, :n].to(torch.uint16)

    return n, blockmask


@functools.lru_cache(maxsize=8)
def make_fused_sieve(literals: tuple, run_specs: tuple, device: str):
    """One literal blockmask launch plus class-run hits over a
    device-resident [B, L] segment tensor, with the mask fetch
    COMPACTED to hit rows. The returned function gives

      nhit   — int32 scalar, segments with ≥1 code hit
      idx    — [CAP] int64, their row indices (first nhit valid,
               ascending, the rest 0; CAP = min(SIEVE_CAP, B))
      cmasks — [CAP, K] uint16 blockmask rows for those segments
      hits   — [B, n_specs] bool class-run presence

    Pad-code columns are sliced off BEFORE any row is counted as a
    hit: pad codes hit 8-NUL windows, which every zero pad row has.
    When nhit > CAP, callers fetch the full masks (make_full_sieve).
    Cached on (literals, run_specs, device)."""
    from .dfa import compact
    _, blockmask = _sieve_blockmask_fn(literals, device)

    def fused(segments: torch.Tensor) -> tuple:
        return (*compact(blockmask(segments)),
                run_hits(segments, run_specs))

    return fused


@functools.lru_cache(maxsize=8)
def make_full_sieve(literals: tuple, device: str):
    """Full-mask variant of make_fused_sieve: the whole [B, K] uint16
    mask array, no run hits."""
    return _sieve_blockmask_fn(literals, device)[1]
