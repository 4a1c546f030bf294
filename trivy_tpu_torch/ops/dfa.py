"""Multi-pattern DFA engine for the secret sieve — compile once,
scan everything in one dispatch.

The whole rule corpus — full-length gate keywords, anchor literals,
and the provably-finite fixed subchains of the windowed patterns
from ``secret/rx`` — compiles into ONE table, and a single kernel
pass (``ops/dfa_cuda.py``) emits per-(segment, pattern) position
bitmasks.

Automaton shape. Every pattern is a *fixed chain*: states 1..k where
state ``i`` is reached from ``i-1`` iff the input byte lies in the
state's byte class. The transition table is therefore banded, and a
chain of k classes ends at position t iff all k membership tests pass
at t-k+1..t — so every state's transition is evaluated in parallel
per text position instead of walking ``state = T[state, byte]``
serially. Literal runs collapse to masked sliding-window word
compares (8 states per compare) and same-class runs collapse to
log-doubling erosion (ops/runs.py).

Soundness. The compiler only ever OVER-approximates: a pattern hit
is necessary for the rule's Python ``re`` to match, never sufficient
— every hit is re-verified by the CPU-exact scanner, and a miss is a
proof the rule cannot fire. Case: literal patterns match on
ASCII-lowercased text, class memberships run on raw bytes with the
AST's own folding.

Residency: ``DfaTable`` uploads its band arrays and the kernel's
chain descriptor once per device (ops/resident.py).
"""

from __future__ import annotations

import hashlib
import math
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import keywords
from .keywords import CODE_CHUNK, MAX_CODE_LEN, pack_code
from .resident import ResidentTables
from .runs import RunSpec, run_hits

MAX_LIT_BYTES = 32        # literal patterns: up to 4 masked words
MAX_CHAIN_LEN = 48        # fixed-chain cap — bounds segment overlap
MIN_CHAIN_BITS = 24.0     # selectivity floor to keep a chain
MAX_CLASS_RANGES = 8      # wider classes get gap-merged (superset)
REP_EXPAND_CAP = 96       # {m} repeat expansion cap, in positions


# ---------------------------------------------------------------------
# chain extraction: rx AST → fixed byte-class chains
# ---------------------------------------------------------------------

def _lower(b: int) -> int:
    return b + 32 if 65 <= b <= 90 else b


def _atoms(node) -> list:
    """Flatten an rx AST into a list of atoms: a tuple of per-byte
    classes (a FIXED stretch — every match threads through exactly
    these positions) or None (a VARIABLE stretch — chain breaker).
    Zero-width nodes vanish. Always an over-approximation: the
    fixed atoms are mandatory contiguous byte positions of every
    match of ``node``."""
    from ..secret.rx.parser import Alt, Boundary, Cat, Empty, Lit, Rep
    if isinstance(node, (Boundary, Empty)):
        return []
    if isinstance(node, Lit):
        # Unicode-aware units consume 1-4 bytes — variable
        return [(node.bytes,)] if node.ascii_only else [None]
    if isinstance(node, Cat):
        out: list = []
        for p in node.parts:
            out.extend(_atoms(p))
        return out
    if isinstance(node, Rep):
        sub = _atoms(node.node)
        if not sub:
            return []                       # repeat of zero-width
        if node.max is not None and node.min == node.max \
                and all(a is not None for a in sub):
            total = node.min * sum(len(a) for a in sub)
            if total <= REP_EXPAND_CAP:
                return [a for _ in range(node.min) for a in sub]
        return [None]
    if isinstance(node, Alt):
        flats = []
        for o in node.options:
            sub = _atoms(o)
            if any(a is None for a in sub):
                return [None]
            flats.append(tuple(c for a in sub for c in a))
        flats = [f for f in flats if f] or [()]
        if all(len(f) == len(flats[0]) for f in flats) \
                and len(flats) == len(node.options):
            # equal-length branches: positionwise class union is a
            # fixed superset (e.g. (test_|live_), (AKIA|ASIA|...))
            n = len(flats[0])
            return [tuple(frozenset().union(*(f[i] for f in flats))
                          for i in range(n))] if n else []
        return [None]
    raise TypeError(node)


def _bits(cls: frozenset) -> float:
    """Selectivity of one position in bits; case-pairs matched on
    lowered text count their folded width."""
    lows = {_lower(b) for b in cls}
    width = 2 * len(lows) if len(lows) < len(cls) or any(
        97 <= b <= 122 for b in lows) else len(cls)
    return math.log2(256 / min(256, max(1, width)))


def best_fixed_chain(node) -> Optional[tuple]:
    """The most selective fixed byte-class window (≤ MAX_CHAIN_LEN
    positions) that every match of ``node`` must contain
    contiguously — or None when nothing clears MIN_CHAIN_BITS.
    Returns a tuple of frozenset classes."""
    runs: list = []
    cur: list = []
    for a in _atoms(node):
        if a is None:
            if cur:
                runs.append(cur)
            cur = []
        else:
            cur.extend(a)
    if cur:
        runs.append(cur)
    best, best_score = None, 0.0
    for run in runs:
        bits = [_bits(c) for c in run]
        n = len(run)
        w = min(n, MAX_CHAIN_LEN)
        # best score window of width ≤ w (prefix sums)
        pre = [0.0]
        for b in bits:
            pre.append(pre[-1] + b)
        for i in range(n - w + 1) if n else ():
            score = pre[i + w] - pre[i]
            if score > best_score:
                best, best_score = tuple(run[i:i + w]), score
    if best is None or best_score < MIN_CHAIN_BITS:
        return None
    return best


def _merge_ranges(ranges: tuple) -> tuple:
    """Cap a class's range list at MAX_CLASS_RANGES by repeatedly
    merging the smallest gap — a byteset SUPERSET, so memberships
    stay a sound over-approximation."""
    rs = [list(r) for r in ranges]
    while len(rs) > MAX_CLASS_RANGES:
        gaps = [(rs[i + 1][0] - rs[i][1], i)
                for i in range(len(rs) - 1)]
        _, i = min(gaps)
        rs[i][1] = rs[i + 1][1]
        del rs[i + 1]
    return tuple((lo, hi) for lo, hi in rs)


def chain_units(classes: tuple) -> tuple:
    """Compile a fixed class chain into the band encoding the kernel
    evaluates: runs of literal-exact positions become ("lit", bytes)
    (masked word compares on lowered text); CONSECUTIVE class
    positions collapse into one ("run", ranges, n) over their byte
    UNION — a further sound over-approximation (any string matching
    the positioned classes is n bytes drawn from the union) that
    keeps the per-chain kernel work at one membership + one
    erosion per run instead of one per position."""
    units: list = []
    lit: list = []
    run: list = []               # [union byteset, length]

    def flush_lit():
        nonlocal lit
        if lit:
            units.append(("lit", bytes(lit)))
            lit = []

    def flush_run():
        nonlocal run
        if run:
            ranges = _merge_ranges(
                RunSpec.from_byteset(frozenset(run[0]), 1).ranges)
            units.append(("run", ranges, run[1]))
            run = []

    for cls in classes:
        lows = {_lower(b) for b in cls}
        if len(lows) == 1 and len(cls) <= 2:
            flush_run()
            lit.append(next(iter(lows)))
            continue
        flush_lit()
        if run:
            run = [run[0] | cls, run[1] + 1]
        else:
            run = [set(cls), 1]
    flush_lit()
    flush_run()
    return tuple(units)


def chain_len(units: tuple) -> int:
    return sum(len(u[1]) if u[0] == "lit" else u[2] for u in units)


# ---------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------

@dataclass(frozen=True)
class _LitGroup:
    chunks: int          # masked words per literal
    start: int           # first pattern column of this group
    count: int           # literals in the group


# kernel descriptor layout (int32; see csrc/dfa_blockmask.cu)
DESC_HEADER = 8          # n_groups, n_chains, n_sets, n_patterns,
                         # off_groups, off_chains, off_units, off_sets
UNIT_LIT, UNIT_RUN = 0, 1
SET_INTS = 1 + 2 * MAX_CLASS_RANGES


class DfaTable(ResidentTables):
    """One compiled multi-pattern table: literal patterns (full-length
    keywords + anchors, grouped by word-chunk count) followed by
    chain patterns. Pattern *columns* are the index space the scan
    plan stores; ``masks[:, col]`` is a 16-block position bitmask —
    START positions for literals, END positions for chains."""

    def __init__(self, literals: list, chains: list):
        # literals: lowercased bytes, 1..MAX_LIT_BYTES, deduped by
        # caller; chains: unit tuples from chain_units, deduped
        self._init_resident()
        order = sorted(range(len(literals)),
                       key=lambda i: (-(-len(literals[i]) //
                                        MAX_CODE_LEN), literals[i]))
        self.literals = tuple(literals[i] for i in order)
        self.chains = tuple(chains)
        self._lit_col = {b: c for c, b in enumerate(self.literals)}
        self._chain_col = {u: len(self.literals) + c
                           for c, u in enumerate(self.chains)}
        self.n_patterns = len(self.literals) + len(self.chains)

        self.groups: list = []
        self._arrays: list = []
        col = 0
        i = 0
        while i < len(self.literals):
            c = -(-len(self.literals[i]) // MAX_CODE_LEN)
            j = i
            while j < len(self.literals) and \
                    -(-len(self.literals[j]) // MAX_CODE_LEN) == c:
                j += 1
            group = self.literals[i:j]
            self.groups.append(_LitGroup(chunks=c, start=col,
                                         count=len(group)))
            self._arrays.extend(self._pack_group(group, c))
            col += len(group)
            i = j
        self.rules_hash = hashlib.sha256(
            repr((self.literals, self.chains)).encode()
        ).hexdigest()[:16]
        self._desc = None

    @classmethod
    def from_reference(cls, literals, chains, arrays) -> "DfaTable":
        """The table of another build of the same compiler, from what
        it exposes: its ordered ``literals``, its ``chains`` and its
        packed band arrays (numpy, 4 per literal group). The arrays
        must be the ones this compiler packs for those literals."""
        table = cls(list(literals), list(chains))
        if table.literals != tuple(literals):
            raise ValueError("literals are not in table order")
        mine = table._resident_band()
        if len(arrays) != len(mine) or any(
                np.asarray(a).shape != b.shape for a, b in
                zip(arrays, mine)):
            raise ValueError("band arrays do not fit the literals")
        table._arrays = [np.asarray(a, np.uint32) for a in arrays]
        return table

    @staticmethod
    def _pack_group(group: tuple, chunks: int) -> list:
        Kg = len(group)
        Kp = -(-Kg // CODE_CHUNK) * CODE_CHUNK
        lo = np.zeros((chunks, Kp), np.uint64)
        hi = np.zeros((chunks, Kp), np.uint64)
        lom = np.zeros((chunks, Kp), np.uint64)
        him = np.zeros((chunks, Kp), np.uint64)
        # pad columns must never hit: code 0 under a full mask only
        # matches 8 NULs, and pad columns are sliced off before any
        # consumer sees them anyway
        lom[0, Kg:] = him[0, Kg:] = 0xFFFFFFFF
        for k, lit in enumerate(group):
            for j in range(chunks):
                part = lit[j * MAX_CODE_LEN:(j + 1) * MAX_CODE_LEN]
                if not part:
                    continue            # trailing chunk: always-true
                lo[j, k], hi[j, k], lom[j, k], him[j, k] = \
                    pack_code(part)
        return [a.astype(np.uint32) for a in (lo, hi, lom, him)]

    # --- index space (the scan plan stores these columns) ---

    def lit_col(self, literal: bytes) -> int:
        return self._lit_col[literal.lower()]

    def chain_col(self, units: tuple) -> int:
        return self._chain_col[units]

    @property
    def max_chunks(self) -> int:
        cs = [g.chunks for g in self.groups]
        for units in self.chains:
            cs.extend(-(-len(u[1]) // MAX_CODE_LEN)
                      for u in units if u[0] == "lit")
        return max(cs, default=1)

    # --- residency ---

    def _resident_band(self) -> tuple:
        """The packed band arrays, 4 per literal group: (lo, hi,
        lo_mask, hi_mask), each [chunks, Kg padded to CODE_CHUNK]
        uint32."""
        return tuple(self._arrays)

    def _resident_arrays(self) -> tuple:
        # int64 copies of the band for the plain version (PyTorch's
        # CPU uint32 has no shifts or compares), then the kernel's
        # descriptor
        return tuple(a.astype(np.int64) for a in self._arrays) \
            + (self.kernel_desc(),)

    def kernel_desc(self) -> np.ndarray:
        """The flat int32 descriptor the CUDA kernel reads: literal
        groups with their packed words, and the chains as units over
        distinct byte-range sets — so one binary serves every rule
        set. Layout (all offsets in int32 elements from the start):

          header  n_groups n_chains n_sets n_patterns
                  off_groups off_chains off_units off_sets
          group   chunks col_start count word_off
                  (words: per literal, per chunk: lo hi lo_mask
                  hi_mask — real literals only, no pad columns)
          chain   col K n_units unit_off
          unit    kind off ulen param (lit: word_off, chunks =
                  ceil(ulen/8); run: set index)
          set     n_ranges lo0 hi0 lo1 hi1 ... (SET_INTS ints)
        """
        if self._desc is not None:
            return self._desc
        sets: dict = {}
        for units in self.chains:
            for u in units:
                if u[0] == "run":
                    sets.setdefault(u[1], len(sets))
        n_units = sum(len(u) for u in self.chains)
        off_groups = DESC_HEADER
        off_chains = off_groups + 4 * len(self.groups)
        off_units = off_chains + 4 * len(self.chains)
        off_sets = off_units + 4 * n_units
        off_words = off_sets + SET_INTS * len(sets)
        head: list = [len(self.groups), len(self.chains), len(sets),
                      self.n_patterns, off_groups, off_chains,
                      off_units, off_sets]
        grp: list = []
        words: list = []

        def add_words(data: bytes) -> int:
            at = off_words + len(words)
            for j in range(-(-len(data) // MAX_CODE_LEN)):
                words.extend(pack_code(
                    data[j * MAX_CODE_LEN:(j + 1) * MAX_CODE_LEN]))
            return at

        ai = 0
        for g in self.groups:
            lo, hi, lom, him = self._arrays[ai:ai + 4]
            ai += 4
            grp += [g.chunks, g.start, g.count,
                    off_words + len(words)]
            for k in range(g.count):
                for j in range(g.chunks):
                    words += [int(lo[j, k]), int(hi[j, k]),
                              int(lom[j, k]), int(him[j, k])]
        chn: list = []
        unt: list = []
        for ci, units in enumerate(self.chains):
            chn += [len(self.literals) + ci, chain_len(units),
                    len(units), off_units + len(unt)]
            off = 0
            for u in units:
                if u[0] == "lit":
                    unt += [UNIT_LIT, off, len(u[1]), add_words(u[1])]
                    off += len(u[1])
                else:
                    unt += [UNIT_RUN, off, u[2], sets[u[1]]]
                    off += u[2]
        st: list = []
        for ranges in sets:
            row = [len(ranges)] + [v for r in ranges for v in r]
            st += row + [0] * (SET_INTS - len(row))
        flat = head + grp + chn + unt + st + words
        self._desc = np.array(flat, np.int64).astype(np.uint32) \
            .view(np.int32)
        return self._desc


_TABLE_CACHE: dict = {}
_TABLE_LOCK = threading.Lock()
_TABLE_CACHE_MAX = 8


def build_table(literals, chains) -> DfaTable:
    """Compile (or fetch) the table for one rule corpus. Cached on
    the rule-set hash so every scanner instance built from the same
    rules shares one table — and therefore one device upload (a
    ``trivy-secret.yaml`` custom rule set compiles into its own
    cached table)."""
    lits = tuple(sorted({x.lower() for x in literals if x}))
    chs = tuple(sorted(set(chains), key=repr))
    fp = hashlib.sha256(repr((lits, chs)).encode()).hexdigest()
    evicted = []
    with _TABLE_LOCK:
        table = _TABLE_CACHE.get(fp)
        if table is None:
            table = DfaTable(list(lits), list(chs))
            _TABLE_CACHE[fp] = table
            while len(_TABLE_CACHE) > _TABLE_CACHE_MAX:
                evicted.append(_TABLE_CACHE.pop(
                    next(iter(_TABLE_CACHE))))
    for old in evicted:
        old.invalidate_device()
    return table


# ---------------------------------------------------------------------
# the sieve: ONE pass over a device-resident segment buffer
# ---------------------------------------------------------------------

def full_sieve(segments: torch.Tensor, table: DfaTable, dev: tuple,
               run_specs: tuple) -> tuple:
    """(masks [B, K] uint16, run_hits [B, n_specs] bool)."""
    from .dfa_cuda import dfa_blockmask
    masks = dfa_blockmask(segments, table, dev)
    return masks, run_hits(segments, run_specs)


def fused_sieve(segments: torch.Tensor, table: DfaTable, dev: tuple,
                run_specs: tuple) -> tuple:
    """Pattern blockmasks + class-run hits with the mask fetch
    COMPACTED to hit rows. Returns (nhit, idx, cmasks, run_hits):

      nhit   — int32 scalar, segments with ≥1 pattern hit
      idx    — [CAP] int64, their row indices (first nhit valid,
               ascending, the rest 0; CAP = min(SIEVE_CAP, B))
      cmasks — [CAP, K] uint16 blockmask rows for those segments
      hits   — [B, n_specs] bool class-run presence

    When nhit > CAP the compacted fetch is insufficient — callers
    fetch the full masks instead (``compact`` on ``full_sieve``'s
    output keeps them at hand)."""
    masks, hits = full_sieve(segments, table, dev, run_specs)
    return (*compact(masks), hits)


def compact(masks: torch.Tensor) -> tuple:
    """[B, K] uint16 blockmasks → (nhit, idx, cmasks) as
    ``fused_sieve`` returns them. A prefix sum and a scatter, so
    nothing here waits on the device."""
    B, K = masks.shape
    cap = min(keywords.SIEVE_CAP, B)
    seg_any = (masks != 0).any(dim=1) if K else \
        torch.zeros(B, dtype=torch.bool, device=masks.device)
    nhit = seg_any.sum(dtype=torch.int32)
    pos = torch.cumsum(seg_any, 0) - 1
    # hit rows go to their rank; every other row to a dump slot
    dest = torch.where(seg_any & (pos < cap), pos,
                       torch.full_like(pos, cap))
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=masks.device)
    idx.scatter_(0, dest, torch.arange(B, device=masks.device))
    idx = idx[:cap]
    # CUDA has no uint16 gather: gather the same bits as int16
    cmasks = masks.view(torch.int16)[idx].view(torch.uint16)
    return nhit, idx, cmasks


__all__ = [
    "MAX_LIT_BYTES", "MAX_CHAIN_LEN", "DfaTable", "build_table",
    "best_fixed_chain", "chain_units", "chain_len", "full_sieve",
    "fused_sieve", "compact",
]
