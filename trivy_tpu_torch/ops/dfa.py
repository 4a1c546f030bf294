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
descriptor once per device (ops/resident.py), and the descriptor that
adds a plan's run specs once per (device, run specs).
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
from .runs import RunSpec

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


# kernel descriptor layout (int32; see csrc/dfa_blockmask.cu and
# DfaTable.kernel_desc). Header slots:
(H_RUNS, H_SETS, H_EROS, H_UNITS, H_CHAINS, H_SPECS, H_PATTERNS,
 H_CLASS_WORDS, H_ERO_PASSES, H_OFF_RUNS, H_OFF_COLS, H_OFF_CLASS,
 H_OFF_EROS, H_OFF_CHAINS, H_OFF_TERMS, H_OFF_SPECS,
 H_OFF_WORDS) = range(17)
DESC_HEADER = 20         # header ints (a multiple of 4)
RUN_INTS = 4             # shape code, count, word offset, cols offset
ERO_INTS = 2             # set, n
CHAIN_INTS = 3           # column, n_terms, terms offset
TERM_INTS = 3            # kind, index, shift
TERM_LIT, TERM_RUN = 0, 1
MODE_COLUMN, MODE_BITS = 0, 1   # a run's output: block mask, bitmap
# the mask shape of a literal's last 8-byte chunk (every earlier chunk
# is compared under full masks): its length in that chunk is 8, 5-7,
# 4 or 1-3 bytes
TAIL_FF, TAIL_FP, TAIL_F0, TAIL_P0 = range(4)
DESC_MAX_CHUNKS = 4      # chunks per literal the kernel's loop takes
PIECE = DESC_MAX_CHUNKS * MAX_CODE_LEN   # longer chain lits are split
_FULL = 0xFFFFFFFF


def shape_code(chunks: int, tail: int, mode: int) -> int:
    """The kernel's switch index of a literal run."""
    return ((chunks - 1) * 4 + tail) * 2 + mode


def _lit_shape(chunks: list) -> tuple:
    """(C, tail) of one literal from its packed chunks (lo, hi,
    lo_mask, hi_mask): trailing always-true chunks (zero masks) are
    dropped, every other chunk but the last must be fully masked."""
    while chunks and chunks[-1][2] == 0 and chunks[-1][3] == 0:
        chunks = chunks[:-1]
    if not 1 <= len(chunks) <= DESC_MAX_CHUNKS or any(
            (c[2], c[3]) != (_FULL, _FULL) for c in chunks[:-1]):
        raise ValueError(f"literal of {len(chunks)} chunks has no "
                         f"kernel shape")
    lom, him = chunks[-1][2], chunks[-1][3]
    if lom == _FULL:
        tail = TAIL_FF if him == _FULL else \
            TAIL_F0 if him == 0 else TAIL_FP
    elif lom and not him:
        tail = TAIL_P0
    else:
        raise ValueError(f"chunk masks {lom:#x}, {him:#x} have no "
                         f"kernel shape")
    return len(chunks), tail


def erosion_steps(n: int) -> list:
    """The shift of each log-doubling step of an erosion by n (the
    order ``ops/runs.py::erode`` takes)."""
    steps, span = [], 1
    while span < n:
        steps.append(min(span, n - span))
        span += steps[-1]
    return steps


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
        self._descs: dict = {}       # run specs → kernel descriptor

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
        # CPU uint32 has no shifts or compares)
        return tuple(a.astype(np.int64) for a in self._arrays)

    def device_desc(self, device, run_specs: tuple = ()) -> torch.Tensor:
        """``kernel_desc(run_specs)`` on ``device``, uploaded once per
        (device, run specs)."""
        run_specs = tuple(run_specs)
        return self.device_array(device, ("desc", run_specs),
                                 lambda: self.kernel_desc(run_specs))

    def _literal_chunks(self):
        """(column, [(lo, hi, lo_mask, hi_mask) per chunk]) for every
        literal column, read from the band arrays."""
        ai = 0
        for g in self.groups:
            lo, hi, lom, him = self._arrays[ai:ai + 4]
            ai += 4
            for k in range(g.count):
                yield g.start + k, [
                    (int(lo[j, k]), int(hi[j, k]), int(lom[j, k]),
                     int(him[j, k])) for j in range(g.chunks)]

    def kernel_desc(self, run_specs: tuple = ()) -> np.ndarray:
        """The flat int32 descriptor the CUDA kernel reads, so one
        binary serves every rule set; ``run_specs`` (``RunSpec``s) add
        the class-run gate to the same launch. All offsets are in
        int32 elements from the start; the header slots are the
        ``H_*`` constants.

          runs    per literal run: shape_code(C, tail, mode), count,
                  word offset, cols offset. A run holds literals of
                  one mask shape: C 8-byte chunks, all but the last
                  under full masks, the last of shape ``tail``. Mode
                  COLUMN runs are the table's literals (cols: their
                  pattern columns, in table order); mode BITS runs are
                  the chains' lit units, cut into pieces of at most
                  PIECE bytes (cols: their unit bitmap).
          cols    one int per literal of every run
          class   [256, class_words] uint32: bit s of byte b is set
                  when b is in set s. The sets are the distinct byte
                  sets of the chains' run units and of the run specs.
          eros    per distinct (set, n) erosion: set, n
          chains  per chain: column, n_terms, terms offset; a term is
                  kind (TERM_LIT: a unit bitmap, TERM_RUN: an
                  erosion), its index and the shift right that moves
                  its START positions to the chain END
          specs   per run spec: its erosion
          words   16-byte aligned: per literal, per chunk: lo hi
                  lo_mask hi_mask
        """
        run_specs = tuple(run_specs)
        desc = self._descs.get(run_specs)
        if desc is None:
            desc = self._descs[run_specs] = self._build_desc(run_specs)
        return desc

    def _build_desc(self, run_specs: tuple) -> np.ndarray:
        sets: dict = {}      # membership bytes → set index
        eros: dict = {}      # (set, n) → erosion index
        pieces: dict = {}    # lit unit piece → unit index

        def erosion(ranges, n: int) -> int:
            member = np.zeros(256, bool)
            for lo, hi in ranges:
                member[lo:hi + 1] = True
            s = sets.setdefault(member.tobytes(), len(sets))
            return eros.setdefault((s, max(n, 1)), len(eros))

        chains: list = []
        terms: list = []
        for ci, units in enumerate(self.chains):
            K = chain_len(units)
            first = len(terms)
            off = 0
            for u in units:
                if u[0] == "lit":
                    data = u[1]
                    for j in range(0, len(data), PIECE):
                        ui = pieces.setdefault(data[j:j + PIECE],
                                               len(pieces))
                        terms.append((TERM_LIT, ui, K - 1 - off - j))
                    off += len(data)
                else:
                    terms.append((TERM_RUN, erosion(u[1], u[2]),
                                  K - 1 - off))
                    off += u[2]
            chains.append((len(self.literals) + ci, len(terms) - first,
                           first))
        specs = [erosion(s.ranges, s.runlen) for s in run_specs]

        # literal runs: table literals, then the chains' lit pieces,
        # each grouped by mask shape (columns keep table order inside)
        runs: dict = {}
        for col, chunks in self._literal_chunks():
            C, tail = _lit_shape(chunks)
            runs.setdefault(shape_code(C, tail, MODE_COLUMN), []) \
                .append((col, chunks[:C]))
        for piece, ui in pieces.items():
            chunks = [pack_code(piece[j:j + MAX_CODE_LEN])
                      for j in range(0, len(piece), MAX_CODE_LEN)]
            C, tail = _lit_shape(chunks)
            runs.setdefault(shape_code(C, tail, MODE_BITS), []) \
                .append((ui, chunks))

        W = -(-len(sets) // 32)
        cls = np.zeros((256, W), np.uint32)
        for key, s in sets.items():
            cls[np.frombuffer(key, bool), s // 32] |= np.uint32(1 << s % 32)
        n_lits = sum(len(r) for r in runs.values())
        off_runs = DESC_HEADER
        off_cols = off_runs + RUN_INTS * len(runs)
        off_class = off_cols + n_lits
        off_eros = off_class + cls.size
        off_chains = off_eros + ERO_INTS * len(eros)
        off_terms = off_chains + CHAIN_INTS * len(chains)
        off_specs = off_terms + TERM_INTS * len(terms)
        off_words = -(-(off_specs + len(specs)) // 4) * 4
        head = [0] * DESC_HEADER
        head[:17] = [
            len(runs), len(sets), len(eros), len(pieces), len(chains),
            len(specs), self.n_patterns, W,
            max([1] + [len(erosion_steps(n)) for _, n in eros]),
            off_runs, off_cols, off_class, off_eros, off_chains,
            off_terms, off_specs, off_words]
        run_rec: list = []
        cols: list = []
        words: list = []
        for code in sorted(runs):
            lits = runs[code]
            run_rec += [code, len(lits), off_words + len(words),
                        off_cols + len(cols)]
            for target, chunks in lits:
                cols.append(target)
                for c in chunks:
                    words.extend(c)
        flat = head + run_rec + cols + cls.ravel().tolist() \
            + [v for e in eros for v in e] \
            + [v for c in chains for v in c] \
            + [v for t in terms for v in t] + specs
        flat += [0] * (off_words - len(flat)) + words
        return np.array(flat, np.int64).astype(np.uint32).view(np.int32)


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
    """(masks [B, K] uint16, run_hits [B, n_specs] bool). On CUDA one
    kernel launch computes both (the class-run gate rides in the
    blockmask launch); on the CPU the plain versions do."""
    from .dfa_cuda import dfa_blockmask
    return dfa_blockmask(segments, table, dev, tuple(run_specs))


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
