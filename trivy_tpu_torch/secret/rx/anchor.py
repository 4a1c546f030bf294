"""Anchor-literal extraction: the static analysis behind windowed verify.

For each rule regex we try to prove: *every* match contains one of a
small set of literal byte-strings (the rule's "anchors"). When that
holds and the match length is bounded, the device keyword kernel's hit
positions for those literals bound every possible match location — the
host then only has to regex small windows around hits instead of whole
files. Rules where the proof fails (unbounded matches, alternation too
wide) fall back to reference behavior: whole-file regex whenever the
rule's keyword gate passes (pkg/fanal/secret/scanner.go:341-417 runs
the regex over full content after MatchKeywords).

Soundness: ``anchor_literals`` returns S only if every string matched
by the (case-folded) regex contains ≥1 element of S as a substring;
``max_match_len`` returns a finite M only if no match exceeds M bytes.
Both are proved compositionally over the parsed AST.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .parser import Alt, Boundary, Cat, Empty, Lit, Rep, parse

INF = float("inf")

MAX_ANCHOR_SET = 64       # most alternatives a candidate set may hold
MAX_PRODUCT = 40          # give up productizing classes past this
MIN_ANCHOR_LEN = 3        # anchors shorter than this match too often
MAX_ANCHOR_LEN = 8        # keyword-kernel code width
MAX_CLASS_FANOUT = 16     # productize byte classes up to this size


def max_match_len(node) -> float:
    """Upper bound on the BYTE length of any match. INF if unbounded.

    The AST is parsed over bytes, but rule regexes run on decoded
    text (Scanner.scan) where one pattern unit like ``.`` consumes one
    *character* — up to 4 UTF-8 bytes. A Lit whose class can reach
    non-ASCII therefore counts 4 bytes, keeping byte-sliced windows
    sound for matches containing multibyte characters."""
    if isinstance(node, (Boundary, Empty)):
        return 0
    if isinstance(node, Lit):
        return 1 if (node.ascii_only
                     and all(b < 0x80 for b in node.bytes)) else 4
    if isinstance(node, Cat):
        return sum(max_match_len(p) for p in node.parts)
    if isinstance(node, Alt):
        return max(max_match_len(o) for o in node.options)
    if isinstance(node, Rep):
        if node.max is None:
            inner = max_match_len(node.node)
            return 0 if inner == 0 else INF
        return node.max * max_match_len(node.node)
    raise TypeError(node)


_SPACE = frozenset(b" \t\n\r\f\v")


def _is_space_run(node) -> bool:
    return (isinstance(node, Rep) and node.max is None
            and isinstance(node.node, Lit)
            and node.node.bytes <= _SPACE)


def _is_edge_boundary(node, kind: str) -> bool:
    if isinstance(node, Boundary):
        return node.kind == kind
    if isinstance(node, Cat):
        return len(node.parts) == 1 and _is_edge_boundary(
            node.parts[0], kind)
    return False


def _elastic_edge(node, kind: str) -> bool:
    """True if ``node`` is an *edge-elastic* context guard: an unbounded
    pure-whitespace run, optionally alternated with the matching anchor
    (``^`` for prefix, ``$`` for suffix) or ε.

    Soundness of dropping it from the window bound: any window slice
    that truncates the whitespace run still matches — a sub-run of
    whitespace is whitespace, and the ``^``/``$``/ε alternative (or
    ``min=0``) covers the cut landing exactly at the core edge. A
    windowed ``re.search`` therefore finds a (possibly shorter) match
    whenever the full text had one. False positives are fine — every
    prelim hit is re-verified by a whole-file exact scan.
    """
    if _is_space_run(node):
        # bare run: sound with window slack ≥2 — the slice always
        # retains ≥1 run byte (or the run was empty and min==0)
        return True
    if isinstance(node, Alt):
        has_edge = any(
            _is_edge_boundary(o, kind) or isinstance(o, Empty)
            for o in node.options)
        runs_ok = all(
            _is_space_run(o) or _is_edge_boundary(o, kind)
            or isinstance(o, Empty)
            for o in node.options)
        return has_edge and runs_ok
    return False


def _edge_run_min(node) -> int:
    """Window widening for a stripped elastic edge: the slice must
    retain ``min`` COMPLETE whitespace characters for re.search to
    succeed (``\\s{30,}`` needs 30 visible). ``\\s`` is Unicode-aware
    (up to 4 bytes/char) and the slice cut can split one character,
    hence 4·(min+1)+3 bytes rather than ``min``."""
    m = 0
    if _is_space_run(node):
        m = node.min
    elif isinstance(node, Alt):
        m = max((o.min for o in node.options if _is_space_run(o)),
                default=0)
    return 4 * (m + 1) + 3


def strip_elastic(node) -> tuple:
    """Drop edge-elastic prefix/suffix guards from a top-level Cat;
    returns ``(core, extra_window)`` — window math happens on the
    core, widened by the stripped runs' minimum lengths."""
    if not isinstance(node, Cat) or not node.parts:
        return node, 0
    parts = list(node.parts)
    extra = 0
    while parts and (_elastic_edge(parts[0], "^")
                     or _is_space_run(parts[0])):
        extra += _edge_run_min(parts.pop(0))
    while parts and (_elastic_edge(parts[-1], "$")
                     or _is_space_run(parts[-1])):
        extra += _edge_run_min(parts.pop())
    return (Cat(parts) if parts else Empty()), extra


def _lower_byte(b: int) -> int:
    return b + 32 if 65 <= b <= 90 else b


def _class_lowered(bs: frozenset) -> frozenset:
    return frozenset(_lower_byte(b) for b in bs)


def _product(runs: list, cls: frozenset) -> Optional[list]:
    """Extend every partial string by every byte of ``cls`` (lowered)."""
    lowered = sorted(_class_lowered(cls))
    if len(runs) * len(lowered) > MAX_PRODUCT:
        return None
    return [r + bytes([b]) for r in runs for b in lowered]


_COMMON_LITERALS = {b"https://", b"http://", b"https:/", b"http:/",
                    b"www."}


@dataclass
class _Cand:
    """One candidate anchor set with a quality score."""

    literals: list            # list[bytes], lowercased

    @property
    def min_len(self) -> int:
        return min(len(x) for x in self.literals)

    @property
    def score(self) -> tuple:
        # a set made only of ubiquitous literals would make every web
        # page a candidate window — rank it below anything specific
        common = all(x in _COMMON_LITERALS for x in self.literals)
        # extra length raises specificity, but every literal is one
        # more kernel pass — one distinctive 4-byte anchor beats a
        # 36-way productized 5-byte set
        return (not common,
                min(self.min_len, 8) - 0.12 * len(self.literals))


def _literal_strings(node) -> Optional[list]:
    """All strings of L(node), lowercased — or None if not a small
    finite literal language (used to push runs through alternations
    like ``(test|live)``)."""
    if isinstance(node, Empty) or (isinstance(node, Boundary)):
        return [b""]
    if isinstance(node, Lit):
        # Unicode-aware units (\d, [^…], .) can match characters the
        # byte product cannot enumerate — never productize them
        if not node.ascii_only:
            return None
        lowered = sorted(_class_lowered(node.bytes))
        if len(lowered) > MAX_CLASS_FANOUT:
            return None
        return [bytes([b]) for b in lowered]
    if isinstance(node, Cat):
        acc = [b""]
        for p in node.parts:
            sub = _literal_strings(p)
            if sub is None or len(acc) * len(sub) > MAX_ANCHOR_SET:
                return None
            acc = [a + s for a in acc for s in sub]
        return acc
    if isinstance(node, Alt):
        acc = []
        for o in node.options:
            sub = _literal_strings(o)
            if sub is None:
                return None
            acc.extend(sub)
            if len(acc) > MAX_ANCHOR_SET:
                return None
        return acc
    if isinstance(node, Rep):
        if node.max is None or node.min != node.max:
            return None
        sub = _literal_strings(node.node)
        if sub is None:
            return None
        acc = [b""]
        for _ in range(node.min):
            if len(acc) * len(sub) > MAX_ANCHOR_SET:
                return None
            acc = [a + s for a in acc for s in sub]
        return acc
    return None


def _cat_run_candidates(parts: list) -> list:
    """Literal-run candidates inside a concatenation: consecutive
    mandatory parts with small finite literal languages, productized.
    A run flushes when a part is optional, unbounded, or fans out too
    wide to productize."""
    out: list = []
    cur: list = [b""]

    def flush():
        nonlocal cur
        if any(len(r) >= MIN_ANCHOR_LEN for r in cur):
            lits = [r[:MAX_ANCHOR_LEN] for r in cur]
            out.append(_Cand(sorted(set(lits))))
        cur = [b""]

    for p in parts:
        if isinstance(p, (Boundary, Empty)):
            continue                       # zero-width: run stays contiguous
        strs = _literal_strings(p)
        if strs is not None and all(len(s) > 0 for s in strs):
            if all(len(r) < MAX_ANCHOR_LEN for r in cur):
                if len(cur) * len(strs) <= MAX_ANCHOR_SET:
                    cur = [r + s for r in cur for s in strs]
                    continue
            # run already saturated: keep it, start fresh with this part
            flush()
            if len(strs) <= MAX_ANCHOR_SET:
                cur = list(strs)
            continue
        # a mandatory class repeat can rescue a run still below the
        # usable length by contributing its first byte
        # (SK[0-9a-f]{32} → "sk"+hexdigit) — never dilute longer runs
        if (isinstance(p, Rep) and p.min >= 1
                and isinstance(p.node, Lit) and p.node.ascii_only
                and any(0 < len(r) < MIN_ANCHOR_LEN for r in cur)):
            ext = _product(cur, p.node.bytes)
            if ext is not None:
                cur = ext
        flush()
    flush()
    return [c for c in out if c.min_len >= MIN_ANCHOR_LEN]


def anchor_literals(node) -> Optional[list]:
    """Set S of lowercased literals such that every match contains some
    s ∈ S — or None if no usable S is found."""
    cand = _best_candidate(node)
    return cand.literals if cand is not None else None


def _best_candidate(node) -> Optional[_Cand]:
    if isinstance(node, (Boundary, Empty, Lit)):
        # single-byte anchors are below MIN_ANCHOR_LEN
        if isinstance(node, Lit):
            return None
        return None
    if isinstance(node, Cat):
        cands = _cat_run_candidates(node.parts)
        # recursing into composite parts can find better anchors
        # (e.g. a Cat of [prefix-classes, Alt-of-literals, suffix])
        for p in node.parts:
            if isinstance(p, (Alt, Cat)) or (
                    isinstance(p, Rep) and p.min >= 1):
                sub = _best_candidate(p)
                if sub is not None:
                    cands.append(sub)
        if not cands:
            return None
        return max(cands, key=lambda c: c.score)
    if isinstance(node, Alt):
        branches = []
        total = 0
        for o in node.options:
            sub = _best_candidate(o)
            if sub is None:
                return None              # one branch unanchorable → fail
            branches.append(sub)
            total += len(sub.literals)
        if total > 2 * MAX_ANCHOR_SET:
            return None
        merged = sorted(set(x for b in branches for x in b.literals))
        return _Cand(merged)
    if isinstance(node, Rep):
        if node.min >= 1:
            return _best_candidate(node.node)
        return None
    raise TypeError(node)


MIN_RUN_GATE = 16         # shortest class-run worth a device gate
MAX_RUN_GATE = 64         # cap (also bounds required segment overlap)
MIN_CHAIN_GATE = 8        # shorter chains allowed when the byteset...
MAX_CHAIN_SET = 20        # ...stays this narrow (specificity holds)


def _chain_unit(node):
    """(byteset, min_len) for a chain-combinable part, or None.

    A part joins a contiguous-run chain when every byte it can
    contribute is a known ASCII set: a literal/class, or a bounded or
    unbounded repeat of one (an unbounded repeat only *adds* bytes from
    its set — min contribution still node.min). Zero-width parts keep
    the chain contiguous without contributing."""
    if isinstance(node, (Boundary, Empty)):
        return frozenset(), 0
    if isinstance(node, Lit):
        return (node.bytes, 1) if node.ascii_only else None
    if isinstance(node, Rep) and isinstance(node.node, Lit) \
            and node.node.ascii_only:
        return node.node.bytes, node.min
    return None


def _chain_gates(parts: list) -> list:
    """Run gates from chains of consecutive classifiable parts: every
    match contains the parts' contributions CONTIGUOUSLY, so it
    contains a run of ≥ Σ min_len bytes drawn from the byteset union
    (e.g. ``[0-9]{4}-?[0-9]{4}-?[0-9]{4}`` → 12 bytes of [0-9-]).
    Narrow unions qualify at MIN_CHAIN_GATE; anything at MIN_RUN_GATE."""
    out = []
    bs: frozenset = frozenset()
    total = 0

    def flush():
        nonlocal bs, total
        if bs and (total >= MIN_RUN_GATE
                   or (total >= MIN_CHAIN_GATE
                       and len(bs) <= MAX_CHAIN_SET)):
            out.append((bs, min(total, MAX_RUN_GATE)))
        bs, total = frozenset(), 0

    for p in parts:
        u = _chain_unit(p)
        if u is None:
            flush()
            continue
        bs |= u[0]
        total += u[1]
    flush()
    return out


def run_gates(node) -> list:
    """Mandatory long class-runs: every match must contain ``runlen``
    consecutive bytes all drawn from ``byteset``. A sound NECESSARY
    condition used to gate whole-file host scans of rules the window
    proof rejects (e.g. aws-secret-access-key's 40-char base64 body).

    Returns [(byteset, runlen)] — possibly several; all must hold.
    Only spine-mandatory repeats count (an optional or alternated run
    proves nothing)."""
    out = []
    if isinstance(node, Rep):
        if node.min >= 1:
            # Unicode-aware classes (\d \w \s: ascii_only=False) match
            # multibyte codepoints the ASCII byteset can't see — a
            # byte-run gate built from them would create false
            # negatives (e.g. 16 Arabic-Indic digits match \d{16} with
            # zero ASCII-digit bytes). Only ASCII-exact units gate.
            if isinstance(node.node, Lit) and node.node.ascii_only \
                    and node.min >= MIN_RUN_GATE:
                out.append((node.node.bytes,
                            min(node.min, MAX_RUN_GATE)))
            else:
                out.extend(run_gates(node.node))
    elif isinstance(node, Cat):
        out.extend(_chain_gates(node.parts))
        for p in node.parts:
            out.extend(run_gates(p))
    elif isinstance(node, Alt):
        # a run mandatory in EVERY branch is mandatory; keep the
        # common (byteset, len≥) pairs conservatively: only when all
        # branches yield an identical gate
        branch_gates = [run_gates(o) for o in node.options]
        if branch_gates and all(branch_gates):
            first = set(branch_gates[0])
            for bg in branch_gates[1:]:
                first &= set(bg)
            out.extend(sorted(first, key=lambda g: -g[1]))
    return out


@dataclass
class RuleAnchor:
    """Verification plan for one rule."""

    anchored: bool
    literals: list            # lowercased anchor literals (if anchored)
    window: int               # max match length bound (if anchored)
    exact: bool = False       # windowed finditer == whole-file finditer


def _has_hard_boundary(node) -> bool:
    """``^``/``$`` make matching position-dependent beyond the match
    bytes themselves, so windowed extraction cannot be exact."""
    if isinstance(node, Boundary):
        return node.kind in ("^", "$")
    if isinstance(node, Cat):
        return any(_has_hard_boundary(p) for p in node.parts)
    if isinstance(node, Alt):
        return any(_has_hard_boundary(o) for o in node.options)
    if isinstance(node, Rep):
        return _has_hard_boundary(node.node)
    return False


def analyze_rule(pattern: str, max_window: int = 2048) -> RuleAnchor:
    """Build the verification plan for one rule regex.

    ``max_window`` caps how large a bounded match we are willing to
    verify through windows — beyond that, whole-file is cheaper.

    ``exact`` upgrade: when no elastic edge was stripped (extra == 0)
    and the core has no ``^``/``$``, a finditer restricted to the
    merged anchor windows returns byte-identical matches to a
    whole-file finditer, so the host never re-scans the whole file.
    Proof sketch: every match contains an anchor occurrence q and fits
    in [q-window, q+window]; the kernel reports every occurrence of
    every anchor, each contributing a window that the batch layer
    merges with overlapping neighbours — so for any position p where
    the engine attempts a match inside a region, all bytes any attempt
    from p can examine (≤ window, quantifiers all bounded) lie inside
    that same merged region, with ≥8 bytes of slack for ``\\b``
    look-around at the edges. Region-wise finditer therefore visits
    the same (position, match) sequence as whole-file finditer.
    """
    try:
        ast, extra = strip_elastic(parse(pattern))
    except Exception:
        return RuleAnchor(False, [], 0)
    m = max_match_len(ast)
    if m == INF or m > max_window:
        return RuleAnchor(False, [], 0)
    lits = anchor_literals(ast)
    if not lits:
        return RuleAnchor(False, [], 0)
    exact = extra == 0 and not _has_hard_boundary(ast)
    # +2 slack keeps the edge-elastic soundness argument (a truncated
    # whitespace run must retain ≥min+1 bytes inside the window).
    return RuleAnchor(True, lits, int(m) + extra + 2, exact)
