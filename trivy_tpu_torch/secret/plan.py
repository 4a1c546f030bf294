"""Per-rule scan plan: DFA pattern columns + anchor windows.

Built once per rule set; consumed by BatchSecretScanner. The plan
compiles the whole corpus into ONE multi-pattern DFA table
(trivy_tpu_torch.ops.dfa) — full-length gate keywords, anchor literals,
and each rule's best provably-mandatory fixed byte-class chain —
and records, per rule:

  - ``gate``: table columns of the rule's keywords (FULL length,
    lowercased — exactly the reference's MatchKeywords substring
    gate; the host exact scan re-applies it anyway). Rules without
    keywords always pass (scanner.go:164-168 returns true on an
    empty keyword list).
  - ``anchors`` + ``window``: when rx.anchor proves every match
    contains one of the anchor literals within a bounded span, the
    host only needs to regex windows around anchor hits.
  - ``chain``: a table column whose pattern every match of the rule
    PROVABLY contains (ops.dfa.best_fixed_chain over the
    elastic-stripped core AST). No chain hit anywhere in a file is a
    proof the rule cannot fire there — the rule resolves fully
    on-device, no host regex at all.
  - ``run_gate``: mandatory long class-runs for rules the window
    proof rejects (unchanged from the earlier engine).

Overlap contract (the hard error a silent straddle used to hide):
full-length patterns are only sound when the segment overlap covers
them — a literal longer than the overlap could sit across a segment
boundary and never fire, silently gating its rule OUT. build time
enforces it: any gate keyword longer than MAX_SIEVE_LITERAL raises
``PlanError`` naming the rule, and ``ScanPlan.min_overlap`` tells
the scanner the floor its overlap must clear
(``validate_overlap`` double-checks after seg-len rounding).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..ops.dfa import (MAX_LIT_BYTES, best_fixed_chain, build_table,
                       chain_len, chain_units)
from ..ops.runs import RunSpec
from .rx.anchor import analyze_rule, run_gates, strip_elastic
from .rx.parser import parse

# longest literal the sieve will match full-length; bounded so the
# required overlap stays ≤ a quarter segment at the default seg_len
MAX_SIEVE_LITERAL = MAX_LIT_BYTES
MAX_SIEVE_CHAIN = 48


class PlanError(ValueError):
    """A rule the sieve cannot soundly compile (build-time, loud)."""


@dataclass
class RulePlan:
    rule_index: int
    gate: frozenset               # table columns; empty = always pass
    anchored: bool = False
    anchors: list = field(default_factory=list)   # table columns
    window: int = 0               # bytes each side of an anchor hit
    exact: bool = False           # windowed verify is extraction-exact
    run_gate: list = field(default_factory=list)  # run-spec indices
    chain: Optional[int] = None   # table column, or None


@dataclass
class ScanPlan:
    table: object                 # ops.dfa.DfaTable
    rules: list                   # list[RulePlan], same order as input
    run_specs: list = field(default_factory=list)  # [RunSpec]
    min_overlap: int = 0          # longest pattern the sieve matches
    longest: tuple = ("", 0)      # (rule id, length) — error context

    @property
    def max_runlen(self) -> int:
        return max((s.runlen for s in self.run_specs), default=0)

    def validate_overlap(self, overlap: int) -> None:
        """Hard invariant: every compiled pattern fits inside the
        segment overlap, so no literal/anchor/chain can straddle an
        uncovered boundary (a straddle is a silent false NEGATIVE —
        the gated rule never fires)."""
        if overlap < self.min_overlap:
            rid, n = self.longest
            raise PlanError(
                f"segment overlap {overlap} < longest compiled "
                f"pattern ({n} bytes, rule {rid!r}) — a pattern "
                f"longer than the overlap can straddle segment "
                f"boundaries undetected")


def build_scan_plan(rules) -> ScanPlan:
    """``rules``: sequence of secret.model.Rule. Raises PlanError
    when a rule's gate keyword exceeds MAX_SIEVE_LITERAL — the sieve
    matches keywords FULL length, so an oversized keyword cannot be
    silently truncated without weakening the straddle guarantee the
    overlap provides."""
    analyses = []
    literals: list = []
    chains: list = []
    longest = ("", 0)
    for r in rules:
        kws = []
        for k in r.keywords:
            if not k:
                continue
            kb = k.lower().encode()
            if len(kb) > MAX_SIEVE_LITERAL:
                raise PlanError(
                    f"rule {r.id!r}: keyword {k!r} is {len(kb)} "
                    f"bytes — longer than MAX_SIEVE_LITERAL="
                    f"{MAX_SIEVE_LITERAL}; the sieve matches "
                    f"keywords full-length and the segment overlap "
                    f"cannot cover it (shorten the keyword — the "
                    f"regex still sees the full context)")
            kws.append(kb)
            if len(kb) > longest[1]:
                longest = (r.id, len(kb))
        ra = analyze_rule(r.regex.pattern) if r.regex is not None \
            else None
        if ra is not None and not ra.anchored:
            ra = None
        core = None
        if r.regex is not None:
            try:
                core, _ = strip_elastic(parse(r.regex.pattern))
            except Exception:
                core = None
        units = None
        # chain policy (cost-driven): anchored rules with an
        # extraction-EXACT window proof AND a selective anchor
        # already resolve on tiny merged spans — a chain would
        # mostly duplicate the anchor. The expensive host fallbacks
        # get the on-device chain gate: whole-file scans (unanchored
        # rules), prelim regexes (non-exact windows), and
        # weak-anchor rules (a ≤4-byte anchor like twilio's "SK"
        # windows half the corpus; the chain's token body kills
        # those files on device). Keeping the chain set small is
        # also what keeps the kernel's chain section near the
        # round-5 sieve cost on the CPU interpreter.
        weak_anchor = ra is not None and \
            min(len(a) for a in ra.literals) <= 4
        if core is not None and (
                ra is None or not ra.exact or weak_anchor):
            classes = best_fixed_chain(core)
            if classes is not None:
                units = chain_units(classes)
                n = chain_len(units)
                if n > MAX_SIEVE_CHAIN:
                    units = None
                elif n > longest[1]:
                    longest = (r.id, n)
        analyses.append((kws, ra, core, units))
        literals.extend(kws)
        if ra is not None:
            literals.extend(ra.literals)
        if units is not None:
            chains.append(units)

    table = build_table(literals, chains)
    run_specs: list = []
    spec_index: dict = {}
    plans = []
    for i, (kws, ra, core, units) in enumerate(analyses):
        rp = RulePlan(rule_index=i,
                      gate=frozenset(table.lit_col(k) for k in kws))
        if units is not None:
            rp.chain = table.chain_col(units)
        if ra is not None:
            rp.anchored = True
            rp.anchors = sorted({table.lit_col(a)
                                 for a in ra.literals})
            rp.window = ra.window
            rp.exact = ra.exact
        elif core is not None:
            # non-anchored: a mandatory long class-run is a sound
            # extra gate before the whole-file host scan
            try:
                gates = run_gates(core)
            except Exception:
                gates = []
            # drop dominated gates: (bs1, n1) filters nothing when
            # a (bs2 ⊆ bs1, n2 ≥ n1) gate exists — any run passing
            # the narrow gate passes the wide one
            gates = [
                (bs1, n1) for bs1, n1 in gates
                if not any(
                    (bs2, n2) != (bs1, n1) and bs2 <= bs1 and n2 >= n1
                    for bs2, n2 in gates)
            ]
            for bs, runlen in gates:
                spec = RunSpec.from_byteset(bs, runlen)
                if spec not in spec_index:
                    spec_index[spec] = len(run_specs)
                    run_specs.append(spec)
                rp.run_gate.append(spec_index[spec])
        plans.append(rp)

    min_overlap = max(
        [longest[1]]
        + [s.runlen for s in run_specs]
        + [len(x) for x in table.literals]) if (
            run_specs or table.literals or longest[1]) else 0
    return ScanPlan(table=table, rules=plans, run_specs=run_specs,
                    min_overlap=min_overlap, longest=longest)
