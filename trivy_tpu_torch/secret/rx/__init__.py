"""Regex analysis pipeline for the device secret sieve.

parse → AST (over-approximating the RE2 subset the builtin rules use)
→ anchor/window/run-gate analysis (``rx.anchor``) consumed by
``trivy_tpu_torch.secret.plan`` to build the literal sieve + class-run gates.

The sieve is a *hit detector*: it can only over-approximate the rule
language. False positives are discarded by host-side exact
re-matching; false negatives are impossible by construction — the
parity property the whole device path rests on.
"""

from .parser import parse, RegexParseError
from .anchor import RuleAnchor, analyze_rule, run_gates, strip_elastic

__all__ = [
    "parse", "RegexParseError", "RuleAnchor", "analyze_rule",
    "run_gates", "strip_elastic",
]
