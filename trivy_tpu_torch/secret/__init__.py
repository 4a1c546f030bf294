"""Secret detection engine.

CPU path: exact reference semantics (pkg/fanal/secret/scanner.go).
Device path: the multi-pattern DFA sieve (trivy_tpu_torch.ops.dfa) +
class-run gates (trivy_tpu_torch.ops.runs) + sparse host verification,
orchestrated by trivy_tpu_torch.secret.batch.
"""

from .model import (
    Rule,
    AllowRule,
    ExcludeBlock,
    Location,
    SecretConfig,
    load_config,
)
from .scanner import Scanner, new_scanner
from .builtin_rules import BUILTIN_RULES, BUILTIN_ALLOW_RULES

__all__ = [
    "Rule", "AllowRule", "ExcludeBlock", "Location", "SecretConfig",
    "load_config", "Scanner", "new_scanner", "BUILTIN_RULES",
    "BUILTIN_ALLOW_RULES",
]
