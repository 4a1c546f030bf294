"""Deterministic fault injection (reference: ``trivy_tpu/faults/``;
docs/robustness.md).

The fault layer has two halves: :class:`FaultSpec` (the seeded,
declarative scenario — what breaks, how often) and
:class:`FaultInjector` (the runtime hooks the pipeline's failure
domains consult). It exercises the robustness machinery it ships next
to — the circuit-broken cache fallback (``artifact/resilient.py``),
poison-image quarantine in the scheduler, degraded-mode reports,
idempotent RPC retries, graceful drain — under reproducible failure,
from the tests and the CLI (``--fault-spec`` on the ``image`` fleet,
``server``, ``watch`` and ``route``). The route faults
(``replica-kill``, ``replica-flaky``) drill the scan router
(``router/``); the other entries take them and inject nothing at
their own sites, as the reference's do.
"""

from .hostile import (BUILDERS as HOSTILE_BUILDERS, EXPECTED_STATUS,
                      build_corpus, corrupt_boltdb_layout,
                      hostile_limits)
from .inject import (CacheFault, CorruptLayerFault, DeviceFault,
                     FaultInjector, FaultyCache, InjectedFault)
from .spec import SCENARIOS, FaultSpec, parse_fault_spec

__all__ = [
    "CacheFault", "CorruptLayerFault", "DeviceFault", "FaultInjector",
    "FaultSpec", "FaultyCache", "HOSTILE_BUILDERS", "InjectedFault",
    "EXPECTED_STATUS", "SCENARIOS", "build_corpus",
    "corrupt_boltdb_layout", "hostile_limits", "parse_fault_spec",
]
