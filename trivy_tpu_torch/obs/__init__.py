"""Observability (reference: ``trivy_tpu/obs/``): per-request tracing
and the flight recorder, the SLO burn-rate engine and the per-tenant
cost ledger — what the continuous-batching scheduler (``sched/``)
threads through every request.

Zero-dependency by design: spans, the ring, the SLO windows and the
ledger are stdlib-only. The phase spans and events that deep seams
record (``phase_span``, ``add_event``, ``activate_or_null``), the
busy/idle timeline (``timeline.py``) and the host profiler
(``profiler.py``) are ROADMAP A.8; the Prometheus exposition
(``prom.py``), fleet federation (``federate.py``) and trace
propagation (``propagate.py``) are A.9.
"""

from .cost import (COST_LEDGER, CostLedger, TenantBudget, balance,
                   parse_budget_config)
from .recorder import FlightRecorder, RingLogHandler, attach_ring_handler
from .slo import SLO, SloEngine, default_slos, parse_slo_config
from .trace import (NOOP_SPAN, Span, Tracer, current_span, get_tracer,
                    new_trace_id, to_chrome, trace_cause)

__all__ = [
    "COST_LEDGER", "CostLedger", "FlightRecorder", "NOOP_SPAN",
    "RingLogHandler", "SLO", "SloEngine", "Span", "TenantBudget",
    "Tracer", "attach_ring_handler", "balance",
    "current_span", "default_slos", "get_tracer", "new_trace_id",
    "parse_budget_config", "parse_slo_config", "to_chrome",
    "trace_cause",
]
