"""Observability (reference: ``trivy_tpu/obs/``): per-request tracing
with the phase spans and events of the deep seams, the flight
recorder, the busy/idle timeline with typed idle attribution, the
sampling host profiler and the ``torch.profiler`` device trace, the
SLO burn-rate engine and the per-tenant cost ledger.

Zero-dependency by design: spans, the ring, the timeline math, the
profiler, the SLO windows and the ledger are stdlib-only; the busy
spans' CUDA event stamps (``busy.py``) and the device trace import
torch when they run. ``prom.py`` renders the scan server's
``/metrics`` as Prometheus text, ``procstats.py`` reads the process's
own RSS, fds and threads, and ``propagate.py`` carries a trace context
across the process seams and estimates clock offsets between them;
``federate.py`` merges a replica fleet's expositions and SLO verdicts.
"""

from .cost import (COST_LEDGER, CostLedger, TenantBudget, balance,
                   parse_budget_config)
from .profiler import HostProfiler, device_trace, get_profiler
from .recorder import FlightRecorder, RingLogHandler, attach_ring_handler
from .slo import SLO, SloEngine, default_slos, parse_slo_config
from .timeline import Timeline, from_recorder, from_tracer
from .trace import (NOOP_SPAN, Span, Tracer, activate_or_null,
                    add_event, current_span, get_tracer, new_trace_id,
                    phase_span, summarize, to_chrome, trace_cause)

__all__ = [
    "COST_LEDGER", "CostLedger", "FlightRecorder", "HostProfiler",
    "NOOP_SPAN", "RingLogHandler", "SLO", "SloEngine", "Span",
    "TenantBudget", "Timeline", "Tracer", "activate_or_null",
    "add_event", "attach_ring_handler", "balance", "current_span",
    "default_slos", "device_trace", "from_recorder", "from_tracer",
    "get_profiler", "get_tracer", "new_trace_id", "parse_budget_config",
    "parse_slo_config", "phase_span", "summarize", "to_chrome",
    "trace_cause",
]
