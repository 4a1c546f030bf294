"""Fault-tolerant scan router (reference: ``trivy_tpu/router/``;
docs/serving.md "Scan router & autoscaling").

The fleet front the single-process server stack lives behind: a
``python -m trivy_tpu_torch route`` process (or an embedded
:class:`ScanRouter`) shards Scan RPCs across N ``server`` replicas, each
on its own card, by consistent hashing on layer digest — the
bounded-load variant, so a hot digest spills to the next ring node
instead of melting one shard — with per-replica health probing,
circuit-breaker ejection, drain-aware failover (zero-loss: an
in-flight request whose replica dies or starts draining is replayed
with the same idempotency key and traceparent against the next ring
owner), and an SLO-driven autoscaler that consumes the federated
``fleet.slo_ok`` burn-rate verdicts.
"""

# Lazy exports (PEP 562): ``python -m trivy_tpu_torch.router.sim`` — the
# subprocess replica the controllers spawn per fleet member — and the
# scan server's imports of ``ring`` and ``lifecycle`` must execute this
# package __init__ without paying for the rpc/server import chain (and
# torch) that core.py needs. Attribute access from normal code resolves
# identically.
_EXPORTS = {
    "Ring": "ring",
    "ScanRouter": "core", "ReplicaHandle": "core",
    "HealthProber": "core",
    "RouterServer": "front", "serve_router": "front",
    "Autoscaler": "scaler", "ScalerPolicy": "scaler",
    "ReplicaController": "scaler", "SimReplicaController": "scaler",
    "SubprocessReplicaController": "scaler", "decide": "scaler",
    "SimReplica": "sim",
    "LifecycleMetrics": "lifecycle", "LIFECYCLE_METRICS": "lifecycle",
    "prewarm_ranges": "lifecycle", "plan_handoff": "lifecycle",
    "run_handoff": "lifecycle", "fetch_handoff": "lifecycle",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__),
                   name)
