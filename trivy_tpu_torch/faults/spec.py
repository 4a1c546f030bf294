"""Fault scenarios: what to break, when, deterministically (copied
from ``trivy_tpu/faults/spec.py``: the same text parses to the same
spec and the same sub-seeds in both packages, and a bad one fails with
the same message).

A :class:`FaultSpec` is the declarative half of the fault layer — a
seeded description of which failure domains misbehave and how hard.
Scenarios are the named presets the docs (docs/robustness.md), the
``--fault-spec`` CLI flag (the ``image`` fleet, ``server`` and
``watch``) and the tests all share, so "cache-outage" means the same
thing in a unit test and in a drill on the card. Every stochastic
decision draws from one seeded RNG: the same spec against the same
workload injects the same faults.

Spec strings::

    cache-outage                       # a named scenario, defaults
    cache-outage:seed=7,cache_fail_ops=80
    poison-image:poison=img7.tar
    poison=img3.tar;img9.tar,device_fail_batches=1   # bare overrides
    event-storm,replica-kill,hostile-ingest          # composition

Composition (the last form) is how a soak script asks for storms +
kills + hostile trickle *simultaneously*: each comma-separated
scenario name opens a new sub-spec (``k=v`` items bind to the
sub-spec opened most recently), every sub-spec after the first draws
an independently derived sub-seed so co-injected domains don't
replay each other's random streams, and
:func:`combine_fault_specs` merges them — two sub-specs assigning
*different* values to the same scalar field fail up front with the
offending pair named.
"""

from __future__ import annotations

import hashlib

from dataclasses import dataclass, fields, replace


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault scenario. Zero values mean "healthy"."""

    scenario: str = ""
    seed: int = 20260804

    # -- cache backend (exercises the circuit breaker + FS/memory
    #    fallback in artifact/resilient.py)
    cache_fail_ops: int = 0     # first N cache ops raise; -1 = every op
    cache_fail_rate: float = 0.0  # per-op failure probability

    # -- device dispatch (exercises batch bisection + quarantine in
    #    sched/scheduler.py)
    device_fail_batches: int = 0  # first N dispatches raise (transient)
    device_fail_rate: float = 0.0  # per-dispatch failure probability
    device_stall_s: float = 0.0   # every dispatch sleeps this long
    poison: tuple = ()   # request-name substrings that poison a batch

    # -- host phases
    corrupt: tuple = ()  # request-name substrings whose image load fails
    stall_s: float = 0.0      # slow-host: analyze sleeps this long
    stall_rate: float = 1.0   # fraction of analyzes stalled

    # -- RPC surface (exercises idempotency keys + client retry)
    rpc_error_first: int = 0   # first N POSTs answer 500 unprocessed
    rpc_error_rate: float = 0.0
    rpc_drop_first: int = 0    # first N POSTs process, then drop the
    rpc_drop_rate: float = 0.0  # response (lost-response retry case)

    # -- deadline storm: the harness applies this as the per-request
    #    deadline (the spec only carries the number)
    deadline_s: float = 0.0

    # -- flaky registry (artifact/registry.py streaming fetch): the
    #    first N blob streams are dropped mid-body (one connection
    #    drop each, past the first chunk) — the resumable fetch must
    #    recover via Range (or an offset-0 rewrite when the registry
    #    rejects ranges) without failing the scan
    blob_drop_first: int = 0

    # -- hostile-ingest corpus (faults/hostile.py): builder names —
    #    or ("all",) — materialized (seeded by ``seed``) and appended
    #    to the scanned fleet by the multi-target image path; the
    #    guard layer must quarantine each one per-target
    hostile: tuple = ()

    # -- findings memo (trivy_tpu/memo): corrupt the first N memo
    #    entry loads (-1 = every load) — the checksum must catch the
    #    damage, drop the entry, and recompute transparently
    #    (scan completes ok, byte-identical to cold)
    memo_corrupt_loads: int = 0

    # -- event storm (docs/serving.md "Continuous scanning"): a
    #    burst of storm_events registry push notifications over
    #    storm_digests distinct digests (duplicate-tag repushes) with
    #    storm_malformed malformed envelopes interleaved. The harness
    #    (watch.source.make_event_storm) materializes the seeded
    #    burst; the watch loop must collapse duplicates via debounce,
    #    count-and-drop malformed envelopes, shed overload through
    #    the existing 429/503 paths, and never crash
    storm_events: int = 0
    storm_digests: int = 0
    storm_malformed: int = 0

    # -- router fleet (docs/serving.md "Scan router & autoscaling"):
    #    parsed as the reference parses them; the port's injector
    #    refuses a spec that sets them until the router is ported.
    #    replica_kill_after kills a backend replica mid-storm after
    #    the router has forwarded N requests (the harness — bench
    #    kill arm, tests — does the killing; the spec carries the
    #    seeded instant, and replica_kill optionally names the
    #    victim, else the harness picks the busiest).
    #    replica_flaky_every drops every Nth forwarded response at
    #    the router's fault hook (work done, response lost — the
    #    replay-with-same-idempotency-key case); replica_flaky
    #    scopes the drops to one named replica, else any.
    replica_kill_after: int = 0
    replica_kill: str = ""
    replica_flaky_every: int = 0
    replica_flaky: str = ""

    # -- tenant flood (docs/serving.md "Multi-tenant QoS"): like
    #    deadline-storm, the spec only carries the storm's shape —
    #    the harness (bench.py adversarial-tenant arm, tests) runs
    #    an open-loop submitter AS this tenant at this rate while
    #    compliant tenants keep their normal traffic; the tenancy
    #    layer must shed the flood as 429s while compliant p99 holds
    flood_tenant: str = ""
    flood_rate: float = 0.0   # open-loop storm arrival rate, req/s
    flood_n: int = 0          # storm submissions (0 = harness pick)

    def wants_cache_faults(self) -> bool:
        return bool(self.cache_fail_ops or self.cache_fail_rate)

    def wants_device_faults(self) -> bool:
        return bool(self.device_fail_batches or self.device_fail_rate
                    or self.device_stall_s or self.poison)

    def wants_rpc_faults(self) -> bool:
        return bool(self.rpc_error_first or self.rpc_error_rate
                    or self.rpc_drop_first or self.rpc_drop_rate)

    def wants_tenant_flood(self) -> bool:
        return bool(self.flood_tenant and self.flood_rate > 0)

    def wants_memo_faults(self) -> bool:
        return bool(self.memo_corrupt_loads)

    def wants_route_faults(self) -> bool:
        return bool(self.replica_kill_after
                    or self.replica_flaky_every)

    def wants_event_storm(self) -> bool:
        return bool(self.storm_events)

    def wants_registry_faults(self) -> bool:
        return bool(self.blob_drop_first)


# Named presets. ``standard-outage`` is the bench/acceptance scenario:
# a cache outage long enough to trip the breaker and recover, one
# poisoned image per 64 (callers name it via poison=...), and one
# transient device error.
SCENARIOS: dict = {
    "cache-outage": {"cache_fail_ops": 40},
    "cache-down": {"cache_fail_ops": -1},
    "cache-flaky": {"cache_fail_rate": 0.2},
    "device-transient": {"device_fail_batches": 2},
    "device-persistent": {"device_fail_rate": 1.0},
    "poison-image": {"poison": ("poison",)},
    "corrupt-layer": {"corrupt": ("corrupt",)},
    "rpc-flaky": {"rpc_drop_rate": 0.2, "rpc_error_rate": 0.2},
    "rpc-lost-response": {"rpc_drop_first": 1},
    "slow-host": {"stall_s": 0.2, "stall_rate": 0.25},
    "deadline-storm": {"deadline_s": 0.05},
    "standard-outage": {"cache_fail_ops": 40,
                        "device_fail_batches": 1,
                        "poison": ("poison",)},
    "hostile-ingest": {"hostile": ("all",)},
    "memo-poison": {"memo_corrupt_loads": 4},
    "tenant-flood": {"flood_tenant": "flooder", "flood_rate": 400.0,
                     "flood_n": 256},
    "replica-kill": {"replica_kill_after": 32},
    "replica-flaky": {"replica_flaky_every": 3},
    "registry-flaky": {"blob_drop_first": 2},
    "event-storm": {"storm_events": 256, "storm_digests": 8,
                    "storm_malformed": 8},
}

_FIELDS = {f.name: f for f in fields(FaultSpec)}


def _coerce(name: str, raw: str):
    f = _FIELDS[name]
    if f.type in ("tuple", tuple):
        return tuple(p for p in raw.split(";") if p)
    if f.type in ("int", int):
        return int(raw)
    if f.type in ("float", float):
        return float(raw)
    return raw


def derive_subseed(base_seed: int, index: int, name: str) -> int:
    """Deterministic per-sub-spec seed for composed scenarios: a
    stable hash of ``(base seed, position, scenario name)`` so
    ``event-storm,replica-kill`` gives the storm and the kill
    independent random streams that never collide — and the same
    composed string always derives the same pair."""
    h = hashlib.sha256(
        f"{base_seed}:{index}:{name}".encode()).hexdigest()
    return int(h[:12], 16)


def _parse_segment(name: str, pairs: list) -> tuple:
    """One sub-spec: ``(overrides dict, explicit_seed bool)``."""
    overrides: dict = {}
    if name:
        preset = SCENARIOS.get(name)
        if preset is None:
            raise ValueError(
                f"unknown fault scenario {name!r} "
                f"(choose from {', '.join(sorted(SCENARIOS))})")
        overrides.update(preset)
        overrides["scenario"] = name
    explicit_seed = False
    for pair in pairs:
        key, eq, raw = pair.partition("=")
        key = key.strip()
        if not eq or key not in _FIELDS:
            raise ValueError(
                f"bad fault-spec entry {pair!r} "
                f"(want key=value with a FaultSpec field)")
        try:
            overrides[key] = _coerce(key, raw.strip())
        except (TypeError, ValueError):
            raise ValueError(
                f"bad fault-spec value for {key!r}: {raw!r}")
        if key == "seed":
            explicit_seed = True
    return overrides, explicit_seed


def parse_fault_specs(text) -> tuple:
    """``"scenario[:k=v,...][,scenario2[:...]]..."`` → tuple of
    :class:`FaultSpec`, one per comma-combined scenario.

    Each scenario name opens a new sub-spec; bare ``k=v`` items bind
    to the most recently opened one (a leading run of ``k=v`` items
    forms an anonymous sub-spec, the legacy single-spec grammar).
    Sub-specs after the first that don't say ``seed=`` explicitly
    get :func:`derive_subseed`'d seeds, so composed domains draw
    from independent random streams deterministically."""
    if isinstance(text, FaultSpec):
        return (text,)
    text = (text or "").strip()
    if not text:
        return (FaultSpec(),)
    # split into segments: each item is either "name", "name:k=v",
    # or "k=v"; a name (no "=" before any ":") opens a new segment
    segments: list = []       # (name, [pairs])
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        head, sep, rest = item.partition(":")
        if "=" not in head:
            segments.append([head, []])
            if sep and rest.strip():
                segments[-1][1].append(rest.strip())
        else:
            if not segments:
                segments.append(["", []])
            segments[-1][1].append(item)
    specs: list = []
    base_seed = FaultSpec.seed
    for i, (name, pairs) in enumerate(segments):
        overrides, explicit_seed = _parse_segment(name, pairs)
        if i == 0:
            base_seed = overrides.get("seed", base_seed)
        elif not explicit_seed:
            overrides["seed"] = derive_subseed(base_seed, i, name)
        specs.append(replace(FaultSpec(), **overrides))
    return tuple(specs)


_DEFAULT = FaultSpec()
_TUPLE_FIELDS = tuple(f.name for f in fields(FaultSpec)
                      if f.type in ("tuple", tuple))


def combine_fault_specs(specs) -> FaultSpec:
    """Merge composed sub-specs into the one :class:`FaultSpec` the
    injector consumes. Tuple fields union (order-preserving, deduped
    — co-injecting two poison lists means both poison); scalar
    fields conflict-checked: two sub-specs assigning *different*
    non-default values to the same field raise ValueError naming the
    offending pair up front, instead of one scenario silently
    clobbering the other mid-run. The merged seed is the first
    sub-spec's; per-domain randomness should use the sub-spec seeds
    (:func:`parse_fault_specs` derives them)."""
    specs = [s for s in specs if s is not None]
    if not specs:
        return FaultSpec()
    if len(specs) == 1:
        return specs[0]
    merged: dict = {}
    owner: dict = {}
    names = [s.scenario or f"<spec#{i}>"
             for i, s in enumerate(specs)]
    for i, spec in enumerate(specs):
        for f in fields(FaultSpec):
            if f.name in ("scenario", "seed"):
                continue
            val = getattr(spec, f.name)
            if val == getattr(_DEFAULT, f.name):
                continue
            if f.name not in merged:
                merged[f.name] = val
                owner[f.name] = i
                continue
            if f.name in _TUPLE_FIELDS:
                seen = merged[f.name]
                merged[f.name] = seen + tuple(
                    v for v in val if v not in seen)
            elif merged[f.name] != val:
                raise ValueError(
                    f"conflicting fault-spec composition: "
                    f"{names[owner[f.name]]} and {names[i]} both "
                    f"set {f.name} "
                    f"({merged[f.name]!r} vs {val!r})")
    merged["scenario"] = "+".join(n for n in
                                  (s.scenario for s in specs) if n)
    merged["seed"] = specs[0].seed
    return replace(FaultSpec(), **merged)


def parse_fault_spec(text) -> FaultSpec:
    """``"scenario[:k=v,...]"`` or bare ``"k=v,..."`` → FaultSpec.
    Comma-combined scenarios parse as a composition and merge via
    :func:`combine_fault_specs`.

    Unknown scenario names and unknown keys raise ValueError so a
    typo'd --fault-spec fails the run up front instead of silently
    injecting nothing.
    """
    return combine_fault_specs(parse_fault_specs(text))
