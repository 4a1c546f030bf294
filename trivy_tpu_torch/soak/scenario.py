"""Declarative, seeded soak scenarios (copied from
``trivy_tpu/soak/scenario.py``): typed steps on a virtual timeline,
compressed onto the wall clock.

A :class:`Scenario` is a pure function of its spec: ``schedule()``
returns the complete run — every push arrival (diurnal Poisson with
tenant mix and duplicate-tag bursts) and every disruption step —
as one canonical JSON document. Same seed ⇒ byte-identical schedule;
the runner merely *executes* it, so a failing soak replays exactly.

Disruption steps compose the existing ``faults/`` scenarios instead
of reinventing them: a step's ``fault`` string is parsed by
``faults.spec.parse_fault_specs`` (the comma-composition grammar,
independently derived sub-seeds included), and the runner applies
whatever the fleet expresses — storm shapes become registry push
bursts, ``replica_kill_after`` arms the kill, chaos windows steer
the live replicas' ``POST /chaos`` knobs.

The virtual clock: step/arrival times are in *virtual seconds*;
``compression`` maps them onto real time (``real = virtual /
compression``), so "a week of chaos" compresses into an afternoon —
or a test-suite-safe smoke into seconds — without touching the script.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
from dataclasses import asdict, dataclass, field, replace

from ..faults.spec import combine_fault_specs, parse_fault_specs
from .registry import RegistrySpec

STEP_KINDS = (
    "storm",          # registry push burst (event-storm shape)
    "kill",           # hard-kill one replica, no drain
    "scale_up",       # add a replica to the ring
    "scale_down",     # drain → quiesce → stop one replica
    "hot_swap",       # rolling DB generation bump across replicas
    "brownout",       # error window on every replica (500s)
    "flaky",          # response-drop window (lost responses)
    "cache_outage",   # cache-tier op failure window
)


@dataclass(frozen=True)
class Step:
    """One scripted disruption at virtual time ``t``."""

    t: float                      # virtual seconds from run start
    kind: str
    duration: float = 0.0         # virtual seconds (window steps)
    value: float = 0.0            # rate for window steps (0 → 1.0)
    fault: str = ""               # faults/ spec composition string
    expect_trip: bool = False     # this step is DESIGNED to trip
                                  # the fleet SLO (gated exactly)

    def __post_init__(self):
        if self.kind not in STEP_KINDS:
            raise ValueError(
                f"unknown soak step kind {self.kind!r} "
                f"(choose from {', '.join(STEP_KINDS)})")
        if self.t < 0 or self.duration < 0:
            raise ValueError("step times must be >= 0")

    def fault_spec(self):
        """The composed FaultSpec this step carries (merged across
        comma-combined scenarios; None when the step has none)."""
        if not self.fault:
            return None
        return combine_fault_specs(parse_fault_specs(self.fault))


@dataclass(frozen=True)
class ScenarioSpec:
    """Everything a soak run derives from — one seed to rule the
    arrivals, the tenant mix, and every sub-seeded fault stream."""

    name: str = "custom"
    seed: int = 20260807
    duration_s: float = 48.0        # virtual seconds
    compression: float = 3.0        # virtual seconds per real second
    base_rate: float = 30.0         # pushes per virtual second
    diurnal_amplitude: float = 0.6  # rate swing over one "day"
    dup_rate: float = 0.2           # share of arrivals that burst
    burst: int = 3                  # max extra pushes in a burst
    registry: RegistrySpec = field(default_factory=RegistrySpec)
    steps: tuple = ()

    def __post_init__(self):
        if self.duration_s <= 0 or self.compression <= 0:
            raise ValueError("duration and compression must be > 0")
        if self.base_rate <= 0:
            raise ValueError("base_rate must be > 0")
        for st in self.steps:
            if st.t > self.duration_s:
                raise ValueError(
                    f"step {st.kind!r} at t={st.t} lands after "
                    f"duration {self.duration_s}")


class Scenario:
    """A spec plus its deterministic schedule."""

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self._schedule = None

    def rate_at(self, t: float) -> float:
        """Diurnal arrival rate: one sinusoidal "day" spans the run
        (peak mid-run), swinging ``diurnal_amplitude`` around the
        base rate — the day/night shape real registries show."""
        s = self.spec
        phase = 2.0 * math.pi * (t / s.duration_s)
        return max(s.base_rate * 0.05,
                   s.base_rate * (1.0 + s.diurnal_amplitude
                                  * math.sin(phase)))

    def arrivals(self) -> list:
        """Seeded inhomogeneous-Poisson push schedule via thinning:
        ``[(t_virtual, image_index), ...]``, with duplicate-tag
        bursts (the same image repushed within ~50 virtual ms — the
        pattern debounce exists for) and popularity-skewed image
        choice so hot images re-push often."""
        s = self.spec
        rng = random.Random(f"{s.seed}:arrivals".encode())
        peak = s.base_rate * (1.0 + s.diurnal_amplitude)
        out = []
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= s.duration_s:
                break
            if rng.random() > self.rate_at(t) / peak:
                continue             # thinned: off-peak hour
            # popularity skew: square the draw so a hot head of
            # images dominates re-pushes (realistic tag churn)
            i = int(rng.random() ** 2 * s.registry.images)
            out.append((round(t, 6), i))
            if rng.random() < s.dup_rate:
                for j in range(1 + rng.randrange(
                        max(1, s.burst))):
                    tb = t + (j + 1) * 0.05
                    if tb < s.duration_s:
                        out.append((round(tb, 6), i))
        out.sort()
        return out

    def schedule(self) -> dict:
        """The full deterministic run plan, canonical and cached."""
        if self._schedule is None:
            s = self.spec
            self._schedule = {
                "name": s.name,
                "seed": s.seed,
                "duration_s": s.duration_s,
                "compression": s.compression,
                "registry": asdict(s.registry),
                "arrivals": self.arrivals(),
                "steps": [asdict(st) for st in
                          sorted(s.steps, key=lambda st:
                                 (st.t, st.kind))],
            }
        return self._schedule

    def to_json(self) -> str:
        """Canonical bytes: the same-seed ⇒ byte-identical contract
        (and the thing the schedule digest is taken over)."""
        return json.dumps(self.schedule(), sort_keys=True,
                          separators=(",", ":"))

    def digest(self) -> str:
        return "sha256:" + hashlib.sha256(
            self.to_json().encode()).hexdigest()


def _smoke_steps() -> tuple:
    """The smoke script: every step kind once, overlapping where the
    emergent-behavior questions live (a hot swap during a scale-up
    during storm recovery), with exactly one designed SLO trip."""
    return (
        Step(t=6.0, kind="storm",
             fault="event-storm:storm_events=160,storm_digests=8,"
                   "storm_malformed=12"),
        Step(t=10.0, kind="kill", fault="replica-kill"),
        Step(t=12.0, kind="scale_up"),
        Step(t=16.0, kind="hot_swap", duration=6.0),
        Step(t=20.0, kind="cache_outage", duration=4.0,
             value=0.5, fault="cache-flaky"),
        Step(t=26.0, kind="flaky", duration=4.0, value=0.15,
             fault="replica-flaky"),
        Step(t=31.0, kind="scale_down"),
        Step(t=36.0, kind="brownout", duration=10.0, value=1.0,
             expect_trip=True),
    )


SCENARIOS = {
    # test-suite-safe: seconds of wall clock, every step kind, one
    # designed trip — the harness exercising itself on every PR
    "soak-smoke": ScenarioSpec(
        name="soak-smoke", seed=20260807,
        duration_s=48.0, compression=3.0, base_rate=30.0,
        registry=RegistrySpec(seed=20260807, layers=100_000,
                              images=20_000, hostile_rate=0.01),
        steps=_smoke_steps()),
    # the full gated run: a compressed "week" against a
    # million-layer registry — ≥10⁴ scans, chaos cycles repeating
    # so leak trends have room to show
    "soak": ScenarioSpec(
        name="soak", seed=20260807,
        duration_s=720.0, compression=6.0, base_rate=40.0,
        registry=RegistrySpec(seed=20260807, layers=1_000_000,
                              images=200_000, hostile_rate=0.005),
        steps=(
            Step(t=60.0, kind="storm",
                 fault="event-storm:storm_events=512,"
                       "storm_digests=24,storm_malformed=32"),
            Step(t=120.0, kind="kill", fault="replica-kill"),
            Step(t=150.0, kind="scale_up"),
            Step(t=200.0, kind="hot_swap", duration=60.0),
            Step(t=280.0, kind="cache_outage", duration=40.0,
                 value=0.5, fault="cache-flaky"),
            Step(t=340.0, kind="flaky", duration=40.0, value=0.1,
                 fault="replica-flaky"),
            Step(t=400.0, kind="scale_down"),
            Step(t=430.0, kind="storm",
                 fault="event-storm:storm_events=512,"
                       "storm_digests=24,storm_malformed=32"),
            Step(t=470.0, kind="kill", fault="replica-kill"),
            Step(t=500.0, kind="scale_up"),
            Step(t=540.0, kind="hot_swap", duration=60.0),
            Step(t=620.0, kind="brownout", duration=100.0,
                 value=1.0, expect_trip=True),
        )),
}


def _step_from_dict(doc: dict) -> Step:
    known = {"t", "kind", "duration", "value", "fault",
             "expect_trip"}
    extra = set(doc) - known
    if extra:
        raise ValueError(f"unknown step fields {sorted(extra)}")
    return Step(**doc)


def load_scenario(name_or_path: str, seed: int = 0,
                  duration_s: float = 0.0,
                  compression: float = 0.0) -> Scenario:
    """``--scenario NAME`` (preset) or ``--scenario FILE`` (a JSON
    ScenarioSpec document). CLI overrides (seed/duration/compression
    > 0) apply on top of either."""
    import os
    if name_or_path in SCENARIOS:
        spec = SCENARIOS[name_or_path]
    elif os.path.exists(name_or_path):
        with open(name_or_path, encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError("scenario file must hold a JSON "
                             "object")
        reg = RegistrySpec(**(doc.pop("registry", None) or {}))
        steps = tuple(_step_from_dict(d)
                      for d in doc.pop("steps", None) or ())
        spec = ScenarioSpec(registry=reg, steps=steps, **doc)
    else:
        raise ValueError(
            f"unknown scenario {name_or_path!r} (presets: "
            f"{', '.join(sorted(SCENARIOS))}; or a JSON file path)")
    overrides = {}
    if seed:
        overrides["seed"] = seed
        overrides["registry"] = replace(spec.registry, seed=seed)
    if duration_s > 0:
        overrides["duration_s"] = duration_s
    if compression > 0:
        overrides["compression"] = compression
    if overrides:
        spec = replace(spec, **overrides)
    return Scenario(spec)
