"""Registry-scale soak harness (copied from ``trivy_tpu/soak/``;
docs/robustness.md "Soak & chaos testing"): a compressed week of production against a synthetic
million-image registry, rendered as a pass/fail verdict.

Four pieces, composable and all seeded:

* :mod:`registry` — a content-addressed synthetic registry:
  10⁵–10⁶ distinct layer identities behind generated manifests
  (index-bound, never materialized as tarballs) with the realistic
  cross-image layer reuse of the reference's warm fleets;
* :mod:`scenario` — a declarative scenario script: typed steps on a
  virtual timeline (diurnal Poisson pushes with tenant mix, rolling
  DB hot swaps, replica kills, autoscale cycles, event storms,
  brownouts, hostile trickle), composing the ``faults/`` scenarios,
  compressed onto a wall clock;
* :mod:`runner` — drives a routed multi-replica fleet + watch loop
  + the federation plane through the script and enforces the global
  books invariant (fleet-wide ``lost == 0``);
* :mod:`audit` — the steady-state leak audit: RSS/fds/threads and
  every long-lived bounded structure, sampled per epoch; any series
  that grows without bound fails the run.

Surface: ``python -m trivy_tpu_torch soak --scenario soak`` (full)
and ``--scenario soak-smoke`` (seconds of wall clock). It runs no
kernel and needs no card: the fleet is CPU sim replicas
(``router/sim.py``).

One departure from the reference, in :mod:`runner`: the verdict clock
(each verdict and ok-rate point stamped after the scrape it carries,
verdicts and steps on one origin).
"""

from .audit import ResourceAudit
from .registry import RegistrySpec, SyntheticRegistry
from .runner import SoakRunner, run_soak
from .scenario import (SCENARIOS, Scenario, ScenarioSpec, Step,
                       load_scenario)

__all__ = [
    "ResourceAudit", "RegistrySpec", "SCENARIOS", "Scenario",
    "ScenarioSpec", "SoakRunner", "Step", "SyntheticRegistry",
    "load_scenario", "run_soak",
]
