"""SLO-driven autoscaler for the scan router (reference:
``trivy_tpu/router/scaler.py``; docs/serving.md "Scan router &
autoscaling").

The scaling signal is the federation contract — the fleet
``slo_ok`` verdict and burn rates computed over every replica's
merged event buckets (``obs/federate.py``), NOT raw quantiles: a
burn-rate trip means the error budget is being spent too fast fleet-
wide, which is the only signal that justifies paying for another
replica. Scale-down needs the opposite confidence, so it additionally
requires ``complete: true`` (every peer answered fresh — shrinking
the fleet on a partial view would double-punish a flapping replica)
and several consecutive calm ticks.

Scale-down NEVER kills a working replica: the victim is marked
draining (the router stops sending NEW work, its in-flight scans
finish), and only when both the router's own in-flight book and the
replica's probed inflight reach zero does the controller stop it and
the ring reshard — the same zero-loss discipline as request
failover.

The actuation surface is a pluggable :class:`ReplicaController`;
:class:`SimReplicaController` (in-process) and
:class:`SubprocessReplicaController` (``python -m
trivy_tpu_torch.router.sim`` per replica) ship for tests and bench, a
production deployment implements the same three methods against its
orchestrator (k8s Deployment scale, an ASG, …).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import ROUTER_METRICS

log = logging.getLogger("trivy_tpu_torch.router.scaler")

# the subprocess replica: the port's own sim, never the reference's
SIM_MODULE = "trivy_tpu_torch.router.sim"


@dataclass(frozen=True)
class ScalerPolicy:
    """Scaling knobs (docs/serving.md documents each)."""
    min_replicas: int = 1
    max_replicas: int = 8
    interval_s: float = 2.0
    # avg in-flight per routable replica below which the fleet is
    # considered idle enough to shrink
    low_inflight: float = 0.5
    # consecutive idle-and-healthy ticks before a scale-down fires
    calm_ticks: int = 3
    # quiet period after ANY scale event (flap damping)
    cooldown_s: float = 10.0
    # scale-down only on a complete federated view
    require_complete: bool = True


def decide(slo_ok: bool, complete: bool, avg_inflight: float,
           n: int, calm: int, policy: ScalerPolicy, *,
           warming: int = 0) -> Tuple[str, str]:
    """Pure scaling decision: ("up"|"down"|"hold", reason).
    ``calm`` is the caller's count of consecutive calm ticks BEFORE
    this one. ``warming`` is the count of replicas still
    prewarming: they don't serve yet, so they don't count toward
    ``n`` or the in-flight average — but a burn-rate trip while one
    is in flight holds instead of stacking a second scale-up (the
    hysteresis covers the prewarm window, not just the cooldown)."""
    if not slo_ok:
        if warming > 0:
            return "hold", (f"slo burning but {warming} replica(s) "
                            "still prewarming — scale-up in flight")
        if n + warming < policy.max_replicas:
            return "up", "fleet slo burn-rate trip"
        return "hold", "slo burning but fleet at max_replicas"
    if warming > 0:
        # never shrink under a join in flight: the prewarming
        # replica is about to take ring ranges; draining a peer at
        # the same time would churn the ring twice in one window
        return "hold", f"{warming} replica(s) prewarming"
    if n > policy.min_replicas \
            and avg_inflight < policy.low_inflight:
        if policy.require_complete and not complete:
            return "hold", "idle but federated view incomplete"
        if calm + 1 >= policy.calm_ticks:
            return "down", (f"avg inflight {avg_inflight:.2f} < "
                            f"{policy.low_inflight} for "
                            f"{calm + 1} ticks")
        return "hold", f"calm tick {calm + 1}/{policy.calm_ticks}"
    return "hold", "slo ok, fleet busy or at min_replicas"


class ReplicaController:
    """Actuation interface the autoscaler drives. Implementations
    must make ``start`` return a ready-to-probe endpoint and make
    ``stop`` safe on an already-dead replica.

    ``prewarm_enabled`` tells the scaler whether a started replica
    boots in the ``warming`` state (docs/serving.md "Elastic
    lifecycle"): when True the scaler admits it to the ring as
    warming (unroutable until its /healthz flips) and passes the
    current ring membership into ``start`` so the replica can
    compute its post-join key ranges before serving."""

    prewarm_enabled = False

    def start(self, ring_members: Optional[List[str]] = None,
              ) -> Tuple[str, str]:
        """Launch one replica; returns (name, url)."""
        raise NotImplementedError

    def drain(self, name: str) -> None:
        """Ask a replica to stop accepting NEW work (it keeps its
        in-flight scans)."""
        raise NotImplementedError

    def stop(self, name: str) -> None:
        """Terminate a (drained) replica."""
        raise NotImplementedError


class SimReplicaController(ReplicaController):
    """In-process SimReplica fleet — unit/e2e tests."""

    def __init__(self, prefix: str = "sim", **sim_kwargs):
        self.prefix = prefix
        self.sim_kwargs = sim_kwargs
        self._n = 0
        self.replicas: Dict[str, object] = {}

    @property
    def prewarm_enabled(self) -> bool:
        return bool(self.sim_kwargs.get("memo_dir"))

    def start(self, ring_members: Optional[List[str]] = None,
              ) -> Tuple[str, str]:
        from .sim import SimReplica
        name = f"{self.prefix}-{self._n}"
        self._n += 1
        kwargs = dict(self.sim_kwargs)
        if self.prewarm_enabled and ring_members:
            kwargs.setdefault("ring_members", list(ring_members))
        sim = SimReplica(name=name, **kwargs).start()
        self.replicas[name] = sim
        return name, sim.url

    def drain(self, name: str) -> None:
        sim = self.replicas.get(name)
        if sim is not None:
            sim.drain()

    def stop(self, name: str) -> None:
        sim = self.replicas.pop(name, None)
        if sim is not None:
            sim.stop()

    def kill(self, name: str) -> None:
        """Abrupt death, no drain: the in-process analogue of the
        subprocess controller's SIGKILL lever (soak replica-kill
        steps). In-flight requests error at the router and replay."""
        sim = self.replicas.pop(name, None)
        if sim is not None:
            sim.kill()


class SubprocessReplicaController(ReplicaController):
    """One OS process per replica via ``python -m
    trivy_tpu_torch.router.sim`` — the bench fleet, and the template a
    real deployment's controller follows (start/drain/stop against
    its own orchestrator)."""

    def __init__(self, prefix: str = "rep",
                 extra_args: Optional[List[str]] = None,
                 start_timeout_s: float = 10.0):
        self.prefix = prefix
        self.extra_args = list(extra_args or [])
        self.start_timeout_s = start_timeout_s
        self._n = 0
        self.procs: Dict[str, object] = {}
        self.urls: Dict[str, str] = {}

    @property
    def prewarm_enabled(self) -> bool:
        return "--memo-dir" in self.extra_args

    def start(self, ring_members: Optional[List[str]] = None,
              ) -> Tuple[str, str]:
        import subprocess
        import sys
        name = f"{self.prefix}-{self._n}"
        self._n += 1
        args = list(self.extra_args)
        if self.prewarm_enabled and ring_members \
                and "--ring-members" not in args:
            args += ["--ring-members", ",".join(ring_members)]
        proc = subprocess.Popen(
            [sys.executable, "-m", SIM_MODULE,
             "--name", name, "--port", "0"] + args,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        # the replica prints "PORT <n>" once bound; readline blocks
        # until then (or EOF on a crashed child)
        line = proc.stdout.readline().strip() \
            if proc.stdout else ""
        if not line.startswith("PORT "):
            proc.kill()
            raise RuntimeError(
                f"sim replica {name} failed to report its port "
                f"(got {line!r})")
        url = f"http://127.0.0.1:{int(line.split()[1])}"
        self.procs[name] = proc
        self.urls[name] = url
        return name, url

    def drain(self, name: str) -> None:
        import urllib.error
        import urllib.request
        url = self.urls.get(name)
        if not url:
            return
        try:
            req = urllib.request.Request(url + "/drain",
                                         data=b"{}", method="POST")
            urllib.request.urlopen(req, timeout=2.0).close()
        except (urllib.error.URLError, ConnectionError,
                TimeoutError, OSError) as e:
            # a dead replica cannot be asked to drain; the scaler's
            # stop path (and the prober's breaker) handle it
            log.warning("drain request to %s failed: %r", name, e)

    def stop(self, name: str) -> None:
        proc = self.procs.pop(name, None)
        self.urls.pop(name, None)
        if proc is None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except Exception:       # subprocess.TimeoutExpired
            log.warning("replica %s ignored SIGTERM; killing", name)
            proc.kill()
            proc.wait(timeout=5.0)

    def kill(self, name: str) -> None:
        """Hard-kill (no drain) — the bench's replica-death lever."""
        proc = self.procs.pop(name, None)
        self.urls.pop(name, None)
        if proc is not None:
            proc.kill()
            proc.wait(timeout=5.0)


def federated_verdicts(router, token: str = "",
                       timeout_s: float = 2.0) -> Callable[[], dict]:
    """The default scaling-signal source: an ``obs/federate.py`` Federator over the
    router's CURRENT replica set, rebuilt only when membership
    changes, answering ``{"slo_ok": bool, "complete": bool}`` from
    the merged burn-rate verdicts — plus the fleet cost signal
    (``cost_per_scan_s``: attributed device-seconds per completed
    request, from the same snapshot pull) so scaling decisions see
    efficiency next to latency."""
    from ..obs.federate import Federator
    state = {"key": None, "federator": None}

    def verdict() -> dict:
        peers = [(h.name, h.url) for h in router.replicas()]
        key = tuple(peers)
        if key != state["key"]:
            state["key"] = key
            state["federator"] = Federator(
                peers, token=token, timeout_s=timeout_s) \
                if peers else None
        fed = state["federator"]
        if fed is None:
            return {"slo_ok": True, "complete": False, "slos": []}
        rows = fed.collect()
        fleet = fed.fleet_slo({}, rows)
        return {"slo_ok": bool(fleet.get("slo_ok", True)),
                "complete": bool(fleet.get("complete", False)),
                "slos": fleet.get("slos") or [],
                "cost": _fleet_cost(rows)}

    return verdict


def _fleet_cost(rows) -> dict:
    """Fleet cost-per-scan from the snapshot pull's ``cost_export``
    sections — no second network round-trip. Replicas predating the
    cost plane simply contribute nothing."""
    from ..obs.cost import (balance, device_seconds,
                            merge_cost_exports)
    exports = []
    measured_s = 0.0
    for row in rows:
        snap = row.get("snapshot")
        ce = snap.get("cost_export") if snap else None
        if not isinstance(ce, dict):
            continue
        if isinstance(ce.get("export"), dict):
            exports.append(ce["export"])
        try:
            measured_s += float(ce.get("measured_device_s", 0.0))
        except (TypeError, ValueError):
            pass
    merged = merge_cost_exports(exports)
    attributed_s = 0.0
    requests = 0.0
    for vec in merged["cum"].values():
        attributed_s += device_seconds(vec)
        requests += float(vec.get("requests", 0.0))
    return {
        "attributed_device_s": round(attributed_s, 6),
        "measured_device_s": round(measured_s, 6),
        "requests": int(requests),
        "cost_per_scan_s": round(attributed_s / requests, 6)
        if requests > 0 else 0.0,
        "balance": balance(attributed_s, measured_s),
    }


class Autoscaler:
    """Tick loop gluing verdicts to actuation. ``tick()`` is public
    and deterministic given the verdict so tests drive it directly;
    ``start()`` runs it on a background thread at
    ``policy.interval_s``."""

    def __init__(self, router, controller: ReplicaController,
                 policy: Optional[ScalerPolicy] = None,
                 verdict_fn: Optional[Callable[[], dict]] = None,
                 clock=time.monotonic,
                 handoff_timeout_s: float = 5.0):
        self.router = router
        self.controller = controller
        self.policy = policy or ScalerPolicy()
        self.handoff_timeout_s = handoff_timeout_s
        self.verdict_fn = verdict_fn or federated_verdicts(router)
        self._clock = clock
        self._calm = 0
        self._last_event: Optional[float] = None
        self._draining: set = set()   # victims awaiting quiesce
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: List[dict] = []     # bounded event log

    # ---- one tick ----

    def _finish_drains(self) -> None:
        for name in sorted(self._draining):
            h = self.router.replica(name)
            if h is None:
                self._draining.discard(name)
                continue
            if h.inflight == 0 and h.probed_inflight == 0:
                self.controller.stop(name)
                self.router.remove_replica(name)
                self._draining.discard(name)
                ROUTER_METRICS.inc("drain_kills")
                log.info("scale-down victim %s quiesced and "
                         "stopped", name)

    def _avg_inflight(self) -> Tuple[float, int, int]:
        """(avg inflight over SERVING replicas, serving count,
        warming count). A prewarming replica serves nothing yet, so
        counting it would both dilute the average and overstate
        capacity — it is capacity in flight, not capacity."""
        serving = []
        warming = 0
        for h in self.router.replicas():
            if h.draining:
                continue
            if h.warming:
                warming += 1
                continue
            serving.append(h)
        if not serving:
            return 0.0, 0, warming
        total = sum(max(h.inflight, h.probed_inflight)
                    for h in serving)
        return total / len(serving), len(serving), warming

    def tick(self, verdict: Optional[dict] = None) -> dict:
        self._finish_drains()
        if verdict is None:
            verdict = self.verdict_fn()
        avg, n, warming = self._avg_inflight()
        now = self._clock()
        in_cooldown = (self._last_event is not None and
                       now - self._last_event
                       < self.policy.cooldown_s)
        if in_cooldown:
            action, reason = "hold", "cooldown after last event"
        else:
            action, reason = decide(
                bool(verdict.get("slo_ok", True)),
                bool(verdict.get("complete", False)),
                avg, n, self._calm, self.policy,
                warming=warming)
        calm_now = bool(verdict.get("slo_ok", True)) \
            and avg < self.policy.low_inflight
        self._calm = self._calm + 1 if calm_now else 0
        if action == "up":
            members = [h.name for h in self.router.replicas()
                       if not h.draining]
            try:
                name, url = self.controller.start(
                    ring_members=members)
            except TypeError:
                # a pre-lifecycle controller with a bare start():
                # joins cold, exactly like before this contract
                name, url = self.controller.start()
            # a prewarm-enabled controller's replica joins the ring
            # WARMING: membership (and its one reshard) happen now,
            # but the router admits it only when its /healthz flips
            self.router.add_replica(
                name, url,
                warming=bool(self.controller.prewarm_enabled))
            ROUTER_METRICS.inc("scale_ups")
            self._last_event = now
            self._calm = 0
            log.info("scale UP -> %s (%s)", name, reason)
        elif action == "down":
            victim = self._pick_victim()
            if victim is None:
                action, reason = "hold", "no drainable victim"
                ROUTER_METRICS.inc("scale_holds")
            else:
                self.controller.drain(victim)
                self.router.mark_draining(victim)
                self._draining.add(victim)
                ROUTER_METRICS.inc("scale_downs")
                ROUTER_METRICS.inc("drains_started")
                self._last_event = now
                self._calm = 0
                # drain handoff: publish the victim's hot-digest
                # set to its ring successors while its in-flight
                # work finishes — best-effort, never blocks the
                # drain (docs/serving.md "Elastic lifecycle")
                from .lifecycle import run_handoff
                run_handoff(self.router, victim,
                            timeout_s=self.handoff_timeout_s)
                log.info("scale DOWN: draining %s (%s)",
                         victim, reason)
        else:
            ROUTER_METRICS.inc("scale_holds")
        event = {"action": action, "reason": reason,
                 "replicas": n, "warming": warming,
                 "avg_inflight": round(avg, 3),
                 "slo_ok": bool(verdict.get("slo_ok", True)),
                 "complete": bool(verdict.get("complete", False)),
                 "draining": sorted(self._draining)}
        cost = verdict.get("cost")
        if isinstance(cost, dict):
            # cost-per-scan rides next to the latency verdict: a
            # scale decision's efficiency context in the event log
            event["cost_per_scan_s"] = cost.get("cost_per_scan_s",
                                                0.0)
        self.decisions.append(event)
        del self.decisions[:-256]
        return event

    def _pick_victim(self) -> Optional[str]:
        candidates = [h for h in self.router.replicas()
                      if not h.draining]
        if len(candidates) <= self.policy.min_replicas:
            return None
        return min(candidates,
                   key=lambda h: (max(h.inflight,
                                      h.probed_inflight),
                                  h.name)).name

    # ---- loop ----

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="router-scaler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the scaling
                # loop must survive a transient verdict/controller
                # failure; holding is always safe
                log.warning("autoscaler tick failed: %r", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def stats(self) -> dict:
        return {"policy": {
                    "min_replicas": self.policy.min_replicas,
                    "max_replicas": self.policy.max_replicas,
                    "low_inflight": self.policy.low_inflight,
                    "calm_ticks": self.policy.calm_ticks,
                    "cooldown_s": self.policy.cooldown_s},
                "calm": self._calm,
                "pending_drains": sorted(self._draining),
                "decisions": list(self.decisions[-16:])}
