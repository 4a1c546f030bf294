"""Multi-host seam: several scanner processes as one logical scanner
(reference: ``trivy_tpu/parallel/multihost.py``).

A single process drives at most one host's cards. The contract has
three pieces, each testable without a pod:

* :func:`topology_from_env` — the env/flag seam. A pod is described by
  ``TRIVY_TPU_COORDINATOR`` (host:port of process 0),
  ``TRIVY_TPU_NUM_PROCESSES`` and ``TRIVY_TPU_PROCESS_ID`` (CLI:
  ``--coordinator`` / ``--num-processes`` / ``--process-id``). Absent
  env = single host, everything degenerates to the single-process
  paths.
* :func:`initialize` — the idempotent join: the reference's
  ``jax.distributed.initialize`` becomes
  ``torch.distributed.init_process_group`` at ``tcp://{coordinator}``
  (``nccl`` when this process drives a card, ``gloo`` when it does
  not); on a single host it is a no-op.
* :func:`host_shard_layout` / :func:`local_indices` — the
  work-placement function: greedy LPT (``parallel/balance.py``) of
  per-item byte volumes over the process set. It is a PURE function
  of (volumes, num_processes), so every host computes the identical
  global layout from the same inputs with no coordination traffic, and
  the union of the per-host scans equals a single-host scan of the
  whole fleet.

Departure from the reference: after its join, a JAX process sees the
GLOBAL device set, and ``global_mesh`` spans every host's chips. A
torch process has no global device set: its mesh is its own cards
(:func:`global_mesh`), and the cross-host split is
:func:`local_indices` — which is what the reference's simulated hosts
(``simhost``) and its pod already do with their work.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("trivy_tpu_torch.parallel.multihost")

ENV_COORDINATOR = "TRIVY_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "TRIVY_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "TRIVY_TPU_PROCESS_ID"
ENV_LOCAL_DEVICES = "TRIVY_TPU_LOCAL_DEVICES"


@dataclass(frozen=True)
class HostTopology:
    """One process's view of the pod."""

    num_processes: int = 1
    process_id: int = 0
    coordinator: str = ""       # "host:port" of process 0
    local_devices: int = 0      # 0 = every visible card

    @property
    def multi_host(self) -> bool:
        return self.num_processes > 1

    def validate(self) -> "HostTopology":
        if self.num_processes < 1:
            raise ValueError(
                f"num_processes must be >= 1, got "
                f"{self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} outside "
                f"[0, {self.num_processes})")
        if self.multi_host and not self.coordinator:
            raise ValueError(
                "multi-host topology needs a coordinator "
                f"address ({ENV_COORDINATOR} or --coordinator)")
        return self


def topology_from_env(env=None, coordinator: str = "",
                      num_processes: int = 0,
                      process_id: int = -1) -> HostTopology:
    """Resolve the topology: explicit args (CLI flags) win over the
    ``TRIVY_TPU_*`` env contract; a typo'd value fails the run up
    front with ValueError instead of silently scanning a partial
    fleet on one host."""
    env = os.environ if env is None else env

    def _env_int(key, default):
        raw = env.get(key, "")
        if not raw:
            return default
        try:
            return int(raw)
        except ValueError:
            raise ValueError(f"bad {key}={raw!r}: not an integer")

    topo = HostTopology(
        num_processes=int(num_processes) if num_processes > 0
        else _env_int(ENV_NUM_PROCESSES, 1),
        process_id=int(process_id) if process_id >= 0
        else _env_int(ENV_PROCESS_ID, 0),
        coordinator=coordinator or env.get(ENV_COORDINATOR, ""),
        local_devices=_env_int(ENV_LOCAL_DEVICES, 0),
    )
    return topo.validate()


_INIT_LOCK = threading.Lock()
_INITIALIZED: dict = {}


def initialize(topo: Optional[HostTopology] = None,
               device_type: str = "cpu") -> bool:
    """Join this process into the pod's process group
    (``torch.distributed.init_process_group`` at
    ``tcp://{coordinator}``, with this topology's world size and rank;
    ``nccl`` when this process drives a card, ``device_type`` "cuda",
    else ``gloo``).
    Idempotent per topology; single-host topologies are a no-op.
    Returns True when the process group was (or already had been)
    joined."""
    topo = topology_from_env() if topo is None else topo.validate()
    if not topo.multi_host:
        return False
    key = (topo.coordinator, topo.num_processes, topo.process_id)
    with _INIT_LOCK:
        if _INITIALIZED.get(key):
            return True
        if _INITIALIZED:
            raise RuntimeError(
                f"torch.distributed already initialized with "
                f"{next(iter(_INITIALIZED))}, cannot re-join as "
                f"{key}")
        import torch.distributed as dist
        backend = "nccl" if device_type == "cuda" else "gloo"
        log.info("joining pod: coordinator=%s process %d/%d (%s)",
                 topo.coordinator, topo.process_id,
                 topo.num_processes, backend)
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{topo.coordinator}",
            world_size=topo.num_processes, rank=topo.process_id)
        _INITIALIZED[key] = True
    return True


def global_mesh(topo: Optional[HostTopology] = None,
                rules_shards: Optional[int] = None):
    """The mesh this process scans on: its own cards (the first
    ``topo.local_devices`` of them when set), after joining the pod
    when ``topo`` describes one. The cross-host split of the work is
    :func:`local_indices`, not the mesh (module docstring)."""
    from .mesh import make_mesh
    n = None
    if topo is not None:
        initialize(topo, device_type="cuda")
        n = topo.local_devices or None
    return make_mesh(n, rules_shards=rules_shards)


# --- deterministic cross-host work placement ---

def host_shard_layout(volumes: list, num_processes: int) -> list:
    """``volumes[i]`` (bytes of work item i) → owning process id,
    greedy LPT over the process set (``parallel/balance.py`` — the same
    packer that balances rows over devices, one level up). Pure and
    deterministic: every host derives the identical global layout
    from the shared fleet spec, which is what makes "no coordinator
    traffic per item" safe."""
    from .balance import balance_by_volume
    return balance_by_volume([int(v) for v in volumes],
                             max(1, int(num_processes)))


def local_indices(volumes: list, topo: HostTopology) -> list:
    """The work items THIS process owns under the global layout,
    in input order."""
    assign = host_shard_layout(volumes, topo.num_processes)
    return [i for i, p in enumerate(assign)
            if p == topo.process_id]
