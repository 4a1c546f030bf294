"""Device mesh construction and the per-shard launch.

A 2-D ``(data, rules)`` grid of ``torch.device``s: ``data`` shards
batch items (segments, files, package rows), ``rules`` shards literal
code tables. On one device both axes are 1 and every sharded function
degenerates to its local form, on the same code path.

The reference (``trivy_tpu/parallel/mesh.py``) builds a
``jax.sharding.Mesh`` and runs ONE ``shard_map`` program per shape,
because a per-device dispatch loop paid a jit compile per (device,
shape). PyTorch runs eagerly, so the port launches each shard's work
itself (``per_shard``): in order, from the calling thread, on a side
stream of the shard's device that first waits for the caller's stream
there, with an event recorded behind it. Whoever reads a shard's
output waits on that event first. Shard k's side stream on a device is
made once per process (``side_stream``) and serves every later launch
of shard k there, so the caching allocator, which keeps its free blocks
per stream, reuses that stream's buffers from one call to the next.
The unsharded paths run on ``local_mesh(device)``, a 1 × 1 mesh.

A mesh's device list may name one device several times (``[cpu] *
8`` in the CPU tests, ``[cuda:0] * 4`` on one card): its shards then
share that device's resident tables and kernel build, and keep their
own streams.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device

DATA_AXIS = "data"
RULES_AXIS = "rules"


class DeviceMesh:
    """``devices``: a [data, rules] numpy object array of
    ``torch.device``; ``shape``: {axis name: size}, as a JAX mesh's.
    ``local`` marks ``local_mesh``'s 1 × 1 mesh, the unsharded form,
    which resident tables place as one device."""

    local = False

    def __init__(self, grid: np.ndarray):
        self.devices = grid
        self.shape = {DATA_AXIS: int(grid.shape[0]),
                      RULES_AXIS: int(grid.shape[1])}

    @property
    def flat(self) -> list:
        """Every shard's device, data-major: shard k of a flat split."""
        return list(self.devices.flat)

    @property
    def distinct(self) -> list:
        """Each device once, in first-seen order."""
        return list(dict.fromkeys(self.flat))

    @property
    def device_type(self) -> str:
        return self.flat[0].type

    def __repr__(self) -> str:
        return (f"DeviceMesh(data={self.shape[DATA_AXIS]}, "
                f"rules={self.shape[RULES_AXIS]}, "
                f"devices={[str(d) for d in self.flat]})")


def local_mesh(device) -> DeviceMesh:
    """The 1 × 1 mesh of one device: the unsharded form of every
    sharded function."""
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = torch.device(device)
    mesh = DeviceMesh(grid)
    mesh.local = True
    return mesh


def make_mesh(n_devices: Optional[int] = None,
              rules_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """Build a mesh with axes ``("data", "rules")``.

    ``devices`` defaults to every visible CUDA card (it raises where
    there is none: a mesh never drops to the CPU on its own); a given
    list may repeat a device. ``rules_shards`` defaults to 2 when the
    device count allows a non-trivial split (≥4 and even), else 1 —
    rule-group tables are small, so the data axis gets the bulk of the
    parallelism."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh spans one device type, not "
                         f"{sorted({d.type for d in devices})}")

    if rules_shards is None:
        rules_shards = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    if n_devices % rules_shards:
        raise ValueError(
            f"n_devices={n_devices} not divisible by "
            f"rules_shards={rules_shards}")
    data = n_devices // rules_shards
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices
    return DeviceMesh(grid.reshape(data, rules_shards))


def mesh_axis_sizes(mesh) -> tuple:
    """(data, rules) axis sizes of a mesh built by make_mesh."""
    return (mesh.shape[DATA_AXIS], mesh.shape[RULES_AXIS])


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is ≥ max(n, 1)."""
    n = max(n, 1)
    return ((n + m - 1) // m) * m


def check_mesh(mesh, backend: str) -> None:
    """Raise unless ``mesh`` is None or a ``DeviceMesh`` whose devices
    are ``backend``'s type (``cuda`` or ``cpu``; ``cpu-ref`` runs numpy
    and takes any mesh)."""
    if mesh is None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    if backend != "cpu-ref" and mesh.device_type != backend:
        raise ValueError(f"backend {backend!r} on a mesh of "
                         f"{mesh.device_type} devices")


_SIDE_STREAMS: dict = {}
_SIDE_LOCK = threading.Lock()


def side_stream(device: torch.device, k: int):
    """Shard ``k``'s side stream on ``device``, made on first use and
    kept for the process: one stream per (device, shard), whichever
    mesh launches that shard."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, k)
    with _SIDE_LOCK:
        stream = _SIDE_STREAMS.get(key)
        if stream is None:
            stream = _SIDE_STREAMS[key] = torch.cuda.Stream(device=device)
    return stream


def per_shard(mesh: DeviceMesh, fn) -> list:
    """``fn(k, device)`` for every flat shard k, in order, from this
    thread (so the kernel wrappers' launch counts stay exact): on a
    card, on shard k's side stream of that device (``side_stream``)
    that first waits for the calling thread's current stream there (so
    it sees the uploads enqueued before it), with an event recorded
    behind it; on the CPU, inline. Returns [(result, event or None)];
    each result must keep every tensor its work touches alive until its
    event has passed."""
    launched = []
    for k, device in enumerate(mesh.flat):
        if device.type != "cuda":
            launched.append((fn(k, device), None))
            continue
        with torch.cuda.device(device):
            stream = side_stream(device, k)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                out = fn(k, device)
                event = torch.cuda.Event()
                event.record(stream)
        launched.append((out, event))
    return launched


def wait_all(launched: list) -> None:
    """Wait on the host for every shard event of ``per_shard``."""
    for _out, event in launched:
        if event is not None:
            event.synchronize()
