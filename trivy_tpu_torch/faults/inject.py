"""Fault injector: the imperative half of the fault layer (copied from
``trivy_tpu/faults/inject.py``).

A :class:`FaultInjector` holds one :class:`FaultSpec` plus the seeded
RNG and per-site counters, and is consulted at the pipeline's failure
domains:

* **cache** — :meth:`wrap_cache` interposes a :class:`FaultyCache`
  proxy between the circuit breaker and the real backend, so injected
  outages look exactly like a dead Redis/S3 to the breaker;
* **host** — :meth:`on_image_load` (corrupt layer tar) and
  :meth:`on_host_analyze` (slow-host stall) fire inside the
  scheduler's analyze phase;
* **device** — :meth:`on_device_dispatch` fires at the top of every
  coalesced device dispatch (transient errors, persistent errors,
  poisoned requests, stalls);
* **memo** — :meth:`on_memo_load` damages memo entry reads;
* **registry** — :meth:`on_blob_chunk` drops blob streams mid-body;
* **rpc** — :meth:`rpc_action` decides per POST whether to answer
  500 before processing or to process and then drop the response
  (the lost-response case idempotency keys exist for);
* **router** — :meth:`on_route_forward` drops every Nth forwarded
  response (replica-flaky) and :meth:`replica_kill_due` tells the
  harness when to kill a backend mid-storm (replica-kill), both
  drilling the scan router's replay-based failover.

On the card the scheduler lets only a :class:`DeviceFault` raised at
:meth:`on_device_dispatch` go down its bisect / quarantine ladder
(``sched/scheduler.py::_isolable``): an injected transient heals with
another launch on the card, a poisoned request finishes on the host
and is counted in ``host_fallbacks``.

Everything raised here derives from :class:`InjectedFault` so tests
and logs can tell injected failures from real ones; the cache flavor
additionally derives from ConnectionError because that is what the
breaker (and the CLI's error handling) treats as a backend outage.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from ..obs.trace import add_event
from .spec import FaultSpec, parse_fault_spec

log = logging.getLogger("trivy_tpu_torch.faults")


class InjectedFault(RuntimeError):
    """Marker base: this failure was injected, not organic."""


class DeviceFault(InjectedFault):
    """Injected device-dispatch failure."""


class CorruptLayerFault(InjectedFault, OSError):
    """Injected corrupt layer tar (an OSError, like a real one)."""


class CacheFault(InjectedFault, ConnectionError):
    """Injected cache-backend outage (a ConnectionError, like a real
    Redis/S3 failure — the circuit breaker keys off that)."""


class RegistryStreamFault(InjectedFault, OSError):
    """Injected mid-body registry stream drop (an OSError, so the
    blob fetch engine's connection-failure retry path — the one
    Range resume rides — handles it like a real torn stream)."""


class FaultInjector:
    """Deterministic, thread-safe fault decisions for one scenario."""

    def __init__(self, spec):
        if not isinstance(spec, FaultSpec):
            spec = parse_fault_spec(spec)
        self.spec = spec
        self._rng = random.Random(spec.seed)
        self._lock = threading.Lock()
        self.counters = {"cache_ops": 0, "cache_faults": 0,
                         "device_dispatches": 0, "device_faults": 0,
                         "image_loads": 0, "corrupt_faults": 0,
                         "stalls": 0, "rpc_posts": 0,
                         "rpc_errors": 0, "rpc_drops": 0,
                         "memo_loads": 0, "memo_corruptions": 0,
                         "routed_forwards": 0, "route_drops": 0,
                         "replica_kills": 0, "blob_chunks": 0,
                         "blob_stream_faults": 0}

    def _inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self.counters[name] += n
            return self.counters[name]

    def _hit(self, rate: float) -> bool:
        if rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < rate

    def stats(self) -> dict:
        with self._lock:
            return {"scenario": self.spec.scenario or "custom",
                    "seed": self.spec.seed, **self.counters}

    # --- cache site ---

    def wrap_cache(self, cache, resilient: bool = True):
        """Interpose the faulty proxy; with ``resilient`` (the
        production shape) the chain is
        ResilientCache(FaultyCache(backend)) so injected outages
        exercise the breaker instead of surfacing raw."""
        if not self.spec.wants_cache_faults():
            return cache
        from ..artifact.resilient import ResilientCache
        if isinstance(cache, ResilientCache):
            # already circuit-broken (remote --cache-backend):
            # interpose the faults BENEATH the existing breaker so
            # its stats/fallback describe the layer that actually
            # degrades — never stack a second breaker on top
            cache.primary = FaultyCache(cache.primary, self)
            return cache
        faulty = FaultyCache(cache, self)
        if not resilient:
            return faulty
        return ResilientCache(faulty, name="fault-injected")

    def on_cache_op(self, op: str, key: str = "") -> None:
        n = self._inc("cache_ops")
        spec = self.spec
        fail = (spec.cache_fail_ops == -1
                or n <= spec.cache_fail_ops
                or self._hit(spec.cache_fail_rate))
        if fail:
            self._inc("cache_faults")
            # fault injections land on the active request's span so
            # traces show what was injected (device-site faults are
            # recorded by the scheduler's dispatch spans instead)
            add_event("fault_injected", site="cache", op=op)
            raise CacheFault(
                f"injected cache outage ({op} {key!r}, op #{n})")

    # --- findings-memo site ---

    def on_memo_load(self, key: str, raw: bytes) -> bytes:
        """memo-poison scenario: damage the first N memo entry
        reads (truncate + flip a byte) so the checksum layer in
        trivy_tpu.memo must detect, drop, and recompute. Returns
        the (possibly corrupted) raw bytes."""
        spec = self.spec
        if not spec.wants_memo_faults():
            return raw
        n = self._inc("memo_loads")
        if spec.memo_corrupt_loads != -1 and \
                n > spec.memo_corrupt_loads:
            return raw
        self._inc("memo_corruptions")
        add_event("fault_injected", site="memo",
                  kind="corrupt-entry")
        if len(raw) < 8:
            return b"\x00garbage"
        # truncate mid-document and flip a byte — both a torn write
        # and bit rot in one artifact
        cut = max(8, len(raw) * 2 // 3)
        damaged = bytearray(raw[:cut])
        damaged[cut // 2] ^= 0x5A
        return bytes(damaged)

    # --- host site ---

    def on_image_load(self, name: str) -> None:
        self._inc("image_loads")
        if any(m in (name or "") for m in self.spec.corrupt):
            self._inc("corrupt_faults")
            add_event("fault_injected", site="host",
                      kind="corrupt-layer", target=name)
            raise CorruptLayerFault(
                f"injected corrupt layer tar in {name!r}")

    def on_host_analyze(self, name: str) -> None:
        spec = self.spec
        if spec.stall_s > 0 and self._hit(spec.stall_rate):
            self._inc("stalls")
            add_event("fault_injected", site="host", kind="stall",
                      seconds=spec.stall_s)
            time.sleep(spec.stall_s)

    # --- registry site (artifact/registry.py fetch_blob) ---

    def on_blob_chunk(self, digest: str, offset: int) -> None:
        """registry-flaky scenario: consulted once per received blob
        chunk. Drops the stream mid-body — past the first chunk, so
        there is real progress to resume — until
        ``blob_drop_first`` faults have fired (-1 = every stream,
        which exhausts the retry budget). The raised fault is an
        OSError, so the fetch engine treats it as a torn connection
        and retries with a Range resume."""
        spec = self.spec
        if not spec.wants_registry_faults():
            return
        self._inc("blob_chunks")
        if offset <= 0:
            return
        with self._lock:
            if spec.blob_drop_first != -1 and \
                    self.counters["blob_stream_faults"] >= \
                    spec.blob_drop_first:
                return
            self.counters["blob_stream_faults"] += 1
        add_event("fault_injected", site="registry",
                  kind="stream-drop", digest=digest, offset=offset)
        raise RegistryStreamFault(
            f"injected mid-body stream drop for {digest} "
            f"at offset {offset}")

    # --- device site ---

    def on_device_dispatch(self, names: list) -> None:
        n = self._inc("device_dispatches")
        spec = self.spec
        if spec.device_stall_s > 0:
            self._inc("stalls")
            time.sleep(spec.device_stall_s)
        poisoned = [name for name in names
                    if any(m in (name or "") for m in spec.poison)]
        if poisoned:
            self._inc("device_faults")
            raise DeviceFault(
                f"injected poison dispatch: {poisoned[0]!r}")
        if n <= spec.device_fail_batches \
                or self._hit(spec.device_fail_rate):
            self._inc("device_faults")
            raise DeviceFault(
                f"injected transient device error (dispatch #{n})")

    # --- router site (docs/serving.md "Scan router & autoscaling") ---

    def on_route_forward(self, replica: str) -> str:
        """'ok' | 'drop' — consulted by the router AFTER a forward
        completed: 'drop' discards the replica's response (the work
        happened, the client never hears back), forcing the replay-
        with-same-idempotency-key failover path. ``replica_flaky``
        scopes the drops to one named replica."""
        spec = self.spec
        n = self._inc("routed_forwards")
        if not spec.replica_flaky_every:
            return "ok"
        if spec.replica_flaky and replica != spec.replica_flaky:
            return "ok"
        if n % spec.replica_flaky_every == 0:
            self._inc("route_drops")
            add_event("fault_injected", site="router",
                      kind="response-drop", replica=replica)
            return "drop"
        return "ok"

    def replica_kill_due(self, forwards: int) -> bool:
        """replica-kill scenario: True exactly once, the first time
        the router's forward count reaches the seeded instant — the
        HARNESS (bench kill arm, tests) then kills the victim
        replica's process; the spec only carries when."""
        spec = self.spec
        if not spec.replica_kill_after:
            return False
        if forwards < spec.replica_kill_after:
            return False
        with self._lock:
            if self.counters["replica_kills"]:
                return False
            self.counters["replica_kills"] += 1
        add_event("fault_injected", site="router",
                  kind="replica-kill",
                  replica=spec.replica_kill or "(harness pick)")
        return True

    # --- rpc site ---

    def rpc_action(self, path: str) -> str:
        """'ok' | 'error' (answer 500 unprocessed) | 'drop' (process,
        then lose the response)."""
        if not self.spec.wants_rpc_faults():
            return "ok"
        n = self._inc("rpc_posts")
        spec = self.spec
        if n <= spec.rpc_error_first or self._hit(spec.rpc_error_rate):
            self._inc("rpc_errors")
            return "error"
        if n <= spec.rpc_error_first + spec.rpc_drop_first \
                or self._hit(spec.rpc_drop_rate):
            self._inc("rpc_drops")
            return "drop"
        return "ok"


class FaultyCache:
    """Cache proxy that consults the injector before every op. It
    deliberately fails BEFORE touching the inner backend — an outage
    means the backend is unreachable, not half-written."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def _op(self, op: str, key: str, *args):
        self.injector.on_cache_op(op, key)
        return getattr(self.inner, op)(key, *args)

    def put_artifact(self, artifact_id: str, info) -> None:
        return self._op("put_artifact", artifact_id, info)

    def put_blob(self, blob_id: str, blob) -> None:
        return self._op("put_blob", blob_id, blob)

    def get_artifact(self, artifact_id: str):
        return self._op("get_artifact", artifact_id)

    def get_blob(self, blob_id: str):
        return self._op("get_blob", blob_id)

    def missing_blobs(self, artifact_id: str, blob_ids: list) -> tuple:
        self.injector.on_cache_op("missing_blobs", artifact_id)
        return self.inner.missing_blobs(artifact_id, blob_ids)

    def delete_blobs(self, blob_ids: list) -> None:
        self.injector.on_cache_op("delete_blobs", "")
        return self.inner.delete_blobs(blob_ids)

    def clear(self) -> None:
        clear = getattr(self.inner, "clear", None)
        if clear is not None:
            clear()
