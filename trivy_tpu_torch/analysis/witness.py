"""Runtime lock-order witness (reference:
``trivy_tpu/analysis/witness.py``).

The static ``lock-discipline`` rule proves what it can see; the
witness catches what it can't: an opt-in instrumented-lock wrapper
that records the *process-wide* lock-acquisition order graph, keyed
by lock **creation site** (``module:line`` — the lockdep "lock
class" idea: every ``SchedMetrics._lock`` instance is one node), and

* raises :class:`LockOrderViolation` the moment two sites are ever
  acquired in opposite orders (the gauge-under-lock deadlock class,
  caught even when the interleaving that would actually deadlock
  never fires);
* raises :class:`PoolSelfJoinError` on a blocking join of a host-
  pool future from a host-pool thread (the pool self-join class).

Enable with ``TRIVY_TPU_LOCK_WITNESS=1`` (the reference's knob; the
CLI installs it before its heavy imports) or programmatically via
:func:`install_witness`. The port's seeded storms (the scheduler's
and the ring's) run under an installed witness.

Scope: only locks *constructed* by ``trivy_tpu_torch`` modules while
the witness is installed are wrapped; the ~49Hz profiler tick path
(``trivy_tpu_torch.obs.profiler``) is exclude-listed by module.

Departures, so that the reference's witness and this one can share a
process (the tests import both packages):

* the real factories are the interpreter's own (``_thread``'s lock
  and RLock, and the ``Condition`` class), never whatever
  ``threading.Lock`` is when this module is imported;
* uninstalling restores the factories found at install only while
  this witness's are still in place, so the reference's witness,
  installed under or over this one, stays in force;
* ``Future.result`` is left alone: the port's pool hands out futures
  of a subclass (tag ``_trivy_tpu_torch_hostpool``) whose ``result``
  checks for a self-join and then defers to whatever
  ``Future.result`` is, so each witness checks only its own pool.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from concurrent.futures import Future
from typing import List, Optional

_real_Lock = _thread.allocate_lock
_real_RLock = _thread.RLock
# the Condition class even when another witness has replaced
# threading.Condition by a factory: threading's own Event builds one
# through that factory, from a module no witness wraps
_real_Condition = threading.Condition \
    if isinstance(threading.Condition, type) \
    else type(threading.Event()._cond)


class LockOrderViolation(RuntimeError):
    """Two lock sites acquired in opposite orders somewhere in the
    process — a deadlock waiting for the right interleaving."""

    def __init__(self, cycle: List[str]):
        self.cycle = list(cycle)
        super().__init__(
            "lock-order cycle: " + " -> ".join(
                self.cycle + self.cycle[:1]))


class PoolSelfJoinError(RuntimeError):
    """A host-pool thread blocked on a future of its own pool."""


class OrderGraph:
    """Pure directed graph with incremental cycle detection —
    property-tested on seeded random acquisition schedules. NOT
    thread-safe; the witness serializes access."""

    def __init__(self):
        self.adj: dict = {}
        self.edge_set: set = set()

    def add_edge(self, a: str, b: str) -> Optional[List[str]]:
        """Record ``a`` held while ``b`` acquired. Returns the
        cycle path (``[a, b, ..., back-to-a]`` exclusive) if this
        edge closes one, else None. A cycle-closing edge is NOT
        recorded — recording it would make the dedup fast path
        swallow every later recurrence of the same inversion, and
        a violation that raised once into a broad except seam
        must keep raising."""
        if a == b:
            return None          # per-instance self-nesting is the
            # immediate-deadlock case Python raises on its own;
            # same-SITE different-instance nesting is legal
        if (a, b) in self.edge_set:
            return None
        # would b -> ... -> a exist already?
        cycle = self._path(b, a)
        if cycle is not None:
            return [a] + cycle
        self.edge_set.add((a, b))
        self.adj.setdefault(a, set()).add(b)
        return None

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        if src == dst:
            return [src]
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self.adj.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def edges(self) -> list:
        return sorted(self.edge_set)


class LockWitness:
    """The process-wide recorder: per-thread held stacks, the site
    graph, and the acquisition counters the bench overhead gate
    multiplies out."""

    EXCLUDE_MODULES = ("trivy_tpu_torch.obs.profiler",)
    PREFIXES = ("trivy_tpu_torch",)

    def __init__(self, extra_prefixes: tuple = ()):
        self.graph = OrderGraph()
        self.prefixes = self.PREFIXES + tuple(extra_prefixes)
        # raw lock: the witness's own bookkeeping must not recurse
        # into the patched factories
        self._glock = _real_Lock()
        self._tls = threading.local()
        # plain (GIL-approximate) counters: the acquire fast path
        # must not serialize every wrapped lock in the process on
        # one global lock — under-counting a storm by a few is
        # fine, a 20% contention tax is not (bench-gated <2%)
        self.acquisitions = 0
        self.nested = 0
        self.wrapped = 0
        self.pool_joins_checked = 0
        self.violations: list = []

    # --- policy ---

    def should_wrap(self, module: str) -> bool:
        if not module:
            return False
        if any(module.startswith(e) for e in self.EXCLUDE_MODULES):
            return False
        return any(module == p or module.startswith(p + ".")
                   for p in self.prefixes)

    # --- hooks (called by _WitnessLock) ---

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_acquire(self, site: str) -> None:
        held = self._stack()
        self.acquisitions += 1
        if held:
            self.nested += 1
            # fast path: every (held, site) edge already recorded —
            # two unlocked set lookups (GIL-safe; a stale read just
            # falls through to the locked recheck below, and
            # add_edge is idempotent)
            es = self.graph.edge_set
            if any(h != site and (h, site) not in es
                   for h in held):
                with self._glock:
                    for h in held:
                        cycle = self.graph.add_edge(h, site)
                        if cycle is not None:
                            self.violations.append(cycle)
                            held_copy = list(held)
                            raise LockOrderViolation(cycle) \
                                from _held_context(held_copy,
                                                   site)
        held.append(site)

    def on_release(self, site: str) -> None:
        held = self._stack()
        # release order may differ from acquisition order: drop the
        # LAST occurrence
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                return

    def stats(self) -> dict:
        with self._glock:
            return {
                "acquisitions": self.acquisitions,
                "nested_acquisitions": self.nested,
                "wrapped_locks": self.wrapped,
                "edges": len(self.graph.edge_set),
                "violations": len(self.violations),
                "pool_joins_checked": self.pool_joins_checked,
            }


def _held_context(held: list, site: str) -> RuntimeError:
    return RuntimeError(
        f"while holding {held} and acquiring {site}")


class _WitnessLock:
    """Wraps a real Lock/RLock; reentrancy-aware (edges recorded
    on the first acquisition only). Delegates the Condition
    protocol (``_release_save``/``_acquire_restore``/``_is_owned``)
    so ``threading.Condition`` accepts it."""

    def __init__(self, inner, site: str, witness: LockWitness):
        self._inner = inner
        self._site = site
        self._witness = witness
        self._local = threading.local()

    def _depth(self) -> int:
        return getattr(self._local, "n", 0)

    def _live(self) -> bool:
        # a lock wrapped during one witness session must go inert
        # once that witness uninstalls — it would otherwise keep
        # booking (and raising) forever after the test that
        # installed it finished
        return _ACTIVE is self._witness

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            # hot path: threading.local's per-thread __dict__ is
            # one lookup instead of getattr+setattr descriptor
            # round-trips (this wrapper rides every lock in the
            # witnessed process — bench-gated <2% attributed)
            d = self._local.__dict__
            n = d.get("n", 0)
            d["n"] = n + 1
            if n == 0 and _ACTIVE is self._witness:
                try:
                    self._witness.on_acquire(self._site)
                except BaseException:
                    d["n"] = n
                    self._inner.release()
                    raise
        return ok

    def release(self) -> None:
        d = self._local.__dict__
        n = d.get("n", 1)
        d["n"] = n - 1 if n > 0 else 0
        if n == 1 and _ACTIVE is self._witness:
            self._witness.on_release(self._site)
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # --- Condition protocol (RLock inner) ---

    def _release_save(self):
        if self._live():
            self._witness.on_release(self._site)
        n = self._depth()
        self._local.n = 0
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), n)
        self._inner.release()
        return (None, n)

    def _acquire_restore(self, state) -> None:
        inner_state, n = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        self._local.n = n
        if self._live():
            self._witness.on_acquire(self._site)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return self._depth() > 0

    def __repr__(self) -> str:
        return f"<WitnessLock {self._site} of {self._inner!r}>"


_ACTIVE: Optional[LockWitness] = None


def _caller_module(depth: int = 2) -> str:
    try:
        frame = sys._getframe(depth)
    except ValueError:  # pragma: no cover
        return ""
    return frame.f_globals.get("__name__", "") or ""


def _site(depth: int = 2) -> str:
    try:
        frame = sys._getframe(depth)
    except ValueError:  # pragma: no cover
        return "<unknown>"
    mod = frame.f_globals.get("__name__", "") or "<unknown>"
    return f"{mod}:{frame.f_lineno}"


def _make_lock():
    w = _ACTIVE
    if w is None or not w.should_wrap(_caller_module()):
        return _real_Lock()
    with w._glock:
        w.wrapped += 1
    return _WitnessLock(_real_Lock(), _site(), w)


def _make_rlock():
    w = _ACTIVE
    if w is None or not w.should_wrap(_caller_module()):
        return _real_RLock()
    with w._glock:
        w.wrapped += 1
    return _WitnessLock(_real_RLock(), _site(), w)


def _make_condition(lock=None):
    w = _ACTIVE
    if lock is None and w is not None and \
            w.should_wrap(_caller_module()):
        with w._glock:
            w.wrapped += 1
        lock = _WitnessLock(_real_RLock(), _site(), w)
    return _real_Condition(lock)


class _PoolFuture(Future):
    """A future of the port's host pool: ``result`` from a pool
    thread raises while a witness is active."""

    _trivy_tpu_torch_hostpool = True

    def result(self, timeout=None):
        from ..runtime.hostpool import on_pool_thread
        w = _ACTIVE
        if w is not None and on_pool_thread():
            with w._glock:
                w.pool_joins_checked += 1
            raise PoolSelfJoinError(
                "host-pool thread blocked on a future of its own "
                "pool — under saturation every worker waits on a "
                "worker and the pool deadlocks (pool self-join class)")
        return super().result(timeout)


def _tag_pool(pool) -> None:
    """Make every future the host pool hands out a
    :class:`_PoolFuture`, so its ``result`` can recognize a
    pool-thread self-join (``pool.map`` submits through here too)."""
    if pool is None or getattr(pool, "_torch_witness_tagged", False):
        return
    orig = pool.submit

    def submit(fn, *args, **kwargs):
        fut = orig(fn, *args, **kwargs)
        fut.__class__ = _PoolFuture
        return fut

    pool.submit = submit
    pool._torch_witness_tagged = True


_saved: Optional[tuple] = None    # the factories found at install


def install_witness(extra_prefixes: tuple = ()) -> LockWitness:
    """Activate the witness: patch the ``threading`` lock
    factories (caller-module filtered) and tag the host pool's
    futures. Returns the active witness; idempotent."""
    global _ACTIVE, _saved
    if _ACTIVE is not None:
        return _ACTIVE
    _ACTIVE = LockWitness(extra_prefixes=extra_prefixes)
    if threading.Lock is not _make_lock:
        _saved = (threading.Lock, threading.RLock,
                  threading.Condition)
        threading.Lock = _make_lock
        threading.RLock = _make_rlock
        threading.Condition = _make_condition
    # tag the host pool (existing and future instances)
    from ..runtime import hostpool
    _tag_pool(hostpool._POOL)
    if not getattr(hostpool, "_witness_hooked", False):
        orig_get = hostpool.get_host_pool

        def get_host_pool():
            pool = orig_get()
            if _ACTIVE is not None:
                _tag_pool(pool)
            return pool

        hostpool.get_host_pool = get_host_pool
        hostpool._witness_hooked = True
    return _ACTIVE


def uninstall_witness() -> None:
    """Deactivate and restore the factories found at install, if
    this witness's are still the ones in place (a witness installed
    over this one keeps its own). Locks already wrapped keep their
    wrappers but go INERT — every hook checks that the captured
    witness is still the active one, so a lock created during one
    test's witness session costs nothing and raises nothing
    afterward."""
    global _ACTIVE, _saved
    _ACTIVE = None
    if _saved is not None and threading.Lock is _make_lock:
        threading.Lock, threading.RLock, threading.Condition = _saved
    _saved = None


def active_witness() -> Optional[LockWitness]:
    return _ACTIVE


def maybe_install_from_env() -> Optional[LockWitness]:
    """Honor ``TRIVY_TPU_LOCK_WITNESS=1`` (the opt-in contract)."""
    if os.environ.get("TRIVY_TPU_LOCK_WITNESS", "") == "1":
        return install_witness()
    return None
