"""A batch SBOM service: closed-loop clients over a pool of BOMs.

The pool is drawn from the seed as the workload's ``boms`` say: per
shape, ``count`` CycloneDX documents (``boms.make_bom``), each with
packages and versions drawn under its own seed. Every seed has the
same shapes, counts and sizes; the seed draws the versions and the
order of each shape's documents, which are spread evenly over the pool
(``mix.spread``). The pool is written once per seed into the cache and
reused by later runs of that seed.

``clients`` threads each take the next ``per_call`` documents of the
pool, call ``BatchScanRunner.scan_boms`` on one shared scheduled
runner and render each report (the ``sbom`` command's JSON), in a
closed loop. Set-up starts them and waits until ``ramp`` documents
were written: the kernels are loaded and the clients are in their
loop when the window opens. A document counts when its call returns
inside the window, over the window's length: the clients are a closed
loop, each waiting on its own call, with nothing dispatched ahead, and
a call still running at the close is waited for but not counted. A
pass over the pool scans each document once.
Clients that reach the pool's end start the next pass on a new runner
with an empty blob cache, as the sweep does, so the pool never runs
dry and never caps the rate; no pass finds a document of an earlier
one in its runner.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np

from ..reference import expected_bom
from .boms import make_bom
from .mix import spread

KIND_KEY = "shape"
MANIFEST = "pool.json"


def _rng(seed: int, *keys: int):
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *keys])


def build(params: dict, n_pkgs: dict, seed: int, pool_dir: str) -> dict:
    """Write the pool of ``seed`` under ``pool_dir`` (unless a complete
    one is there) and return its manifest: {"boms": [{"path", "shape",
    "index", "truth"}] in the order the clients take them}."""
    path = os.path.join(pool_dir, MANIFEST)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    shutil.rmtree(pool_dir, ignore_errors=True)
    os.makedirs(pool_dir)
    boms = []
    for s, shape in enumerate(params["boms"]):
        for i in range(shape["count"]):
            doc, truth = make_bom(shape, n_pkgs, _rng(seed, s, i),
                                  serial=(s << 20) + i)
            out = os.path.join(pool_dir, f"{shape['family']}-{i}.cdx.json")
            with open(out, "w") as f:
                json.dump(doc, f)
            boms.append({"path": out, "shape": s, "index": i,
                         "truth": truth})
    manifest = {"boms": spread(boms, KIND_KEY, _rng(seed, 99))}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)
    return manifest


def _read(entries: list) -> list:
    out = []
    for e in entries:
        with open(e["path"], "rb") as f:
            out.append((e["path"], f.read()))
    return out


def expect(entry: dict, params: dict, plans: list) -> dict:
    """The reference's sets of one finished BOM."""
    return expected_bom(entry, params["boms"][entry["shape"]], plans)


class Load:
    """The clients over one pool. ``system``: the harness's view of the
    program (``make_runner(k)`` → (runner, options) on an empty blob
    cache of pass ``k``; ``render(report)`` → text)."""

    def __init__(self, system, manifest: dict, params: dict):
        self.system = system
        self.boms = manifest["boms"]
        self.clients = params["clients"]
        self.per_call = params["per_call"]
        self.ramp = params["ramp"]
        self.lock = threading.Lock()
        self.passes = 0
        self.runners: list = []       # every pass's runner, in order
        self.runner = self.options = None
        self.next = 0                 # the pass's next document
        self._start_pass()
        self.stop = threading.Event()
        self.threads: list = []
        self.done: list = []          # (entry, text, monotonic time)
        self.failed: list = []        # (entry, error, monotonic time)
        self.errors: list = []

    def _start_pass(self) -> None:
        """A new pass over the pool on a new runner (under the lock, or
        before the clients start). Earlier runners stay open until the
        clients have stopped: a client may still be in a call on one."""
        self.runner, self.options = self.system.make_runner(self.passes)
        self.runners.append(self.runner)
        self.passes += 1
        self.next = 0

    def _take(self) -> tuple:
        with self.lock:
            if self.next >= len(self.boms):
                self._start_pass()
            a = self.next
            self.next = a + self.per_call
            return self.boms[a:a + self.per_call], self.runner, \
                self.options

    def _client(self) -> None:
        try:
            while not self.stop.is_set():
                batch, runner, options = self._take()
                results = runner.scan_boms(_read(batch), options)
                out = []
                for e, res in zip(batch, results):
                    if res.error or res.status == "failed":
                        out.append((e, None, res.error))
                    else:
                        out.append((e, self.system.render(res.report), ""))
                at = time.monotonic()
                with self.lock:
                    for e, text, err in out:
                        if text is None:
                            self.failed.append((e, err, at))
                        else:
                            self.done.append((e, text, at))
        except Exception as e:   # noqa: BLE001 — reported as a failed
            # run, never swallowed
            self.errors.append(repr(e))

    def warm_up(self, limit_s: float = 600.0) -> None:
        """Start the clients and wait for ``ramp`` BOMs."""
        self.threads = [threading.Thread(target=self._client,
                                         name=f"bom-client-{c}")
                        for c in range(self.clients)]
        for t in self.threads:
            t.start()
        deadline = time.monotonic() + limit_s
        while len(self.done) < self.ramp and not self.errors and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        if self.errors or len(self.done) < self.ramp:
            self._stop()
            self._close()
            raise RuntimeError(f"{len(self.done)} of {self.ramp} ramp "
                               f"BOMs; {self.errors[:1]}")

    def _stop(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join()

    def _close(self) -> None:
        for runner in self.runners:
            runner.close()

    def run(self, seconds: float) -> dict:
        """Scan for ``seconds``, then stop the clients; the same keys
        as ``image_sweep.Load.run``, with ``window_s`` = ``seconds``."""
        with self.lock:
            before = {id(r): r.scheduler.stats() for r in self.runners}
            n_done, n_failed = len(self.done), len(self.failed)
        t0 = time.monotonic()
        time.sleep(seconds)
        t_end = t0 + seconds
        self._stop()
        c0 = time.monotonic()
        if self.errors:
            self._close()
            raise RuntimeError(f"a client failed: {self.errors[0]}")
        sched = [(before.get(id(r)), r.scheduler.stats())
                 for r in self.runners]
        self._close()
        done = [(e, text, at - t0) for e, text, at in self.done[n_done:]
                if at <= t_end]
        return {"done": done,
                "failed": [(e, err) for e, err, at in self.failed[n_failed:]
                           if at <= t_end],
                "passes": self.passes, "window_s": seconds,
                "in_window": len(done), "close_s": time.monotonic() - c0,
                "sched": sched}
