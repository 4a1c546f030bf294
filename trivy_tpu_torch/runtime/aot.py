"""Boot-time kernel build and warm launch (reference:
``trivy_tpu/runtime/aot.py``; docs/serving.md "Elastic lifecycle").

A scan server that boots cold pays its first-use costs in the middle
of the first requests: ``nvcc`` for each hand-written kernel (seconds
each), the library loads, and the first launches at each shape (the
caching allocator's first blocks, the descriptor upload). This module
makes them a boot cost, and one that a later boot on the same
directory does not pay again:

* :func:`enable_persistent_cache` points the kernels' build directory
  at ``<cache_dir>/kernels``. That directory is the port's whole
  persistent cache: ``ops/cuda_build.py`` keys each library by the
  hash of its source, name and flags, so a boot that finds it builds
  nothing and only loads. The reference's jax compilation cache has no
  torch counterpart beyond it — eager torch compiles nothing per
  shape — and the port keeps no other cache.
* :func:`build_kernels` builds (or loads from that directory) both
  kernel libraries, ``csrc/dfa_blockmask.cu`` and
  ``csrc/code_blockmask.cu``, the builds side by side.
* :func:`precompile_dfa_shapes` launches ``dfa_blockmask`` (the fused
  secret sieve) once at each rung of :data:`DEFAULT_SEG_BUCKETS`, and
  :func:`precompile_interval_shapes` the resident interval match
  (``ops/intervals.py::interval_hits_resident``) once at each rung of
  :data:`DEFAULT_PAIR_BUCKETS`, on zero inputs.
* a JSON **manifest** in the cache dir, keyed by ``sha256(torch
  version | CUDA version | device name | kind | shape | table hash)``,
  records which keyed shapes earlier boots launched — the
  ``trivy_tpu_compile_cache_{hits,misses}`` split. Any component of
  the key changing (a torch upgrade, another card, a new rule set)
  misses cleanly into a fresh entry; stale entries are inert, never
  wrong.

Zero inputs are inert in every kernel here: zero segments hit no
pattern and no class run, and a zero interval row (flags 0) matches
nothing — the property the serving path's pad rows already rely on. A
warm launch whose zero input hits anything raises, and so does a
kernel that fails to build or launch: unlike the reference, whose
precompile only logs a failure, the port's boot fails rather than
serve on a kernel it could not run.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional, Tuple

import numpy as np

log = logging.getLogger("trivy_tpu_torch.runtime.aot")

MANIFEST_NAME = "trivy_tpu_aot_manifest.json"
KERNEL_DIR = "kernels"

# default ladder rungs warmed at boot: the small end, where first
# requests actually land (a cold fleet's first scans are small
# batches; the big rungs amortize their own first launch once traffic
# exists to fill them)
DEFAULT_PAIR_BUCKETS = (64, 128, 256)
DEFAULT_SEG_BUCKETS = (256, 512)


class CompileCacheMetrics:
    """Cumulative compile-cache counters, one singleton per
    process. ``bytes`` is computed at snapshot time from the cache
    directory (the kernel libraries and the manifest are shared state
    on disk, not an in-process accumulator)."""

    _KEYS = ("hits", "misses", "precompiled")

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in self._KEYS}
        self._dir = ""
        self._seconds = 0.0

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def add_seconds(self, seconds: float) -> None:
        with self._lock:
            self._seconds += max(0.0, seconds)

    def set_dir(self, path: str) -> None:
        with self._lock:
            self._dir = path

    def reset(self) -> None:
        """Test hook — production code never calls this."""
        with self._lock:
            for k in self._c:
                self._c[k] = 0
            self._dir = ""
            self._seconds = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._c)
            out["dir"] = self._dir
            out["seconds"] = round(self._seconds, 6)
        out["bytes"] = _dir_bytes(out["dir"])
        return out


COMPILE_CACHE_METRICS = CompileCacheMetrics()


def _dir_bytes(path: str) -> int:
    if not path or not os.path.isdir(path):
        return 0
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                # racing rewrite — a size gauge tolerates it
                continue
    return total


def _wrappers() -> tuple:
    from ..ops import dfa_cuda, keywords_cuda
    return ((dfa_cuda, "dfa_blockmask"), (keywords_cuda, "code_blockmask"))


def enable_persistent_cache(cache_dir: str) -> str:
    """Point the kernel libraries' build directory at
    ``<cache_dir>/kernels`` (created if missing) for every kernel not
    loaded yet, and book ``cache_dir`` as the compile cache. Returns
    the build directory, or "" without a ``cache_dir``."""
    if not cache_dir:
        return ""
    build_dir = os.path.join(cache_dir, KERNEL_DIR)
    os.makedirs(build_dir, exist_ok=True)
    for mod, _name in _wrappers():
        if mod._lib is None:
            mod.BUILD_DIR = build_dir
    COMPILE_CACHE_METRICS.set_dir(cache_dir)
    log.info("kernel build cache at %s", build_dir)
    return build_dir


def build_kernels(build_dir: str = "") -> dict:
    """Build (or find already built) both kernel libraries, the nvcc
    runs side by side, then load each. Returns per kernel ``built``
    (whether this call ran nvcc), ``build_s``, ``load_s`` and the
    library's ``path``. Raises when a kernel does not build."""
    from ..ops import cuda_build
    out = {}

    def one(mod, name):
        target = build_dir or mod.BUILD_DIR
        probe = cuda_build.library_path(mod.SOURCE, name, target)
        existed = os.path.exists(probe)
        t0 = time.monotonic()
        path = cuda_build.build(mod.SOURCE, name, target)
        return name, {"built": not existed,
                      "build_s": round(time.monotonic() - t0, 4),
                      "path": path}

    mods = _wrappers()
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        for name, row in pool.map(lambda m: one(*m), mods):
            out[name] = row
    for mod, name in mods:
        t0 = time.monotonic()
        mod._load()
        out[name]["load_s"] = round(time.monotonic() - t0, 4)
    return out


def _device_name(device) -> str:
    """The card's name, ``cpu``, or ``numpy`` (None: ``cpu-ref``)."""
    import torch
    if device is None:
        return "numpy"
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def cache_key(kind: str, shape_sig: str, table_hash: str = "",
              device="cpu") -> str:
    """Manifest key: torch version × CUDA version × device name ×
    kernel kind × shape × rule-set/table hash — the invalidation
    domain. Any component changing misses into a fresh entry."""
    import torch
    raw = (f"{torch.__version__}|{torch.version.cuda or ''}|"
           f"{_device_name(device)}|{kind}|{shape_sig}|{table_hash}")
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


class _Manifest:
    """The keyed-shape manifest beside the kernel libraries. Read
    once, appended per precompile, written atomically — two replicas
    racing a boot at worst both launch (correct, just not free)."""

    def __init__(self, cache_dir: str):
        self.path = os.path.join(cache_dir, MANIFEST_NAME) \
            if cache_dir else ""
        self.entries: dict = {}
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path, encoding="utf-8") as f:
                    doc = json.load(f)
                if isinstance(doc, dict):
                    self.entries = doc
            except (OSError, ValueError) as e:
                log.warning("unreadable AOT manifest %s: %r",
                            self.path, e)

    def seen(self, key: str) -> bool:
        return key in self.entries

    def note(self, key: str, meta: dict) -> None:
        self.entries[key] = meta
        if not self.path:
            return
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.entries, f, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError as e:
            log.warning("AOT manifest write failed: %r", e)


def _materialize(out):
    """Wait for the launch (a warm launch pays its whole cost HERE,
    not on the first request) and count what the zero input hit."""
    import torch
    hits = 0
    for t in out if isinstance(out, tuple) else (out,):
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            hits += int((t.reshape(-1).to(torch.int32) != 0).sum())
        else:
            hits += int(np.count_nonzero(t))
    return hits


def _warm_call(fn, args, key: str, manifest: _Manifest,
               meta: dict) -> float:
    """Run one kernel on inert inputs, booking the manifest hit/miss
    and the wall. Returns seconds; raises when the zero input hit."""
    t0 = time.monotonic()
    if manifest.seen(key):
        COMPILE_CACHE_METRICS.inc("hits")
    else:
        COMPILE_CACHE_METRICS.inc("misses")
    hits = _materialize(fn(*args))
    if hits:
        raise RuntimeError(f"warm launch {meta} on zero inputs hit "
                           f"{hits} entries: the kernel is not inert")
    dt = time.monotonic() - t0
    manifest.note(key, dict(meta, seconds=round(dt, 4)))
    COMPILE_CACHE_METRICS.inc("precompiled")
    COMPILE_CACHE_METRICS.add_seconds(dt)
    return dt


def _torch_device(backend: str):
    import torch
    if backend == "cpu-ref":
        return None
    if backend == "cuda":
        from .. import resolve_device
        return resolve_device("cuda")
    return torch.device("cpu")


def precompile_interval_shapes(
        buckets: Iterable[int] = DEFAULT_PAIR_BUCKETS,
        cache_dir: str = "", backend: str = "cuda") -> dict:
    """Launch the resident interval match over the pair-row ladder
    (``detect/batch.py::_job_bucket`` rungs): [P] zero ranks and row
    indices into a one-row zero table (flags 0: never vulnerable), so
    every launch is inert; ``cpu-ref`` runs the numpy match."""
    import torch

    from ..ops.intervals import (MAX_INTERVALS, interval_hits_host,
                                 interval_hits_resident)
    device = _torch_device(backend)
    manifest = _Manifest(cache_dir)
    out = {"kernel": "interval_resident", "shapes": [], "seconds": 0.0}
    if device is None:
        iv = np.zeros((1, MAX_INTERVALS), np.int32)
        table = (iv, iv, iv, iv, np.zeros(1, np.int32))

        def fn(rank, idx):
            return interval_hits_host(rank, *(a[idx] for a in table))
    else:
        iv = torch.zeros((1, MAX_INTERVALS), dtype=torch.int32,
                         device=device)
        table = (iv, iv, iv, iv,
                 torch.zeros(1, dtype=torch.int32, device=device))

        def fn(rank, idx):
            return interval_hits_resident(rank, idx, *table)
    for p in sorted(set(int(b) for b in buckets if int(b) > 0)):
        if device is None:
            args = (np.zeros(p, np.int32), np.zeros(p, np.int64))
        else:
            args = (torch.zeros(p, dtype=torch.int32, device=device),
                    torch.zeros(p, dtype=torch.int64, device=device))
        key = cache_key("interval_resident", f"P{p}xM{MAX_INTERVALS}",
                        device=device)
        dt = _warm_call(fn, args, key, manifest,
                        {"kernel": "interval_resident", "P": p,
                         "backend": backend})
        out["shapes"].append(p)
        out["seconds"] += dt
    out["seconds"] = round(out["seconds"], 4)
    return out


def precompile_dfa_shapes(table, run_specs: tuple = (),
                          buckets: Iterable[int] = DEFAULT_SEG_BUCKETS,
                          cache_dir: str = "",
                          backend: str = "cuda") -> dict:
    """Launch the fused secret sieve (``ops/dfa.py::full_sieve``: one
    ``dfa_blockmask`` launch on the card) over the segment-buffer
    ladder (``ops/keywords.py::_bucket`` rungs × SEG_LEN columns),
    staging the table's resident arrays and its kernel descriptor as a
    side effect. Keyed on the table's ``rules_hash`` so a custom rule
    set misses into its own entries."""
    import torch

    from ..ops.dfa import dfa_masks_host, full_sieve
    from ..ops.runs import run_hits_host
    from ..secret.batch import SEG_LEN
    device = _torch_device(backend)
    manifest = _Manifest(cache_dir)
    out = {"kernel": "dfa_blockmask", "shapes": [], "seconds": 0.0}
    specs = tuple(run_specs)
    if device is None:
        def fn(seg):
            return dfa_masks_host(seg, table), run_hits_host(seg, specs)
    else:
        dev = table.device_tables(device)

        def fn(seg):
            return full_sieve(seg, table, dev, specs)
    for b in sorted(set(int(x) for x in buckets if int(x) > 0)):
        seg = np.zeros((b, SEG_LEN), np.uint8) if device is None \
            else torch.zeros((b, SEG_LEN), dtype=torch.uint8,
                             device=device)
        key = cache_key("dfa_blockmask", f"B{b}xL{SEG_LEN}",
                        table.rules_hash, device=device)
        dt = _warm_call(fn, (seg,), key, manifest,
                        {"kernel": "dfa_blockmask", "B": b,
                         "rules_hash": table.rules_hash,
                         "backend": backend})
        out["shapes"].append(b)
        out["seconds"] += dt
    out["seconds"] = round(out["seconds"], 4)
    return out


def boot_precompile(cache_dir: str = "",
                    dfa_table=None,
                    run_specs: tuple = (),
                    pair_buckets: Optional[Tuple[int, ...]] = None,
                    seg_buckets: Optional[Tuple[int, ...]] = None,
                    backend: str = "cuda") -> dict:
    """The boot-time glue the server calls once: point the kernel
    build cache at ``cache_dir``, build (or load) both kernels on
    ``cuda``, then warm the interval and (when a table is supplied)
    DFA ladders. Returns the boot's split: ``build`` (per kernel),
    ``build_s``, ``kernels`` (per kernel kind: shapes and launch
    seconds), ``hits``/``misses`` of this boot, and ``seconds``. Raises
    when a kernel does not build or launch, or a warm launch is not
    inert."""
    t0 = time.monotonic()
    before = COMPILE_CACHE_METRICS.snapshot()
    build_dir = enable_persistent_cache(cache_dir)
    summary = {"cache_dir": cache_dir, "persistent": bool(build_dir),
               "backend": backend, "build": {}, "kernels": []}
    if backend == "cuda":
        _torch_device(backend)      # no card: raise before any build
        summary["build"] = build_kernels(build_dir)
    summary["build_s"] = round(time.monotonic() - t0, 4)
    if any(row["built"] for row in summary["build"].values()):
        # a kernel built at boot is the port's compile bill
        COMPILE_CACHE_METRICS.add_seconds(summary["build_s"])
    summary["kernels"].append(precompile_interval_shapes(
        pair_buckets or DEFAULT_PAIR_BUCKETS, cache_dir, backend))
    if dfa_table is not None:
        summary["kernels"].append(precompile_dfa_shapes(
            dfa_table, run_specs, seg_buckets or DEFAULT_SEG_BUCKETS,
            cache_dir, backend))
    after = COMPILE_CACHE_METRICS.snapshot()
    summary["hits"] = after["hits"] - before["hits"]
    summary["misses"] = after["misses"] - before["misses"]
    summary["seconds"] = round(time.monotonic() - t0, 4)
    log.info("boot precompile: %d kernels in %.2fs (built %s)",
             len(summary["kernels"]), summary["seconds"],
             sorted(k for k, v in summary["build"].items()
                    if v["built"]))
    return summary
