"""One run of one benchmark cell.

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The harness first makes or reuses
the seed's traffic pool; ``setup_s`` leaves that time out. Set-up
then loads the configuration's advisory database (its npz built by a
child process on the first run in the checkout, so that every run's
process starts as one that only loads it), builds the program as its command
builds it and warms the cell's shapes once; then the window
drives the program for ``--seconds`` and waits for what it submitted;
the cyclic collector's pauses in it are summed on standard error
(``gc_s``, ``gc_full_s``). With ``--trace 1`` the window is
profiled (``torch.profiler``) and its spans recorded, and the line
carries the cell's per-layer metrics instead of its end-to-end ones.
After the window a sample of what the program finished is compared
with the plain reference (``benchmark/compare.py``). The last line of
standard output is the result as one JSON object; the numbers compared
and their limits are also the last lines of standard error.

Caches live at fixed paths inside the checkout
(``benchmark/.cache``): the database npz, the traffic pools (one seed
each per cell; a new seed replaces the old), the kernel build
directories given to PyTorch and Triton, and each run's blob caches.
The program builds its own kernels under ``trivy_tpu_torch/_build``.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "trivy_tpu")


def _env(cache: str) -> None:
    """Fixed cache directories inside the checkout for every compiler
    the program could reach, set before torch is imported."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class System:
    """The program as a cell's traffic sees it: runners made on demand,
    each on its own empty blob cache and memo under the run's
    directory (removed with it when the run ends), and the command's
    JSON writer."""

    def __init__(self, entry: str, cfg: dict, run_dir: str, backend: str,
                 npz: str, store, tracer=None):
        self.entry, self.cfg, self.run_dir = entry, cfg, run_dir
        self.backend, self.npz, self.store = backend, npz, store
        self.tracer = tracer
        self.scanner = None

    def _dir(self, k) -> str:
        return os.path.join(self.run_dir, f"pass-{k}")

    def make_runner(self, k) -> tuple:
        from . import system
        args = system.cli_args(self.entry, self.cfg, self._dir(k),
                               self.backend, self.npz)
        if self.entry == "sbom":
            runner, options = system.bom_runner(args, self.store)
        else:
            runner, options, self.scanner = system.image_runner(
                args, self.store, self.scanner)
        if self.tracer is not None:
            runner.tracer = self.tracer
        return runner, options

    @staticmethod
    def render(report) -> str:
        from . import system
        return system.render(report)


def join_threads(before: set, timeout_s: float = 300.0) -> list:
    """Wait for every thread started since ``before`` (idents) to end,
    but the program's host pool, whose idle workers live as long as
    the process: a scheduler's device thread can outlive its
    ``close``. Returns the names of those still running."""
    from trivy_tpu_torch.runtime.hostpool import THREAD_PREFIX
    deadline = time.monotonic() + timeout_s
    late = []
    for t in threading.enumerate():
        if t.ident in before or t.name.startswith(THREAD_PREFIX) or \
                t is threading.current_thread():
            continue
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            late.append(t.name)
    return late


class GcPauses:
    """A ``gc.callbacks`` entry that sums the cyclic collector's pauses:
    every collection, and the full (generation 2) ones apart."""

    def __init__(self):
        self.t = 0.0
        self.n = self.n_full = 0
        self.s = self.s_full = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.t = time.perf_counter()
            return
        d = time.perf_counter() - self.t
        self.n += 1
        self.s += d
        if info.get("generation") == 2:
            self.n_full += 1
            self.s_full += d

    def notes(self) -> dict:
        return {"gc_runs": self.n, "gc_s": self.s,
                "gc_full_runs": self.n_full, "gc_full_s": self.s_full}


def power_limit_w():
    """The first card's power limit by ``nvidia-smi`` (roofline shares
    are stated beside it), or None where it cannot be read."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def quiesce_host_pool(timeout_s: float = 300.0) -> None:
    """Wait until the program's host pool has run every task handed to
    it (a request failed at the window's close may have left packing
    work there): one task per worker that waits at a barrier can only
    all start once every earlier task has ended."""
    from trivy_tpu_torch.runtime.hostpool import get_host_pool, pool_size
    pool = get_host_pool()
    if pool is None:
        return
    n = pool_size()
    barrier = threading.Barrier(n + 1)
    futures = [pool.submit(barrier.wait, timeout_s) for _ in range(n)]
    barrier.wait(timeout_s)
    for f in futures:
        f.result()


def _pool_dir(cache: str, cell: str, seed: int) -> str:
    """This seed's pool directory; the cell's pools of other seeds are
    deleted."""
    base = os.path.join(cache, "pools", cell)
    if os.path.isdir(base):
        for d in os.listdir(base):
            if d != str(seed):
                shutil.rmtree(os.path.join(base, d), ignore_errors=True)
    return os.path.join(base, str(seed))


def run_cell(cell, seed: int, seconds: float, trace: bool,
             backend: str = "cuda", cache: str = CACHE) -> dict:
    """Set up, drive and check one cell; the result's fields, with
    ``checks`` ({name: (value, limit, "max" or "min")}), ``diffs``
    and, traced, ``breakdown``."""
    from . import compare, metrics, system
    from .spans import TraceData, recording_tracer
    from .traffic import advisories
    threads_before = {t.ident for t in threading.enumerate()}
    cfg, wl = cell.config, cell.workload
    shape = importlib.import_module(f".traffic.{wl['shape']}",
                                    __package__)
    run_dir = os.path.join(cache, "runs", cell.name)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)

    # the seed's traffic pool first, alone: its time is the harness's,
    # not the program's, and is left out of setup_s; then the database
    # (built on the first run only) and its load, with nothing of the
    # harness running beside it
    t0 = time.monotonic()
    plans = advisories.plan(cfg["db"]["rows"], cfg["db"]["seed"])
    manifest = shape.build(wl["traffic"], advisories.n_pkgs_of(plans),
                           seed, _pool_dir(cache, cell.name, seed))
    gc.collect()
    pool_s = time.monotonic() - t0
    npz = system.db_prefix(cache, cfg["db"])
    if not os.path.exists(npz + ".npz"):
        build_s = system.build_db_apart(npz, cfg["db"], ROOT)
        print(f"built the advisory database in {build_s:.1f} s",
              file=sys.stderr)
    t0 = time.monotonic()
    store = system.load_db(system.cli_args(cfg["entry"], cfg,
                                           run_dir, backend, npz))
    db_load_s = time.monotonic() - t0
    notes = {"pool_s": pool_s, "db_load_s": db_load_s}

    tracer = recording_tracer(run_dir) if trace else None
    if tracer is None:
        from trivy_tpu_torch.obs.trace import get_tracer
        get_tracer().recorder.dump_dir = run_dir
    sut = System(cfg["entry"], cfg, run_dir, backend, npz, store, tracer)
    t0 = time.monotonic()
    load = shape.Load(sut, manifest, wl["traffic"])
    load.warm_up()
    notes["warm_up_s"] = time.monotonic() - t0
    sieve = {}
    if trace and sut.scanner is not None:
        from .roofline import sieve_shape
        sieve = sieve_shape(sut.scanner)
    gc.collect()
    setup_s = time.monotonic() - T_START - pool_s
    notes["setup_s"] = setup_s
    pauses = GcPauses()

    dev = None
    if trace:
        from .profile import DeviceTrace
        dev = DeviceTrace(run_dir)
        tracer.recording.set()
        dev.start()
    gc.callbacks.append(pauses)
    out = load.run(seconds)
    gc.callbacks.remove(pauses)
    notes.update(pauses.notes(), in_window=out["in_window"],
                 window_s=out["window_s"])
    late = join_threads(threads_before)
    if late:
        print(f"warning: threads still running after the window: "
              f"{', '.join(late)}", file=sys.stderr)
    quiesce_host_pool()
    if trace:
        dev_out = dev.stop()
        tracer.recording.clear()
    memory_peak = 0
    device = {"platform": "cpu", "kind": "cpu", "count": 0}
    if backend == "cuda":
        import torch
        memory_peak = int(torch.cuda.max_memory_allocated())
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell.chips}
    device["memory_peak_bytes"] = memory_peak

    done = out["done"]
    result = {"attempted": len(done) + len(out["failed"]),
              "failed": len(out["failed"])}
    if trace:
        td = TraceData(spans=list(tracer.records), sched=out["sched"],
                       kernels=dev_out["kernels"],
                       kernels_mono=dev_out["kernels_mono"],
                       busy_s=dev_out["busy_s"],
                       window_s=dev_out["window_s"], t_start=dev.t_start,
                       completed=len(done),
                       db_load_s=db_load_s, sieve=sieve)
        values = {}
        for m in cell.per_layer:
            v = metrics.load(m["name"]).read(td)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = values
        from .profile import breakdown
        result["breakdown"] = breakdown(dev_out, td.spans)
        for sp in td.spans:
            key = f"span_s.{sp.name}"
            notes[key] = notes.get(key, 0.0) + sp.seconds
        device["busy_s"] = dev_out["busy_s"]
        device["window_s"] = dev_out["window_s"]
        limit = power_limit_w() if backend == "cuda" else None
        if limit is not None:
            device["power_limit_w"] = limit
    else:
        rate = wl["rate_metric"]
        values = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] == rate:
                values[rate] = {"value": len(done) / out["window_s"],
                                "unit": m["unit"]}
        result["metrics"] = values
    result["device"] = device

    # free the program's state, then hold a sample against the
    # reference
    del load, sut, store, tracer
    gc.collect()
    if backend == "cuda":
        import torch
        torch.cuda.empty_cache()
    sample = compare.draw_sample(done, wl["sample"], seed, shape.KIND_KEY)
    traffic = wl["traffic"]

    def expect(e):
        return shape.expect(e, traffic, plans)

    t0 = time.monotonic()
    checks, diffs = compare.judge(sample, expect)
    notes.update(check_s=time.monotonic() - t0, close_s=out["close_s"],
                 passes=out["passes"], completed=len(done))
    checks["failed"] = (float(result["failed"]), 0.0, "max")
    result["correct"] = compare.holds(checks)
    result["checks"] = checks
    result["diffs"] = diffs + [f"failed {e['path']}: {err}"
                               for e, err in out["failed"][:4]]
    result["notes"] = notes
    shutil.rmtree(run_dir, ignore_errors=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import spec
    try:
        cell = spec.cell(ROOT, args.workload)
    except (KeyError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _env(CACHE)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    try:
        import trivy_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"error: modules loaded in the measuring process: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 4
    print("notes: " + " ".join(f"{k}={v:.6g}" for k, v in
                               result.pop("notes").items()),
          file=sys.stderr)
    for d in result.pop("diffs"):
        print(f"diff: {d}", file=sys.stderr)
    checks = result.pop("checks")
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": result["device"]}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim, "bound": side}
                      for k, (v, lim, side) in checks.items()}
    for k, (v, lim, side) in checks.items():
        rel = "<=" if side == "max" else ">="
        print(f"check {k} {v:g} {rel} {lim:g}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
