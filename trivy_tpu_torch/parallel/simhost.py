"""Multi-process simulation worker for the multi-host contract
(reference: ``trivy_tpu/parallel/simhost.py``).

``python -m trivy_tpu_torch.parallel.simhost <spec.json> <out.json>``
runs as ONE simulated host: it reads the shared fleet spec, derives
the global LPT shard layout exactly like a real pod process would
(:func:`trivy_tpu_torch.parallel.multihost.host_shard_layout` — a pure
function of the fleet, so no coordination traffic), scans only the
slice it owns on a process-local mesh, and writes its layout +
normalized reports. The parent spawns P of these with
``TRIVY_TPU_PROCESS_ID=0..P-1`` (and ``TRIVY_TPU_NUM_PROCESSES=P``,
``TRIVY_TPU_COORDINATOR``) and checks two invariants the real pod
depends on:

* **layout parity** — every process reports the identical global
  assignment;
* **findings identity** — the union of per-host reports equals a
  single-host scan of the whole fleet.

Spec JSON: ``{"paths": [tar, ...], "devices": N (per host),
"db_fixture": {bucket: {pkg: {cve: advisory}}},
"vulns": {cve: {...}}, "dispatch_depth": D, "backend": "cuda" |
"cpu"}``. ``backend`` (the port's key; default ``cuda``) picks the
mesh: the first min(N, visible) cards, or the CPU named N times.
Resident advisory tables are compiled per process: each host places
its own copy, which is the per-host replication of the real pod.

Fleet observability (docs/observability.md "Fleet plane"): an
optional spec ``"traceparent"`` roots this process's span tree under
the parent's span — the parent's flight recorder then names every
host in ONE cross-process trace. ``"clock_port_file"`` starts a
monotonic ``ClockServer`` and writes its port, so the parent can
estimate this process's clock offset pairwise. The output's
``trace`` carries the ids for child-link checks and ``timeline`` is
this process's span export (``obs/timeline.py::export_tracer``), the
unit ``MergedTimeline`` aligns.
"""

from __future__ import annotations

import json
import os
import sys

def _normalized(results) -> list:
    out = []
    for r in results:
        if r.error:
            out.append([r.name, "error", r.error])
        else:
            out.append([r.name, json.dumps(r.report.to_dict(),
                                           sort_keys=True)])
    return out


def _mesh(backend: str, n: int):
    import torch

    from .mesh import make_mesh
    if backend == "cpu":
        return make_mesh(devices=[torch.device("cpu")] * n)
    if backend != "cuda":
        raise ValueError(f"simhost backend {backend!r}: cuda or cpu")
    visible = torch.cuda.device_count() if torch.cuda.is_available() \
        else 0
    return make_mesh(max(1, min(n, visible)))


def run_simhost(spec: dict, topo=None) -> dict:
    """One simulated host's scan: returns {process_id, num_processes,
    assign, indices, reports, trace, timeline}. Importable (a test
    calls it in-process for the single-host arm)."""
    from ..db import AdvisoryStore, CompiledDB
    from ..obs.propagate import (EMPTY_CONTEXT, ClockServer,
                                 parse_traceparent)
    from ..obs.timeline import export_tracer
    from ..obs.trace import get_tracer
    from ..runtime import BatchScanRunner
    from .multihost import (host_shard_layout, local_indices,
                            topology_from_env)

    topo = topology_from_env() if topo is None else topo
    paths = list(spec["paths"])
    volumes = [os.path.getsize(p) for p in paths]
    assign = host_shard_layout(volumes, topo.num_processes)
    mine = local_indices(volumes, topo)

    store = AdvisoryStore()
    for bucket, pkgs in (spec.get("db_fixture") or {}).items():
        for pkg, advs in pkgs.items():
            for cve, adv in advs.items():
                store.put_advisory(bucket, pkg, cve, adv)
    for cve, vuln in (spec.get("vulns") or {}).items():
        store.put_vulnerability(cve, vuln)
    cdb = CompiledDB.compile(store)

    backend = str(spec.get("backend") or "cuda")
    mesh = _mesh(backend, int(spec.get("devices") or 1))
    runner = BatchScanRunner(
        store=cdb, backend=backend, mesh=mesh,
        dispatch_depth=int(spec.get("dispatch_depth") or 2))

    clock = None
    port_file = str(spec.get("clock_port_file") or "")
    if port_file:
        clock = ClockServer()
        clock.write_port_file(port_file)

    tracer = get_tracer()
    process = f"host{topo.process_id}"
    ctx = parse_traceparent(
        str(spec.get("traceparent") or "")) or EMPTY_CONTEXT
    # the simhost root: a LOCAL root span (it completes this
    # process's bucket) carrying the parent process's span as its
    # remote parent, so the merged trace links across the seam
    root = tracer.start_span(
        "simhost", trace_id=ctx.trace_id,
        remote_parent=ctx.parent_span_id,
        attrs={"process": process})
    try:
        with root.activate():
            results = runner.scan_paths([paths[i] for i in mine])
        root.end()
    except BaseException:
        root.end(status="failed")
        raise
    finally:
        if clock is not None:
            clock.close()
    return {
        "process_id": topo.process_id,
        "num_processes": topo.num_processes,
        "assign": assign,
        "indices": mine,
        "reports": _normalized(results),
        "trace": {"trace_id": root.trace_id,
                  "root_span_id": root.span_id,
                  "remote_parent": ctx.parent_span_id},
        "timeline": export_tracer(tracer, process=process),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m trivy_tpu_torch.parallel.simhost "
              "<spec.json> <out.json>", file=sys.stderr)
        return 2
    with open(argv[0], encoding="utf-8") as f:
        spec = json.load(f)
    out = run_simhost(spec)
    with open(argv[1], "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
