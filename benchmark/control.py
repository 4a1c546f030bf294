"""The control of the comparison that decides ``correct``.

    python -m benchmark.control --workload NAME --seeds S1 S2 S3 ...

The configurations state no precision, so the control breaks one
guarantee they do state: that unfixed advisories are reported where
the distro reports them. It is the plain reference put in the
program's place with that guarantee dropped (trivy's
``--ignore-unfixed``), held against the plain reference on the sample
a run would check (the first ``sample`` targets of the pool, the
largest of each kind among them), at the cell's own size. Every seed
must come out not correct; the numbers it reads are the upper readings
the limits sit below. It runs on the host alone and imports nothing of
the program.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from . import compare, spec
from .traffic import advisories

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def drop_unfixed(want: dict) -> dict:
    """The reference's sets with every unfixed finding left out."""
    out = dict(want)
    out["vulns"] = {v for v in want["vulns"] if v[4] != ""}
    return out


def control_readings(cell, seed: int, cache: str) -> dict:
    """{number name: the control's reading} on ``seed``'s sample."""
    wl = cell.workload
    shape = importlib.import_module(f".traffic.{wl['shape']}",
                                    __package__)
    plans = advisories.plan(cell.config["db"]["rows"],
                            cell.config["db"]["seed"])
    manifest = shape.build(wl["traffic"], advisories.n_pkgs_of(plans),
                           seed, os.path.join(cache, cell.name, str(seed)))
    entries = manifest["tags" if "tags" in manifest else "boms"]
    done = [(e, None, 0.0) for e in entries]
    sample = compare.draw_sample(done, wl["sample"], seed, shape.KIND_KEY)
    totals: dict = {}
    for entry, _, _ in sample:
        want = shape.expect(entry, wl["traffic"], plans)
        for k, n in compare.mismatches(drop_unfixed(want), want).items():
            totals[f"{k}_mismatched"] = totals.get(f"{k}_mismatched",
                                                   0) + n
    return totals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cache", default=os.path.join(
        ROOT, "benchmark", ".cache", "control"))
    args = ap.parse_args(argv)
    cell = spec.cell(ROOT, args.workload)
    out = {}
    for seed in args.seeds:
        out[seed] = control_readings(cell, seed, args.cache)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": out[seed]}), flush=True)
    failed_all = all(any(v > 0 for v in r.values()) for r in out.values())
    print(json.dumps({"workload": args.workload,
                      "control_not_correct_on_every_seed": failed_all}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
