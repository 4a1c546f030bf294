"""Cells of ``BENCHMARK.json`` cut to a size a CPU test run holds: the
same shapes, configurations and traffic, fewer rows, tags, files and
packages. Used by the tests only; a benchmark run never cuts a cell."""

from __future__ import annotations

import copy
import os

from benchmark import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL_DB = {"rows": 20000, "seed": 7}


def small_cell(name: str):
    c = spec.cell(ROOT, name)
    c.config = dict(copy.deepcopy(c.config), db=dict(SMALL_DB))
    c.workload = copy.deepcopy(c.workload)
    t = c.workload["traffic"]
    t["ramp"] = 2
    if "in_flight" in t:
        t["in_flight"] = 3
    for k in t.get("images", []):
        k.update(tags=3, corpus_files=48, group=2)
        k["tree"]["os_packages"] //= 10
        for a in k["tree"]["apps"]:
            a["packages"] //= 20
    if "boms" in t:
        t.update(clients=2, per_call=2)
        for b in t["boms"]:
            b["count"] = 8
            b["os_packages"] //= 10
            for a in b["apps"]:
                a["packages"] //= 20
    return c
