"""``BENCHMARK.json`` and the files it names.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic shape (a module of
``traffic/``) and the shape's parameters; a per-layer metric is a
reader module of ``metrics/`` with the metric's name. The harness
finds each by the name ``BENCHMARK.json`` gives it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # configs/<config>.json
    workload: dict         # workloads/<cell>.json
    end_to_end: list       # the cell's end-to-end metric entries
    per_layer: list        # the cell's per-layer metric entries


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def config_path(name: str) -> str:
    return os.path.join(HERE, "configs", f"{name}.json")


def workload_path(name: str) -> str:
    return os.path.join(HERE, "workloads", f"{name}.json")


def _reported_in(metric: dict, cell: str, e2e: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", "") in e2e if "moves" in metric else True


def cell(root: str, name: str) -> Cell:
    """The cell ``name`` of the checkout at ``root``. Raises
    ``KeyError`` for a cell ``BENCHMARK.json`` does not list."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if _reported_in(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reported_in(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_load(config_path(entry["config"])),
                workload=_load(workload_path(name)),
                end_to_end=e2e, per_layer=per_layer)
