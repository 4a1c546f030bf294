"""BENCHMARK.json and every file it names load and keep the contract's
shapes: names and units of the allowed characters, every file where
the harness looks for it, every reader agreeing with its entry."""

import json
import math
import os
import re

import pytest

from benchmark import metrics, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")
BENCH = spec.benchmark(ROOT)
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    with open(os.path.join(ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.fullmatch(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_paths_hold_the_benchmark():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")


def test_full_check_fits_its_budget_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            texts = {"configs": ("why", "source"), "workloads": ("why",),
                     "per_layer": ("layer",)}.get(group, ())
            for key in texts:
                assert TEXT.fullmatch(e[key]), (e["name"], key)
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["traffic"]) and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_setup_metric_and_one_more_per_cell():
    assert E2E["setup_s"]["bound"] <= 0.25
    for name in CELLS:
        c = spec.cell(ROOT, name)
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert c.per_layer, name
        assert c.workload["rate_metric"] in got


def test_configurations_are_used_and_their_files_load():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["entry"] in ("image", "sbom")
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_size"))


@pytest.mark.parametrize("name", CELLS)
def test_workload_files_load(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    with open(spec.workload_path(name)) as f:
        wl = json.load(f)
    assert wl["name"] == name and wl["config"] == entry["config"]
    assert wl["why"] == entry["why"]
    assert os.path.exists(os.path.join(
        ROOT, "benchmark", "traffic", wl["shape"] + ".py"))
    assert wl["sample"] >= 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_readers_agree_with_their_entries(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    mod = metrics.load(name)
    assert mod.LAYER == entry["layer"]
    assert mod.UNIT == entry["unit"]
    assert mod.MOVES == entry["moves"]
    assert mod.SOURCE == entry["source"]
    assert entry["moves"] in E2E
    for cell in entry.get("workloads", CELLS):
        assert cell in CELLS
        allowed = E2E[entry["moves"]].get("workloads", CELLS)
        assert cell in allowed, (name, cell)
    if "roofline" in name or "mfu" in name:
        assert entry["unit"] == "%"


def test_layers_name_one_layer_one_way():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(len(CELLS) / 4))


def test_a_stated_cut_is_what_the_cells_run():
    """A configuration that cuts the corpus states, per base image, the
    files its cells' tags carry, and the larger source scale."""
    for w in BENCH["workloads"]:
        with open(spec.config_path(w["config"])) as f:
            cfg = json.load(f)
        if "corpus_files" not in cfg:
            continue
        assert "corpus_files" in cfg["reduced"]
        with open(spec.workload_path(w["name"])) as f:
            wl = json.load(f)
        got = {k["tree"]["bucket"]: k["corpus_files"]
               for k in wl["traffic"]["images"]}
        assert got == cfg["corpus_files"]
        scale = cfg["source_scale"]["corpus_files"]
        assert all(scale[b] > n for b, n in got.items())
