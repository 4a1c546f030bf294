"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``run.run_cell``: set-up, warm-up,
the window, the comparison) on the CPU at a size a test run holds,
skipping only the harness's look for a card, once clean and once with
each fault a cell can have planted in the program: half of every
device batch's interval jobs left out, one answer of the match altered
where the kernel produces it, and a scan step that returns its first
state unchanged (every report the first one's). The cells run on one
card, so there is no exchange between cards to leave out. The control
(``control.py``) must also come out not correct on every seed."""

import pytest
import torch

from benchmark import control, run
from benchmark.tests.cells import small_cell

CELLS = ("sweep.mixed-tags.cold", "sbom.cyclonedx.mixed")
SECONDS = {"sweep.mixed-tags.cold": 15.0, "sbom.cyclonedx.mixed": 3.0}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench-cache"))


def _run(name: str, cache: str, seed: int = 2 ** 31 + 5) -> dict:
    return run.run_cell(small_cell(name), seed, SECONDS[name], False,
                        backend="cpu", cache=cache)


def half_batch(monkeypatch):
    from trivy_tpu_torch.detect import batch
    orig = batch.dispatch_jobs_async

    def dropped(jobs, *a, **kw):
        return orig(jobs[::2], *a, **kw)

    monkeypatch.setattr(batch, "dispatch_jobs_async", dropped)


def altered_answer(monkeypatch):
    from trivy_tpu_torch.parallel import interval_shard
    orig = interval_shard.interval_hits_resident

    def flipped(*a, **kw):
        hits = orig(*a, **kw).clone()
        hits[0] = ~hits[0] if hits.dtype == torch.bool else 1 - hits[0]
        return hits

    monkeypatch.setattr(interval_shard, "interval_hits_resident", flipped)


@pytest.mark.parametrize("name", CELLS)
def test_clean_run_is_correct(name, cache):
    r = _run(name, cache)
    assert r["correct"], r["diffs"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["targets_checked"][0] >= 1


def unchanged_state(monkeypatch):
    from trivy_tpu_torch.scan import local
    orig = local.LocalScanner.finish
    first = []

    def frozen(self, prepared, detected):
        out = orig(self, prepared, detected)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(local.LocalScanner, "finish", frozen)


@pytest.mark.parametrize("fault", [half_batch, altered_answer,
                                   unchanged_state],
                         ids=["half_batch", "altered_answer",
                              "unchanged_state"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, cache, monkeypatch):
    fault(monkeypatch)
    r = _run(name, cache)
    assert r["attempted"] >= 1
    assert not r["correct"]
    assert r["checks"]["vulns_mismatched"][0] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_three_seeds(name, tmp_path):
    for seed in (3, 2 ** 31 + 7, 2 ** 33 + 1):
        got = control.control_readings(small_cell(name), seed,
                                       str(tmp_path))
        assert got["vulns_mismatched"] > 0, seed
