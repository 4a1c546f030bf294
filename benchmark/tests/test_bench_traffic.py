"""The generators repeat byte for byte under a seed, differ under
another, and keep every seed's sizes."""

import hashlib
import json
import os

import numpy as np

from benchmark.tests.cells import small_cell
from benchmark.traffic import advisories, bom_batch, corpus, image_sweep

PLANS = advisories.plan(20000, 7)
N_PKGS = advisories.n_pkgs_of(PLANS)


def _digest(d: str) -> dict:
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            data = fh.read()
        if f == "pool.json":
            # the manifest names the directory it was written to
            data = data.replace(d.encode(), b"")
        out[f] = hashlib.sha256(data).hexdigest()
    return out


def test_corpus_repeats_and_plants():
    a = corpus.make_corpus(200, [5, 1])
    b = corpus.make_corpus(200, [5, 1])
    c = corpus.make_corpus(200, [6, 1])
    assert a == b and a != c
    files, planted = a
    assert all(2000 <= len(x) <= 16000 for _, x in files)
    for rel, rule in planted.items():
        content = dict(files)[rel]
        sec = next(s for s, r in corpus.SECRETS if r == rule)
        assert sec in content


def test_advisory_rows_repeat_and_match_the_store_fill():
    again = advisories.plan(20000, 7)
    for bp, bq in zip(PLANS, again):
        assert bp.bucket == bq.bucket and bp.quota == bq.quota
        assert np.array_equal(bp.nums, bq.nums)
    assert sum(bp.quota for bp in PLANS) == 20000

    class Sink:
        def __init__(self):
            self.rows = {}

        def put_data_source(self, *a):
            pass

        def put_advisory(self, bucket, name, cve, value):
            self.rows.setdefault((bucket, name), []).append((cve, value))

        def put_vulnerability(self, *a):
            pass

    sink = Sink()
    advisories.fill_store(sink, PLANS)
    for bp in PLANS:
        for p in (0, 1, bp.n_pkgs - 1):
            name = f"{bp.kind}-{bp.grammar}-{p}"
            assert advisories.rows_of(PLANS, bp.bucket, p) == \
                sink.rows[(bp.bucket, name)]
        assert (bp.bucket, f"{bp.kind}-{bp.grammar}-{bp.n_pkgs}") \
            not in sink.rows


def test_sweep_pool_repeats_byte_for_byte(tmp_path):
    params = small_cell("sweep.mixed-tags.cold").workload["traffic"]
    a = image_sweep.build(params, N_PKGS, 2 ** 31 + 11, str(tmp_path / "a"))
    b = image_sweep.build(params, N_PKGS, 2 ** 31 + 11, str(tmp_path / "b"))
    c = image_sweep.build(params, N_PKGS, 2 ** 31 + 12, str(tmp_path / "c"))
    assert _digest(str(tmp_path / "a")) == _digest(str(tmp_path / "b"))
    assert _digest(str(tmp_path / "a")) != _digest(str(tmp_path / "c"))
    # every seed: the same kinds, counts and sizes, in another order
    kinds = sorted((e["kind"], e["index"]) for e in a["tags"])
    assert kinds == sorted((e["kind"], e["index"]) for e in c["tags"])
    assert [e["index"] for e in a["tags"]] != \
        [e["index"] for e in c["tags"]] or len(a["tags"]) < 3
    for e in a["tags"]:
        tree = params["images"][e["kind"]]["tree"]
        assert len(e["truth"]["os"]) == tree["os_packages"]
        assert [len(x[4]) for x in e["truth"]["apps"]] == \
            [x["packages"] for x in tree["apps"]]
    # a complete pool is reused, not rewritten
    again = image_sweep.build(params, N_PKGS, 2 ** 31 + 11,
                              str(tmp_path / "a"))
    assert again == json.loads(json.dumps(a))


def test_bom_pool_repeats_byte_for_byte(tmp_path):
    params = small_cell("sbom.cyclonedx.mixed").workload["traffic"]
    a = bom_batch.build(params, N_PKGS, 77, str(tmp_path / "a"))
    bom_batch.build(params, N_PKGS, 77, str(tmp_path / "b"))
    bom_batch.build(params, N_PKGS, 78, str(tmp_path / "c"))
    assert _digest(str(tmp_path / "a")) == _digest(str(tmp_path / "b"))
    assert _digest(str(tmp_path / "a")) != _digest(str(tmp_path / "c"))
    assert len(a["boms"]) == sum(s["count"] for s in params["boms"])
    for e in a["boms"]:
        with open(e["path"]) as f:
            doc = json.load(f)
        shape = params["boms"][e["shape"]]
        n_libs = sum(x["packages"] for x in shape["apps"])
        assert len(doc["components"]) == \
            shape["os_packages"] + 1 + n_libs + len(shape["apps"])


class _FakeRunner:
    """A runner that returns a report per document at once, and counts
    what it was handed."""

    def __init__(self, k):
        self.k, self.seen, self.closed = k, [], False
        self.scheduler = self

    def stats(self):
        return {"batch": {"count": len(self.seen), "items_total":
                          len(self.seen)}}

    def scan_boms(self, docs, options):
        from types import SimpleNamespace
        assert not self.closed
        self.seen.extend(path for path, _ in docs)
        return [SimpleNamespace(error="", status="ok", report=path)
                for path, _ in docs]

    def close(self):
        self.closed = True


class _FakeSystem:
    def __init__(self):
        self.runners = []

    def make_runner(self, k):
        self.runners.append(_FakeRunner(k))
        return self.runners[-1], None

    @staticmethod
    def render(report):
        return report


def test_bom_clients_never_run_dry(tmp_path):
    """Clients that reach the pool's end go on with a new pass on a new
    runner: no runner sees a document twice, and every runner is closed
    at the end."""
    params = small_cell("sbom.cyclonedx.mixed").workload["traffic"]
    manifest = bom_batch.build(params, N_PKGS, 77, str(tmp_path / "a"))
    sys_ = _FakeSystem()
    load = bom_batch.Load(sys_, manifest, params)
    load.warm_up()
    out = load.run(0.3)
    n = len(manifest["boms"])
    assert load.passes >= 2 and len(sys_.runners) == load.passes
    assert len(out["sched"]) == load.passes
    for r in sys_.runners:
        assert r.closed
        assert len(r.seen) == len(set(r.seen)) <= n
    assert len(out["done"]) > n and not out["failed"]


class _SlowRequest:
    def __init__(self, path, ready_at):
        self.path, self.ready_at = path, ready_at

    @property
    def done(self):
        import time
        return time.monotonic() >= self.ready_at

    def result(self):
        from types import SimpleNamespace
        return SimpleNamespace(error="", status="ok", report=self.path)


class _SlowSweepRunner:
    """A runner whose every tag is answered ``delay_s`` after it was
    submitted; it records the submission times."""

    def __init__(self, delay_s):
        from types import SimpleNamespace
        self.delay_s, self.submitted, self.closed = delay_s, [], False
        self.scheduler = SimpleNamespace(stats=lambda: {})

    def submit_path(self, path, options):
        import time
        assert not self.closed
        now = time.monotonic()
        self.submitted.append(now)
        return _SlowRequest(path, now + self.delay_s)

    def close(self):
        self.closed = True


def test_sweep_window_waits_for_what_it_submitted(tmp_path):
    """When the time is up nothing more is submitted, every tag already
    submitted is waited for and counted, and the window's length runs
    to the end of that wait."""
    import time
    params = dict(small_cell("sweep.mixed-tags.cold").workload["traffic"],
                  in_flight=3, ramp=1)
    manifest = image_sweep.build(params, N_PKGS, 91, str(tmp_path / "a"))
    runners = []

    class System:
        def make_runner(self, k):
            runners.append(_SlowSweepRunner(0.2))
            return runners[-1], None

        @staticmethod
        def render(report):
            return report

    load = image_sweep.Load(System(), manifest, params)
    load.warm_up()
    t0 = time.monotonic()
    out = load.run(0.3)
    end = max(r for x in runners for r in x.submitted)
    assert end <= t0 + 0.3 + 0.05          # nothing submitted after
    assert out["window_s"] >= end - t0 + 0.2 - 0.01
    assert not load.pending and not out["failed"]
    n_after = sum(s > t0 for x in runners for s in x.submitted)
    # the window's reports: those pending at its start and every tag
    # submitted in it
    assert len(out["done"]) == n_after + params["in_flight"]
    assert out["in_window"] < len(out["done"])
    assert all(r.closed for r in runners)
