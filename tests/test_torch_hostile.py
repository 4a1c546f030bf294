"""The hostile ingest corpus: ``trivy_tpu_torch.faults.hostile`` against
the JAX package's (JAX on the CPU) in the same process.

For the same seed and scale each builder writes the same bytes in both
packages (hashed per builder and seed), ``hostile_limits`` scales the
same limits and ``corrupt_boltdb_layout`` lays out the same files.
Through both packages' batch runners (direct and scheduled, guards
on, ``tests/test_sched.py``'s clean targets beside the corpus) every
artifact ends in its ``EXPECTED_STATUS`` with an ``ingest`` cause of
the reference's kind, and the clean slots keep the guardless report.
The gzip ratio tripwire's byte count differs by design (ROADMAP
Queue C), so trip messages are not compared."""

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import random

import pytest

import trivy_tpu.faults.hostile as rhostile
import trivy_tpu_torch.faults.hostile as thostile
from tests.test_sched import make_fleet
from tests.torch_threads import one_torch_thread  # noqa: F401

SCALE = 0.05
BUILDERS = sorted(thostile.BUILDERS)
HOSTILE = {"ref": rhostile, "port": thostile}


def _digests(root: str, corpus: list) -> list:
    return [(name, os.path.relpath(path, root),
             hashlib.sha256(open(path, "rb").read()).hexdigest())
            for name, path in corpus]


def test_builders_and_expected_statuses_equal_the_reference():
    assert list(thostile.BUILDERS) == list(rhostile.BUILDERS)
    assert thostile.EXPECTED_STATUS == rhostile.EXPECTED_STATUS
    assert thostile.DEFAULT_SEED == rhostile.DEFAULT_SEED


@pytest.mark.parametrize("scale", [1.0, 0.05, 0.02])
def test_hostile_limits_equal_the_reference(scale):
    assert dataclasses.asdict(thostile.hostile_limits(scale)) == \
        dataclasses.asdict(rhostile.hostile_limits(scale))


@pytest.mark.parametrize("seed", [20260804, 11, 7])
@pytest.mark.parametrize("builder", BUILDERS)
def test_corpus_is_byte_identical_per_seed(builder, seed, tmp_path):
    """One builder at one seed (scale 0.05): the port's artifact hashes
    as the reference's, and building it again gives the same bytes."""
    got = {}
    for pkg in ("ref", "port", "again"):
        root = str(tmp_path / pkg)
        mod = rhostile if pkg == "ref" else thostile
        got[pkg] = _digests(root, mod.build_corpus(
            root, seed=seed, only=[builder], scale=SCALE))
    assert got["port"] == got["ref"] == got["again"]


def test_whole_corpus_at_full_scale_equals_the_reference(tmp_path):
    """The CLI's corpus (``hostile-ingest``: every builder, scale 1.0,
    the default seed) hashes as the reference's."""
    got = {}
    for pkg, mod in HOSTILE.items():
        root = str(tmp_path / pkg)
        got[pkg] = _digests(root, mod.build_corpus(root, only=["all"]))
    assert got["port"] == got["ref"] and len(got["port"]) == len(BUILDERS)


@pytest.mark.parametrize("only", [["no-such-attack"],
                                  ["gzip-bomb", "nope", "bad"]])
def test_unknown_builder_rejected_as_the_reference(only, tmp_path):
    msgs = []
    for pkg, mod in HOSTILE.items():
        with pytest.raises(ValueError) as e:
            mod.build_corpus(str(tmp_path / pkg), only=only)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "unknown hostile" in msgs[1]


@pytest.mark.parametrize("seed", [20260804, 3])
def test_corrupt_boltdb_layout_equals_the_reference(seed, tmp_path):
    """The advisory-DB flavour: the same OCI layout files, byte for
    byte."""
    got = {}
    for pkg, mod in HOSTILE.items():
        root = str(tmp_path / pkg)
        mod.corrupt_boltdb_layout(root, seed=seed)
        got[pkg] = sorted(
            (os.path.relpath(os.path.join(d, n), root),
             hashlib.sha256(open(os.path.join(d, n), "rb").read())
             .hexdigest())
            for d, _, names in os.walk(root) for n in names)
    assert got["port"] == got["ref"] and got["port"]


# --- the corpus through both runners --------------------------------------

def _store(pkg):
    import importlib
    db = importlib.import_module(("trivy_tpu" if pkg == "ref"
                                  else "trivy_tpu_torch") + ".db")
    store = db.AdvisoryStore()
    store.put_advisory("alpine 3.16", "pkg1", "CVE-2099-0001",
                       {"FixedVersion": "2.0.0-r0"})
    store.put_vulnerability("CVE-2099-0001", {"Severity": "HIGH"})
    return store


def _scan(pkg, paths, limits, sched="off", guards=True):
    import importlib
    root = "trivy_tpu" if pkg == "ref" else "trivy_tpu_torch"
    art = importlib.import_module(root + ".artifact.artifact")
    runtime = importlib.import_module(root + ".runtime")
    types = importlib.import_module(root + ".types")
    backend = "cpu-ref" if pkg == "ref" else "cpu"
    runner = runtime.BatchScanRunner(
        store=_store(pkg), backend=backend, sched=sched,
        artifact_option=art.ArtifactOption(ingest_guards=guards,
                                           ingest_limits=limits))
    try:
        return runner.scan_paths(list(paths),
                                 types.ScanOptions(backend=backend))
    finally:
        runner.close()


def _norm(results) -> list:
    return [(r.name, "error", r.error) if r.error else
            (r.name, json.dumps(r.report.to_dict(), sort_keys=True))
            for r in results]


def _summary(results) -> list:
    """(status, cause stages and kinds) per slot."""
    return [(r.status, sorted({(c.stage, c.kind) for c in r.causes
                               if c.stage != "obs"}))
            for r in results]


@pytest.fixture(scope="module")
def corpus_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hostile")
    corpus = thostile.build_corpus(str(tmp / "corpus"), scale=SCALE)
    limits = {pkg: dataclasses.replace(mod.hostile_limits(SCALE),
                                       ingest_deadline_s=30.0)
              for pkg, mod in HOSTILE.items()}
    clean = make_fleet(tmp, 2)
    paths = clean + [p for _, p in corpus]
    runs = {(pkg, sched): _scan(pkg, paths, limits[pkg], sched=sched)
            for pkg in HOSTILE for sched in ("off", "on")}
    unguarded = {pkg: _norm(_scan(pkg, clean, limits[pkg], guards=False))
                 for pkg in HOSTILE}
    return {"corpus": corpus, "runs": runs, "unguarded": unguarded}


@pytest.mark.parametrize("sched", ["off", "on"])
@pytest.mark.parametrize("builder", BUILDERS)
def test_every_artifact_ends_in_its_expected_status(corpus_runs, builder,
                                                    sched):
    """Each hostile slot ends in ``EXPECTED_STATUS`` with an ``ingest``
    cause of a guard kind, in both packages, with the reference's
    stages and kinds."""
    k = 2 + [n for n, _ in corpus_runs["corpus"]].index(builder)
    got = {pkg: corpus_runs["runs"][(pkg, sched)][k] for pkg in HOSTILE}
    for r in got.values():
        assert r.status == thostile.EXPECTED_STATUS[builder], \
            f"{builder}: {r.status} ({r.error})"
        assert "ingest" in {c.stage for c in r.causes}
        assert {c.kind for c in r.causes} & {"resource-budget",
                                            "malformed-archive"}
    assert _summary([got["port"]]) == _summary([got["ref"]])


@pytest.mark.parametrize("sched", ["off", "on"])
def test_clean_slots_keep_the_guardless_report(corpus_runs, sched):
    """The clean targets beside the corpus are ``ok`` and equal the
    guardless run, in both packages, and the port's equal the
    reference's."""
    for pkg in HOSTILE:
        clean = corpus_runs["runs"][(pkg, sched)][:2]
        assert all(r.status == "ok" and not r.error for r in clean)
        assert _norm(clean) == corpus_runs["unguarded"][pkg]
    assert corpus_runs["unguarded"]["port"] == \
        corpus_runs["unguarded"]["ref"]


def test_degraded_slot_report_carries_status(tmp_path):
    """The survivable artifact (``corrupt-rpmdb``) completes degraded,
    its report carrying the status and an ``ingest`` cause, as the
    reference's (the same report, but the trace id of its ``obs``
    cause)."""
    corpus = thostile.build_corpus(str(tmp_path), only=["corrupt-rpmdb"],
                                   scale=SCALE)
    docs = {}
    for pkg, mod in HOSTILE.items():
        (res,) = _scan(pkg, [corpus[0][1]], mod.hostile_limits(SCALE))
        assert res.status == "degraded" and res.report is not None
        doc = res.report.to_dict()
        assert doc["Status"] == "degraded"
        assert doc["FailureCauses"][0]["Stage"] == "ingest"
        # the obs cause names a random trace id
        doc["FailureCauses"] = [c for c in doc["FailureCauses"]
                                if c["Stage"] != "obs"]
        docs[pkg] = doc
    assert docs["port"] == docs["ref"]


def test_random_mutants_end_typed_as_the_reference(tmp_path):
    """Seeded mutations of a clean target (truncations, flipped runs,
    spliced garbage) never raise past the artifact boundary: each slot
    ends ok, degraded or failed with a cause, and the port's statuses
    and causes equal the reference's."""
    base = open(make_fleet(tmp_path, 1)[0], "rb").read()
    rng = random.Random(20260804)
    paths = []
    for i in range(24):
        data = bytearray(base)
        op = rng.randrange(3)
        if op == 0:
            data = data[:rng.randrange(1, len(data))]
        elif op == 1:
            off = rng.randrange(len(data))
            n = min(len(data) - off, rng.randrange(1, 512))
            for j in range(off, off + n):
                data[j] ^= 0xFF
        else:
            off = rng.randrange(len(data))
            data[off:off] = rng.randbytes(rng.randrange(1, 2048))
        p = tmp_path / f"mutant{i}.tar"
        p.write_bytes(bytes(data))
        paths.append(str(p))
    got = {pkg: _scan(pkg, paths, mod.hostile_limits(SCALE))
           for pkg, mod in HOSTILE.items()}
    for results in got.values():
        assert len(results) == len(paths)
        for r in results:
            assert r.status in ("ok", "degraded", "failed")
            if r.status == "failed":
                assert r.causes, f"untyped failure: {r.error}"
    assert _summary(got["port"]) == _summary(got["ref"])


def test_hostile_ingest_cli_drill_equals_the_reference(tmp_path,
                                                       monkeypatch):
    """``image a.tar b.tar --fault-spec hostile-ingest --format json``:
    the full-scale corpus appended to the fleet, each hostile slot
    failing or degrading per target, the clean ones untouched — the
    same exit code, documents and error lines (by target and guard
    kind) as the reference's."""
    from trivy_tpu.cli import main as rmain
    from trivy_tpu_torch.cli import main as tmain
    monkeypatch.chdir(tmp_path)
    paths = make_fleet(tmp_path, 2)
    got = {}
    for pkg, main in (("ref", rmain), ("port", tmain)):
        out, err = io.StringIO(), io.StringIO()
        argv = ["image", *paths, "--backend", "cpu", "--format", "json",
                "--security-checks", "vuln", "--fault-spec",
                "hostile-ingest"]
        if pkg == "ref":
            argv += ["--no-cache", "--no-memo"]
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            code = main(argv)
        lines = err.getvalue().splitlines()
        failed = sorted(os.path.basename(ln.split(": ")[1])
                        for ln in lines if ln.startswith("error: "))
        docs = [(os.path.basename(d["ArtifactName"]), d.get("Status"),
                 [c["Kind"] for c in d.get("FailureCauses", [])
                  if c["Stage"] != "obs"])
                for d in json.loads(out.getvalue())]
        added = [ln for ln in lines if ln.startswith("fault-spec: ")]
        got[pkg] = (code, failed, docs, added)
    assert got["port"] == got["ref"]
    code, failed, docs, added = got["port"]
    assert code == 1 and added == [
        "fault-spec: added 10 hostile artifacts to the fleet "
        "(seed=20260804)"]
    assert failed == sorted(f"hostile-{n}.tar" for n, s in
                            thostile.EXPECTED_STATUS.items()
                            if s == "failed")
    assert docs[-1] == ("hostile-corrupt-rpmdb.tar", "degraded",
                        ["malformed-archive"])
