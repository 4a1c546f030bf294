"""The fleet runtime's direct path: ``trivy_tpu_torch.runtime.
BatchScanRunner(sched="off")`` and ``python -m trivy_tpu_torch image
a.tar b.tar ... --sched off`` against the JAX package's
``BatchScanRunner(backend="tpu", sched="off")`` and ``python -m
trivy_tpu.cli image a.tar b.tar ... --sched off --no-cache --no-memo``
(JAX on the CPU) on one seeded fleet of eight docker-save targets
(``chip_smoke.fleet_targets`` at a small scale, the shape of
``tests/test_sched.py::make_fleet``): a shared base layer with a
secret the base gate hides, a shared layer with a secret, per-image
lockfiles, two groups that share a part of a corpus with planted
secrets, one image twice under two tags, and one truncated tar. The
reports must be equal after ``sort_keys`` (``table`` byte for byte),
with the same failed slot and cause, exit code and ``error:`` lines,
on ``cpu`` and ``cpu-ref``, at dispatch depth 1, 2 and 4 and with
waves of 64 rows; ``scan_boms`` likewise on BOM documents."""

import contextlib
import io
import json

import pytest
import yaml

import trivy_tpu.analyzer as ranalyzer
import trivy_tpu.db as rdb
import trivy_tpu_torch.analyzer as tanalyzer
import trivy_tpu_torch.db as tdb
import trivy_tpu_torch.detect.batch as tbatch
from chip_smoke import (FS_ROOTS, SBOM_IMAGES, fleet_targets,
                        make_advisory_store, make_bom, make_corpus)
from tests.test_torch_scan_local import _fast_yaml, _fixture_docs
from trivy_tpu.cli import main as rmain
from trivy_tpu.runtime import BatchScanRunner as RRunner
from trivy_tpu_torch.cli import main as tmain
from trivy_tpu_torch.runtime import BatchScanRunner as TRunner

STORE_ROWS = 3000
SEED = 20261016
N_IMAGES = 8
CORPUS = 48


def _norm(results) -> list:
    """tests/test_sched.py's ``_norm``, with each slot's status and
    causes."""
    out = []
    for r in results:
        causes = [c.to_dict() for c in r.causes]
        if r.error:
            out.append((r.name, "error", r.error, r.status, causes))
        else:
            out.append((r.name, json.dumps(r.report.to_dict(),
                                           sort_keys=True),
                        r.status, causes))
    return out


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    rstore, n_pkgs = make_advisory_store(STORE_ROWS, SEED,
                                         store=rdb.AdvisoryStore())
    tstore, _ = make_advisory_store(STORE_ROWS, SEED)
    corpus, planted = make_corpus(CORPUS, 7)
    plan = fleet_targets(str(d), FS_ROOTS["fs"], n_pkgs, 3, corpus,
                         n_images=N_IMAGES, scale=0.04)
    (d / "fixtures.yaml").write_text(json.dumps(_fixture_docs(rstore)))
    rcdb = rdb.CompiledDB.compile(rstore)
    rcdb.save(str(d / "compiled"))
    boms = [(f"bom-{k}-{i}", json.dumps(make_bom(
        SBOM_IMAGES[k], n_pkgs, SEED + i, scale=0.02)).encode())
        for i, k in enumerate(("A", "B", "A"))]
    boms.insert(1, ("not-a-bom", b'{"hello": "world"}'))
    return {"plan": plan, "planted": planted, "boms": boms,
            "stores": {"fixtures": (rstore, tstore),
                       "compiled": (rcdb,
                                    tdb.CompiledDB.compile(tstore))},
            "fixtures": str(d / "fixtures.yaml"),
            "compiled": str(d / "compiled")}


@pytest.fixture(autouse=True)
def _reset_secret_config():
    """Both CLIs point their registered secret analyzer at the rule
    config they read (process-global, as in the reference)."""
    yield
    for pkg in (ranalyzer, tanalyzer):
        for a in pkg.registered_analyzers():
            if a.type == "secret":
                a.config_path = ""


_REFERENCE: dict = {}


def _reference(fleet, db: str) -> list:
    """The reference's results, once per store kind (its output is the
    same at every depth and wave size: ``tests/test_async_rt.py``)."""
    if db not in _REFERENCE:
        runner = RRunner(store=fleet["stores"][db][0], backend="tpu",
                         sched="off")
        _REFERENCE[db] = _norm(runner.scan_paths(fleet["plan"]["paths"]))
    return _REFERENCE[db]


@pytest.mark.parametrize("wave_rows", [tbatch._WAVE_ROWS, 64])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("backend", ["cpu", "cpu-ref"])
@pytest.mark.parametrize("db", ["compiled", "fixtures"])
def test_scan_paths_equals_reference(fleet, db, backend, depth,
                                     wave_rows, monkeypatch):
    want = _reference(fleet, db)
    monkeypatch.setattr(tbatch, "_WAVE_ROWS", wave_rows)
    runner = TRunner(store=fleet["stores"][db][1], backend=backend,
                     sched="off", dispatch_depth=depth)
    got = _norm(runner.scan_paths(fleet["plan"]["paths"]))
    assert got == want
    stats = runner.last_stats
    assert stats["images"] == N_IMAGES - 1      # the broken tar never loads
    assert stats["dispatch_depth"] == depth
    assert stats["interval_jobs"] > stats["interval_jobs_unique"] > 0
    assert stats["secret"]["files_with_findings"] > 0
    if backend == "cpu-ref":
        assert stats["interval_waves"] == 1
    else:
        # waves of at most wave_rows unique device rows
        assert (stats["interval_waves"] > 1) == (wave_rows == 64)


def test_failed_and_twin_slots(fleet):
    """The truncated tar fails its own slot with the reference's cause;
    the twin's report is its image's but for the name and tag; the
    shared secret is reported in every image, the base's in none; and
    a second run on the runner's warm cache (every layer cached, no
    sieve) gives the same reports."""
    plan = fleet["plan"]
    want = _reference(fleet, "compiled")
    runner = TRunner(store=fleet["stores"]["compiled"][1], backend="cpu",
                     sched="off")
    res = runner.scan_paths(plan["paths"])
    broken = res[plan["broken"]]
    assert broken.status == "failed" and broken.report is None
    assert broken.error and broken.causes[0].stage == "ingest"
    assert want[plan["broken"]][1] == "error"
    assert [c.to_dict() for c in broken.causes] == want[plan["broken"]][4]
    assert sum(r.status == "failed" for r in res) == 1
    twins = []
    for i in plan["twin"]:
        doc = res[i].report.to_dict()
        assert doc["ArtifactName"] == plan["paths"][i]
        tags = doc["Metadata"].pop("RepoTags")
        twins.append((tags, json.dumps(doc, sort_keys=True).replace(
            plan["paths"][i], "NAME")))
    assert twins[0][0] != twins[1][0] and twins[0][1] == twins[1][1]
    for r in res:
        if r.report is None:
            continue
        secrets = {x.target for x in r.report.results
                   if x.class_ == "secret"}
        assert "/srv/shared/deploy.env" in secrets
        assert "/opt/base/release.env" not in secrets
    again = runner.scan_paths(plan["paths"])
    assert runner.last_stats["secret"] == {}
    assert _norm(again) == _norm(res)


@pytest.mark.parametrize("backend", ["cpu", "cpu-ref"])
@pytest.mark.parametrize("db", ["compiled", "fixtures"])
def test_scan_boms_equals_reference(fleet, db, backend):
    rres = RRunner(store=fleet["stores"][db][0], backend="tpu",
                   sched="off").scan_boms(fleet["boms"])
    runner = TRunner(store=fleet["stores"][db][1], backend=backend,
                     sched="off")
    got = runner.scan_boms(fleet["boms"])
    assert _norm(got) == _norm(rres)
    assert [r.status for r in got] == ["ok", "failed", "ok", "ok"]
    assert runner.last_stats["sboms"] == 4
    assert runner.last_stats["interval_jobs"] > 0


def _run(main, argv: list) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    said = [ln for ln in err.getvalue().splitlines()
            if ln.startswith(("error:", "warning:"))]
    return code, out.getvalue(), said, err.getvalue()


def _out(text: str, fmt: str) -> str:
    return json.dumps(json.loads(text), sort_keys=True) \
        if fmt == "json" else text


CLI_CASES = [
    # (format, db, flags)
    ("json", "compiled", []),
    ("table", "compiled", []),
    ("json", "fixtures", ["--severity", "HIGH,CRITICAL",
                          "--exit-code", "3"]),
    ("table", "fixtures", ["--security-checks", "secret"]),
    ("json", "compiled", ["--security-checks", "vuln",
                          "--vuln-type", "library", "--list-all-pkgs"]),
]


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("fmt,db,flags", CLI_CASES)
def test_cli_fleet_equals_reference(fleet, fmt, db, flags, depth,
                                    tmp_path, monkeypatch):
    """Each case runs the reference once (``--backend cpu`` or
    ``cpu-ref``, alternately) and holds both of the port's CPU
    backends to it: the json array after ``sort_keys``, the tables
    byte for byte, the exit code and the ``error:`` lines (the
    truncated tar's)."""
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    monkeypatch.chdir(tmp_path)
    dbflag = "--db-fixtures" if db == "fixtures" else "--compiled-db"
    argv = ["image", *fleet["plan"]["paths"], "--sched", "off",
            "--format", fmt, dbflag, fleet[db],
            "--dispatch-depth", str(depth), *flags]
    rb = ("cpu", "cpu-ref")[(CLI_CASES.index((fmt, db, flags)) + depth)
                            % 2]
    rcode, rout, rsaid, _ = _run(rmain, argv + [
        "--backend", rb, "--no-cache", "--no-memo"])
    assert len(rsaid) == 1 and rsaid[0].startswith(
        f"error: {fleet['plan']['paths'][-1]}: ")
    assert rcode == (3 if "--exit-code" in flags else 1)
    for backend in ("cpu", "cpu-ref"):
        code, out, said, _ = _run(tmain, argv + ["--backend", backend])
        assert (code, said) == (rcode, rsaid)
        assert _out(out, fmt) == _out(rout, fmt)
    if fmt == "json":
        docs = json.loads(rout)
        assert len(docs) == N_IMAGES - 1
        assert all(d["ArtifactType"] == "container_image" for d in docs)


def test_cli_sched_stats_dumps_the_batch(fleet, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    code, out, _, err = _run(tmain, [
        "image", *fleet["plan"]["paths"][:3], "--sched", "off",
        "--sched-stats", "--compiled-db", fleet["compiled"],
        "--format", "json", "--backend", "cpu"])
    assert code == 0 and len(json.loads(out)) == 3
    stats = json.loads(err[err.index("{"):])
    assert {"analyze_s", "secret_batch_s", "squash_join_s",
            "interval_dispatch_s", "interval_device_s", "interval_jobs",
            "interval_jobs_unique", "interval_dedup_ratio",
            "dispatch_depth", "interval_waves", "dispatch_overlap_ratio",
            "secret"} <= set(stats)
    assert stats["images"] == 3 and stats["dispatch_depth"] == 2


# --- refusals --------------------------------------------------------

REFUSALS = {
    "sched_on_by_default": ([], "A.5"),
    "sched_on": (["--sched", "on"], "A.5"),
    "tenant_config": (["--sched", "off", "--tenant-config", "a:rate=1"],
                      "A.5"),
    "tenant_budget": (["--sched", "off", "--tenant-budget",
                       "a:device_s=1"], "A.5"),
    "coordinator": (["--sched", "off", "--coordinator", "h:1"], "A.6"),
    "num_processes": (["--sched", "off", "--num-processes", "2"], "A.6"),
    "process_id": (["--sched", "off", "--process-id", "0"], "A.6"),
    "fault_spec": (["--sched", "off", "--fault-spec", "poison-image"],
                   "A.9"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_fleet_refuses_before_any_host_work(fleet, case, monkeypatch,
                                            tmp_path):
    import trivy_tpu_torch.cli as tcli

    def no_work(*args, **kwargs):
        raise AssertionError("host work before the refusal")

    for name in ("load_image", "load_store", "BatchScanRunner"):
        monkeypatch.setattr(tcli, name, no_work)
    monkeypatch.chdir(tmp_path)
    flags, item = REFUSALS[case]
    code, out, said, _ = _run(tcli.main, [
        "image", *fleet["plan"]["paths"][:2], *flags, "--backend", "cpu"])
    assert code == 1 and out == ""
    assert len(said) == 1 and f"ROADMAP {item}" in said[0]


@pytest.mark.parametrize("flags", [["--input", "x.tar"],
                                   ["--format", "cyclonedx"]])
def test_fleet_usage_errors_as_reference(fleet, flags, monkeypatch,
                                         tmp_path):
    """``--input`` beside several targets and a per-document format
    end with exit 2 and the reference's message."""
    monkeypatch.chdir(tmp_path)
    argv = ["image", *fleet["plan"]["paths"][:2], "--sched", "off",
            "--backend", "cpu", *flags]
    want = _run(rmain, argv + ["--no-cache", "--no-memo"])
    got = _run(tmain, argv)
    assert got[:3] == want[:3]
    assert got[0] == 2 and len(got[2]) == 1


def test_runner_takes_the_direct_path_only(fleet):
    with pytest.raises(NotImplementedError, match="A.5"):
        TRunner(backend="cpu", sched="on")
    for arg in ("mesh", "memo", "tracer", "fault_injector",
                "sched_config"):
        with pytest.raises(TypeError):
            TRunner(backend="cpu", **{arg: None})
    assert not hasattr(TRunner, "scan_registry_refs")
    assert not hasattr(TRunner, "blob_keyer")
