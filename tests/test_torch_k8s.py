"""``python -m trivy_tpu_torch k8s`` and ``trivy_tpu_torch.k8s``
(``ManifestClient``, ``K8sScanner``, ``k8s/report.py``) and
``compliance.py`` against the JAX package's ``trivy_tpu.cli k8s`` and
modules, in the same process.

The cluster is a directory of manifests: the reference test's
Deployment, Role and CronJob, workloads naming the images of
``utils.synth.tiny_fleet`` (an apk database, half its packages
vulnerable, and a planted AWS key each) by ``--images-dir`` name, two
workloads that share one image, a ref no tarball answers, a truncated
tarball, a multi-document file and a JSON manifest. The port scans on
``--backend cpu`` (the torch code) and ``cpu-ref`` (numpy), the
reference on ``cpu``; reports must be equal after ``sort_keys``
(``json``) or byte for byte (the summary and ``all`` tables, the
compliance summary), with the exit codes and ``error:`` lines."""

import contextlib
import io
import json
import os
import shutil

import pytest

import trivy_tpu.compliance as rcompliance
import trivy_tpu.db as rdb
import trivy_tpu.k8s as rk8s
import trivy_tpu.k8s.report as rreport
import trivy_tpu.utils.synth as rsynth
import trivy_tpu_torch.compliance as tcompliance
import trivy_tpu_torch.db as tdb
import trivy_tpu_torch.k8s as tk8s
import trivy_tpu_torch.k8s.report as treport
from tests.torch_threads import one_torch_thread  # noqa: F401
from trivy_tpu.cli import main as rmain
from trivy_tpu_torch.cli import main as tmain

DEPLOYMENT = """apiVersion: apps/v1
kind: Deployment
metadata:
  name: web
  namespace: prod
spec:
  template:
    spec:
      containers:
        - name: app
          image: dry/img:0
          securityContext:
            privileged: true
"""

RBAC = """apiVersion: rbac.authorization.k8s.io/v1
kind: Role
metadata:
  name: reader
  namespace: prod
rules:
  - apiGroups: [""]
    resources: ["pods"]
    verbs: ["get"]
"""

CRONJOB = """apiVersion: batch/v1
kind: CronJob
metadata:
  name: nightly
spec:
  jobTemplate:
    spec:
      template:
        spec:
          containers:
            - name: task
              image: test/task:1.0
"""

WORKLOADS = """apiVersion: apps/v1
kind: StatefulSet
metadata:
  name: db
  namespace: data
spec:
  template:
    spec:
      initContainers:
        - name: init
          image: dry/img:1
      containers:
        - name: main
          image: dry/img:2
---
apiVersion: v1
kind: Pod
metadata:
  name: twin
spec:
  containers:
    - name: c
      image: dry/img:1
---
apiVersion: apps/v1
kind: DaemonSet
metadata:
  name: broken
  namespace: kube-system
spec:
  template:
    spec:
      containers:
        - name: agent
          image: dry/broken:1
          securityContext:
            runAsUser: 0
---
just a string
"""

JOB_JSON = {
    "apiVersion": "batch/v1", "kind": "Job",
    "metadata": {"name": "migrate", "namespace": "data"},
    "spec": {"template": {"spec": {"containers": [
        {"name": "m", "image": "dry/img:3",
         "securityContext": {"readOnlyRootFilesystem": True,
                             "runAsNonRoot": True}}]}}},
}

CUSTOM_SPEC = """spec:
  id: custom
  title: Custom policy set
  version: "0.1"
  controls:
    - id: C-1
      name: no privileged pods
      checks:
        - id: KSV017
      severity: HIGH
    - id: X-1
      name: not implemented anywhere
      checks:
        - id: KSV999
      severity: LOW
      defaultStatus: FAIL
    - id: X-2
      name: also unimplemented, no default
      checks:
        - id: KSV998
      severity: LOW
    - id: V-1
      name: a vulnerability
      checks:
        - id: CVE-2022-10001
      severity: HIGH
"""


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    d = tmp_path_factory.mktemp("k8s")
    os.makedirs(d / "fleet")
    paths, store = rsynth.tiny_fleet(str(d / "fleet"), 4)
    images = d / "images"
    images.mkdir()
    for n, p in enumerate(paths):
        shutil.copy(p, images / f"dry_img_{n}.tar")
    with open(paths[0], "rb") as f:
        (images / "dry_broken_1.tar").write_bytes(f.read()[:3000])
    rdb.CompiledDB.compile(store).save(str(d / "cdb"))
    m = d / "cluster"
    m.mkdir()
    (m / "deploy.yaml").write_text(DEPLOYMENT)
    (m / "rbac.yaml").write_text(RBAC)
    (m / "cron.yml").write_text(CRONJOB)
    (m / "workloads.yaml").write_text(WORKLOADS)
    sub = m / "batch"
    sub.mkdir()
    (sub / "job.json").write_text(json.dumps(JOB_JSON))
    (sub / "broken.yaml").write_text("kind: [unclosed\n")
    (sub / "notes.txt").write_text("kind: Pod\n")
    (d / "spec.yaml").write_text(CUSTOM_SPEC)
    (d / "bad-spec.yaml").write_text("spec: [unclosed\n")
    (d / "list-spec.yaml").write_text("- a\n- b\n")
    return {"dir": str(m), "images": str(images), "db": str(d / "cdb"),
            "store": store, "spec": str(d / "spec.yaml"),
            "bad_spec": str(d / "bad-spec.yaml"),
            "list_spec": str(d / "list-spec.yaml"),
            "single": str(m / "deploy.yaml"), "root": d}


@pytest.fixture(autouse=True)
def _reset_secret_config():
    yield
    import trivy_tpu.analyzer as ranalyzer
    import trivy_tpu_torch.analyzer as tanalyzer
    for pkg in (ranalyzer, tanalyzer):
        for a in pkg.registered_analyzers():
            if a.type == "secret":
                a.config_path = ""


def _artifacts(mod, path) -> list:
    return [(a.kind, a.name, a.namespace, a.images,
             json.dumps(a.raw, sort_keys=True))
            for a in mod.ManifestClient(path).artifacts()]


@pytest.mark.parametrize("which", ["dir", "single"])
def test_manifest_client_equals_the_reference(cluster, which):
    got = _artifacts(tk8s, cluster[which])
    assert got == _artifacts(rk8s, cluster[which])
    assert tk8s.ManifestClient(cluster[which]).cluster_name == \
        rk8s.ManifestClient(cluster[which]).cluster_name
    if which == "dir":
        kinds = sorted(k for k, *_ in got)
        assert kinds == ["CronJob", "DaemonSet", "Deployment", "Job",
                         "Pod", "Role", "StatefulSet"]


def _store(pkg, cluster):
    mod = rdb if pkg == "ref" else tdb
    return mod.CompiledDB.load(cluster["db"])


def _scan(pkg, cluster, backend, checks, path="dir") -> dict:
    mod = rk8s if pkg == "ref" else tk8s
    scanner = mod.K8sScanner(
        store=_store(pkg, cluster) if "vuln" in checks else None,
        backend=backend, images_dir=cluster["images"],
        security_checks=list(checks))
    return scanner.scan(mod.ManifestClient(cluster[path]))


@pytest.mark.parametrize("checks", [("config",), ("vuln",),
                                    ("vuln", "secret", "config"),
                                    ("secret", "rbac")])
def test_scanner_reports_equal_the_reference(cluster, checks):
    want = json.dumps(_scan("ref", cluster, "cpu", checks).to_dict(),
                      sort_keys=True)
    for backend in ("cpu", "cpu-ref"):
        got = _scan("port", cluster, backend, checks)
        assert json.dumps(got.to_dict(), sort_keys=True) == want, backend
    if "vuln" in checks:
        by_name = {(r.kind, r.name): r for r in got.vulnerabilities}
        assert by_name[("CronJob", "nightly")].error == \
            "image not resolvable: test/task:1.0"
        assert by_name[("DaemonSet", "broken")].error
        ids = {v.vulnerability_id for res in
               by_name[("Deployment", "web")].results
               for v in res.vulnerabilities}
        assert ids and all(i.startswith("CVE-2022-1000") for i in ids)
        assert [r.to_dict() for r in by_name[("Pod", "twin")].results] \
            == [r.to_dict() for r in
                [v for v in got.vulnerabilities
                 if v.name == "db"][0].results]


def test_summary_all_and_failed_equal_the_reference(cluster):
    checks = ("vuln", "secret", "config")
    reports = {"ref": _scan("ref", cluster, "cpu", checks),
               "port": _scan("port", cluster, "cpu", checks)}
    for fn in ("render_summary", "render_all", "k8s_failed"):
        assert getattr(treport, fn)(reports["port"]) == \
            getattr(rreport, fn)(reports["ref"]), fn
    for fmt, mode in (("table", "summary"), ("table", "all"),
                      ("json", "summary")):
        outs = []
        for mod, pkg in ((rreport, "ref"), (treport, "port")):
            buf = io.StringIO()
            mod.write_k8s_report(reports[pkg], fmt=fmt, mode=mode,
                                 output=buf)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
    empty = (rk8s.K8sReport(cluster_name="c"), tk8s.K8sReport(
        cluster_name="c"))
    assert treport.render_summary(empty[1]) == \
        rreport.render_summary(empty[0])


@pytest.mark.parametrize("spec", ["nsa", "custom"])
def test_compliance_reports_equal_the_reference(cluster, spec):
    name = "nsa" if spec == "nsa" else cluster["spec"]
    checks = ("vuln", "config")
    out = []
    for mod, pkg in ((rcompliance, "ref"), (tcompliance, "port")):
        rep = _scan(pkg, cluster, "cpu", checks)
        results = [res for group in (rep.misconfigurations,
                                     rep.vulnerabilities)
                   for r in group for res in r.results]
        built = mod.build_report(mod.load_spec(name), results)
        buf = io.StringIO()
        mod.write_compliance(built, fmt="table", output=buf)
        out.append((json.dumps(built.to_dict(), sort_keys=True),
                    buf.getvalue(), mod.render_summary(built)))
    assert out[0] == out[1]
    doc = json.loads(out[1][0])
    by_id = {c["ID"]: c for c in doc["Controls"]}
    if spec == "nsa":
        assert by_id["1.4"]["Status"] == "FAIL"
    else:
        assert by_id["X-1"]["FailTotal"] == 1
        assert by_id["V-1"]["Status"] == "FAIL"


def test_compliance_spec_errors_equal_the_reference(cluster):
    for path in (cluster["bad_spec"], cluster["list_spec"],
                 str(cluster["root"] / "missing.yaml")):
        got = []
        for mod in (rcompliance, tcompliance):
            try:
                got.append(("ok", mod.load_spec(path)))
            except Exception as e:   # noqa: BLE001 — compared
                got.append((type(e).__name__, str(e)))
        assert got[0] == got[1]


def _run(main, argv: list) -> tuple:
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        code = main(argv)
    errors = [ln for ln in err.getvalue().splitlines()
              if ln.startswith("error:")]
    return code, buf.getvalue(), errors


CLI_CASES = [
    ("summary", ["--security-checks", "config"]),
    ("summary-vuln", ["--security-checks", "vuln,config", "--db"]),
    ("all", ["--report", "all", "--security-checks",
             "vuln,secret,config", "--db"]),
    ("json", ["--format", "json", "--db"]),
    ("json-config", ["--format", "json", "--security-checks",
                     "vuln,secret,config", "--db"]),
    ("severity", ["--security-checks", "vuln,config", "--severity",
                  "CRITICAL", "--exit-code", "5", "--db"]),
    ("exit-code", ["--security-checks", "config", "--exit-code", "5"]),
    ("exit-code-vuln", ["--exit-code", "4", "--format", "json", "--db"]),
    ("unfixed", ["--format", "json", "--ignore-unfixed",
                 "--include-non-failures", "--security-checks",
                 "vuln,config", "--db"]),
    ("nsa", ["--security-checks", "config", "--compliance", "nsa"]),
    ("nsa-json", ["--security-checks", "vuln,config", "--compliance",
                  "nsa", "--format", "json", "--severity", "CRITICAL",
                  "--db"]),
    ("spec", ["--security-checks", "vuln,config", "--compliance",
              "@spec", "--format", "json", "--db"]),
    ("bad-spec", ["--security-checks", "config", "--compliance",
                  "@bad_spec"]),
    ("missing-spec", ["--security-checks", "config", "--compliance",
                      "/nonexistent/spec.yaml"]),
    ("compliance-sarif", ["--compliance", "nsa", "--format", "sarif"]),
    ("fault-spec", ["--fault-spec", "cache-outage"]),
]


@pytest.mark.parametrize("name,flags", CLI_CASES)
def test_k8s_cli_equals_the_reference(cluster, name, flags, tmp_path,
                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = []
    for f in flags:
        if f == "--db":
            argv += ["--compiled-db", cluster["db"]]
        elif f.startswith("@"):
            argv.append(cluster[f[1:]])
        else:
            argv.append(f)
    common = ["k8s", cluster["dir"], "--images-dir", cluster["images"]]
    json_out = "json" in flags
    outs = {}
    for pkg, main, backend in (("ref", rmain, "cpu"),
                               ("port", tmain, "cpu"),
                               ("port-ref", tmain, "cpu-ref")):
        out_file = tmp_path / f"{pkg}.out"
        code, stdout, errors = _run(main, common + argv + [
            "--backend", backend, "--output", str(out_file),
            "--cache-dir", str(tmp_path / f"c-{pkg}")])
        text = out_file.read_text() if out_file.exists() else ""
        if json_out and text:
            text = json.dumps(json.loads(text), sort_keys=True)
        outs[pkg] = (code, text, stdout, errors)
    assert outs["port"] == outs["ref"], name
    assert outs["port-ref"] == outs["ref"], name
    code, text, _, errors = outs["port"]
    if name in ("bad-spec", "missing-spec"):
        assert code == 1 and errors[0].startswith(
            "error: compliance spec:")
    elif name in ("compliance-sarif", "fault-spec"):
        assert code == 2 and errors
    elif name.startswith("exit-code"):
        assert code in (4, 5)
    else:
        assert text and code == 0 and not errors


def test_k8s_cli_missing_path_equals_the_reference(tmp_path):
    got = [_run(main, ["k8s", str(tmp_path / "nope"), "--backend",
                       "cpu"]) for main in (rmain, tmain)]
    assert got[0] == got[1] and got[1][0] == 1
