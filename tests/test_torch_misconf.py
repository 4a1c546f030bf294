"""The ``config`` check of the port (``trivy_tpu_torch/misconf/``, the
config collectors, the misconf post-handler, ``LocalScanner``'s
misconfiguration results and the ``config`` entry) against the JAX
package's, on the CPU.

``scan_config_files`` on the same ``ConfigFile``s through both
packages: tests/test_misconf.py's inputs (Dockerfiles, Kubernetes
YAML and JSON with several documents and non-Kubernetes ones,
Terraform modules with ``Unresolved`` attributes, CloudFormation YAML
with its tags and JSON, a Helm chart with ``--helm-values`` and
``--helm-set``) and ``chip_smoke.iac_files``' seeded subtrees, with
and without ``--trace``, with a ``--config-policy`` directory (one file
per package that differs only in its import) and with the YAML-less
path (``yaml_mod`` None in both). Then the entries: ``fs``, ``rootfs``
and ``config`` on a seeded IaC tree, ``image`` on a layered image whose
IaC files change from layer to layer, and the direct and scheduled
fleets at depth 1 and 2. Equality is exact: the blob-level results
after ``sort_keys``, the reports in ``json`` after ``sort_keys`` and in
``table`` byte for byte, with the same exit code."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import trivy_tpu.analyzer as ranalyzer
import trivy_tpu.db as rdb
import trivy_tpu.misconf as rmisconf
import trivy_tpu.misconf.cloudformation as rcfn
import trivy_tpu.misconf.helm as rhelm
import trivy_tpu_torch.analyzer as tanalyzer
import trivy_tpu_torch.db as tdb
import trivy_tpu_torch.misconf as tmisconf
import trivy_tpu_torch.misconf.cloudformation as tcfn
import trivy_tpu_torch.misconf.helm as thelm
import tests.test_misconf as ref_cases
from chip_smoke import (FS_ROOTS, IMAGE_HISTORY, dpkg_names, fs_tree_files,
                        iac_files, make_advisory_store, make_corpus,
                        make_fs_tree, write_docker_save)
from tests.test_torch_scan_local import _fast_yaml, _fixture_docs
from tests.torch_threads import one_torch_thread  # noqa: F401
from trivy_tpu.artifact import ArtifactOption as RArtifactOption
from trivy_tpu.cli import main as rmain
from trivy_tpu.runtime import BatchScanRunner as RRunner
from trivy_tpu.types import ConfigFile as RConfigFile
from trivy_tpu.types import ScanOptions as RScanOptions
from trivy_tpu_torch.artifact import ArtifactOption as TArtifactOption
from trivy_tpu_torch.cli import main as tmain
from trivy_tpu_torch.runtime import BatchScanRunner as TRunner
from trivy_tpu_torch.types import ConfigFile as TConfigFile
from trivy_tpu_torch.types import ScanOptions as TScanOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261016
STORE_ROWS = 2000
CONFIG_CHECKS = ["vuln", "secret", "config"]


@pytest.fixture(autouse=True)
def _reset_globals():
    """``misconf.configure`` and the secret analyzer's ``config_path``
    are process-global in both packages: every test starts and ends
    with the defaults."""
    for m in (rmisconf, tmisconf):
        m.configure()
    yield
    for m in (rmisconf, tmisconf):
        m.configure()
    for pkg in (ranalyzer, tanalyzer):
        for a in pkg.registered_analyzers():
            if a.type == "secret":
                a.config_path = ""


def _no_yaml(monkeypatch) -> None:
    """The chip machine's case: no PyYAML for either package's misconf
    engine."""
    for mod in (rmisconf, rcfn, rhelm, tmisconf, tcfn, thelm):
        monkeypatch.setattr(mod, "yaml_mod", None)


def _scan_both(files: list) -> tuple:
    """``scan_config_files`` on ``files`` ([(type, path, bytes)]) in
    both packages: (reference, port) as sorted JSON."""
    out = []
    for m, cf in ((rmisconf, RConfigFile), (tmisconf, TConfigFile)):
        res = m.scan_config_files([cf(type=t, file_path=p, content=c)
                                   for t, p, c in files])
        out.append(json.dumps([r.to_dict() for r in res],
                              sort_keys=True))
    return tuple(out)


def _config_type(rel: str) -> str:
    """The collector a path goes to (``analyzer/config.py``)."""
    base = os.path.basename(rel).lower()
    if base in ("dockerfile", "containerfile") or \
            base.startswith("dockerfile.") or base.endswith(".dockerfile"):
        return "dockerfile"
    if rel.endswith(".tf"):
        return "terraform"
    if rel.endswith((".yaml", ".yml")):
        return "yaml"
    if rel.endswith(".json"):
        return "json"
    return ""


HARDENED_POD = b"""apiVersion: v1
kind: Pod
metadata:
  name: web
spec:
  securityContext:
    runAsNonRoot: true
  containers:
    - name: app
      image: nginx:1.25
      securityContext:
        allowPrivilegeEscalation: false
        readOnlyRootFilesystem: true
        capabilities:
          drop: [ALL]
      resources:
        limits: {cpu: 500m, memory: 128Mi}
"""

MULTI_DOC = ref_cases.BAD_K8S + b"---\n" + HARDENED_POD + \
    b"---\nfoo: bar\n---\n- just\n- a list\n"

UNRESOLVED_TF = (b'variable "enc" {}\n'
                 b'resource "aws_db_instance" "d" {\n'
                 b'  storage_encrypted = var.enc\n}\n'
                 b'resource "aws_s3_bucket" "b" {\n'
                 b'  acl = "${var.prefix}-read"\n}\n'
                 b'resource "aws_security_group" "s" {\n'
                 b'  ingress {\n    cidr_blocks = [local.cidr]\n  }\n}\n')

CHART = [("yaml", "chart/Chart.yaml", ref_cases.CHART_YAML),
         ("yaml", "chart/values.yaml", ref_cases.VALUES_YAML),
         ("yaml", "chart/templates/deploy.yaml", ref_cases.DEPLOY_TPL)]

CASES = {
    "dockerfiles": [("dockerfile", "Dockerfile", ref_cases.BAD_DOCKERFILE),
                    ("dockerfile", "good/Dockerfile",
                     ref_cases.GOOD_DOCKERFILE),
                    ("dockerfile", "multi/Dockerfile",
                     b"FROM node AS build\nRUN npm ci\nFROM node\n"
                     b"COPY --from=build /app /app\nUSER app\n")],
    "k8s_yaml": [("yaml", "pod.yaml", ref_cases.BAD_K8S),
                 ("yaml", "hardened.yaml", HARDENED_POD)],
    "k8s_multi_doc": [("yaml", "all.yaml", MULTI_DOC),
                      ("yaml", "plain.yaml", b"name: x\nitems: [1, 2]\n"),
                      ("yaml", "broken.yaml", b"a: [unclosed\n")],
    "k8s_json": [("json", "pod.json", json.dumps(
        yaml.safe_load(ref_cases.BAD_K8S)).encode()),
        ("json", "data.json", b'{"name": "not k8s"}'),
        ("json", "bad.json", b"{not json")],
    "terraform": [("terraform", "main.tf", ref_cases.TF_BAD),
                  ("terraform", "good/main.tf", ref_cases.TF_GOOD)],
    "terraform_cross_file": [
        ("terraform", "m/vars.tf",
         b'variable "acl" { default = "public-read" }\n'),
        ("terraform", "m/s3.tf",
         b'resource "aws_s3_bucket" "b" { acl = var.acl }\n')],
    "terraform_unresolved": [("terraform", "u/main.tf", UNRESOLVED_TF)],
    "cloudformation": [("json", "t.json", ref_cases.CFN_BAD),
                       ("yaml", "t.yaml", ref_cases.CFN_YAML_INTRINSICS)],
    "helm": CHART,
    "helm_at_root": [(t, p[len("chart/"):], c) for t, p, c in CHART],
}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_config_files_equals_reference(case, trace):
    for m in (rmisconf, tmisconf):
        m.configure(trace=trace)
    want, got = _scan_both(CASES[case])
    assert got == want
    assert json.loads(got)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_iac_equals_reference(seed):
    """``iac_files`` at a small size under four seeds, with ``--trace``
    on for odd seeds: every file type, failures and passes."""
    files, _ = iac_files(seed, [f"pkg{i}" for i in range(3)], n_each=12,
                         n_tf=6, n_cfn_yaml=6, n_licenses=0)
    inputs = [(_config_type(rel), rel, data) for rel, data in files
              if _config_type(rel)]
    for m in (rmisconf, tmisconf):
        m.configure(trace=bool(seed % 2))
    want, got = _scan_both(inputs)
    assert got == want
    kinds = {m["FileType"] for m in json.loads(got)}
    assert kinds == {"dockerfile", "kubernetes", "terraform",
                     "cloudformation", "helm"}


def test_trace_lists_the_unresolved_attributes():
    for m in (rmisconf, tmisconf):
        m.configure(trace=True)
    want, got = _scan_both(CASES["terraform_unresolved"])
    assert got == want
    assert json.loads(got)[0]["Traces"]


@pytest.mark.parametrize("how", ["values", "set", "both"])
def test_helm_values_and_set_equal_reference(how, tmp_path):
    vf = tmp_path / "over.yaml"
    vf.write_text("runAsRoot: false\nimage:\n  tag: \"1.26\"\n")
    kwargs = {"values": {"helm_value_files": [str(vf)]},
              "set": {"helm_set_values": ["runAsRoot=false",
                                          "image.tag=1.27"]},
              "both": {"helm_value_files": [str(vf)],
                       "helm_set_values": ["image.tag=1.28"]}}[how]
    for m in (rmisconf, tmisconf):
        m.configure(**kwargs)
    want, got = _scan_both(CHART)
    assert got == want
    helm = [m for m in json.loads(got) if m["FileType"] == "helm"]
    assert helm and "KSV012" not in {f["ID"] for f in
                                     helm[0].get("Failures", [])}


def _policy_dirs(tmp_path) -> dict:
    """A ``--config-policy`` directory per package: the same module but
    for the import line (tests/test_misconf.py's policy)."""
    dirs = {}
    for pkg in ("trivy_tpu", "trivy_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        (d / "latest.py").write_text(ref_cases.CUSTOM_POLICY.replace(
            "from trivy_tpu.misconf.policies",
            f"from {pkg}.misconf.policies"))
        (d / "notes.txt").write_text("not a policy module")
        dirs[pkg] = str(d)
    return dirs


def test_config_policy_dir_equals_reference(tmp_path):
    dirs = _policy_dirs(tmp_path)
    rmisconf.configure(policy_dirs=[dirs["trivy_tpu"]])
    tmisconf.configure(policy_dirs=[dirs["trivy_tpu_torch"]])
    doc = (b"apiVersion: apps/v1\nkind: Deployment\nmetadata:\n  name: d\n"
           b"spec:\n  template:\n    spec:\n      containers:\n"
           b"      - name: c\n        image: web:latest\n")
    want, got = _scan_both([("yaml", "d.yaml", doc),
                            ("yaml", "ok.yaml", HARDENED_POD)])
    assert got == want
    fails = [f for m in json.loads(got) for f in m.get("Failures", [])
             if f["ID"] == "USR-0001"]
    assert fails and fails[0]["Namespace"] == "user.kubernetes.USR-0001"


@pytest.mark.parametrize("source,message", [
    ("syntax error(((", "config policy"),
    ("X = 1\n", "must define POLICIES"),
])
def test_bad_policy_module_raises_in_both(tmp_path, source, message):
    d = tmp_path / "p"
    d.mkdir()
    (d / "x.py").write_text(source)
    for m in (rmisconf, tmisconf):
        with pytest.raises(ValueError, match=message):
            m.configure(policy_dirs=[str(d)])
    for m in (rmisconf, tmisconf):
        with pytest.raises(ValueError, match="--config-policy"):
            m.configure(policy_dirs=[str(tmp_path / "missing")])


@pytest.mark.parametrize("case", ["k8s_yaml", "cloudformation", "helm",
                                  "dockerfiles", "k8s_json"])
def test_yaml_less_path_equals_reference(case, monkeypatch):
    """Without PyYAML both engines skip YAML manifests, CloudFormation
    YAML and Helm charts alike; JSON, Terraform and Dockerfiles are
    still evaluated."""
    _no_yaml(monkeypatch)
    want, got = _scan_both(CASES[case])
    assert got == want
    if case in ("k8s_yaml", "helm"):
        assert json.loads(got) == []
    if case == "cloudformation":
        assert [m["FilePath"] for m in json.loads(got)] == ["t.json"]


def test_collectors_equal_reference():
    """The four collectors' gates on seeded paths and sizes, and what
    they collect."""
    from trivy_tpu.analyzer.config import MAX_CONFIG_SIZE as RMAX
    from trivy_tpu_torch.analyzer.config import MAX_CONFIG_SIZE
    assert MAX_CONFIG_SIZE == RMAX
    rng = np.random.default_rng(5)
    names = ["Dockerfile", "dockerfile.dev", "app.Dockerfile",
             "Containerfile", "x.yaml", "x.yml", "x.json", "main.tf",
             "x.tf.json", "Dockerfile.txt", "README.md", "yaml", "tf"]
    rcol = {a.type: a for a in ranalyzer.registered_analyzers()}
    tcol = {a.type: a for a in tanalyzer.registered_analyzers()}
    for kind in ("dockerfile", "yaml", "json", "terraform"):
        for _ in range(40):
            path = "/".join(["a", "b", "c"][:int(rng.integers(0, 4))] +
                            [str(rng.choice(names))])
            size = int(rng.choice([0, 10, MAX_CONFIG_SIZE,
                                   MAX_CONFIG_SIZE + 1]))
            assert tcol[kind].required(path, size) == \
                rcol[kind].required(path, size)
            content = rng.bytes(16)
            assert tcol[kind].analyze(path, content) \
                .to_blob_info().to_dict() == \
                rcol[kind].analyze(path, content) \
                .to_blob_info().to_dict()


def test_local_scanner_misconf_results_equal_reference():
    """``LocalScanner`` with the ``config`` check on a blob the misconf
    post-handler filled: ``misconfsToResults`` (status, severity,
    primary URL, the once-per-clean-file trace) as the reference's."""
    from trivy_tpu.artifact import MemoryCache as RCache
    from trivy_tpu.handler import post_handle as rpost
    from trivy_tpu.scan.local import LocalScanner as RScanner
    from trivy_tpu.scan.local import ScanTarget as RTarget
    from trivy_tpu.types import BlobInfo as RBlob
    from trivy_tpu_torch.artifact import MemoryCache as TCache
    from trivy_tpu_torch.handler import post_handle as tpost
    from trivy_tpu_torch.scan.local import LocalScanner as TScanner
    from trivy_tpu_torch.scan.local import ScanTarget as TTarget
    from trivy_tpu_torch.types import BlobInfo as TBlob
    inputs = [x for k in ("dockerfiles", "k8s_json", "terraform_unresolved",
                          "cloudformation") for x in CASES[k]]
    out = []
    for m, cache, post, scanner, target, blob, cf, opts in (
            (rmisconf, RCache(), rpost, RScanner, RTarget, RBlob,
             RConfigFile, RScanOptions),
            (tmisconf, TCache(), tpost, TScanner, TTarget, TBlob,
             TConfigFile, TScanOptions)):
        m.configure(trace=True)
        b = blob(config_files=[cf(type=t, file_path=p, content=c)
                               for t, p, c in inputs])
        post(b)
        cache.put_blob("sha256:b", b)
        sc = scanner(cache)
        prepared = sc.prepare(target("t", "sha256:a", ["sha256:b"]),
                              opts(security_checks=["config"]))
        results, _ = sc.finish(prepared, [])
        out.append(json.dumps([r.to_dict() for r in results],
                              sort_keys=True))
    assert out[1] == out[0]
    statuses = {m["Status"] for r in json.loads(out[1])
                for m in r["Misconfigurations"]}
    assert statuses == {"FAIL", "PASS"}


# --- the entries ------------------------------------------------------

@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A seeded DB as fixture JSON, an IaC tree (a debian root, a few
    corpus files, ``iac_files`` at a small size) and a layered image
    whose IaC files change from layer to layer."""
    d = tmp_path_factory.mktemp("misconf")
    store, n_pkgs = make_advisory_store(STORE_ROWS, SEED,
                                        store=rdb.AdvisoryStore())
    tstore, _ = make_advisory_store(STORE_ROWS, SEED)
    (d / "db.json").write_text(json.dumps(_fixture_docs(store)))
    corpus, planted = make_corpus(24, 7)
    os_files, app_files = fs_tree_files(FS_ROOTS["fs"], n_pkgs, SEED, 0.05)
    iac, _ = iac_files(SEED, dpkg_names(os_files), n_each=10, n_tf=5,
                       n_cfn_yaml=5, n_licenses=8)
    tree = d / "tree"
    make_fs_tree(str(tree), FS_ROOTS["fs"], n_pkgs, SEED, 0.05,
                 files=corpus + iac)
    # the image: the IaC set in the lockfile layer, a later layer that
    # rewrites Dockerfiles and adds a Terraform module, one that whites
    # out manifests and a license file
    docker = [(rel, data) for rel, data in iac if "iac/docker/" in rel]
    l2 = [(rel, data.replace(b"USER app", b"USER root")
           .replace(b"alpine:3.16", b"alpine:latest"))
          for rel, data in docker[:6] if rel.endswith("Dockerfile")]
    l2 += [("iac/tf/extra/main.tf", ref_cases.TF_BAD)]
    gone = [rel for rel, _ in iac if rel.startswith("iac/k8s/json/")][:3]
    gone += [rel for rel, _ in iac if rel.endswith("LICENSE")][:1]
    l4 = [(f"{os.path.dirname(rel)}/.wh.{os.path.basename(rel)}", b"")
          for rel in gone]
    layers = [os_files, app_files + iac, corpus[:12] + l2, corpus[12:],
              l4]
    image = write_docker_save(str(d / "image.tar"), layers, IMAGE_HISTORY)
    # the fleet: three images of their own IaC sets, one twin
    fleet = []
    for i in range(3):
        f, _ = iac_files(SEED + i, [], n_each=4, n_tf=2, n_cfn_yaml=2,
                         n_licenses=3)
        fleet.append(write_docker_save(
            str(d / f"fleet{i}.tar"),
            [os_files, app_files, f, corpus[i * 8:(i + 1) * 8], []],
            IMAGE_HISTORY, repo_tag=f"smoke/iac:{i}"))
    return {"db": str(d / "db.json"), "tree": str(tree), "image": image,
            "fleet": fleet, "gone": gone, "stores": (store, tstore)}


def _run(main, argv: list) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    said = [ln for ln in err.getvalue().splitlines()
            if ln.startswith(("error:", "warning:"))]
    return code, out.getvalue(), said


def _norm(text: str, fmt: str) -> str:
    return json.dumps(json.loads(text), sort_keys=True) \
        if fmt == "json" else text


def _both(argv: list, fmt: str, ref_extra=("--no-cache",)) -> tuple:
    """The reference's and the port's (code, normalized output, said)
    for ``argv`` on ``--backend cpu``."""
    rcode, rout, rsaid = _run(rmain, argv + ["--backend", "cpu",
                                             *ref_extra])
    tcode, tout, tsaid = _run(tmain, argv + ["--backend", "cpu"])
    return (rcode, _norm(rout, fmt), rsaid), (tcode, _norm(tout, fmt),
                                              tsaid)


FS_CASES = [
    ("fs", "json", []),
    ("fs", "table", []),
    ("fs", "json", ["--include-non-failures"]),
    ("rootfs", "table", ["--include-non-failures", "--exit-code", "1"]),
    ("rootfs", "json", ["--exit-code", "1", "--severity", "HIGH,CRITICAL"]),
    ("fs", "json", ["--trace"]),
    ("config", "json", []),
    ("config", "table", ["--exit-code", "1"]),
    ("conf", "json", ["--include-non-failures", "--trace"]),
]


@pytest.mark.parametrize("cmd,fmt,flags", FS_CASES)
def test_fs_entries_equal_reference(seeded, cmd, fmt, flags, tmp_path,
                                    monkeypatch):
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    monkeypatch.chdir(tmp_path)
    argv = [cmd, seeded["tree"], "--format", fmt] + flags
    if cmd not in ("config", "conf"):
        argv += ["--security-checks", ",".join(CONFIG_CHECKS),
                 "--db-fixtures", seeded["db"]]
    want, got = _both(argv, fmt)
    assert got == want
    assert want[0] == (1 if "--exit-code" in flags else 0)
    if fmt == "json":
        classes = {r["Class"] for r in json.loads(want[1])["Results"]}
        assert "config" in classes
        assert (classes == {"config"}) == (cmd in ("config", "conf"))


def test_fs_yaml_less_equals_reference(seeded, tmp_path, monkeypatch):
    _no_yaml(monkeypatch)
    monkeypatch.chdir(tmp_path)
    want, got = _both(["config", seeded["tree"], "--format", "json"],
                      "json")
    assert got == want
    types = {r["Type"] for r in json.loads(got[1])["Results"]}
    assert types == {"dockerfile", "kubernetes", "terraform",
                     "cloudformation"}


def test_config_policy_and_helm_flags_on_fs(seeded, tmp_path, monkeypatch):
    """``--config-policy`` (one directory per package), ``--helm-values``
    and ``--helm-set`` through both CLIs; a policy module that cannot
    load is an ``error:`` line and exit 1 in both."""
    monkeypatch.chdir(tmp_path)
    dirs = _policy_dirs(tmp_path)
    vf = tmp_path / "v.yaml"
    vf.write_text("runAsRoot: false\n")
    argv = ["config", seeded["tree"], "--format", "json",
            "--helm-values", str(vf), "--helm-set", "image.tag=2.0"]
    rcode, rout, _ = _run(rmain, argv + [
        "--config-policy", dirs["trivy_tpu"], "--backend", "cpu",
        "--no-cache"])
    tcode, tout, _ = _run(tmain, argv + [
        "--config-policy", dirs["trivy_tpu_torch"], "--backend", "cpu"])
    assert (tcode, _norm(tout, "json")) == (rcode, _norm(rout, "json"))
    ids = {m["ID"] for r in json.loads(tout)["Results"]
           for m in r.get("Misconfigurations", [])}
    assert "USR-0001" in ids
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "x.py").write_text("syntax error(((")
    argv = ["fs", seeded["tree"], "--security-checks", "config",
            "--config-policy", str(bad)]
    want, got = _both(argv, "table")
    assert got[0] == want[0] == 1 and got[1] == want[1] == ""
    assert [s.split(":")[0] for s in got[2]] == ["error"]
    assert got[2][0].startswith("error: config policy ")
    assert want[2][0].startswith("error: config policy ")


def test_trace_flag_is_the_misconf_trace(seeded, tmp_path, monkeypatch):
    """``--trace`` is the misconf trace flag, not an abbreviation of
    ``--trace-out``: ``fs DIR --trace`` evaluates with traces and
    exports no trace file."""
    from trivy_tpu_torch.obs.trace import get_tracer
    monkeypatch.chdir(tmp_path)
    tracer = get_tracer()
    before = (tracer.export_dir, tracer.n_exported)
    code, out, _ = _run(tmain, ["fs", seeded["tree"], "--trace",
                                "--security-checks", "config",
                                "--backend", "cpu", "--format", "json"])
    assert code == 0 and tmisconf._options.trace
    assert (tracer.export_dir, tracer.n_exported) == before
    assert os.listdir(tmp_path) == []
    assert any(m.get("Traces") for r in json.loads(out)["Results"]
               for m in r.get("Misconfigurations", []))
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            tmain(["fs", "--trace", "x", seeded["tree"]])


def test_config_entry_needs_a_card_by_default(seeded, monkeypatch,
                                              tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("config", "conf"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain([cmd, seeded["tree"]])


@pytest.mark.parametrize("fmt,flags", [
    ("json", []), ("table", ["--include-non-failures"]),
    ("json", ["--trace", "--exit-code", "1"])])
def test_image_equals_reference(seeded, fmt, flags, tmp_path, monkeypatch):
    """A layered image: the IaC set in one layer, rewritten Dockerfiles
    and a new module in a later one, whited-out manifests and a license
    file in the last."""
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    monkeypatch.chdir(tmp_path)
    argv = ["image", "--input", seeded["image"], "--format", fmt,
            "--security-checks", "vuln,secret,config,license",
            "--db-fixtures", seeded["db"]] + flags
    want, got = _both(argv, fmt, ("--no-cache", "--no-memo"))
    assert got == want
    if fmt == "json":
        targets = {r["Target"].lstrip("/")
                   for r in json.loads(want[1])["Results"]
                   if r["Class"] == "config"}
        assert "iac/tf/extra/main.tf" in targets
        assert not targets & set(seeded["gone"])


def test_image_fscache_is_shared_with_reference(seeded, tmp_path,
                                                monkeypatch):
    """The reference fills an on-disk blob cache with the config and
    license checks on; the port's scan on that directory walks no layer
    and reports what the reference reported."""
    import trivy_tpu_torch.artifact.artifact as tart
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    monkeypatch.chdir(tmp_path)
    cache = str(tmp_path / "cache")
    argv = ["image", "--input", seeded["image"], "--format", "json",
            "--security-checks", "vuln,secret,config,license",
            "--db-fixtures", seeded["db"], "--cache-dir", cache,
            "--backend", "cpu"]
    rcode, rout, _ = _run(rmain, argv + ["--no-memo"])

    def no_walk(*args, **kwargs):
        raise AssertionError("a cached layer was walked")

    monkeypatch.setattr(tart, "collect_layer_tar", no_walk)
    tcode, tout, _ = _run(tmain, argv + ["--no-memo"])
    assert (tcode, _norm(tout, "json")) == (rcode, _norm(rout, "json"))


def _untraced(obj) -> str:
    return re.sub(r"trace [0-9a-f]{32}[^\"]*", "TRACE", json.dumps(obj))


def _fleet_norm(results) -> str:
    return _untraced([(r.name, r.status, [c.to_dict() for c in r.causes],
                       r.report.to_dict() if r.report else None)
                      for r in results])


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("sched", ["off", "on"])
def test_fleet_equals_reference(seeded, sched, depth):
    """``BatchScanRunner.scan_paths`` with every check, direct and
    scheduled, at depth 1 and 2: the runner's template option carries
    both checks to every image, as the reference's does."""
    checks = ["vuln", "secret", "config", "license"]
    rstore, tstore = seeded["stores"]
    paths = seeded["fleet"] + [seeded["fleet"][0]]
    rres = RRunner(store=rstore, backend="tpu", sched=sched,
                   dispatch_depth=depth, artifact_option=RArtifactOption(
                       scan_misconfig=True, scan_licenses=True)) \
        .scan_paths(paths, RScanOptions(security_checks=checks))
    runner = TRunner(store=tstore, backend="cpu", sched=sched,
                     dispatch_depth=depth, artifact_option=TArtifactOption(
                         scan_misconfig=True, scan_licenses=True))
    try:
        tres = runner.scan_paths(paths, TScanOptions(
            security_checks=checks, backend="cpu"))
    finally:
        runner.close()
    assert _fleet_norm(tres) == _fleet_norm(rres)
    for r in tres:
        classes = {x.class_ for x in r.report.results}
        assert {"config", "license-file"} <= classes


@pytest.mark.parametrize("sched", ["off", "on"])
def test_fleet_cli_equals_reference(seeded, sched, tmp_path, monkeypatch):
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    monkeypatch.chdir(tmp_path)
    argv = ["image", *seeded["fleet"], "--sched", sched, "--format",
            "json", "--security-checks", "vuln,secret,config,license",
            "--db-fixtures", seeded["db"], "--exit-code", "1"]
    want, got = _both(argv, "json", ("--no-cache", "--no-memo"))
    assert got == want and got[0] == 1
    assert len(json.loads(got[1])) == len(seeded["fleet"])


def test_config_entry_in_a_new_process(seeded, tmp_path):
    """``python -m trivy_tpu_torch config DIR`` against ``python -m
    trivy_tpu.cli config DIR``: the table byte for byte."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}

    def run(args) -> str:
        proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                              capture_output=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        return proc.stdout.decode()

    want = run(["trivy_tpu.cli", "config", seeded["tree"], "--backend",
                "cpu", "--no-cache", "--cache-dir", str(tmp_path / "c")])
    got = run(["trivy_tpu_torch", "config", seeded["tree"], "--backend",
               "cpu"])
    assert got == want and "(misconfigurations)" in got
