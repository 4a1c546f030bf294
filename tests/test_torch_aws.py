"""``python -m trivy_tpu_torch aws`` and ``trivy_tpu_torch.cloud``
(``load_account_state``, ``scan_account``, ``KNOWN_SERVICES``) against
the JAX package's ``trivy_tpu.cli aws`` and ``trivy_tpu.cloud``, in
the same process.

The account states are the reference tests' two and seeded ones (numpy,
every service the checks know, each flag drawn at random, access keys
far older or younger than the 90-day rotation). Results must be equal
as dicts, and the CLI's reports after ``sort_keys`` (``json``) or byte
for byte (``table``), with the exit codes and ``error:`` lines. The
checks run on the host: there is no device work to put on the card."""

import contextlib
import io
import json

import numpy as np
import pytest

import trivy_tpu.cloud as rcloud
import trivy_tpu_torch.cloud as tcloud
from trivy_tpu.cli import main as rmain
from trivy_tpu_torch.cli import main as tmain

ACCOUNT_STATE = {
    "state": {"aws": {
        "s3": {"buckets": [
            {"name": "public-bucket",
             "publicAccessBlock": {"blockPublicAcls": False},
             "encryption": {"enabled": True}},
            {"name": "good-bucket",
             "publicAccessBlock": {
                 "blockPublicAcls": True, "blockPublicPolicy": True,
                 "ignorePublicAcls": True,
                 "restrictPublicBuckets": True},
             "encryption": {"enabled": True}}]},
        "ec2": {"securityGroups": [
            {"name": "web", "ingressRules": [
                {"cidrs": ["0.0.0.0/0"], "fromPort": 22,
                 "toPort": 22}]}]},
        "iam": {"rootUser": {"accessKeys": ["AKIA..."]},
                "users": [{"name": "alice", "consoleAccess": True,
                           "mfaActive": True}]},
        "cloudtrail": {"trails": [{"isLogging": True}]},
    }},
}

BREADTH_STATE = {
    "ec2": {"securityGroups": [],
            "volumes": [
                {"id": "vol-plain", "encryption": {"enabled": False}},
                {"id": "vol-enc", "encryption": {"enabled": True}}]},
    "rds": {"instances": [
        {"id": "db-bad", "encryption": {"enabled": False},
         "publiclyAccessible": True, "backupRetentionPeriodDays": 0},
        {"id": "db-good", "encryption": {"enabled": True},
         "publiclyAccessible": False, "backupRetentionPeriodDays": 7}]},
    "efs": {"fileSystems": [{"id": "fs-1", "encrypted": False}]},
    "eks": {"clusters": [
        {"name": "prod",
         "publicAccess": {"enabled": True, "cidrs": ["0.0.0.0/0"]},
         "encryption": {"secrets": False},
         "logging": {"api": True, "audit": True, "authenticator": True,
                     "controllerManager": True, "scheduler": True}}]},
    "iam": {"users": [
        {"name": "stale", "accessKeys": [
            {"active": True, "creationDate": "2020-01-01T00:00:00Z"}]},
        {"name": "epoch", "accessKeys": [
            {"active": True, "creationDate": 1_000_000_000}]},
        {"name": "garbled", "accessKeys": [
            {"active": True, "creationDate": "not a date"}]}],
        "passwordPolicy": {"minimumLength": 8}},
    "kms": {"keys": [{"id": "cmk-1", "rotationEnabled": False},
                     {"id": "sign-key", "usage": "SIGN_VERIFY"}]},
}


def seeded_state(seed: int) -> dict:
    """Every service the checks read, each flag drawn at random; access
    keys are years old or far in the future, so the rotation check does
    not depend on today's date."""
    rng = np.random.default_rng(seed)

    def flag():
        return bool(rng.integers(0, 2))

    def n(k=4):
        return int(rng.integers(0, k))

    cidrs = (["0.0.0.0/0"], ["::/0"], ["10.0.0.0/8"], [])
    state = {
        "s3": {"buckets": [
            {"name": f"b{i}",
             "publicAccessBlock": {k: flag() for k in (
                 "blockPublicAcls", "blockPublicPolicy",
                 "ignorePublicAcls", "restrictPublicBuckets")},
             "encryption": {"enabled": flag()}} for i in range(n(6))]},
        "ec2": {"securityGroups": [
            {"name": f"sg{i}", "ingressRules": [
                {"cidrs": cidrs[n()], "fromPort": int(p),
                 "toPort": int(p) + n(30)}
                for p in rng.integers(0, 40, n(3))]}
            for i in range(n(5))],
            "volumes": [{"id": f"vol{i}", "encryption": {"enabled": flag()}}
                        for i in range(n())]},
        "iam": {"rootUser": {"accessKeys": ["AKIA"] * n(2)},
                "users": [
                    {"name": f"u{i}", "consoleAccess": flag(),
                     "mfaActive": flag(),
                     "accessKeys": [
                         {"active": flag(),
                          "creationDate": ("2015-06-01T00:00:00Z",
                                           "2999-01-01T00:00:00",
                                           1_200_000_000)[n(3)]}
                         for _ in range(n(3))]} for i in range(n(5))],
                **({"passwordPolicy": {
                    "minimumLength": n(20),
                    "reusePreventionCount": n(8),
                    "maxAgeDays": n(120)}} if flag() else {})},
        "cloudtrail": {"trails": [
            {"name": f"t{i}", "isLogging": flag(),
             "enableLogFileValidation": flag(),
             "kmsKeyId": "k" if flag() else ""} for i in range(n())]},
        "rds": {"instances": [
            {"id": f"db{i}", "encryption": {"enabled": flag()},
             "publiclyAccessible": flag(),
             "backupRetentionPeriodDays": n(10)} for i in range(n())]},
        "efs": {"fileSystems": [{"id": f"fs{i}", "encrypted": flag()}
                                for i in range(n())]},
        "ecr": {"repositories": [
            {"name": f"r{i}", "imageScanning": {"scanOnPush": flag()},
             "imageTagsImmutable": flag()} for i in range(n())]},
        "eks": {"clusters": [
            {"name": f"c{i}",
             "publicAccess": {"enabled": flag(), "cidrs": cidrs[n()]},
             "encryption": {"secrets": flag(),
                            "kmsKeyId": "k" if flag() else ""},
             "logging": {k: flag() for k in (
                 "api", "audit", "authenticator", "controllerManager",
                 "scheduler")}} for i in range(n())]},
        "elb": {"loadBalancers": [
            {"name": f"lb{i}",
             "type": ("application", "network", None)[n(3)],
             "dropInvalidHeaderFields": flag(),
             "listeners": [{"protocol": ("HTTP", "HTTPS")[n(2)],
                            "defaultActionType":
                                ("redirect", "forward")[n(2)]}
                           for _ in range(n(3))]} for i in range(n())]},
        "kms": {"keys": [
            {"id": f"k{i}", "rotationEnabled": flag(),
             **({"usage": "SIGN_VERIFY"} if flag() else {})}
            for i in range(n())]},
    }
    # a service left out is not audited
    for svc in sorted(state):
        if rng.random() < 0.15:
            del state[svc]
    return state


STATES = {"account": ACCOUNT_STATE["state"]["aws"],
          "breadth": BREADTH_STATE,
          **{f"seed{s}": seeded_state(s) for s in range(6)}}


def _results(mod, state, services=None) -> str:
    return json.dumps([r.to_dict() for r in
                       mod.scan_account(state, services)], sort_keys=True)


@pytest.mark.parametrize("name", sorted(STATES))
@pytest.mark.parametrize("services", [None, ["iam"], ["s3", "eks", "kms"]])
def test_scan_account_equals_the_reference(name, services):
    got = _results(tcloud, STATES[name], services)
    assert got == _results(rcloud, STATES[name], services)
    assert json.loads(got) or services or not STATES[name]


def test_policies_and_services_equal_the_reference():
    assert tcloud.KNOWN_SERVICES == rcloud.KNOWN_SERVICES
    assert [(p.id, p.avd_id, p.title, p.severity, p.service,
             p.recommended_actions, p.references)
            for p in tcloud.AWS_POLICIES] == \
        [(p.id, p.avd_id, p.title, p.severity, p.service,
          p.recommended_actions, p.references)
         for p in rcloud.AWS_POLICIES]


@pytest.mark.parametrize("doc", [
    ACCOUNT_STATE, {"aws": BREADTH_STATE}, BREADTH_STATE,
    {"state": BREADTH_STATE}, [], {"state": []}, {"state": {"aws": 3}},
    "text"])
def test_load_account_state_equals_the_reference(doc, tmp_path):
    path = tmp_path / "state.json"
    path.write_text(json.dumps(doc))
    got = []
    for mod in (rcloud, tcloud):
        try:
            got.append(("ok", mod.load_account_state(str(path))))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[0] == got[1]


def _run(main, argv: list) -> tuple:
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        code = main(argv)
    errors = [ln for ln in err.getvalue().splitlines()
              if ln.startswith("error:")]
    return code, buf.getvalue(), errors


CLI_CASES = [
    ("account", ["--format", "json"]),
    ("account", []),
    ("account", ["--service", "s3", "--format", "json"]),
    ("breadth", ["--service", " EKS ,rds", "--exit-code", "6"]),
    ("seed1", ["--format", "json", "--include-non-failures"]),
    ("seed2", ["--severity", "CRITICAL,HIGH"]),
    ("seed3", ["--format", "sarif"]),
    ("seed4", ["--service", "s3,lambda"]),
    ("bad", []),
    ("missing", []),
    ("seed5", ["--fault-spec", "cache-outage"]),
]


@pytest.mark.parametrize("name,flags", CLI_CASES)
def test_aws_cli_equals_the_reference(name, flags, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "state.json"
    if name == "bad":
        path.write_text("[]")
    elif name != "missing":
        path.write_text(json.dumps(STATES[name] if name != "account"
                                   else ACCOUNT_STATE))
    argv = ["aws", "--account-state", str(path)] + flags
    got = {"ref": _run(rmain, argv + ["--cache-dir",
                                      str(tmp_path / "c")]),
           "port": _run(tmain, argv)}
    for pkg, (code, out, errors) in got.items():
        if "json" in flags and out:
            got[pkg] = (code, json.dumps(json.loads(out), sort_keys=True),
                        errors)
        elif "sarif" in flags:
            got[pkg] = (code, json.dumps(json.loads(out)["runs"][0][
                "results"], sort_keys=True), errors)
    assert got["port"] == got["ref"]
    code, out, errors = got["port"]
    if name in ("bad", "missing"):
        assert code == 1 and errors[0].startswith("error: account state")
    elif name == "seed4":
        assert code == 2 and "lambda" in errors[0]
    elif name == "seed5":
        assert code == 2
    else:
        assert out and not errors
