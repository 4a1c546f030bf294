"""Cloud/AWS scanning (copied from ``trivy_tpu/cloud/__init__.py``;
reference: pkg/cloud — `trivy aws` walks an AWS account through
defsec's cloud adapters with an account-state cache).

The live AWS API walk is a seam (zero egress here): ``python -m
trivy_tpu_torch aws --account-state state.json`` evaluates the
built-in checks against an exported account state — the same JSON shape the
reference persists in its account-state cache (pkg/cloud/aws/cache
CacheData.state: ``{"aws": {service: resources...}}``) — and a live
enumerator would feed the identical evaluator. Results render per
service like every other config class.

Checks cover defsec's CIS-ish core (ref
pkg/cloud/aws/scanner/scanner.go:28 enumerates the supported
services): s3 public access/encryption, ec2 security groups + EBS
volume encryption, iam root keys/MFA/password policy/key rotation,
cloudtrail logging/validation/CMK, rds encryption/public
access/backups, efs at-rest encryption, ecr scan-on-push/immutable
tags, eks endpoint/secrets/control-plane logs, elb HTTPS/invalid
headers, kms rotation. Each check's docstring names the defsec slug
it mirrors; absence of a service key in the export means
"not audited" and is skipped, never reported as PASS.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Callable

from ..misconf.policies import Cause, Policy

log = logging.getLogger("trivy_tpu_torch.cloud")


def _s3_public_access(state: dict) -> list:
    causes = []
    for b in (state.get("s3") or {}).get("buckets") or []:
        pab = b.get("publicAccessBlock") or {}
        if not all(pab.get(k) for k in
                   ("blockPublicAcls", "blockPublicPolicy",
                    "ignorePublicAcls", "restrictPublicBuckets")):
            causes.append(Cause(
                message=f"Bucket {b.get('name', '?')!r} does not "
                "block public access",
                resource=b.get("name", "")))
    return causes


def _s3_encryption(state: dict) -> list:
    causes = []
    for b in (state.get("s3") or {}).get("buckets") or []:
        if not (b.get("encryption") or {}).get("enabled"):
            causes.append(Cause(
                message=f"Bucket {b.get('name', '?')!r} does not "
                "have encryption enabled",
                resource=b.get("name", "")))
    return causes


def _ec2_open_ssh(state: dict) -> list:
    causes = []
    for sg in (state.get("ec2") or {}).get("securityGroups") or []:
        for rule in sg.get("ingressRules") or []:
            cidrs = rule.get("cidrs") or []
            from_port = rule.get("fromPort", 0)
            to_port = rule.get("toPort", from_port)
            if any(c in ("0.0.0.0/0", "::/0") for c in cidrs) and \
                    from_port <= 22 <= to_port:
                causes.append(Cause(
                    message=f"Security group "
                    f"{sg.get('name', '?')!r} allows SSH from the "
                    "public internet",
                    resource=sg.get("name", "")))
    return causes


def _ec2_open_ingress(state: dict) -> list:
    causes = []
    for sg in (state.get("ec2") or {}).get("securityGroups") or []:
        for rule in sg.get("ingressRules") or []:
            if any(c in ("0.0.0.0/0", "::/0")
                   for c in rule.get("cidrs") or []):
                causes.append(Cause(
                    message=f"Security group "
                    f"{sg.get('name', '?')!r} has an ingress rule "
                    "open to the world",
                    resource=sg.get("name", "")))
                break
    return causes


def _iam_root_access_keys(state: dict) -> list:
    root = (state.get("iam") or {}).get("rootUser") or {}
    if root.get("accessKeys"):
        return [Cause(message="The root account has active access "
                      "keys", resource="root")]
    return []


def _iam_mfa(state: dict) -> list:
    causes = []
    for u in (state.get("iam") or {}).get("users") or []:
        if u.get("consoleAccess") and not u.get("mfaActive"):
            causes.append(Cause(
                message=f"User {u.get('name', '?')!r} has console "
                "access without MFA",
                resource=u.get("name", "")))
    return causes


def _cloudtrail_enabled(state: dict) -> list:
    trails = (state.get("cloudtrail") or {}).get("trails")
    if trails is None:
        return []           # service not exported
    if not any(t.get("isLogging") for t in trails):
        return [Cause(message="No CloudTrail trail is logging")]
    return []


def _flag(state, service, collection, name_key, bad, message):
    """Table-driven body shared by the boolean resource checks:
    flag every resource under state[service][collection] for which
    bad(resource) is true. `message` is formatted with {name}."""
    causes = []
    for res in (state.get(service) or {}).get(collection) or []:
        if bad(res):
            causes.append(Cause(
                message=message.format(
                    name=repr(res.get(name_key, "?"))),
                resource=res.get(name_key, "")))
    return causes


def _cloudtrail_log_validation(state: dict) -> list:
    """defsec aws-cloudtrail-enable-log-validation."""
    return _flag(state, "cloudtrail", "trails", "name",
                 lambda t: not t.get("enableLogFileValidation"),
                 "Trail {name} does not validate log files")


def _cloudtrail_cmk(state: dict) -> list:
    """defsec aws-cloudtrail-encryption-customer-managed-key."""
    return _flag(state, "cloudtrail", "trails", "name",
                 lambda t: not t.get("kmsKeyId"),
                 "Trail {name} is not encrypted with a "
                 "customer-managed key")


def _ebs_volume_encryption(state: dict) -> list:
    """defsec aws-ebs-enable-volume-encryption (same check the TF
    analyzer runs as AVD-AWS-0026 over aws_ebs_volume blocks)."""
    return _flag(state, "ec2", "volumes", "id",
                 lambda v: not (v.get("encryption")
                                or {}).get("enabled"),
                 "EBS volume {name} is not encrypted")


def _rds_encryption(state: dict) -> list:
    """defsec aws-rds-encrypt-instance-storage-data."""
    return _flag(state, "rds", "instances", "id",
                 lambda db: not (db.get("encryption")
                                 or {}).get("enabled"),
                 "RDS instance {name} has unencrypted storage")


def _rds_public_access(state: dict) -> list:
    """defsec aws-rds-no-public-db-access."""
    return _flag(state, "rds", "instances", "id",
                 lambda db: db.get("publiclyAccessible"),
                 "RDS instance {name} is publicly accessible")


def _rds_backup_retention(state: dict) -> list:
    """defsec aws-rds-specify-backup-retention."""
    return _flag(state, "rds", "instances", "id",
                 lambda db: not db.get("backupRetentionPeriodDays"),
                 "RDS instance {name} has no backup retention "
                 "period")


def _efs_encryption(state: dict) -> list:
    """defsec aws-efs-enable-at-rest-encryption."""
    return _flag(state, "efs", "fileSystems", "id",
                 lambda fs: not fs.get("encrypted"),
                 "EFS file system {name} is not encrypted at rest")


def _ecr_scan_on_push(state: dict) -> list:
    """defsec aws-ecr-enable-image-scans."""
    return _flag(state, "ecr", "repositories", "name",
                 lambda r: not (r.get("imageScanning")
                                or {}).get("scanOnPush"),
                 "ECR repository {name} does not scan images on "
                 "push")


def _ecr_immutable_tags(state: dict) -> list:
    """defsec aws-ecr-enforce-immutable-repository."""
    return _flag(state, "ecr", "repositories", "name",
                 lambda r: not r.get("imageTagsImmutable"),
                 "ECR repository {name} allows mutable image tags")


def _eks_public_endpoint(state: dict) -> list:
    """defsec aws-eks-no-public-cluster-access: any enabled public
    endpoint fails (CIDR scoping is the separate
    aws-eks-no-public-cluster-access-to-cidr, AWS-0041)."""
    return _flag(state, "eks", "clusters", "name",
                 lambda c: (c.get("publicAccess")
                            or {}).get("enabled"),
                 "EKS cluster {name} API endpoint allows public "
                 "access")


def _eks_public_cidrs(state: dict) -> list:
    """defsec aws-eks-no-public-cluster-access-to-cidr (public
    endpoint whose allowed CIDRs include the whole internet)."""
    def bad(c):
        access = c.get("publicAccess") or {}
        if not access.get("enabled"):
            return False
        cidrs = access.get("cidrs") or []
        return not cidrs or any(x in ("0.0.0.0/0", "::/0")
                                for x in cidrs)
    return _flag(state, "eks", "clusters", "name", bad,
                 "EKS cluster {name} API endpoint is open to the "
                 "public internet")


def _eks_secrets_encryption(state: dict) -> list:
    """defsec aws-eks-encrypt-secrets."""
    return _flag(state, "eks", "clusters", "name",
                 lambda c: not ((c.get("encryption") or {}).get(
                     "secrets") and (c.get("encryption")
                                     or {}).get("kmsKeyId")),
                 "EKS cluster {name} does not encrypt secrets "
                 "with a KMS key")


def _eks_control_plane_logging(state: dict) -> list:
    """defsec aws-eks-enable-control-plane-logging (all five log
    types: api, audit, authenticator, controllerManager,
    scheduler)."""
    wanted = ("api", "audit", "authenticator", "controllerManager",
              "scheduler")
    causes = []
    for c in (state.get("eks") or {}).get("clusters") or []:
        logging = c.get("logging") or {}
        missing = [k for k in wanted if not logging.get(k)]
        if missing:
            causes.append(Cause(
                message=f"EKS cluster {c.get('name', '?')!r} is "
                f"missing control-plane logs: {', '.join(missing)}",
                resource=c.get("name", "")))
    return causes


def _elb_https_listeners(state: dict) -> list:
    """defsec aws-elb-http-not-used (every ALB listener must be
    HTTPS, or an HTTP listener whose default action redirects)."""
    causes = []
    for lb in (state.get("elb") or {}).get("loadBalancers") or []:
        if lb.get("type") not in (None, "application"):
            continue
        for li in lb.get("listeners") or []:
            if li.get("protocol") == "HTTP" and \
                    li.get("defaultActionType") != "redirect":
                causes.append(Cause(
                    message=f"Load balancer {lb.get('name', '?')!r} "
                    "has a plain-HTTP listener",
                    resource=lb.get("name", "")))
    return causes


def _elb_drop_invalid_headers(state: dict) -> list:
    """defsec aws-elb-drop-invalid-headers."""
    return _flag(state, "elb", "loadBalancers", "name",
                 lambda lb: lb.get("type") in (None, "application")
                 and not lb.get("dropInvalidHeaderFields"),
                 "Load balancer {name} does not drop invalid "
                 "header fields")


def _iam_password_policy(state: dict) -> list:
    """defsec aws-iam-set-minimum-password-length (and the
    companion reuse-prevention / max-age checks the reference
    groups as the password-policy family)."""
    # a missing passwordPolicy export is AWS's NoSuchEntity — no
    # policy configured at all, the insecure default defsec FAILs
    pol = (state.get("iam") or {}).get("passwordPolicy") or {}
    causes = []
    if (pol.get("minimumLength") or 0) < 14:
        causes.append(Cause(
            message="IAM password policy minimum length is below "
            "14 characters", resource="passwordPolicy"))
    if (pol.get("reusePreventionCount") or 0) < 5:
        causes.append(Cause(
            message="IAM password policy allows reuse of recent "
            "passwords", resource="passwordPolicy"))
    if not pol.get("maxAgeDays"):
        causes.append(Cause(
            message="IAM password policy does not expire passwords",
            resource="passwordPolicy"))
    return causes


def _iam_key_rotation(state: dict) -> list:
    """defsec aws-iam-rotate-access-keys (keys older than 90
    days)."""
    from datetime import datetime, timezone
    causes = []
    now = datetime.now(timezone.utc)
    for u in (state.get("iam") or {}).get("users") or []:
        for key in u.get("accessKeys") or []:
            created = key.get("creationDate")
            if not (key.get("active") and created):
                continue
            if isinstance(created, (int, float)):   # epoch seconds
                dt = datetime.fromtimestamp(created, timezone.utc)
            else:
                try:
                    dt = datetime.fromisoformat(
                        str(created).replace("Z", "+00:00"))
                except ValueError:
                    log.warning(
                        "iam: unparseable creationDate %r for "
                        "user %r access key — cannot audit "
                        "rotation", created, u.get("name", "?"))
                    continue
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=timezone.utc)
            age = (now - dt).days
            if age > 90:
                causes.append(Cause(
                    message=f"User {u.get('name', '?')!r} has an "
                    f"access key {age} days old (rotate every 90)",
                    resource=u.get("name", "")))
    return causes


def _kms_key_rotation(state: dict) -> list:
    """defsec aws-kms-auto-rotate-keys (rotation only applies to
    ENCRYPT_DECRYPT CMKs)."""
    return _flag(state, "kms", "keys", "id",
                 lambda k: k.get("usage") in (None,
                                              "ENCRYPT_DECRYPT")
                 and not k.get("rotationEnabled"),
                 "KMS key {name} does not have automatic rotation "
                 "enabled")


def _policy(id_, service, title, severity, check,
            resolution) -> Policy:
    return Policy(
        id=id_, avd_id=f"AVD-{id_}",
        title=title, description=title, severity=severity,
        recommended_actions=resolution,
        references=[f"https://avd.aquasec.com/misconfig/"
                    f"{id_.lower().replace('-', '')}"],
        provider="AWS", service=service, check=check)


AWS_POLICIES = [
    _policy("AWS-0086", "s3", "S3 bucket does not block public "
            "access", "HIGH", _s3_public_access,
            "Enable the bucket's public access block"),
    _policy("AWS-0088", "s3", "S3 bucket is unencrypted", "HIGH",
            _s3_encryption, "Enable bucket encryption"),
    _policy("AWS-0107", "ec2", "Security group allows public "
            "ingress to SSH", "CRITICAL", _ec2_open_ssh,
            "Restrict port 22 to trusted networks"),
    _policy("AWS-0105", "ec2", "Security group rule open to "
            "0.0.0.0/0", "MEDIUM", _ec2_open_ingress,
            "Scope ingress rules to known CIDRs"),
    _policy("AWS-0141", "iam", "Root account has access keys",
            "CRITICAL", _iam_root_access_keys,
            "Delete the root user's access keys"),
    _policy("AWS-0123", "iam", "Console user without MFA", "HIGH",
            _iam_mfa, "Require MFA for console users"),
    _policy("AWS-0014", "cloudtrail", "CloudTrail logging disabled",
            "MEDIUM", _cloudtrail_enabled,
            "Enable at least one logging trail"),
    _policy("AWS-0016", "cloudtrail", "CloudTrail log file "
            "validation disabled", "HIGH",
            _cloudtrail_log_validation,
            "Turn on log file validation for every trail"),
    _policy("AWS-0015", "cloudtrail", "CloudTrail not encrypted "
            "with a customer-managed key", "HIGH", _cloudtrail_cmk,
            "Set a KMS key id on the trail"),
    _policy("AWS-0026", "ec2", "EBS volume is unencrypted", "HIGH",
            _ebs_volume_encryption,
            "Enable encryption on the volume"),
    _policy("AWS-0080", "rds", "RDS instance storage is "
            "unencrypted", "HIGH", _rds_encryption,
            "Enable storage encryption on the instance"),
    _policy("AWS-0082", "rds", "RDS instance is publicly "
            "accessible", "CRITICAL", _rds_public_access,
            "Disable public accessibility on the instance"),
    _policy("AWS-0077", "rds", "RDS instance has no backup "
            "retention", "MEDIUM", _rds_backup_retention,
            "Set a backup retention period of at least one day"),
    _policy("AWS-0037", "efs", "EFS file system is not encrypted "
            "at rest", "HIGH", _efs_encryption,
            "Create the file system with encryption enabled"),
    _policy("AWS-0030", "ecr", "ECR repository does not scan on "
            "push", "HIGH", _ecr_scan_on_push,
            "Enable image scanning on push"),
    _policy("AWS-0031", "ecr", "ECR repository allows mutable "
            "tags", "HIGH", _ecr_immutable_tags,
            "Set the repository's tags to immutable"),
    _policy("AWS-0040", "eks", "EKS cluster endpoint allows "
            "public access", "CRITICAL", _eks_public_endpoint,
            "Disable public endpoint access"),
    _policy("AWS-0041", "eks", "EKS cluster endpoint open to the "
            "internet", "CRITICAL", _eks_public_cidrs,
            "Restrict the public endpoint to trusted CIDRs"),
    _policy("AWS-0039", "eks", "EKS secrets are not KMS-encrypted",
            "HIGH", _eks_secrets_encryption,
            "Enable secrets encryption with a KMS key"),
    _policy("AWS-0038", "eks", "EKS control-plane logging "
            "incomplete", "MEDIUM", _eks_control_plane_logging,
            "Enable all five control-plane log types"),
    _policy("AWS-0054", "elb", "Load balancer uses plain HTTP",
            "CRITICAL", _elb_https_listeners,
            "Switch the listener to HTTPS or redirect to it"),
    _policy("AWS-0052", "elb", "Load balancer keeps invalid HTTP "
            "headers", "HIGH", _elb_drop_invalid_headers,
            "Enable drop-invalid-header-fields"),
    _policy("AWS-0063", "iam", "IAM password policy is weak",
            "MEDIUM", _iam_password_policy,
            "Require 14+ characters, reuse prevention and expiry"),
    _policy("AWS-0146", "iam", "IAM access key needs rotation",
            "LOW", _iam_key_rotation,
            "Rotate access keys at least every 90 days"),
    _policy("AWS-0065", "kms", "KMS key rotation disabled",
            "MEDIUM", _kms_key_rotation,
            "Enable automatic key rotation"),
]


def load_account_state(path: str) -> dict:
    """Exported account state: {"aws": {service: ...}} (the
    reference's CacheData.state shape) or the bare service map."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError("account state must be a JSON object")
    state = doc.get("state", doc)
    if not isinstance(state, dict):
        raise ValueError("'state' must be a JSON object")
    aws = state.get("aws", state)
    if not isinstance(aws, dict):
        raise ValueError("'state.aws' must be a JSON object")
    return aws


KNOWN_SERVICES = sorted({p.service for p in AWS_POLICIES})


def scan_account(state: dict, services=None) -> list:
    """→ [Result] per service (ref aws/scanner + report: ARN-scoped
    resources grouped by service)."""
    from ..scan.local import _to_detected_misconf
    from ..types import Result
    from ..types.common import Layer
    from ..types.report import (CauseMetadata, MisconfResult,
                                ResultClass)

    by_service: dict = {}
    for policy in AWS_POLICIES:
        if services and policy.service not in services:
            continue
        if policy.service not in state:
            # never report PASS for a service that was not exported —
            # absence of data is not an audit
            continue
        causes = policy.check(state)
        results = by_service.setdefault(policy.service, [])
        if causes:
            for cause in causes:
                results.append(_to_detected_misconf(
                    MisconfResult(
                        namespace=f"builtin.aws.{policy.service}",
                        query="data.builtin.aws",
                        message=cause.message,
                        id=policy.id, avd_id=policy.avd_id,
                        type="AWS Security Check",
                        title=policy.title,
                        description=policy.description,
                        severity=policy.severity,
                        recommended_actions=
                        policy.recommended_actions,
                        references=list(policy.references),
                        cause_metadata=CauseMetadata(
                            provider="AWS",
                            service=policy.service,
                            resource=cause.resource)),
                    "CRITICAL", "FAIL", Layer()))
        else:
            results.append(_to_detected_misconf(
                MisconfResult(
                    namespace=f"builtin.aws.{policy.service}",
                    query="data.builtin.aws",
                    message="No issues found",
                    id=policy.id, avd_id=policy.avd_id,
                    type="AWS Security Check",
                    title=policy.title,
                    severity=policy.severity,
                    cause_metadata=CauseMetadata(
                        provider="AWS", service=policy.service)),
                "UNKNOWN", "PASS", Layer()))

    out = []
    for service in sorted(by_service):
        out.append(Result(
            target=f"aws/{service}",
            class_=ResultClass.CONFIG,
            type=f"aws-{service}",
            misconfigurations=by_service[service]))
    return out
