"""Terraform misconfiguration checks.

Re-implementations of defsec's best-known AWS Terraform checks (the
reference embeds them through defsec's terraform scanner,
pkg/fanal/handler/misconf/misconf.go:19-29; IDs /
severities follow the public AVD registry the reference reports).
Checks only fail on PROVABLE misconfigurations: Unresolved values
(variables without defaults, function calls) never fail — defsec's
checks behave the same on unresolvable values.

Input: the module's top-level blocks from hcl.parse_module. Causes
carry the resource address (``aws_s3_bucket.logs``) and source lines.
"""

from __future__ import annotations

from .hcl import Block, Unresolved
from .policies import Cause, Policy


def _resources(blocks: list, rtype: str) -> list:
    return [b for b in blocks
            if b.type == "resource" and b.labels
            and b.labels[0] == rtype]


def _addr(b: Block) -> str:
    return ".".join(b.labels[:2]) if len(b.labels) >= 2 else \
        (b.labels[0] if b.labels else "resource")


def _ref_target(v) -> str:
    """'aws_s3_bucket.b.id' → 'aws_s3_bucket.b' (link resolution for
    cross-resource references that the subset keeps as Unresolved)."""
    if isinstance(v, Unresolved):
        parts = v.why.split(".")
        if len(parts) >= 2:
            return ".".join(parts[:2])
    return ""


def _cause(b: Block, msg: str, line: int = 0) -> Cause:
    return Cause(message=msg, resource=_addr(b),
                 start_line=line or b.start_line,
                 end_line=line or b.end_line,
                 file_path=getattr(b, "src_path", ""))


# ------------------------------------------------------------------- S3

def _s3_buckets(blocks):
    return _resources(blocks, "aws_s3_bucket")


def _aux_index(blocks, rtype: str) -> dict:
    """One-pass lookup of aux resources (versioning / encryption /
    logging / public-access-block) keyed by BOTH the reference target
    (aws_s3_bucket.b) and the literal bucket-name string, so configs
    that link by `bucket = "my-bucket"` count the same as references."""
    idx = {}
    for r in _resources(blocks, rtype):
        v = r.attrs.get("bucket")
        if v is None:
            continue
        t = _ref_target(v.value)
        if t:
            idx.setdefault(t, r)
        if isinstance(v.value, str):
            idx.setdefault(v.value, r)
    return idx


def _aux_lookup(idx: dict, bucket: Block):
    r = idx.get(_addr(bucket))
    if r is not None:
        return r
    name = bucket.attr("bucket")
    return idx.get(name) if isinstance(name, str) else None


def _check_s3_public_access_block(blocks) -> list:
    """AVD-AWS-0094 aws-s3-specify-public-access-block."""
    out = []
    pabs = _aux_index(blocks, "aws_s3_bucket_public_access_block")
    for b in _s3_buckets(blocks):
        if _aux_lookup(pabs, b) is None:
            out.append(_cause(
                b, "Bucket does not have a corresponding public "
                   "access block."))
    return out


def _pab_flag_check(flag: str, message: str):
    def check(blocks) -> list:
        out = []
        pabs = _aux_index(
            blocks, "aws_s3_bucket_public_access_block")
        for b in _s3_buckets(blocks):
            pab = _aux_lookup(pabs, b)
            if pab is None:
                continue          # AVD-AWS-0094 reports the absence
            v = pab.attr(flag)
            if v is True or isinstance(v, Unresolved):
                continue
            out.append(_cause(pab, message, pab.attr_line(flag)
                              if flag in pab.attrs else 0))
        return out
    return check


def _check_s3_encryption(blocks) -> list:
    """AVD-AWS-0088 aws-s3-enable-bucket-encryption."""
    out = []
    enc = _aux_index(
        blocks, "aws_s3_bucket_server_side_encryption_configuration")
    for b in _s3_buckets(blocks):
        if b.first_block("server_side_encryption_configuration"):
            continue
        if _aux_lookup(enc, b):
            continue
        out.append(_cause(
            b, "Bucket does not have encryption enabled"))
    return out


def _check_s3_versioning(blocks) -> list:
    """AVD-AWS-0090 aws-s3-enable-versioning."""
    out = []
    ver_idx = _aux_index(blocks, "aws_s3_bucket_versioning")
    for b in _s3_buckets(blocks):
        ver = b.first_block("versioning")
        if ver is not None:
            v = ver.attr("enabled", True)
            if v is False:
                out.append(_cause(
                    b, "Bucket does not have versioning enabled",
                    ver.start_line))
            continue
        r = _aux_lookup(ver_idx, b)
        if r is not None:
            cfg = r.first_block("versioning_configuration")
            if cfg is not None and cfg.attr("status") not in (
                    "Enabled", None) and not isinstance(
                    cfg.attr("status"), Unresolved):
                out.append(_cause(
                    r, "Bucket does not have versioning enabled",
                    cfg.start_line))
            continue
        out.append(_cause(
            b, "Bucket does not have versioning enabled"))
    return out


def _check_s3_public_acl(blocks) -> list:
    """AVD-AWS-0092 aws-s3-no-public-access-with-acl (public-read /
    public-read-write / website ACLs on the bucket itself)."""
    out = []
    for b in _s3_buckets(blocks):
        acl = b.attr("acl")
        if isinstance(acl, str) and acl.startswith("public-"):
            out.append(_cause(
                b, f"Bucket has a public ACL: {acl!r}.",
                b.attr_line("acl")))
    return out


def _check_s3_logging(blocks) -> list:
    """AVD-AWS-0089 aws-s3-enable-bucket-logging."""
    out = []
    logging_idx = _aux_index(blocks, "aws_s3_bucket_logging")
    for b in _s3_buckets(blocks):
        if b.first_block("logging") or _aux_lookup(logging_idx, b):
            continue
        if isinstance(b.attr("acl"), str) and \
                b.attr("acl") == "log-delivery-write":
            continue            # the log bucket itself
        out.append(_cause(b, "Bucket does not have logging enabled"))
    return out


# -------------------------------------------------------- security group

_PUBLIC_CIDRS = ("0.0.0.0/0", "::/0")


def _cidr_causes(b: Block, rule: Block, kind: str) -> list:
    out = []
    for attr_name in ("cidr_blocks", "ipv6_cidr_blocks"):
        v = rule.attr(attr_name)
        if isinstance(v, list):
            for cidr in v:
                if cidr in _PUBLIC_CIDRS:
                    out.append(_cause(
                        b, f"Security group rule allows {kind} from "
                           f"public internet: {cidr!r}",
                        rule.attr_line(attr_name)))
    return out


def _check_sg_public_ingress(blocks) -> list:
    """AVD-AWS-0107 aws-ec2-no-public-ingress-sgr."""
    out = []
    for b in _resources(blocks, "aws_security_group"):
        for rule in b.find_blocks("ingress"):
            out.extend(_cidr_causes(b, rule, "ingress"))
    for b in _resources(blocks, "aws_security_group_rule"):
        if b.attr("type") == "ingress":
            out.extend(_cidr_causes(b, b, "ingress"))
    return out


def _check_sg_public_egress(blocks) -> list:
    """AVD-AWS-0104 aws-ec2-no-public-egress-sgr."""
    out = []
    for b in _resources(blocks, "aws_security_group"):
        for rule in b.find_blocks("egress"):
            out.extend(_cidr_causes(b, rule, "egress"))
    for b in _resources(blocks, "aws_security_group_rule"):
        if b.attr("type") == "egress":
            out.extend(_cidr_causes(b, b, "egress"))
    return out


def _check_sg_description(blocks) -> list:
    """AVD-AWS-0099 aws-ec2-add-description-to-security-group."""
    out = []
    for b in _resources(blocks, "aws_security_group"):
        d = b.attr("description")
        if d is None or d == "":
            out.append(_cause(
                b, "Security group does not have a description."))
    return out


# ------------------------------------------------------------------ IAM

def _policy_docs(b: Block):
    """Inline policy JSON documents in a policy attr (jsonencode is a
    call → Unresolved, but heredoc/literal JSON is resolvable)."""
    import json
    v = b.attr("policy")
    if isinstance(v, str):
        try:
            return [json.loads(v)]
        except ValueError:
            return []
    return []


def _check_iam_wildcards(blocks) -> list:
    """AVD-AWS-0057 aws-iam-no-policy-wildcards."""
    out = []
    for rtype in ("aws_iam_policy", "aws_iam_role_policy",
                  "aws_iam_user_policy", "aws_iam_group_policy"):
        for b in _resources(blocks, rtype):
            for doc in _policy_docs(b):
                stmts = doc.get("Statement") or []
                if isinstance(stmts, dict):
                    stmts = [stmts]
                for s in stmts:
                    if s.get("Effect", "Allow") != "Allow":
                        continue
                    for key in ("Action", "Resource"):
                        vals = s.get(key)
                        vals = [vals] if isinstance(vals, str) \
                            else (vals or [])
                        for v in vals:
                            if v == "*":
                                out.append(_cause(
                                    b, f"IAM policy document uses "
                                       f"wildcard {key.lower()} "
                                       f"'{v}'",
                                    b.attr_line("policy")))
    return out


# ---------------------------------------------------------- EC2/EBS/RDS

def _check_imds_tokens(blocks) -> list:
    """AVD-AWS-0028 aws-ec2-enforce-http-token-imds."""
    out = []
    for b in _resources(blocks, "aws_instance") + \
            _resources(blocks, "aws_launch_template"):
        mo = b.first_block("metadata_options")
        if mo is None:
            out.append(_cause(
                b, "Instance does not require IMDS access to require "
                   "a token"))
            continue
        v = mo.attr("http_tokens")
        if v is not None and not isinstance(v, Unresolved) \
                and v != "required":
            out.append(_cause(
                b, "Instance does not require IMDS access to require "
                   "a token", mo.attr_line("http_tokens")))
    return out


def _check_ebs_encryption(blocks) -> list:
    """AVD-AWS-0026 aws-ebs-enable-volume-encryption."""
    out = []
    for b in _resources(blocks, "aws_ebs_volume"):
        v = b.attr("encrypted")
        if v is True or isinstance(v, Unresolved):
            continue
        out.append(_cause(
            b, "EBS volume does not have encryption enabled",
            b.attr_line("encrypted") if "encrypted" in b.attrs else 0))
    for b in _resources(blocks, "aws_instance"):
        for dev in (b.find_blocks("root_block_device")
                    + b.find_blocks("ebs_block_device")):
            v = dev.attr("encrypted")
            if v is True or isinstance(v, Unresolved):
                continue
            out.append(_cause(
                b, "Block device does not have encryption enabled",
                dev.start_line))
    return out


def _check_rds_encryption(blocks) -> list:
    """AVD-AWS-0080 aws-rds-encrypt-instance-storage-data."""
    out = []
    for b in _resources(blocks, "aws_db_instance"):
        v = b.attr("storage_encrypted")
        if v is True or isinstance(v, Unresolved):
            continue
        out.append(_cause(
            b, "Instance does not have storage encryption enabled",
            b.attr_line("storage_encrypted")
            if "storage_encrypted" in b.attrs else 0))
    return out


def _p(pid, avd, title, sev, service, check, actions="",
       refs=()) -> Policy:
    return Policy(
        id=pid, avd_id=avd, title=title,
        description=title, severity=sev,
        recommended_actions=actions, references=list(refs),
        provider="AWS", service=service, check=check)


TERRAFORM_POLICIES = [
    _p("AVD-AWS-0094", "AVD-AWS-0094",
       "S3 buckets should each define an aws_s3_bucket_public_access_block",
       "LOW", "s3", _check_s3_public_access_block),
    _p("AVD-AWS-0086", "AVD-AWS-0086",
       "S3 Access block should block public ACL",
       "HIGH", "s3", _pab_flag_check(
           "block_public_acls",
           "Public access block does not block public ACLs")),
    _p("AVD-AWS-0087", "AVD-AWS-0087",
       "S3 Access block should block public policy",
       "HIGH", "s3", _pab_flag_check(
           "block_public_policy",
           "Public access block does not block public policies")),
    _p("AVD-AWS-0091", "AVD-AWS-0091",
       "S3 Access Block should Ignore Public Acl",
       "HIGH", "s3", _pab_flag_check(
           "ignore_public_acls",
           "Public access block does not ignore public ACLs")),
    _p("AVD-AWS-0092", "AVD-AWS-0092",
       "S3 buckets should not be publicly accessible via ACL",
       "HIGH", "s3", _check_s3_public_acl),
    _p("AVD-AWS-0088", "AVD-AWS-0088",
       "Unencrypted S3 bucket",
       "HIGH", "s3", _check_s3_encryption),
    _p("AVD-AWS-0090", "AVD-AWS-0090",
       "S3 Data should be versioned",
       "MEDIUM", "s3", _check_s3_versioning),
    _p("AVD-AWS-0089", "AVD-AWS-0089",
       "S3 Bucket Logging",
       "LOW", "s3", _check_s3_logging),
    _p("AVD-AWS-0107", "AVD-AWS-0107",
       "An ingress security group rule allows traffic from /0",
       "CRITICAL", "ec2", _check_sg_public_ingress),
    _p("AVD-AWS-0104", "AVD-AWS-0104",
       "An egress security group rule allows traffic to /0",
       "CRITICAL", "ec2", _check_sg_public_egress),
    _p("AVD-AWS-0099", "AVD-AWS-0099",
       "Missing description for security group",
       "LOW", "ec2", _check_sg_description),
    _p("AVD-AWS-0057", "AVD-AWS-0057",
       "IAM policy should avoid use of wildcards",
       "HIGH", "iam", _check_iam_wildcards),
    _p("AVD-AWS-0028", "AVD-AWS-0028",
       "aws_instance should activate session tokens for Instance "
       "Metadata Service (IMDSv2)",
       "HIGH", "ec2", _check_imds_tokens),
    _p("AVD-AWS-0026", "AVD-AWS-0026",
       "EBS volumes must be encrypted",
       "HIGH", "ebs", _check_ebs_encryption),
    _p("AVD-AWS-0080", "AVD-AWS-0080",
       "RDS encryption has not been enabled at a DB Instance level",
       "HIGH", "rds", _check_rds_encryption),
]
