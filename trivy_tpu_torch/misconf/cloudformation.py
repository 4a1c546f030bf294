"""CloudFormation misconfiguration checks.

The reference routes CloudFormation templates through defsec's
cfscanner (pkg/fanal/handler/misconf/misconf.go:25).
This walker evaluates the same core AWS checks (shared AVD IDs with
the Terraform set) directly over the template's ``Resources`` map.

YAML templates use intrinsic tags (!Ref, !GetAtt, !Sub...); a
tolerant loader maps them to ``Intrinsic`` markers so parsing never
fails and checks treat them as unresolvable (never a provable FAIL).
"""

from __future__ import annotations

import json
from typing import Optional

from .policies import Cause, Policy

try:
    import yaml as yaml_mod
except ImportError:          # pragma: no cover
    yaml_mod = None


class Intrinsic:
    """An unresolved CFN intrinsic (!Ref / Fn::* / !Sub ...)."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: str, value):
        self.tag = tag
        self.value = value

    def __repr__(self):
        return f"Intrinsic({self.tag})"

    def __bool__(self):
        return False


def _make_loader():
    class _Loader(yaml_mod.SafeLoader):
        pass

    def intrinsic(loader, tag_suffix, node):
        if isinstance(node, yaml_mod.ScalarNode):
            v = loader.construct_scalar(node)
        elif isinstance(node, yaml_mod.SequenceNode):
            v = loader.construct_sequence(node)
        else:
            v = loader.construct_mapping(node)
        return Intrinsic(tag_suffix, v)

    _Loader.add_multi_constructor("!", intrinsic)
    return _Loader


def parse_template(content: bytes) -> Optional[dict]:
    """Parse a CFN template (JSON or YAML); None if not CFN-shaped."""
    text = content.decode("utf-8", "replace")
    doc = None
    stripped = text.lstrip()
    if stripped.startswith("{"):
        try:
            doc = json.loads(text)
        except ValueError:
            return None
    elif yaml_mod is not None:
        try:
            doc = yaml_mod.load(text, Loader=_make_loader())
        except yaml_mod.YAMLError:
            return None
    if not isinstance(doc, dict):
        return None
    if "AWSTemplateFormatVersion" not in doc and \
            "Resources" not in doc:
        return None
    resources = doc.get("Resources")
    if not isinstance(resources, dict) or not all(
            isinstance(r, dict) and "Type" in r
            for r in resources.values()):
        return None
    return doc


def is_cloudformation(content: bytes) -> bool:
    return parse_template(content) is not None


def _rs(doc: dict, rtype: str) -> list:
    """[(logical name, properties dict)] for one resource type."""
    out = []
    for name, r in (doc.get("Resources") or {}).items():
        if isinstance(r, dict) and r.get("Type") == rtype:
            props = r.get("Properties")
            out.append((name, props if isinstance(props, dict)
                        else {}))
    return out


def _cause(name: str, msg: str) -> Cause:
    return Cause(message=msg, resource=name)


# ------------------------------------------------------------------- S3

def _check_s3_public_access_block(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::S3::Bucket"):
        v = props.get("PublicAccessBlockConfiguration")
        if isinstance(v, (dict, Intrinsic)):
            continue      # present, or unresolvable (!If whole-prop)
        out.append(_cause(
            name, "Bucket does not have a corresponding public "
                  "access block."))
    return out


def _pab_flag_check(flag: str, message: str):
    def check(doc) -> list:
        out = []
        for name, props in _rs(doc, "AWS::S3::Bucket"):
            pab = props.get("PublicAccessBlockConfiguration")
            if not isinstance(pab, dict):
                continue
            v = pab.get(flag)
            if v is True or isinstance(v, Intrinsic):
                continue
            out.append(_cause(name, message))
        return out
    return check


def _check_s3_encryption(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::S3::Bucket"):
        v = props.get("BucketEncryption")
        if v or isinstance(v, Intrinsic):
            continue
        out.append(_cause(
            name, "Bucket does not have encryption enabled"))
    return out


def _check_s3_versioning(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::S3::Bucket"):
        vc = props.get("VersioningConfiguration")
        if isinstance(vc, Intrinsic):
            continue      # whole-property !If: unresolvable
        status = vc.get("Status") if isinstance(vc, dict) else None
        if status != "Enabled" and not isinstance(status, Intrinsic):
            out.append(_cause(
                name, "Bucket does not have versioning enabled"))
    return out


def _check_s3_public_acl(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::S3::Bucket"):
        acl = props.get("AccessControl")
        if isinstance(acl, str) and acl in (
                "PublicRead", "PublicReadWrite", "AuthenticatedRead"):
            out.append(_cause(
                name, f"Bucket has a public ACL: {acl!r}."))
    return out


# -------------------------------------------------------- security group

_PUBLIC_CIDRS = ("0.0.0.0/0", "::/0")


def _sg_rule_causes(name, rules, kind) -> list:
    out = []
    if not isinstance(rules, list):
        return out
    for rule in rules:
        if not isinstance(rule, dict):
            continue
        for key in ("CidrIp", "CidrIpv6"):
            v = rule.get(key)
            if v in _PUBLIC_CIDRS:
                out.append(_cause(
                    name, f"Security group rule allows {kind} from "
                          f"public internet: {v!r}"))
    return out


def _check_sg_public_ingress(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::EC2::SecurityGroup"):
        out.extend(_sg_rule_causes(
            name, props.get("SecurityGroupIngress"), "ingress"))
    for name, props in _rs(doc, "AWS::EC2::SecurityGroupIngress"):
        out.extend(_sg_rule_causes(name, [props], "ingress"))
    return out


def _check_sg_public_egress(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::EC2::SecurityGroup"):
        out.extend(_sg_rule_causes(
            name, props.get("SecurityGroupEgress"), "egress"))
    return out


def _check_sg_description(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::EC2::SecurityGroup"):
        v = props.get("GroupDescription")
        if v or isinstance(v, Intrinsic):
            continue
        out.append(_cause(
            name, "Security group does not have a description."))
    return out


# ------------------------------------------------------------------ IAM

def _check_iam_wildcards(doc) -> list:
    out = []
    for rtype in ("AWS::IAM::Policy", "AWS::IAM::ManagedPolicy",
                  "AWS::IAM::Role", "AWS::IAM::User",
                  "AWS::IAM::Group"):
        for name, props in _rs(doc, rtype):
            docs = []
            if isinstance(props.get("PolicyDocument"), dict):
                docs.append(props["PolicyDocument"])
            for p in props.get("Policies") or []:
                if isinstance(p, dict) and \
                        isinstance(p.get("PolicyDocument"), dict):
                    docs.append(p["PolicyDocument"])
            for d in docs:
                stmts = d.get("Statement") or []
                if isinstance(stmts, dict):
                    stmts = [stmts]
                for s in stmts:
                    if not isinstance(s, dict) or \
                            s.get("Effect", "Allow") != "Allow":
                        continue
                    for key in ("Action", "Resource"):
                        vals = s.get(key)
                        vals = [vals] if isinstance(vals, str) \
                            else (vals or [])
                        if "*" in [v for v in vals
                                   if isinstance(v, str)]:
                            out.append(_cause(
                                name, f"IAM policy document uses "
                                      f"wildcard {key.lower()} '*'"))
    return out


# ------------------------------------------------------------- EBS/RDS

def _check_ebs_encryption(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::EC2::Volume"):
        v = props.get("Encrypted")
        if v is True or isinstance(v, Intrinsic):
            continue
        out.append(_cause(
            name, "EBS volume does not have encryption enabled"))
    return out


def _check_rds_encryption(doc) -> list:
    out = []
    for name, props in _rs(doc, "AWS::RDS::DBInstance"):
        v = props.get("StorageEncrypted")
        if v is True or isinstance(v, Intrinsic):
            continue
        out.append(_cause(
            name, "Instance does not have storage encryption "
                  "enabled"))
    return out


def _p(pid, title, sev, service, check) -> Policy:
    return Policy(
        id=pid, avd_id=pid, title=title, description=title,
        severity=sev, recommended_actions="", references=[],
        provider="AWS", service=service, check=check)


CLOUDFORMATION_POLICIES = [
    _p("AVD-AWS-0094",
       "S3 buckets should each define an "
       "aws_s3_bucket_public_access_block",
       "LOW", "s3", _check_s3_public_access_block),
    _p("AVD-AWS-0086", "S3 Access block should block public ACL",
       "HIGH", "s3", _pab_flag_check(
           "BlockPublicAcls",
           "Public access block does not block public ACLs")),
    _p("AVD-AWS-0087", "S3 Access block should block public policy",
       "HIGH", "s3", _pab_flag_check(
           "BlockPublicPolicy",
           "Public access block does not block public policies")),
    _p("AVD-AWS-0091", "S3 Access Block should Ignore Public Acl",
       "HIGH", "s3", _pab_flag_check(
           "IgnorePublicAcls",
           "Public access block does not ignore public ACLs")),
    _p("AVD-AWS-0092",
       "S3 buckets should not be publicly accessible via ACL",
       "HIGH", "s3", _check_s3_public_acl),
    _p("AVD-AWS-0088", "Unencrypted S3 bucket",
       "HIGH", "s3", _check_s3_encryption),
    _p("AVD-AWS-0090", "S3 Data should be versioned",
       "MEDIUM", "s3", _check_s3_versioning),
    _p("AVD-AWS-0107",
       "An ingress security group rule allows traffic from /0",
       "CRITICAL", "ec2", _check_sg_public_ingress),
    _p("AVD-AWS-0104",
       "An egress security group rule allows traffic to /0",
       "CRITICAL", "ec2", _check_sg_public_egress),
    _p("AVD-AWS-0099", "Missing description for security group",
       "LOW", "ec2", _check_sg_description),
    _p("AVD-AWS-0057", "IAM policy should avoid use of wildcards",
       "HIGH", "iam", _check_iam_wildcards),
    _p("AVD-AWS-0026", "EBS volumes must be encrypted",
       "HIGH", "ebs", _check_ebs_encryption),
    _p("AVD-AWS-0080",
       "RDS encryption has not been enabled at a DB Instance level",
       "HIGH", "rds", _check_rds_encryption),
]
