"""Misconfiguration scanning engine
(reference: pkg/fanal/handler/misconf/misconf.go:149-338 + defsec).

Evaluates policy sets against collected ConfigFiles and produces
blob-level Misconfigurations: per file, every applicable policy lands
in ``failures`` (with cause lines) or ``successes`` —
resultsToMisconf's shape (misconf.go:338-). Host-side: policy
evaluation is irregular tree-walking, not kernel work.

File types handled (reference misconf.go:19-29 scanner fleet):
  dockerfile        — instruction checks (policies.DOCKERFILE_POLICIES)
  kubernetes        — yaml/json manifests (KUBERNETES_POLICIES)
  terraform         — .tf modules via the HCL subset (terraform.py)
  cloudformation    — templates via the resource walker
  helm              — charts rendered to k8s docs (helm.py), then the
                      Kubernetes policy set

User extension point (the reference's custom-rego analog,
misconf.go:202-238 policy paths): ``configure(policy_dirs=[...])``
loads Python modules defining ``POLICIES = [Policy(...)]``; each
policy declares ``file_types`` naming the inputs it understands.
Custom policies run with namespace ``user.<file_type>.<id>``.
WARNING: policy modules execute with full interpreter rights (like
--ignore-policy), unlike the reference's sandboxed Rego.
"""

from __future__ import annotations

import json as json_mod
import logging
import posixpath
import os

from ..types import Misconfiguration
from ..types.report import CauseMetadata, MisconfResult
from . import dockerfile as dockerfile_mod
from .policies import (DOCKERFILE_POLICIES, KUBERNETES_POLICIES,
                       Policy)

log = logging.getLogger("trivy_tpu_torch.misconf")

try:
    import yaml as yaml_mod
except ImportError:          # pragma: no cover
    yaml_mod = None


_SCANNER_NAMES = {
    "dockerfile": "Dockerfile",
    "kubernetes": "Kubernetes",
    "terraform": "Terraform",
    "cloudformation": "CloudFormation",
    "helm": "Helm",
}


class MisconfOptions:
    """Engine options (reference config.ScannerOption subset)."""

    def __init__(self, policy_dirs=None, helm_value_files=None,
                 helm_set_values=None, trace=False):
        self.policy_dirs = list(policy_dirs or [])
        self.helm_value_files = list(helm_value_files or [])
        self.helm_set_values = list(helm_set_values or [])
        self.custom_policies = _load_custom(self.policy_dirs)
        self.trace = bool(trace)


def configure(policy_dirs=None, helm_value_files=None,
              helm_set_values=None, trace=False) -> None:
    """Install engine options (called by the CLI before scanning)."""
    global _options
    _options = MisconfOptions(policy_dirs, helm_value_files,
                              helm_set_values, trace)


def _load_custom(dirs: list) -> dict:
    """{file_type: [Policy]} from user policy modules."""
    out: dict = {}
    import types as _types
    for d in dirs:
        try:
            names = sorted(os.listdir(d))
        except OSError as e:
            raise ValueError(f"--config-policy {d}: {e}")
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(d, name)
            mod = _types.ModuleType(f"trivy_config_policy_{name[:-3]}")
            with open(path, encoding="utf-8") as f:
                src = f.read()
            try:
                exec(compile(src, path, "exec"), mod.__dict__)
            except Exception as e:       # noqa: BLE001
                raise ValueError(f"config policy {path}: {e!r}")
            policies = getattr(mod, "POLICIES", None)
            if not isinstance(policies, (list, tuple)):
                raise ValueError(
                    f"config policy {path} must define POLICIES = "
                    f"[Policy(...)]")
            for p in policies:
                for ft in (p.file_types or ("kubernetes",)):
                    out.setdefault(ft, []).append(p)
    return out


_options = MisconfOptions()


def _is_kubernetes(doc) -> bool:
    return isinstance(doc, dict) and "apiVersion" in doc and \
        "kind" in doc


def _parse_docs(config_file):
    """ConfigFile → (file_type, parsed docs or None)."""
    if config_file.type == "dockerfile":
        return "dockerfile", dockerfile_mod.parse(config_file.content)
    if config_file.type in ("yaml", "helm", "json"):
        from .cloudformation import parse_template
        cfn = parse_template(config_file.content)
        if cfn is not None:
            return "cloudformation", cfn
    if config_file.type in ("yaml", "helm"):
        if yaml_mod is None:
            return None, None
        try:
            docs = [d for d in yaml_mod.safe_load_all(
                config_file.content.decode("utf-8", "replace"))
                if d is not None]
        except yaml_mod.YAMLError as e:
            log.debug("yaml parse error in %s: %s",
                      config_file.file_path, e)
            return None, None
        k8s = [d for d in docs if _is_kubernetes(d)]
        if k8s:
            return "kubernetes", k8s
        return None, None
    if config_file.type == "json":
        try:
            doc = json_mod.loads(config_file.content)
        except ValueError:
            return None, None
        if _is_kubernetes(doc):
            return "kubernetes", [doc]
        return None, None
    return None, None


def _result(policy: Policy, file_type: str, message: str,
            cause=None, custom: bool = False) -> MisconfResult:
    ns = (f"user.{file_type}.{policy.id}" if custom
          else f"builtin.{file_type}.{policy.id}")
    scanner = _SCANNER_NAMES.get(file_type, file_type.title())
    return MisconfResult(
        namespace=ns,
        query=f"data.{ns}.deny",
        message=message,
        id=policy.id,
        avd_id=policy.avd_id,
        type=f"{scanner} Security Check",
        title=policy.title,
        description=policy.description,
        severity=policy.severity,
        recommended_actions=policy.recommended_actions,
        references=list(policy.references),
        cause_metadata=CauseMetadata(
            resource=getattr(cause, "resource", "") or "",
            provider=policy.provider,
            service=policy.service,
            start_line=getattr(cause, "start_line", 0),
            end_line=getattr(cause, "end_line", 0)),
    )


def _policies_for(file_type: str) -> list:
    builtin = {
        "dockerfile": DOCKERFILE_POLICIES,
        "kubernetes": KUBERNETES_POLICIES,
        "helm": KUBERNETES_POLICIES,
    }.get(file_type)
    if builtin is None:
        if file_type == "terraform":
            from .terraform import TERRAFORM_POLICIES
            builtin = TERRAFORM_POLICIES
        elif file_type == "cloudformation":
            from .cloudformation import CLOUDFORMATION_POLICIES
            builtin = CLOUDFORMATION_POLICIES
        else:
            builtin = []
    custom = _options.custom_policies.get(file_type, [])
    return [(p, False) for p in builtin] + [(p, True) for p in custom]


def _evaluate(file_type: str, docs, file_path: str,
              check_input=None) -> Misconfiguration:
    """Run every applicable policy over one file's parsed docs."""
    successes, failures = [], []
    for policy, custom in _policies_for(file_type):
        causes = []
        if file_type == "dockerfile":
            causes = policy.check(docs)
        elif file_type in ("kubernetes", "helm"):
            for doc in docs:
                causes.extend(policy.check(doc))
        else:
            causes = policy.check(check_input
                                  if check_input is not None else docs)
        if causes:
            for cause in causes:
                failures.append(_result(
                    policy, file_type, cause.message, cause, custom))
        else:
            successes.append(_result(
                policy, file_type, policy.success_message,
                custom=custom))
    successes.sort(key=lambda r: (r.avd_id,
                                  r.cause_metadata.start_line))
    failures.sort(key=lambda r: (r.avd_id,
                                 r.cause_metadata.start_line))
    return Misconfiguration(
        file_type=file_type, file_path=file_path,
        successes=successes, failures=failures)


def _scan_terraform(tf_files: list) -> list:
    """Group .tf ConfigFiles by directory into modules, evaluate the
    module, then attribute each cause to the file its resource lives
    in (defsec reports per-resource-location files the same way).
    Successes attach to every file in the module."""
    from .hcl import parse_module
    by_dir: dict = {}
    for cf in tf_files:
        by_dir.setdefault(posixpath.dirname(cf.file_path), []).append(cf)
    out = []
    for _d, files in sorted(by_dir.items()):
        sources = {cf.file_path: cf.content.decode("utf-8", "replace")
                   for cf in files}
        try:
            blocks = parse_module(sources)
        except Exception as e:       # noqa: BLE001 - stay robust
            log.debug("terraform parse error in %s: %s", _d, e)
            continue
        # --trace: evaluation visibility — where the HCL subset
        # bailed to Unresolved, grouped per source file (the rego
        # --trace analog; checks never fail on unknowns, so these
        # are exactly the spots "clean" might mean "couldn't
        # evaluate")
        trace_by_file: dict = {}
        if _options.trace:
            from .hcl import unresolved_trace
            for src, line in unresolved_trace(blocks):
                trace_by_file.setdefault(src, []).append(line)
        # evaluate once per module; split causes per source file
        per_file: dict = {cf.file_path: ([], []) for cf in files}
        for policy, custom in _policies_for("terraform"):
            causes = policy.check(blocks)
            if causes:
                for cause in causes:
                    fp = getattr(cause, "file_path", "") or \
                        files[0].file_path
                    per_file.setdefault(fp, ([], []))[1].append(
                        _result(policy, "terraform", cause.message,
                                cause, custom))
            else:
                for cf in files:
                    per_file[cf.file_path][0].append(_result(
                        policy, "terraform", policy.success_message,
                        custom=custom))
        for fp, (succ, fail) in sorted(per_file.items()):
            succ.sort(key=lambda r: (r.avd_id,
                                     r.cause_metadata.start_line))
            fail.sort(key=lambda r: (r.avd_id,
                                     r.cause_metadata.start_line))
            out.append(Misconfiguration(
                file_type="terraform", file_path=fp,
                successes=succ, failures=fail,
                traces=trace_by_file.get(fp, [])))
    return out


def _scan_helm_charts(config_files: list) -> tuple:
    """Render detected charts; returns ([Misconfiguration],
    set of paths consumed by chart rendering)."""
    from .helm import find_charts, render_chart
    files = {cf.file_path: cf.content for cf in config_files
             if cf.type in ("yaml", "helm")}
    charts = find_charts(list(files))
    overrides = []
    for vf in _options.helm_value_files:
        try:
            with open(vf, encoding="utf-8") as f:
                overrides.append(f.read())
        except OSError as e:
            log.warning("--helm-values %s: %s", vf, e)
    out, consumed = [], set()
    for root, tpls in sorted(charts.items()):
        consumed.update(tpls)
        # posixpath.join: a chart at the scan root has root == "" and
        # plain concat would yield "/Chart.yaml", never matching the
        # real path, so those files got re-scanned as plain configs
        consumed.add(posixpath.join(root, "Chart.yaml"))
        consumed.add(posixpath.join(root, "values.yaml"))
        rendered = render_chart(
            files, root, tpls, overrides,
            _options.helm_set_values)
        for path, text in sorted(rendered.items()):
            if yaml_mod is None:
                continue
            try:
                docs = [d for d in yaml_mod.safe_load_all(text)
                        if d is not None]
            except yaml_mod.YAMLError as e:
                log.debug("rendered helm template %s: %s", path, e)
                continue
            k8s = [d for d in docs if _is_kubernetes(d)]
            if k8s:
                out.append(_evaluate("helm", k8s, path))
    return out, consumed


def scan_config_files(config_files: list) -> list:
    """[ConfigFile] → [Misconfiguration], sorted per
    misconf.go:300-321."""
    out = []

    helm_results, consumed = _scan_helm_charts(config_files)
    out.extend(helm_results)

    tf = [cf for cf in config_files if cf.type == "terraform"]
    if tf:
        out.extend(_scan_terraform(tf))

    for cf in config_files:
        if cf.type == "terraform" or cf.file_path in consumed:
            continue
        file_type, docs = _parse_docs(cf)
        if file_type is None:
            continue
        out.append(_evaluate(file_type, docs, cf.file_path,
                             check_input=docs))
    out.sort(key=lambda m: m.file_path)
    return out
