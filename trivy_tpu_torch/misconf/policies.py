"""Built-in misconfiguration policies.

Python re-implementations of the best-known defsec built-in checks
(IDs/AVD IDs/titles/severities are the compat contract — the
reference embeds these in defsec's Go checks). Each policy's
``check(doc)`` returns a list of Causes; empty list = pass.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from functools import partial
from typing import Callable

from .dockerfile import Stage


@dataclass
class Cause:
    message: str
    start_line: int = 0
    end_line: int = 0
    resource: str = ""
    file_path: str = ""      # module-scoped checks (terraform) set it


@dataclass
class Policy:
    id: str
    avd_id: str
    title: str
    description: str
    severity: str
    recommended_actions: str
    references: list
    provider: str
    service: str
    check: Callable          # (parsed doc) -> list[Cause]
    success_message: str = "No issues found"
    # custom policies (--config-policy) declare which parsed inputs
    # their check understands: dockerfile | kubernetes | terraform |
    # cloudformation | helm
    file_types: tuple = ()


# ------------------------------------------------------------ dockerfile


def _last_user(stage: Stage):
    user = None
    for inst in stage.instructions:
        if inst.cmd == "USER":
            user = inst
    return user


def _check_root_user(stages: list) -> list:
    """The FINAL stage decides who runs the container."""
    if not stages:
        return []
    stage = stages[-1]
    user = _last_user(stage)
    if user is None:
        # a missing USER is a whole-file finding with no location
        # (dockerfile.json.golden: CauseMetadata carries no
        # Start/EndLine for DS002)
        return [Cause(
            message="Specify at least 1 USER command in Dockerfile "
            "with non-root user as argument")]
    if user.value.split(":")[0] in ("root", "0"):
        return [Cause(
            message="Last USER command in Dockerfile should not be "
            f"'root' but it is {user.value!r}",
            start_line=user.start_line, end_line=user.end_line)]
    return []


def _check_latest_tag(stages: list) -> list:
    causes = []
    earlier_stages = set()
    for stage in stages:
        base = stage.base
        if base and base not in earlier_stages and \
                not base.startswith("$") and "@" not in base:
            # tag = whatever follows ':' in the last path segment
            segment = base.rsplit("/", 1)[-1]
            _, sep, tag = segment.partition(":")
            if not sep or tag == "latest":
                causes.append(Cause(
                    message="Specify a tag in the 'FROM' statement "
                    f"for image '{segment.split(':')[0]}'",
                    start_line=stage.start_line,
                    end_line=stage.start_line))
        if stage.alias:
            # only AS aliases are resolvable as later FROM targets
            earlier_stages.add(stage.alias)
    return causes


def _check_add(stages: list) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "ADD":
                continue
            src = inst.value.split()[0] if inst.value.split() else ""
            # ADD is legitimate for remote URLs and auto-extraction
            if src.startswith(("http://", "https://")) or \
                    src.endswith((".tar", ".tar.gz", ".tgz",
                                  ".tar.bz2", ".tar.xz", ".zip")):
                continue
            causes.append(Cause(
                message=f"Consider using 'COPY {inst.value}' "
                "command instead of 'ADD' command",
                start_line=inst.start_line,
                end_line=inst.end_line))
    return causes


def _check_exposed_22(stages: list) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd == "EXPOSE":
                for port in inst.value.split():
                    if port.split("/")[0] == "22":
                        causes.append(Cause(
                            message="Port 22 should not be exposed "
                            "in Dockerfile",
                            start_line=inst.start_line,
                            end_line=inst.end_line))
    return causes


def _check_healthcheck(stages: list) -> list:
    if any(inst.cmd == "HEALTHCHECK"
           for s in stages for inst in s.instructions):
        return []
    return [Cause(message="Add HEALTHCHECK instruction in your "
                  "Dockerfile", start_line=1, end_line=1)]


DOCKERFILE_POLICIES = [
    Policy(id="DS001", avd_id="AVD-DS-0001",
           title="':latest' tag used",
           description="When using a 'FROM' statement you should use "
           "a specific tag to avoid uncontrolled behavior when the "
           "image is updated.",
           severity="MEDIUM",
           recommended_actions="Add a tag to the image in the 'FROM' "
           "statement",
           references=["https://avd.aquasec.com/misconfig/ds001"],
           provider="Dockerfile", service="general",
           check=_check_latest_tag),
    Policy(id="DS002", avd_id="AVD-DS-0002",
           title="Image user should not be 'root'",
           description="Running containers with 'root' user can lead "
           "to a container escape situation. It is a best practice "
           "to run containers as non-root users, which can be done "
           "by adding a 'USER' statement to the Dockerfile.",
           severity="HIGH",
           recommended_actions="Add 'USER <non root user name>' line "
           "to the Dockerfile",
           references=["https://docs.docker.com/develop/"
                       "develop-images/dockerfile_best-practices/",
                       "https://avd.aquasec.com/misconfig/ds002"],
           provider="Dockerfile", service="general",
           check=_check_root_user),
    Policy(id="DS004", avd_id="AVD-DS-0004",
           title="Port 22 exposed",
           description="Exposing port 22 might allow users to SSH "
           "into the container.",
           severity="MEDIUM",
           recommended_actions="Remove 'EXPOSE 22' statement from "
           "the Dockerfile",
           references=["https://avd.aquasec.com/misconfig/ds004"],
           provider="Dockerfile", service="general",
           check=_check_exposed_22),
    Policy(id="DS005", avd_id="AVD-DS-0005",
           title="ADD instead of COPY",
           description="You should use COPY instead of ADD unless "
           "you want to extract a tar file. Note that an ADD command "
           "will extract a tar file, which adds the risk of Zip-based "
           "vulnerabilities. Accordingly, it is advised to use a COPY "
           "command, which does not extract tar files.",
           severity="LOW",
           recommended_actions="Use COPY instead of ADD",
           references=["https://avd.aquasec.com/misconfig/ds005"],
           provider="Dockerfile", service="general",
           check=_check_add),
]

# DS026 (no HEALTHCHECK) exists in later defsec but NOT in this
# reference vintage's embedded set: dockerfile.json.golden evaluates
# exactly 22 checks and passes a HEALTHCHECK-less Dockerfile, so
# registering it would break count and verdict parity. The check
# function (_check_healthcheck) stays for custom policy reuse.


# ------------------------------------------------------------ kubernetes


def _k8s_containers(doc: dict):
    spec = doc.get("spec") or {}
    # workloads nest pod specs under template
    tmpl = (spec.get("template") or {}).get("spec") or {}
    pod = tmpl or spec
    for kind in ("initContainers", "containers"):
        for c in pod.get(kind) or []:
            yield c, pod


def _k8s_check_privileged(doc: dict) -> list:
    causes = []
    for c, _ in _k8s_containers(doc):
        sc = c.get("securityContext") or {}
        if sc.get("privileged"):
            causes.append(Cause(
                message=f"Container {c.get('name', '?')!r} of "
                f"{doc.get('kind', '?')} "
                f"{(doc.get('metadata') or {}).get('name', '?')!r} "
                "should set 'securityContext.privileged' to false",
                resource=c.get("name", "")))
    return causes


def _k8s_check_priv_escalation(doc: dict) -> list:
    causes = []
    for c, _ in _k8s_containers(doc):
        sc = c.get("securityContext") or {}
        if sc.get("allowPrivilegeEscalation", True):
            causes.append(Cause(
                message=f"Container {c.get('name', '?')!r} of "
                f"{doc.get('kind', '?')} "
                f"{(doc.get('metadata') or {}).get('name', '?')!r} "
                "should set "
                "'securityContext.allowPrivilegeEscalation' to false",
                resource=c.get("name", "")))
    return causes


def _k8s_check_run_as_nonroot(doc: dict) -> list:
    causes = []
    for c, pod in _k8s_containers(doc):
        csc = c.get("securityContext") or {}
        psc = pod.get("securityContext") or {}
        # container-level setting overrides the pod-level one
        effective = csc.get("runAsNonRoot")
        if effective is None:
            effective = psc.get("runAsNonRoot")
        if not effective:
            causes.append(Cause(
                message=f"Container {c.get('name', '?')!r} of "
                f"{doc.get('kind', '?')} "
                f"{(doc.get('metadata') or {}).get('name', '?')!r} "
                "should set 'securityContext.runAsNonRoot' to true",
                resource=c.get("name", "")))
    return causes


def _k8s_check_readonly_rootfs(doc: dict) -> list:
    causes = []
    for c, _ in _k8s_containers(doc):
        sc = c.get("securityContext") or {}
        if not sc.get("readOnlyRootFilesystem"):
            causes.append(Cause(
                message=f"Container {c.get('name', '?')!r} of "
                f"{doc.get('kind', '?')} "
                f"{(doc.get('metadata') or {}).get('name', '?')!r} "
                "should set 'securityContext."
                "readOnlyRootFilesystem' to true",
                resource=c.get("name", "")))
    return causes


def _k8s_check_run_as_root_group(doc: dict) -> list:
    """KSV029: explicit root primary (runAsGroup/fsGroup 0) or
    supplementary (supplementalGroups containing 0) GID."""
    causes = []
    for c, pod in _k8s_containers(doc):
        csc = c.get("securityContext") or {}
        psc = pod.get("securityContext") or {}
        group = csc.get("runAsGroup", psc.get("runAsGroup"))
        fs_group = psc.get("fsGroup")
        supplemental = psc.get("supplementalGroups") or []
        if group == 0 or fs_group == 0 or 0 in supplemental:
            causes.append(Cause(
                message=f"Container {c.get('name', '?')!r} of "
                f"{doc.get('kind', '?')} "
                f"{(doc.get('metadata') or {}).get('name', '?')!r} "
                "should not set 'securityContext.runAsGroup' or "
                "'fsGroup' to 0",
                resource=c.get("name", "")))
    return causes


def _k8s_check_docker_sock(doc: dict) -> list:
    causes = []
    spec = doc.get("spec") or {}
    pod = (spec.get("template") or {}).get("spec") or spec
    for vol in pod.get("volumes") or []:
        host_path = (vol.get("hostPath") or {}).get("path", "")
        if host_path.rstrip("/") == "/var/run/docker.sock":
            causes.append(Cause(
                message=f"{doc.get('kind', '?')} "
                f"{(doc.get('metadata') or {}).get('name', '?')!r} "
                "should not mount '/var/run/docker.sock'",
                resource=vol.get("name", "")))
    return causes


KUBERNETES_POLICIES = [
    Policy(id="KSV001", avd_id="AVD-KSV-0001",
           title="Process can elevate its own privileges",
           description="A program inside the container can elevate "
           "its own privileges and run as root, which might give the "
           "program control over the container and node.",
           severity="MEDIUM",
           recommended_actions="Set 'set containers[].securityContext"
           ".allowPrivilegeEscalation' to 'false'.",
           references=["https://avd.aquasec.com/misconfig/ksv001"],
           provider="Kubernetes", service="general",
           check=_k8s_check_priv_escalation),
    Policy(id="KSV006", avd_id="AVD-KSV-0006",
           title="hostPath volume mounted with docker.sock",
           description="Mounting docker.sock from the host can give "
           "the container full root access to the host.",
           severity="HIGH",
           recommended_actions="Do not specify /var/run/docker.sock "
           "in 'spec.template.volumes.hostPath.path'.",
           references=["https://avd.aquasec.com/misconfig/ksv006"],
           provider="Kubernetes", service="general",
           check=_k8s_check_docker_sock),
    Policy(id="KSV012", avd_id="AVD-KSV-0012",
           title="Runs as root user",
           description="'runAsNonRoot' forces the running image to "
           "run as a non-root user to ensure least privileges.",
           severity="MEDIUM",
           recommended_actions="Set 'containers[].securityContext."
           "runAsNonRoot' to true.",
           references=["https://avd.aquasec.com/misconfig/ksv012"],
           provider="Kubernetes", service="general",
           check=_k8s_check_run_as_nonroot),
    Policy(id="KSV014", avd_id="AVD-KSV-0014",
           title="Root file system is not read-only",
           description="An immutable root file system prevents "
           "applications from writing to their local disk.",
           severity="LOW",
           recommended_actions="Change 'containers[].securityContext"
           ".readOnlyRootFilesystem' to 'true'.",
           references=["https://avd.aquasec.com/misconfig/ksv014"],
           provider="Kubernetes", service="general",
           check=_k8s_check_readonly_rootfs),
    Policy(id="KSV029", avd_id="AVD-KSV-0029",
           title="A root primary or supplementary GID set",
           description="Containers should be forbidden from running "
           "with a root primary or supplementary GID.",
           severity="LOW",
           recommended_actions="Set 'securityContext.runAsGroup' and "
           "'fsGroup' to a non-zero GID.",
           references=["https://avd.aquasec.com/misconfig/ksv029"],
           provider="Kubernetes", service="general",
           check=_k8s_check_run_as_root_group),
    Policy(id="KSV017", avd_id="AVD-KSV-0017",
           title="Privileged container",
           description="Privileged containers share namespaces with "
           "the host system and do not offer any security. They "
           "should be used exclusively for system containers.",
           severity="HIGH",
           recommended_actions="Change 'containers[].securityContext"
           ".privileged' to 'false'.",
           references=["https://avd.aquasec.com/misconfig/ksv017"],
           provider="Kubernetes", service="general",
           check=_k8s_check_privileged),
]


def _check_copy_from_self(stages: list) -> list:
    """DS006: COPY --from references the stage's own FROM alias."""
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "COPY":
                continue
            for flag in inst.flags:
                if flag.startswith("--from=") and stage.alias and \
                        flag[len("--from="):].lower() == \
                        stage.alias.lower():
                    causes.append(Cause(
                        message=f"'COPY {flag}' references the "
                        f"current image FROM alias "
                        f"{stage.alias!r}",
                        start_line=inst.start_line,
                        end_line=inst.end_line))
    return causes


def _check_duplicate(cmd: str, stages: list) -> list:
    """Per stage, every occurrence of ``cmd`` but the last is dead."""
    causes = []
    for stage in stages:
        insts = [i for i in stage.instructions if i.cmd == cmd]
        for inst in insts[:-1]:
            causes.append(Cause(
                message=f"There are multiple {cmd} instructions; "
                "only the last one takes effect",
                start_line=inst.start_line,
                end_line=inst.end_line))
    return causes


def _check_port_range(stages: list) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "EXPOSE":
                continue
            for port in inst.value.split():
                num = port.split("/")[0]
                if num.isdigit() and int(num) > 65535:
                    causes.append(Cause(
                        message=f"'EXPOSE' contains port "
                        f"{num} which is out of range",
                        start_line=inst.start_line,
                        end_line=inst.end_line))
    return causes


def _check_workdir_relative(stages: list) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "WORKDIR":
                continue
            path = inst.value.strip().strip("'\"")
            if path and not path.startswith(("/", "$", "C:",
                                             "c:")):
                causes.append(Cause(
                    message=f"WORKDIR path {path!r} should be "
                    "absolute",
                    start_line=inst.start_line,
                    end_line=inst.end_line))
    return causes


def _check_run_sudo(stages: list) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd == "RUN" and re.search(
                    r"(^|\s|;|&&)sudo\s", " " + inst.value):
                causes.append(Cause(
                    message="Using 'sudo' in RUN is not supported "
                    "and indicates a misconfigured image",
                    start_line=inst.start_line,
                    end_line=inst.end_line))
    return causes


def _check_run_cd(stages: list) -> list:
    """DS013: use WORKDIR, not 'RUN cd ...' as the only command."""
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd == "RUN" and re.match(
                    r"^cd\s+\S+$", inst.value.strip()):
                causes.append(Cause(
                    message=f"RUN should not be used to change "
                    f"directories ('{inst.value}'); use WORKDIR",
                    start_line=inst.start_line,
                    end_line=inst.end_line))
    return causes


def _check_apt_install_y(stages: list) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "RUN":
                continue
            for part in re.split(r"&&|;|\|", inst.value):
                tokens = part.split()
                if "apt-get" not in tokens and "apt" not in tokens:
                    continue
                if "install" not in tokens:
                    continue
                confirmed = any(
                    t in ("--yes", "--assume-yes") or
                    (t.startswith("-") and not t.startswith("--")
                     and "y" in t[1:])
                    for t in tokens)
                if not confirmed:
                    causes.append(Cause(
                        message="'-y' flag is missing from "
                        "'apt-get install' — the build will hang "
                        "on the confirmation prompt",
                        start_line=inst.start_line,
                        end_line=inst.end_line))
    return causes


def _check_apk_no_cache(stages: list) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "RUN":
                continue
            for part in re.split(r"&&|;|\|", inst.value):
                tokens = part.split()
                if "apk" in tokens and "add" in tokens and \
                        "--no-cache" not in tokens:
                    causes.append(Cause(
                        message="'--no-cache' is missing from "
                        "'apk add' — the package index bloats the "
                        "image",
                        start_line=inst.start_line,
                        end_line=inst.end_line))
    return causes


def _check_maintainer(stages: list) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd == "MAINTAINER":
                causes.append(Cause(
                    message=f"MAINTAINER is deprecated; use "
                    f"'LABEL maintainer=\"{inst.value}\"'",
                    start_line=inst.start_line,
                    end_line=inst.end_line))
    return causes



def _check_update_alone(stages: list) -> list:
    """DS017: 'RUN <pm> update' without an install in the same RUN
    leaves a stale package index baked into the layer."""
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "RUN":
                continue
            value = inst.value
            has_update = re.search(
                r"\b(apt-get|apt|yum|apk|zypper)\b[^&|;]*"
                r"\b(update|check-update|ref(?:resh)?)\b", value)
            if has_update and "install" not in value and \
                    "add" not in value.split():
                causes.append(Cause(
                    message="The instruction "
                    "'RUN <package-manager> update' should always "
                    "be followed by '<package-manager> install' "
                    "in the same RUN statement",
                    start_line=inst.start_line,
                    end_line=inst.end_line))
    return causes


def _check_copy_multiple_dest(stages: list) -> list:
    """DS011: COPY with more than two arguments needs a directory
    destination ending with '/'."""
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "COPY":
                continue
            args = [t for t in inst.value.split()
                    if not t.startswith("--")]
            if len(args) > 2 and not args[-1].endswith("/"):
                causes.append(Cause(
                    message=f"When COPY with more than two "
                    f"arguments, the last one must end with '/' "
                    f"('{args[-1]}')",
                    start_line=inst.start_line,
                    end_line=inst.end_line))
    return causes


def _check_duplicate_alias(stages: list) -> list:
    """DS012: the same alias must not be used in multiple FROMs."""
    causes = []
    seen: dict = {}
    for stage in stages:
        alias = stage.alias
        if not alias:
            continue
        if alias.lower() in seen:
            causes.append(Cause(
                message=f"Duplicate aliases '{alias}' are defined "
                "in multiple FROMs",
                start_line=stage.start_line,
                end_line=stage.start_line))
        seen[alias.lower()] = True
    return causes


def _check_wget_and_curl(stages: list) -> list:
    """DS014: don't use both wget and curl — pick one tool."""
    used = {"wget": None, "curl": None}
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "RUN":
                continue
            for part in re.split(r"&&|;|\|", inst.value):
                tokens = part.split()
                for tool in ("wget", "curl"):
                    if tool in tokens and used[tool] is None:
                        used[tool] = inst
    if used["wget"] is not None and used["curl"] is not None:
        inst = used["curl"]
        return [Cause(
            message="Shouldn't use both curl and wget",
            start_line=inst.start_line, end_line=inst.end_line)]
    return []


def _pm_cleanup_missing(stages, pm, use_re, clean_re,
                        message) -> list:
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd != "RUN":
                continue
            if re.search(use_re, inst.value) and not \
                    re.search(clean_re, inst.value):
                causes.append(Cause(
                    message=message,
                    start_line=inst.start_line,
                    end_line=inst.end_line))
    return causes


def _check_yum_clean(stages: list) -> list:
    """DS015: 'yum install' without 'yum clean all' bloats the
    layer with the package cache."""
    return _pm_cleanup_missing(
        stages, "yum",
        r"\byum\b[^&|;]*\binstall\b",
        r"\byum\s+clean\s+all\b",
        "'yum clean all' is missed")


def _check_zypper_clean(stages: list) -> list:
    """DS019: 'zypper install' without 'zypper clean'."""
    return _pm_cleanup_missing(
        stages, "zypper",
        r"\bzypper\b[^&|;]*\b(install|in)\b",
        r"\bzypper\s+(clean|cc)\b",
        "'zypper clean' is missed")


def _check_dist_upgrade(stages: list) -> list:
    """DS024: 'apt-get dist-upgrade' should not be used in an
    image build."""
    causes = []
    for stage in stages:
        for inst in stage.instructions:
            if inst.cmd == "RUN" and re.search(
                    r"\bapt-get\b[^&|;]*\bdist-upgrade\b",
                    inst.value):
                causes.append(Cause(
                    message="'apt-get dist-upgrade' should not be "
                    "used in a Dockerfile",
                    start_line=inst.start_line,
                    end_line=inst.end_line))
    return causes


DOCKERFILE_POLICIES += [
    Policy(id="DS006", avd_id="AVD-DS-0006",
           title="COPY '--from' references current FROM alias",
           description="COPY '--from' should not mention the "
           "current FROM alias, since it is impossible to copy from "
           "itself.",
           severity="CRITICAL",
           recommended_actions="Change the '--from' so that it "
           "references a previous build stage",
           references=["https://avd.aquasec.com/misconfig/ds006"],
           provider="Dockerfile", service="general",
           check=_check_copy_from_self),
    Policy(id="DS007", avd_id="AVD-DS-0007",
           title="Multiple ENTRYPOINT instructions listed",
           description="There can only be one ENTRYPOINT "
           "instruction in a Dockerfile; only the last one takes "
           "effect.",
           severity="CRITICAL",
           recommended_actions="Remove unnecessary ENTRYPOINT "
           "instructions",
           references=["https://avd.aquasec.com/misconfig/ds007"],
           provider="Dockerfile", service="general",
           check=partial(_check_duplicate, "ENTRYPOINT")),
    Policy(id="DS008", avd_id="AVD-DS-0008",
           title="Port out of range",
           description="UNIX ports outside the 0-65535 range are "
           "invalid.",
           severity="CRITICAL",
           recommended_actions="Use a port number within the range",
           references=["https://avd.aquasec.com/misconfig/ds008"],
           provider="Dockerfile", service="general",
           check=_check_port_range),
    Policy(id="DS009", avd_id="AVD-DS-0009",
           title="WORKDIR path not absolute",
           description="For clarity and reliability, you should "
           "always use absolute paths for your WORKDIR.",
           severity="HIGH",
           recommended_actions="Use an absolute path in WORKDIR",
           references=["https://avd.aquasec.com/misconfig/ds009"],
           provider="Dockerfile", service="general",
           check=_check_workdir_relative),
    Policy(id="DS010", avd_id="AVD-DS-0010",
           title="RUN using 'sudo'",
           description="Avoid using 'sudo' in RUN: it has "
           "unpredictable TTY and signal-forwarding behavior.",
           severity="CRITICAL",
           recommended_actions="Don't use sudo; switch users with "
           "USER",
           references=["https://avd.aquasec.com/misconfig/ds010"],
           provider="Dockerfile", service="general",
           check=_check_run_sudo),
    Policy(id="DS013", avd_id="AVD-DS-0013",
           title="'RUN cd ...' to change directory",
           description="Use WORKDIR instead of proliferating "
           "'RUN cd ...' instructions, which are hard to read and "
           "maintain.",
           severity="MEDIUM",
           recommended_actions="Use WORKDIR to change directories",
           references=["https://avd.aquasec.com/misconfig/ds013"],
           provider="Dockerfile", service="general",
           check=_check_run_cd),
    Policy(id="DS016", avd_id="AVD-DS-0016",
           title="Multiple CMD instructions listed",
           description="There can only be one CMD instruction in a "
           "Dockerfile; only the last one takes effect.",
           severity="HIGH",
           recommended_actions="Remove unnecessary CMD instructions",
           references=["https://avd.aquasec.com/misconfig/ds016"],
           provider="Dockerfile", service="general",
           check=partial(_check_duplicate, "CMD")),
    Policy(id="DS017", avd_id="AVD-DS-0017",
           title="'RUN <package-manager> update' instruction alone",
           description="The instruction 'RUN <package-manager> "
           "update' should always be followed by '<package-manager> "
           "install' in the same RUN statement.",
           severity="HIGH",
           recommended_actions="Combine the update and install "
           "instructions in one RUN",
           references=["https://avd.aquasec.com/misconfig/ds017"],
           provider="Dockerfile", service="general",
           check=_check_update_alone),
    Policy(id="DS021", avd_id="AVD-DS-0021",
           title="'apt-get install' missing '-y'",
           description="Without '-y', apt-get waits for manual "
           "confirmation and the build hangs.",
           severity="HIGH",
           recommended_actions="Add '-y' to 'apt-get install'",
           references=["https://avd.aquasec.com/misconfig/ds021"],
           provider="Dockerfile", service="general",
           check=_check_apt_install_y),
    Policy(id="DS022", avd_id="AVD-DS-0022",
           title="MAINTAINER is deprecated",
           description="The MAINTAINER instruction is deprecated "
           "since Docker 1.13.0.",
           severity="LOW",
           recommended_actions="Use LABEL maintainer=... instead",
           references=["https://avd.aquasec.com/misconfig/ds022"],
           provider="Dockerfile", service="general",
           check=_check_maintainer),
    Policy(id="DS023", avd_id="AVD-DS-0023",
           title="Multiple HEALTHCHECK instructions listed",
           description="There can only be one HEALTHCHECK "
           "instruction in a Dockerfile; only the last one takes "
           "effect.",
           severity="MEDIUM",
           recommended_actions="Remove unnecessary HEALTHCHECK "
           "instructions",
           references=["https://avd.aquasec.com/misconfig/ds023"],
           provider="Dockerfile", service="general",
           check=partial(_check_duplicate, "HEALTHCHECK")),
    Policy(id="DS025", avd_id="AVD-DS-0025",
           title="'apk add' missing '--no-cache'",
           description="Cached package indexes bloat the image; "
           "'apk add --no-cache' avoids them.",
           severity="HIGH",
           recommended_actions="Add '--no-cache' to 'apk add'",
           references=["https://avd.aquasec.com/misconfig/ds025"],
           provider="Dockerfile", service="general",
           check=_check_apk_no_cache),
    Policy(id="DS011", avd_id="AVD-DS-0011",
           title="COPY with multiple sources needs a directory "
           "destination",
           description="When a COPY command has more than two "
           "arguments, the last one must end with '/' so it is "
           "treated as a directory.",
           severity="CRITICAL",
           recommended_actions="End the destination with '/'",
           references=["https://avd.aquasec.com/misconfig/ds011"],
           provider="Dockerfile", service="general",
           check=_check_copy_multiple_dest),
    Policy(id="DS012", avd_id="AVD-DS-0012",
           title="Duplicate aliases defined in multiple FROMs",
           description="Multiple FROM instructions must not use "
           "the same alias.",
           severity="CRITICAL",
           recommended_actions="Rename the duplicate alias",
           references=["https://avd.aquasec.com/misconfig/ds012"],
           provider="Dockerfile", service="general",
           check=_check_duplicate_alias),
    Policy(id="DS014", avd_id="AVD-DS-0014",
           title="'wget' and 'curl' used together",
           description="Pick one HTTP tool; installing both bloats "
           "the image and confuses maintenance.",
           severity="LOW",
           recommended_actions="Use either wget or curl, not both",
           references=["https://avd.aquasec.com/misconfig/ds014"],
           provider="Dockerfile", service="general",
           check=_check_wget_and_curl),
    Policy(id="DS015", avd_id="AVD-DS-0015",
           title="'yum clean all' missing",
           description="The package cache left by 'yum install' "
           "bloats the layer.",
           severity="HIGH",
           recommended_actions="Add 'yum clean all' after the "
           "install",
           references=["https://avd.aquasec.com/misconfig/ds015"],
           provider="Dockerfile", service="general",
           check=_check_yum_clean),
    Policy(id="DS019", avd_id="AVD-DS-0019",
           title="'zypper clean' missing",
           description="The package cache left by 'zypper install' "
           "bloats the layer.",
           severity="HIGH",
           recommended_actions="Add 'zypper clean' after the "
           "install",
           references=["https://avd.aquasec.com/misconfig/ds019"],
           provider="Dockerfile", service="general",
           check=_check_zypper_clean),
    Policy(id="DS024", avd_id="AVD-DS-0024",
           title="'apt-get dist-upgrade' used",
           description="Full distribution upgrades inside an image "
           "build are unpredictable; upgrade the base image "
           "instead.",
           severity="HIGH",
           recommended_actions="Remove 'apt-get dist-upgrade'",
           references=["https://avd.aquasec.com/misconfig/ds024"],
           provider="Dockerfile", service="general",
           check=_check_dist_upgrade),
]
