"""Red Hat build-info analyzers (reference:
pkg/fanal/analyzer/buildinfo/{content_manifest,dockerfile}.go).

Red Hat layered images record which repositories (content sets) the
layer's packages were installed from under
``root/buildinfo/content_manifests/*.json``, and the component NVR +
architecture as labels in ``root/buildinfo/Dockerfile-*``. The Red
Hat detector narrows advisory candidates by these
(detect/ospkg/drivers.py _RedHat.adv_match; ref
pkg/detector/ospkg/redhat/redhat.go:129-138).
"""

from __future__ import annotations

import json
import posixpath

from .analyzer import AnalysisResult, Analyzer, register_analyzer


@register_analyzer
class ContentManifestAnalyzer(Analyzer):
    """root/buildinfo/content_manifests/<img>.json →
    {"ContentSets": [...]} (ref content_manifest.go)."""

    type = "redhat content manifest"
    version = 1

    def required(self, path, size=None):
        head, name = posixpath.split(path)
        return head == "root/buildinfo/content_manifests" and \
            name.endswith(".json")

    def analyze(self, path, content):
        try:
            doc = json.loads(content.decode("utf-8", "replace"))
        except ValueError:
            return None
        sets = doc.get("content_sets")
        if not isinstance(sets, list):
            return None
        return AnalysisResult(build_info={
            "ContentSets": [str(s) for s in sets]})


@register_analyzer
class BuildInfoDockerfileAnalyzer(Analyzer):
    """root/buildinfo/Dockerfile-<name>-<version>-<release> →
    {"Nvr": component-version-release, "Arch": ...} from the
    com.redhat.component / architecture labels (ref
    dockerfile.go:48-91, with buildkit's shlex replaced by the
    repo's quote-aware Dockerfile parser)."""

    type = "redhat dockerfile"
    version = 1

    def required(self, path, size=None):
        head, name = posixpath.split(path)
        return head == "root/buildinfo" and \
            name.startswith("Dockerfile")

    def analyze(self, path, content):
        from ..misconf.dockerfile import parse
        try:
            stages = parse(content)
        except Exception:
            return None
        env: dict = {}
        component = arch = ""
        for stage in stages:
            for ins in stage.instructions:
                if ins.cmd == "ENV" or ins.cmd == "ARG":
                    for k, v in _pairs(ins.value):
                        env[k] = v
                elif ins.cmd == "LABEL":
                    for k, v in _pairs(ins.value):
                        key = _expand(k, env).lower()
                        if key in ("com.redhat.component",
                                   "bzcomponent"):
                            component = _expand(v, env)
                        elif key == "architecture":
                            arch = _expand(v, env)
        if not component or not arch:
            return None
        version = _version_from_name(posixpath.basename(path))
        return AnalysisResult(build_info={
            "Nvr": f"{component}-{version}" if version
            else component,
            "Arch": arch})


def _pairs(value: str):
    """LABEL/ENV "k=v k2=v2" pairs, honoring quoted values."""
    out = []
    token = []
    quote = ""
    for ch in value + " ":
        if quote:
            if ch == quote:
                quote = ""
            else:
                token.append(ch)
        elif ch in "\"'":
            quote = ch
        elif ch.isspace():
            if token:
                word = "".join(token)
                if "=" in word:
                    k, _, v = word.partition("=")
                    out.append((k, v))
                token = []
        else:
            token.append(ch)
    return out


def _expand(value: str, env: dict) -> str:
    """$VAR / ${VAR} substitution from ARG/ENV (shlex
    ProcessWordWithMap analog, defaults to empty)."""
    import re
    return re.sub(
        r"\$(?:\{([^}]+)\}|([A-Za-z_][A-Za-z0-9_]*))",
        lambda m: env.get(m.group(1) or m.group(2), ""), value)


def _version_from_name(name: str) -> str:
    """'Dockerfile-ubi8-8.4-209' → '8.4-209' (the last two
    dash-fields; ref dockerfile.go parseVersion)."""
    release_idx = name.rfind("-")
    if release_idx < 0:
        return ""
    version_idx = name.rfind("-", 0, release_idx)
    if version_idx < 0:
        return ""
    return name[version_idx + 1:]
