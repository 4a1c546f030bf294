"""IaC config-file collectors (reference:
pkg/fanal/analyzer/config/{dockerfile,yaml,json}).

These analyzers only COLLECT — they stash raw bytes as ConfigFiles in
the blob; the misconf post-handler (``misconf/``) parses and
evaluates policies, the way the reference's fanal collectors feed the
defsec engine via the misconf handler. Disabled unless
``--security-checks config`` is on (the reference registers them only
when the misconfig scanner option is set).
"""

from __future__ import annotations

import os
from typing import Optional

from ..types import ConfigFile
from .analyzer import AnalysisResult, Analyzer, register_analyzer

# collectors skip anything bigger — IaC files are small; big yaml/json
# blobs are data, not config
MAX_CONFIG_SIZE = 1 << 20

CONFIG_ANALYZER_TYPES = ("dockerfile", "yaml", "json", "terraform")


class _Collector(Analyzer):
    version = 1

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        r = AnalysisResult()
        r.config_files.append(ConfigFile(
            type=self.type, file_path=path, content=content))
        return r


@register_analyzer
class DockerfileAnalyzer(_Collector):
    type = "dockerfile"

    def required(self, path: str, size: Optional[int] = None) -> bool:
        if size is not None and size > MAX_CONFIG_SIZE:
            return False
        name = os.path.basename(path)
        base = name.lower()
        return base in ("dockerfile", "containerfile") or \
            base.startswith("dockerfile.") or \
            base.endswith(".dockerfile")


@register_analyzer
class YamlConfigAnalyzer(_Collector):
    type = "yaml"

    def required(self, path: str, size: Optional[int] = None) -> bool:
        if size is not None and size > MAX_CONFIG_SIZE:
            return False
        return path.endswith((".yaml", ".yml"))


@register_analyzer
class JsonConfigAnalyzer(_Collector):
    type = "json"

    def required(self, path: str, size: Optional[int] = None) -> bool:
        if size is not None and size > MAX_CONFIG_SIZE:
            return False
        return path.endswith(".json")


@register_analyzer
class TerraformConfigAnalyzer(_Collector):
    """Collector for .tf modules (reference:
    pkg/fanal/analyzer/config/terraform; .tf.json is covered by the
    JSON collector's CFN/k8s sniffing)."""

    type = "terraform"

    def required(self, path: str, size: Optional[int] = None) -> bool:
        if size is not None and size > MAX_CONFIG_SIZE:
            return False
        return path.endswith(".tf")

