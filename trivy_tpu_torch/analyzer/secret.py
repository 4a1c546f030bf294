"""Secret-candidate collector (reference:
pkg/fanal/analyzer/secret/secret.go).

Gating mirrors Required (secret.go:112-141: size ≥ 10, skip .git /
node_modules dirs, lockfiles, binary-ish extensions) and Analyze's
binary sniff (utils.IsBinary). Unlike the reference — which regexes
each file inline — this analyzer only COLLECTS candidates; the
artifact layer scans the whole collection in one batched sieve
(secret/batch.py), with identical findings.
"""

from __future__ import annotations

import posixpath

from .analyzer import AnalysisResult, Analyzer, register_analyzer

SKIP_FILES = {"go.mod", "go.sum", "package-lock.json", "yarn.lock",
              "pnpm-lock.yaml", "Pipfile.lock", "Gemfile.lock"}
SKIP_DIRS = {".git", "node_modules"}
SKIP_EXTS = {".jpg", ".png", ".gif", ".doc", ".pdf", ".bin", ".svg",
             ".socket", ".deb", ".rpm", ".zip", ".gz", ".gzip",
             ".tar", ".pyc"}


def is_binary(content: bytes) -> bool:
    """utils.IsBinary approximation: NUL byte in the head chunk."""
    return b"\x00" in content[:8000]


@register_analyzer
class SecretCandidateAnalyzer(Analyzer):
    type = "secret"
    version = 1
    config_path = ""      # set from --secret-config (secret.go:135)

    def required(self, path, size=None):
        if size is not None and size < 10:
            return False
        dir_, name = posixpath.split(path)
        if SKIP_DIRS & set(dir_.split("/")):
            return False
        if name in SKIP_FILES:
            return False
        ext = posixpath.splitext(name)[1].lower()
        if ext in SKIP_EXTS:
            return False
        # the secret-rule config itself is never scanned; the
        # reference compares basename(configPath) against the walked
        # path (secret.go:135) — a deliberate quirk we replicate
        # exactly (a top-level file merely SHARING the config's name
        # is skipped there too)
        if self.config_path and \
                posixpath.basename(self.config_path) == path:
            return False
        return True

    def analyze(self, path, content):
        if is_binary(content):
            return None
        return AnalysisResult(secret_candidates=[(path, content)])
