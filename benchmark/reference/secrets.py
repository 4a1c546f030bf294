"""The plain secret scan: Python ``re`` over every file, rule by rule.

Which files are scanned follows trivy's secret analyzer (files under 10
bytes, ``.git`` and ``node_modules`` directories, lockfiles, binary
extensions and files with a NUL byte in their first 8,000 bytes are
skipped); how a file is scanned follows trivy's secret scanner: a
global allow path skips the file; per rule, its path and allow paths,
its keyword prefilter over the lowercased bytes, every regex match
whose text no allow rule matches, the named secret group where the rule
has one. A finding is (path, rule id, first line, last line).
"""

from __future__ import annotations

import posixpath

from .secret_rules import BUILTIN_ALLOW_RULES, BUILTIN_RULES

SKIP_FILES = {"go.mod", "go.sum", "package-lock.json", "yarn.lock",
              "pnpm-lock.yaml", "Pipfile.lock", "Gemfile.lock"}
SKIP_DIRS = {".git", "node_modules"}
SKIP_EXTS = {".jpg", ".png", ".gif", ".doc", ".pdf", ".bin", ".svg",
             ".socket", ".deb", ".rpm", ".zip", ".gz", ".gzip",
             ".tar", ".pyc"}


def scanned(path: str, content: bytes) -> bool:
    """Does trivy's secret analyzer hand this file to the scanner?"""
    if len(content) < 10:
        return False
    dir_, name = posixpath.split(path)
    if SKIP_DIRS & set(dir_.split("/")):
        return False
    if name in SKIP_FILES:
        return False
    if posixpath.splitext(name)[1].lower() in SKIP_EXTS:
        return False
    return b"\x00" not in content[:8000]


def _allowed(rules: list, text: str) -> bool:
    return any(r.regex is not None and r.regex.search(text) for r in rules)


def scan_file(path: str, content: bytes, rules=None) -> set:
    """{(path, rule id, first line, last line)} of one file at ``path``
    (relative to the image root), with ``rules`` (the built-in rules
    when None)."""
    rules = BUILTIN_RULES if rules is None else rules
    if not scanned(path, content):
        return set()
    if any(a.path is not None and a.path.search(path)
           for a in BUILTIN_ALLOW_RULES):
        return set()
    text = content.decode("utf-8", "surrogateescape")
    lowered = content.lower()
    out = set()
    for rule in rules:
        if rule.path is not None and not rule.path.search(path):
            continue
        if any(a.path is not None and a.path.search(path)
               for a in rule.allow_rules):
            continue
        if rule.keywords and not any(k.lower().encode() in lowered
                                     for k in rule.keywords):
            continue
        for m in rule.regex.finditer(text):
            whole = m.group(0)
            if _allowed(BUILTIN_ALLOW_RULES, whole) or \
                    _allowed(rule.allow_rules, whole):
                continue
            if rule.secret_group_name:
                try:
                    s, e = m.span(rule.secret_group_name)
                except IndexError:
                    continue
                if s < 0:
                    continue
            else:
                s, e = m.span()
            first = text.count("\n", 0, s) + 1
            out.add((path, rule.id, first,
                     first + text.count("\n", s, e)))
    return out
