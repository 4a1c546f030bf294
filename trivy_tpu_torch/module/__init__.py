"""In-process extension modules (copied from
``trivy_tpu/module/__init__.py``; reference: pkg/module — WASM via
wazero).

The reference loads ``~/.trivy/modules/*.wasm`` and registers each as
an analyzer and/or post-scanner through a handshake of exports
(module.go:573-680). The Python analog loads
``~/.trivy-tpu/modules/*.py`` with the same handshake as module-level
attributes:

    name = "spring4shell"
    version = 1
    api_version = 1
    is_analyzer = True          # implement required()/analyze()
    is_post_scanner = True      # implement post_scan(results)
    required_files = [r"\\.java$"]   # regex list, like Required()

Analyzer modules see (path, content) and return either a dict with
EXACTLY the keys ``{"type", "data"}`` — a self-typed custom resource
(serialize.CustomResource shape: the declared type plus a bare
payload) — or any other dict, stored opaquely under the module's own
``module:<name>`` type. Payload dicts that legitimately need keys
named type+data must add any third key to stay opaque.
Post-scanner modules
rewrite the results list (INSERT/UPDATE/DELETE by returning the
modified list, api/api.go's action set collapsed into
return-the-new-results).
"""

from __future__ import annotations

import logging
import os
import re
import types as types_mod
from typing import Optional

from ..analyzer.analyzer import (AnalysisResult, Analyzer,
                                 register_analyzer)
from ..scan.post import register_post_scanner
from ..types.artifact import CustomResource

log = logging.getLogger("trivy_tpu_torch.module")

SUPPORTED_API_VERSION = 1

# absolute paths already registered this process — repeated
# cli.main() calls must not re-register analyzers (the global
# analyzer registry appends without dedup)
_LOADED: set = set()


def modules_dir() -> str:
    return os.environ.get(
        "TRIVY_MODULE_DIR",
        os.path.join(os.path.expanduser("~"), ".trivy-tpu",
                     "modules"))


class _ModuleAnalyzer(Analyzer):
    def __init__(self, mod):
        self.mod = mod
        self.type = f"module:{mod.name}"
        self.version = getattr(mod, "version", 1)
        self._patterns = [re.compile(p) for p in
                          getattr(mod, "required_files", [])]

    def required(self, path: str, size: Optional[int] = None) -> bool:
        if hasattr(self.mod, "required"):
            return bool(self.mod.required(path, size))
        return any(p.search(path) for p in self._patterns)

    def analyze(self, path: str, content: bytes) -> AnalysisResult:
        r = AnalysisResult()
        # modules see rooted paths (module.go:390 prefixes "/")
        file_path = path if path.startswith("/") else "/" + path
        data = self.mod.analyze(file_path, content)
        if data:
            rtype, payload = self.type, data
            if isinstance(data, dict) and \
                    set(data) == {"type", "data"}:
                # EXACTLY {type, data}: the module declares its own
                # resource type + bare payload
                # (serialize.CustomResource{Type, Data} shape);
                # any other dict is an opaque legacy payload
                rtype, payload = str(data["type"]), data["data"]
            r.custom_resources.append(CustomResource(
                type=rtype, file_path=file_path, data=payload))
        return r


class _ModulePostScanner:
    def __init__(self, mod):
        self.mod = mod
        self.name = mod.name
        self.version = getattr(mod, "version", 1)

    def post_scan(self, results: list) -> list:
        return self.mod.post_scan(results)


class Manager:
    """Loads and registers modules (ref module.go:80-149)."""

    def __init__(self, directory: str = ""):
        self.directory = directory or modules_dir()
        self.modules: list = []

    def load(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        for fname in sorted(os.listdir(self.directory)):
            if not fname.endswith(".py") or fname.startswith("_"):
                continue
            path = os.path.abspath(
                os.path.join(self.directory, fname))
            if path in _LOADED:
                continue
            try:
                mod = self._load_one(path)
                _LOADED.add(path)
            except Exception as e:      # noqa: BLE001 — a broken
                # module must not brick the scanner
                log.warning("failed to load module %s: %r",
                            path, e)
                continue
            self.modules.append(mod)
        return self.modules

    def _load_one(self, path: str):
        mod = _exec_module(path)
        name = mod.name
        if getattr(mod, "is_analyzer", False):
            register_analyzer(_ModuleAnalyzer(mod))
            log.info("registered module analyzer %s", name)
        if getattr(mod, "is_post_scanner", False):
            register_post_scanner(_ModulePostScanner(mod))
            log.info("registered module post-scanner %s", name)
        return mod


# --- management commands (ref pkg/commands/app.go:693 + pkg/module
# Install/Uninstall; the reference pulls modules from an OCI
# repository — the registry fetch is the documented egress seam, so
# install here takes a local .py file or a directory of them) ---

def _exec_module(path: str):
    """Execute a module file and check the handshake: it must set
    `name` and a supported `api_version` (module.go's export
    validation). Shared by loading, install validation and
    listing. Any exec-time failure surfaces as ValueError so
    callers print one clean error."""
    mod = types_mod.ModuleType(
        "trivy_module_" +
        os.path.basename(path).removesuffix(".py"))
    try:
        with open(path, encoding="utf-8") as f:
            exec(compile(f.read(), path, "exec"), mod.__dict__)
    except Exception as e:          # noqa: BLE001 — module code
        # can fail arbitrarily; it must not traceback the CLI
        raise ValueError(f"{path}: {e!r}") from e
    if not getattr(mod, "name", ""):
        raise ValueError(f"{path}: module must set `name`")
    api = getattr(mod, "api_version", 1)
    if api > SUPPORTED_API_VERSION:
        raise ValueError(
            f"{path}: module {mod.name} requires api_version "
            f"{api} > {SUPPORTED_API_VERSION}")
    return mod


def install(source: str, directory: str = "") -> list:
    """Copy module file(s) into the modules dir. Every file is
    validated before any is copied, so a bad file in a directory
    install leaves nothing half-installed. → installed names."""
    import shutil
    directory = directory or modules_dir()
    if os.path.isfile(source):
        files = [source]
    elif os.path.isdir(source):
        files = [os.path.join(source, f)
                 for f in sorted(os.listdir(source))
                 if f.endswith(".py") and not f.startswith("_")]
    else:
        raise ValueError(f"no such file or directory: {source}")
    if not files:
        raise ValueError(f"no module files in {source}")
    for f in files:
        if not f.endswith(".py"):
            raise ValueError(f"not a Python module: {f}")
        _exec_module(f)
    installed = []
    os.makedirs(directory, exist_ok=True)
    for f in files:
        dest = os.path.join(directory, os.path.basename(f))
        shutil.copyfile(f, dest)
        installed.append(
            os.path.basename(f).removesuffix(".py"))
    return installed


def uninstall(name: str, directory: str = "") -> bool:
    # names are bare module stems — reject separators so a crafted
    # name cannot traverse out of the modules dir
    if name != os.path.basename(name) or ".." in name or \
            "/" in name or "\\" in name:
        return False
    directory = directory or modules_dir()
    path = os.path.join(directory, name + ".py")
    if not os.path.isfile(path):
        return False
    os.remove(path)
    return True


def list_installed(directory: str = "") -> list:
    """→ [(file-stem, declared name, version)] without registering
    anything."""
    directory = directory or modules_dir()
    if not os.path.isdir(directory):
        return []
    out = []
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        path = os.path.join(directory, fname)
        try:
            mod = _exec_module(path)
            name, version = mod.name, getattr(mod, "version", 1)
        except ValueError:
            name, version = "<broken>", 0
        out.append((fname.removesuffix(".py"), name, version))
    return out
