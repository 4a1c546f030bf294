"""Plugin system (copied from ``trivy_tpu/plugin/__init__.py``;
reference: pkg/plugin/plugin.go).

git-style subprocess plugins: installed under
``~/.trivy-tpu/plugins/<name>/`` with a ``plugin.yaml`` manifest
``{name, version, usage, platforms: [{selector: {os, arch}, uri,
bin}]}`` (plugin.go manifest shape). ``install`` accepts a local
directory or archive (the reference's go-getter also fetches URLs —
network fetch is a seam here); platform selection picks the first
entry whose selector matches, and ``run`` executes the binary with
stdio passthrough (plugin.go:61-111). Unknown CLI subcommands fall
through to an installed plugin of that name (app.go:96).
"""

from __future__ import annotations

import logging
import os
import platform as platform_mod
import shutil
import subprocess
import sys
import tarfile
import zipfile
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger("trivy_tpu_torch.plugin")

try:
    import yaml as yaml_mod
except ImportError:              # pragma: no cover
    yaml_mod = None


def plugins_dir() -> str:
    return os.environ.get(
        "TRIVY_PLUGIN_DIR",
        os.path.join(os.path.expanduser("~"), ".trivy-tpu",
                     "plugins"))


@dataclass
class Platform:
    os: str = ""
    arch: str = ""
    uri: str = ""
    bin: str = ""


@dataclass
class Plugin:
    name: str = ""
    version: str = ""
    usage: str = ""
    description: str = ""
    platforms: list = field(default_factory=list)
    dir: str = ""

    @classmethod
    def from_manifest(cls, path: str) -> "Plugin":
        with open(path, encoding="utf-8") as f:
            doc = yaml_mod.safe_load(f) or {}
        platforms = []
        for p in doc.get("platforms") or []:
            sel = p.get("selector") or {}
            platforms.append(Platform(
                os=sel.get("os", ""), arch=sel.get("arch", ""),
                uri=p.get("uri", ""), bin=p.get("bin", "")))
        return cls(name=doc.get("name", ""),
                   version=str(doc.get("version", "")),
                   usage=doc.get("usage", ""),
                   description=doc.get("description", ""),
                   platforms=platforms,
                   dir=os.path.dirname(path))

    def _host(self) -> tuple:
        os_name = {"linux": "linux", "darwin": "darwin",
                   "win32": "windows"}.get(sys.platform,
                                           sys.platform)
        arch = {"x86_64": "amd64", "aarch64": "arm64",
                "arm64": "arm64"}.get(platform_mod.machine(),
                                      platform_mod.machine())
        return os_name, arch

    def select_platform(self) -> Optional[Platform]:
        """First platform whose selector matches, empty selector
        matches all (plugin.go:113-135)."""
        host_os, host_arch = self._host()
        for p in self.platforms:
            if (not p.os or p.os == host_os) and \
                    (not p.arch or p.arch == host_arch):
                return p
        return None

    def run(self, args: list) -> int:
        p = self.select_platform()
        if p is None:
            print(f"error: plugin {self.name} supports no platform "
                  f"matching this host", file=sys.stderr)
            return 1
        bin_path = os.path.join(self.dir, p.bin)
        if not os.path.exists(bin_path):
            print(f"error: plugin binary not found: {bin_path}",
                  file=sys.stderr)
            return 1
        try:
            return subprocess.run([bin_path] + list(args)).returncode
        except OSError as e:
            print(f"error: plugin {self.name} failed to start: {e}",
                  file=sys.stderr)
            return 1


def install(source: str) -> Plugin:
    """Install from a local directory or archive containing
    plugin.yaml (reference fetches via go-getter; URL fetch is a
    seam in this zero-egress build)."""
    if not os.path.exists(source):
        raise ValueError(f"plugin source not found: {source} "
                         "(URL installs need network egress)")
    staging = None
    if os.path.isdir(source):
        staging = source
    elif source.endswith((".tar.gz", ".tgz", ".tar")):
        staging = source + ".unpacked"
        with tarfile.open(source) as tf:
            tf.extractall(staging, filter="data")
    elif source.endswith(".zip"):
        staging = source + ".unpacked"
        with zipfile.ZipFile(source) as zf:
            zf.extractall(staging)
    else:
        raise ValueError(f"unsupported plugin source: {source}")

    manifest = os.path.join(staging, "plugin.yaml")
    if not os.path.exists(manifest):
        raise ValueError(f"no plugin.yaml in {source}")
    plugin = Plugin.from_manifest(manifest)
    if not plugin.name:
        raise ValueError("plugin.yaml must set a name")

    dest = os.path.join(plugins_dir(), plugin.name)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(staging, dest)
    # binaries must stay executable through the copy
    for p in plugin.platforms:
        bin_path = os.path.join(dest, p.bin)
        if os.path.exists(bin_path):
            os.chmod(bin_path, 0o755)
    if staging != source:
        shutil.rmtree(staging, ignore_errors=True)
    plugin.dir = dest
    log.info("installed plugin %s %s", plugin.name, plugin.version)
    return plugin


def uninstall(name: str) -> bool:
    dest = os.path.join(plugins_dir(), name)
    if not os.path.exists(dest):
        return False
    shutil.rmtree(dest)
    return True


def load(name: str) -> Optional[Plugin]:
    manifest = os.path.join(plugins_dir(), name, "plugin.yaml")
    if not os.path.exists(manifest):
        return None
    return Plugin.from_manifest(manifest)


def load_all() -> list:
    root = plugins_dir()
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        p = load(name)
        if p is not None:
            out.append(p)
    return out


def run_with_args(name: str, args: list) -> Optional[int]:
    """app.go:96: unknown subcommands dispatch to plugins."""
    plugin = load(name)
    if plugin is None:
        return None
    return plugin.run(args)
