"""Image-config analyzers: packages from RUN history commands
(reference: pkg/fanal/analyzer/command/apk/apk.go, registered via
RegisterConfigAnalyzer and run by AnalyzeImageConfig,
analyzer.go:449-462).

``trivy image --removed-pkgs`` also scans packages that a Dockerfile
installed and later deleted (`apk add foo && ... && apk del foo`) —
the installed-DB never saw them, but the image HISTORY did. The
alpine analyzer parses ``apk add`` commands out of
config history, resolves transitive dependencies through an APKINDEX
archive, and guesses each package's version as the newest build not
younger than the layer's created timestamp (apk.go:225-260).

The APKINDEX archive is pointed to by ``TRIVY_APK_INDEX_ARCHIVE_URL``
(the reference's FANAL_APK_INDEX_ARCHIVE_URL is honored too);
``file://`` paths load directly, and the reference's default GitHub
URL is the documented egress seam — without the env var set, history
analysis yields no packages, exactly like the reference's failed
fetch (AnalyzeImageConfig swallows analyzer errors).
"""

from __future__ import annotations

import json
import logging
import os
from datetime import datetime, timezone

from ..types import Package

log = logging.getLogger("trivy_tpu_torch.analyzer.imgconf")

_ENV_VARS = ("TRIVY_APK_INDEX_ARCHIVE_URL",
             "FANAL_APK_INDEX_ARCHIVE_URL")


def _index_url() -> str:
    for var in _ENV_VARS:
        v = os.environ.get(var, "")
        if v:
            return v
    return ""


def load_apk_index(os_name: str = "") -> dict:
    """APKINDEX archive {Package: {name: {Versions, Dependencies,
    Provides}}, Provide: {SO, Package}} (apk.go:38-59)."""
    url = _index_url()
    if not url:
        return {}
    if "%s" in url and os_name:
        # "3.9.3" → "3.9" (apk.go:80-84)
        ver = os_name
        if ver.count(".") > 1:
            ver = ver[:ver.rindex(".")]
        url = url % ver
    if not url.startswith("file://"):
        log.warning("apk index fetch over the network needs egress; "
                    "point %s at a file:// path", _ENV_VARS[0])
        return {}
    try:
        with open(url[len("file://"):], encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        log.warning("apk index archive unreadable: %s", e)
        return {}


def _parse_command(command: str, envs: dict) -> list:
    """'apk add' package names out of one history created_by
    (apk.go:133-169)."""
    if "#(nop)" in command:
        return []
    command = command.removeprefix("/bin/sh -c")
    pkgs = []
    for chunk in command.split("&&"):
        for cmd in chunk.split(";"):
            cmd = cmd.strip()
            if not cmd.startswith("apk"):
                continue
            add = False
            for fld in cmd.split():
                if fld.startswith("-") or fld.startswith("."):
                    continue
                if fld == "add":
                    add = True
                elif add:
                    if fld.startswith("$"):
                        pkgs.extend(envs.get(fld, "").split())
                        continue
                    pkgs.append(fld)
    return pkgs


def _resolve_dependency(index: dict, name: str, seen: set) -> list:
    if name in seen:
        return []
    seen.add(name)
    archive = (index.get("Package") or {}).get(name)
    if archive is None:
        return [name]
    provide = index.get("Provide") or {}
    out = [name]
    for dep in archive.get("Dependencies") or []:
        if "=" in dep:
            dep = dep[:dep.index("=")]
        if dep.startswith("so:"):
            so_pkg = ((provide.get("SO") or {}).get(dep[3:])
                      or {}).get("Package", "")
            if so_pkg:
                out.extend(_resolve_dependency(index, so_pkg, seen))
            continue
        if dep.startswith(("pc:", "cmd:")):
            continue
        via = (provide.get("Package") or {}).get(dep)
        if via:
            out.extend(_resolve_dependency(
                index, via.get("Package", dep), seen))
            continue
        out.extend(_resolve_dependency(index, dep, seen))
    return out


def _guess_version(index: dict, names: list, created: str) -> list:
    """Newest version built no later than the layer's timestamp
    (apk.go:225-260)."""
    try:
        dt = datetime.fromisoformat(
            str(created).replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        created_unix = int(dt.timestamp())
    except ValueError:
        return []
    pkgs = []
    for name in names:
        archive = (index.get("Package") or {}).get(name)
        if archive is None:
            continue
        candidate = ""
        for version, built_at in sorted(
                (archive.get("Versions") or {}).items(),
                key=lambda kv: kv[1]):
            if built_at <= created_unix:
                candidate = version
            else:
                break
        if candidate:
            # src fields mirror name/version so the alpine driver's
            # src-version formatting can parse them (the reference
            # leaves Src* empty on history packages — apk.go:258 —
            # which makes FormatSrcVersion return "" and detection
            # silently skip every reconstructed package)
            pkgs.append(Package(name=name, version=candidate,
                                src_name=name,
                                src_version=candidate))
    return pkgs


def analyze_image_config(os_family: str, os_name: str,
                         config: dict) -> list:
    """→ [Package] from RUN history (AnalyzeImageConfig analog).
    Only the alpine analyzer exists, as in the reference."""
    if os_family not in ("", "alpine"):
        return []
    index = load_apk_index(os_name)
    if not index:
        return []
    envs = {}
    container_cfg = config.get("container_config") \
        or config.get("config") or {}
    for env in container_cfg.get("Env") or []:
        k, _, v = env.partition("=")
        envs["$" + k] = v
    uniq = {}
    for h in config.get("history") or []:
        names = _parse_command(h.get("created_by", ""), envs)
        names = [p for n in names
                 for p in _resolve_dependency(index, n, set())]
        for pkg in _guess_version(index, names,
                                  h.get("created", "")):
            uniq[pkg.name] = pkg
    return sorted(uniq.values(), key=lambda p: p.name)
