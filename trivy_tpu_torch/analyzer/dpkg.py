"""Debian dpkg status parser (reference:
pkg/fanal/analyzer/pkg/dpkg — var/lib/dpkg/status + status.d/*,
plus var/lib/dpkg/info/*.list system files)."""

from __future__ import annotations

import re

from ..types import Package, PackageInfo
from .analyzer import AnalysisResult, Analyzer, register_analyzer

_STATUS = "var/lib/dpkg/status"
_STATUS_DIR = "var/lib/dpkg/status.d/"
_INFO_LIST = re.compile(r"^var/lib/dpkg/info/[^/]+\.list$")

# "1:1.2.3-4" → epoch 1, upstream 1.2.3, revision 4
_VER_RE = re.compile(
    r"^(?:(?P<epoch>\d+):)?(?P<ver>[^-]+(?:-[^-]+)*?)"
    r"(?:-(?P<rev>[^-]+))?$")


def _split_version(full: str) -> tuple:
    epoch = 0
    rest = full
    if ":" in full:
        e, _, rest = full.partition(":")
        if e.isdigit():
            epoch = int(e)
    upstream, _, revision = rest.rpartition("-")
    if not upstream:
        upstream, revision = revision, ""
    return epoch, upstream, revision


@register_analyzer
class DpkgAnalyzer(Analyzer):
    type = "dpkg"
    version = 3

    def required(self, path, size=None):
        return (path == _STATUS or path.startswith(_STATUS_DIR)
                or _INFO_LIST.match(path) is not None)

    def analyze(self, path, content):
        if _INFO_LIST.match(path):
            files = [line for line in
                     content.decode("utf-8", "replace").splitlines()
                     if line and line != "/."]
            return AnalysisResult(system_files=files)
        pkgs = self._parse_status(content)
        if not pkgs:
            return None
        return AnalysisResult(package_infos=[
            PackageInfo(file_path=path, packages=pkgs)])

    def _parse_status(self, content: bytes) -> list:
        pkgs = []
        for para in content.decode("utf-8", "replace")\
                .split("\n\n"):
            fields = self._fields(para)
            if not fields.get("Package"):
                continue
            status = fields.get("Status", "")
            if status and "installed" not in status.split():
                continue
            full_ver = fields.get("Version", "")
            if not full_ver:
                continue
            epoch, upstream, revision = _split_version(full_ver)

            src_name = fields.get("Source", "")
            src_ver = full_ver
            if src_name:
                # "Source: glibc (2.28-10)" carries its own version
                m = re.match(r"^(\S+)(?:\s+\((.+)\))?$", src_name)
                if m:
                    src_name = m.group(1)
                    if m.group(2):
                        src_ver = m.group(2)
            else:
                src_name = fields["Package"]
            s_epoch, s_up, s_rev = _split_version(src_ver)

            pkg = Package(
                id=f"{fields['Package']}@{full_ver}",
                name=fields["Package"],
                version=upstream,
                epoch=epoch,
                release=revision,
                arch=fields.get("Architecture", ""),
                src_name=src_name,
                src_version=s_up,
                src_release=s_rev,
                src_epoch=s_epoch,
            )
            deps = fields.get("Depends", "")
            if deps:
                names = []
                for d in deps.split(","):
                    name = d.strip().split(" ")[0].split(":")[0]
                    if name:
                        names.append(name)
                pkg.depends_on = names
            pkgs.append(pkg)
        # resolve dependency names → IDs where installed
        by_name = {p.name: p.id for p in pkgs}
        for p in pkgs:
            p.depends_on = sorted({by_name[d] for d in p.depends_on
                                   if d in by_name})
        return pkgs

    @staticmethod
    def _fields(paragraph: str) -> dict:
        fields: dict = {}
        key = None
        for line in paragraph.splitlines():
            if line.startswith((" ", "\t")):
                if key:
                    fields[key] += "\n" + line.strip()
                continue
            k, sep, v = line.partition(":")
            if not sep:
                continue
            key = k.strip()
            fields[key] = v.strip()
        return fields
