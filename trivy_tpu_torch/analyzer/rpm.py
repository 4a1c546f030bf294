"""RPM package analyzers (reference:
pkg/fanal/analyzer/pkg/rpm/rpm.go:30-166 + rpmqa.go).

``RpmDBAnalyzer`` parses the installed-package database in any of
rpm's three backend formats (Berkeley DB / SQLite / NDB) via
``rpmdb/``; ``RpmQaAnalyzer`` parses the pre-generated
``rpm -qa``-style manifests distroless images carry.
"""

from __future__ import annotations

import logging

from ..types import Package, PackageInfo
from .analyzer import AnalysisResult, Analyzer, register_analyzer

log = logging.getLogger("trivy_tpu_torch.analyzer.rpm")

REQUIRED_PATHS = {
    # Berkeley DB
    "usr/lib/sysimage/rpm/Packages",
    "var/lib/rpm/Packages",
    # NDB
    "usr/lib/sysimage/rpm/Packages.db",
    "var/lib/rpm/Packages.db",
    # SQLite
    "usr/lib/sysimage/rpm/rpmdb.sqlite",
    "var/lib/rpm/rpmdb.sqlite",
}

# vendors whose files are system-owned (rpm.go:48-61)
OS_VENDORS = (
    "Amazon Linux", "Amazon.com", "CentOS", "Fedora Project",
    "Oracle America", "Red Hat", "AlmaLinux", "CloudLinux",
    "VMware", "SUSE", "openSUSE", "Microsoft Corporation",
)


def _to_package(rp) -> Package:
    src_name, src_ver, src_rel = rp.src_fields
    arch = rp.arch or "None"
    return Package(
        id=f"{rp.name}@{rp.version}-{rp.release}.{rp.arch}",
        name=rp.name,
        epoch=rp.epoch,
        version=rp.version,
        release=rp.release,
        arch=arch,
        src_name=src_name,
        src_epoch=rp.epoch,   # SOURCERPM carries no epoch (rpm.go)
        src_version=src_ver,
        src_release=src_rel,
        licenses=[rp.license] if rp.license else [],
        modularity_label=rp.modularity_label,
    )


@register_analyzer
class RpmDBAnalyzer(Analyzer):
    type = "rpm"
    version = 1

    exact_paths = frozenset(REQUIRED_PATHS)

    def analyze(self, path, content):
        from ..rpmdb import list_packages
        try:
            rpkgs = list_packages(content)
        except ValueError as e:
            # a corrupt rpmdb is survivable hostile input: the scan
            # completes without rpm packages, but an image scan
            # reports status=degraded with an ingest-stage cause
            # instead of silently pretending the image has no rpm
            # database. The filesystem path has no ingest budget, so
            # there the fault is logged
            from ..guard.budget import current_budget
            b = current_budget.get()
            if b is not None:
                b.note("malformed-archive",
                       f"corrupt rpmdb at {path}: {e}")
            else:
                log.warning("corrupt rpmdb at %s: %s", path, e)
            return None
        pkgs = []
        system_files = []
        for rp in rpkgs:
            pkgs.append(_to_package(rp))
            if any(rp.vendor.startswith(v) for v in OS_VENDORS):
                system_files.extend(rp.installed_files)
        if not pkgs:
            return None
        return AnalysisResult(
            package_infos=[PackageInfo(file_path=path,
                                       packages=pkgs)],
            system_files=system_files,
        )


@register_analyzer
class RpmQaAnalyzer(Analyzer):
    """CBL-Mariner distroless package manifest (rpmqa.go:28-29):
    ``rpm -qa --qf "%{NAME}\\t%{VERSION}-%{RELEASE}\\t%{INSTALLTIME}
    \\t%{BUILDTIME}\\t%{VENDOR}\\t(none)\\t%{SIZE}\\t%{ARCH}
    \\t%{EPOCHNUM}\\t%{SOURCERPM}"`` — exactly 10 tab fields."""

    type = "rpmqa"
    version = 1

    _PATHS = {"var/lib/rpmmanifest/container-manifest-2"}

    exact_paths = frozenset(_PATHS)

    def analyze(self, path, content):
        from ..rpmdb.header import RpmPackage
        pkgs = []
        for line in content.decode("utf-8", "replace").splitlines():
            if not line.strip():
                continue
            fields = line.split("\t")
            if len(fields) != 10:
                continue
            name, arch, source_rpm = fields[0], fields[7], fields[9]
            ver, _, rel = fields[1].rpartition("-")
            if not ver:
                ver, rel = fields[1], ""
            try:
                epoch = int(fields[8])
            except ValueError:
                epoch = 0
            rp = RpmPackage(name=name, version=ver, release=rel,
                            epoch=epoch, arch=arch,
                            source_rpm=source_rpm)
            src_name, src_ver, src_rel = rp.src_fields
            # no package ID: the reference's rpmqa parser sets none
            # (go-dep-parser rpmqa; mariner-1.0 golden carries no
            # PkgID), unlike the rpmdb analyzer
            pkgs.append(Package(
                name=name, version=ver, release=rel, epoch=epoch,
                arch=arch, src_name=src_name, src_version=src_ver,
                src_release=src_rel, src_epoch=epoch))
        if not pkgs:
            return None
        return AnalysisResult(
            package_infos=[PackageInfo(file_path=path,
                                       packages=pkgs)])
