"""Distro drivers: bucket lookup + fixed-version comparison.

Shapes mirror pkg/detector/ospkg/*: each driver knows its trivy-db
bucket naming, version grammar, OS-version normalization, EOL table,
and unfixed-advisory policy. Installed versions format as
``[epoch:]version[-release]`` from the SOURCE package fields
(pkg/scanner/utils/utils.go:15-28).
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass
from typing import Optional

from ...types import DetectedVulnerability, Vulnerability
from ...types.common import SEVERITIES
from ...types.common import format_evr as format_version  # noqa: F401
from ...types.common import format_src_version  # noqa: F401
from ...vercmp import get_comparer

log = logging.getLogger("trivy_tpu_torch.detect.ospkg")


def _severity_name(value: int) -> str:
    if 0 <= value < len(SEVERITIES):
        return str(SEVERITIES[value])
    return "UNKNOWN"


@dataclass
class Driver:
    """One distro scanner. Subclasses/instances configure behavior."""

    family: str
    grammar: str
    bucket_fmt: str                  # e.g. "alpine {ver}"
    severity_source: str = ""        # set per-pkg severity when given
    report_unfixed: bool = True
    eol: dict = None                 # os_ver → date

    # --- version normalization hooks ---

    def normalize_ver(self, os_ver: str) -> str:
        return os_ver

    def bucket(self, os_ver: str, repo) -> str:
        return self.bucket_fmt.format(ver=self.normalize_ver(os_ver))

    def src_name(self, pkg) -> str:
        return pkg.src_name or pkg.name

    def installed(self, pkg) -> str:
        return format_src_version(pkg)

    def adv_match(self, os_ver: str, pkg, adv) -> bool:
        """Per-driver candidate gate, applied host-side before
        interval jobs dispatch (and in the plain detect loop).
        Default: the per-advisory arch lists."""
        return arch_match(pkg, adv)

    def fixed_version(self, adv) -> str:
        """Reported FixedVersion; drivers that normalize it through
        their version grammar override (mariner.go:68-70)."""
        return adv.fixed_version

    # --- main loop (mirrors e.g. debian.go:85-140) ---

    def detect(self, store, os_ver: str, repo, pkgs: list) -> list:
        comparer = get_comparer(self.grammar)
        bucket = self.bucket(os_ver, repo)
        vulns = []
        for pkg in pkgs:
            installed = self.installed(pkg)
            try:
                installed_key = comparer.parse(installed)
            except ValueError as e:
                log.debug("installed version parse error: %s", e)
                continue
            for adv in store.get(bucket, self.src_name(pkg)):
                if not self.adv_match(os_ver, pkg, adv):
                    continue
                if not self._is_vulnerable(comparer, installed_key,
                                           adv):
                    continue
                v = DetectedVulnerability(
                    vulnerability_id=adv.vulnerability_id,
                    vendor_ids=adv.vendor_ids,
                    pkg_id=pkg.id,
                    pkg_name=pkg.name,
                    installed_version=installed,
                    fixed_version=self.fixed_version(adv),
                    layer=pkg.layer,
                    ref=pkg.ref,
                    data_source=adv.data_source,
                )
                if self.severity_source and adv.severity:
                    v.severity_source = self.severity_source
                    v.vulnerability = Vulnerability(
                        severity=_severity_name(adv.severity))
                vulns.append(v)
        return vulns

    def _is_vulnerable(self, comparer, installed_key, adv) -> bool:
        # Alpine AffectedVersion: version that introduced the vuln
        if adv.affected_version:
            try:
                if comparer.parse(adv.affected_version)\
                        > installed_key:
                    return False
            except ValueError as e:
                log.debug("affected version parse error: %s", e)
                return False
        if adv.fixed_version == "":
            return self.report_unfixed
        try:
            fixed_key = comparer.parse(adv.fixed_version)
        except ValueError as e:
            log.debug("fixed version parse error: %s", e)
            return False
        return installed_key < fixed_key

    # --- support window ---

    def eol_key(self, os_ver: str) -> str:
        """Version key for the EOL table; defaults to the bucket
        normalization but may differ (redhat.go:212-214 strips to the
        major even though its bucket is flat)."""
        return self.normalize_ver(os_ver)

    def is_supported(self, os_ver: str, now=None) -> bool:
        if not self.eol:
            return True
        eol = self.eol.get(self.eol_key(os_ver))
        if eol is None:
            return True            # may be the latest version
        now = now or datetime.datetime.now(datetime.timezone.utc)
        return now.date() <= eol


class _Alpine(Driver):
    def normalize_ver(self, os_ver: str) -> str:
        parts = os_ver.split(".")
        if len(parts) > 2:
            os_ver = ".".join(parts[:2])
        return os_ver

    def bucket(self, os_ver: str, repo) -> str:
        stream = self.normalize_ver(os_ver)
        repo_release = getattr(repo, "release", "") if repo else ""
        if repo_release and stream != repo_release:
            # prefer the repository release (alpine.go:96-104)
            stream = repo_release
        return self.bucket_fmt.format(ver=stream)


class _MajorOnly(Driver):
    def normalize_ver(self, os_ver: str) -> str:
        return os_ver.split(".")[0]


_D = datetime.date

ALPINE_EOL = {
    "2.0": _D(2012, 4, 1), "2.1": _D(2012, 11, 1),
    "2.2": _D(2013, 5, 1), "2.3": _D(2013, 11, 1),
    "2.4": _D(2014, 5, 1), "2.5": _D(2014, 11, 1),
    "2.6": _D(2015, 5, 1), "2.7": _D(2015, 11, 1),
    "3.0": _D(2016, 5, 1), "3.1": _D(2016, 11, 1),
    "3.2": _D(2017, 5, 1), "3.3": _D(2017, 11, 1),
    "3.4": _D(2018, 5, 1), "3.5": _D(2018, 11, 1),
    "3.6": _D(2019, 5, 1), "3.7": _D(2019, 11, 1),
    "3.8": _D(2020, 5, 1), "3.9": _D(2020, 11, 1),
    "3.10": _D(2021, 5, 1), "3.11": _D(2021, 11, 1),
    "3.12": _D(2022, 5, 1), "3.13": _D(2022, 11, 1),
    "3.14": _D(2023, 5, 1), "3.15": _D(2023, 11, 1),
    "3.16": _D(2024, 5, 23), "edge": _D(9999, 1, 1),
}

DEBIAN_EOL = {
    "1.1": _D(1997, 6, 5), "1.2": _D(1998, 6, 5),
    "1.3": _D(1999, 3, 9), "2.0": _D(2000, 3, 9),
    "2.1": _D(2000, 10, 30), "2.2": _D(2003, 7, 30),
    "3.0": _D(2006, 6, 30), "3.1": _D(2008, 3, 30),
    "4.0": _D(2010, 2, 15), "5.0": _D(2012, 2, 6),
    "6.0": _D(2016, 2, 29), "7": _D(2018, 5, 31),
    "8": _D(2020, 6, 30), "9": _D(2022, 6, 30),
    "10": _D(2024, 6, 30), "11": _D(2026, 8, 14),
    "12": _D(3000, 1, 1),
}

UBUNTU_EOL = {
    "4.10": _D(2006, 4, 30), "5.04": _D(2006, 10, 31),
    "5.10": _D(2007, 4, 13), "6.06": _D(2011, 6, 1),
    "6.10": _D(2008, 4, 25), "7.04": _D(2008, 10, 19),
    "7.10": _D(2009, 4, 18), "8.04": _D(2013, 5, 9),
    "8.10": _D(2010, 4, 30), "9.04": _D(2010, 10, 23),
    "9.10": _D(2011, 4, 29), "10.04": _D(2015, 4, 29),
    "10.10": _D(2012, 4, 10), "11.04": _D(2012, 10, 28),
    "11.10": _D(2013, 5, 9), "12.04": _D(2019, 4, 26),
    "12.10": _D(2014, 5, 16), "13.04": _D(2014, 1, 27),
    "13.10": _D(2014, 7, 17), "14.04": _D(2022, 4, 25),
    "14.10": _D(2015, 7, 23), "15.04": _D(2016, 1, 23),
    "15.10": _D(2016, 7, 22), "16.04": _D(2024, 4, 21),
    "16.10": _D(2017, 7, 20), "17.04": _D(2018, 1, 13),
    "17.10": _D(2018, 7, 19), "18.04": _D(2028, 4, 26),
    "18.10": _D(2019, 7, 18), "19.04": _D(2020, 1, 18),
    "19.10": _D(2020, 7, 17), "20.04": _D(2030, 4, 23),
    "20.10": _D(2021, 7, 22), "21.04": _D(2022, 1, 22),
    "21.10": _D(2022, 7, 22), "22.04": _D(2032, 4, 23),
    "22.10": _D(2023, 7, 20),
}


# EOL tables for the rpm families (factual constants from the
# reference detectors: amazon.go:21-26, oracle.go:22-29, alma.go:21-24,
# rocky.go:21-24, redhat.go:45-63, photon.go:18-25, suse.go:21-60)
AMAZON_EOL = {
    "1": _D(2023, 6, 30), "2": _D(2024, 6, 30),
    "2022": _D(3000, 1, 1),
}

ORACLE_EOL = {
    "3": _D(2011, 12, 31), "4": _D(2013, 12, 31),
    "5": _D(2017, 12, 31), "6": _D(2021, 3, 21),
    "7": _D(2024, 7, 23), "8": _D(2029, 7, 18),
    "9": _D(2032, 7, 18),
}

ALMA_EOL = {"8": _D(2029, 3, 1), "9": _D(2032, 5, 31)}

ROCKY_EOL = {"8": _D(2029, 5, 31), "9": _D(2032, 5, 31)}

REDHAT_EOL = {
    "4": _D(2017, 5, 31), "5": _D(2020, 11, 30),
    "6": _D(2024, 6, 30), "7": _D(3000, 1, 1),
    "8": _D(3000, 1, 1), "9": _D(3000, 1, 1),
}

CENTOS_EOL = {
    "3": _D(2010, 10, 31), "4": _D(2012, 2, 29),
    "5": _D(2017, 3, 31), "6": _D(2020, 11, 30),
    "7": _D(2024, 6, 30), "8": _D(2021, 12, 31),
}

PHOTON_EOL = {
    "1.0": _D(2022, 2, 28), "2.0": _D(2022, 12, 31),
    "3.0": _D(2024, 6, 30), "4.0": _D(2025, 12, 31),
}

SLES_EOL = {
    "10": _D(2007, 12, 31), "10.1": _D(2008, 11, 30),
    "10.2": _D(2010, 4, 11), "10.3": _D(2011, 10, 11),
    "10.4": _D(2013, 7, 31), "11": _D(2010, 12, 31),
    "11.1": _D(2012, 8, 31), "11.2": _D(2014, 1, 31),
    "11.3": _D(2016, 1, 31), "11.4": _D(2019, 3, 31),
    "12": _D(2016, 6, 30), "12.1": _D(2017, 5, 31),
    "12.2": _D(2018, 3, 31), "12.3": _D(2019, 1, 30),
    "12.4": _D(2020, 6, 30), "12.5": _D(2024, 10, 31),
    "15": _D(2019, 12, 31), "15.1": _D(2021, 1, 31),
    "15.2": _D(2021, 12, 31), "15.3": _D(2022, 12, 31),
    "15.4": _D(2028, 12, 31),
}

OPENSUSE_EOL = {
    "42.1": _D(2017, 5, 17), "42.2": _D(2018, 1, 26),
    "42.3": _D(2019, 6, 30), "15.0": _D(2019, 12, 3),
    "15.1": _D(2020, 11, 30), "15.2": _D(2021, 11, 30),
    "15.3": _D(2022, 11, 30), "15.4": _D(2023, 11, 30),
}


def add_modular_namespace(name: str, label: str) -> str:
    """redhat.go:240-251: "npm" + "nodejs:12:8030...:229f..." →
    "nodejs:12::npm" — module streams get their own advisory keys.
    Accepts short "name:stream" labels too (the reference needs two
    colons and drops those; real labels have four fields either way).
    """
    parts = label.split(":")
    if len(parts) >= 2 and parts[0] and parts[1]:
        return f"{parts[0]}:{parts[1]}::{name}"
    return name


def arch_match(pkg, adv) -> bool:
    """Per-advisory arch lists gate matches; "noarch" packages match
    any (redhat.go:150-155)."""
    return not adv.arches or pkg.arch == "noarch" or \
        pkg.arch in adv.arches


DEFAULT_CONTENT_SETS = {
    # redhat.go:27-44 defaultContentSets — used when the image has
    # no root/buildinfo content manifest (plain RHEL/CentOS hosts)
    "6": ["rhel-6-server-rpms", "rhel-6-server-extras-rpms"],
    "7": ["rhel-7-server-rpms", "rhel-7-server-extras-rpms"],
    "8": ["rhel-8-for-x86_64-baseos-rpms",
          "rhel-8-for-x86_64-appstream-rpms"],
    "9": ["rhel-9-for-x86_64-baseos-rpms",
          "rhel-9-for-x86_64-appstream-rpms"],
}


class _RedHat(Driver):
    """Red Hat / CentOS (reference: pkg/detector/ospkg/redhat).

    Modular packages look up under their module stream namespace
    (redhat.go:127), per-advisory arch lists gate matches
    (redhat.go:150-155), and advisories carrying content-set lists
    only match packages whose buildinfo content sets (or NVR)
    intersect them — layered-image advisories for repositories the
    image never enabled are suppressed (redhat.go:129-138; the
    content sets travel from the root/buildinfo analyzers through
    the applier onto pkg.build_info)."""

    def bucket(self, os_ver: str, repo) -> str:
        return "Red Hat"

    def adv_match(self, os_ver: str, pkg, adv) -> bool:
        if not arch_match(pkg, adv):
            return False
        if not adv.content_sets:
            return True         # advisory applies everywhere
        info = pkg.build_info
        if info is None:        # plain host: per-major defaults
            # (redhat.go:131 — only when BuildInfo is absent, not
            # when its set list is empty)
            info = {"ContentSets":
                    DEFAULT_CONTENT_SETS.get(
                        self.eol_key(os_ver), [])}
        sets = info.get("ContentSets") or []
        if any(s in adv.content_sets for s in sets):
            return True
        nvr = info.get("Nvr")
        if nvr and info.get("Arch"):
            return f"{nvr}-{info['Arch']}" in adv.content_sets
        return False

    def src_name(self, pkg) -> str:
        # Red Hat OVAL v2 keys advisories by BINARY package name
        # (redhat.go:127 uses pkg.Name, not SrcName)
        return add_modular_namespace(pkg.name,
                                     pkg.modularity_label) \
            if pkg.modularity_label else pkg.name

    def installed(self, pkg) -> str:
        # binary EVR, not source (redhat.go:143 FormatVersion)
        return format_version(pkg.epoch, pkg.version, pkg.release)

    def eol_key(self, os_ver: str) -> str:
        # "8.4.2105" → "8" (redhat.go:212-214)
        return os_ver.split(".")[0]

    def fixed_version(self, adv) -> str:
        # redhat.go:184 fixedVersion.String()
        return _strip_zero_epoch(adv.fixed_version)


class _BinaryKeyed(Driver):
    """Families whose advisories key by BINARY package name and
    compare binary EVR (amazon.go:77,82; alma.go:76,82;
    rocky.go:76,82) — unlike debian/ubuntu/mariner which use the
    source package."""

    def src_name(self, pkg) -> str:
        return add_modular_namespace(pkg.name,
                                     pkg.modularity_label) \
            if pkg.modularity_label else pkg.name

    def installed(self, pkg) -> str:
        return format_version(pkg.epoch, pkg.version, pkg.release)


class _AlmaRocky(_MajorOnly, _BinaryKeyed):
    """Alma/Rocky: major-only bucket, and packages built from a
    module but missing their modularity label cannot be looked up
    safely — skipped (alma.go:72-75, rocky.go:72-75)."""

    def adv_match(self, os_ver: str, pkg, adv) -> bool:
        if ".module_el" in pkg.release and \
                not pkg.modularity_label:
            return False
        return super().adv_match(os_ver, pkg, adv)


def _strip_zero_epoch(v: str) -> str:
    """rpm-grammar FixedVersion normalization: Version.String()
    omits a 0 epoch (redhat.go:184, mariner.go:68-70)."""
    return v[2:] if v.startswith("0:") else v


def _ksplice(v: str) -> str:
    """The 'kspliceN' dot-component of a version/release, or ""
    (oracle.go extractKsplice lowercases before splitting)."""
    for part in v.lower().split("."):
        if part.startswith("ksplice"):
            return part
    return ""


class _Oracle(_MajorOnly, _BinaryKeyed):
    """Oracle Linux: major-only bucket, binary keying, and a
    ksplice gate — an advisory only applies when its fixed
    version's ksplice component matches the package release's
    (oracle.go:78-82). FixedVersion is reported verbatim
    (oracle.go:97)."""

    def src_name(self, pkg) -> str:
        # plain binary name — oracle.go:77 has no modular-namespace
        # handling, unlike alma/rocky/redhat
        return pkg.name

    def adv_match(self, os_ver: str, pkg, adv) -> bool:
        if _ksplice(adv.fixed_version) != _ksplice(pkg.release):
            return False
        return super().adv_match(os_ver, pkg, adv)


class _SrcNameBinaryVer(Driver):
    """photon/suse: source-name bucket lookup but BINARY EVR
    comparison (photon.go:69,74; suse.go:121,126)."""

    def installed(self, pkg) -> str:
        return format_version(pkg.epoch, pkg.version, pkg.release)


class _Amazon(_BinaryKeyed):
    def src_name(self, pkg) -> str:
        # plain binary name — amazon.go:77 has no modular-namespace
        # handling, unlike alma/rocky/redhat
        return pkg.name

    def eol_key(self, os_ver: str) -> str:
        # amazon.go IsSupportedVersion: anything that isn't stream
        # 2 maps to Amazon Linux 1 — INCLUDING 2022, whose eolDates
        # entry (year 3000) is unreachable in the reference too;
        # AL2022 is therefore reported end-of-support, quirk kept
        # for parity (amazon.go:21-26,121-126)
        ver = os_ver.split()[0] if os_ver.split() else os_ver
        return ver if ver == "2" else "1"

    def normalize_ver(self, os_ver: str) -> str:
        # bucket stream (amazon.go:68-71): the OS name carries the
        # codename ("2 (Karoo)", "2022 (Amazon Linux)"); streams
        # other than 2/2022 are Amazon Linux 1
        ver = os_ver.split()[0] if os_ver.split() else os_ver
        return ver if ver in ("2", "2022") else "1"


class _Mariner(Driver):
    """CBL-Mariner (ref pkg/detector/ospkg/mariner): version
    trimmed to major.minor ("1.0.20220122" → "1.0"), source
    package names, and FixedVersion normalized through the rpm
    grammar — a 0 epoch is dropped (mariner.go:33-35,68-70)."""

    def normalize_ver(self, os_ver: str) -> str:
        if os_ver.count(".") > 1:
            return os_ver[:os_ver.rindex(".")]
        return os_ver

    def fixed_version(self, adv) -> str:
        # mariner.go:68-70 fixedVersion.String()
        return _strip_zero_epoch(adv.fixed_version)


DRIVERS = {
    "alpine": _Alpine("alpine", "apk", "alpine {ver}",
                      report_unfixed=True, eol=ALPINE_EOL),
    "debian": _MajorOnly("debian", "deb", "debian {ver}",
                         severity_source="debian",
                         report_unfixed=True, eol=DEBIAN_EOL),
    "ubuntu": Driver("ubuntu", "deb", "ubuntu {ver}",
                     severity_source="ubuntu",
                     report_unfixed=True, eol=UBUNTU_EOL),
    "amazon": _Amazon("amazon", "rpm", "amazon linux {ver}",
                      severity_source="amazon",
                      report_unfixed=False, eol=AMAZON_EOL),
    "oracle": _Oracle("oracle", "rpm", "Oracle Linux {ver}",
                      report_unfixed=False, eol=ORACLE_EOL),
    "alma": _AlmaRocky("alma", "rpm", "alma {ver}",
                       severity_source="alma", report_unfixed=False,
                       eol=ALMA_EOL),
    "rocky": _AlmaRocky("rocky", "rpm", "rocky {ver}",
                        severity_source="rocky", report_unfixed=False,
                        eol=ROCKY_EOL),
    "redhat": _RedHat("redhat", "rpm", "Red Hat",
                      severity_source="redhat", report_unfixed=True,
                      eol=REDHAT_EOL),
    "centos": _RedHat("centos", "rpm", "Red Hat",
                      severity_source="redhat", report_unfixed=True,
                      eol=CENTOS_EOL),
    "cbl-mariner": _Mariner("cbl-mariner", "rpm",
                            "CBL-Mariner {ver}",
                            report_unfixed=True),
    # photon.go has no unfixed-advisory branch: an empty
    # FixedVersion never satisfies LessThan, so unfixed photon
    # entries are dropped by the reference — report_unfixed=False
    "photon": _SrcNameBinaryVer("photon", "rpm",
                                "Photon OS {ver}",
                                severity_source="photon",
                                report_unfixed=False,
                                eol=PHOTON_EOL),
    "opensuse.leap": _SrcNameBinaryVer(
        "opensuse.leap", "rpm", "openSUSE Leap {ver}",
        report_unfixed=False, eol=OPENSUSE_EOL),
    "suse linux enterprise server": _SrcNameBinaryVer(
        "suse linux enterprise server", "rpm",
        "SUSE Linux Enterprise {ver}", report_unfixed=False,
        eol=SLES_EOL),
}


def ospkg_detect(family: str, os_ver: str, repo, pkgs: list,
                 store) -> tuple:
    """(vulns, eosl) for one OS package set. Raises KeyError for
    unsupported families (detect.go:66-69)."""
    driver = DRIVERS.get(family.lower())
    if driver is None:
        raise KeyError(f"unsupported os family: {family}")
    vulns = driver.detect(store, os_ver, repo, pkgs)
    eosl = not driver.is_supported(os_ver)
    return vulns, eosl
