"""In-memory advisory store with trivy-db access semantics.

API mirrors the reference's ``db.Config``: ``get_advisories(prefix,
pkg_name)`` scans every bucket whose name starts with the prefix
(driver.go:83-91), ``get(bucket, pkg_name)`` reads one bucket
(ospkg drivers), ``get_vulnerability(id)`` reads the detail record
(pkg/vulnerability/vulnerability.go:44)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types import DataSource


@dataclass
class Advisory:
    """trivy-db types.Advisory — only fields the detectors consume."""

    vulnerability_id: str = ""
    fixed_version: str = ""
    affected_version: str = ""      # Alpine "introduced in"
    vulnerable_versions: list = field(default_factory=list)
    patched_versions: list = field(default_factory=list)
    unaffected_versions: list = field(default_factory=list)
    arches: list = field(default_factory=list)
    severity: int = 0               # per-source severity enum value
    vendor_ids: list = field(default_factory=list)
    data_source: Optional[DataSource] = None
    # Red Hat: repositories/NVRs this advisory applies to. Empty =
    # applies everywhere. Flattened from trivy-db redhat-oval's
    # repository→CPE-index indirection (redhat.go:129-138) onto the
    # advisory record itself; observable narrowing is the same.
    content_sets: list = field(default_factory=list)

    @classmethod
    def from_dict(cls, vuln_id: str, d: dict) -> "Advisory":
        ds = d.get("DataSource")
        return cls(
            vulnerability_id=vuln_id,
            fixed_version=d.get("FixedVersion", ""),
            affected_version=d.get("AffectedVersion", ""),
            vulnerable_versions=list(d.get("VulnerableVersions") or []),
            patched_versions=list(d.get("PatchedVersions") or []),
            unaffected_versions=list(d.get("UnaffectedVersions") or []),
            arches=list(d.get("Arches") or []),
            severity=int(d.get("Severity", 0) or 0),
            vendor_ids=list(d.get("VendorIDs") or []),
            data_source=DataSource(
                id=ds.get("ID", ""), name=ds.get("Name", ""),
                url=ds.get("URL", "")) if ds else None,
            content_sets=list(d.get("ContentSets") or []),
        )


@dataclass
class VulnerabilityDetail:
    """trivy-db ``vulnerability`` bucket record."""

    id: str = ""
    title: str = ""
    description: str = ""
    severity: str = ""
    vendor_severity: dict = field(default_factory=dict)
    cvss: dict = field(default_factory=dict)
    cwe_ids: list = field(default_factory=list)
    references: list = field(default_factory=list)
    published_date: str = ""
    last_modified_date: str = ""

    @classmethod
    def from_dict(cls, vuln_id: str, d: dict) -> "VulnerabilityDetail":
        sev = d.get("Severity", "")
        if isinstance(sev, int):
            from ..types import SEVERITIES
            sev = str(SEVERITIES[sev]) if 0 <= sev < 5 else ""
        return cls(
            id=vuln_id,
            title=d.get("Title", ""),
            description=d.get("Description", ""),
            severity=sev,
            vendor_severity=dict(d.get("VendorSeverity") or {}),
            cvss=dict(d.get("CVSS") or {}),
            cwe_ids=list(d.get("CweIDs") or []),
            references=list(d.get("References") or []),
            published_date=d.get("PublishedDate", ""),
            last_modified_date=d.get("LastModifiedDate", ""),
        )


class AdvisoryStore:
    """bucket name → package name → {cve id → advisory dict}."""

    def __init__(self):
        self.buckets: dict = {}
        self.vulnerabilities: dict = {}
        self.data_sources: dict = {}
        self._adv_cache: dict = {}      # (bucket, pkg) → [Advisory]
        self._detail_cache: dict = {}   # vuln id → detail
        self._cpe_names = None          # index → [repo/nvr names]
        # mutation epoch: the findings memo caches
        # this store's content fingerprint against it, so fixture
        # stores mutated after a scan re-fingerprint correctly
        self.mutations = 0

    # --- writes ---

    def put_advisory(self, bucket: str, pkg: str, vuln_id: str,
                     value: dict) -> None:
        self.buckets.setdefault(bucket, {}) \
            .setdefault(pkg, {})[vuln_id] = value
        self._adv_cache.pop((bucket, pkg), None)
        self.mutations += 1
        if bucket == "Red Hat CPE":
            # the CPE mapping feeds every expanded Red Hat advisory
            self._cpe_names = None
            self._adv_cache = {}

    def put_vulnerability(self, vuln_id: str, value: dict) -> None:
        self.vulnerabilities[vuln_id] = value
        self._detail_cache.pop(vuln_id, None)
        self.mutations += 1

    def put_data_source(self, bucket: str, value: dict) -> None:
        self.data_sources[bucket] = value
        self.mutations += 1
        self._adv_cache = {k: v for k, v in self._adv_cache.items()
                           if k[0] != bucket}

    # --- reads (db.Config semantics) ---

    def get(self, bucket: str, pkg_name: str) -> list:
        """Advisories for one package in one bucket. Non-dict values
        (metadata buckets like "Red Hat CPE" repo→CPE maps) are not
        advisories and are skipped. Decoded Advisory lists are
        memoized per (bucket, pkg): a 512-image fleet asks for the
        same handful of packages tens of thousands of times, and
        re-building dataclasses dominated the job-prep phase."""
        key = (bucket, pkg_name)
        cached = self._adv_cache.get(key)
        if cached is not None:
            return cached
        out = []
        for vid, v in (self.buckets.get(bucket, {})
                       .get(pkg_name, {})).items():
            if not isinstance(v, dict):
                continue
            if "Entries" in v:
                # trivy-db redhat-oval v2 record (vulnsrc
                # redhat-oval: per-entry CPE indices + CVE list)
                out.extend(self._expand_redhat(vid, v, bucket))
                continue
            adv = Advisory.from_dict(vid, v)
            if adv.data_source is None:
                adv.data_source = self._bucket_source(bucket)
            out.append(adv)
        self._adv_cache[key] = out
        return out

    def _expand_redhat(self, key: str, value: dict,
                       bucket: str) -> list:
        """redhat-oval schema → flat advisories: one per
        (entry, CVE), with the entry's Affected CPE indices
        translated back to repository/NVR names so the Red Hat
        driver's content-set narrowing applies
        (redhat.go:129-138 + trivy-db redhat-oval Get). The
        advisory key is a CVE id or an RHSA/RHBA vendor id; vendor
        keys surface as VendorIDs on each carried CVE."""
        idx_names = self._cpe_index_names()
        out = []
        for entry in value.get("Entries") or []:
            affected = []
            for i in entry.get("Affected") or []:
                try:
                    affected.append(int(i))
                except (TypeError, ValueError):
                    continue        # malformed row: skip, not crash
            sets = sorted({name for i in affected
                           for name in idx_names.get(i, [])})
            if affected and not sets:
                # indices with no known repository/NVR: keep the
                # entry narrowed (it can never match), not open
                sets = [f"cpe-index:{i}" for i in affected]
            cves = entry.get("Cves") or [{}]
            for cve in cves:
                vuln_id = cve.get("ID") or key
                out.append(Advisory(
                    vulnerability_id=vuln_id,
                    fixed_version=entry.get("FixedVersion", ""),
                    arches=list(entry.get("Arches") or []),
                    severity=int(cve.get("Severity", 0) or 0),
                    vendor_ids=[key] if key != vuln_id else [],
                    content_sets=sets,
                    data_source=self._bucket_source(bucket)))
        return out

    def _cpe_index_names(self) -> dict:
        """index → [repository/NVR names] inverted from the
        "Red Hat CPE" bucket's repository and nvr sub-buckets."""
        if self._cpe_names is None:
            inv: dict = {}
            cpe = self.buckets.get("Red Hat CPE", {})
            for sub in ("repository", "nvr"):
                for name, indices in (cpe.get(sub) or {}).items():
                    if not isinstance(indices, list):
                        continue
                    for i in indices:
                        try:
                            inv.setdefault(int(i), []).append(name)
                        except (TypeError, ValueError):
                            continue
            self._cpe_names = inv
        return self._cpe_names

    def get_advisories(self, prefix: str, pkg_name: str) -> list:
        """Prefix scan over buckets (e.g. ``pip::``) — driver.go:83."""
        out = []
        for bucket in sorted(self.buckets):
            if bucket.startswith(prefix):
                out.extend(self.get(bucket, pkg_name))
        return out

    def get_vulnerability(self, vuln_id: str)\
            -> Optional[VulnerabilityDetail]:
        """Memoized like get(): enrichment asks for the same CVE
        once per affected image across a fleet."""
        detail = self._detail_cache.get(vuln_id)
        if detail is not None:
            return detail
        v = self.vulnerabilities.get(vuln_id)
        if v is None:
            return None
        detail = VulnerabilityDetail.from_dict(vuln_id, v)
        self._detail_cache[vuln_id] = detail
        return detail

    def _bucket_source(self, bucket: str) -> Optional[DataSource]:
        d = self.data_sources.get(bucket)
        if not d:
            return None
        return DataSource(id=d.get("ID", ""), name=d.get("Name", ""),
                          url=d.get("URL", ""))
