"""A seeded trivy-db-shaped advisory database, row by row.

The rows are those of ``chip_smoke.py``'s ``make_advisory_store`` (the
same draws in the same order, so one seed gives the same database),
split into a plan of per-bucket draws (``plan``) and one function that
spells any row out (``row``). The program's store is filled from every
row (``fill_store``); the reference spells out only the rows of the
packages it checks (``rows_of``).

OS buckets carry FixedVersion (about 5 % unfixed, some alpine rows an
AffectedVersion); library buckets carry GHSA-shaped
VulnerableVersions/PatchedVersions, 2.5 % of them with six
alternatives. Every advisory has a vulnerability record and every
bucket a data source.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# (bucket, grammar, share of the rows, does its distro report unfixed)
VULN_OS = (("alpine 3.16", "apk", 0.06, True),
           ("debian 12", "deb", 0.22, True),
           ("ubuntu 22.04", "deb", 0.22, True),
           ("rocky 9", "rpm", 0.10, False))
# (bucket, ecosystem, grammar, share of the rows)
VULN_LIBS = (("npm::GitHub Security Advisory npm", "npm", "npm", 0.12),
             ("pip::GitHub Security Advisory pip", "pip", "pep440", 0.08),
             ("maven::GitHub Security Advisory Maven", "maven", "maven",
              0.08),
             ("rubygems::GitHub Security Advisory RubyGems", "rubygems",
              "rubygems", 0.04),
             ("go::GitHub Security Advisory Go", "go", "semver", 0.08))


def os_version(grammar: str, bucket: str, a: int, b: int, c: int,
               r: int) -> str:
    if grammar == "apk":
        return f"{a}.{b}.{c}-r{r}"
    if grammar == "rpm":
        return f"{a}.{b}.{c}-{r}.el9" if r % 4 else f"1:{a}.{b}.{c}-{r}.el9_2"
    if bucket.startswith("ubuntu"):
        return f"{a}.{b}.{c}-{r}ubuntu0.{c % 3}"
    return f"{a}.{b}.{c}-{r}" if r % 5 else f"1:{a}.{b}.{c}+dfsg-{r}"


def pkg_major(p: int) -> int:
    return p % 7


def installed_version(grammar: str, bucket: str, p: int, k: int) -> str:
    """Variant ``k`` (0-3) of package ``p``'s installed version: four per
    package, so a fleet repeats (package, version) pairs."""
    a, b, c = pkg_major(p), (p * 31 + k * 7) % 20, (p * 17 + k * 3) % 20
    if grammar in ("apk", "deb", "rpm"):
        return os_version(grammar, bucket, a, b, c, 1 + k)
    v = f"{a}.{b}.{c}"
    if grammar == "npm" and (p + k) % 20 == 0:
        return v + "-beta.1"          # a prerelease: the exact host path
    return "v" + v if grammar == "semver" else v


@dataclass
class BucketPlan:
    bucket: str
    grammar: str
    kind: str              # "os" or "lib"
    vid0: int              # global index of the bucket's first row
    quota: int             # rows
    ends: np.ndarray       # row index past each package's last row
    nums: np.ndarray       # [quota, 4] the version digits
    roll: np.ndarray       # [quota] the shape draw
    sev: np.ndarray        # [quota] the OS severity

    @property
    def n_pkgs(self) -> int:
        return int(np.searchsorted(self.ends, self.quota - 1,
                                   side="right")) + 1

    def pkg_rows(self, p: int) -> range:
        start = int(self.ends[p - 1]) if p else 0
        return range(start, min(int(self.ends[p]), self.quota))


def plan(n_rows: int, seed: int) -> list:
    """The per-bucket draws of ``n_rows`` advisories under ``seed``."""
    rng = np.random.default_rng(seed)
    order = [(b, g, s, "os") for b, g, s, _ in VULN_OS] + \
        [(b, g, s, "lib") for b, _, g, s in VULN_LIBS]
    out, vid = [], 0
    for bucket, grammar, share, kind in order:
        quota = int(n_rows * share) if bucket != order[-1][0] \
            else n_rows - vid
        per_pkg = rng.geometric(0.25, quota)
        nums = rng.integers(0, 20, (quota, 4))
        roll = rng.random(quota)
        sev = rng.integers(0, 5, quota)
        out.append(BucketPlan(bucket, grammar, kind, vid, quota,
                              np.cumsum(per_pkg), nums, roll, sev))
        vid += quota
    return out


def n_pkgs_of(plans: list) -> dict:
    """{bucket: number of packages with advisories}."""
    return {bp.bucket: bp.n_pkgs for bp in plans}


def data_source(bp: BucketPlan) -> dict:
    eco = bp.bucket.split("::")[0] if bp.kind == "lib" \
        else bp.bucket.split()[0]
    return {"ID": "ghsa" if bp.kind == "lib" else eco, "Name": bp.bucket,
            "URL": f"https://advisories.example/{eco}"}


def row(bp: BucketPlan, i: int, p: int) -> tuple:
    """(package name, CVE id, advisory value) of the bucket's row ``i``,
    which belongs to package ``p``."""
    vid = bp.vid0 + i
    a = pkg_major(p)
    b, c, b2, c2 = (int(x) for x in bp.nums[i])
    roll = float(bp.roll[i])
    name = f"{bp.kind}-{bp.grammar}-{p}"
    cve = f"CVE-{2000 + vid % 24}-{vid:07d}"
    if bp.kind == "os":
        value = {"Severity": int(bp.sev[i])}
        if roll >= 0.05:
            value["FixedVersion"] = os_version(
                bp.grammar, bp.bucket, a, b, c, 1 + c2 % 4)
        if bp.grammar == "apk" and roll > 0.8:
            value["AffectedVersion"] = f"{a}.{b2 // 4}.0-r0"
        return name, cve, value
    fixed, lo = f"{a}.{b}.{c + 1}", f"{a}.{b2 // 2}.0"
    alt = f"{a + 1}.{b2}.{c2 + 1}"
    if roll < 0.4:
        vuln = [f"<{fixed}"]
    elif roll < 0.6:
        vuln = [f">={lo}, <{fixed}"]
    elif roll < 0.75:
        vuln = [f">= {lo}", f"<= {fixed}"]
    elif roll < 0.9:
        vuln = [f"<{fixed}", f">={fixed}, <{alt}"]
    elif roll < 0.975:
        vuln = [f"={fixed}"]
    else:
        vuln = [f"={a}.{j}.{c}" for j in range(6)]
    value = {"VulnerableVersions": vuln}
    if roll < 0.9:
        value["PatchedVersions"] = [f">={fixed}"]
    return name, cve, value


def detail(name: str, cve: str, vid: int) -> dict:
    """The vulnerability record of the row with global index ``vid``."""
    out = {"Title": f"{name}: issue {vid}",
           "Severity": ("LOW", "MEDIUM", "HIGH", "CRITICAL")[vid % 4],
           "VendorSeverity": {"nvd": 1 + vid % 4},
           "References": [f"https://nvd.example/{cve}"]}
    if vid % 4 == 0:
        out.update(
            CweIDs=[f"CWE-{20 + vid % 700}"],
            CVSS={"nvd": {"V3Vector": "CVSS:3.1/AV:N/AC:L/PR:N/"
                          "UI:N/S:U/C:H/I:H/A:H",
                          "V3Score": 5.0 + vid % 50 / 10}},
            PublishedDate=f"20{10 + vid % 14}-0{1 + vid % 9}-"
                          f"1{vid % 10}T00:00:00Z")
    return out


def fill_store(store, plans: list) -> None:
    """Every row into ``store`` (any object with the ``AdvisoryStore``
    writes ``put_data_source``, ``put_advisory``,
    ``put_vulnerability``)."""
    for bp in plans:
        store.put_data_source(bp.bucket, data_source(bp))
        p = 0
        for i in range(bp.quota):
            while i >= bp.ends[p]:
                p += 1
            name, cve, value = row(bp, i, p)
            store.put_advisory(bp.bucket, name, cve, value)
            store.put_vulnerability(cve, detail(name, cve, bp.vid0 + i))


def rows_of(plans: list, bucket: str, p: int) -> list:
    """[(CVE id, advisory value)] of package ``p`` in ``bucket``."""
    for bp in plans:
        if bp.bucket == bucket:
            if p >= bp.n_pkgs:
                return []
            return [row(bp, i, p)[1:] for i in bp.pkg_rows(p)]
    return []
