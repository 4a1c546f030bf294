"""The port's package URLs and OS drivers against the reference's:
``purl.from_string`` / ``new_package_url`` / ``oci_package_url`` over
seeded purls and packages of every type, and every ``DRIVERS`` entry's
bucket, source name, installed version, advisory gate, fixed version
and support window (at a fixed ``now``), then its whole ``detect`` on a
seeded store. Every comparison is exact equality."""

import datetime
import random
import re

import numpy as np
import pytest

import trivy_tpu.db as rdb
import trivy_tpu.detect.ospkg.drivers as rdrv
import trivy_tpu.purl as rpurl
import trivy_tpu.types as rtypes
import trivy_tpu_torch.db as tdb
import trivy_tpu_torch.detect.ospkg.drivers as tdrv
import trivy_tpu_torch.purl as tpurl
import trivy_tpu_torch.types as ttypes

PURL_TYPES = ("apk", "deb", "rpm", "maven", "npm", "pypi", "gem",
              "nuget", "composer", "golang", "cargo", "conan", "oci",
              "swift", "Generic")
PKG_TYPES = sorted(rpurl._APP_TO_PURL) + [
    "alpine", "debian", "ubuntu", "redhat", "centos", "rocky", "alma",
    "amazon", "fedora", "oracle", "opensuse.leap",
    "suse linux enterprise server", "photon", "cbl-mariner", "gradle",
    "wolfi"]
NAMES = ("lodash", "@babel/core", "Django_Rest", "org.apache:commons",
         "github.com/Foo/bar", "pear/log", "a b+c", "näme", "x%y",
         "golang.org/x/crypto", "openssl-libs", "ns/a/b/c")
VERSIONS = ("1.2.3", "1:2.3-4.el9", "v0.0.1", "2.0.0-rc.1+build",
            "1.0 beta", "3.1.2-r5", "", "1:1.12.8-14.el8_2.1")
NOW = datetime.datetime(2026, 6, 1, tzinfo=datetime.timezone.utc)


def _purls(seed: int, n: int) -> list:
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        ptype = rng.choice(PURL_TYPES)
        name = rng.choice(NAMES)
        ns = rng.choice(["", "debian", "@scope", "org.apache.logging",
                         "a/b", "Red Hat"])
        s = f"pkg:{ptype}/"
        if ns:
            s += ns.replace(" ", "%20") + "/"
        s += name.replace(" ", "%20").replace("%y", "%25y")
        v = rng.choice(VERSIONS)
        if v:
            s += "@" + v.replace(" ", "%20")
        quals = rng.sample([("arch", "x86_64"), ("distro", "debian-12"),
                            ("epoch", rng.choice(["1", "x"])),
                            ("modularitylabel", "nodejs:12:8030:229f"),
                            ("Repository_URL", "a%2Fb"), ("empty", "")],
                           rng.randint(0, 4))
        if quals:
            s += "?" + "&".join(f"{k}={v}" for k, v in quals)
        if rng.random() < 0.2:
            s += "#sub/path%20x"
        out.append(s)
    # malformed ones raise in both
    return out + ["purl:npm/x@1", "pkg:npm", "pkg:npm/", "pkg:/x",
                  "pkg:npm/a/@1", "pkg:npm//x"]


def _url_view(p) -> dict:
    return {"fields": (p.type, p.namespace, p.name, p.version,
                       list(p.qualifiers), p.subpath, p.file_path),
            "str": p.to_string(), "ref": p.bom_ref(),
            "app": p.app_type(), "os": p.is_os_pkg(),
            "pkg": p.package().to_dict()}


def _parse(mod, s: str):
    try:
        return _url_view(mod.from_string(s))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_from_string_equals_reference(seed):
    purls = _purls(seed, 300)
    got = [_parse(tpurl, s) for s in purls]
    assert got == [_parse(rpurl, s) for s in purls]
    assert sum(isinstance(g, tuple) for g in got) >= 5
    # parses are memoized; a caller mutates only its own copy
    s = "pkg:npm/lodash@1.0.0?arch=x"
    tpurl.from_string(s).qualifiers.append(("k", "v"))
    assert tpurl.from_string(s).qualifiers == [("arch", "x")]


def _package_fields(rng: random.Random) -> dict:
    return dict(
        id=rng.choice(["", "id@1"]), name=rng.choice(NAMES),
        version=rng.choice(VERSIONS).split(":")[-1],
        release=rng.choice(["", "4.el9", "r5"]),
        epoch=rng.choice([0, 0, 2]), arch=rng.choice(["", "x86_64"]),
        modularity_label=rng.choice(["", "nodejs:12:8030:229f"]),
        file_path=rng.choice(["", "app/package-lock.json"]))


@pytest.mark.parametrize("seed", [4, 5])
def test_new_package_url_equals_reference(seed):
    rng = random.Random(seed)
    seen = set()
    for k in range(400):
        ptype = PKG_TYPES[k % len(PKG_TYPES)]
        os_fields = rng.choice([
            None, {"family": "alpine", "name": "3.16.2"},
            {"family": "debian", "name": "12"},
            {"family": "suse linux enterprise server", "name": "15.4"},
            {"family": "rocky", "name": "9.2"}])
        f = _package_fields(rng)
        want = rpurl.new_package_url(
            ptype, rtypes.Package(**f),
            os=rtypes.OS(**os_fields) if os_fields else None)
        got = tpurl.new_package_url(
            ptype, ttypes.Package(**f),
            os=ttypes.OS(**os_fields) if os_fields else None)
        assert (got.to_string(), got.bom_ref(), got.type) == \
            (want.to_string(), want.bom_ref(), want.type)
        seen.add(got.type)
    assert {"apk", "deb", "rpm", "maven", "npm", "pypi", "gem", "nuget",
            "composer", "golang", "cargo", "conan"} <= seen


def test_oci_package_url_equals_reference():
    digests = [[], ["alpine@sha256:" + "a" * 64],
               ["ghcr.io/org/app:1.0@sha256:" + "b" * 64],
               ["localhost:5000/x@sha256:" + "c" * 64],
               ["user/repo@sha256:" + "d" * 64], ["bad-digest"],
               ["x@md5:00"]]
    for d in digests:
        for arch in ("", "amd64"):
            try:
                want = rpurl.oci_package_url(d, arch).to_string()
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    tpurl.oci_package_url(d, arch)
                continue
            assert tpurl.oci_package_url(d, arch).to_string() == want


# --- OS drivers ------------------------------------------------------

OS_VERSIONS = ("3.16.2", "3.9", "edge", "12", "11.7", "22.04", "18.04",
               "9.2", "8.4.2105", "7", "6", "2", "2 (Karoo)",
               "2022 (Amazon Linux)", "1", "15.4", "42.3", "1.0.20220122",
               "2.0", "3.0", "4.0", "")


def _pkg_fields(rng: random.Random) -> dict:
    return dict(
        id=rng.choice(["", "p@1"]),
        name=rng.choice(["openssl", "npm", "kernel", "glibc"]),
        version=rng.choice(["1.2.3", "2.0", "1.1.1k"]),
        release=rng.choice(["", "1.el8", "4.module_el8.3.0+1",
                            "2.el9_2.ksplice1", "r5"]),
        epoch=rng.choice([0, 0, 1]),
        arch=rng.choice(["", "x86_64", "noarch", "aarch64"]),
        src_name=rng.choice(["", "openssl-src"]),
        src_version=rng.choice(["", "1.2.3"]),
        src_release=rng.choice(["", "1"]), src_epoch=rng.choice([0, 2]),
        modularity_label=rng.choice(["", "", "nodejs:12:8030:229f",
                                     "nodejs:12"]),
        build_info=rng.choice([None, {}, {"ContentSets": ["rhel-8-a"]},
                               {"ContentSets": [], "Nvr": "ubi8-8.4-1",
                                "Arch": "x86_64"}]))


def _adv_dict(rng: random.Random) -> dict:
    d = {"FixedVersion": rng.choice(["", "1.2.4", "0:1.2.4-1.el8",
                                     "1.2.4-1.el8.ksplice1",
                                     "2:1.0-1"]),
         "Severity": rng.choice([0, 1, 3, 7])}
    if rng.random() < 0.4:
        d["Arches"] = rng.sample(["x86_64", "aarch64", "noarch"], 2)
    if rng.random() < 0.4:
        d["ContentSets"] = rng.sample(
            ["rhel-8-a", "rhel-8-for-x86_64-baseos-rpms",
             "rhel-7-server-rpms", "ubi8-8.4-1-x86_64"], 2)
    return d


@pytest.mark.parametrize("family", sorted(rdrv.DRIVERS))
def test_driver_methods_equal_reference(family):
    rd, td = rdrv.DRIVERS[family], tdrv.DRIVERS[family]
    assert type(td).__name__ == type(rd).__name__
    assert (td.family, td.grammar, td.bucket_fmt, td.severity_source,
            td.report_unfixed, td.eol) == \
        (rd.family, rd.grammar, rd.bucket_fmt, rd.severity_source,
         rd.report_unfixed, rd.eol)
    rng = random.Random(family)
    for os_ver in OS_VERSIONS:
        for repo in (None, ("alpine", "3.15")):
            rrepo = rtypes.Repository(*repo) if repo else None
            trepo = ttypes.Repository(*repo) if repo else None
            assert td.bucket(os_ver, trepo) == rd.bucket(os_ver, rrepo)
        assert td.eol_key(os_ver) == rd.eol_key(os_ver)
        for now in (NOW, datetime.datetime(2040, 1, 1,
                                           tzinfo=datetime.timezone.utc)):
            assert td.is_supported(os_ver, now=now) == \
                rd.is_supported(os_ver, now=now)
    for _ in range(200):
        f = _pkg_fields(rng)
        rp, tp = rtypes.Package(**f), ttypes.Package(**f)
        vid, ad = f"CVE-{rng.randint(0, 99)}", _adv_dict(rng)
        ra = rdb.Advisory.from_dict(vid, ad)
        ta = tdb.Advisory.from_dict(vid, ad)
        os_ver = rng.choice(OS_VERSIONS)
        assert (td.src_name(tp), td.installed(tp), td.fixed_version(ta),
                td.adv_match(os_ver, tp, ta)) == \
            (rd.src_name(rp), rd.installed(rp), rd.fixed_version(ra),
             rd.adv_match(os_ver, rp, ra))


def _os_store(db_mod, seed: int):
    rng = np.random.default_rng(seed)
    store = db_mod.AdvisoryStore()
    buckets = ("alpine 3.16", "debian 12", "ubuntu 22.04", "rocky 9",
               "Red Hat", "amazon linux 2", "Oracle Linux 8",
               "CBL-Mariner 2.0", "Photon OS 4.0")
    for b in buckets:
        store.put_data_source(b, {"ID": b.split()[0].lower(), "Name": b})
        for p in range(6):
            for k in range(3):
                vid = f"CVE-2024-{len(store.vulnerabilities):04d}"
                v = {"Severity": int(rng.integers(0, 5))}
                if rng.random() < 0.85:
                    v["FixedVersion"] = (
                        f"{int(rng.integers(0, 3))}."
                        f"{int(rng.integers(0, 4))}-{int(rng.integers(1, 4))}"
                        + (".el8" if "Red" in b else ""))
                if rng.random() < 0.2:
                    v["Arches"] = ["x86_64"]
                store.put_advisory(b, f"pkg{p}", vid, v)
                store.put_vulnerability(vid, {"Title": vid})
    return store


@pytest.mark.parametrize("family,os_ver", [
    ("alpine", "3.16.2"), ("debian", "12.1"), ("ubuntu", "22.04"),
    ("rocky", "9.2"), ("redhat", "8.4"), ("centos", "7.9.2009"),
    ("amazon", "2 (Karoo)"), ("oracle", "8.6"), ("cbl-mariner", "2.0.1"),
    ("photon", "4.0")])
def test_ospkg_detect_equals_reference(family, os_ver):
    rstore, tstore = _os_store(rdb, 3), _os_store(tdb, 3)
    rng = random.Random(family)
    rpkgs, tpkgs = [], []
    for p in range(6):
        for _ in range(2):
            f = dict(name=f"pkg{p}", src_name=f"pkg{p}",
                     version=f"{rng.randint(0, 2)}.{rng.randint(0, 3)}",
                     release=str(rng.randint(1, 3)),
                     src_version=f"{rng.randint(0, 2)}.{rng.randint(0, 3)}",
                     src_release=str(rng.randint(1, 3)),
                     arch=rng.choice(["x86_64", "noarch", "aarch64"]))
            rpkgs.append(rtypes.Package(**f))
            tpkgs.append(ttypes.Package(**f))
    want, weosl = rdrv.ospkg_detect(family, os_ver, None, rpkgs, rstore)
    got, geosl = tdrv.ospkg_detect(family, os_ver, None, tpkgs, tstore)
    assert [v.to_dict() for v in got] == [v.to_dict() for v in want]
    assert geosl == weosl
    with pytest.raises(KeyError):
        tdrv.ospkg_detect("plan9", "1", None, tpkgs, tstore)
