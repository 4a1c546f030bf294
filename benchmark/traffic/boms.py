"""Seeded CycloneDX 1.4 BOMs as an image scan writes them.

A copy of ``chip_smoke.py``'s ``make_bom`` that draws from a given
``rng`` and also returns what it wrote: the truth the reference checks
the program's findings against.
"""

from __future__ import annotations

from .advisories import installed_version
from .trees import zipf_unique


def _prop(name: str, value: str) -> dict:
    return {"name": "aquasecurity:trivy:" + name, "value": value}


def make_bom(shape: dict, n_pkgs: dict, rng, serial: int) -> tuple:
    """(a CycloneDX 1.4 JSON document, its truth) of ``shape`` (a
    ``boms`` entry of a workload: ``family``, ``version``, ``bucket``,
    ``grammar``, ``purl_type``, ``os_packages``, ``apps``): one
    operating-system component with its packages (source package
    properties, distro purls) and one application component per
    lockfile with its libraries, all on the dependency graph. The
    truth is {"os": [(name, version, p)], "apps": [(app type, path,
    bucket, grammar, [(name, version, p)])]}."""
    family, os_ver = shape["family"], shape["version"]
    bucket, grammar, ptype = shape["bucket"], shape["grammar"], \
        shape["purl_type"]
    comps, deps = [], []
    os_refs, os_pkgs = [], []
    for p in zipf_unique(rng, n_pkgs[bucket], shape["os_packages"]):
        name = f"os-{grammar}-{p}"
        ver = installed_version(grammar, bucket, p, int(rng.integers(0, 4)))
        os_pkgs.append((name, ver, p))
        epoch, _, rest = ver.rpartition(":")
        version, _, release = rest.rpartition("-")
        quals = f"arch={'amd64' if ptype == 'deb' else 'x86_64'}" \
            f"&distro={family}-{os_ver}"
        props = [_prop("PkgID", f"{name}@{ver}"),
                 _prop("SrcName", name), _prop("SrcVersion", version),
                 _prop("SrcRelease", release),
                 _prop("LayerDiffID", f"sha256:{p % 7:064x}")]
        if epoch:
            props.insert(4, _prop("SrcEpoch", epoch))
        if ptype == "rpm":
            purl = f"pkg:rpm/{family}/{name}@{rest}?{quals}" + \
                (f"&epoch={epoch}" if epoch else "")
        else:
            purl = f"pkg:{ptype}/{family}/{name}@{ver}?{quals}"
        comp = {"bom-ref": purl, "type": "library", "name": name,
                "version": ver, "purl": purl, "properties": props}
        if p % 3 == 0:
            comp["licenses"] = [{"expression": "GPL-2.0-or-later"}]
        comps.append(comp)
        os_refs.append(purl)
    comps.append({"bom-ref": "os", "type": "operating-system",
                  "name": family, "version": os_ver,
                  "properties": [_prop("Class", "os-pkgs"),
                                 _prop("Type", family)]})
    deps.append({"ref": "os", "dependsOn": os_refs})
    truth = {"os": os_pkgs, "apps": []}
    for i, app in enumerate(shape["apps"]):
        refs, libs = [], []
        agrammar, abucket = app["grammar"], app["bucket"]
        for p in zipf_unique(rng, n_pkgs[abucket], app["packages"]):
            name = f"lib-{agrammar}-{p}"
            ver = installed_version(agrammar, abucket, p,
                                    int(rng.integers(0, 4)))
            libs.append((name, ver, p))
            purl = f"pkg:{app['purl_type']}/{name}@{ver}"
            comps.append({"bom-ref": purl, "type": "library",
                          "name": name, "version": ver, "purl": purl,
                          "licenses": [{"expression": "MIT"}]})
            refs.append(purl)
        truth["apps"].append((app["type"], app["path"], abucket, agrammar,
                              libs))
        comps.append({"bom-ref": f"app-{i}", "type": "application",
                      "name": app["path"],
                      "properties": [_prop("Class", "lang-pkgs"),
                                     _prop("Type", app["type"])]})
        deps.append({"ref": f"app-{i}", "dependsOn": refs})
    root = f"image-{family}-{serial}"
    deps.append({"ref": root,
                 "dependsOn": ["os"] + [f"app-{i}"
                                        for i in range(len(shape["apps"]))]})
    doc = {"bomFormat": "CycloneDX", "specVersion": "1.4",
           "serialNumber": "urn:uuid:00000000-0000-4000-8000-"
                           f"{serial % 10 ** 12:012d}",
           "version": 1,
           "metadata": {"timestamp": "2026-10-16T00:00:00+00:00",
                        "component": {"bom-ref": root,
                                      "type": "container",
                                      "name": f"{family}:{os_ver}-app",
                                      "properties": [
                                          _prop("SchemaVersion", "2")]}},
           "components": comps, "dependencies": deps}
    return doc, truth
