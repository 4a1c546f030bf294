"""The port's SBOM decoders against the reference's: format sniffing,
CycloneDX JSON / XML / in-toto attestation and SPDX JSON / tag-value
decode of the documents of tests/test_sbom.py and of seeded image BOMs
(chip_smoke.make_bom), the decoded OS, packages, applications and
header compared through ``to_dict``; the SBOM artifact's blob and key;
and the CycloneDX writers on the same report. Exact equality."""

import base64
import copy
import json
import re
import xml.etree.ElementTree as ET

import pytest

import trivy_tpu.artifact.cache as rcache
import trivy_tpu.artifact.sbom as rart
import trivy_tpu.sbom as rsbom
import trivy_tpu.sbom.cyclonedx as rcdx
import trivy_tpu.sbom.spdx as rspdx
import trivy_tpu.types as rtypes
import trivy_tpu_torch.artifact.cache as tcache
import trivy_tpu_torch.artifact.sbom as tart
import trivy_tpu_torch.sbom as tsbom
import trivy_tpu_torch.sbom.cyclonedx as tcdx
import trivy_tpu_torch.sbom.spdx as tspdx
import trivy_tpu_torch.types as ttypes
from chip_smoke import SBOM_IMAGES, make_advisory_store, make_bom
from tests.test_sbom import CDX_BOM, SPDX_DOC

CDX_XML = """<?xml version="1.0"?>
<bom xmlns="http://cyclonedx.org/schema/bom/1.4" version="1"
     serialNumber="urn:uuid:1234">
  <components>
    <component bom-ref="os-ref" type="operating-system">
      <name>alpine</name><version>3.9.4</version>
    </component>
    <component bom-ref="pkg:apk/alpine/musl@1.1.20-r4" type="library">
      <name>musl</name><version>1.1.20-r4</version>
      <purl>pkg:apk/alpine/musl@1.1.20-r4</purl>
    </component>
  </components>
  <dependencies>
    <dependency ref="os-ref">
      <dependency ref="pkg:apk/alpine/musl@1.1.20-r4"/>
    </dependency>
  </dependencies>
</bom>"""

SPDX_RPM = {
    "SPDXID": "SPDXRef-DOCUMENT",
    "packages": [
        {"name": "centos", "versionInfo": "8.3",
         "SPDXID": "SPDXRef-OperatingSystem-1"},
        {"name": "dbus", "SPDXID": "SPDXRef-Package-1",
         "sourceInfo": "built package from: dbus 1:1.12.8-14.el8",
         "externalRefs": [{
             "referenceCategory": "PACKAGE-MANAGER",
             "referenceType": "purl",
             "referenceLocator": "pkg:rpm/centos/dbus@1.12.8-14.el8"}]},
    ],
    "relationships": [
        {"spdxElementId": "SPDXRef-DOCUMENT",
         "relationshipType": "DESCRIBE",
         "relatedSpdxElement": "SPDXRef-OperatingSystem-1"},
        {"spdxElementId": "SPDXRef-OperatingSystem-1",
         "relationshipType": "CONTAINS",
         "relatedSpdxElement": "SPDXRef-Package-1"},
    ],
}


def _attest(bom: dict, wrap_data: bool = True) -> bytes:
    stmt = {"predicateType": "https://cyclonedx.org/bom",
            "predicate": {"Data": bom} if wrap_data else bom}
    return json.dumps({
        "payloadType": "application/vnd.in-toto+json",
        "payload": base64.b64encode(json.dumps(stmt).encode()).decode()
    }).encode()


def _to_xml(bom: dict) -> bytes:
    """A CycloneDX JSON document as CycloneDX XML."""
    ns = "http://cyclonedx.org/schema/bom/1.4"
    root = ET.Element("bom", {"xmlns": ns, "version": "1",
                              "serialNumber": bom["serialNumber"]})

    def comp(parent, c, tag="component"):
        el = ET.SubElement(parent, tag, {"bom-ref": c["bom-ref"],
                                         "type": c["type"]})
        for key in ("name", "version", "purl"):
            if c.get(key):
                ET.SubElement(el, key).text = c[key]
        if c.get("licenses"):
            lic = ET.SubElement(el, "licenses")
            for entry in c["licenses"]:
                ET.SubElement(lic, "expression").text = entry["expression"]
        if c.get("properties"):
            props = ET.SubElement(el, "properties")
            for p in c["properties"]:
                ET.SubElement(props, "property",
                              {"name": p["name"]}).text = p["value"]

    meta = ET.SubElement(root, "metadata")
    comp(meta, bom["metadata"]["component"])
    comps = ET.SubElement(root, "components")
    for c in bom["components"]:
        comp(comps, c)
    deps = ET.SubElement(root, "dependencies")
    for d in bom["dependencies"]:
        el = ET.SubElement(deps, "dependency", {"ref": d["ref"]})
        for ref in d["dependsOn"]:
            ET.SubElement(el, "dependency", {"ref": ref})
    return ET.tostring(root, xml_declaration=True, encoding="utf-8")


def _seeded_boms() -> list:
    _, n_pkgs = make_advisory_store(5000, 7)
    out = []
    for i, image in enumerate(SBOM_IMAGES.values()):
        bom = make_bom(image, n_pkgs, 100 + i, scale=0.05)
        # a foreign tool's orphan libraries, of every purl type
        orphans = ["pkg:deb/debian/zlib@1.2.13-1", "pkg:npm/%40s/x@1.0.0",
                   "pkg:rpm/redhat/bash@1:5.1-2.el9", "pkg:gem/rack@2.2",
                   "pkg:cargo/serde@1.0", "bad purl"]
        bom["components"] += [{"bom-ref": f"o{k}", "type": "library",
                               "name": "o", "purl": p}
                              for k, p in enumerate(orphans)]
        out.append(bom)
    return out


SEEDED = _seeded_boms()


def _documents() -> list:
    """(label, bytes) of every document the decoders are held to."""
    tv = rspdx.Marshaler(timestamp="2022-01-01T00:00:00Z",
                         uuid_fn=lambda: "u1").marshal_tv(
        rtypes.Report(
            artifact_name="test", artifact_type="filesystem",
            metadata=rtypes.Metadata(os=rtypes.OS(family="alpine",
                                                  name="3.9.4")),
            results=[rtypes.Result(
                target="test", class_=rtypes.ResultClass.OSPKG,
                type="alpine",
                packages=[rtypes.Package(
                    name="musl", version="1.1.20", release="r4",
                    src_name="musl", src_version="1.1.20",
                    src_release="r4")])]))
    docs = [("cdx-json", json.dumps(CDX_BOM).encode()),
            ("cdx-xml", CDX_XML.encode()),
            ("cdx-xml-full", _to_xml(CDX_BOM)),
            ("attest", _attest(CDX_BOM)),
            ("attest-bare", _attest(CDX_BOM, wrap_data=False)),
            ("spdx-json", json.dumps(SPDX_DOC).encode()),
            ("spdx-rpm", json.dumps(SPDX_RPM).encode()),
            ("spdx-tv", tv.encode())]
    for i, bom in enumerate(SEEDED):
        docs += [(f"seeded-{i}-json", json.dumps(bom).encode()),
                 (f"seeded-{i}-xml", _to_xml(bom)),
                 (f"seeded-{i}-attest", _attest(bom))]
    return docs


DOCS = _documents()
IDS = [label for label, _ in DOCS]


def _view(decoded) -> dict:
    return {"os": decoded.os.to_dict() if decoded.os else None,
            "packages": [p.to_dict() for p in decoded.packages],
            "applications": [a.to_dict() for a in decoded.applications],
            "cyclonedx": decoded.cyclonedx, "spdx": decoded.spdx}


@pytest.mark.parametrize("label,data", DOCS, ids=IDS)
def test_sniff_and_decode_equal_reference(label, data):
    rfmt, rdec = rsbom.sniff_and_decode(data)
    tfmt, tdec = tsbom.sniff_and_decode(data)
    assert tfmt == rfmt == tsbom.detect_format(data)
    assert _view(tdec) == _view(rdec)
    assert _view(tsbom.decode(data, tfmt)) == _view(rdec)
    if label.startswith("seeded"):
        assert tdec.os is not None and tdec.packages[0].packages
        assert sum(len(a.libraries) for a in tdec.applications) > 20


@pytest.mark.parametrize("data", [
    b"hello world", b'{"a": 1}', b"<html/>", b"<not xml", b"",
    b'{"payloadType": "application/vnd.in-toto+json", "payload": "e30="}',
    json.dumps({"payloadType": "application/vnd.in-toto+json",
                "payload": "!!"}).encode()])
def test_unknown_documents_fail_alike(data):
    assert tsbom.detect_format(data) == rsbom.detect_format(data) \
        == "unknown"
    with pytest.raises(ValueError) as want:
        rsbom.sniff_and_decode(data)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tsbom.sniff_and_decode(data)


@pytest.mark.parametrize("fmt", ["cyclonedx-json", "cyclonedx-xml",
                                 "spdx-json", "spdx-tv",
                                 "attest-cyclonedx-json", "github"])
def test_decode_in_the_wrong_format_fails_alike(fmt):
    data = json.dumps(CDX_BOM).encode() if fmt != "cyclonedx-json" \
        else CDX_XML.encode()
    with pytest.raises(ValueError) as want:
        rsbom.decode(data, fmt)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tsbom.decode(data, fmt)


@pytest.mark.parametrize("label,data", DOCS[:8] + DOCS[8:11], ids=IDS[:11])
def test_sbom_artifact_blob_equals_reference(label, data, tmp_path):
    rtype, _, rblob, rid = rart.decode_to_blob(data)
    ttype, _, tblob, tid = tart.decode_to_blob(data)
    assert (ttype, tid, tblob.to_dict()) == (rtype, rid, rblob.to_dict())
    assert tart.DECODER_VERSION == rart.DECODER_VERSION
    path = tmp_path / "bom"
    path.write_bytes(data)
    rc, tc = rcache.MemoryCache(), tcache.MemoryCache()
    rref = rart.SBOMArtifact(str(path), rc).inspect()
    tref = tart.SBOMArtifact(str(path), tc).inspect()
    assert vars(tref) == vars(rref)
    assert tc.get_blob(tid).to_dict() == rc.get_blob(rid).to_dict()


def test_sbom_artifact_names_the_file_on_a_decode_error(tmp_path):
    path = tmp_path / "notbom.txt"
    path.write_text("hello")
    for mod, cache in ((rart, rcache), (tart, tcache)):
        with pytest.raises(ValueError, match="notbom.txt"):
            mod.SBOMArtifact(str(path), cache.MemoryCache()).inspect()


def test_memory_cache_equals_reference():
    caches = (rcache.MemoryCache(), tcache.MemoryCache())
    for c in caches:
        c.put_blob("b1", "one")
        c.put_blob("b1", "two")
    for key in ("b1", "b2"):
        assert caches[1].get_blob(key) == caches[0].get_blob(key)


def _report(types_mod, decoded, artifact_type: str):
    """A report listing the decoded packages, as a rescan builds it."""
    results = []
    if decoded.packages:
        results.append(types_mod.Result(
            target="img (os)", class_=types_mod.ResultClass.OSPKG,
            type=decoded.os.family if decoded.os else "",
            packages=decoded.packages[0].packages))
    for app in decoded.applications:
        results.append(types_mod.Result(
            target=app.file_path, class_=types_mod.ResultClass.LANGPKG,
            type=app.type, packages=app.libraries))
    return types_mod.Report(
        artifact_name="img", artifact_type=artifact_type,
        metadata=types_mod.Metadata(
            os=decoded.os, size=1024, image_id="sha256:1",
            repo_digests=["img@sha256:" + "e" * 64],
            diff_ids=["sha256:2"], repo_tags=["img:1"]),
        results=results, cyclonedx=decoded.cyclonedx)


@pytest.mark.parametrize("artifact_type",
                         ["container_image", "filesystem", "cyclonedx"])
@pytest.mark.parametrize("label,data", DOCS[8:14], ids=IDS[8:14])
def test_cyclonedx_marshal_equals_reference(label, data, artifact_type):
    def uuids():
        n = iter(range(10 ** 6))
        return lambda: f"u-{next(n)}"

    _, rdec = rsbom.sniff_and_decode(data)
    _, tdec = tsbom.sniff_and_decode(data)
    rrep = _report(rtypes, rdec, artifact_type)
    trep = _report(ttypes, tdec, artifact_type)
    rm = rcdx.Marshaler(app_version="v", timestamp="t", uuid_fn=uuids())
    tm = tcdx.Marshaler(app_version="v", timestamp="t", uuid_fn=uuids())
    assert tm.marshal(copy.deepcopy(trep)) == \
        rm.marshal(copy.deepcopy(rrep))
    assert tm.marshal_vulnerabilities(trep) == \
        rm.marshal_vulnerabilities(rrep)


def test_cyclonedx_marshal_stamps_time_and_serial():
    bom = tcdx.Marshaler().marshal(ttypes.Report(artifact_name="x"))
    assert re.fullmatch(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\+00:00",
                        bom["metadata"]["timestamp"])
    assert re.fullmatch(r"urn:uuid:[0-9a-f-]{36}", bom["serialNumber"])
