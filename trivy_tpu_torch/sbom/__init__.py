"""SBOM format sniffing + decode (ref pkg/sbom/sbom.go).

``detect_format`` probes the raw bytes the same way the reference
probes the reader: CycloneDX JSON (bomFormat), CycloneDX XML (xmlns),
SPDX JSON (SPDXID), SPDX tag-value (first line), then a DSSE-enveloped
in-toto attestation carrying a CycloneDX predicate.
"""

from __future__ import annotations

import base64
import json
import xml.etree.ElementTree as ET

from .cyclonedx import DecodedSBOM
from . import cyclonedx as cdx
from . import spdx as spdx_mod

FORMAT_CYCLONEDX_JSON = "cyclonedx-json"
FORMAT_CYCLONEDX_XML = "cyclonedx-xml"
FORMAT_SPDX_JSON = "spdx-json"
FORMAT_SPDX_TV = "spdx-tv"
FORMAT_ATTEST_CYCLONEDX_JSON = "attest-cyclonedx-json"
FORMAT_UNKNOWN = "unknown"

IN_TOTO_PAYLOAD_TYPE = "application/vnd.in-toto+json"
PREDICATE_CYCLONEDX = "https://cyclonedx.org/bom"


def _sniff(data: bytes):
    """Sniff the SBOM format, returning ``(fmt, parsed)`` so decode
    never parses the same bytes twice (sbom.go:33-107). ``parsed`` is
    the json document, the XML root element, or the raw text."""
    try:
        doc = json.loads(data)
    except (ValueError, UnicodeDecodeError):
        doc = None
    if isinstance(doc, dict):
        if doc.get("bomFormat") == "CycloneDX":
            return FORMAT_CYCLONEDX_JSON, doc
        if str(doc.get("SPDXID", "")).startswith("SPDX"):
            return FORMAT_SPDX_JSON, doc
        if doc.get("payloadType") == IN_TOTO_PAYLOAD_TYPE:
            try:
                stmt = json.loads(
                    base64.b64decode(doc.get("payload", "")))
            except (ValueError, UnicodeDecodeError):
                stmt = {}
            if stmt.get("predicateType") == PREDICATE_CYCLONEDX:
                return FORMAT_ATTEST_CYCLONEDX_JSON, doc
        return FORMAT_UNKNOWN, None

    stripped = data.lstrip()
    if stripped.startswith(b"<"):
        try:
            root = ET.fromstring(data)
        except ET.ParseError:
            return FORMAT_UNKNOWN, None
        if root.tag.startswith("{http://cyclonedx.org"):
            return FORMAT_CYCLONEDX_XML, root
        return FORMAT_UNKNOWN, None

    first = data.split(b"\n", 1)[0].strip()
    if first.startswith(b"SPDX"):
        return FORMAT_SPDX_TV, data.decode("utf-8", "replace")
    return FORMAT_UNKNOWN, None


def detect_format(data: bytes) -> str:
    """Sniff the SBOM format (sbom.go:33-107)."""
    return _sniff(data)[0]


def _decode_parsed(fmt: str, parsed) -> DecodedSBOM:
    if fmt == FORMAT_CYCLONEDX_JSON:
        return cdx.unmarshal(parsed)
    if fmt == FORMAT_CYCLONEDX_XML:
        return cdx.unmarshal(_xml_to_doc(parsed))
    if fmt == FORMAT_ATTEST_CYCLONEDX_JSON:
        if parsed.get("payloadType") != IN_TOTO_PAYLOAD_TYPE:
            raise ValueError(
                f"invalid attestation payload type: "
                f"{parsed.get('payloadType')}")
        stmt = json.loads(base64.b64decode(parsed.get("payload", "")))
        predicate = stmt.get("predicate") or {}
        # cosign wraps the BOM in a custom predicate {Data: <bom>}
        bom = predicate.get("Data", predicate)
        if isinstance(bom, str):
            bom = json.loads(bom)
        return cdx.unmarshal(bom)
    if fmt == FORMAT_SPDX_JSON:
        return spdx_mod.unmarshal(parsed)
    if fmt == FORMAT_SPDX_TV:
        return spdx_mod.unmarshal(spdx_mod.parse_tag_value(parsed))
    raise ValueError(f"{fmt} scanning is not yet supported")


def decode(data: bytes, fmt: str) -> DecodedSBOM:
    """Decode SBOM bytes in the given format (sbom.go:109-148)."""
    sniffed, parsed = _sniff(data)
    if sniffed != fmt:
        raise ValueError(
            f"{fmt} scanning is not yet supported"
            if fmt not in (FORMAT_CYCLONEDX_JSON, FORMAT_CYCLONEDX_XML,
                           FORMAT_ATTEST_CYCLONEDX_JSON,
                           FORMAT_SPDX_JSON, FORMAT_SPDX_TV)
            else f"document is not {fmt} (detected {sniffed})")
    return _decode_parsed(fmt, parsed)


def sniff_and_decode(data: bytes):
    """One-pass detect + decode: ``(fmt, DecodedSBOM)``.
    Raises ValueError on unknown format."""
    fmt, parsed = _sniff(data)
    if fmt == FORMAT_UNKNOWN:
        raise ValueError("failed to detect SBOM format")
    return fmt, _decode_parsed(fmt, parsed)


def _xml_to_doc(root) -> dict:
    """CycloneDX XML root element → the dict shape the JSON decoder
    uses."""
    if isinstance(root, (bytes, str)):
        root = ET.fromstring(root)
    if not root.tag.startswith("{http://cyclonedx.org"):
        raise ValueError("not a CycloneDX XML document")
    ns = root.tag.split("}")[0] + "}"

    def text(el, tag):
        child = el.find(ns + tag)
        return child.text or "" if child is not None else ""

    def conv_component(el):
        comp = {
            "bom-ref": el.get("bom-ref", ""),
            "type": el.get("type", ""),
            "name": text(el, "name"),
            "version": text(el, "version"),
            "purl": text(el, "purl"),
        }
        lic_el = el.find(ns + "licenses")
        if lic_el is not None:
            licenses = []
            for le in lic_el:
                if le.tag == ns + "expression":
                    licenses.append({"expression": le.text or ""})
                else:
                    licenses.append({"license": {
                        "name": text(le, "name") or text(le, "id")}})
            comp["licenses"] = licenses
        props_el = el.find(ns + "properties")
        if props_el is not None:
            comp["properties"] = [
                {"name": pe.get("name", ""), "value": pe.text or ""}
                for pe in props_el.findall(ns + "property")]
        return comp

    doc = {"bomFormat": "CycloneDX",
           "specVersion": root.get("version", ""),
           "serialNumber": root.get("serialNumber", "")}
    meta_el = root.find(ns + "metadata")
    if meta_el is not None:
        mc = meta_el.find(ns + "component")
        if mc is not None:
            doc["metadata"] = {"component": conv_component(mc)}
    comps_el = root.find(ns + "components")
    if comps_el is not None:
        doc["components"] = [conv_component(c) for c in
                             comps_el.findall(ns + "component")]
    deps_el = root.find(ns + "dependencies")
    if deps_el is not None:
        doc["dependencies"] = [
            {"ref": d.get("ref", ""),
             "dependsOn": [dd.get("ref", "") for dd in
                           d.findall(ns + "dependency")]}
            for d in deps_el.findall(ns + "dependency")]
    return doc
