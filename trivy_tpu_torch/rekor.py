"""Rekor transparency-log client (reference: pkg/rekor/client.go).

Searches the log by artifact sha256 and fetches entries whose
attestations carry SBOMs (the reference uses this to discover SBOM
attestations for bare executables). HTTP against the Rekor REST API
(``/api/v1/index/retrieve`` + ``/api/v1/log/entries/retrieve``);
in this zero-egress build the default endpoint fails with a clean
error and tests drive the same code against a local fake server.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from dataclasses import dataclass

import logging

log = logging.getLogger("trivy_tpu_torch.rekor")

DEFAULT_URL = "https://rekor.sigstore.dev"
MAX_GET_ENTRIES = 10       # client.go MaxGetEntriesLimit

_TREE_ID_LEN = 16
_UUID_LEN = 64


class RekorError(RuntimeError):
    pass


@dataclass
class EntryID:
    tree_id: str = ""
    uuid: str = ""

    @classmethod
    def parse(cls, raw: str) -> "EntryID":
        """client.go:33-46: 80 hex chars = treeID+uuid, 64 = uuid."""
        if len(raw) == _TREE_ID_LEN + _UUID_LEN:
            return cls(tree_id=raw[:_TREE_ID_LEN],
                       uuid=raw[_TREE_ID_LEN:])
        if len(raw) == _UUID_LEN:
            return cls(uuid=raw)
        raise RekorError(f"invalid Entry ID length: {raw!r}")

    def __str__(self) -> str:
        return self.tree_id + self.uuid


@dataclass
class Entry:
    statement: bytes = b""


class Client:
    def __init__(self, url: str = DEFAULT_URL,
                 timeout_s: float = 30.0):
        self.base_url = url.rstrip("/")
        self.timeout_s = timeout_s

    def _call(self, method: str, path: str, body=None) -> object:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode() if body is not None
            else None,
            method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"null")
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise RekorError(
                f"rekor request failed (network egress needed for "
                f"{self.base_url}): {e}")

    def search(self, hash_: str) -> list:
        """sha256 → entry ids (client.go:73-90 Search)."""
        payload = self._call("POST", "/api/v1/index/retrieve",
                             {"hash": hash_})
        return [EntryID.parse(raw) for raw in payload or []]

    def get_entries(self, entry_ids: list) -> list:
        """entry ids → attestation statements (client.go:92-)."""
        if len(entry_ids) > MAX_GET_ENTRIES:
            raise RekorError(
                f"over get entries limit ({MAX_GET_ENTRIES})")
        if not entry_ids:
            return []
        requested = {str(e) for e in entry_ids} | \
            {e.uuid for e in entry_ids}
        payload = self._call(
            "POST", "/api/v1/log/entries/retrieve",
            {"entryUUIDs": [str(e) for e in entry_ids]})
        out = []
        for record in payload or []:
            for key, entry in record.items():
                if key not in requested:
                    # never attribute someone else's attestation to
                    # this artifact (client.go filters the same way)
                    log.debug("unrequested entry %s skipped", key)
                    continue
                att = (entry.get("attestation") or {}).get("data")
                if att:
                    try:
                        out.append(Entry(
                            statement=base64.b64decode(att)))
                    except ValueError:
                        log.debug("undecodable attestation skipped")
        return out


def discover_sbom(client: Client, artifact_digest: str):
    """The integration point the reference uses this client for
    (executable → SBOM attestation discovery): search the log by the
    artifact's sha256, fetch attestation statements, and decode the
    first CycloneDX predicate into a scannable SBOM. Returns a
    DecodedSBOM or None."""
    import json as json_mod

    from .sbom import cyclonedx as cdx

    ids = client.search(artifact_digest)
    for entry in client.get_entries(ids[:MAX_GET_ENTRIES]):
        try:
            stmt = json_mod.loads(entry.statement)
        except ValueError:
            continue
        if stmt.get("predicateType") != "https://cyclonedx.org/bom":
            continue
        predicate = stmt.get("predicate") or {}
        bom = predicate.get("Data", predicate)
        if isinstance(bom, str):
            try:
                bom = json_mod.loads(bom)
            except ValueError:
                continue
        if isinstance(bom, dict):
            return cdx.unmarshal(bom)
    return None
