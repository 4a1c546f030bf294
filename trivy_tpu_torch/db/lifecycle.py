"""Advisory-DB lifecycle: OCI-layout distribution + metadata freshness
(copied from ``trivy_tpu/db/lifecycle.py``).

Mirrors the reference's DB client (pkg/db/db.go:90-178) and OCI
artifact reader (pkg/oci/artifact.go:46-130):

  - trivy-db ships as a single-layer OCI artifact whose layer media
    type is ``application/vnd.aquasec.trivy.db.layer.v1.tar+gzip``
    and whose ``org.opencontainers.image.title`` annotation names the
    archive (db.go:19, artifact.go:93-103);
  - the archive unpacks to ``trivy.db`` + ``metadata.json`` under
    ``<cache>/db/``;
  - ``metadata.json`` freshness (db.go NeedsUpdate:90-120): schema
    mismatch → update (or error if the local schema is NEWER than
    supported); else fresh while ``now < NextUpdate`` or
    ``now < DownloadedAt + 1h``; ``--skip-db-update`` is rejected on
    first run and on old schemas.

There is no pull transport (the reference has none either):
``update_from_oci_layout`` consumes a local OCI *layout* directory
(``index.json`` + ``blobs/``), which is the format a registry pull
produces — the transport is the only missing piece.
"""

from __future__ import annotations

import datetime
import gzip
import io
import json
import logging
import os
import tarfile
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger("trivy_tpu_torch.db.lifecycle")

SCHEMA_VERSION = 2            # reference: trivy-db db.SchemaVersion
DB_MEDIA_TYPE = "application/vnd.aquasec.trivy.db.layer.v1.tar+gzip"
TITLE_ANNOTATION = "org.opencontainers.image.title"
_RFC3339 = "%Y-%m-%dT%H:%M:%S"


def _parse_time(s: str) -> datetime.datetime:
    if not s:
        return datetime.datetime.fromtimestamp(
            0, tz=datetime.timezone.utc)
    # Go emits RFC3339Nano; fromisoformat handles offsets but not 'Z'
    # before 3.11-style normalization
    s = s.replace("Z", "+00:00")
    try:
        t = datetime.datetime.fromisoformat(s)
    except ValueError:
        return datetime.datetime.fromtimestamp(
            0, tz=datetime.timezone.utc)
    if t.tzinfo is None:
        # offset-less timestamps would make needs_update comparisons
        # raise (naive vs aware); treat them as UTC like Go's zero-loc
        t = t.replace(tzinfo=datetime.timezone.utc)
    return t


def _fmt_time(t: datetime.datetime) -> str:
    return t.astimezone(datetime.timezone.utc).strftime(
        _RFC3339) + "Z"


@dataclass
class Metadata:
    """trivy-db metadata.json (trivy-db metadata.Metadata)."""

    version: int = 0
    next_update: datetime.datetime = field(
        default_factory=lambda: datetime.datetime.fromtimestamp(
            0, tz=datetime.timezone.utc))
    updated_at: datetime.datetime = field(
        default_factory=lambda: datetime.datetime.fromtimestamp(
            0, tz=datetime.timezone.utc))
    downloaded_at: datetime.datetime = field(
        default_factory=lambda: datetime.datetime.fromtimestamp(
            0, tz=datetime.timezone.utc))

    @classmethod
    def from_dict(cls, d: dict) -> "Metadata":
        return cls(
            version=int(d.get("Version", 0)),
            next_update=_parse_time(d.get("NextUpdate", "")),
            updated_at=_parse_time(d.get("UpdatedAt", "")),
            downloaded_at=_parse_time(d.get("DownloadedAt", "")))

    def to_dict(self) -> dict:
        return {
            "Version": self.version,
            "NextUpdate": _fmt_time(self.next_update),
            "UpdatedAt": _fmt_time(self.updated_at),
            "DownloadedAt": _fmt_time(self.downloaded_at),
        }


def db_dir(cache_dir: str) -> str:
    return os.path.join(cache_dir, "db")


def metadata_path(cache_dir: str) -> str:
    return os.path.join(db_dir(cache_dir), "metadata.json")


def load_metadata(cache_dir: str) -> Optional[Metadata]:
    try:
        with open(metadata_path(cache_dir), encoding="utf-8") as f:
            return Metadata.from_dict(json.load(f))
    except (OSError, ValueError):
        return None


def save_metadata(cache_dir: str, meta: Metadata) -> None:
    os.makedirs(db_dir(cache_dir), exist_ok=True)
    with open(metadata_path(cache_dir), "w", encoding="utf-8") as f:
        json.dump(meta.to_dict(), f)


def needs_update(cache_dir: str, skip: bool = False,
                 now: Optional[datetime.datetime] = None) -> bool:
    """db.go NeedsUpdate:90-120 semantics. Raises ValueError where
    the reference errors (newer-schema DB; --skip on first run or on
    an old schema)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    meta = load_metadata(cache_dir)
    if meta is None:
        if skip:
            raise ValueError(
                "--skip-db-update cannot be specified on the first "
                "run")
        meta = Metadata(version=SCHEMA_VERSION)

    if SCHEMA_VERSION < meta.version:
        raise ValueError(
            f"the version of DB schema doesn't match. Local DB: "
            f"{meta.version}, Expected: {SCHEMA_VERSION}")

    if skip:
        if SCHEMA_VERSION != meta.version:
            raise ValueError(
                f"--skip-db-update cannot be specified with the old "
                f"DB schema. Local DB: {meta.version}, Expected: "
                f"{SCHEMA_VERSION}")
        return False

    if SCHEMA_VERSION != meta.version:
        return True
    # isNewDB (db.go:133-143): fresh while inside NextUpdate, or
    # downloaded within the last hour
    if now < meta.next_update:
        return False
    if now < meta.downloaded_at + datetime.timedelta(hours=1):
        return False
    return True


# --------------------------------------------------- hot-swap observers

def attach_memo(store, memo):
    """Register a findings memo (``memo.FindingsMemo``) on a
    SwappableStore's swap lifecycle: every ``db update`` hot swap
    computes the advisory delta between the outgoing and incoming
    generations and re-matches only the delta-touched packages
    against the new resident tables. Returns a detach callable."""
    def hook(old_db, new_db):
        memo.hot_swap(old_db, new_db)

    store.add_swap_hook(hook)

    def detach():
        store.remove_swap_hook(hook)

    return detach


# ------------------------------------------------------------ OCI layout

def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _blob_path(layout_dir: str, digest: str) -> str:
    # validate BEFORE the digest becomes a filesystem path — a
    # crafted index/manifest must not read outside the layout
    from ..guard.safetar import validate_digest
    algo, _, hexd = validate_digest(digest).partition(":")
    return os.path.join(layout_dir, "blobs", algo, hexd)


def read_oci_layout(layout_dir: str) -> tuple:
    """OCI image layout → (layer bytes, title annotation).

    Mirrors pkg/oci/artifact.go:46-103: exactly one layer, media type
    must be the trivy-db tgz, title annotation must be present — and
    the layer bytes must hash to the digest the manifest pins (a
    tampered or torn download fails HERE, before any unpack)."""
    import hashlib
    index = _read_json(os.path.join(layout_dir, "index.json"))
    manifests = index.get("manifests") or []
    if not manifests:
        raise ValueError(f"{layout_dir}: empty OCI index")
    manifest = _read_json(
        _blob_path(layout_dir, manifests[0]["digest"]))
    layers = manifest.get("layers") or []
    if len(layers) != 1:
        raise ValueError("OCI artifact must be a single layer")
    layer = layers[0]
    if layer.get("mediaType") != DB_MEDIA_TYPE:
        raise ValueError(
            f"unacceptable media type: {layer.get('mediaType')!r}")
    title = (layer.get("annotations") or {}).get(TITLE_ANNOTATION)
    if not title:
        raise ValueError(f"annotation {TITLE_ANNOTATION} is missing")
    digest = layer.get("digest") or ""
    with open(_blob_path(layout_dir, digest), "rb") as f:
        blob = f.read()
    algo, _, want = digest.partition(":")
    if algo != "sha256":
        raise ValueError(f"unsupported layer digest {digest!r}")
    got = hashlib.sha256(blob).hexdigest()
    if got != want:
        raise ValueError(
            f"layer digest mismatch: manifest pins {digest}, "
            f"blob is sha256:{got}")
    return blob, title


def update_from_oci_layout(
        layout_dir: str, cache_dir: str,
        now: Optional[datetime.datetime] = None) -> Metadata:
    """``db update --from-oci-layout``: unpack the layer tgz and
    install it ATOMICALLY into <cache>/db/ (db.go Download: 146-184
    + hostile-input hardening):

    1. unpack into a temp dir NEXT TO the destination (same fs, so
       the final ``os.replace`` is atomic), through the bounded
       safe-tar reader (a bomb or 100k-entry flood trips the budget
       instead of filling the disk);
    2. verify the unpacked ``trivy.db`` opens as a valid BoltDB
       (meta-page magic + checksum);
    3. only then drop the stale metadata/compiled tables and
       ``os.replace`` the new files in.

    A corrupt, truncated, or tampered download therefore raises and
    leaves the PREVIOUS DB serving — never a half-written install.
    Returns the resulting metadata."""
    import shutil
    import tempfile

    from ..guard.budget import ResourceBudget, ResourceLimits
    from ..guard.safetar import safe_extract_db_archive

    now = now or datetime.datetime.now(datetime.timezone.utc)
    blob, _title = read_oci_layout(layout_dir)
    dest = db_dir(cache_dir)
    os.makedirs(dest, exist_ok=True)

    budget = ResourceBudget(
        ResourceLimits(max_decompressed_bytes=4 << 30,
                       max_file_bytes=4 << 30, max_files=64,
                       ingest_deadline_s=600.0),
        name="db-update")
    tmpdir = tempfile.mkdtemp(prefix=".db-install-", dir=cache_dir)
    try:
        safe_extract_db_archive(blob, tmpdir, budget)
        bolt_tmp = os.path.join(tmpdir, "trivy.db")
        if not os.path.exists(bolt_tmp):
            raise ValueError("OCI layer does not contain trivy.db")
        from .boltdb import BoltDB
        BoltDB(bolt_tmp).close()     # CorruptDB (a ValueError) if not
        # validation passed — point of no return: drop the stale
        # metadata (db.go:148-151) and any compiled tables derived
        # from the OLD trivy.db (they would silently shadow the
        # fresh install in cli.load_store), then swap the new files in
        for stale in (metadata_path(cache_dir),
                      os.path.join(dest, "compiled.npz")):
            try:
                os.remove(stale)
            except OSError:
                pass
        os.replace(bolt_tmp, os.path.join(dest, "trivy.db"))
        meta_tmp = os.path.join(tmpdir, "metadata.json")
        if os.path.exists(meta_tmp):
            os.replace(meta_tmp, metadata_path(cache_dir))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    meta = load_metadata(cache_dir) or Metadata(
        version=SCHEMA_VERSION)
    meta.downloaded_at = now
    save_metadata(cache_dir, meta)
    log.info("advisory DB updated from %s -> %s", layout_dir, dest)
    return meta


def write_oci_layout(layout_dir: str, archive: bytes) -> None:
    """Produce an OCI layout holding one trivy-db layer — the shape a
    registry pull yields; used by fixtures and tests."""
    import hashlib
    os.makedirs(os.path.join(layout_dir, "blobs", "sha256"),
                exist_ok=True)

    def put(data: bytes) -> str:
        digest = hashlib.sha256(data).hexdigest()
        with open(os.path.join(layout_dir, "blobs", "sha256",
                               digest), "wb") as f:
            f.write(data)
        return f"sha256:{digest}"

    layer_digest = put(archive)
    config = json.dumps({}).encode()
    config_digest = put(config)
    manifest = json.dumps({
        "schemaVersion": 2,
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "config": {
            "mediaType": "application/vnd.unknown.config.v1+json",
            "digest": config_digest, "size": len(config)},
        "layers": [{
            "mediaType": DB_MEDIA_TYPE,
            "digest": layer_digest, "size": len(archive),
            "annotations": {TITLE_ANNOTATION: "db.tar.gz"}}],
    }).encode()
    manifest_digest = put(manifest)
    with open(os.path.join(layout_dir, "index.json"), "w",
              encoding="utf-8") as f:
        json.dump({
            "schemaVersion": 2,
            "manifests": [{
                "mediaType":
                    "application/vnd.oci.image.manifest.v1+json",
                "digest": manifest_digest,
                "size": len(manifest)}],
        }, f)
    with open(os.path.join(layout_dir, "oci-layout"), "w",
              encoding="utf-8") as f:
        json.dump({"imageLayoutVersion": "1.0.0"}, f)


def pack_db_archive(bolt_bytes: bytes,
                    meta: Optional[Metadata] = None) -> bytes:
    """tgz holding trivy.db (+ metadata.json) — the layer payload."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        ti = tarfile.TarInfo("trivy.db")
        ti.size = len(bolt_bytes)
        tf.addfile(ti, io.BytesIO(bolt_bytes))
        if meta is not None:
            mb = json.dumps(meta.to_dict()).encode()
            ti = tarfile.TarInfo("metadata.json")
            ti.size = len(mb)
            tf.addfile(ti, io.BytesIO(mb))
    return gzip.compress(buf.getvalue())
