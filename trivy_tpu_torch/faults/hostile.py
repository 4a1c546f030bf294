"""Adversarial ingest corpus: seeded builders of hostile artifacts
(copied from ``trivy_tpu/faults/hostile.py``: for the same seed and
scale both packages write the same bytes).

Each builder produces a syntactically loadable container-image tar
whose *content* attacks a specific ingest resource or parser — the
corpus the guard layer (``trivy_tpu_torch/guard``, docs/robustness.md) is
acceptance-tested against:

========================  =============================================
builder                   attack / expected outcome under guards
========================  =============================================
``gzip-bomb``             tiny gzip layer inflating past the
                          compression-ratio tripwire → ``failed``
                          (ingest/resource-budget)
``tar-flood``             header flood: more entries than
                          ``max_files`` → ``failed`` (resource-budget)
``link-escape``           ``..``-traversal entry names + hardlink
                          escaping the root → ``failed``
                          (malformed-archive)
``deep-tree``             pathological path depth → ``failed``
                          (resource-budget)
``absurd-size``           member header claiming a size past the
                          per-file budget → ``failed``
                          (resource-budget)
``truncated-gzip``        gzip stream cut mid-flight → ``failed``
                          (malformed-archive)
``truncated-tar``         layer tar cut mid-member → ``failed``
                          (malformed-archive)
``non-utf8-names``        entry names that do not decode → ``failed``
                          (malformed-archive)
``oversize-config``       multi-MB image config JSON → ``failed``
                          (resource-budget)
``corrupt-rpmdb``         rpm Packages file with a valid magic and
                          garbage pages → scan completes,
                          ``degraded`` (soft ingest fault)
========================  =============================================

``build_corpus`` materializes the named builders (all by default)
into a directory, deterministically from one seed — the same seed
produces byte-identical artifacts, so a failure reproduces from the
spec string alone. ``hostile_limits(scale)`` returns the matching
:class:`ResourceLimits`: at ``scale=1.0`` the corpus trips the CLI
*defaults*; smaller scales shrink both the artifacts and the limits
proportionally so tests stay fast.

Wired into ``--fault-spec`` (scenario ``hostile-ingest``, or any
spec carrying ``hostile=<builder;builder;...>``): the multi-target
image path appends the materialized corpus to the scanned fleet, a
mixed clean and hostile fleet.

``corrupt_boltdb_layout`` is the advisory-DB flavor (an OCI layout
whose ``trivy.db`` is garbage with a *valid* digest); it exercises
the atomic-install rollback in ``db/lifecycle.py`` rather than the
image path, so it is not part of the scanned corpus list.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import os
import random
import tarfile
from typing import Optional

from ..guard.budget import DEFAULT_LIMITS, ResourceLimits

DEFAULT_SEED = 20260804

# expected terminal status per builder under hostile_limits — the
# acceptance contract pytest -m hostile asserts
EXPECTED_STATUS = {
    "gzip-bomb": "failed",
    "tar-flood": "failed",
    "link-escape": "failed",
    "deep-tree": "failed",
    "absurd-size": "failed",
    "truncated-gzip": "failed",
    "truncated-tar": "failed",
    "non-utf8-names": "failed",
    "oversize-config": "failed",
    "corrupt-rpmdb": "degraded",
}


def hostile_limits(scale: float = 1.0) -> ResourceLimits:
    """Limits under which the ``scale``-sized corpus reliably trips
    (scale=1.0 == the CLI defaults)."""
    return DEFAULT_LIMITS.scaled(scale)


# ------------------------------------------------------------ helpers

def _layer_tar(files: dict, gz: bool = False) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for path, content in files.items():
            ti = tarfile.TarInfo(path)
            ti.size = len(content)
            tf.addfile(ti, io.BytesIO(content))
    data = buf.getvalue()
    return gzip.compress(data, mtime=0) if gz else data


def _image_tar(path: str, layer_blobs: list,
               config: Optional[dict] = None) -> str:
    """Wrap layer blobs into a docker-save tar the loader accepts."""
    diff_ids = ["sha256:" + hashlib.sha256(b).hexdigest()
                for b in layer_blobs]
    config = config or {}
    config.setdefault("architecture", "amd64")
    config.setdefault("os", "linux")
    config.setdefault("rootfs", {"type": "layers",
                                 "diff_ids": diff_ids})
    config.setdefault("config", {})
    manifest = [{"Config": "config.json",
                 "RepoTags": [f"hostile/{os.path.basename(path)}"],
                 "Layers": [f"l{i}.tar"
                            for i in range(len(layer_blobs))]}]
    with tarfile.open(path, "w") as tf:
        def add(name, data):
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
        add("config.json", json.dumps(config).encode())
        add("manifest.json", json.dumps(manifest).encode())
        for i, b in enumerate(layer_blobs):
            add(f"l{i}.tar", b)
    return path


def _benign_layer(rng: random.Random) -> bytes:
    """A small healthy layer so hostile images look like images."""
    return _layer_tar({
        "etc/alpine-release": b"3.16.2\n",
        "srv/app/readme.txt":
            f"build {rng.randrange(1 << 30)}\n".encode(),
    })


# ------------------------------------------------------------ builders

def build_gzip_bomb(path: str, rng: random.Random,
                    scale: float = 1.0) -> str:
    """Layer whose gzip inflates ~1000x: a few MB of zeros (scaled)
    compressing to a handful of KB — trips the ratio tripwire long
    before the absolute byte cap."""
    inner = _layer_tar(
        {"srv/bomb.bin": b"\0" * int((8 << 20) * scale)})
    return _image_tar(path, [_benign_layer(rng),
                             gzip.compress(inner, mtime=0)])


def build_tar_flood(path: str, rng: random.Random,
                    scale: float = 1.0) -> str:
    """Header flood: ~1.1x ``max_files`` empty entries (100k-entry
    class at scale 1.0) — trips the entry budget without the scan
    reading a single payload byte."""
    n = max(8, int(110_000 * scale))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for i in range(n):
            tf.addfile(tarfile.TarInfo(f"srv/flood/f{i}"))
    return _image_tar(path, [buf.getvalue()])


def build_link_escape(path: str, rng: random.Random,
                      scale: float = 1.0) -> str:
    """Traversal entry names (normpath keeps the ``..``) plus a
    hardlink targeting an absolute path outside the archive."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        evil = tarfile.TarInfo("../../etc/cron.d/evil")
        evil.size = 4
        tf.addfile(evil, io.BytesIO(b"boom"))
        ln = tarfile.TarInfo("srv/app/passwd")
        ln.type = tarfile.LNKTYPE
        ln.linkname = "/etc/passwd"
        tf.addfile(ln)
    return _image_tar(path, [_benign_layer(rng), buf.getvalue()])


def build_deep_tree(path: str, rng: random.Random,
                    scale: float = 1.0) -> str:
    deep = "/".join(f"d{i}" for i in range(4 * DEFAULT_LIMITS.max_depth))
    return _image_tar(path, [
        _layer_tar({deep + "/leaf.txt": b"deep\n"})])


def build_absurd_size(path: str, rng: random.Random,
                      scale: float = 1.0) -> str:
    """Member header claiming a payload far past the per-file budget
    (with no data behind it) — the size check trips before any read
    materializes."""
    out = io.BytesIO()
    benign = tarfile.TarInfo("etc/alpine-release")
    benign.size = 7
    out.write(benign.tobuf(format=tarfile.GNU_FORMAT))
    out.write(b"3.16.2\n".ljust(512, b"\0"))
    huge = tarfile.TarInfo("srv/huge.bin")
    huge.size = int(DEFAULT_LIMITS.max_file_bytes * 4 * scale)
    out.write(huge.tobuf(format=tarfile.GNU_FORMAT))
    out.write(b"\0" * 1024)          # no payload behind the claim
    return _image_tar(path, [out.getvalue()])


def build_truncated_gzip(path: str, rng: random.Random,
                         scale: float = 1.0) -> str:
    whole = gzip.compress(_layer_tar(
        {"srv/data.bin": bytes(rng.randrange(256)
                               for _ in range(4096))}), mtime=0)
    return _image_tar(path, [_benign_layer(rng),
                             whole[:len(whole) // 2]])


def build_truncated_tar(path: str, rng: random.Random,
                        scale: float = 1.0) -> str:
    whole = _layer_tar({
        "srv/a.txt": b"A" * 2048,
        "srv/b.txt": b"B" * 2048,
    })
    # cut mid-way through the SECOND member's payload (first member
    # spans header+data = 2560 bytes, second header ends at 3072):
    # iteration yields both headers, then hits unexpected EOF
    return _image_tar(path, [whole[:3072 + 400]])


def build_non_utf8_names(path: str, rng: random.Random,
                         scale: float = 1.0) -> str:
    name = b"srv/caf\xe9/\xff\xfe.txt".decode(
        "utf-8", "surrogateescape")
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w",
                      format=tarfile.GNU_FORMAT) as tf:
        ti = tarfile.TarInfo(name)
        ti.size = 2
        tf.addfile(ti, io.BytesIO(b"hi"))
    return _image_tar(path, [buf.getvalue()])


def build_oversize_config(path: str, rng: random.Random,
                          scale: float = 1.0) -> str:
    pad = "x" * int(DEFAULT_LIMITS.max_config_bytes * 1.5 * scale)
    return _image_tar(path, [_benign_layer(rng)],
                      config={"comment": pad})


def build_corrupt_rpmdb(path: str, rng: random.Random,
                        scale: float = 1.0) -> str:
    """Berkeley-DB magic + garbage pages: ``is_bdb`` says yes, the
    page walk says no. Survivable — the scan completes without rpm
    packages, status ``degraded`` with an ingest soft fault."""
    import struct
    page = bytearray(rng.randbytes(4096))
    struct.pack_into("<I", page, 12, 0x061561)   # hash magic
    struct.pack_into("<I", page, 20, 4096)       # page size
    struct.pack_into("<I", page, 32, 0xFFFF)     # absurd last_pgno
    return _image_tar(path, [_layer_tar({
        "etc/alpine-release": b"3.16.2\n",
        "var/lib/rpm/Packages": bytes(page),
    })])


BUILDERS = {
    "gzip-bomb": build_gzip_bomb,
    "tar-flood": build_tar_flood,
    "link-escape": build_link_escape,
    "deep-tree": build_deep_tree,
    "absurd-size": build_absurd_size,
    "truncated-gzip": build_truncated_gzip,
    "truncated-tar": build_truncated_tar,
    "non-utf8-names": build_non_utf8_names,
    "oversize-config": build_oversize_config,
    "corrupt-rpmdb": build_corrupt_rpmdb,
}


def build_corpus(dirpath: str, seed: int = DEFAULT_SEED,
                 only: Optional[list] = None,
                 scale: float = 1.0) -> list:
    """Materialize the corpus → [(builder name, image-tar path)].
    Deterministic per seed; ``only`` selects builders (``"all"``
    expands to every one). Unknown names raise ValueError so a
    typo'd ``--fault-spec hostile=...`` fails up front."""
    names = list(BUILDERS) if not only or "all" in only \
        else list(only)
    unknown = [n for n in names if n not in BUILDERS]
    if unknown:
        raise ValueError(
            f"unknown hostile builder(s) {', '.join(unknown)} "
            f"(choose from {', '.join(sorted(BUILDERS))})")
    os.makedirs(dirpath, exist_ok=True)
    out = []
    for name in names:
        rng = random.Random((seed, name).__repr__())
        path = os.path.join(dirpath, f"hostile-{name}.tar")
        out.append((name, BUILDERS[name](path, rng, scale)))
    return out


def corrupt_boltdb_layout(dirpath: str,
                          seed: int = DEFAULT_SEED) -> str:
    """OCI layout whose trivy.db layer is garbage with a VALID
    digest — passes the transport integrity check, fails the
    boltdb-open validation, and must leave a previous install
    serving (db/lifecycle.py atomic install)."""
    from ..db.lifecycle import pack_db_archive, write_oci_layout
    rng = random.Random(seed)
    archive = pack_db_archive(rng.randbytes(8192))
    write_oci_layout(dirpath, archive)
    return dirpath
