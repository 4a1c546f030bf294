"""Pure-Python rpmdb readers (reference: pkg/fanal/analyzer/pkg/rpm
via the external knqyf263/go-rpmdb module).

Three container formats hold the same header blobs:
  - Berkeley DB hash ("Packages") — RHEL/CentOS ≤8, Amazon, Oracle
  - SQLite ("rpmdb.sqlite") — Fedora 33+, RHEL 9, Mariner
  - NDB ("Packages.db") — SUSE / openSUSE

``list_packages(data)`` sniffs the format and returns RpmPackage
records with the fields the detectors consume.
"""

from .header import RpmPackage, parse_header_blob
from .bdb import bdb_blobs, is_bdb
from .ndb import is_ndb, ndb_blobs
from .sqlite import is_sqlite, sqlite_blobs


def list_packages(data: bytes) -> list:
    """rpmdb file bytes → [RpmPackage]; raises ValueError on an
    unrecognized or corrupt database. Any parser crash on crafted
    bytes (struct/index/unicode errors deep in the page walkers) is
    normalized to ValueError so callers need exactly one corrupt-db
    error path."""
    import struct
    try:
        if is_sqlite(data):
            blobs = sqlite_blobs(data)
        elif is_bdb(data):
            blobs = bdb_blobs(data)
        elif is_ndb(data):
            blobs = ndb_blobs(data)
        else:
            raise ValueError("unrecognized rpmdb format")
        out = []
        for blob in blobs:
            pkg = parse_header_blob(blob)
            if pkg is not None and pkg.name:
                out.append(pkg)
        return out
    except ValueError:
        raise
    except (struct.error, IndexError, KeyError, OverflowError,
            MemoryError, UnicodeError) as e:
        raise ValueError(f"corrupt rpmdb: {e!r}") from e


__all__ = ["list_packages", "RpmPackage", "parse_header_blob",
           "is_bdb", "bdb_blobs", "is_ndb", "ndb_blobs",
           "is_sqlite", "sqlite_blobs"]
