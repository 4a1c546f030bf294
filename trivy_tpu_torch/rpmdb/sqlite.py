"""rpmdb.sqlite reader: the ``Packages`` table holds (hnum, blob)
rows where blob is a header blob (rpm's sqlite backend)."""

from __future__ import annotations

import os
import sqlite3
import tempfile

_MAGIC = b"SQLite format 3\x00"


def is_sqlite(data: bytes) -> bool:
    return data[:16] == _MAGIC


def sqlite_blobs(data: bytes) -> list:
    fd, path = tempfile.mkstemp(suffix=".sqlite")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        con = sqlite3.connect(f"file:{path}?mode=ro&immutable=1",
                              uri=True)
        try:
            rows = con.execute(
                "SELECT blob FROM Packages ORDER BY hnum").fetchall()
        finally:
            con.close()
        return [bytes(r[0]) for r in rows]
    except sqlite3.Error as e:
        raise ValueError(f"invalid rpmdb.sqlite: {e}") from e
    finally:
        os.unlink(path)
