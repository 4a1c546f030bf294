"""Redis layer-cache backend (reference: ``trivy_tpu/artifact/
redis_cache.py``, after trivy's pkg/fanal/cache/redis.go).

Keys match the reference's layout (``fanal::artifact::<id>`` /
``fanal::blob::<id>``, JSON values, optional TTL) so a cache
populated by either implementation serves the other. The client
speaks RESP2 directly over a stdlib socket — no client library —
and plugs into the same cache interface as FSCache/MemoryCache
(``--cache-backend redis://host:port``).
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Optional
from urllib.parse import urlparse

from ..types.convert import (artifact_info_from_dict,
                             blob_info_from_dict)

log = logging.getLogger("trivy_tpu_torch.cache.redis")

PREFIX = "fanal"
ARTIFACT_BUCKET = "artifact"
BLOB_BUCKET = "blob"


class RedisError(ConnectionError):
    pass


class RespClient:
    """Minimal RESP2 client: enough for GET/SET/EXISTS/DEL/KEYS/SCAN.

    One connection, one command at a time: ``command`` holds a lock
    from the send to the end of the reply, so the scheduler's host
    workers can share a client (the reference's interleaves their
    commands on the socket)."""

    def __init__(self, host: str, port: int,
                 timeout_s: float = 10.0):
        try:
            self._sock = socket.create_connection(
                (host, port), timeout=timeout_s)
        except OSError as e:
            raise RedisError(f"redis connect {host}:{port}: {e}")
        self._buf = b""
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def command(self, *args):
        out = [f"*{len(args)}\r\n".encode()]
        for a in args:
            data = a if isinstance(a, bytes) else str(a).encode()
            out.append(f"${len(data)}\r\n".encode() + data +
                       b"\r\n")
        with self._lock:
            try:
                self._sock.sendall(b"".join(out))
                return self._read_reply()
            except OSError as e:
                raise RedisError(f"redis io error: {e}")

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise RedisError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise RedisError("redis connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self._read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RedisError(f"unexpected reply: {line!r}")


class RedisCache:
    """The cache interface the artifact layer uses, over Redis
    (redis.go:22-120)."""

    def __init__(self, url: str, expiration_s: int = 0,
                 client: Optional[RespClient] = None):
        if client is not None:
            self.client = client
        else:
            u = urlparse(url)
            self.client = RespClient(u.hostname or "127.0.0.1",
                                     u.port or 6379)
        self.expiration_s = expiration_s

    def _key(self, bucket: str, id_: str) -> str:
        return f"{PREFIX}::{bucket}::{id_}"

    def _set(self, key: str, obj) -> None:
        args = ["SET", key, json.dumps(obj.to_dict())]
        if self.expiration_s:
            args += ["EX", self.expiration_s]
        self.client.command(*args)

    def put_artifact(self, artifact_id: str, info) -> None:
        self._set(self._key(ARTIFACT_BUCKET, artifact_id), info)

    def put_blob(self, blob_id: str, blob) -> None:
        self._set(self._key(BLOB_BUCKET, blob_id), blob)

    def get_artifact(self, artifact_id: str):
        raw = self.client.command(
            "GET", self._key(ARTIFACT_BUCKET, artifact_id))
        if raw is None:
            return None
        return artifact_info_from_dict(json.loads(raw))

    def get_blob(self, blob_id: str):
        raw = self.client.command(
            "GET", self._key(BLOB_BUCKET, blob_id))
        if raw is None:
            return None
        return blob_info_from_dict(json.loads(raw))

    def missing_blobs(self, artifact_id: str, blob_ids: list)\
            -> tuple:
        missing_artifact = self.client.command(
            "EXISTS", self._key(ARTIFACT_BUCKET, artifact_id)) == 0
        missing = [b for b in blob_ids
                   if self.client.command(
                       "EXISTS", self._key(BLOB_BUCKET, b)) == 0]
        return missing_artifact, missing

    def delete_blobs(self, blob_ids: list) -> None:
        for b in blob_ids:
            self.client.command("DEL", self._key(BLOB_BUCKET, b))

    def clear(self) -> None:
        for bucket in (ARTIFACT_BUCKET, BLOB_BUCKET):
            keys = self.client.command(
                "KEYS", f"{PREFIX}::{bucket}::*") or []
            for k in keys:
                self.client.command("DEL", k)
