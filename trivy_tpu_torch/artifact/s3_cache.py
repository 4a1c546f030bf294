"""S3 layer-cache backend (reference: ``trivy_tpu/artifact/s3_cache.py``,
after trivy's pkg/fanal/cache/s3.go).

Object layout matches the reference so a cache populated by either
implementation serves the other: ``artifact/<prefix>/<id>`` and
``blob/<prefix>/<id>`` hold the JSON records, and every PUT also
writes ``<key>.index`` — the reference's marker for S3's historical
read-after-write caveat; MissingBlobs HEADs the index before
trusting a GET (s3.go:75-166).

The client speaks the S3 REST API directly over http.client with
SigV4 request signing from the standard AWS env vars
(AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / AWS_SESSION_TOKEN);
unsigned requests are sent when no credentials are present (fakes,
anonymous MinIO). Selected with
``--cache-backend s3://bucket/prefix?endpoint=...&region=...`` —
path-style addressing is used whenever an endpoint override is
given, virtual-hosted style for real AWS.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import json
import logging
import os
import threading
from typing import Optional
from urllib.parse import quote, urlparse

from ..types.convert import (artifact_info_from_dict,
                             blob_info_from_dict)

log = logging.getLogger("trivy_tpu_torch.cache.s3")

ARTIFACT_BUCKET = "artifact"
BLOB_BUCKET = "blob"


class S3Error(ConnectionError):
    pass


class S3IntegrityError(S3Error):
    """The cache is INCONSISTENT (e.g. an .index marker without its
    object), not unreachable. ``integrity`` marks it for the circuit
    breaker (artifact/resilient.py): tripping open on a healthy-but-
    inconsistent bucket would hide the actionable message and take
    the whole cache offline, so the breaker re-raises these."""

    integrity = True


class S3Client:
    """Just enough S3 REST: PUT/GET/HEAD/DELETE object."""

    def __init__(self, bucket: str, endpoint: str = "",
                 region: str = "", timeout_s: float = 10.0):
        self.bucket = bucket
        self.region = region or os.environ.get(
            "AWS_REGION", "us-east-1")
        self.timeout_s = timeout_s
        if endpoint:
            u = urlparse(endpoint)
            self.secure = u.scheme == "https"
            self.host = u.netloc
            self.path_style = True
        else:
            self.secure = True
            self.host = f"{bucket}.s3.{self.region}.amazonaws.com"
            self.path_style = False
        self.access_key = os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.session_token = os.environ.get("AWS_SESSION_TOKEN", "")
        # one kept-alive connection, handed to one request at a time
        # (the scheduler's host workers share a client)
        self._conn = None
        self._conn_lock = threading.Lock()

    def _take_conn(self):
        with self._conn_lock:
            conn, self._conn = self._conn, None
        return conn or self._connect()

    def _path(self, key: str) -> str:
        # ':' stays literal so keys match the reference layout
        # (blob/<prefix>/sha256:<hex>)
        safe = quote(key, safe="/-_.~:")
        if self.path_style:
            return f"/{self.bucket}/{safe}"
        return f"/{safe}"

    def _connect(self):
        cls = http.client.HTTPSConnection if self.secure \
            else http.client.HTTPConnection
        return cls(self.host, timeout=self.timeout_s)

    def request(self, method: str, key: str,
                body: bytes = b"") -> tuple:
        """→ (status, body bytes). Raises S3Error on transport
        failure. The TCP/TLS connection is kept open across
        requests — missing_blobs HEADs every layer sequentially,
        so per-request handshakes would dominate cross-region
        latency; one stale-connection retry covers keep-alive
        closes."""
        path = self._path(key)
        headers = {"Host": self.host,
                   "Content-Length": str(len(body))}
        if self.access_key and self.secret_key:
            self._sign(method, path, headers, body)
        last_err = None
        for attempt in range(2):
            conn = self._take_conn()
            try:
                conn.request(method, path, body=body or None,
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                last_err = e
                continue
            self._conn = conn
            return resp.status, data
        raise S3Error(f"s3 {method} {key}: {last_err}")

    def list_keys(self, prefix: str, max_keys: int = 0) -> tuple:
        """ListObjectsV2 under ``prefix`` → (keys, complete).

        Pages through continuation tokens; a positive ``max_keys``
        stops paging early and reports ``complete=False`` when more
        pages remain — the bounded-iteration contract memo
        ``scan_keys`` (and the impact-index rebuild) relies on."""
        import html
        import re
        keys: list = []
        token = ""
        while True:
            params = {"list-type": "2", "prefix": prefix}
            if token:
                params["continuation-token"] = token
            status, body = self._request_query("GET", params)
            if status >= 300:
                raise S3Error(f"s3 list {prefix}: HTTP {status}")
            text = body.decode("utf-8", "replace")
            keys.extend(html.unescape(m) for m in
                        re.findall(r"<Key>(.*?)</Key>", text))
            truncated = re.search(
                r"<IsTruncated>\s*true\s*</IsTruncated>", text)
            nxt = re.search(r"<NextContinuationToken>(.*?)"
                            r"</NextContinuationToken>", text)
            if not truncated or nxt is None:
                return keys, True
            if max_keys and len(keys) >= max_keys:
                return keys, False
            token = html.unescape(nxt.group(1))

    def _request_query(self, method: str, params: dict) -> tuple:
        """A bucket-level request with a query string (the object
        request() path can't express one: its signer hardcodes an
        empty canonical query)."""
        path = f"/{self.bucket}" if self.path_style else "/"
        query = "&".join(
            f"{quote(k, safe='-_.~')}={quote(str(v), safe='-_.~')}"
            for k, v in sorted(params.items()))
        headers = {"Host": self.host, "Content-Length": "0"}
        if self.access_key and self.secret_key:
            self._sign(method, path, headers, b"", query=query)
        last_err = None
        for _ in range(2):
            conn = self._take_conn()
            try:
                conn.request(method, f"{path}?{query}",
                             headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                last_err = e
                continue
            self._conn = conn
            return resp.status, data
        raise S3Error(f"s3 {method} {path}?{query}: {last_err}")

    def _sign(self, method: str, path: str, headers: dict,
              body: bytes, query: str = "") -> None:
        """AWS Signature Version 4 (the aws-sdk-go default signer
        the reference relies on). ``query`` must already be the
        canonical form: sorted, percent-encoded pairs."""
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(body).hexdigest()
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token

        lowered = {k.lower(): str(v).strip()
                   for k, v in headers.items()}
        signed = sorted(lowered)
        canonical_headers = "".join(
            f"{k}:{lowered[k]}\n" for k in signed)
        signed_list = ";".join(signed)
        canonical = "\n".join([
            method, path, query, canonical_headers, signed_list,
            payload_hash])
        scope = f"{date}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])

        def h(key, msg):
            return hmac.new(key, msg.encode(),
                            hashlib.sha256).digest()

        k = h(("AWS4" + self.secret_key).encode(), date)
        k = h(k, self.region)
        k = h(k, "s3")
        k = h(k, "aws4_request")
        signature = hmac.new(k, to_sign.encode(),
                             hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            "AWS4-HMAC-SHA256 "
            f"Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_list}, "
            f"Signature={signature}")


class S3Cache:
    """The cache interface the artifact layer uses, over S3
    (s3.go:20-166)."""

    def __init__(self, url: str, client: Optional[S3Client] = None):
        u = urlparse(url)
        self.prefix = u.path.strip("/")
        if client is not None:
            self.client = client
        else:
            from urllib.parse import parse_qs
            q = parse_qs(u.query)
            self.client = S3Client(
                u.netloc,
                endpoint=(q.get("endpoint") or [""])[0],
                region=(q.get("region") or [""])[0])
        if not self.client.bucket:
            raise ValueError(
                "s3 cache needs a bucket: s3://bucket/prefix")

    def _key(self, bucket: str, id_: str) -> str:
        return f"{bucket}/{self.prefix}/{id_}" if self.prefix \
            else f"{bucket}//{id_}"     # ref layout keeps the slot

    def _put(self, bucket: str, id_: str, obj) -> None:
        key = self._key(bucket, id_)
        body = json.dumps(obj.to_dict()).encode()
        status, _ = self.client.request("PUT", key, body)
        if status >= 300:
            raise S3Error(f"s3 put {key}: HTTP {status}")
        # the read-after-write index marker (s3.go:77-85)
        status, _ = self.client.request("PUT", key + ".index")
        if status >= 300:
            raise S3Error(f"s3 put {key}.index: HTTP {status}")

    def _get(self, bucket: str, id_: str):
        status, data = self.client.request(
            "GET", self._key(bucket, id_))
        if status == 404:
            return None
        if status >= 300:
            raise S3Error(f"s3 get {id_}: HTTP {status}")
        return json.loads(data)

    def _has_index(self, bucket: str, id_: str) -> bool:
        status, _ = self.client.request(
            "HEAD", self._key(bucket, id_) + ".index")
        return status < 300

    def put_artifact(self, artifact_id: str, info) -> None:
        self._put(ARTIFACT_BUCKET, artifact_id, info)

    def put_blob(self, blob_id: str, blob) -> None:
        self._put(BLOB_BUCKET, blob_id, blob)

    def get_artifact(self, artifact_id: str):
        d = self._get(ARTIFACT_BUCKET, artifact_id)
        return artifact_info_from_dict(d) if d is not None else None

    def get_blob(self, blob_id: str):
        d = self._get(BLOB_BUCKET, blob_id)
        return blob_info_from_dict(d) if d is not None else None

    def _present(self, bucket: str, id_: str) -> bool:
        """Index-first existence check that also verifies the BODY is
        readable (s3.go:133-160 re-reads the record): an interrupted
        delete or lifecycle eviction can leave the .index marker
        without its object — reporting that as a cache hit would make
        get_blob return None and apply_layers silently drop the
        layer, so index-without-body is an error, not a hit."""
        if not self._has_index(bucket, id_):
            return False
        key = self._key(bucket, id_)
        status, _ = self.client.request("HEAD", key)
        if status == 404:
            raise S3IntegrityError(
                f"s3 cache inconsistent: {key}.index exists but "
                f"the object is missing (run delete_blobs or evict "
                f"the marker)")
        if status >= 300:
            raise S3Error(f"s3 head {key}: HTTP {status}")
        return True

    def missing_blobs(self, artifact_id: str,
                      blob_ids: list) -> tuple:
        """Index-first existence checks (s3.go:133-160)."""
        missing = [b for b in blob_ids
                   if not self._present(BLOB_BUCKET, b)]
        missing_artifact = not self._present(ARTIFACT_BUCKET,
                                             artifact_id)
        return missing_artifact, missing

    def delete_blobs(self, blob_ids: list) -> None:
        # the .index marker goes FIRST: if the delete is interrupted
        # between the two requests, the leftover state is
        # body-without-index (a cache miss, re-analyzed next scan),
        # never index-without-body (a phantom hit)
        for b in blob_ids:
            for suffix in (".index", ""):
                key = self._key(BLOB_BUCKET, b) + suffix
                status, _ = self.client.request("DELETE", key)
                if status >= 300 and status != 404:
                    log.warning("s3 delete %s: HTTP %s", key,
                                status)
