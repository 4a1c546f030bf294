"""RPC client (reference: pkg/rpc/client/client.go + retry.go; the JAX
package's ``rpc/client.py``).

``python -m trivy_tpu_torch image --server URL``: the client inspects
the artifact locally (analyzers, and the secret sieve on its own
card), pushes BlobInfos to the server's cache, and asks the server to
run detection against its DB — the client needs no advisory store at
all (run.go:269-271). Transient failures retry with full-jitter
exponential backoff ×10 (honoring a ``Retry-After``), like
retry.go:16-41 does on twirp.Unavailable. A Scan body carries the
scan's ``backend`` (``cuda`` by default), which the server runs it
on.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from typing import Optional

from ..types.convert import os_from_dict, result_from_dict
from ..utils.backoff import full_jitter_delay, parse_retry_after
from .server import (CACHE_PREFIX, DEFAULT_TOKEN_HEADER,
                     SCANNER_PREFIX, TENANT_HEADER)

log = logging.getLogger("trivy_tpu_torch.rpc.client")

MAX_RETRIES = 10
BACKOFF_BASE_S = 0.2
BACKOFF_MAX_S = 5.0
# a server-sent Retry-After is honored up to this cap (it is the
# server's authoritative shed hint, so it is NOT clamped to the
# jitter backoff's 5s ceiling — a 20s quota-drain hint must not
# collapse into futile 5s retries); the request deadline still caps
# the whole loop below
RETRY_AFTER_CAP_S = 60.0


class RPCError(RuntimeError):
    def __init__(self, code, msg):
        super().__init__(f"rpc error {code}: {msg}")
        self.code = code


class _Client:
    def __init__(self, base_url: str, token: str = "",
                 token_header: str = DEFAULT_TOKEN_HEADER,
                 custom_headers: Optional[dict] = None,
                 max_retries: int = MAX_RETRIES,
                 backoff_base_s: float = BACKOFF_BASE_S,
                 backoff_max_s: float = BACKOFF_MAX_S,
                 timeout_s: float = 300.0,
                 tenant: str = ""):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.token_header = token_header
        self.custom_headers = custom_headers or {}
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.timeout_s = timeout_s
        # tenant identity sent on every call (Trivy-Tenant header);
        # empty = the server's shared anonymous tenant
        self.tenant = tenant
        # trace_id of the most recent Scan call (RemoteScanner):
        # lets a CLI client surface "see /trace/<id> on the server"
        self.last_trace_id = ""
        # replica that served the most recent call, when a scan
        # router fronted it (Trivy-Routed-Replica header / the Scan
        # body's routed_replica field); "" when talking to a single
        # server directly
        self.last_routed_replica = ""
        # retry accounting: total retry sleeps taken, and how many
        # of them were server 429 rate-limit shed (docs/serving.md
        # "Multi-tenant QoS") vs transient 5xx/connection failures
        self.counters = {"retries": 0, "rate_limited": 0}

    def _delay(self, attempt: int, retry_after: str = "") -> float:
        """One retry delay: the server's ``Retry-After`` when it
        sent one (a 429's shed hint is authoritative, capped only at
        RETRY_AFTER_CAP_S), else full jitter on an exponential base
        — a retrying fleet must not re-synchronize onto the
        overloaded server (same policy as artifact/registry.py's
        registry client; shared pieces in utils/backoff.py)."""
        hint = parse_retry_after(retry_after)
        if hint is not None:
            return min(hint, RETRY_AFTER_CAP_S)
        return full_jitter_delay(attempt, self.backoff_base_s,
                                 self.backoff_max_s)

    def call(self, path: str, body: dict,
             deadline_s: float = 0.0) -> dict:
        """POST with bounded retries on transient errors only:
        connection refused, 5xx (retry.go retries only
        twirp.Unavailable), and 429 rate-limit shed — honoring the
        server's ``Retry-After``. ``deadline_s`` caps the whole
        retry loop: backing off past the request's own deadline
        would only return an answer nobody is waiting for."""
        data = json.dumps(body).encode()
        last_err = None
        t0 = time.monotonic()
        for attempt in range(self.max_retries):
            req = urllib.request.Request(
                self.base_url + path, data=data, method="POST",
                headers={"Content-Type": "application/json",
                         **self.custom_headers})
            if self.token:
                req.add_header(self.token_header, self.token)
            if self.tenant:
                req.add_header(TENANT_HEADER, self.tenant)
            retry_after = ""
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    self.last_routed_replica = resp.headers.get(
                        "Trivy-Routed-Replica") or ""
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                detail = e.read().decode("utf-8", "replace")
                if e.code == 429:
                    # per-tenant shed: transient by contract — the
                    # server told us exactly how long to back off.
                    # The JSON body's retry_after_s is preferred
                    # (sub-second precision); the Retry-After
                    # header (integer delta-seconds per RFC 9110)
                    # is the fallback
                    self.counters["rate_limited"] += 1
                    retry_after = (e.headers.get("Retry-After")
                                   if e.headers else "") or ""
                    try:
                        body_hint = json.loads(detail).get(
                            "retry_after_s")
                        if body_hint is not None:
                            retry_after = str(float(body_hint))
                    except (ValueError, AttributeError):
                        pass
                    last_err = RPCError(e.code, detail)
                    log.debug("rate-limited on %s (retry-after=%s)",
                              path, retry_after)
                elif e.code == 503:
                    # transient by contract (drain/unavailable or
                    # queue-full shed) — and when a router or a
                    # draining server sent a Retry-After, honor it
                    # exactly like a 429's: header as the fallback,
                    # the JSON body's retry_after_s (sub-second
                    # precision) preferred
                    retry_after = (e.headers.get("Retry-After")
                                   if e.headers else "") or ""
                    try:
                        body_hint = json.loads(detail).get(
                            "retry_after_s")
                        if body_hint is not None:
                            retry_after = str(float(body_hint))
                    except (ValueError, AttributeError):
                        pass
                    last_err = RPCError(e.code, detail)
                    log.debug("retrying %s after 503 "
                              "(retry-after=%s)", path, retry_after)
                elif e.code >= 500:         # transient: retry
                    last_err = RPCError(e.code, detail)
                    log.debug("retrying %s after %d: %s",
                              path, e.code, detail)
                else:
                    raise RPCError(e.code, detail)
            except (urllib.error.URLError, OSError,
                    ConnectionError) as e:
                last_err = RPCError("unavailable", str(e))
                log.debug("retrying %s after %s", path, e)
            if attempt + 1 >= self.max_retries:
                break
            delay = self._delay(attempt, retry_after)
            if deadline_s and deadline_s > 0:
                remaining = deadline_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break           # out of deadline: fail now
                delay = min(delay, remaining)
            self.counters["retries"] += 1
            time.sleep(delay)
        raise last_err


class RemoteCache(_Client):
    """Cache service client — satisfies the local cache interface the
    artifact layer uses, so inspection code is oblivious to the wire
    (reference: NopCache(RemoteCache), run.go:296-299)."""

    def missing_blobs(self, artifact_id: str, blob_ids: list) -> tuple:
        out = self.call(CACHE_PREFIX + "MissingBlobs",
                        {"artifact_id": artifact_id,
                         "blob_ids": list(blob_ids)})
        return (out.get("missing_artifact", False),
                out.get("missing_blob_ids") or [])

    def put_artifact(self, artifact_id: str, info) -> None:
        self.call(CACHE_PREFIX + "PutArtifact",
                  {"artifact_id": artifact_id,
                   "artifact_info": info.to_dict()})

    def put_blob(self, blob_id: str, blob) -> None:
        self.call(CACHE_PREFIX + "PutBlob",
                  {"diff_id": blob_id,
                   "blob_info": blob.to_dict()})

    def delete_blobs(self, blob_ids: list) -> None:
        self.call(CACHE_PREFIX + "DeleteBlobs",
                  {"blob_ids": list(blob_ids)})

    def get_blob(self, blob_id: str):
        """The wire cache is write-only from the client side (the
        server scans its own copy)."""
        return None

    def get_artifact(self, artifact_id: str):
        return None


class RemoteScanner(_Client):
    """Scanner service client — the remote analog of
    LocalScanner.scan (reference: pkg/rpc/client client.go:64-94)."""

    def scan(self, target, options) -> tuple:
        """``target`` is a ScanTarget — same call shape as
        LocalScanner.scan, so the CLI swaps drivers freely
        (scanner.Driver in the reference).

        Every Scan carries a fresh idempotency key shared by all
        retry attempts of THIS call: if a response is lost after the
        server enqueued the scan, the retry replays the first
        enqueue's outcome instead of double-enqueuing into the
        scheduler.

        It also carries a client-generated ``trace_id`` (Dapper-style
        propagation, docs/observability.md): the server roots this
        request's span tree under it, so the caller can pull the
        trace from ``GET /trace/<id>`` — the id is logged at debug
        and kept on ``self.last_trace_id``. Retries reuse the same
        id: they are attempts at ONE logical request.

        Fleet propagation (obs/propagate.py): when the caller has an
        active local span, its context rides a ``traceparent`` field
        and the server's root becomes a true CHILD of that span —
        one tree spanning both processes. Without one, a fresh id is
        minted exactly as before."""
        import uuid

        from ..obs.propagate import current_context
        ctx = current_context()
        self.last_trace_id = ctx.trace_id if ctx is not None \
            else uuid.uuid4().hex
        log.debug("scan %r trace_id=%s", target.name,
                  self.last_trace_id)
        deadline_s = float(getattr(options, "deadline_s", 0.0)
                           or 0.0)
        body = {
            "idempotency_key": uuid.uuid4().hex,
            "trace_id": self.last_trace_id,
            "target": target.name,
            "artifact_id": target.artifact_id,
            "blob_ids": list(target.blob_ids),
            "options": {
                "vuln_type": list(options.vuln_type),
                "security_checks": list(options.security_checks),
                "list_all_packages": options.list_all_packages,
                "scan_removed_packages":
                    options.scan_removed_packages,
                "backend": getattr(options, "backend", "cuda"),
            },
        }
        if ctx is not None:
            body["traceparent"] = ctx.to_header()
        if deadline_s:
            body["deadline_s"] = deadline_s
        if self.tenant:
            body["tenant"] = self.tenant
        # the retry loop is capped at the request's own deadline —
        # a 429's Retry-After is honored, but never past the point
        # where the answer would arrive too late to matter
        out = self.call(SCANNER_PREFIX + "Scan", body,
                        deadline_s=deadline_s)
        # behind a scan router the response says which backend
        # replica served it (body field; the header is the fallback
        # call() already captured) — callers log it for debugging
        # ring placement
        routed = str(out.get("routed_replica") or "")
        if routed:
            self.last_routed_replica = routed
            log.debug("scan %r served by replica %s", target.name,
                      routed)
        results = [result_from_dict(r)
                   for r in out.get("results") or []]
        return results, os_from_dict(out.get("os"))
